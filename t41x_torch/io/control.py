"""PC control-app data streaming (host side).

Re-expression of the reference's control-app protocol (tmr4/T41_SDR
`t41Control.cpp`, frame assembly `FFT.cpp:171-195`, audio spectrum
`Process.cpp:818-825`, S-meter `SendSmeter` `t41Control.cpp:95-116`):
framed spectrum / audio-spectrum / S-meter data for an external display
app.  The reference streams over USB serial at 19200; t41x serves TCP.

Frame formats (byte-compatible with the reference):
  RF spectrum:    b"FD" + b"%03d" (255 - max) + 512 bytes + b";"
  audio spectrum: b"AD" + n bytes + b";"
  S-meter:        b"SM" + b"%03d" (bar 0..180) + b"%+07.1f" dBm + b";"
  beacon monitor: b"BM" + band + beacon + volume + 90 SNR color indexes
                  + b";"  (96 bytes; `t41Beacon.cpp:18`,
                  `Beacon.cpp:387-424`)

`BeaconAppServer` also accepts the beacon app's commands
(`T41BeaconLoop` `t41Beacon.cpp:57-89`): DS;/DP; start/stop the data
stream, TM<epoch>; sets the radio clock.

A copy of `t41x.io.control`, so the port never imports JAX
(`tests/test_torch_host_copies.py` pins the two equal).
"""

from __future__ import annotations

import socket
import socketserver
import threading

import numpy as np


def rf_spectrum_frame(pixels: np.ndarray) -> bytes:
    """pixels: (512,) display pixel heights (any float range); scaled so
    max maps to 255, like the reference's shift-to-max framing."""
    p = np.asarray(pixels, np.float64)
    mx = float(p.max()) if p.size else 0.0
    data = np.clip(p + (255.0 - mx), 0, 255).astype(np.uint8)
    return b"FD" + b"%03d" % max(0, min(999, int(255 - mx))) \
        + data.tobytes() + b";"


def audio_spectrum_frame(pixels: np.ndarray) -> bytes:
    data = np.clip(np.asarray(pixels, np.float64), 0, 255).astype(np.uint8)
    return b"AD" + data.tobytes() + b";"


def smeter_frame(dbm: float, pixels_per_s: int = 12) -> bytes:
    bar = int(np.interp(dbm, [-73.0 - 9 * 6.0, -73.0],
                        [0, 9 * pixels_per_s]))
    bar = max(0, min(15 * pixels_per_s, bar))
    return b"SM" + b"%03d" % bar + (b"%+07.1f" % dbm) + b";"


def beacon_frame(band: int, beacon: int, volume: int,
                 snr_colors: np.ndarray) -> bytes:
    """96-byte beacon-monitor frame (`Beacon.cpp:415-423`):
    b"BM" + band + beacon + volume + 90 SNR color indexes (18 beacons ×
    5 bands, 0..9) + b";"."""
    colors = np.clip(np.asarray(snr_colors, np.int64).reshape(-1),
                     0, 9).astype(np.uint8)
    if colors.size != 90:
        raise ValueError("snr_colors must hold 18*5 entries")
    return (b"BM" + bytes([band & 0xFF, beacon & 0xFF, volume & 0xFF])
            + colors.tobytes() + b";")


def parse_frames(buf: bytes):
    """Split a byte stream into (tag, payload) frames; returns
    (frames, remainder).  Binary payloads may contain ';' — frames are
    length-delimited by tag: FD = 3+512, SM = 3+7, BM = 93,
    AD = until ';'."""
    frames = []
    i = 0
    while i + 2 <= len(buf):
        tag = buf[i: i + 2]
        if tag == b"FD":
            need = i + 2 + 3 + 512 + 1
            if len(buf) < need:
                break
            frames.append(("FD", buf[i + 2: need - 1]))
            i = need
        elif tag == b"SM":
            need = i + 2 + 10 + 1
            if len(buf) < need:
                break
            frames.append(("SM", buf[i + 2: need - 1]))
            i = need
        elif tag == b"BM":
            need = i + 96
            if len(buf) < need:
                break
            frames.append(("BM", buf[i + 2: need - 1]))
            i = need
        elif tag == b"AD":
            end = buf.find(b";", i + 2)
            if end < 0:
                break
            frames.append(("AD", buf[i + 2: end]))
            i = end + 1
        else:
            i += 1
    return frames, buf[i:]


class ControlServer:
    """Push server: call publish_* from the processing loop; every
    connected client receives the framed stream."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._clients: list[socket.socket] = []
        self._lock = threading.Lock()
        clients, lock = self._clients, self._lock

        class _TCP(socketserver.BaseRequestHandler):
            def handle(self):
                with lock:
                    clients.append(self.request)
                try:
                    while self.request.recv(1024):
                        pass
                except OSError:
                    pass
                finally:
                    with lock:
                        if self.request in clients:
                            clients.remove(self.request)

        self._srv = socketserver.ThreadingTCPServer((host, port), _TCP)
        self._srv.daemon_threads = True
        self.port = self._srv.server_address[1]
        threading.Thread(target=self._srv.serve_forever,
                         daemon=True).start()

    def _send(self, frame: bytes) -> None:
        with self._lock:
            dead = []
            for c in self._clients:
                try:
                    c.sendall(frame)
                except OSError:
                    dead.append(c)
            for c in dead:
                self._clients.remove(c)

    def publish_rf_spectrum(self, pixels) -> None:
        self._send(rf_spectrum_frame(pixels))

    def publish_audio_spectrum(self, pixels) -> None:
        self._send(audio_spectrum_frame(pixels))

    def publish_smeter(self, dbm: float) -> None:
        self._send(smeter_frame(dbm))

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


class BeaconAppServer(ControlServer):
    """Beacon-monitor app endpoint (`t41Beacon.cpp`): pushes 96-byte BM
    frames while streaming is enabled; accepts DS;/DP;/TM<epoch>;
    commands from the connected app."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        super().__init__(host, port)
        self.streaming = False   # beaconDataFlag (t41Beacon.cpp:18)
        self.clock_offset = 0    # TM; seconds vs host clock
        self._srv.RequestHandlerClass = self._make_handler()

    def _make_handler(self):
        clients, lock, app = self._clients, self._lock, self

        class _TCP(socketserver.BaseRequestHandler):
            def handle(self):
                with lock:
                    clients.append(self.request)
                buf = b""
                try:
                    while True:
                        data = self.request.recv(1024)
                        if not data:
                            break
                        buf += data
                        while b";" in buf:
                            cmd, buf = buf.split(b";", 1)
                            app._command(cmd.decode(errors="replace"))
                except OSError:
                    pass
                finally:
                    with lock:
                        if self.request in clients:
                            clients.remove(self.request)

        return _TCP

    def _command(self, cmd: str) -> None:
        c = cmd.strip().upper()
        if c == "DS":
            self.streaming = True
        elif c == "DP":
            self.streaming = False
        elif c.startswith("TM") and c[2:].lstrip("-").isdigit():
            import time
            self.clock_offset = int(c[2:]) - int(time.time())

    def publish_beacon(self, band: int, beacon: int, volume: int,
                       snr_colors) -> None:
        if self.streaming:
            self._send(beacon_frame(band, beacon, volume, snr_colors))
