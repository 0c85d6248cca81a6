"""Acquisition-device ingest: network I/Q sources feeding the block ring.

The reference's L0 is I2S quad DMA from the QSD ADC
(tmr4/T41_SDR `T41_SDR.ino:177-198`): hardware interrupts deposit
128-sample blocks into `AudioRecordQueue`s.  t41x's acquisition boundary
is the same shape one layer up: a capture device (SDR frontend, remote
digitizer, another process) streams raw I/Q over a socket, and
`NetIQSource` frames it into BLOCK_SIZE blocks pushed to the lock-free
`BlockRing` the StreamRunner pops — back-pressure and overrun accounting
included.  Wire format: raw interleaved little-endian float32 I,Q pairs
(the rtl_tcp/SoapyRemote-style streaming convention, float-native).

    ring = BlockRing()
    src = NetIQSource(ring, host, port)      # connects + streams
    runner = StreamRunner(radio, ring=ring)
    while ...: runner.step()

`serve_capture()` is the matching test/demo transmitter: it serves a
capture's raw bytes over TCP (optionally paced to real time), standing
in for the digitizer.

A copy of `t41x.io.acquire`, so the port never imports JAX
(`tests/test_torch_host_copies.py` pins the two equal).
"""

from __future__ import annotations

import socket
import threading
import time

import numpy as np

from t41x_torch import constants as C


class NetIQSource:
    """Connects to an I/Q stream server and pushes BLOCK_SIZE complex
    blocks into `ring` from a reader thread until EOF or stop()."""

    def __init__(self, ring, host: str, port: int,
                 block_size: int = C.BLOCK_SIZE,
                 connect_timeout: float = 10.0):
        self.ring = ring
        self.block_size = block_size
        self.blocks_received = 0
        self._stop = threading.Event()
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout)
        self._sock.settimeout(1.0)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        bytes_per_block = self.block_size * 2 * 4  # interleaved f32 I,Q
        buf = bytearray()
        while not self._stop.is_set():
            try:
                chunk = self._sock.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            if not chunk:
                break
            buf.extend(chunk)
            while len(buf) >= bytes_per_block:
                frame = bytes(buf[:bytes_per_block])
                del buf[:bytes_per_block]
                block = np.frombuffer(frame, np.float32)
                self.ring.push(block)
                self.blocks_received += 1
        try:
            self._sock.close()
        except OSError:
            pass

    @property
    def running(self) -> bool:
        return self._thread.is_alive()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=5)


def serve_capture(iq: np.ndarray, host: str = "127.0.0.1", port: int = 0,
                  rate_factor: float = 0.0,
                  chunk_blocks: int = 4) -> tuple[int, threading.Thread]:
    """Serve a complex64 capture as a raw interleaved-float32 I/Q stream
    to ONE client, then close.  rate_factor=1 paces to real time
    (BLOCK_SECONDS per block), 0 streams flat out.  Returns
    (port, server_thread)."""
    iq = np.ascontiguousarray(np.asarray(iq, np.complex64))
    raw = iq.view(np.float32).tobytes()
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(1)
    bound_port = srv.getsockname()[1]
    step = chunk_blocks * C.BLOCK_SIZE * 8  # bytes per send

    def run() -> None:
        conn, _ = srv.accept()
        try:
            nxt = time.monotonic()
            for off in range(0, len(raw), step):
                conn.sendall(raw[off: off + step])
                if rate_factor > 0:
                    nxt += chunk_blocks * C.BLOCK_SECONDS / rate_factor
                    dt = nxt - time.monotonic()
                    if dt > 0:
                        time.sleep(dt)
        except OSError:
            pass
        finally:
            conn.close()
            srv.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return bound_port, t
