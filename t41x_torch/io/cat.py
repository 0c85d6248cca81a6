"""Kenwood CAT control server (host side): port of `t41x.io.cat`.

Re-expression of the reference's WSJT-X CAT interface (tmr4/T41_SDR
`wsjt.cpp:170-463` `WSJTLoop`): Kenwood TS-890S emulation over
';'-terminated two-letter commands, serving rig-control clients
(WSJT-X, flrig, ...).  The reference speaks USB serial; t41x serves TCP
(and offers `handle_command` directly for in-process/testing use).

Supported commands mirror the reference: AI, BU/BD (with optional step
count), FA/FB/FC, FI (tune-increment tables), FR/FT (query + VFO
select), FS (fine-tune on/off), GT (AGC), ID, IF, KS, MD/ME, NF/NG
(noise floor), OM, PC (TX power), PS, SM, SP (split), TM (clock set),
TX/RX, plus graceful '?;' for the rest.  The reference also carries a
Kenwood TS-2000 variant (`WSJTLoopTS2000` `wsjt.cpp:494`, shipped
commented out — "WSJT-X had trouble with this"); t41x provides it as
`CATHandlerTS2000` (ID019, TS-2000 IF status layout, inverted PS
convention) selectable via `CATServer(variant="ts2000")`.

Bound to the port's `Radio`; the command set and every response string
are `t41x`'s.
"""

from __future__ import annotations

import socket
import socketserver
import threading
import time

from t41x_torch.radio import Radio

# Kenwood mode numbers (wsjt.cpp:115-140)
_MODE_TO_KENWOOD = {"lsb": 1, "usb": 2, "cw": 3, "nfm": 4, "am": 5,
                    "sam": 5, "ft8": 2, "psk31": 2}
_KENWOOD_TO_MODE = {1: "lsb", 2: "usb", 3: "cw", 4: "nfm", 5: "am"}

# Kenwood band numbers (wsjt.cpp:83-111) -> t41x band-table index
_BAND_TO_KENWOOD = {"80M": 1, "40M": 2, "20M": 4, "17M": 5, "15M": 6,
                    "12M": 7, "10M": 8}


class CATHandler:
    """Stateless-ish command interpreter bound to a Radio."""

    def __init__(self, radio: Radio):
        self.radio = radio
        self.smeter_dbm = -100.0
        self.tx = False
        self.clock_offset = 0   # CAT TM; seconds vs host clock

    # ------------------------------------------------------------------
    def handle_command(self, cmd: str) -> str:
        """One ';'-stripped command -> response (may be '')."""
        cfg = self.radio.config
        c = cmd.strip().rstrip(";")
        if not c:
            return ""
        head = c[:2].upper()
        body = c[2:]

        if head == "AI":
            return "AI0;"
        if head == "ID":
            return "ID024;"  # TS-890S (wsjt.cpp:325)
        if head == "PS":
            return "PS1;"
        if head == "FA":
            if body:
                self._set_freq(int(body))
                return ""
            return f"FA{cfg.center_freq + int(cfg.nco_freq):011d};"
        if head in ("FB", "FC"):
            if body:
                self._set_freq(int(body))
                return ""
            return f"{head}{cfg.center_freq:011d};"
        if head == "FI":
            # FI0n; / FI1n; — center / fine tune increment (wsjt.cpp:266)
            if len(body) >= 2:
                which, idx = body[0], int(body[1:])
                if which == "0":
                    self.radio.change_freq_increment(idx - cfg.tune_index)
                else:
                    self.radio.change_ft_increment(idx - cfg.ft_index)
            return ""
        if head == "FR":
            if body:    # select VFO (wsjt.cpp:281)
                if ("B" if int(body) else "A") != cfg.active_vfo:
                    self.radio.toggle_vfo()
                return ""
            return "FR0;"
        if head == "FS":
            # fine tune on/off (wsjt.cpp:288 SetFtActive)
            if body:
                cfg.fine_tune_active = bool(int(body))
                return ""
            return f"FS{int(cfg.fine_tune_active)};"
        if head == "FT":
            if body:    # select VFO
                if ("B" if int(body) else "A") != cfg.active_vfo:
                    self.radio.toggle_vfo()
                return ""
            return "FT1;"
        if head == "GT":
            # AGC mode (wsjt.cpp:315)
            if body:
                self.radio.set_agc(int(body))
                return ""
            return f"GT{cfg.agc_mode};"
        if head == "NF":
            # spectrum noise floor for the current band (wsjt.cpp:369)
            if body:
                self.radio.set_noise_floor(int(body))
                return ""
            return f"NF{cfg.band.noise_floor:04d};"
        if head == "NG":
            # live noise-floor adjust flag (wsjt.cpp:376)
            if body:
                cfg.live_noise_floor = bool(int(body))
                return ""
            return f"NG{int(cfg.live_noise_floor)};"
        if head == "OM":
            # operating demod mode per receiver item (wsjt.cpp:390)
            if len(body) >= 2:
                mode = _KENWOOD_TO_MODE.get(int(body[1]))
                if mode:
                    self.radio.set_mode(mode)
                return ""
            item = body or "0"
            return f"OM{item}{_MODE_TO_KENWOOD.get(cfg.band.mode, 1)};"
        if head == "PC":
            # transmit power (wsjt.cpp:407)
            if body:
                self.radio.set_transmit_power(int(body))
                return ""
            return f"PC{int(cfg.transmit_power):03d};"
        if head == "SP":
            # split VFO (wsjt.cpp:425)
            if body:
                self.radio.set_split(bool(int(body)))
                return ""
            return f"SP{int(cfg.split_on)};"
        if head == "TM":
            # set radio clock from host epoch (wsjt.cpp:434); t41x keeps
            # an offset instead of mutating the system clock
            if body:
                self.clock_offset = int(body) - int(time.time())
            return ""
        if head == "MD":
            if body:
                mode = _KENWOOD_TO_MODE.get(int(body[0]))
                if mode:
                    self.radio.set_mode(mode)
                return ""
            return f"MD{_MODE_TO_KENWOOD.get(cfg.band.mode, 1)};"
        if head == "IF":
            freq = cfg.center_freq + int(cfg.nco_freq)
            mode = _MODE_TO_KENWOOD.get(cfg.band.mode, 1)
            return (f"IF{freq:011d}{5000:04d}{0:+06d}00"
                    f"00{0:02d}{0 if self.tx else 1}{mode}0000"
                    f"1{0:02d}0;")
        if head in ("BU", "BD"):
            # optional step count (wsjt.cpp:201-215 BUn;/BDn;)
            step = int(body) if body else 1
            if head == "BD":
                step = -step
            idx = (cfg.current_band + step) % len(cfg.bands)
            self.radio.set_band(idx)
            return f"{head}0{_BAND_TO_KENWOOD.get(cfg.band.name, 2)};"
        if head == "ME":
            # operating mode SSB/CW/DATA (wsjt.cpp:362 ChangeMode)
            if body:
                cfg.op_mode = {0: "ssb", 1: "cw", 2: "data"}.get(
                    int(body), "ssb")
                return ""
            return f"ME{ {'ssb': 0, 'cw': 1, 'data': 2}[cfg.op_mode] };"
        if head == "KS":
            if body:
                cfg.cw_wpm = int(body)
                return ""
            return f"KS{cfg.cw_wpm:03d};"
        if head == "SM":
            # 0..30 scaled from dBm (S9 = -73)
            level = max(0, min(30, int((self.smeter_dbm + 127) / 3)))
            return f"SM{0}{level:04d};"
        if head == "TX":
            self.tx = True
            return ""
        if head == "RX":
            self.tx = False
            return ""
        return "?;"

    def handle_stream(self, data: str) -> str:
        """Split a ';'-separated stream into commands; concatenate
        responses."""
        out = []
        for part in data.split(";"):
            if part.strip():
                out.append(self.handle_command(part))
        return "".join(out)

    def _set_freq(self, hz: int) -> None:
        cfg = self.radio.config
        # pick the band containing the frequency, like ChangeBand
        for i, b in enumerate(cfg.bands):
            if b.band_low <= hz <= b.band_high:
                if i != cfg.current_band:
                    self.radio.set_band(i)
                break
        cfg.center_freq = hz
        cfg.nco_freq = 0.0


class CATHandlerTS2000(CATHandler):
    """Kenwood TS-2000 emulation (`WSJTLoopTS2000` `wsjt.cpp:494-740`):
    same command set, but ID019, the TS-2000 `IF` status layout, and the
    Kenwood-manual PS convention (`PS0;` = on, `wsjt.cpp:697-699`)."""

    def handle_command(self, cmd: str) -> str:
        cfg = self.radio.config
        c = cmd.strip().rstrip(";")
        head = c[:2].upper()
        body = c[2:]
        if head == "ID":
            return "ID019;"  # TS-2000 (wsjt.cpp:629)
        if head == "PS" and not body:
            return "PS0;"    # manual has 0=On (wsjt.cpp:698)
        if head == "IF" and not body:
            # wsjt.cpp:632-651: freq, step, RIT, RIT/XIT flags, bank,
            # RX/TX, mode, VFO, scan, split, CTCSS on, tone, shift
            freq = cfg.center_freq + int(cfg.nco_freq)
            mode = _MODE_TO_KENWOOD.get(cfg.band.mode, 1)
            vfo = 1 if cfg.active_vfo == "B" else 0
            return (f"IF{freq:011d}{5000:04d}{0:+06d}00"
                    f"0{0:02d}{0 if self.tx else 1}{mode}{vfo}0"
                    f"{int(cfg.split_on)}0{1:02d}0;")
        return super().handle_command(cmd)


class CATServer:
    """TCP server speaking the CAT protocol (default port 4532-style)."""

    def __init__(self, radio: Radio, host: str = "127.0.0.1",
                 port: int = 0, variant: str = "ts890"):
        handler = (CATHandlerTS2000 if variant == "ts2000"
                   else CATHandler)(radio)
        self.handler = handler

        class _TCP(socketserver.StreamRequestHandler):
            def handle(self):
                buf = ""
                while True:
                    data = self.request.recv(4096)
                    if not data:
                        break
                    buf += data.decode(errors="replace")
                    while ";" in buf:
                        cmd, buf = buf.split(";", 1)
                        resp = handler.handle_command(cmd)
                        if resp:
                            self.request.sendall(resp.encode())

        self._srv = socketserver.ThreadingTCPServer((host, port), _TCP)
        self._srv.daemon_threads = True
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


def cat_query(port: int, command: str, host: str = "127.0.0.1") -> str:
    """Test/client helper: send one command, read the response."""
    with socket.create_connection((host, port), timeout=5) as s:
        s.sendall(command.encode())
        s.settimeout(2)
        try:
            return s.recv(4096).decode()
        except socket.timeout:
            return ""
