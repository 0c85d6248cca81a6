"""Live operator control session — the encoder/menu surface as a REPL:
port of `t41x.io.repl`.

The reference's defining operating mode is live interaction while the
DSP runs: rotary encoders retune mid-stream (`Encoders.cpp:148-309`),
buttons switch band/mode (`ButtonProc.cpp:56-315`), menus edit values
with immediate effect (`Menu.cpp:225-318`, `MenuProc.cpp`), and the LCD
panadapter refreshes continuously (`Display.cpp:240`).  t41x maps that
to a line-command session over a live `StreamRunner`: every command
stages a control change that takes effect between blocks (never racing
the DSP), and `spectrum`/`smeter` render the latest display taps as
ASCII — usable interactively over stdin or a TCP socket.

    session = OperatorSession(runner)
    session.execute("tune 40000")       # NCO fine tune, mid-stream
    session.execute("band 40M")         # band switch, chain swap
    print(session.execute("spectrum"))  # ASCII panadapter

`serve_tcp(session)` exposes the same commands newline-delimited on a
socket (multi-line replies are blank-line terminated).

The commands and their replies are `t41x`'s.  `cal rx` runs the port's
IQ correction on the radio's device; `cal tx` needs the transmit chain,
which the port does not have yet, and says so.
"""

from __future__ import annotations

import socket
import socketserver
import threading

import numpy as np

from t41x_torch import constants as C

AGC_NAMES = {"off": 0, "long": 1, "slow": 2, "med": 3, "fast": 4}
AGC_LABELS = {v: k for k, v in AGC_NAMES.items()}
MODES = ("usb", "lsb", "am", "sam", "nfm", "cw", "ft8", "psk31")

HELP = """\
commands:
  freq <hz>|+|-     set center (VFO) frequency / nudge by the increment
  tune <hz>|+|-     NCO fine tune / nudge by the fine-tune step
  step [n]          cycle the center-tune increment table
  band <name|idx>   switch band (80M 40M 20M 17M 15M 12M 10M)
  mode <m>          set demod mode: usb lsb am sam nfm cw ft8 psk31
  agc <m>           off long slow med fast (or 0-4)
  vol <0-100>|+|-   audio volume / nudge by 5
  rf [g|auto on|off] band RF gain 0-15 / digitizer auto-gain
  nr <0-3>          noise reduction: off kim spectral lms
  zoom <z>          spectrum zoom (-1 off, 0 = x1, n = x2^n)
  filter <lo> <hi>  audio band-pass cuts, Hz
  eq rx|tx [on|off] toggle 14-band EQ / show band gains
  eq rx|tx <b> <g>  set EQ band b (1-14) gain 0-100, live
  mic [gain <db>] [comp <ratio>]   mic gain / compression
  fav               list favorite frequency slots
  fav set <slot>    store current frequency in slot 0-12
  fav <slot>        recall favorite (auto band switch)
  spectrum          ASCII panadapter of the latest RF spectrum
  audio             ASCII spectrum of the latest audio tap
  smeter            S-meter reading (dBm)
  cal tx [tone_hz]  TX IQ calibration via the attached loopback
  cal rx [tone_hz]  RX IQ calibration via the attached loopback
  save <path>       persist config (the EEPROM/SD menu)
  load <path>       restore config
  status            current settings + load
  help              this text
  quit              end session"""


class OperatorSession:
    """Command interpreter bound to a live StreamRunner (or a bare Radio
    for offline configuration).

    `loopback`: optional callable iq -> iq used by `cal tx` — the
    TX->RX path (real hardware, or a simulated impairment in tests),
    the role the QSE/QSD loopback plays in the reference's
    `DoXmitCalibrate` (`Process2.cpp:226`)."""

    def __init__(self, runner, loopback=None):
        self.runner = runner
        self.radio = runner.radio
        self.loopback = loopback
        self.closed = False

    # ------------------------------------------------------------------
    def execute(self, line: str) -> str:
        parts = line.strip().split()
        if not parts:
            return ""
        cmd, args = parts[0].lower(), parts[1:]
        try:
            return self._dispatch(cmd, args)
        except (ValueError, IndexError, KeyError) as e:
            return f"error: {e}"

    def _dispatch(self, cmd: str, args: list[str]) -> str:
        radio = self.radio
        cfg = radio.config
        if cmd == "help":
            return HELP
        if cmd == "quit":
            self.closed = True
            return "bye"
        if cmd == "freq":
            if args[0] in ("+", "-"):
                from t41x_torch.config import FREQ_INCREMENTS
                inc = FREQ_INCREMENTS[cfg.tune_index]
                cfg.center_freq += inc if args[0] == "+" else -inc
            else:
                cfg.center_freq = int(float(args[0]))
            return f"center {cfg.center_freq} Hz"
        if cmd == "tune":
            if args[0] in ("+", "-"):
                # encoder detent: one fine-tune step (EncoderFineTuneISR)
                step = cfg.fine_tune_step
                radio.set_fine_tune(
                    cfg.nco_freq + (step if args[0] == "+" else -step))
            else:
                radio.set_fine_tune(float(args[0]))
            return (f"nco {cfg.nco_freq:.0f} Hz "
                    f"(center {cfg.center_freq} Hz)")
        if cmd == "step":
            inc = radio.change_freq_increment(int(args[0]) if args else 1)
            return f"tune increment {inc} Hz"
        if cmd == "band":
            radio.set_band(args[0] if not args[0].isdigit()
                           else int(args[0]))
            return (f"band {cfg.band.name} "
                    f"center {cfg.center_freq} Hz mode {cfg.band.mode}")
        if cmd == "mode":
            if args[0] not in MODES:
                raise ValueError(f"mode must be one of {MODES}")
            if args[0] == "ft8":
                from t41x_torch.radio import DECODERS_TODO

                # the live runner would stop at its next block
                raise ValueError(f"live FT8 decoding is {DECODERS_TODO}")
            radio.set_mode(args[0])
            return f"mode {args[0]}"
        if cmd == "agc":
            mode = AGC_NAMES.get(args[0], None)
            if mode is None:
                mode = int(args[0])
            radio.set_agc(mode)
            return f"agc {AGC_LABELS[cfg.agc_mode]}"
        if cmd == "vol":
            if args[0] in ("+", "-"):
                radio.set_volume(cfg.audio_volume
                                 + (5 if args[0] == "+" else -5))
            else:
                radio.set_volume(int(args[0]))
            return f"volume {cfg.audio_volume}"
        if cmd == "rf":
            # the RF-set menu (MenuProc.cpp:123): band gain + auto-gain
            if not args:
                return (f"rf gain {cfg.band.rf_gain}  "
                        f"auto {'on' if cfg.auto_rf_gain else 'off'}")
            if args[0] == "auto":
                radio.set_auto_rf_gain(len(args) < 2 or args[1] == "on")
                return f"rf auto {'on' if cfg.auto_rf_gain else 'off'}"
            cfg.band.rf_gain = max(0, min(int(args[0]), 15))
            return f"rf gain {cfg.band.rf_gain}"
        if cmd == "save":
            cfg.save(args[0])
            return f"config saved to {args[0]}"
        if cmd == "load":
            from t41x_torch.config import RadioConfig

            self.radio.config = RadioConfig.load(args[0])
            self.radio._chain = None
            return f"config loaded from {args[0]}"
        if cmd == "cal":
            if not args or args[0] not in ("tx", "rx"):
                raise ValueError("usage: cal tx|rx [tone_hz]")
            tone = float(args[1]) if len(args) > 1 else 1000.0
            return (self._cal_tx(tone) if args[0] == "tx"
                    else self._cal_rx(tone))
        if cmd == "eq":
            return self._eq(args)
        if cmd == "mic":
            return self._mic(args)
        if cmd == "fav":
            if not args:
                favs = cfg.favorites
                if not any(favs):
                    return "no favorites stored (fav set <slot>)"
                return "\n".join(f"{i:2d}: {f/1e6:.4f} MHz"
                                 for i, f in enumerate(favs) if f)
            if args[0] == "set":
                slot = int(args[1])
                freq = radio.save_favorite(slot)
                return f"favorite {slot} = {freq/1e6:.4f} MHz"
            freq = radio.recall_favorite(int(args[0]))
            return (f"recalled {freq/1e6:.4f} MHz "
                    f"(band {cfg.band.name})")
        if cmd == "nr":
            radio.set_nr(int(args[0]))
            return f"nr {cfg.nr_mode}"
        if cmd == "zoom":
            radio.set_zoom(int(args[0]))
            return f"zoom {cfg.spectrum_zoom}"
        if cmd == "filter":
            radio.set_filter(float(args[0]), float(args[1]))
            return f"filter {cfg.band.f_lo_cut}..{cfg.band.f_hi_cut} Hz"
        if cmd == "spectrum":
            return self._render_rf_spectrum()
        if cmd == "audio":
            return self._render_audio_spectrum()
        if cmd == "smeter":
            dbm = self.runner.last_smeter_dbm
            return "no data yet" if dbm is None else f"{dbm:.1f} dBm"
        if cmd == "status":
            return self._status()
        raise ValueError(f"unknown command {cmd!r} (try 'help')")

    # ------------------------------------------------------------------
    def _eq(self, args: list[str]) -> str:
        """The EQ set menus (`MenuProc.cpp:318` receive, `:348`
        transmit): toggle the 14-band EQ and edit band gains live."""
        cfg = self.radio.config
        if not args or args[0] not in ("rx", "tx"):
            raise ValueError("usage: eq rx|tx [on|off | <band> <gain>]")
        which = args[0]
        gains = cfg.equalizer_rec if which == "rx" else cfg.equalizer_xmt
        if len(args) == 1:
            on = cfg.receive_eq_on if which == "rx" else cfg.xmit_eq_on
            bars = " ".join(f"{g:3d}" for g in gains)
            return f"eq {which} {'on' if on else 'off'}\n{bars}"
        if args[1] in ("on", "off"):
            self.radio.set_eq(which, args[1] == "on")
            return f"eq {which} {args[1]}"
        band, gain = int(args[1]), int(args[2])
        self.radio.set_eq_band(which, band - 1, gain)  # 1-based like menu
        return f"eq {which} band {band} = {gains[band - 1]}"

    def _mic(self, args: list[str]) -> str:
        """The mic gain/compression menu (`MenuProc.cpp:436`)."""
        cfg = self.radio.config
        if not args:
            return (f"mic gain {cfg.mic_gain} dB  "
                    f"compression {cfg.mic_compression:g}"
                    f"{' (off)' if cfg.mic_compression < 0 else ''}")
        it = iter(args)
        for key in it:
            val = next(it, None) if key in ("gain", "comp") else None
            if key == "gain" and val is not None:
                self.radio.set_mic_gain(int(val))
            elif key == "comp" and val is not None:
                self.radio.set_mic_compression(float(val))
            else:
                raise ValueError("usage: mic [gain <db>] [comp <ratio>]")
        return self._mic([])

    def _cal_rx(self, tone_hz: float) -> str:
        """The RX-side calibrate flow (`MenuProc.cpp:491` ->
        `DoReceiveCalibrate` `Process2.cpp:159`): a clean quadrature cal
        tone goes through the TX->RX loopback (which carries the RX
        front end's IQ impairment), the RX amplitude/phase correction
        factors are descended against measured image rejection, then
        written through to the per-band config."""
        if self.loopback is None:
            return ("no TX->RX loopback attached — pass "
                    "OperatorSession(runner, loopback=fn)")
        import torch

        from t41x_torch.chain import cal as cal_mod
        from t41x_torch.chain import rx as rx_mod

        cfg = self.radio.config
        dev = self.radio.device
        n = 4 * C.BLOCK_SIZE
        t = np.arange(n) / C.SAMPLE_RATE
        tone = (0.5 * np.exp(2j * np.pi * tone_hz * t)).astype(np.complex64)
        rx_in = np.asarray(self.loopback(tone))
        i_part = torch.from_numpy(rx_in.real.astype(np.float32)).to(dev)
        q_part = torch.from_numpy(rx_in.imag.astype(np.float32)).to(dev)

        def measure(amp: float, phase: float) -> float:
            corr = rx_mod.iq_correction(
                i_part, q_part,
                torch.tensor(amp, dtype=torch.float32, device=dev),
                torch.tensor(phase, dtype=torch.float32, device=dev))
            return cal_mod.image_rejection_db(corr.cpu().numpy(), tone_hz)

        amp, phase, best = cal_mod.calibrate_iq(
            measure, float(cfg.band.iq_amp_correction),
            float(cfg.band.iq_phase_correction))
        cfg.band.iq_amp_correction = float(amp)
        cfg.band.iq_phase_correction = float(phase)
        return (f"RX cal: amp {amp:.4f} phase {phase:+.4f} "
                f"image rejection {best:.1f} dB")

    def _cal_tx(self, tone_hz: float) -> str:
        """The MenuProc calibrate flow (`DoXmitCalibrate`
        `Process2.cpp:226-293`) drives a cal tone through the SSB
        exciter, which the port does not have yet: the answer says so."""
        if self.loopback is None:
            return ("no TX->RX loopback attached — pass "
                    "OperatorSession(runner, loopback=fn)")
        return ("no TX chain in t41x_torch yet — TX IQ calibration comes "
                "with the TX slice (ROADMAP.md Queue 1, item 3)")

    def _render_rf_spectrum(self) -> str:
        from t41x_torch.io import display

        spec = self.runner.last_rf_spectrum_db
        if spec is None:
            return "no spectrum yet (is the stream running / zoom >= 0?)"
        floor = float(np.percentile(spec, 20))
        art = display.ascii_spectrum(spec, floor_db=floor,
                                     ceil_db=float(spec.max()) + 3.0)
        zoom = self.radio.config.spectrum_zoom
        span = C.SAMPLE_RATE / (1 << max(zoom, 0))
        lo = self.radio.config.center_freq - span / 2
        hi = self.radio.config.center_freq + span / 2
        return f"{art}\n{lo/1e6:.4f} MHz {'':56s} {hi/1e6:.4f} MHz"

    def _render_audio_spectrum(self) -> str:
        from t41x_torch.io import display

        spec = self.runner.last_audio_spectrum
        if spec is None:
            return "no audio spectrum yet"
        db = 10 * np.log10(np.asarray(spec) + 1e-12)
        floor = float(np.percentile(db, 20))
        art = display.ascii_spectrum(db, floor_db=floor,
                                     ceil_db=float(db.max()) + 3.0)
        return f"{art}\n0 Hz {'':66s} {C.AUDIO_RATE/2/1e3:.0f} kHz"

    def _status(self) -> str:
        cfg = self.radio.config
        load = self.runner.load.percent
        return (f"band {cfg.band.name}  center {cfg.center_freq} Hz  "
                f"nco {cfg.nco_freq:+.0f} Hz  mode {cfg.band.mode}\n"
                f"agc {AGC_LABELS.get(cfg.agc_mode, cfg.agc_mode)}  "
                f"vol {cfg.audio_volume}  nr {cfg.nr_mode}  "
                f"zoom {cfg.spectrum_zoom}\n"
                f"blocks {self.runner.blocks_processed}  "
                f"load {load:.1f}%")


class OperatorServer:
    """Newline-delimited TCP server for an OperatorSession.  Replies are
    terminated by one blank line (commands may return multi-line art)."""

    def __init__(self, runner, host: str = "127.0.0.1", port: int = 0):
        session = OperatorSession(runner)
        self.session = session

        class _TCP(socketserver.StreamRequestHandler):
            def handle(self):
                while not session.closed:
                    line = self.rfile.readline()
                    if not line:
                        break
                    reply = session.execute(line.decode(errors="replace"))
                    self.wfile.write(reply.encode() + b"\n\n")
                    self.wfile.flush()

        self._srv = socketserver.ThreadingTCPServer((host, port), _TCP)
        self._srv.daemon_threads = True
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


def interactive(runner, infile=None, outfile=None) -> None:
    """Blocking stdin/stdout session (the CLI entry point)."""
    import sys

    inf = infile or sys.stdin
    outf = outfile or sys.stdout
    session = OperatorSession(runner)
    outf.write("t41x operator session — 'help' for commands\n")
    while not session.closed:
        outf.write("t41x> ")
        outf.flush()
        line = inf.readline()
        if not line:
            break
        reply = session.execute(line)
        if reply:
            outf.write(reply + "\n")
