"""t41x_torch command-line interface: port of `t41x.cli`.

    python -m t41x_torch.cli rx      --in cap.wav --mode usb --out audio.wav
    python -m t41x_torch.cli cw      --in cap.wav
    python -m t41x_torch.cli operate --in cap.wav
    python -m t41x_torch.cli info

Captures are stereo WAV files (L=I, R=Q) at 192 kHz.  Config persists to
--config (JSON, the EEPROM/SD analog; the same file `t41x` reads).
Each subcommand takes --device (default cuda; cpu runs the chain's
plain torch versions).  `ft8` and `psk31` exit non-zero: the decoders
are not in the port yet.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="t41x_torch")
    ap.add_argument("--config", default=None,
                    help="JSON config path (persisted)")
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default="cuda",
                     help="torch device of the chain (default cuda)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rx = sub.add_parser("rx", parents=[dev],
                        help="demodulate a capture to audio")
    rx.add_argument("--in", dest="inp", required=True)
    rx.add_argument("--out", default=None, help="output audio WAV")
    rx.add_argument("--mode", default=None,
                    choices=["usb", "lsb", "am", "sam", "nfm", "cw"])
    rx.add_argument("--nco", type=float, default=None)
    rx.add_argument("--flo", type=float, default=None)
    rx.add_argument("--fhi", type=float, default=None)
    rx.add_argument("--agc", type=int, default=None)
    rx.add_argument("--nr", type=int, default=None)
    rx.add_argument("--panadapter", default=None, metavar="PNG",
                    help="render spectrum+waterfall of the capture")
    rx.add_argument("--ascii-spectrum", action="store_true",
                    help="print a terminal spectrum of the capture")

    for name in ("ft8", "cw", "psk31"):
        p = sub.add_parser(name, parents=[dev],
                           help=f"decode {name} from a capture")
        p.add_argument("--in", dest="inp", required=True)
        p.add_argument("--nco", type=float, default=None)
        if name == "psk31":
            p.add_argument("--tone", type=float, default=1000.0)

    sub.add_parser("info", parents=[dev], help="print configuration")

    op = sub.add_parser("operate", parents=[dev],
                        help="live operator session over a capture stream "
                             "(tune/band/mode + ASCII panadapter)")
    op.add_argument("--in", dest="inp", required=True)
    op.add_argument("--rate-factor", type=float, default=1.0,
                    help="stream pacing vs real time (0 = flat out)")
    op.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="also serve the session on this TCP port")

    args = ap.parse_args(argv)

    from t41x_torch.config import RadioConfig

    cfg = RadioConfig.load(args.config) if args.config else RadioConfig()

    if args.cmd == "info":
        print(json.dumps(cfg.to_dict(), indent=2))
        return 0

    if args.cmd in ("ft8", "psk31"):
        from t41x_torch.radio import DECODERS_TODO

        print(f"t41x_torch {args.cmd}: {DECODERS_TODO}", file=sys.stderr)
        return 2

    import numpy as np

    from t41x_torch.io import wav
    from t41x_torch.radio import Radio

    radio = Radio(cfg, device=args.device)

    if args.cmd == "operate":
        import threading
        import time

        from t41x_torch.io import repl as repl_mod
        from t41x_torch.io.runtime import CaptureStreamer
        from t41x_torch.runner import StreamRunner

        iq, rate = wav.read_iq_wav(args.inp)
        runner = StreamRunner(radio)
        runner.prime()
        streamer = CaptureStreamer(runner.ring, iq,
                                   rate_factor=args.rate_factor)
        stop = threading.Event()

        def pump():
            while not stop.is_set():
                if runner.step() is None:
                    time.sleep(0.002)

        pump_thread = threading.Thread(target=pump)
        pump_thread.start()
        # let the first blocks land so spectrum/status have data
        t0 = time.monotonic()
        while runner.blocks_processed == 0 and time.monotonic() - t0 < 3.0:
            time.sleep(0.01)
        srv = repl_mod.OperatorServer(runner, port=args.serve) \
            if args.serve else None
        if srv:
            print(f"operator session on tcp port {srv.port}")
        try:
            repl_mod.interactive(runner)
        finally:
            stop.set()
            pump_thread.join(timeout=10)
            streamer.stop()
            if srv:
                srv.close()
        if args.config:
            cfg.save(args.config)
        return 0

    iq, rate = wav.read_iq_wav(args.inp)
    if args.nco is not None:
        radio.set_fine_tune(args.nco)

    if args.cmd == "rx":
        if args.mode:
            radio.set_mode(args.mode)
        if args.flo is not None or args.fhi is not None:
            radio.set_filter(args.flo if args.flo is not None
                             else cfg.band.f_lo_cut,
                             args.fhi if args.fhi is not None
                             else cfg.band.f_hi_cut)
        if args.agc is not None:
            radio.set_agc(args.agc)
        if args.nr is not None:
            radio.set_nr(args.nr)
        out = radio.receive(iq)
        audio = out["audio_24k"]
        peak = float(abs(audio).max() or 1.0)
        if args.out:
            wav.write_wav(args.out, audio / (1.05 * peak), 24000)
            print(f"wrote {args.out}: {audio.shape[-1]} samples @24 kHz")
        m = radio.metrics
        print(f"processed {m['input_samples']} samples in "
              f"{m['wall_s']:.2f} s ({m['realtime_channels']:.1f}x realtime)")
        if (args.panadapter or args.ascii_spectrum) \
                and "rf_spectrum" in out:
            from t41x_torch.io import display
            spec_blocks = out["rf_spectrum"]
            spec_blocks = spec_blocks.reshape(-1, display.SPECTRUM_RES)
            spec_db = 10.0 * np.log10(np.maximum(spec_blocks, 1e-30))
            spec_db -= np.median(spec_db[-1])   # noise floor at 0 dB
            if args.panadapter:
                img = display.render_panadapter(
                    spec_db[-1], spec_db[::-1],
                    f_lo=cfg.band.f_lo_cut, f_hi=cfg.band.f_hi_cut,
                    span_hz=192_000 / (1 << max(cfg.spectrum_zoom, 0)))
                display.save_png(args.panadapter, img)
                print(f"wrote {args.panadapter}: {img.shape[1]}x"
                      f"{img.shape[0]} panadapter")
            if args.ascii_spectrum:
                print(display.ascii_spectrum(spec_db[-1]))
    elif args.cmd == "cw":
        print(radio.decode_cw(iq))

    if args.config:
        cfg.save(args.config)
    return 0


if __name__ == "__main__":
    sys.exit(main())
