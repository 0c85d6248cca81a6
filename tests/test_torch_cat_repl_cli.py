"""The port's CAT server, operator session and CLI against t41x's.

The same Kenwood command transcript gives the same responses and the
same radio configs on the TS-890 and TS-2000 handlers (and over TCP);
the same operator-session transcript gives the same replies, load
figures masked, with the same display taps and the same `cal rx`
loopback, and the same `cal tx` and `mode ft8`.  `cli info` prints the
same config; `python -m t41x_torch.cli rx --device cpu` writes audio
within 55 dB SNR of `t41x.cli rx`'s on the same capture; `ft8` (I/Q and
mono audio captures) and `psk31` print t41x's decodes.
"""

import contextlib
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from t41x import cli as j_cli
from t41x.io import cat as j_cat, repl as j_repl, signals, wav as j_wav
from t41x.radio import Radio as JRadio
from t41x.runner import StreamRunner as JRunner
from t41x_torch import cli as t_cli
from t41x_torch.io import cat as t_cat, repl as t_repl, wav as t_wav
from t41x_torch.radio import Radio
from t41x_torch.runner import StreamRunner
from t41x_torch.utils import parity

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CAT_TRANSCRIPT = [
    "AI", "ID", "PS", "PS1", "FA", "FA00007074000", "FA", "FB", "FC",
    "FB00014074000", "FI03", "FI12", "FI", "FR", "FR1", "FR0", "FS", "FS0",
    "FS", "FT", "FT1", "FT0", "GT", "GT3", "GT", "NF", "NF0012", "NF", "NG",
    "NG1", "NG", "OM", "OM02", "OM0", "OM05", "PC", "PC050", "PC", "SP",
    "SP1", "SP", "TM1700000000", "MD", "MD1", "MD3", "MD", "MD9", "IF", "BU",
    "BD2", "BU3", "BD", "ME", "ME1", "ME", "ME2", "KS", "KS025", "KS", "SM",
    "TX", "IF", "RX", "IF", "ZZ", "", " md; ",
]


@pytest.mark.parametrize("variant", ["ts890", "ts2000"])
def test_cat_transcripts_equal(variant):
    j, t = JRadio(), Radio(device="cpu")
    jh = (j_cat.CATHandlerTS2000 if variant == "ts2000"
          else j_cat.CATHandler)(j)
    th = (t_cat.CATHandlerTS2000 if variant == "ts2000"
          else t_cat.CATHandler)(t)
    for cmd in CAT_TRANSCRIPT:
        for h in (jh, th):
            h.smeter_dbm = -61.5
        assert th.handle_command(cmd) == jh.handle_command(cmd), cmd
        assert t.config.to_dict() == j.config.to_dict(), cmd
        assert th.tx == jh.tx
    stream = "FA;MD;IF;FA00021074000;BU;IF;SM;"
    assert th.handle_stream(stream) == jh.handle_stream(stream)
    assert t.config.to_dict() == j.config.to_dict()


def test_cat_server_over_tcp():
    radio = Radio(device="cpu")
    srv = t_cat.CATServer(radio, variant="ts2000")
    try:
        assert t_cat.cat_query(srv.port, "ID;") == "ID019;"
        assert t_cat.cat_query(srv.port, "FA00007074000;") == ""
        assert radio.config.band.name == "40M"
        want = j_cat.CATHandlerTS2000(JRadio()).handle_command(
            "FA00007074000")
        assert want == ""
    finally:
        srv.close()


SESSION = [
    "help", "status", "freq 14100000", "freq +", "freq -", "tune 1500",
    "tune +", "tune -", "tune 150000", "step", "step 2", "band 40M",
    "band 3", "mode am", "mode xyz", "agc fast", "agc 1", "agc 9", "vol 80",
    "vol +", "vol -", "vol 500", "rf", "rf 9", "rf auto on", "rf auto off",
    "rf 99", "nr 2", "zoom 3", "filter 100 2500", "eq rx", "eq rx on",
    "eq rx 3 55", "eq tx 14 10", "eq", "mic", "mic gain 5 comp 3",
    "mic gain", "fav", "fav set 3", "fav", "fav 3", "fav 7", "spectrum",
    "audio", "smeter", "save {cfg}", "band 10M", "load {cfg}", "status",
    "cal", "cal rx", "cal tx", "mode psk31", "bogus", "", "quit",
]


def _mask(reply: str) -> str:
    return re.sub(r"load [0-9.]+%", "load <masked>%", reply)


def _rx_hardware(iq):
    i, q = iq.real, iq.imag
    return (0.93 * i - 0.04 * q) + 1j * q


def test_operator_session_transcripts_equal(tmp_path):
    cfg = str(tmp_path / "cfg.json")
    jr, tr = JRunner(JRadio()), StreamRunner(Radio(device="cpu"))
    js, ts = j_repl.OperatorSession(jr), t_repl.OperatorSession(tr)
    for line in SESSION:
        line = line.format(cfg=cfg)
        want = _mask(js.execute(line))
        assert _mask(ts.execute(line)) == want, line
        assert tr.radio.config.to_dict() == jr.radio.config.to_dict(), line
    assert ts.closed and js.closed

    # the same display taps render the same art
    rng = np.random.default_rng(8)
    rf_db = rng.uniform(-120, -40, 512).astype(np.float32)
    aus = rng.uniform(1e-9, 1e-3, 512).astype(np.float32)
    for r in (jr, tr):
        r.last_rf_spectrum_db, r.last_audio_spectrum = rf_db, aus
        r.last_smeter_dbm = -87.25
    for line in ("spectrum", "audio", "smeter", "zoom 2", "spectrum"):
        assert ts.execute(line) == js.execute(line), line

    # cal rx through the same simulated loopback
    jl = j_repl.OperatorSession(jr, loopback=_rx_hardware)
    tl = t_repl.OperatorSession(tr, loopback=_rx_hardware)
    want = jl.execute("cal rx 1000")
    assert "image rejection" in want
    assert tl.execute("cal rx 1000") == want
    assert tr.radio.config.to_dict() == jr.radio.config.to_dict()
    # the TX slice's cal tx and the decoder slice's mode ft8
    want = jl.execute("cal tx")
    assert "image rejection" in want
    assert tl.execute("cal tx") == want
    assert tl.execute("mode ft8") == jl.execute("mode ft8") == "mode ft8"
    assert tr.radio.config.to_dict() == jr.radio.config.to_dict()


def test_interactive_session_over_streams():
    out = io.StringIO()
    t_repl.interactive(StreamRunner(Radio(device="cpu")),
                       io.StringIO("band 20M\nvol 30\nquit\n"), out)
    ref = io.StringIO()
    j_repl.interactive(JRunner(JRadio()),
                       io.StringIO("band 20M\nvol 30\nquit\n"), ref)
    assert out.getvalue() == ref.getvalue()


def _run_main(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_cli_info_equal(tmp_path):
    assert _run_main(t_cli.main, ["info"]) == _run_main(j_cli.main, ["info"])
    cfg = str(tmp_path / "c.json")
    r = JRadio()
    r.set_band("15M")
    r.set_volume(22)
    r.config.save(cfg)
    got = _run_main(t_cli.main, ["--config", cfg, "info", "--device", "cpu"])
    assert got == _run_main(j_cli.main, ["--config", cfg, "info"])
    assert '"current_band": 4' in got[1]


def test_cli_rx_matches_t41x(tmp_path):
    n = 6 * 2048
    iq = (signals.usb_signal([800.0, 1700.0], n, amps=[0.2, 0.1])
          + signals.awgn(n, 0.01, seed=9)).astype(np.complex64)
    cap = str(tmp_path / "cap.wav")
    t_wav.write_iq_wav(cap, iq, 192_000)
    j_out, t_out = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    rc, text, _ = _run_main(j_cli.main, ["rx", "--in", cap, "--out", j_out,
                                         "--nco", "200"])
    assert rc == 0 and "wrote" in text
    res = subprocess.run(
        [sys.executable, "-m", "t41x_torch.cli", "rx", "--device", "cpu",
         "--in", cap, "--out", t_out, "--nco", "200", "--ascii-spectrum"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert f"wrote {t_out}: {n // 8} samples" in res.stdout
    assert "#" in res.stdout
    want, rate = j_wav.read_wav(j_out)
    got, t_rate = t_wav.read_wav(t_out)
    assert rate == t_rate == 24000 and got.shape == want.shape
    assert parity.snr_db(want, got) >= parity.AUDIO_SNR_MIN_DB


def test_cli_operate_runs_a_live_session(tmp_path):
    cap = str(tmp_path / "cap.wav")
    t_wav.write_iq_wav(cap, (signals.usb_signal([900.0], 8 * 2048) * 0.3
                             ).astype(np.complex64), 192_000)
    res = subprocess.run(
        [sys.executable, "-m", "t41x_torch.cli", "operate", "--device",
         "cpu", "--in", cap, "--rate-factor", "0"],
        input="tune 500\nstatus\nquit\n", cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "t41x operator session" in res.stdout
    assert "nco 500 Hz" in res.stdout and "bye" in res.stdout
    # how many blocks the pump has run by then depends on the clock
    assert re.search(r"blocks \d+ +load [0-9.]+%", res.stdout), res.stdout


@pytest.mark.parametrize("cmd", ["ft8", "psk31"])
def test_cli_decoders_exit_nonzero(cmd, tmp_path):
    """Until the decoder slice these exited non-zero; now they print
    t41x's decodes: ft8 from a mono 12 kHz audio recording (resampled
    to 24 kHz, the reference's WAV test mode), psk31 from an I/Q
    capture (the FT8 I/Q path: tests/test_torch_ft8_radio.py)."""
    from t41x.decode import psk31
    from t41x.decode.ft8 import encode

    cap = str(tmp_path / "cap.wav")
    if cmd == "ft8":
        audio = encode.synth_audio(encode.encode("CQ K1ABC FN42"),
                                   base_freq=1100.0, rate=12000.0, amp=0.3)
        slot = np.zeros(14 * 12000, np.float32)
        slot[6000:6000 + len(audio)] = audio
        slot += 0.05 * np.random.default_rng(3).standard_normal(
            slot.size).astype(np.float32)
        t_wav.write_wav(cap, slot, 12000)
        args = [cmd, "--in", cap]
    else:
        iq = psk31.synth_psk31("CQ DE T41", tone_hz=1000.0)
        t_wav.write_iq_wav(cap, iq[: len(iq) // 2048 * 2048], 192_000)
        args = [cmd, "--in", cap, "--tone", "1000"]
    rc, out, err = _run_main(t_cli.main, args + ["--device", "cpu"])
    want = _run_main(j_cli.main, args)
    assert rc == want[0] == 0, err
    assert ("CQ K1ABC FN42" if cmd == "ft8" else "CQ DE T41") in out
    if cmd == "ft8":
        # the SNR figure follows the score (tests/test_torch_ft8.py)
        def strip(o):
            return [re.sub(r"[+-]\d+\.\d dB", "<snr>", line)
                    for line in o.splitlines()]
        assert strip(out) == strip(want[1])
    else:
        assert out == want[1]
