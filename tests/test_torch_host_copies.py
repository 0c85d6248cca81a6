"""t41x_torch's copies of the JAX-free host modules of t41x, pinned.

The port never imports `t41x`, so it carries copies of `config`,
`chain.{codec_gain,tune,cal}`, `io.{wav,signals,runtime,control,acquire,
display}`, `decode.{cw_text,psk31_varicode,locator,bearing,beacon}`,
`decode.ft8` with its `tables`, `crc`, `message`, `encode` and `slots`,
`utils.debugtrace` and `version`.  Each copy is held two ways: its code
equals the original's (imports read as `t41x`, docstrings aside), and
both give exactly the same results on the same inputs.
"""

import ast
import dataclasses
import importlib
import json
import time
from pathlib import Path

import numpy as np
import pytest

from t41x import config as j_config
from t41x.chain import cal as j_cal, codec_gain as j_cg, tune as j_tune
from t41x.decode import beacon as j_beacon, bearing as j_bearing
from t41x.decode import cw_text as j_cw, locator as j_loc
from t41x.decode import psk31_varicode as j_vari
from t41x.decode.ft8 import crc as j_crc, encode as j_enc
from t41x.decode.ft8 import message as j_msg, slots as j_slots
from t41x.decode.ft8 import tables as j_tables
from t41x.io import acquire as j_acq, control as j_ctl, display as j_disp
from t41x.io import runtime as j_rt, signals as j_sig, wav as j_wav
from t41x.utils import debugtrace as j_dbg
from t41x_torch import config as t_config
from t41x_torch.chain import cal as t_cal, codec_gain as t_cg
from t41x_torch.chain import tune as t_tune
from t41x_torch.decode import beacon as t_beacon, bearing as t_bearing
from t41x_torch.decode import cw_text as t_cw, locator as t_loc
from t41x_torch.decode import psk31_varicode as t_vari
from t41x_torch.decode.ft8 import crc as t_crc, encode as t_enc
from t41x_torch.decode.ft8 import message as t_msg, slots as t_slots
from t41x_torch.decode.ft8 import tables as t_tables
from t41x_torch.io import acquire as t_acq, control as t_ctl
from t41x_torch.io import display as t_disp, runtime as t_rt
from t41x_torch.io import signals as t_sig, wav as t_wav
from t41x_torch.utils import debugtrace as t_dbg

COPIES = ("config", "chain.codec_gain", "chain.tune", "chain.cal", "io.wav",
          "io.signals", "io.runtime", "decode.cw_text", "io.control",
          "io.acquire", "utils.debugtrace", "io.display", "decode.ft8",
          "decode.ft8.tables", "decode.ft8.crc", "decode.ft8.message",
          "decode.ft8.encode", "decode.ft8.slots", "decode.psk31_varicode",
          "decode.locator", "decode.bearing", "decode.beacon", "version")
# functions, classes and imports of an original that its copy leaves
# out: the port's stage times come from `t41x_torch.utils.tracing`, not
# from host wall time around asynchronous GPU work
NOT_COPIED: dict = {"utils.debugtrace": ("StageTimer", "time",
                                         "contextmanager")}


def _code(mod_name: str, drop=()) -> str:
    """The module's AST without docstrings and without the definitions
    and imported names in `drop`, with `t41x_torch` read as `t41x`."""
    src = Path(importlib.import_module(mod_name).__file__).read_text()
    tree = ast.parse(src)
    tree.body = [n for n in tree.body
                 if getattr(n, "name", None) not in drop]
    for n in tree.body:
        if isinstance(n, (ast.Import, ast.ImportFrom)):
            n.names = [a for a in n.names if a.name not in drop]
    tree.body = [n for n in tree.body
                 if not isinstance(n, (ast.Import, ast.ImportFrom))
                 or n.names]
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree).replace("t41x_torch", "t41x")


@pytest.mark.parametrize("mod", COPIES)
def test_copy_is_the_original(mod):
    assert _code(f"t41x_torch.{mod}") == _code(
        f"t41x.{mod}", NOT_COPIED.get(mod, ()))


def _equal(a, b, path="result"):
    """Exact equality of nested results: arrays by value, dtype and
    shape; dataclasses as dicts."""
    if dataclasses.is_dataclass(a):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _config_changes(cfg):
    cfg.current_band = 1
    cfg.band.rf_gain = 7
    cfg.equalizer_rec[3] = 40
    cfg.favorites = [7_100_000, 0, 14_074_000]
    cfg.my_grid = "FN42aa"
    return cfg


def case_config_dicts(tmp_path):
    return ([t_config.RadioConfig(itu_region=r).to_dict() for r in (1, 2, 3)]
            + [t_config.FREQ_INCREMENTS, t_config.FT_INCREMENTS,
               t_config.CONFIG_VERSION],
            [j_config.RadioConfig(itu_region=r).to_dict() for r in (1, 2, 3)]
            + [j_config.FREQ_INCREMENTS, j_config.FT_INCREMENTS,
               j_config.CONFIG_VERSION])


def case_config_json_across(tmp_path):
    """A config file written by either package loads in the other."""
    j_path, t_path = tmp_path / "j.json", tmp_path / "t.json"
    _config_changes(j_config.RadioConfig()).save(str(j_path))
    _config_changes(t_config.RadioConfig()).save(str(t_path))
    assert j_path.read_bytes() == t_path.read_bytes()
    return ([t_config.RadioConfig.load(str(j_path)).to_dict(),
             t_config.RadioConfig.load(str(tmp_path / "none.json")).to_dict()],
            [j_config.RadioConfig.load(str(t_path)).to_dict(),
             j_config.RadioConfig.load(str(tmp_path / "none.json")).to_dict()])


def case_codec_gain(tmp_path):
    rng = np.random.default_rng(1)
    flags = rng.random((400, 2)) < (0.02, 0.2)
    out = []
    for mod in (t_cg, j_cg):
        cg, g, traj = mod.CodecGain(), 8, []
        for h, q in flags:
            g = cg.step(bool(h), bool(q), g)
            traj.append((g, cg.timer, cg.changes))
        out.append(traj)
    return out


def case_tune(tmp_path):
    args = [(14_200_000, 0.0), (7_074_000, 1500.0, True, 600.0, True),
            (28_350_000, -250.0, True, 750.0, False, 1.00002)]
    return ([t_tune.lo_plan(*a) for a in args]
            + [t_tune.rx_capture_offset_hz(f) for f in (0.0, 1234.5)],
            [j_tune.lo_plan(*a) for a in args]
            + [j_tune.rx_capture_offset_hz(f) for f in (0.0, 1234.5)])


def case_cal(tmp_path):
    n = 4096
    t = np.arange(n) / 192_000.0
    tone = np.exp(2j * np.pi * 1000.0 * t)
    bad = (1.03 * tone.real + 1j * (tone.imag + 0.02 * tone.real)
           ).astype(np.complex64)

    def run(mod):
        def measure(amp, phase):
            fixed = (bad.real * amp) + 1j * (bad.imag - phase * bad.real)
            return mod.image_rejection_db(fixed, 1000.0)
        return [mod.tone_powers_db(bad, 1000.0),
                mod.image_rejection_db(bad, 1000.0),
                mod.calibrate_iq(measure)]
    return run(t_cal), run(j_cal)


def case_wav(tmp_path):
    rng = np.random.default_rng(2)
    mono = (0.5 * rng.standard_normal(1000)).clip(-1, 1).astype(np.float32)
    iq = (0.3 * (rng.standard_normal(800)
                 + 1j * rng.standard_normal(800))).astype(np.complex64)
    out = []
    for name, mod in (("t", t_wav), ("j", j_wav)):
        p1, p2 = tmp_path / f"{name}1.wav", tmp_path / f"{name}2.wav"
        mod.write_wav(str(p1), mono, 24000)
        mod.write_iq_wav(str(p2), iq, 192000)
        out.append([p1.read_bytes(), p2.read_bytes(),
                    *mod.read_wav(str(p1)), *mod.read_iq_wav(str(p2))])
    return out


def case_signals(tmp_path):
    def run(m):
        n = 4096
        return [m.tone_iq(1234.0, n), m.usb_signal([700.0, 1900.0], n),
                m.lsb_signal([900.0], n, nco=300.0),
                m.am_signal(400.0, n, depth=0.3),
                m.nfm_signal(1000.0, n), m.cw_keying_envelope(
                    m.text_to_morse_pattern("CQ DE K1ABC"), 20.0, 5 * n),
                m.text_to_morse_pattern("TEST 73"),
                m.cw_signal("TEST", 25.0, 4 * n),
                m.awgn(n, 0.1, seed=3), m.awgn(n, 0.1, seed=3,
                                              complex_=False),
                m.voice_proxy(n), m.tone_fit_snr(
                    np.sin(np.arange(n) * 0.3).astype(np.float32), [0.3 * 24000
                                                                    / 6.283],
                    24000.0),
                m.snr_db(np.ones(64), np.ones(64) * 1.01)]
    return run(t_sig), run(j_sig)


@pytest.fixture(params=["native", "python"])
def ring_kind(request, monkeypatch):
    if request.param == "native":
        if not (t_rt.native_available() and j_rt.native_available()):
            pytest.skip("the native runtime library does not build here")
    else:
        monkeypatch.setattr(t_rt, "_load", lambda: None)
        monkeypatch.setattr(j_rt, "_load", lambda: None)
    return request.param


def test_block_ring_push_pop_equal(ring_kind):
    rng = np.random.default_rng(4)
    blocks = rng.standard_normal((20, 8)).astype(np.float32)
    out = []
    for mod in (t_rt, j_rt):
        ring = mod.BlockRing(block_floats=8, capacity=8)
        trace = []
        for i, b in enumerate(blocks):
            trace.append(ring.push(b))
            if i % 3 == 2:
                trace.append(ring.pop_iq())
            trace.append(ring.available())
        while (b := ring.pop()) is not None:
            trace.append(b)
        trace.append(ring.overruns)
        out.append(trace)
    for a, b in zip(*out):
        _equal(a, b)
    assert len(out[0]) == len(out[1])


def case_load_meter_and_wav_reader(tmp_path):
    t_wav.write_iq_wav(str(tmp_path / "c.wav"),
                       np.full(300, 0.25 + 0.5j, np.complex64), 192000)
    out = []
    for mod in (t_rt, j_rt):
        m = mod.LoadMeter(budget_s=1.0, force_python=True)
        out.append([m.percent, *mod.read_wav_native(str(tmp_path / "c.wav"))])
    return out


def case_morse(tmp_path):
    env = j_sig.cw_keying_envelope(j_sig.text_to_morse_pattern(
        "CQ CQ DE K1ABC K"), 18.0, int(12 * 192_000))
    block = 2048
    keyed = env[: len(env) // block * block].reshape(-1, block).mean(1) > 0.5
    out = []
    for mod in (t_cw, j_cw):
        dec = mod.MorseDecoder(wpm_hint=18)
        text = "".join(dec.feed(keyed[i:i + 7].tolist())
                       for i in range(0, len(keyed), 7))
        out.append([text, dec.wpm, mod.decode_envelope(keyed)])
    return out


def case_control_frames(tmp_path):
    rng = np.random.default_rng(5)
    pix = rng.uniform(-40, 300, 512)
    colors = rng.integers(0, 12, 90)

    def run(m):
        frames = [m.rf_spectrum_frame(pix), m.audio_spectrum_frame(pix[:256]),
                  m.smeter_frame(-80.5), m.smeter_frame(-20.0),
                  m.beacon_frame(2, 7, 40, colors)]
        return frames + [m.parse_frames(b"".join(frames) + b"FD01")]
    return run(t_ctl), run(j_ctl)


def case_acquire(tmp_path):
    """Each package's capture server feeds the other's network source."""
    iq = j_sig.usb_signal([1000.0], 3 * 2048) * 0.25
    out = []
    for serve, src_mod, ring_mod in ((j_acq, t_acq, t_rt),
                                     (t_acq, j_acq, j_rt)):
        port, _ = serve.serve_capture(iq)
        ring = ring_mod.BlockRing()
        src = src_mod.NetIQSource(ring, "127.0.0.1", port)
        t0 = time.monotonic()
        while src.blocks_received < 3 and time.monotonic() - t0 < 30:
            time.sleep(0.01)
        src.stop()
        out.append([src.blocks_received]
                   + [ring.pop_iq() for _ in range(ring.available())])
    return out


def case_debugtrace(tmp_path):
    out = []
    for cfg_mod, mod in ((t_config, t_dbg), (j_config, j_dbg)):
        log = []
        tr = mod.ConfigTracer(log=log.append)
        cfg = cfg_mod.RadioConfig()
        tr.enter(cfg)
        _config_changes(cfg)
        diff = tr.exit(cfg)
        tr.enter(cfg)
        same = tr.exit(cfg)
        out.append([diff, same, log, tr.history])
    # StageTimer is t41x's alone (NOT_COPIED)
    assert not hasattr(t_dbg, "StageTimer")
    timer = j_dbg.StageTimer()
    with timer.stage("a"):
        pass
    assert sorted(timer.report()["a"]) == ["count", "mean_ms", "total_s"]
    assert timer.report()["a"]["count"] == 1
    return out


def case_display(tmp_path):
    rng = np.random.default_rng(6)
    spec = rng.uniform(0, 60, 512)
    wf = rng.uniform(0, 60, (16, 512))

    def run(m):
        return [m.waterfall_colormap(), m.waterfall_colormap(40),
                m.waterfall_rows_to_rgb(wf, 5.0, 2),
                m.render_panadapter(spec, wf, f_lo=200, f_hi=3000,
                                    span_hz=96_000),
                m.render_panadapter(spec), m.render_smeter(-90.0),
                m.render_smeter(-50.0), m.ascii_spectrum(spec),
                m.ascii_spectrum(spec, width=40, floor_db=10, ceil_db=50),
                [m.snr_color(s) for s in (-1.0, 3.0, 14.0, 80.0,
                                          float("nan"))],
                m.SPECTRUM_RES, m.DISPLAY_SCALES]
    return run(t_disp), run(j_disp)


def case_ft8_tables(tmp_path):
    names = ("COSTAS", "GRAY", "CRC_POLY", "CRC_WIDTH", "N", "K", "M", "ND",
             "NS", "NN", "NRW", "NM", "MN", "H", "GP")
    return ([getattr(t_tables, n) for n in names],
            [getattr(j_tables, n) for n in names])


FT8_MESSAGES = ("CQ K1ABC FN42", "K1ABC W9XYZ EM77", "W9XYZ K1ABC -11",
                "K1ABC W9XYZ RRR", "W9XYZ K1ABC R-09", "CQ PJ4/KA1ABC",
                "<W9XYZ> PJ4/KA1ABC RR73", "PJ4/KA1ABC <W9XYZ> 73",
                "TNX BOB 73 GL", "123456789ABCDEF012")


def case_ft8_message_and_crc(tmp_path):
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, (8, 77)).astype(np.uint8)

    def run(msg, crc):
        hashes = msg.CallHashTable()
        hashes.save("W9XYZ")
        packed = [msg.pack77(m) for m in FT8_MESSAGES]
        return [packed, [msg.unpack77(b, hashes) for b in packed],
                [msg.unpack77(b) for b in packed],
                [msg.unpack77(b) for b in bits],
                [msg.ihashcall(c, m) for c in ("W9XYZ", "PJ4/KA1ABC")
                 for m in (10, 12, 22)],
                [msg.pack28(c) for c in ("K1ABC", "CQ", "DE", "W9XYZ")],
                msg.pack_grid("FN42"), msg.unpack_grid(*msg.pack_grid("EM77")),
                [crc.crc14(np.concatenate([b, np.zeros(5, np.uint8)]))
                 for b in bits],
                [crc.add_crc(b) for b in bits],
                [crc.check_crc(crc.add_crc(b)) for b in bits]]
    return run(t_msg, t_crc), run(j_msg, j_crc)


def case_ft8_encode(tmp_path):
    def run(m):
        tones = m.encode("CQ K1ABC FN42")
        audio = m.synth_audio(tones, base_freq=1100.0, amp=0.3)
        return [tones, m.encode_bits(t_msg.pack77("K1ABC W9XYZ EM77")),
                audio, m.apply_sample_rate_offset(audio, 40.0),
                m.apply_fading(audio, 0.3, seed=4),
                m.synth_iq("W9XYZ K1ABC -11", base_freq=900.0, nco=200.0,
                           pad_start_s=0.1, pad_end_s=0.1)]
    return run(t_enc), run(j_enc)


def case_ft8_slots(tmp_path):
    rng = np.random.default_rng(9)
    sizes = rng.integers(200, 4000, 500)
    out = []
    for mod in (t_slots, j_slots):
        sm = mod.SlotManager(lambda a: [len(a), float(a[::997].sum())],
                             clock=lambda: 11.0 + sm.samples_fed / 24000.0)
        out.append([sm.feed(np.full(n, i % 5, np.float32))
                    for i, n in enumerate(sizes)]
                   + [sm.results, sm.slots_decoded, sm.buffered])
    return out


def case_psk31_varicode(tmp_path):
    return ([t_vari.VARICODE, t_vari.VARICODE_REVERSE],
            [j_vari.VARICODE, j_vari.VARICODE_REVERSE])


def case_locator_bearing_beacon(tmp_path):
    grids = ("FN42", "EM77aa", "JO65hp", "QF56od", "AA00aa", "RR99xx")
    calls = ("K1ABC", "G4XYZ", "VK2AB", "JA1XYZ", "PJ4/KA1ABC", "ZZ9ZZZ",
             "3DA0AB")
    dbm = np.random.default_rng(3).uniform(-120, -60, (5, 3 * 938))

    def run(loc, bea, bcn):
        report = bcn.monitor_capture(dbm, start_slot=4)
        return [[loc.grid_to_latlon(g) for g in grids],
                [loc.latlon_to_grid(la, lo, p) for la, lo in
                 ((42.3, -71.1), (-33.9, 151.2), (0.0, 0.0))
                 for p in (4, 6)],
                [loc.distance_km(a, b) for a in grids for b in grids],
                [loc.bearing_deg(a, b) for a in grids[:3] for b in grids],
                [bea.callsign_prefix(c) for c in calls],
                [bea.find_country(c) for c in calls],
                [bea.dx_heading("FN42", c) for c in calls],
                [bcn.beacon_schedule(i) for i in range(20)],
                bcn.slot_snr(dbm), report.snr, report.render()]
    return (run(t_loc, t_bearing, t_beacon),
            run(j_loc, j_bearing, j_beacon))


def case_display_maps(tmp_path):
    dbm = np.random.default_rng(5).uniform(-120, -60, (5, 2 * 938))

    def run(disp, bcn):
        report = bcn.monitor_capture(dbm, start_slot=1)
        return [disp.render_beacon_map(report, "FN42", band_index=b, scale=1)
                for b in (0, 3)] + [
            disp.render_beacon_map(bcn.BeaconReport(), None, scale=2),
            disp.render_bearing_map("FN42", "JA1XYZ", scale=1),
            disp.render_bearing_map("JO65", "K1ABC", scale=2)]
    return run(t_disp, t_beacon), run(j_disp, j_beacon)


def test_bearing_map_refuses_unknown_calls():
    for disp in (t_disp, j_disp):
        with pytest.raises(ValueError, match="no DXCC match"):
            disp.render_bearing_map("FN42", "ZZ9ZZZ")


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_copy_behaves_as_the_original(name, tmp_path):
    got, want = CASES[name](tmp_path)
    _equal(got, want)


def test_config_json_is_plain():
    """The JSON file carries nothing package-specific."""
    d = json.loads(json.dumps(t_config.RadioConfig().to_dict()))
    assert t_config.RadioConfig.from_dict(d).to_dict() == \
        j_config.RadioConfig.from_dict(d).to_dict()
