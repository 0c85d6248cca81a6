"""t41x_torch design-time code: every designed coefficient, operator and
constant equals t41x's bit for bit, and the port never imports JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from t41x import constants as JC
from t41x.chain import ChainSpec as JSpec, RxChain as JChain
from t41x.demod import am as jam, cw as jcw, sam as jsam
from t41x.dsp import agc as jagc, eq as jeq, firdesign as jfd, iir as jiir
from t41x.dsp import nb as jnb, nr as jnr, spectrum as jspec
from t41x.kernels import frontend_pallas as jfp
from t41x.kernels.frontend_pallas import FusedFrontEnd as JFront
from t41x.kernels.interp_pallas import FusedInterp as JInterp
from t41x.utils import windows as jw
from t41x_torch import constants as TC
from t41x_torch.chain import ChainSpec, RxChain
from t41x_torch.demod import am as tam, cw as tcw, sam as tsam
from t41x_torch.dsp import agc as tagc, chunk_ops as tco, eq as teq
from t41x_torch.dsp import firdesign as tfd, iir as tiir, nb as tnb
from t41x_torch.dsp import nr as tnr, spectrum as tspec
from t41x_torch.kernels.frontend import FusedFrontEnd as TFront
from t41x_torch.kernels.interp import FusedInterp as TInterp
from t41x_torch.utils import windows as tw

torch.set_num_threads(1)

SPECS = [dict(mode="usb"),
         dict(mode="lsb", f_lo=-2800.0, f_hi=-300.0),
         dict(mode="usb", f_lo=100.0, f_hi=12000.0, agc_mode=4,
              agc_thresh_db=35.0),
         dict(mode="am", f_lo=-5000.0, f_hi=5000.0),
         dict(mode="sam", f_lo=-3000.0, f_hi=3000.0),
         dict(mode="nfm"),                       # decimators refit to nfm_bw
         dict(mode="nfm", f_lo=-6000.0, f_hi=6000.0, nfm_bw=9000.0),
         dict(mode="usb", nr_mode=1, f_lo=300.0, f_hi=2700.0),
         dict(mode="lsb", f_lo=-2800.0, f_hi=-300.0, nr_mode=2,
              notch_on=True)]
EQ = np.testing.assert_array_equal


@pytest.mark.parametrize("kw", SPECS)
def test_chain_designs_equal(kw):
    j, t = JChain(JSpec(**kw)), RxChain(ChainSpec(**kw), device="cpu")
    for name in ("h1", "h2", "hi1", "hi2", "mask", "os_W", "os_F", "os_W2",
                 "os_mask_sq", "dc_b", "dc_a"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        EQ(a, b, err_msg=name)
    for name in ("am_b", "am_a"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        EQ(a, b, err_msg=name)
    for op in ("dc_op", "am_op"):
        for f in ("R", "L", "AK", "G", "b0"):
            EQ(getattr(getattr(t, op), f), getattr(getattr(j, op), f),
               err_msg=f"{op}.{f}")
    for name in ("agc_params", "sam_params", "kim_params",
                 "spectral_nr_params", "xanr_params", "notch_params",
                 "vol_scale"):
        assert getattr(t, name) == getattr(j, name), name


def test_constants_equal():
    names = [n for n in dir(JC) if n.isupper()]
    assert names and names == [n for n in dir(TC) if n.isupper()]
    for n in names:
        assert getattr(TC, n) == getattr(JC, n), n
    assert (TC.dec1_taps(), TC.dec2_taps()) == (JC.dec1_taps(),
                                                JC.dec2_taps())


@pytest.mark.parametrize("n", [7, 64, 257])
def test_windows_equal(n):
    for name, fn in jw.WINDOWS.items():
        EQ(tw.WINDOWS[name](n), fn(n), err_msg=name)
    for fn in ("sqrt_hann_periodic", "blackman_ft8"):
        EQ(getattr(tw, fn)(n), getattr(jw, fn)(n), err_msg=fn)
    for att in (15.0, 40.0, 60.0, 90.0):
        assert tw.kaiser_beta(att) == jw.kaiser_beta(att)
        EQ(tw.kaiser(n, tw.kaiser_beta(att)), jw.kaiser(n, jw.kaiser_beta(att)))
    x = np.linspace(0.0, 30.0, n)
    EQ(tw.izero(x), jw.izero(x))


def test_firdesign_equal():
    for taps, fc, att, fs in ((28, 3000.0, 90.0, 192000.0),
                              (46, 9000.0, 90.0, 48000.0),
                              (4, 6000.0, 60.0, 192000.0)):
        EQ(tfd.fir_kaiser(taps, fc, att, fs=fs),
           jfd.fir_kaiser(taps, fc, att, "lowpass", fs=fs))
    for lp in (None, 2500.0, 12000.0):
        for a, b in zip(tfd.interpolation_prototypes(lp),
                        jfd.interpolation_prototypes(lp)):
            EQ(a, b)
    for lo, hi in ((200.0, 3000.0), (-3000.0, -200.0), (-5000.0, 5000.0)):
        EQ(tfd.bandpass_mask(lo, hi), jfd.bandpass_mask(lo, hi))
    for a, b in zip(tfd.dc_block_biquad(), jfd.dc_block_biquad()):
        EQ(a, b)


def test_biquad_rbj_equal():
    for ftype in ("lowpass", "notch", "highpass", "peak"):
        for f0, q, fs in ((3000.0, 1.3, 24000.0), (700.0, 0.7, 24000.0),
                          (20000.0, 2.0, 24000.0), (5000.0, 1.3, 48000.0)):
            for a, b in zip(tfd.biquad_rbj(f0, q, fs, ftype),
                            jfd.biquad_rbj(f0, q, fs, ftype)):
                assert a.dtype == b.dtype
                EQ(a, b, err_msg=f"{ftype} {f0} {q} {fs}")
    with pytest.raises(ValueError):
        tfd.biquad_rbj(1000.0, 1.0, 24000.0, "allpass")


def test_demod_designs_equal():
    for f_hi in (2500.0, 3000.0, 5000.0):
        lp = jfd.biquad_rbj(f_hi, 1.3, 24000.0, "lowpass")
        for pole in (0.99, 0.95):
            for a, b in zip(tam.am_post_cascade(*lp, pole=pole),
                            jam.am_post_cascade(*lp, pole=pole)):
                assert a.dtype == b.dtype
                EQ(a, b)
    assert (tam.ALPHA, tam.BETA) == (jam.ALPHA, jam.BETA)
    assert tsam._ATAN_COEF.dtype == jsam._ATAN_COEF.dtype
    EQ(tsam._ATAN_COEF, jsam._ATAN_COEF)
    for kw in (dict(), dict(rate=48000.0), dict(omega_n=400.0, zeta=0.8),
               dict(pll_fmax=2000.0, fade_leveler=0)):
        assert tsam.sam_params(**kw) == jsam.sam_params(**kw), kw


def test_nr_designs_equal():
    EQ(tnr._hann(), jnr._hann())
    EQ(tnr._sqrt_hann(), jnr._sqrt_hann())
    assert (tnr.NR_FFT_L, tnr.HOP) == (jnr.NR_FFT_L, jnr.HOP)
    for lo, hi in ((200.0, 3000.0), (-3000.0, -200.0), (-5000.0, 5000.0),
                   (100.0, 150.0), (0.0, 12000.0)):
        assert tnr._vad_bins(lo, hi) == jnr._vad_bins(lo, hi)
        assert tnr.kim_params(lo, hi) == jnr.kim_params(lo, hi)
        assert tnr.spectral_params(lo, hi) == jnr.spectral_params(lo, hi)
    for notch in (False, True):
        assert tnr.XanrParams(notch=notch) == jnr.XanrParams(notch=notch)
    assert tnr.KimParams() == jnr.KimParams()
    assert tnr.SpectralParams() == jnr.SpectralParams()
    # the states' fields, their order and their initial values
    for tf, jf, args in ((tnr.kim_state, jnr.kim_state, ()),
                         (tnr.spectral_state, jnr.spectral_state, ()),
                         (tnr.xanr_state, jnr.xanr_state,
                          (jnr.XanrParams(),)),
                         (tsam.sam_state, jsam.sam_state, ())):
        ts, js = tf(*args, (3,)), jf(*args, (3,))
        assert ts._fields == js._fields
        for a, b in zip(ts, js):
            assert a.numpy().dtype == b.dtype
            EQ(a.numpy(), b)


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
def test_agc_params_equal(mode):
    for thresh in (10.0, 20.0, 50.0):
        for rate in (24000.0, 48000.0):
            assert (tagc.agc_params(mode, thresh, rate)
                    == jagc.agc_params(mode, thresh, rate))


@pytest.mark.parametrize("chunk", [64, 128])
def test_biquad_operators_equal(chunk):
    dc_b, dc_a = jfd.dc_block_biquad()
    lp_b, lp_a = jfd.biquad_rbj(2500.0, 1.3, 24000.0, "lowpass")
    real_b, real_a = [1.0, 0.3, 0.0], [1.0, -0.9, 0.2]  # distinct real poles
    rep_b, rep_a = [1.0, 0.0, 0.0], [1.0, -1.0, 0.25]  # repeated pole
    for b, a in (([dc_b], [dc_a]), ([lp_b, real_b], [lp_a, real_a]),
                 ([rep_b], [rep_a])):
        t, j = tiir.BiquadChunked(b, a, chunk), jiir.BiquadChunked(b, a, chunk)
        for f in ("R", "L", "AK", "G", "b0"):
            EQ(getattr(t, f), getattr(j, f), err_msg=f)
        for s in range(len(b)):
            for x, y in zip(tiir.stage_normal_form(b[s], a[s]),
                            jiir.stage_normal_form(b[s], a[s])):
                EQ(x, y)


def test_kernel_operators_equal():
    chain = JChain(JSpec())
    jf = JFront(chain.h1, chain.h2, chain.dc_b[0], chain.dc_a[0])
    tf = TFront(chain.h1, chain.h2, chain.dc_b[0], chain.dc_a[0])
    # the CUDA kernel's constant block: [0, the DC operator's Toeplitz
    # taps (its first column below the diagonal)], R, G, AK, b0, the
    # reversed decimator taps
    kc = tf.kernel_consts
    assert kc[0] == 0.0
    EQ(kc[1:128], jf.Lt[0, 1:])
    EQ(kc[128:384].reshape(128, 2).T, jf.Rt)
    EQ(kc[384:640].reshape(128, 2), jf.G)
    EQ(kc[640:644].reshape(2, 2).T, jf.AKt)
    assert kc[644] == jf.b0 == float(tf.dc_op.b0[0])
    EQ(kc[645:673], jf.h1_rev)
    EQ(kc[673:], jf.h2_rev)
    ji, ti = JInterp(chain.hi1, chain.hi2), TInterp(chain.hi1, chain.hi2)
    EQ(ti.hp1, ji.hp1)
    EQ(ti.hp2, ji.hp2)


@pytest.mark.parametrize("zoom", range(1, 8))
def test_zoom_designs_equal(zoom):
    """The zoom 2^z tap: anti-alias IIR, decimator taps, display
    multiplier, the per-stage operators, the composed chunk operators
    of K1's zoom variant, and the ZoomState layout."""
    EQ(tfd.zoom_antialias_iir(zoom), jfd.zoom_antialias_iir(zoom))
    t, j = tspec.ZoomFFT(zoom), jspec.ZoomFFT(zoom)
    for f in ("h", "iir_b", "iir_a"):
        assert getattr(t, f).dtype == getattr(j, f).dtype, f
        EQ(getattr(t, f), getattr(j, f), err_msg=f)
    assert (t.factor, t.multiplier) == (j.factor, j.multiplier)
    for f in ("R", "L", "AK", "G", "b0"):
        EQ(getattr(t.iir_op, f), getattr(j.iir_op, f), err_msg=f)
    chain = JChain(JSpec())
    args = (chain.h1, chain.h2, chain.dc_b[0], chain.dc_a[0])
    kw = dict(zoom=zoom, zoom_sos=(j.iir_b, j.iir_a), zoom_h=j.h)
    tf, jf = TFront(*args, **kw), JFront(*args, **kw)
    EQ(tf.Wy, jf.Wy)
    EQ(tf.Ws, jf.Ws)
    assert (tf.z_states, tf.z_stages, tf.zt, tf.zfactor) \
        == (jf.z_states, jf.z_stages, jf.zt, jf.zfactor)
    ts, js = t.init_state((3,)), j.init_state((3,))
    assert ts._fields == js._fields
    for a, b in zip(ts, js):
        assert a.numpy().dtype == b.dtype
        EQ(a.numpy(), b)


def test_chunk_ops_equal():
    """dsp.chunk_ops against frontend_pallas's design functions, on the
    EQ's band cascades, the CW filter and the zoom taps."""
    eb, ea = jeq.design_eq_bands()
    sos = jfd.cw_audio_lpf(840.0)
    for b, a, K in ((eb[0], ea[0], 32), (eb[13], ea[13], 32),
                    (sos[:, :3], sos[:, 3:], 64)):
        for x, y in zip(tco.compose_cascade_ops(b, a, K),
                        jfp._compose_cascade_ops(b, a, K)):
            EQ(x, y)
    s1 = jiir.stage_normal_form(eb[2][0], ea[2][0])
    s2 = jiir.stage_normal_form(eb[2][1], ea[2][1])
    for x, y in zip(tco.compose_systems(s1, s2),
                    jfp._compose_systems(s1, s2)):
        EQ(x, y)
    for zoom in (1, 4):
        z = jspec.ZoomFFT(zoom)
        for x, y in zip(tco.zoom_chunk_ops(z.iir_b, z.iir_a, z.h,
                                           z.factor, 128),
                        jfp._zoom_chunk_ops(z.iir_b, z.iir_a, z.h,
                                            z.factor, 128)):
            EQ(x, y)


def test_eq_cw_nb_designs_equal():
    EQ(teq.band_centers(), jeq.band_centers())
    for rate in (24000.0, 48000.0):
        for a, b in zip(teq.design_eq_bands(rate), jeq.design_eq_bands(rate)):
            assert a.dtype == b.dtype
            EQ(a, b)
    te, je = teq.EQDesign(), jeq.EQDesign()
    assert (te.stages, te.chunk, teq.NUM_BANDS) \
        == (je.stages, je.chunk, jeq.NUM_BANDS)
    EQ(te.Wy, je.Wy)
    EQ(te.Ws, je.Ws)
    EQ(te.init_state((2,)).numpy(), je.init_state((2,)))
    assert tfd.CW_FILTER_FC_HZ == jfd.CW_FILTER_FC_HZ
    for fc in tfd.CW_FILTER_FC_HZ:
        EQ(tfd.cw_audio_lpf(fc), jfd.cw_audio_lpf(fc))
    for tone in (750.0, 600.0):
        td, jd = tcw.CWDetector(tone), jcw.CWDetector(tone)
        for f in ("h", "ref", "goertzel_cos", "goertzel_sin",
                  "corr_matrix"):
            assert getattr(td, f).dtype == getattr(jd, f).dtype, f
            EQ(getattr(td, f), getattr(jd, f), err_msg=f)
        ts, js = td.init_state((3,)), jd.init_state((3,))
        assert ts._fields == js._fields
        for a, b in zip(ts, js):
            assert a.numpy().dtype == b.dtype
            EQ(a.numpy(), b)
    assert (tcw.TONE_HZ, tcw.BLOCK, tcw.THRESHOLD) \
        == (jcw.TONE_HZ, jcw.BLOCK, jcw.THRESHOLD)
    assert (tnb.ORDER, tnb.IMPULSE_LEN, tnb.PL, tnb.NB_THRESH) \
        == (jnb.ORDER, jnb.IMPULSE_LEN, jnb.PL, jnb.NB_THRESH)


@pytest.mark.parametrize("index", range(5))
def test_cw_chain_designs_equal(index):
    kw = dict(mode="cw", cw_filter_index=index, eq_on=True)
    j, t = JChain(JSpec(**kw)), RxChain(ChainSpec(**kw), device="cpu")
    for name in ("cw_lp_b", "cw_lp_a"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        EQ(a, b, err_msg=name)
    for f in ("R", "L", "AK", "G", "b0"):
        EQ(getattr(t.cw_lp_op, f), getattr(j.cw_lp_op, f), err_msg=f)
    # every state field in t41x's layout (the CW, CW filter and EQ ones)
    for a, b in zip(t.init_state((2,)), j.init_state((2,))):
        ta, tb = _leaves(a), _leaves(b)
        assert len(ta) == len(tb)
        for x, y in zip(ta, tb):
            assert x.shape == y.shape and x.numpy().dtype == y.dtype


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _jax_imports(path) -> list:
    """Every import of `jax...` or of `t41x` / `t41x.*` in a source
    file, at any depth (function bodies included), as (line, name)."""
    import ast

    found = []
    for node in ast.walk(ast.parse(open(path).read(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if n.split(".")[0] in ("jax", "jaxlib", "t41x")]
    return found


def test_port_never_imports_jax(tmp_path):
    """No t41x_torch source and not chip_smoke.py imports `jax` or
    `t41x` anywhere, inside functions too (an AST scan); and every
    t41x_torch module imports in a fresh interpreter in which `import
    jax` fails, without loading JAX or the JAX package."""
    import glob

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = sorted(glob.glob(os.path.join(root, "t41x_torch", "**",
                                          "*.py"), recursive=True))
    files.append(os.path.join(root, "chip_smoke.py"))
    assert len(files) >= 81
    # the mesh layer and the tools are scanned too
    for sub in ("mesh", "tools"):
        assert sum(os.sep + sub + os.sep in f for f in files) >= 3, sub
    bad = {f: hits for f in files if (hits := _jax_imports(f))}
    assert not bad, bad
    # the scan sees imports in function bodies, and not t41x_torch's
    probe = tmp_path / "probe.py"
    probe.write_text("import t41x_torch.radio\nfrom t41x_torch import C\n"
                     "def f():\n    from t41x.decode import psk31\n"
                     "    import jax.numpy as jnp\n")
    assert _jax_imports(probe) == [(4, "t41x.decode"), (5, "jax.numpy")]

    code = (
        "import pkgutil, importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "import t41x_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(t41x_torch.__path__,"
        " 't41x_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 't41x' or "
        "m.startswith(('t41x.', 'jax.', 'jaxlib'))]\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 71, mods\n"
        "print(len(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
