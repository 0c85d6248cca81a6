"""Plain reference of the T41 SSB receive chain, for the benchmark's check.

The semantics of one 2048-sample block of tmr4/T41_SDR `ProcessIQData`
(`Process.cpp:70-944`) for the SSB family with the zoom-x1 panadapter or
none, written as plain tensor algebra with no kernels and no chunk tricks:

    q15 -> float, RF gain            (Process.cpp:102-117)
    DC-block biquad at 192 kHz       (Process.cpp:127; FIR.cpp:87-91)
    IQ amplitude / phase correction  (Process.cpp:163-175)
    zoom x1 panadapter tap           (FFT.cpp:208-251)
    +Fs/4 shift, NCO mix down        (Freq_Shift.cpp:42-141)
    x4 then x2 FIR decimation        (Process.cpp:474-479)
    SSB level, overlap-save band-pass with the audio spectrum
                                     (Process.cpp:482-595)
    WDSP AGC, 5 states               (DSP_Fn.cpp:368-632)
    SSB demod, S-meter average       (Process.cpp:616-695)
    x2 then x4 interpolation, volume (Process.cpp:917-929, 955-967)

Every linear stage is a matrix product: the DC biquad as its impulse
response over the block plus its state response, the FIRs as banded
matrices, the DFTs as dense ones.  The AGC is a per-sample loop.  So
with float32 and TF32 matmuls allowed, the same code is the lower
precision control; in float64 it is the reference.

The filters are designed here from the configuration's keywords, by
copies of the port's NumPy designers (`t41x_torch/dsp/firdesign.py`,
`utils/windows.py`, `dsp/iir.py` `_normal_form_powers`,
`dsp/agc.py` `agc_params`, `constants.py`); the carried state uses the
port's coordinates and field names (the DC biquad's balanced normal
form), so a state can be handed across.  This module imports torch and
NumPy only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

RATE = 192_000.0
BLOCK = 2048
DF1, DF2 = 4, 2
DF = DF1 * DF2
AUDIO_RATE = RATE / DF
FFT = 512
HALF = FFT // 2
RES = 512
N_ATT = 90.0
N_DESIRED_BW, N_SAMPLERATE = 9.0, 176.0
INT1_TAPS, INT2_TAPS = 48, 32
NCO_GAIN = 1.1        # Freq_Shift.cpp:137 freqAdjFactor
SPEC_EMA = 0.7        # FFT.cpp:171

# what this reference computes; anything else in a configuration raises
KEYS = {"mode", "f_lo", "f_hi", "agc_mode", "agc_thresh_db", "spectrum_zoom",
        "spectrum_taps", "interpolate_out", "q15_input"}


# ---------------------------------------------------------------- design
def _izero(x):
    x = np.asarray(x, dtype=np.float64)
    x2, total, term = x / 2.0, np.ones_like(x), np.ones_like(x)
    for i in range(1, 64):
        term = term * (x2 / i) ** 2
        total = total + term
        if np.all(term < 1e-12 * total):
            break
    return total


def _kaiser_beta(a: float) -> float:
    if a < 20.96:
        return 0.0
    if a >= 50.0:
        return 0.1102 * (a - 8.71)
    return 0.5842 * (a - 20.96) ** 0.4 + 0.07886 * (a - 20.96)


def fir_kaiser(num_taps: int, fc: float, astop_db: float, fs: float):
    """Kaiser windowed-sinc low-pass (FIR.cpp:908-980)."""
    beta = _kaiser_beta(astop_db)
    fcf, nc = 2.0 * (fc / fs), num_taps
    ii = np.arange(-nc, nc, 2, dtype=np.float64)
    x = ii * (np.pi / 2.0) * fcf
    sinc = np.ones_like(x)
    nz = ii != 0
    sinc[nz] = np.sin(x[nz]) / (fcf * ii[nz] * (np.pi / 2.0))
    u = ii / nc
    win = (_izero(beta * np.sqrt(np.clip(1.0 - u * u, 0.0, None)))
           / _izero(beta))
    h = fcf * sinc * win
    return h[:num_taps] if len(h) >= num_taps else np.pad(
        h, (0, num_taps - len(h)))


def _taps(fpass: float, fstop: float) -> int:
    return 1 + int(N_ATT / (22.0 * (fstop - fpass)))


def decimator_taps() -> tuple[int, int]:
    """(x4, x2) tap counts (T41_SDR.ino:336-345)."""
    s = N_SAMPLERATE
    t1 = _taps(N_DESIRED_BW / s, (s / DF1 - N_DESIRED_BW) / s)
    t2 = _taps(N_DESIRED_BW / (s / DF1),
               (s / DF - N_DESIRED_BW) / (s / DF1))
    return t1, t2


def bandpass_mask(f_lo: float, f_hi: float) -> np.ndarray:
    """The overlap-save mask: a Blackman-Harris complex band-pass of
    FFT/2 + 1 taps, zero-padded and transformed (FIR.cpp:1008-1065,
    Filter.cpp:260-284)."""
    n = FFT // 2 + 1
    n_fl, n_fh = f_lo / AUDIO_RATE, f_hi / AUDIO_RATE
    n_fc, n_fs = (n_fh - n_fl) / 2.0, np.pi * (n_fh + n_fl)
    i = np.arange(n, dtype=np.float64)
    x = i - 0.5 * (n - 1)
    c = (0.35875, 0.48829, 0.14128, 0.01168)
    w = sum(ck * np.cos(2.0 * np.pi * k * i / (n - 1)) * (-1.0 if k % 2
                                                          else 1.0)
            for k, ck in enumerate(c))
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.sin(2.0 * np.pi * x * n_fc) / (np.pi * x) * w
    z[np.abs(x) < 0.01] = 2.0 * n_fc
    buf = np.zeros(FFT, np.complex128)
    buf[:n] = z * np.exp(1j * n_fs * x)
    return np.fft.fft(buf)


def _f32(a):
    """A design as the T41 stores it: its float32 coefficient tables."""
    a = np.asarray(a)
    if np.iscomplexobj(a):
        return a.astype(np.complex64).astype(np.complex128)
    return a.astype(np.float32).astype(np.float64)


def dc_biquad_normal_form():
    """The DC-block high-pass (a 10 Hz Butterworth biquad at 192 kHz, its
    coefficients in float32) as the state-space system s' = A s + B x,
    y = C s + b0 x in the balanced normal-form coordinates that the port
    carries its state in."""
    w0 = 2.0 * np.pi * 10.0 / RATE
    sw, cw = np.sin(w0), np.cos(w0)
    alpha = sw / (2.0 / np.sqrt(2.0))
    a0 = 1.0 + alpha
    b0, b1, b2 = _f32(np.array([(1 + cw) / 2, -(1 + cw), (1 + cw) / 2]) / a0)
    a1, a2 = _f32([-2 * cw / a0, (1 - alpha) / a0])
    k = np.array([b1 - a1 * b0, b2 - a2 * b0])
    disc = a1 * a1 - 4.0 * a2
    if not disc < -1e-30:
        raise ValueError("the DC biquad's poles are not a complex pair")
    p = (-a1 + 1j * np.sqrt(-disc)) / 2.0
    r, th = abs(p), np.angle(p)
    v = np.array([1.0 + 0j, p + a1])
    T = np.stack([v.real, v.imag], axis=1)
    B = np.linalg.inv(T) @ k
    Cv = np.array([1.0, 0.0]) @ T
    s = np.sqrt(np.linalg.norm(B) / max(np.linalg.norm(Cv), 1e-300))
    return r, th, B / s, Cv * s, b0


def agc_constants(mode: int, thresh_db: float) -> dict:
    """WDSP AGC constants (AGCPrep / AGCLoadValues, DSP_Fn.cpp:368-468)."""
    hangtime, tau_decay = {1: (2.0, 2.0), 2: (1.0, 0.5), 3: (0.0, 0.25),
                           4: (0.0, 0.05)}[mode]
    fs, n_tau, var_gain = AUDIO_RATE, 4.0, 1.5

    def mult(tau):
        return 1.0 - np.exp(-1.0 / (fs * tau))

    max_gain = 10.0 ** (thresh_db / 20.0)
    out_target = (1.0 - np.exp(-n_tau)) * 0.9999
    tmp = np.log10(out_target / (var_gain * max_gain))
    tmp2 = 10.0 ** ((0.25 - 1.0) / 0.125)
    return dict(
        buf=int(np.ceil(fs * n_tau * 0.001)), attack=mult(0.001),
        decay=mult(tau_decay), fast_decay=mult(0.005),
        fast_back=mult(0.250), hang_back=mult(0.500),
        hang_decay=mult(0.100), hang_init=int(hangtime * fs),
        out_target=out_target, min_volts=out_target / (var_gain * max_gain),
        slope=(out_target * (1.0 - 1.0 / var_gain)) / (tmp or 1e-16),
        hang_level=(tmp2 + (out_target / (var_gain * max_gain))
                    * (1.0 - tmp2)) * 0.637,
        pop_ratio=5.0)


def _decimator(h: np.ndarray, n_in: int, factor: int) -> np.ndarray:
    """D with out = [history | x] @ D for a causal FIR keeping every
    `factor`-th output, the newest sample's phase (arm_fir_decimate)."""
    t = len(h)
    d = np.zeros((t - 1 + n_in, n_in // factor))
    for n in range(n_in // factor):
        for k in range(t):
            d[n * factor + factor - 1 + k, n] = h[t - 1 - k]
    return d


def _interpolator(h: np.ndarray, n_in: int, factor: int) -> np.ndarray:
    """U with out = [history | x] @ U for a zero-stuffing interpolator
    (arm_fir_interpolate): out[n L + p] = sum_m h[m L + p] x[n - m]."""
    sub = len(h) // factor
    u = np.zeros((sub - 1 + n_in, n_in * factor))
    for n in range(n_in):
        for p in range(factor):
            for m in range(sub):
                u[sub - 1 + n - m, n * factor + p] = h[m * factor + p]
    return u


def _complex_op(m: np.ndarray) -> np.ndarray:
    """A real (2K, 2N) matrix R with [re | im] @ R = [re | im] of x @ m."""
    return np.block([[m.real, m.imag], [-m.imag, m.real]])


# -------------------------------------------------------------- the chain
class Reference:
    """The chain for one configuration, on `device` in `dtype` (float64:
    the reference; float32 with TF32 allowed: the control).  Complex
    state leaves (`COMPLEX`) are held as (..., 2) real pairs."""

    COMPLEX = frozenset({"dec1", "dec2", "osf", "agc.ring"})
    ANGLES = frozenset({"nco_phase"})   # held modulo 2 pi
    # leaves a branch decision sets: where the AGC's attack test ties to
    # rounding, they jump while volts and the audio stay equal (the
    # resident blocks loop, keying and all, so the held level converges
    # onto a repeated peak until the test compares equal numbers)
    DECISIONS = frozenset({"agc.state", "agc.decay_type", "agc.hang_counter",
                           "agc.save_volts"})

    def __init__(self, chain: dict, device, dtype=torch.float64):
        unknown = set(chain) - KEYS
        if unknown:
            raise ValueError(f"reference: keys it does not compute: {unknown}")
        self.kw = kw = dict(chain)
        if kw.get("mode", "usb") not in ("usb", "lsb"):
            raise ValueError(f"reference: mode {kw['mode']!r}")
        self.zoom = int(kw.get("spectrum_zoom", -1))
        if self.zoom not in (-1, 0):
            raise ValueError("reference: only the zoom x1 panadapter or none")
        if not kw.get("interpolate_out", True):
            raise ValueError("reference: only interpolate_out")
        self.taps = bool(kw.get("spectrum_taps", True))
        self.q15 = bool(kw.get("q15_input", False))
        self.dev, self.dt = torch.device(device), dtype
        f_lo = float(kw.get("f_lo", 200.0))
        f_hi = float(kw.get("f_hi", 3000.0))
        lp = min(max(f_hi, -f_lo), 10_000.0)
        t1, t2 = decimator_taps()
        self.h1 = _f32(fir_kaiser(t1, lp, N_ATT, RATE))
        self.h2 = _f32(fir_kaiser(t2, lp, N_ATT, RATE / DF1))
        self.hi1 = _f32(fir_kaiser(INT1_TAPS, lp, N_ATT, RATE / DF1))
        self.hi2 = _f32(fir_kaiser(INT2_TAPS, lp, N_ATT, RATE))
        cut = (-f_lo if kw.get("mode", "usb") == "lsb" else f_hi) * 1e-3
        self.vol_scale = 7.0874 * abs(cut) ** -1.232
        self.agc = agc_constants(int(kw.get("agc_mode", 2)),
                                 float(kw.get("agc_thresh_db", 20.0)))

        # the DC biquad over a block: y = b0 x + x @ H + s0 @ R, and
        # s_N = s0 @ AN.T + x @ G, from A = r rot(th) (powers in closed form)
        r, th, B, Cv, b0 = dc_biquad_normal_form()
        m = np.arange(BLOCK + 1)
        pw = (np.stack([np.stack([np.cos(m * th), np.sin(m * th)], -1),
                        np.stack([-np.sin(m * th), np.cos(m * th)], -1)],
                       axis=-2) * (r ** m)[:, None, None])   # A^m
        imp = np.einsum("j,mjk,k->m", Cv, pw[:BLOCK], B)  # C A^m B
        H = np.zeros((BLOCK, BLOCK))
        for j in range(BLOCK - 1):
            H[j, j + 1:] = imp[:BLOCK - 1 - j]
        R = np.einsum("j,njk->kn", Cv, pw[:BLOCK])          # (2, N)
        G = np.einsum("njk,k->nj", pw[BLOCK - 1::-1], B)    # (N, 2)
        self.dc_b0 = float(b0)

        F = np.exp(-2j * np.pi * np.outer(np.arange(FFT), np.arange(FFT))
                   / FFT)
        Finv = np.conj(F) / FFT
        hann = 0.5 - 0.5 * np.cos(6.28 * np.arange(RES) / RES)  # FFT.cpp:156
        mask = _f32(bandpass_mask(f_lo, f_hi))

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=self.dev)

        self.m = dict(
            H=t(H), R=t(R), G=t(G), AN=t(pw[BLOCK]),
            D1=t(_decimator(self.h1, BLOCK, DF1)),
            D2=t(_decimator(self.h2, BLOCK // DF1, DF2)),
            U1=t(_interpolator(self.hi1, HALF, DF2)),
            U2=t(_interpolator(self.hi2, HALF * DF2, DF1)),
            DFT=t(_complex_op(F.T)),                      # x @ F.T
            ZOOM=t(_complex_op((F * hann[None, :]).T)),   # (x hann) @ F.T
            IDFT=t(_complex_op(Finv[HALF:, :].T)),        # second half only
            mask_re=t(mask.real), mask_im=t(mask.imag),
            fs4=t(np.tile([[1, 0], [0, 1], [-1, 0], [0, -1]],
                          (BLOCK // 4, 1))),
            steps=t(np.arange(1, BLOCK + 1)))

    # ---------------------------------------------------------------- state
    def init_state(self, channels: int) -> dict:
        t1, t2 = len(self.h1), len(self.h2)
        z = lambda *s: torch.zeros((channels,) + s, dtype=self.dt,  # noqa
                                   device=self.dev)
        zi = lambda: torch.zeros(channels, dtype=torch.int64,  # noqa
                                 device=self.dev)
        st = {"dc_bq": z(2, 1, 2), "nco_phase": z(),
              "dec1": z(t1 - 1, 2), "dec2": z(t2 - 1, 2), "osf": z(HALF, 2),
              "agc.ring": z(self.agc["buf"], 2),
              "agc.abs_ring": z(self.agc["buf"]), "agc.volts": z(),
              "agc.save_volts": z(), "agc.fast_backaverage": z(),
              "agc.hang_backaverage": z(), "agc.hang_counter": zi(),
              "agc.decay_type": zi(), "agc.state": zi(),
              "int1": z(INT1_TAPS // DF2 - 1), "int2": z(INT2_TAPS // DF1 - 1)}
        if self.taps:
            st["smeter_avg"] = z()
        if self.zoom == 0:
            st["zoom"] = z(RES)
        return st

    def state_from(self, leaves: dict) -> dict:
        """A state from named tensors (complex as complex), in this
        reference's dtype; integer leaves as int64."""
        out = {}
        for k in self.init_state(1):
            v = leaves[k].to(self.dev)
            if v.is_complex():
                v = torch.view_as_real(v)
            out[k] = (v.to(torch.int64) if not v.is_floating_point()
                      else v.to(self.dt))
        return out

    # -------------------------------------------------------------- a block
    def _cmm(self, x, m):
        """x (..., K, 2) complex as pairs, times the complex operator whose
        real form is m: returns (..., N, 2)."""
        k = x.shape[-2]
        y = torch.cat([x[..., 0], x[..., 1]], dim=-1) @ m
        n = y.shape[-1] // 2
        assert m.shape[0] == 2 * k
        return torch.stack([y[..., :n], y[..., n:]], dim=-1)

    def block(self, params: dict, st: dict, i16, q16):
        """One block: params (nco_freq, rf_gain_db, band_gain, iq_amp,
        iq_phase, volume: (C,) tensors), the state, the codec's (C, 2048)
        int16 I and Q (or, without q15 input, a (C, 2048) complex x as i16
        and None).  Returns (state, outputs)."""
        dt, m, a = self.dt, self.m, self.agc
        p = {k: v.to(self.dev, dt) for k, v in params.items()}
        st = dict(st)
        out = {}
        g = 10.0 ** (p["rf_gain_db"] / 20.0) * p["band_gain"]
        if self.q15:
            xr = i16.to(self.dev, dt) / 32768.0
            xi = q16.to(self.dev, dt) / 32768.0
        else:
            xr, xi = i16.real.to(self.dev, dt), i16.imag.to(self.dev, dt)
        x = torch.stack([xr, xi], dim=-2) * g[:, None, None]   # (C, 2, N)

        # DC block, I and Q
        s0 = st["dc_bq"][:, :, 0, :]                            # (C, 2, 2)
        y = self.dc_b0 * x + x @ m["H"] + s0 @ m["R"]
        st["dc_bq"] = (s0 @ m["AN"].T + x @ m["G"])[:, :, None, :]
        i_, q_ = y[:, 0], y[:, 1]

        # IQ correction
        amp, ph = p["iq_amp"][:, None], p["iq_phase"][:, None]
        ic = i_ * amp
        pos = ph >= 0
        ic = torch.where(pos, ic + ph * q_, ic)
        qc = torch.where(pos, q_, q_ + ph * ic)
        x = torch.stack([ic, qc], dim=-1)                       # (C, N, 2)

        if self.zoom == 0:
            z = self._cmm(x[:, :RES], m["ZOOM"])
            power = (z ** 2).sum(-1)
            power = torch.cat([power[:, RES // 2:], power[:, :RES // 2]], -1)
            st["zoom"] = SPEC_EMA * power + (1.0 - SPEC_EMA) * st["zoom"]
            out["rf_spectrum"] = st["zoom"]

        # +Fs/4 (times j^n), then down by the NCO, gain 1.1
        f = m["fs4"]
        x = torch.stack([x[..., 0] * f[:, 0] - x[..., 1] * f[:, 1],
                         x[..., 0] * f[:, 1] + x[..., 1] * f[:, 0]], -1)
        w = 2.0 * math.pi * p["nco_freq"] / RATE
        theta = st["nco_phase"][:, None] + w[:, None] * m["steps"]
        c, s = torch.cos(theta), -torch.sin(theta)
        x = NCO_GAIN * torch.stack([x[..., 0] * c - x[..., 1] * s,
                                    x[..., 0] * s + x[..., 1] * c], -1)
        st["nco_phase"] = torch.remainder(st["nco_phase"] + w * BLOCK,
                                          2.0 * math.pi)

        # decimate x4, x2 (I and Q share the taps)
        for key, dmat in (("dec1", m["D1"]), ("dec2", m["D2"])):
            xc = torch.cat([st[key], x], dim=1)                 # (C, T-1+N, 2)
            st[key] = xc[:, -st[key].shape[1]:]
            x = (xc.transpose(1, 2) @ dmat).transpose(1, 2)

        # SSB level, then the overlap-save band-pass (and its spectrum)
        x = x * self.vol_scale
        xw = torch.cat([st["osf"], x], dim=1)
        st["osf"] = x
        X = self._cmm(xw, m["DFT"])
        Y = torch.stack([X[..., 0] * m["mask_re"] - X[..., 1] * m["mask_im"],
                         X[..., 0] * m["mask_im"] + X[..., 1] * m["mask_re"]],
                        -1)
        y = self._cmm(Y, m["IDFT"])                             # (C, 256, 2)
        if self.taps:
            spec = (Y ** 2).sum(-1)
            out["audio_spectrum"] = spec
            st["smeter_avg"] = (0.5 * spec.amax(-1)
                                + 0.5 * st["smeter_avg"])
            out["smeter_avg"] = st["smeter_avg"]

        # AGC: the look-ahead delay line, its sliding peak, the 5-state
        # gain recurrence a sample at a time
        B, n = a["buf"], y.shape[1]
        full = torch.cat([st["agc.ring"], y], dim=1)
        mag = torch.sqrt((y ** 2).sum(-1))
        abs_full = torch.cat([st["agc.abs_ring"], mag], dim=1)
        st["agc.ring"], st["agc.abs_ring"] = full[:, n:], abs_full[:, n:]
        ring_max = abs_full.unfold(1, B, 1)[:, 1:1 + n].amax(-1)
        volts = self._agc_loop(st, ring_max, abs_full[:, :n])
        gain = (a["out_target"] - a["slope"] * torch.clamp(
            torch.log10(volts), max=0.0)) / volts
        audio = full[:, :n, 0] * gain               # SSB: the real part
        out["audio_24k"] = audio

        # interpolate x2 then x4; volume (x^5 taper) and the x8 gain
        for key, umat in (("int1", m["U1"]), ("int2", m["U2"])):
            xc = torch.cat([st[key], audio], dim=1)
            st[key] = xc[:, -st[key].shape[1]:]
            audio = xc @ umat
        vol = 5.0 * (p["volume"] / 100.0) ** 5
        out["audio"] = audio * (DF * vol)[:, None]
        return st, out

    def _agc_loop(self, st: dict, rm, ao):
        """The gain state machine over the samples (DSP_Fn.cpp:480-620):
        0 attack/track, 1 fast decay, 2 hang, 3 decay, 4 hang decay.
        Updates the state in place; returns volts (C, n)."""
        a, where = self.agc, torch.where
        v, sv = st["agc.volts"], st["agc.save_volts"]
        fb, hb = st["agc.fast_backaverage"], st["agc.hang_backaverage"]
        hc, dty = st["agc.hang_counter"], st["agc.decay_type"]
        s = st["agc.state"]
        out = []
        for i in range(rm.shape[1]):
            r, o = rm[:, i], ao[:, i]
            fb = a["fast_back"] * o + (1.0 - a["fast_back"]) * fb
            hb = a["hang_back"] * o + (1.0 - a["hang_back"]) * hb
            hc = torch.clamp(hc - 1, min=0)
            d = r - v
            attack = r >= v
            # state 0 releasing: fast decay on a pop, else hang, else decay
            f0 = v > a["pop_ratio"] * fb
            h0 = hb > a["hang_level"]
            v0 = where(f0, v + d * a["fast_decay"],
                       where(h0, v, v + d * a["decay"]))
            n0 = where(f0, 1, where(h0, 2, 3))
            hc0 = where(h0 & ~f0, a["hang_init"], hc)
            dt0 = where(f0, dty, where(h0, 1, 0))
            # state 1: fast decay until back under the saved level
            f1, h1 = v > sv, hc > 0
            v1 = where(f1, v + d * a["fast_decay"], where(
                h1, v, where(dty == 0, v + d * a["decay"],
                             v + d * a["hang_decay"])))
            n1 = where(f1, 1, where(h1, 2, where(dty == 0, 3, 4)))
            # state 2: hold until the hang counter runs out
            done = hc == 0
            v2 = where(done, v + d * a["hang_decay"], v)
            n2 = where(done, 4, 2)
            v3 = v + d * a["decay"] * 0.05
            v4 = v + d * a["hang_decay"]
            rel_v = where(s == 0, v0, where(s == 1, v1, where(
                s == 2, v2, where(s == 3, v3, v4))))
            rel_s = where(s == 0, n0, where(s == 1, n1, where(s == 2, n2, s)))
            rel_hc = where(s == 0, hc0, hc)
            rel_dt = where(s == 0, dt0, dty)
            sv = where(attack & (s >= 2), v, sv)
            v = torch.clamp(where(attack, v + d * a["attack"], rel_v),
                            min=a["min_volts"])
            s = where(attack, 0, rel_s)
            hc = where(attack, hc, rel_hc)
            dty = where(attack, dty, rel_dt)
            out.append(v)
        st.update({"agc.volts": v, "agc.save_volts": sv,
                   "agc.fast_backaverage": fb, "agc.hang_backaverage": hb,
                   "agc.hang_counter": hc, "agc.decay_type": dty,
                   "agc.state": s})
        return torch.stack(out, dim=1)
