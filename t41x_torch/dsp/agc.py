"""WDSP-style AGC (torch), port of `t41x.dsp.agc`.

The reference's 5-state attack/decay/hang AGC (tmr4/T41_SDR
`DSP_Fn.cpp:368-632`, from Warren Pratt's WDSP): a look-ahead delay line
of `attack_buffsize` complex samples, a sliding-window peak over that
line, fast/hang back-averages, and the state machine {0: attack/track,
1: fast decay, 2: hang, 3: decay, 4: hang decay} driving a log-domain
gain slope.

`agc_apply` hoists everything that does not depend on the gain
recurrence out of the per-sample loop (delay, sliding max, gain curve);
the loop carries seven per-channel scalars.  With `use_kernels` a block
at least one delay line long goes whole to the CUDA kernel K2, and a
shorter one runs its recurrence in kernel K5
(`t41x_torch.kernels.agc`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from t41x_torch import constants as C


class AGCParams(NamedTuple):
    """Static AGC constants — reference `AGCPrep` / `AGCLoadValues`
    (`DSP_Fn.cpp:368-468`)."""
    mode: int              # 0 off, 1 long, 2 slow, 3 med, 4 fast
    attack_buffsize: int
    attack_mult: float
    decay_mult: float
    fast_decay_mult: float
    fast_backmult: float
    onemfast_backmult: float
    hang_backmult: float
    onemhang_backmult: float
    hang_decay_mult: float
    hang_counter_init: int
    out_target: float
    min_volts: float
    slope_constant: float
    inv_max_input: float
    hang_level: float
    hang_enable: int
    pop_ratio: float
    fixed_gain: float


_MODE_TABLE = {  # mode -> (hangtime s, tau_decay s), DSP_Fn.cpp:378-402
    1: (2.000, 2.000),
    2: (1.000, 0.500),
    3: (0.000, 0.250),
    4: (0.000, 0.050),
}


def agc_params(mode: int = 1, agc_thresh_db: float = 20.0,
               sample_rate: float = C.AUDIO_RATE) -> AGCParams:
    if mode == 0:
        return AGCParams(0, 1, *([0.0] * 8), 0, 1.0, 0.0, 1.0, 1.0, 0.0, 0,
                         5.0, 20.0)
    hangtime, tau_decay = _MODE_TABLE[mode]
    tau_attack = 0.001
    n_tau = 4.0
    max_input = 1.0
    out_targ = 1.0
    var_gain = 1.5
    tau_fast_backaverage = 0.250
    tau_fast_decay = 0.005
    tau_hang_backmult = 0.500
    hang_thresh = 0.250
    tau_hang_decay = 0.100

    max_gain = 10.0 ** (agc_thresh_db / 20.0)
    attack_buffsize = int(np.ceil(sample_rate * n_tau * tau_attack))
    attack_mult = 1.0 - np.exp(-1.0 / (sample_rate * tau_attack))
    decay_mult = 1.0 - np.exp(-1.0 / (sample_rate * tau_decay))
    fast_decay_mult = 1.0 - np.exp(-1.0 / (sample_rate * tau_fast_decay))
    fast_backmult = 1.0 - np.exp(-1.0 / (sample_rate * tau_fast_backaverage))
    hang_backmult = 1.0 - np.exp(-1.0 / (sample_rate * tau_hang_backmult))
    hang_decay_mult = 1.0 - np.exp(-1.0 / (sample_rate * tau_hang_decay))

    out_target = out_targ * (1.0 - np.exp(-n_tau)) * 0.9999
    min_volts = out_target / (var_gain * max_gain)
    tmp = np.log10(out_target / (max_input * var_gain * max_gain))
    if tmp == 0.0:
        tmp = 1e-16
    slope_constant = (out_target * (1.0 - 1.0 / var_gain)) / tmp
    tmp = 10.0 ** ((hang_thresh - 1.0) / 0.125)
    hang_level = (max_input * tmp
                  + (out_target / (var_gain * max_gain)) * (1.0 - tmp)) * 0.637

    return AGCParams(
        mode=mode,
        attack_buffsize=attack_buffsize,
        attack_mult=float(attack_mult),
        decay_mult=float(decay_mult),
        fast_decay_mult=float(fast_decay_mult),
        fast_backmult=float(fast_backmult),
        onemfast_backmult=float(1.0 - fast_backmult),
        hang_backmult=float(hang_backmult),
        onemhang_backmult=float(1.0 - hang_backmult),
        hang_decay_mult=float(hang_decay_mult),
        hang_counter_init=int(hangtime * sample_rate),
        out_target=float(out_target),
        min_volts=float(min_volts),
        slope_constant=float(slope_constant),
        inv_max_input=float(1.0 / max_input),
        hang_level=float(hang_level),
        hang_enable=1,
        pop_ratio=5.0,
        fixed_gain=20.0,
    )


class AGCState(NamedTuple):
    """Carried AGC state.  Leading dims = channel batch."""
    ring: torch.Tensor       # (..., B) complex64 delay line, [0] oldest
    abs_ring: torch.Tensor   # (..., B) float32 magnitudes
    volts: torch.Tensor      # (...,) float32
    save_volts: torch.Tensor
    fast_backaverage: torch.Tensor
    hang_backaverage: torch.Tensor
    hang_counter: torch.Tensor  # (...,) int32
    decay_type: torch.Tensor    # (...,) int32
    state: torch.Tensor         # (...,) int32


def agc_state(params: AGCParams, channels: tuple[int, ...] = (),
              device=None) -> AGCState:
    B = params.attack_buffsize

    def z(dt=torch.float32, shape=()):
        return torch.zeros(channels + shape, dtype=dt, device=device)

    return AGCState(
        ring=z(torch.complex64, (B,)), abs_ring=z(shape=(B,)),
        volts=z(), save_volts=z(), fast_backaverage=z(),
        hang_backaverage=z(),
        hang_counter=z(torch.int32), decay_type=z(torch.int32),
        state=z(torch.int32),
    )


def _sliding_window_max(a: torch.Tensor, width: int) -> torch.Tensor:
    """Exact sliding-window maximum over the last axis:
    a (..., L) -> (..., L - width + 1), out[i] = max(a[..., i:i+width])."""
    lead = a.shape[:-1]
    out = F.max_pool1d(a.reshape(-1, 1, a.shape[-1]), width, stride=1)
    return out.reshape(lead + (out.shape[-1],))


def agc_step(p: AGCParams, carry, rm, ao):
    """One AGC sample update (the 5-state attack/decay/hang machine),
    branch for branch with `t41x.dsp.agc.agc_step`: each state's release
    branch is computed, then selected first-true-wins."""
    (volts, save_volts, fast_backaverage, hang_backaverage,
     hang_counter0, decay_type, state) = carry
    i32 = torch.int32
    where = torch.where

    fast_back = p.fast_backmult * ao + p.onemfast_backmult * fast_backaverage
    hang_back = p.hang_backmult * ao + p.onemhang_backmult * hang_backaverage
    hang_counter = torch.clamp(hang_counter0 - 1, min=0)
    diff = rm - volts
    attack = rm >= volts

    # --- attack branch (any state -> 0) ---
    att_volts = volts + diff * p.attack_mult
    att_save = where(state >= 2, volts, save_volts)

    # --- release branches per state ---
    s0_fast = volts > p.pop_ratio * fast_back
    s0_hang = (hang_back > p.hang_level) & (p.hang_enable == 1)
    s0_state = where(s0_fast, 1, where(s0_hang, 2, 3))
    s0_volts = where(
        s0_fast, volts + diff * p.fast_decay_mult,
        where(s0_hang, volts, volts + diff * p.decay_mult))
    s0_hc = where(s0_hang & ~s0_fast, p.hang_counter_init, hang_counter)
    s0_dt = where(s0_fast, decay_type, where(s0_hang, 1, 0)).to(i32)

    s1_fast = volts > save_volts
    s1_hang = hang_counter > 0
    s1_state = where(s1_fast, 1, where(s1_hang, 2,
                                       where(decay_type == 0, 3, 4)))
    s1_volts = where(
        s1_fast, volts + diff * p.fast_decay_mult,
        where(s1_hang, volts,
              where(decay_type == 0,
                    volts + diff * p.decay_mult,
                    volts + diff * p.hang_decay_mult)))

    s2_done = hang_counter == 0
    s2_state = where(s2_done, 4, 2)
    s2_volts = where(s2_done, volts + diff * p.hang_decay_mult, volts)

    s3_volts = volts + diff * p.decay_mult * 0.05
    s4_volts = volts + diff * p.hang_decay_mult

    is0, is1, is2, is3 = (state == 0), (state == 1), (state == 2), (state == 3)
    rel_volts = where(is0, s0_volts, where(
        is1, s1_volts, where(is2, s2_volts, where(is3, s3_volts, s4_volts))))
    rel_state = where(is0, s0_state, where(
        is1, s1_state, where(is2, s2_state, state))).to(i32)
    rel_hc = where(is0, s0_hc, hang_counter).to(i32)
    rel_dt = where(is0, s0_dt, decay_type).to(i32)

    volts = where(attack, att_volts, rel_volts)
    state = where(attack, 0, rel_state).to(i32)
    save_volts = where(attack, att_save, save_volts)
    hang_counter = where(attack, hang_counter, rel_hc).to(i32)
    decay_type = where(attack, decay_type, rel_dt).to(i32)

    volts = torch.clamp(volts, min=p.min_volts)
    return (volts, save_volts, fast_back, hang_back, hang_counter,
            decay_type, state)


def gain_curve(p: AGCParams, volts: torch.Tensor) -> torch.Tensor:
    """Log-domain gain multiplier for a volts sequence
    (`DSP_Fn.cpp:623-627`)."""
    return (p.out_target - p.slope_constant
            * torch.clamp(torch.log10(p.inv_max_input * volts), max=0.0)
            ) / volts


def gain_scan(p: AGCParams, carry, rm_t: torch.Tensor, ao_t: torch.Tensor):
    """The gain recurrence alone: `agc_step` over the samples.

    carry: the 7 (...,) states (4 float32, then hang_counter/decay_type/
    state int32); rm_t/ao_t: (N, ...) time-major ring-max and |out|
    streams.  Returns (final carry, volts_seq (N, ...)), the signature of
    `t41x.kernels.agc_pallas.agc_scan_pallas`."""
    volts_seq = []
    for n in range(rm_t.shape[0]):
        carry = agc_step(p, carry, rm_t[n], ao_t[n])
        volts_seq.append(carry[0])
    return carry, torch.stack(volts_seq)


def agc_apply(params: AGCParams, st: AGCState, x: torch.Tensor,
              use_kernels: bool = False):
    """Apply AGC to a complex block.

    x: (..., N) complex64.  Returns (new_state, y) with y delayed by
    attack_buffsize samples (the look-ahead delay line, like the
    reference).  With `use_kernels`, a block at least one delay line long
    goes to the whole-block kernel K2; a shorter one keeps the prework
    here and runs its recurrence in kernel K5.
    """
    if params.mode == 0:
        return st, params.fixed_gain * x

    p = params
    B = p.attack_buffsize
    N = x.shape[-1]

    if use_kernels and N >= B:
        from t41x_torch.kernels.agc import agc_block
        return agc_block(p, st, x)

    # delay line: out_sample[n] = x[n - B]  (negative index -> carried ring)
    full = torch.cat([st.ring, x], dim=-1)                    # (..., B+N)
    abs_full = torch.cat([st.abs_ring, x.abs()], dim=-1)      # (..., B+N)
    delayed = full[..., :N]
    abs_out = abs_full[..., :N]

    # ring_max[n] = max(|x[n-B+1 .. n]|): the width-B window ending at n
    ring_max = _sliding_window_max(abs_full, B)[..., 1: 1 + N]

    carry = (st.volts, st.save_volts, st.fast_backaverage,
             st.hang_backaverage, st.hang_counter, st.decay_type, st.state)
    rm_t, ao_t = ring_max.movedim(-1, 0), abs_out.movedim(-1, 0)
    if use_kernels:
        from t41x_torch.kernels.agc import agc_scan
        carry, volts_seq = agc_scan(p, carry, rm_t, ao_t)
    else:
        carry, volts_seq = gain_scan(p, carry, rm_t, ao_t)
    y = delayed * gain_curve(p, volts_seq.movedim(0, -1))

    new_state = AGCState(full[..., N:], abs_full[..., N:], *carry)
    return new_state, y
