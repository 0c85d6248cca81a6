"""Time-sharded chain execution (torch), port of `t41x.mesh.timeshard`.

The receive chain's LTI front end (RF gain, DC-block biquad, IQ
correction, Fs/4 shift, NCO mix, x4 + x2 decimation) is time-shardable:
every carried state is either a finite filter history, handed on as a
halo (`t41x_torch.mesh.halo`), or an affine IIR state composed exactly
across shards (the DC-block biquad: each shard runs from a zero state,
the per-shard final states, copied to every shard's device, compose by
an n_shards-step recurrence, and the zero-input response is added back
as one rank-2 correction).

The nonlinear tail (AGC state machine `DSP_Fn.cpp:479-632`, SAM PLL
`Demod.cpp:19-23`, NR trackers `Noise.cpp:19-32`) has an unbounded
per-sample dependency and cannot be halo-sharded; for offline captures
it runs as a second pass over the 24 kHz output of the sharded front end
(8x fewer samples) through the streamed chain's own post-front-end code,
`RxChain._post_frontend`, so the two-pass result matches the streamed
chain by construction.  On the card, with `use_kernels=True` and no
display taps, that tail launches K4, K2 and K3.

A sharded signal is the list of its segments along the `t` axis, each
on its shard's device (`Mesh` of `t41x_torch.mesh.sharding`).  Entry
points:

* `run_time_sharded(chain, mesh, iq)`: the front end only (Fs/4 + NCO +
  decimation + overlap-save band-pass), phase-coherent across shards.
* `run_time_sharded_full(chain, mesh, iq, params)`: the full chain,
  sharded front end and sequential tail, the outputs of `RxChain.run`.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from t41x_torch import constants as C
from t41x_torch.chain.rx import iq_correction, join_blocks
from t41x_torch.dsp import iir, nco
from t41x_torch.mesh import halo
from t41x_torch.mesh.sharding import Mesh, chains_on, shard_bounds, split_tree
from t41x_torch.utils.checkpoint import map_leaves

_FS4 = (1, 1j, -1, -1j)


def _segments(iq: torch.Tensor, devices: list) -> list:
    """iq (..., N) cut into len(devices) equal time segments, each on its
    device."""
    n = iq.shape[-1] // len(devices)
    return [iq[..., i * n:(i + 1) * n].to(d) for i, d in enumerate(devices)]


def sharded_frontend(chain, nco_freq: float = 0.0):
    """The front end of `run_time_sharded` over a sharded signal:
    fn(shards) with shards (..., N_seg) complex segments in `t` order, N_seg
    divisible by BLOCK; returns the band-passed 24 kHz segments."""
    def fn(shards):
        out = []
        for idx, seg in enumerate(shards):
            n, dev = seg.shape[-1], seg.device
            # global sample offset of this shard for phase-coherent shifts
            k = torch.arange(n, device=dev) + idx * n
            # Fs/4 shift with global phase: j^(offset+n)
            pattern = torch.exp(torch.complex(
                torch.zeros(n, device=dev),
                0.5 * math.pi * (k % 4).to(torch.float32)))
            x = seg * pattern
            # NCO with global phase
            w = nco.nco_phase_inc(torch.tensor(nco_freq, device=dev),
                                  chain.spec.sample_rate)
            theta = w * (k + 1).to(torch.float32)
            x = (nco.FREQ_ADJ_FACTOR * x) * torch.exp(torch.complex(
                torch.zeros_like(theta), -theta))
            out.append(x)
        t = chain.tensors
        out = halo.sharded_fir_decimate(out, t["h1"], C.DF1)
        out = halo.sharded_fir_decimate(out, t["h2"], C.DF2)
        out = [x * chain.vol_scale for x in out]
        return halo.sharded_os_filter(out, t["mask"], chain.spec.fft_length)

    return fn


def run_time_sharded(chain, mesh: Mesh, iq, axis_name: str = "t",
                     nco_freq: float = 0.0):
    """The front end over a capture iq (N,) complex, time-sharded on
    `mesh`'s `axis_name` (N divisible by n_shards * BLOCK).  Returns the
    (N/8,) band-passed 24 kHz stream on the mesh's first device."""
    devs = list(mesh.devices.flat)
    if mesh.axis_names != (axis_name,):
        raise ValueError(f"a 1-D {axis_name!r} mesh, not {mesh.axis_names}")
    shards = _segments(torch.as_tensor(iq), devs)
    out = sharded_frontend(chain, nco_freq)(shards)
    return torch.cat([y.to(devs[0]) for y in out], dim=-1)


# ----------------------------------------------------------------------
# Full-chain time sharding (sharded LTI front end + sequential tail)
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _dc_terms(b: tuple, a: tuple, n_seg: int):
    """`_dc_affine_terms` made once a design and segment length (the
    companion powers are an n_seg-step host loop)."""
    return _dc_affine_terms(np.asarray(b), np.asarray(a), n_seg)


def _dc_affine_terms(b: np.ndarray, a: np.ndarray, n_seg: int):
    """Zero-input operators for one biquad stage over an n_seg-sample
    segment, float64 at design time:

      R  (n_seg, 2): y_zi[n] = s0 · R[n]   (R[n] = Cn @ An^n)
      AN (2, 2):     s_final = s0 @ AN.T + s_zero-state  (AN = An^n_seg)

    in the balanced normal-form realization of `iir.BiquadChunked`
    (`iir._normal_form_powers`): s0 is a `BiquadChunked` state, so the
    coordinates must match, and the rotation form keeps An^n
    well-conditioned where the companion form's long powers peak at
    ~|1/(1-r)| entries for near-unity poles."""
    b0, b1, b2 = (float(b[0]), float(b[1]), float(b[2]))
    a1, a2 = float(a[1]), float(a[2])
    k = np.array([b1 - a1 * b0, b2 - a2 * b0])
    A = np.array([[-a1, 1.0], [-a2, 0.0]], np.float64)
    P = np.empty((n_seg + 1, 2, 2))
    P[0] = np.eye(2)
    for m in range(n_seg):           # companion fallback basis only
        P[m + 1] = A @ P[m]
    pw, Bn, Cn = iir._normal_form_powers(a1, a2, k, n_seg, P)
    R = np.einsum("j,njk->nk", Cn, pw[:n_seg])
    return R.astype(np.float32), pw[n_seg].astype(np.float32)


def sharded_frontend_full(chain):
    """The full front end over a sharded signal: RF gain, DC-block biquad
    (exact by affine state composition), IQ correction, Fs/4 + NCO with
    globally coherent phase, x4 + x2 halo decimation.

    fn(shards, fe_params) with shards the (..., N_seg) complex segments at
    the RF rate in `t` order and fe_params[i] = (gain, iq_amp, iq_phase,
    nco_freq), (...,) channel tensors on shard i's device; returns the
    (..., N_seg/8) complex 24 kHz segments, the streamed chain's signal
    before `_post_frontend`."""
    spec = chain.spec
    h1, h2 = chain.tensors["h1"], chain.tensors["h2"]
    dc_op = chain.dc_op

    def fn(shards, fe_params):
        n = shards[0].shape[-1]
        if n % (4 * C.DF):
            raise ValueError(f"a segment of {n} samples is not a multiple "
                             f"of {4 * C.DF}")
        R, AN = (torch.from_numpy(a) for a in _dc_terms(
            tuple(chain.dc_b[0].tolist()), tuple(chain.dc_a[0].tolist()), n))

        # RF gain, then the DC-block biquad of every shard from a zero
        # state (Process.cpp:117-134)
        y_z, st_z = [], []
        for seg, (g, *_) in zip(shards, fe_params):
            x = seg * g[..., None]
            xi = torch.stack([x.real, x.imag], dim=-2)       # (..., 2, N)
            zeros = torch.zeros(xi.shape[:-1] + (1, 2), device=seg.device)
            s, y = dc_op.apply(zeros, xi)
            st_z.append(s)
            y_z.append(y)

        # each shard's true initial state: the zero-state finals of the
        # shards before it, composed in shard order on its own device
        inits = {}
        out = []
        for idx, (seg, (_, iq_amp, iq_phase, nco_freq)) in enumerate(
                zip(shards, fe_params)):
            dev = seg.device
            if dev not in inits:
                an_t = AN.to(dev).T
                s = torch.zeros_like(st_z[0]).to(dev)
                inits[dev] = []
                for z in st_z:
                    inits[dev].append(s)
                    s = torch.matmul(s, an_t) + z.to(dev)
            s_own = inits[dev][idx]                          # (..., 2, 1, 2)
            y = y_z[idx] + s_own[..., 0, :] @ R.to(dev).T
            x = iq_correction(y[..., 0, :], y[..., 1, :], iq_amp,
                              iq_phase)
            offset = idx * n
            # Fs/4 with global phase: j^offset rotates the local pattern
            x = x * (nco._fs4_pattern(n, dev) * _FS4[offset % 4])
            # NCO with the global sample offset folded into the start
            # phase, in t41x's float32 order: offset -> float32, x w, mod 2 pi
            w = nco.nco_phase_inc(nco_freq, spec.sample_rate)
            phase0 = torch.remainder(w * float(np.float32(offset)),
                                     2.0 * math.pi)
            _, x = nco.nco_mix(phase0, x, nco_freq, spec.sample_rate)
            out.append(x)

        out = halo.sharded_fir_decimate(out, h1, C.DF1)
        return halo.sharded_fir_decimate(out, h2, C.DF2)

    return fn


def frontend_params(params, device) -> tuple:
    """The front end's per-channel parameters from `ChannelParams`:
    (gain, iq_amp, iq_phase, nco_freq), float32 on `device`."""
    p = params
    g = (10.0 ** (p.rf_gain_db / 20.0) * p.band_gain).to(torch.float32)
    return tuple(t.to(device, torch.float32)
                 for t in (g, p.iq_amp, p.iq_phase, p.nco_freq))


def frontend_pass(chain, mesh: Mesh, iq, params=None, axis_name: str = "t",
                  channel_axis: str | None = None) -> list:
    """Pass 1 of `run_time_sharded_full`: each channel slice through the
    front end over its row's time shards.  Returns, for each slice in
    mesh order, [the chain on the row's first device, the slice's
    params there, its (..., N/8) complex 24 kHz stream there]."""
    from t41x_torch.chain import default_params

    if chain.spec.spectrum_zoom >= 0:
        raise ValueError("display zoom taps are front-end-resident; use "
                         "spectrum_zoom=-1")
    want = (axis_name,) if channel_axis is None else (channel_axis,
                                                      axis_name)
    if mesh.axis_names != want:
        raise ValueError(f"a {want} mesh, not {mesh.axis_names}")
    rows = mesh.devices[None] if channel_axis is None else mesh.devices
    iq = torch.as_tensor(iq)
    ch = tuple(iq.shape[:-1])
    if channel_axis is not None and not ch:
        raise ValueError("channel_axis needs a channel batch dim")
    bounds = (shard_bounds(ch[0], len(rows)) if channel_axis is not None
              else [(None, None)])
    n_t = mesh.shape[axis_name]
    if iq.shape[-1] % (n_t * C.BLOCK_SIZE):
        raise ValueError(f"{iq.shape[-1]} samples do not split into {n_t} "
                         "shards of whole blocks")
    if params is None:
        params = default_params(ch, device=rows[0][0])
    fe = sharded_frontend_full(chain)
    chains = chains_on(chain, [row[0] for row in rows])
    slices = []
    for row, (lo, hi) in zip(rows, bounds):
        devs = list(row)
        if channel_axis is None:
            x_rows, p_rows = iq, map_leaves(lambda _, t: t.to(devs[0]),
                                            params)
        else:
            x_rows, p_rows = iq[lo:hi], split_tree(params, lo, hi, devs[0])
        x24 = fe(_segments(x_rows, devs),
                 [frontend_params(p_rows, d) for d in devs])
        slices.append([chains[devs[0]], p_rows,
                       torch.cat([x.to(devs[0]) for x in x24], dim=-1)])
    return slices


def tail_pass(slices: list) -> dict:
    """Pass 2 of `run_time_sharded_full`: the chain's tail
    (`RxChain._post_frontend`) over each slice's 24 kHz stream from a
    fresh state, block by block with the slices inner (slices on
    separate cards run at once).  Returns the outputs of `RxChain.run`
    (time last), the slices joined on the first slice's device."""
    blk = C.BLOCK_SIZE // C.DF
    n_lead = slices[0][2].ndim - 1
    states = [tail.init_state(tuple(x24.shape[:-1]))
              for tail, _, x24 in slices]
    outs = [[] for _ in slices]
    for b in range(slices[0][2].shape[-1] // blk):
        for i, (tail, p, x24) in enumerate(slices):
            states[i], out = tail._post_frontend(
                p, states[i], x24[..., b * blk:(b + 1) * blk].contiguous(),
                {})
            outs[i].append(out)
    home = slices[0][2].device
    joined = [join_blocks(o, n_lead) for o in outs]
    return {k: torch.cat([o[k].to(home) for o in joined])
            for k in joined[0]}


def run_time_sharded_full(chain, mesh: Mesh, iq, params=None,
                          axis_name: str = "t",
                          channel_axis: str | None = None):
    """Run the FULL receive chain over an offline capture, time-sharded.

    Pass 1 (`frontend_pass`, sharded over `axis_name`): the LTI front
    end, all the 192 kHz work, with halos for the decimators and exact
    DC-block state composition.  Pass 2 (`tail_pass`, sequential): the
    tail (overlap-save band-pass, AGC, demod, NR, notch, CW, EQ, x8
    interpolation) over the 8x smaller audio-rate stream, through
    `RxChain._post_frontend`, so the result matches the streamed chain.

    iq: (..., N) complex at the RF rate, N divisible by n_shards *
    BLOCK_SIZE; leading dims are channels.  With `channel_axis` (the
    mesh's first axis, the mesh then (ch, t)), the leading channel dim is
    split over that axis in contiguous equal slices, each slice running
    on its row of the mesh, its tail on the row's first device.
    Returns the outputs dict of `RxChain.run` (time last) on the mesh's
    first device.  Display zoom taps are front-end-resident: the spec
    needs `spectrum_zoom=-1`."""
    return tail_pass(frontend_pass(chain, mesh, iq, params, axis_name,
                                   channel_axis))
