"""The comparison that decides `correct`: the program's outputs and
carried state against the plain reference's, number by number, each
against the limit its configuration states.

What is compared (see `PERF.md`, "How `correct` is decided"):

* the start: the first pass of the timed graphs over the resident blocks,
  from the initial state, against the reference from its own;
* the end: the window's last dispatch, against the reference run from the
  state the program carried into it (a copy taken just before it), and
  the state the program carried out of it against the reference's.

The numbers (short names, as the result line prints them):

* `<output>` for an output of kind `rel`: the worst channel's relative
  error, ||got - ref|| / ||ref|| over that channel's samples of a block,
  the worst block;
* `<output>` of kind `display_db`: the largest error in dB of a
  displayed spectrum within its 60 dB range (bins below a channel's peak
  - 60 dB clip to that floor), the formula of `t41x_torch/utils/parity.py`
  `spectrum_err_db` per channel;
* `state`: the worst leaf of the carried state, each leaf read at its
  99th-percentile channel: a channel's ||got - ref|| over the larger of
  its ||ref|| and the median channel's, complex leaves by their
  magnitudes and phases (`ANGLES`) by the difference wrapped into
  [-pi, pi), over the leaves that no branch decision sets (the reference
  names those, `DECISIONS`: the AGC's state, decay type, hang counter
  and saved level).  The percentile, not the worst channel: on the
  looped resident blocks the AGC's attack test ties to rounding on a few
  channels in a hundred, whose level and audio history then read up to
  ~0.1 in sound runs; the outputs' own numbers hold every channel.
  Magnitudes: the NCO's phase runs to ~335 rad a block in float32, so
  every complex leaf after it carries ~1e-5 rad of rotation a block, in
  the program and in a float32 control alike; the phase reaches the
  audio, which is compared.  A leaf left unchanged, or not carried from
  one dispatch to the next, differs on every channel and reads about 1;
  a decision leaf not carried shows in the next dispatch's outputs,
  since the end follows two dispatches.

This module imports torch only.
"""

from __future__ import annotations

import math

import torch

DISPLAY_RANGE = 1e-6   # 60 dB


def _f64(t) -> torch.Tensor:
    t = torch.view_as_real(t) if t.is_complex() else t
    return t.to(torch.float64)


def rel(got, ref) -> float:
    g, r = _f64(got), _f64(ref)
    dims = tuple(range(1, r.dim()))
    num = (g - r).square().sum(dims).sqrt() if dims else (g - r).abs()
    den = r.square().sum(dims).sqrt() if dims else r.abs()
    e = num / den.clamp_min(torch.finfo(torch.float64).tiny)
    return float(e.max()) if torch.isfinite(e).all() else math.inf


def display_db(got, ref) -> float:
    g, r = _f64(got), _f64(ref)
    fl = torch.maximum(g.amax(-1, keepdim=True),
                       r.amax(-1, keepdim=True)) * DISPLAY_RANGE
    d = (10 * torch.log10(torch.maximum(g, fl))
         - 10 * torch.log10(torch.maximum(r, fl))).abs()
    return float(d.max()) if torch.isfinite(d).all() else math.inf


KINDS = {"rel": rel, "display_db": display_db}


def outputs(compare: dict, got: dict, ref_blocks: list) -> list:
    """Per block b, {name: value} of every compared output: `got` keyed
    `name.b` (the program's dispatch outputs), `ref_blocks` the
    reference's output dicts a block."""
    per_block = []
    for b, ref in enumerate(ref_blocks):
        row = {}
        for name, kind in compare.items():
            key = f"{name}.{b}"
            row[name] = (KINDS[kind](got[key], ref[name]) if key in got
                         else math.inf)
        per_block.append(row)
    return per_block


def state(got: dict, ref: dict, skip=frozenset(),
          complex_leaves=frozenset(), angles=frozenset()) -> dict:
    """{'state': the worst leaf's error at its 99th-percentile channel}
    over the reference's leaves but `skip`; `got` holds the program's
    leaves by the same names, the reference's `complex_leaves` as
    (..., 2) pairs, `angles` compared modulo 2 pi.  Also 'worst_leaf' and
    every leaf's reading, 'leaves'."""
    rel = {}
    for k, r in ref.items():
        if k in skip:
            continue
        if k not in got:
            return {"state": math.inf, "worst_leaf": k, "leaves": rel}
        g = _f64(got[k].to(r.device)).reshape(r.shape)
        r = r.to(torch.float64)
        if k in complex_leaves:
            g, r = g.square().sum(-1).sqrt(), r.square().sum(-1).sqrt()
        d = g - r
        if k in angles:
            d = torch.remainder(d + math.pi, 2 * math.pi) - math.pi
        channels = r.shape[0]
        dn = d.reshape(channels, -1).norm(dim=1)
        rn = r.reshape(channels, -1).norm(dim=1)
        e = dn / rn.clamp_min(rn.median()).clamp_min(
            torch.finfo(torch.float64).tiny)
        e = torch.sort(e).values[int(0.99 * (channels - 1))]
        rel[k] = float(e) if torch.isfinite(e) else math.inf
    leaf = max(rel, key=rel.get)
    return {"state": rel[leaf], "worst_leaf": leaf, "leaves": rel}


def share_differing(got, ref) -> float:
    """The share of channels (the first axis) on which `got` differs from
    `ref` at all."""
    g = got.to(ref.device).reshape(ref.shape).to(ref.dtype)
    return float((g != ref).reshape(ref.shape[0], -1).any(1).double().mean())


def verdict(values: dict, limits: dict) -> dict:
    """{name: (value, limit)} for every limit; a number without a value
    reads as infinity (it fails)."""
    return {k: (values.get(k, math.inf), float(lim))
            for k, lim in limits.items()}


def passed(checks: dict) -> bool:
    return all(math.isfinite(v) and v <= lim for v, lim in checks.values())
