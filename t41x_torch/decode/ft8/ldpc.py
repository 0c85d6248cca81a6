"""FT8 LDPC(174,91) belief-propagation decoder (torch, device side),
port of `t41x.decode.ft8.ldpc`.

Re-expression of the reference's `bp_decode` (tmr4/T41_SDR
`ft8.cpp:518-596`) as fixed-iteration, candidate-batched message passing
over the (83-check, 174-variable) graph, tracking the best (fewest
parity errors) hard decision across iterations.

t41x sums the check messages into each variable with a scatter-add
(`upd.at[..., NM0].add`), which on the card would be atomics whose order
changes from run to run.  Here each variable gathers its 3 checks'
messages (`tables.MN`, ascending) and sums them in one fixed order,
((0 + c0) + c1) + c2, the order of t41x's scatter on the CPU: the
decoder is deterministic on the card and matches t41x on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from t41x_torch.decode.ft8.tables import H, M, MN, N, NM, NRW

MAX_CHECK_DEGREE = 7

# check -> variable adjacency, 0-padded, with validity mask
_nm = np.zeros((M, MAX_CHECK_DEGREE), np.int64)
_nm_mask = np.zeros((M, MAX_CHECK_DEGREE), bool)
for _m in range(M):
    for _i in range(NRW[_m]):
        _nm[_m, _i] = NM[_m][_i] - 1
        _nm_mask[_m, _i] = True
# variable -> its 3 edges, as indices into the flattened (M, 7) messages
_edges = np.asarray([[(m - 1) * MAX_CHECK_DEGREE
                      + list(NM[m - 1]).index(v + 1) for m in MN[v]]
                     for v in range(N)], np.int64)

_on_device: dict = {}


def _tables(device):
    if device not in _on_device:
        _on_device[device] = tuple(torch.from_numpy(a).to(device) for a in (
            _nm, _nm_mask, _edges, H.astype(np.float32)))
    return _on_device[device]


class BPResult(NamedTuple):
    bits: torch.Tensor    # (..., 174) best hard decision
    errors: torch.Tensor  # (...,) parity errors of that decision


def _parity_errors(bits: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    syn = torch.remainder(bits @ h.T, 2.0)
    return syn.sum(dim=-1).to(torch.int32)


def bp_decode(llr: torch.Tensor, iters: int = 25) -> BPResult:
    """llr: (..., 174) log(p(1)/p(0)) per codeword bit.

    Sum-product BP with per-iteration best-decision tracking; batched
    over leading dims.
    """
    llr = llr.to(torch.float32)
    nm0, mask, edges, h = _tables(llr.device)
    batch = llr.shape[:-1]

    def var_llr(tov):
        """Total LLR per variable = channel + the sum of its 3 checks'
        messages, in a fixed order."""
        flat = tov.reshape(batch + (M * MAX_CHECK_DEGREE,))
        e = flat[..., edges]                              # (..., N, 3)
        upd = (e[..., 0] + e[..., 1]) + e[..., 2]
        return llr + upd

    tov = llr.new_zeros(batch + (M, MAX_CHECK_DEGREE))
    best_bits = (llr > 0).to(torch.float32)
    best_err = _parity_errors(best_bits, h)
    for _ in range(iters):
        total = var_llr(tov)
        # variable->check messages: total minus this check's contribution
        v2c = total[..., nm0] - torch.where(mask, tov, 0.0)
        # check->variable: tanh rule over the other edges
        t = torch.tanh(-0.5 * torch.clamp(v2c, -20.0, 20.0))
        t = torch.where(mask, t, 1.0)
        prod = t[..., :1]
        for i in range(1, MAX_CHECK_DEGREE):
            prod = prod * t[..., i:i + 1]
        t_safe = torch.where(t.abs() < 1e-7, torch.sign(t) * 1e-7 + 1e-12, t)
        others = torch.clamp(prod / t_safe, -0.999999, 0.999999)
        tov = torch.where(mask, -2.0 * torch.atanh(others), 0.0)

        bits = (var_llr(tov) > 0).to(torch.float32)
        err = _parity_errors(bits, h)
        best_bits = torch.where((err < best_err)[..., None], bits, best_bits)
        best_err = torch.minimum(err, best_err)
    return BPResult(best_bits.to(torch.uint8), best_err)
