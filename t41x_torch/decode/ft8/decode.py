"""FT8 decoder orchestration, port of `t41x.decode.ft8.decode`.

Device side: waterfall -> vectorized Costas sync -> batched soft-bit
extraction -> candidate-parallel LDPC BP, on the decoder's device (the
card unless the caller passes `device="cpu"`).
Host side: CRC-14 check, 77-bit unpacking, dedupe, SNR and distance —
the branchy tail of the reference's `ft8_decode` (tmr4/T41_SDR
`ft8.cpp:727-887`), on what the device hands back (`.cpu()`, where t41x
calls its `utils.transfer.fetch`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from t41x_torch.decode.ft8 import crc, ldpc, message, sync, waterfall
from t41x_torch.decode.ft8.tables import GRAY


@dataclass
class Decoded:
    text: str
    score: float
    time_offset: int
    freq_hz: float
    bits77: np.ndarray
    snr_db: float = 0.0        # calibrated estimate, WSJT-X 2.5 kHz conv.
    distance_km: float | None = None  # great-circle to the msg grid


# Score -> SNR calibration (t41x's fit: the clean-channel sensitivity
# sweep, tools/ft8_sensitivity.py, FT8_SENS.json; the reference's analog
# is SNR = (score-160)/6 on ITS byte-waterfall score scale, ft8.cpp:874).
SNR_SLOPE = 0.2058
SNR_INTERCEPT = -31.15


def score_to_snr_db(score: float) -> float:
    """Calibrated per-decode SNR estimate from the sync score, clamped
    to the plausible FT8 reporting range like WSJT-X's -24..+49."""
    return float(np.clip(SNR_SLOPE * score + SNR_INTERCEPT, -24.0, 49.0))


def grid_of_message(text: str) -> str | None:
    """The 4-char Maidenhead grid of a standard message, if it carries
    one (reference: ft8_decode unpacks field3 and calls Target_Distance
    when it looks like a grid, ft8.cpp:830-874)."""
    parts = text.strip().split()
    if not parts:
        return None
    g = parts[-1]
    if (len(g) == 4 and "A" <= g[0] <= "R" and "A" <= g[1] <= "R"
            and g[2].isdigit() and g[3].isdigit() and g != "RR73"):
        return g
    return None


_K_DATA = np.arange(58)
_SYM_IDX = np.where(_K_DATA < 29, _K_DATA + 7, _K_DATA + 14)  # skip sync
# the Gray-mapped tone groups of each of a symbol's 3 bits: (ones, zeros)
_BIT_TONES = (([4, 5, 6, 7], [0, 1, 2, 3]), ([2, 3, 6, 7], [0, 1, 4, 5]),
              ([1, 3, 5, 7], [0, 2, 4, 6]))


def extract_llrs(wf: torch.Tensor, cands: sync.Candidates,
                 max_time_pad: int = 7):
    """Soft bits for each candidate (reference `extract_likelihood` +
    `decode_symbol`, `ft8.cpp:320-332,424-463`), batched over candidates.

    wf: (n_slots, 2, 2, n_bins).  Returns (K, 174) normalized LLRs.
    """
    pad, dev = max_time_pad, wf.device
    z = wf.new_zeros((pad,) + wf.shape[1:])
    wfp = torch.cat([z, wf, z])

    slots = (cands.time_offset[:, None] + pad
             + torch.from_numpy(_SYM_IDX).to(dev))          # (K, 58)
    # gather 8 tone bins per data symbol: (K, 58, 8)
    bins = (cands.freq_offset[:, None, None]
            + torch.arange(8, device=dev)[None, None, :])
    p8 = wfp[slots[..., None], cands.time_sub[:, None, None],
             cands.freq_sub[:, None, None], bins]
    s2 = p8[..., torch.tensor(GRAY, device=dev)]       # s2[j]=p8[gray[j]]

    def max_over(idx):
        return s2[..., torch.tensor(idx, device=dev)].amax(dim=-1)

    llr = torch.stack([max_over(one) - max_over(zero)
                       for one, zero in _BIT_TONES],
                      dim=-1).reshape(p8.shape[0], -1)     # (K, 174)

    # variance normalization to sigma=4 (ft8.cpp:451-462)
    mean = llr.mean(dim=-1, keepdim=True)
    var = (llr * llr).mean(dim=-1, keepdim=True) - mean * mean
    return llr * torch.sqrt(16.0 / torch.clamp_min(var, 1e-12))


def _device_pipeline(audio, k_candidates: int, bp_iters: int):
    wf = waterfall.compute_waterfall(audio)
    cands = sync.find_candidates(wf, k_candidates)
    llrs = extract_llrs(wf, cands)
    result = ldpc.bp_decode(llrs, bp_iters)
    return cands, result


def _wf_and_pool(audio, k_pool: int):
    wf = waterfall.compute_waterfall(audio)
    return wf, sync.find_candidates(wf, k_pool)


def _llr_bp(wf, cands, bp_iters: int):
    llrs = extract_llrs(wf, cands)
    return ldpc.bp_decode(llrs, bp_iters)


# Candidate score floor: the reference rejects sync candidates scoring
# below 40 (`find_sync` threshold, `ft8.cpp:374`).  t41x calibrated the
# score scale against synthetic slots AT THE DEFAULT GEOMETRY
# (rate=24000, base_bin_hz=TONE_SPACING, rectangular window): pure-noise
# slots top out around 38, real signals at the -18 dB decode threshold
# score ~57-64 (FT8_SENS.json).  A different geometry shifts the score
# scale, so the adaptive path then decodes the full pool.
SCORE_FLOOR = 40.0
_K_POOL = 96
_K_BUCKETS = (12, 24, 48, 96)


def _pool_bucket(pool_scores: np.ndarray, score_floor: float) -> int:
    """The smallest BP bucket covering the pool's candidates at or above
    the floor (0: none is)."""
    n_above = int(np.sum(pool_scores >= score_floor))
    if n_above == 0:
        return 0
    return next((b for b in _K_BUCKETS if b >= n_above), _K_POOL)


def decode_audio(audio: np.ndarray, k_candidates: int | None = None,
                 bp_iters: int = 25, rate: float = 24000.0,
                 base_bin_hz: float = waterfall.TONE_SPACING,
                 hashes: message.CallHashTable | None = None,
                 score_floor: float = SCORE_FLOOR,
                 my_grid: str | None = None,
                 device="cuda") -> list[Decoded]:
    """Demodulated USB audio (15 s slot at 24 kHz) -> decoded messages.

    k_candidates=None (default) adapts the candidate count to band
    occupancy: sync scores for a 96-deep pool are computed once, the
    score floor discards noise-level candidates, and LDPC runs on the
    smallest static bucket (12/24/48/96) covering the survivors.  Pass
    an int to force a fixed candidate count.

    Pass a `CallHashTable` kept across slots to resolve `<hashed>`
    calls in type-4 messages.  Pass `my_grid` (the station locator,
    config.my_grid) to get `distance_km` on decodes that carry a grid
    (reference `set_Station_Coordinates` + `Target_Distance`,
    locator.cpp:30-45).  `device`: where the dense stages run."""
    x = torch.as_tensor(np.asarray(audio, np.float32)).to(device)
    if k_candidates is not None:
        cands, result = _device_pipeline(x, k_candidates, bp_iters)
    else:
        if (rate, base_bin_hz) != (24000.0, waterfall.TONE_SPACING) \
                and score_floor == SCORE_FLOOR:
            # the default floor is calibrated for the default waterfall
            # geometry only; decode the full pool instead
            score_floor = -np.inf
        wf, pool = _wf_and_pool(x, _K_POOL)
        k = _pool_bucket(pool.score.cpu().numpy(), score_floor)
        if k == 0:
            return []
        cands = sync.Candidates(*(a[:k] for a in pool))
        result = _llr_bp(wf, cands, bp_iters)
    return messages(result, cands, base_bin_hz, hashes, my_grid)


def messages(result: ldpc.BPResult, cands: sync.Candidates,
             base_bin_hz: float = waterfall.TONE_SPACING,
             hashes: message.CallHashTable | None = None,
             my_grid: str | None = None) -> list[Decoded]:
    """The host tail: the candidates whose best hard decision has no
    parity error and a good CRC, unpacked, deduplicated, strongest
    first."""
    errors = result.errors.cpu().numpy()
    bits = result.bits.cpu().numpy()
    scores, dts, _, fsub, dfs = (a.cpu().numpy() for a in cands)

    out: list[Decoded] = []
    seen: set[str] = set()
    for i in np.argsort(-scores):
        if errors[i] != 0:
            continue
        b = np.asarray(bits[i]).astype(np.uint8)
        if not crc.check_crc(b[:91]):
            continue
        text = message.unpack77(b[:77], hashes)
        if text in seen:
            continue
        seen.add(text)
        dist = None
        if my_grid:
            g = grid_of_message(text)
            if g is not None:
                from t41x_torch.decode import locator

                dist = round(locator.distance_km(my_grid, g), 0)
        out.append(Decoded(
            text=text,
            score=float(scores[i]),
            time_offset=int(dts[i]),
            freq_hz=float(dfs[i] * base_bin_hz + fsub[i] * base_bin_hz / 2),
            bits77=b[:77],
            snr_db=score_to_snr_db(float(scores[i])),
            distance_km=dist,
        ))
    return out
