"""FT8 weak-signal sensitivity and impairment envelope, port of
`tools/ft8_sensitivity.py`.

Measures decode probability against SNR (the WSJT-X convention: signal
power relative to the noise power in a 2.5 kHz bandwidth) for the clean
channel and for three off-air impairments:

  * drift:  +-2 Hz linear transmitter drift across the transmission
  * sro:    +-20 ppm capture sample-rate offset
  * fading: Rayleigh-ish flat fading, 0.2 Hz Doppler spread

Each (condition, SNR) cell runs `--trials` seeded slots (message, start
offset and base frequency drawn per trial, as the reference draws them)
through the port's production decoder (`decode_audio`, adaptive
candidate pool) on `--device`: the card by default, with no fallback;
`--device cpu` for the tests.  It also fits the linear score -> SNR
calibration that `Decoded.snr_db` uses and finds the clean channel's
50% threshold.  The record has `FT8_SENS.json`'s keys.

Usage: python -m t41x_torch.tools.ft8_sensitivity [--trials 10]
    [--snrs -24,...] [--conds clean,...] [--json FT8_SENS_TORCH.json]
    [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from t41x_torch import constants as C
from t41x_torch.decode.ft8 import decode as ft8_decode
from t41x_torch.decode.ft8 import encode as ft8_enc

RATE = C.AUDIO_RATE
SLOT_SECONDS = 14.0
NOISE_STD = 0.1          # fixed noise floor; signal amp set from SNR
EVAL_BW = 2500.0         # WSJT-X SNR reporting bandwidth


def amp_for_snr(snr_db: float, noise_std: float = NOISE_STD) -> float:
    """Sine amplitude for a target SNR in the 2.5 kHz convention.

    White noise with std s at rate R has power s^2 spread over the
    one-sided band R/2; the portion inside 2.5 kHz is s^2 * 2500/(R/2).
    A real sinusoid of amplitude a has power a^2/2.
    """
    noise_in_bw = noise_std ** 2 * EVAL_BW / (RATE / 2.0)
    return float(np.sqrt(2.0 * noise_in_bw * 10.0 ** (snr_db / 10.0)))


CALLS = ["K1ABC", "W9XYZ", "N0DEF", "G4GHI", "VK3JKL", "JA1MNO",
         "PY2PQR", "ZL4STU"]
GRIDS = ["FN42", "EM77", "DM79", "IO91", "QF22", "PM95", "GG66", "RE78"]


def make_slot(snr_db: float, cond: str, trial: int, seed: int):
    """One seeded 14 s slot at the audio rate and its message text."""
    rng = np.random.default_rng(1000 * trial + seed)
    msg = (f"CQ {CALLS[trial % len(CALLS)]} "
           f"{GRIDS[(trial // 2) % len(GRIDS)]}")
    base = float(rng.uniform(600.0, 2400.0))
    dt = float(rng.uniform(0.1, 1.0))
    drift = 0.0
    if cond == "drift":
        drift = float(rng.choice([-2.0, 2.0]))
    a = ft8_enc.synth_audio(ft8_enc.encode(msg), base_freq=base,
                            rate=RATE, amp=amp_for_snr(snr_db),
                            drift_hz=drift)
    if cond == "sro":
        ppm = float(rng.choice([-20.0, 20.0]))
        a = ft8_enc.apply_sample_rate_offset(a, ppm, RATE)
    elif cond == "fading":
        a = ft8_enc.apply_fading(a, doppler_hz=0.2, rate=RATE,
                                 seed=trial + seed)
    slot = (NOISE_STD * rng.standard_normal(int(SLOT_SECONDS * RATE))
            ).astype(np.float32)
    start = int(dt * RATE)
    slot[start:start + len(a)] += a
    return slot, msg


def run_cell(snr_db: float, cond: str, trials: int, seed: int,
             device="cuda"):
    """(decode probability, mean sync score of the hits or None)."""
    hits, scores = 0, []
    for t in range(trials):
        slot, msg = make_slot(snr_db, cond, t, seed)
        decoded = ft8_decode.decode_audio(slot, device=device)
        match = [d for d in decoded if d.text == msg]
        if match:
            hits += 1
            scores.append(match[0].score)
    return hits / trials, (float(np.mean(scores)) if scores else None)


def main(argv=None) -> dict:
    """Run the sweep; print its table and return the record."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--snrs", type=str, default="-24,-22,-20,-18,-16,-14,-10")
    ap.add_argument("--conds", type=str, default="clean,drift,sro,fading")
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the decoder's dense stages run (cuda, cpu)")
    args = ap.parse_args(argv)
    from t41x_torch.tools.bench import device_name, require_device

    dev = require_device(args.device, "ft8_sensitivity")

    snrs = [float(s) for s in args.snrs.split(",")]
    conds = args.conds.split(",")

    table: dict[str, dict] = {}
    fit_pts = []   # (score, snr) pairs from clean successes
    for cond in conds:
        table[cond] = {}
        for snr in snrs:
            prob, mean_score = run_cell(snr, cond, args.trials, args.seed,
                                        dev)
            table[cond][snr] = {"prob": prob, "mean_score": mean_score}
            if cond == "clean" and mean_score is not None:
                fit_pts.append((mean_score, snr))
            print(f"{cond:7s} SNR {snr:+6.1f} dB: "
                  f"P(decode)={prob:4.2f}  mean score="
                  f"{mean_score if mean_score is not None else '-'}",
                  flush=True)

    out = {"trials": args.trials, "noise_std": NOISE_STD,
           "bandwidth_hz": EVAL_BW, "table": table}

    # score -> SNR calibration from the clean sweep
    if len(fit_pts) >= 3:
        sc = np.array([p[0] for p in fit_pts])
        sn = np.array([p[1] for p in fit_pts])
        a, b = np.polyfit(sc, sn, 1)
        out["snr_calibration"] = {"slope": round(float(a), 4),
                                  "intercept": round(float(b), 2)}
        print(f"\nscore->SNR fit: snr_db = {a:.4f} * score + {b:.2f}")

    # threshold: lowest SNR with P(decode) >= 0.5 on the clean channel
    clean = table.get("clean", {})
    thresh = None
    for snr in sorted(clean):
        if clean[snr]["prob"] >= 0.5:
            thresh = snr
            break
    out["clean_threshold_db"] = thresh
    out["device"] = device_name(dev)
    print(f"clean 50% decode threshold: {thresh} dB "
          f"(WSJT-X BP-only reference: ~-18 dB) on {out['device']}")

    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
        print(f"wrote {args.json}")
    return out


if __name__ == "__main__":
    main()
