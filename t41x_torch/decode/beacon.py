"""NCDXF/IARU beacon SNR monitor (BASELINE config 4).

Re-expression of the reference's beacon monitor (tmr4/T41_SDR
`Beacon.cpp`): the 18 NCDXF beacons transmit in a synchronized 3-minute
rotation across 5 bands (14.100/18.110/21.150/24.930/28.200 MHz), 10 s
per beacon per band; per slot the monitor estimates SNR as
max(dBm) - min(dBm) over the slot's S-meter series
(`BeaconLoop` `Beacon.cpp:457-616`, SNR at `:503-536`).

Where the reference hops one receiver across bands with `ChangeBand`,
t41x listens to all 5 bands as a CHANNEL BATCH: one chain run with 5 (or
5xN) channels yields every band's dBm series simultaneously; the slot
scheduling and SNR table assembly are host-side bookkeeping.

A copy of `t41x.decode.beacon`, so the port never imports JAX
(`tests/test_torch_host_copies.py` pins the two equal).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from t41x_torch import constants as C

SLOT_SECONDS = 10.0
NUM_SLOTS = 18

BANDS_MHZ = (14.100, 18.110, 21.150, 24.930, 28.200)

# NCDXF beacon rotation (call, grid) in slot order — public beacon
# network data (reference table `Beacon.cpp:65-85`, ncdxf.org).
BEACONS = (
    ("4U1UN", "FN30as"), ("VE8AT", "CP38gh"), ("W6WX", "CM97bd"),
    ("KH6RS", "BL10ts"), ("ZL6B", "RE78tw"), ("VK6RBP", "OF87av"),
    ("JA2IGY", "PM84jk"), ("RR9O", "NO14kx"), ("VR2B", "OL72bg"),
    ("4S7B", "MJ96wv"), ("ZS6DN", "KG33xi"), ("5Z4B", "KI88hr"),
    ("4X6TU", "KM72jb"), ("OH2B", "KP20eh"), ("CS3B", "IM12jt"),
    ("LU4AA", "GF05tj"), ("OA4B", "FH17mw"), ("YV5B", "FJ69cc"),
)


def beacon_schedule(slot_index: int) -> list[tuple[str, float]]:
    """Which beacon is on which band during a given 10 s slot:
    beacon b transmits on band k during slot (b + k) mod 18."""
    out = []
    for k, band in enumerate(BANDS_MHZ):
        b = (slot_index - k) % NUM_SLOTS
        out.append((BEACONS[b][0], band))
    return out


def slot_snr(dbm_series: np.ndarray, blocks_per_slot: int | None = None
             ) -> np.ndarray:
    """Per-slot SNR = max(dbm) - min(dbm) within each slot
    (reference `Beacon.cpp:503-536`).

    dbm_series: (..., n_blocks) S-meter dBm per processing block.
    Returns (..., n_slots).
    """
    if blocks_per_slot is None:
        blocks_per_slot = int(round(SLOT_SECONDS / C.BLOCK_SECONDS))
    n = dbm_series.shape[-1] // blocks_per_slot
    x = dbm_series[..., : n * blocks_per_slot]
    x = x.reshape(x.shape[:-1] + (n, blocks_per_slot))
    return x.max(-1) - x.min(-1)


@dataclass
class BeaconReport:
    """SNR table: snr[beacon, band] in dB (nan = not yet observed)."""
    snr: np.ndarray

    def __init__(self):
        self.snr = np.full((NUM_SLOTS, len(BANDS_MHZ)), np.nan)

    def update(self, slot_index: int, band_snrs: np.ndarray) -> None:
        """band_snrs: (5,) SNR measured on each band during this slot."""
        for k in range(len(BANDS_MHZ)):
            b = (slot_index - k) % NUM_SLOTS
            self.snr[b, k] = band_snrs[k]

    def render(self) -> str:
        hdr = "beacon   " + " ".join(f"{b:7.3f}" for b in BANDS_MHZ)
        rows = [hdr]
        for i, (call, _grid) in enumerate(BEACONS):
            cells = " ".join(
                "   --  " if np.isnan(v) else f"{v:6.1f} "
                for v in self.snr[i])
            rows.append(f"{call:8s} {cells}")
        return "\n".join(rows)


def monitor_capture(chains_dbm: np.ndarray, start_slot: int = 0
                    ) -> BeaconReport:
    """Run the monitor over a multi-band dBm capture.

    chains_dbm: (5, n_blocks) per-band S-meter series covering whole
    10 s slots.  Returns the filled SNR report.
    """
    blocks_per_slot = int(round(SLOT_SECONDS / C.BLOCK_SECONDS))
    snrs = slot_snr(chains_dbm, blocks_per_slot)  # (5, n_slots)
    report = BeaconReport()
    for s in range(snrs.shape[-1]):
        report.update(start_slot + s, snrs[:, s])
    return report
