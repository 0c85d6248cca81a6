"""FT8 CRC-14 (reference `crc`, tmr4/T41_SDR `ft8.cpp:672-703`).

A copy of `t41x.decode.ft8.crc`, so the port never imports JAX
(`tests/test_torch_host_copies.py` pins the two equal).
"""

from __future__ import annotations

import numpy as np

from t41x_torch.decode.ft8.tables import CRC_POLY, CRC_WIDTH


def crc14(bits: np.ndarray) -> int:
    """CRC over a bit array (MSB-first), matching the reference's
    byte-fed shift register: the message is processed as whole bytes with
    zero padding (so 77 payload bits are CRC'd as 82 bits per the FT8
    spec: 77 bits + 5 zeros in WSJT-X; callers pass the padded array)."""
    bits = np.asarray(bits).astype(int)
    rem = 0
    top = 1 << (CRC_WIDTH - 1)
    for b in bits:
        rem ^= (int(b) << (CRC_WIDTH - 1))
        if rem & top:
            rem = ((rem << 1) ^ CRC_POLY) & ((1 << CRC_WIDTH) - 1)
        else:
            rem = (rem << 1) & ((1 << CRC_WIDTH) - 1)
    return rem


def add_crc(payload77: np.ndarray) -> np.ndarray:
    """77 payload bits -> 91 bits (payload + CRC14 over the 82-bit
    zero-padded payload, per the FT8 spec)."""
    payload77 = np.asarray(payload77).astype(np.uint8)
    padded = np.concatenate([payload77, np.zeros(5, np.uint8)])
    c = crc14(padded)
    crc_bits = [(c >> (13 - i)) & 1 for i in range(14)]
    return np.concatenate([payload77, np.asarray(crc_bits, np.uint8)])


def check_crc(bits91: np.ndarray) -> bool:
    bits91 = np.asarray(bits91).astype(np.uint8)
    expect = add_crc(bits91[:77])
    return bool((expect == bits91).all())
