"""FT8 77-bit message packing/unpacking (host side).

Standard type-1 messages (call/call/grid-or-report), free text (0.0),
telemetry (0.5), and nonstandard/hashed-call messages (type 4),
following the WSJT-X bit layout as implemented by the reference
(tmr4/T41_SDR `ft8.cpp:621-1334`: `unpack77_fields`, `unpack28`,
`unpack_type1`, `unpack_telemetry:1157`, `unpack_nonstandard:1181`).
The packing direction (for test-signal synthesis and a TX path) mirrors
the same layout.

Hashed calls: the reference leaves its hash table unimplemented (its
`save_hash_call`/`hash12` calls are commented out; an unknown 12-bit
hash renders as `<dddd>`).  t41x implements the real WSJT-X multiplier
hash (`ihashcall`) and a session `CallHashTable`, falling back to the
reference's `<dddd>` rendering only when the hash is unknown.

A copy of `t41x.decode.ft8.message`, so the port never imports JAX
(`tests/test_torch_host_copies.py` pins the two equal).
"""

from __future__ import annotations

import numpy as np

NTOKENS = 2_063_592
MAX22 = 4_194_304
MAXGRID4 = 32_400

_A1 = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
_A2 = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
_A3 = "0123456789"
_A4 = " ABCDEFGHIJKLMNOPQRSTUVWXYZ"
_FREE = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ+-./?"
_A38 = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ/"


def ihashcall(call: str, m: int) -> int:
    """WSJT-X multiplier hash of a callsign -> m-bit value (m in
    {10, 12, 22}).  The reference stubs this out (`hash12` comment
    `ft8.cpp:1218`); t41x implements it so hashed calls resolve."""
    c = call.strip().upper().ljust(11)[:11]
    n = 0
    for ch in c:
        n = n * 38 + (_A38.index(ch) if ch in _A38 else 0)
    return ((47055833459 * n) & ((1 << 64) - 1)) >> (64 - m)


class CallHashTable:
    """Session store mapping 10/12/22-bit hashes -> callsigns.

    Fed by every successfully unpacked standard call so later
    `<hashed>` references (type-4 messages) resolve to text, the way
    WSJT-X's `save_hash_call` does."""

    def __init__(self):
        self._by_bits: dict[int, dict[int, str]] = {10: {}, 12: {}, 22: {}}

    def save(self, call: str) -> None:
        call = call.strip().upper()
        if len(call) < 3 or call in ("DE", "QRZ", "CQ") \
                or call.startswith("<"):
            return
        base = call.split("/")[0] if call.count("/") else call
        for name in (call, base):
            for m in (10, 12, 22):
                self._by_bits[m][ihashcall(name, m)] = name

    def lookup(self, h: int, m: int) -> str | None:
        return self._by_bits[m].get(h)


def pack28(call: str) -> int:
    """Callsign -> 28-bit field."""
    call = call.strip().upper()
    if call == "DE":
        return 0
    if call == "QRZ":
        return 1
    if call == "CQ":
        return 2
    # standard callsign: pad into the 6-char template _ A D _ _ _
    c = call
    if len(c) >= 2 and c[1].isdigit():  # e.g. K1ABC -> " K1ABC"
        c = " " + c
    c = c.ljust(6)
    if len(c) != 6:
        raise ValueError(f"cannot pack callsign {call!r}")
    n = _A1.index(c[0])
    n = n * 36 + _A2.index(c[1])
    n = n * 10 + _A3.index(c[2])
    n = n * 27 + _A4.index(c[3])
    n = n * 27 + _A4.index(c[4])
    n = n * 27 + _A4.index(c[5])
    return NTOKENS + MAX22 + n


def unpack28(n28: int, hashes: CallHashTable | None = None) -> str:
    """28-bit field -> callsign text (reference `unpack28`,
    `ft8.cpp:965-1046`); 22-bit hashes resolve via `hashes` when
    known."""
    if n28 < NTOKENS:
        if n28 == 0:
            return "DE"
        if n28 == 1:
            return "QRZ"
        if n28 == 2:
            return "CQ"
        if n28 <= 1002:
            return f"CQ {n28 - 3:03d}"
        if n28 <= 532443:
            n = n28 - 1003
            s = ""
            for _ in range(4):
                s = _A4[n % 27] + s
                n //= 27
            return "CQ " + s.strip()
        return "<?>"
    n28 -= NTOKENS
    if n28 < MAX22:
        known = hashes.lookup(n28, 22) if hashes is not None else None
        return f"<{known}>" if known else f"<{n28:07d}>"
    n = n28 - MAX22
    c = [""] * 6
    c[5] = _A4[n % 27]; n //= 27
    c[4] = _A4[n % 27]; n //= 27
    c[3] = _A4[n % 27]; n //= 27
    c[2] = _A3[n % 10]; n //= 10
    c[1] = _A2[n % 36]; n //= 36
    c[0] = _A1[n % 37]
    return "".join(c).strip()


def pack_grid(grid: str) -> tuple[int, int]:
    """Grid/report/RRR/73 -> (igrid4, ir)."""
    g = grid.strip().upper()
    ir = 0
    if g.startswith("R ") or (g.startswith("R") and g[1:2] in "+-"):
        ir = 1
        g = g[1:].strip()
    if g == "":
        return MAXGRID4 + 1, ir
    if g == "RRR":
        return MAXGRID4 + 2, ir
    if g == "RR73":
        return MAXGRID4 + 3, ir
    if g == "73":
        return MAXGRID4 + 4, ir
    if len(g) == 4 and g[0].isalpha() and g[1].isalpha() \
            and g[2].isdigit() and g[3].isdigit():
        n = ((ord(g[0]) - 65) * 18 + (ord(g[1]) - 65)) * 100 \
            + int(g[2]) * 10 + int(g[3])
        return n, ir
    if g[0] in "+-":  # signal report -30..+32
        return MAXGRID4 + 35 + int(g), ir
    raise ValueError(f"cannot pack grid/report {grid!r}")


def unpack_grid(igrid4: int, ir: int) -> str:
    if igrid4 <= MAXGRID4:
        n = igrid4
        g = "{}{}{}{}".format(chr(65 + n // 1800), chr(65 + (n // 100) % 18),
                              (n // 10) % 10, n % 10)
        return ("R " + g) if ir else g
    irpt = igrid4 - MAXGRID4
    if irpt == 1:
        return ""
    if irpt == 2:
        return "RRR"
    if irpt == 3:
        return "RR73"
    if irpt == 4:
        return "73"
    rpt = irpt - 35
    s = f"{rpt:+03d}"
    return ("R" + s) if ir else s


def _bits_of(value: int, width: int) -> list[int]:
    return [(value >> (width - 1 - i)) & 1 for i in range(width)]


def pack77(message: str) -> np.ndarray:
    """Message text -> 77 payload bits (type 1 standard; type 4
    nonstandard/hashed calls; type 0.5 telemetry for a full 18-hex-digit
    token; type 0.0 free text for anything else)."""
    msg = message.strip().upper()
    parts = msg.split()
    if len(parts) == 1 and len(parts[0]) == 18 and parts[0][0] in "01234567" \
            and all(ch in "0123456789ABCDEF" for ch in parts[0]):
        return pack_telemetry(parts[0])
    try:
        if len(parts) == 4 and parts[2] == "R":
            f1, f2, f3 = parts[0], parts[1], "R " + parts[3]
        elif len(parts) == 3:
            f1, f2, f3 = parts
        elif len(parts) == 2 and parts[0] == "CQ":
            f1, f2, f3 = parts[0], parts[1], ""
        else:
            raise ValueError
        n28a, n28b = pack28(f1), pack28(f2)
        igrid4, ir = pack_grid(f3)
        bits = (_bits_of(n28a, 28) + [0] + _bits_of(n28b, 28) + [0]
                + [ir] + _bits_of(igrid4, 15) + _bits_of(1, 3))
        return np.asarray(bits, np.uint8)
    except (ValueError, KeyError):
        pass
    try:
        return pack_nonstandard(msg)
    except ValueError:
        return pack_free_text(message)


def _pack58(call: str) -> int:
    """Nonstandard call (≤11 chars, base-38 alphabet) -> 58 bits."""
    c = call.strip().upper()
    if not 3 <= len(c) <= 11 or any(ch not in _A38 for ch in c):
        raise ValueError(f"cannot pack nonstandard call {call!r}")
    n = 0
    for ch in c.rjust(11):
        n = n * 38 + _A38.index(ch)
    return n


def pack_nonstandard(message: str) -> np.ndarray:
    """Type 4: `CQ PJ4/KA1ABC`, `<W9XYZ> PJ4/KA1ABC RR73`, or
    `PJ4/KA1ABC <W9XYZ> 73` (reference layout `ft8.cpp:1181-1244`:
    n12|n58|iflip|nrpt|icq)."""
    parts = message.strip().upper().split()
    nrpt = 0
    if parts and parts[-1] in ("RRR", "RR73", "73"):
        nrpt = {"RRR": 1, "RR73": 2, "73": 3}[parts[-1]]
        parts = parts[:-1]
    if len(parts) != 2:
        raise ValueError(f"cannot pack type-4 message {message!r}")
    a, b = parts
    if a == "CQ" and nrpt == 0:
        icq, iflip = 1, 0
        n12, n58 = ihashcall(b, 12), _pack58(b)
    elif a.startswith("<") and a.endswith(">"):
        icq, iflip = 0, 0
        n12, n58 = ihashcall(a[1:-1], 12), _pack58(b)
    elif b.startswith("<") and b.endswith(">"):
        icq, iflip = 0, 1
        n12, n58 = ihashcall(b[1:-1], 12), _pack58(a)
    else:
        raise ValueError(f"cannot pack type-4 message {message!r}")
    bits = (_bits_of(n12, 12) + _bits_of(n58, 58) + [iflip]
            + _bits_of(nrpt, 2) + [icq] + _bits_of(4, 3))
    return np.asarray(bits, np.uint8)


def pack_telemetry(hexstr: str) -> np.ndarray:
    """Type 0.5: up to 18 hex digits (≤71 bits) -> payload."""
    n = int(hexstr, 16)
    if n >= (1 << 71):
        raise ValueError("telemetry exceeds 71 bits")
    bits = _bits_of(n, 71) + _bits_of(5, 3) + _bits_of(0, 3)
    return np.asarray(bits, np.uint8)


def pack_free_text(message: str) -> np.ndarray:
    """Type 0.0 free text: 13 chars base-42 into 71 bits."""
    text = message.strip().upper()[:13].rjust(13)
    n = 0
    for ch in text:
        n = n * 42 + _FREE.index(ch if ch in _FREE else " ")
    bits = _bits_of(n, 71) + [0, 0, 0] + [0, 0, 0]
    return np.asarray(bits, np.uint8)


def unpack77(bits: np.ndarray, hashes: CallHashTable | None = None) -> str:
    """77 payload bits -> message text (types 1, 2, 4, 0.0, 0.5).

    `hashes` (optional) resolves `<hashed>` calls and is fed every
    standard call seen, mirroring WSJT-X's session hash table."""
    bits = np.asarray(bits).astype(int)

    def field(start, width):
        v = 0
        for b in bits[start: start + width]:
            v = (v << 1) | int(b)
        return v

    i3 = field(74, 3)
    n3 = field(71, 3)
    if i3 in (1, 2):
        n28a, ipa = field(0, 28), field(28, 1)
        n28b, ipb = field(29, 28), field(57, 1)
        ir = field(58, 1)
        igrid4 = field(59, 15)
        f1 = unpack28(n28a, hashes)
        f2 = unpack28(n28b, hashes)
        if ipa and f1 not in ("DE", "QRZ", "CQ"):
            f1 += "/R" if i3 == 1 else "/P"
        if ipb and f2 not in ("DE", "QRZ", "CQ"):
            f2 += "/R" if i3 == 1 else "/P"
        if hashes is not None:
            hashes.save(f1)
            hashes.save(f2)
        f3 = unpack_grid(igrid4, ir)
        return " ".join(x for x in (f1, f2, f3) if x)
    if i3 == 0 and n3 == 0:
        n = field(0, 71)
        chars = []
        for _ in range(13):
            chars.append(_FREE[n % 42])
            n //= 42
        return "".join(reversed(chars)).strip()
    if i3 == 0 and n3 == 5:
        # telemetry: 71 bits as 18 hex digits (ft8.cpp:1157-1179)
        return f"{field(0, 71):018X}"
    if i3 == 4:
        # nonstandard calls (ft8.cpp:1181-1244)
        n12 = field(0, 12)
        n58 = field(12, 58)
        iflip = field(70, 1)
        nrpt = field(71, 2)
        icq = field(73, 1)
        c11 = ""
        n = n58
        for _ in range(11):
            c11 = _A38[n % 38] + c11
            n //= 38
        c11 = c11.strip()
        known = hashes.lookup(n12, 12) if hashes is not None else None
        hashed = f"<{known}>" if known else f"<{n12:04d}>"
        if hashes is not None:
            hashes.save(c11)
        call_1, call_2 = (c11, hashed) if iflip else (hashed, c11)
        if icq:
            return f"CQ {c11}"
        f3 = {0: "", 1: "RRR", 2: "RR73", 3: "73"}[nrpt]
        return " ".join(x for x in (call_1, call_2, f3) if x)
    return f"<unsupported i3={i3}>"
