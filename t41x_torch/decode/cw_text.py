"""Adaptive Morse text decoder (host side).

Re-expression of the reference's histogram-adaptive CW decoder
(tmr4/T41_SDR `DoCWDecoding` `CWProcessing.cpp:546-639`,
`DoSignalHistogram:759-815`, `DoGapHistogram:655-699`,
`JackClusteredArrayMax:719-745`, char tree `:540`): a 6-state timing
machine fed by the per-block binary keying envelope, with adaptive
dit/dah clustering via signal-length histograms and a geometric-mean
threshold, walking a binary Morse tree to emit characters.

This is control-flow-heavy, branchy, sample-sparse work — host code by
design (SURVEY.md §7 phase 5); the dense tone detection runs on TPU
(t41x_torch.demod.cw).

A copy of `t41x.decode.cw_text`, so the port never imports JAX
(`tests/test_torch_host_copies.py` pins the two equal).
"""

from __future__ import annotations

import numpy as np

from t41x_torch import constants as C

HISTOGRAM_ELEMENTS = 750
LOWEST_ATOM_TIME = 20  # ms (60 WPM atom)
ADAPTIVE_SCALE_FACTOR = 0.8
SCALE_CONSTANT = 1.0 / (1.0 - ADAPTIVE_SCALE_FACTOR)
DECODER_BUFFER_SIZE = 128

# binary-tree character lookup (dit = +1, dah = +dash_jump/2^depth)
MORSE_TREE = ("-EISH5--4--V---3--UF--------?-2--ARL---------.--.WP------J---1"
              "--TNDB6--.--X/-----KC------Y------MGZ7----,Q------O-8------9"
              "--0----")


def _clustered_max(array: np.ndarray, elements: int, spread: int):
    """Cluster-aware argmax (reference `JackClusteredArrayMax`)."""
    best, best_idx = 0, -1
    elements = min(elements, len(array))
    for i in range(spread, elements - spread):
        t = int(array[i - spread: i + spread + 1].sum())
        if t >= best:
            best, best_idx = t, i
    # (the reference's >= comparison walks best_idx to the end on an
    # all-zero histogram; guard against that)
    if best_idx > 0 and best > 0:
        return int(array[best_idx]), best_idx
    return 0, 0


class MorseDecoder:
    """Streaming Morse decoder over a binary keying envelope.

    feed(keyed) consumes an array of per-block booleans (one per
    BLOCK_SECONDS ~ 10.67 ms) and returns newly decoded text.
    """

    def __init__(self, block_ms: float = C.BLOCK_SECONDS * 1000.0,
                 wpm_hint: float = 15.0):
        self.block_ms = block_ms
        self.time_ms = 0.0
        self.state = 0
        self.signal_start = 0.0
        self.signal_end = 0.0
        self.signal_elapsed = 0.0
        self.gap_length = 0.0
        self.char_in_progress = False
        self.blank_printed = False
        self.decoder_index = 0
        self.dash_jump = DECODER_BUFFER_SIZE
        self.text: list[str] = []
        # adaptive timing (ResetHistograms, CWProcessing.cpp:501-517)
        self.dit_length = 1200.0 / wpm_hint
        self.dah_length = 3 * self.dit_length
        self.ave_dit = self.dit_length
        self.ave_dah = self.dah_length
        self.threshold = np.sqrt(self.ave_dit * self.ave_dah)
        self.signal_hist = np.zeros(HISTOGRAM_ELEMENTS, np.int64)
        self.gap_hist = np.zeros(HISTOGRAM_ELEMENTS, np.int64)
        self.val_flag = 0
        self.val_ref1 = 0.0
        self.val_ref2 = 0.0
        self.gap_ref1 = 0.0
        self.signal_start_old = 0.0
        # histogram updates are throttled to every 5 s, like the
        # reference (CWProcessing.cpp:562, :592)
        self.hist_old_time = 0.0

    @property
    def wpm(self) -> float:
        return 1200.0 / max(self.dit_length, 1.0)

    # ------------------------------------------------------------------
    def _signal_histogram(self, val_ms: float) -> None:
        """DoSignalHistogram (CWProcessing.cpp:759-815)."""
        compare = 2.0
        if self.val_flag == 0:
            self.val_ref1 = self.signal_elapsed
            self.signal_start_old = self.time_ms
            self.val_flag = 1
        if self.time_ms - self.signal_start_old > LOWEST_ATOM_TIME \
                and self.val_flag == 1:
            self.gap_ref1 = self.gap_length
            self.val_ref2 = self.signal_elapsed
            self.val_flag = 0
        r1, r2, g1 = self.val_ref1, self.val_ref2, self.gap_ref1
        if ((r2 >= r1 * compare and g1 <= r1 * compare)
                or (r1 >= r2 * compare and g1 <= r2 * compare)):
            lo, hi = (r1, r2) if r2 >= r1 else (r2, r1)
            self.ave_dit = 0.9 * self.ave_dit + 0.1 * lo
            self.ave_dah = 0.9 * self.ave_dah + 0.1 * hi
        self.threshold = np.sqrt(max(self.ave_dit * self.ave_dah, 1.0))

        idx = int(min(max(val_ms, 0), HISTOGRAM_ELEMENTS - 1))
        self.signal_hist[idx] += 1
        offset = max(int(self.threshold) - 1, 4)
        _, dit_idx = _clustered_max(self.signal_hist, offset, 1)
        if dit_idx:
            self.dit_length = float(dit_idx)
        dah_cnt, dah_idx = _clustered_max(
            self.signal_hist[offset:], HISTOGRAM_ELEMENTS - offset, 3)
        if dah_idx:
            self.dah_length = float(dah_idx + offset)
        dit_cnt, _ = _clustered_max(self.signal_hist, offset, 1)
        if dit_cnt > SCALE_CONSTANT and dah_cnt > SCALE_CONSTANT:
            self.signal_hist = (ADAPTIVE_SCALE_FACTOR
                                * self.signal_hist).astype(np.int64)

    def _gap_histogram(self, gap_ms: float) -> None:
        """DoGapHistogram (simplified: dit-gap cluster only)."""
        idx = int(min(max(gap_ms, 0), HISTOGRAM_ELEMENTS - 1))
        if self.gap_hist[idx] > 10:
            self.gap_hist = (0.8 * self.gap_hist).astype(np.int64)
        self.gap_hist[idx] += 1

    # ------------------------------------------------------------------
    def _emit_char(self) -> None:
        if 0 <= self.decoder_index < len(MORSE_TREE):
            ch = MORSE_TREE[self.decoder_index]
            self.text.append(ch)
        self.decoder_index = 0
        self.dash_jump = DECODER_BUFFER_SIZE
        self.char_in_progress = False
        self.blank_printed = False

    def feed(self, keyed) -> str:
        """Consume per-block keying decisions; return new text."""
        start_len = len(self.text)
        for k in np.asarray(keyed).astype(bool).ravel():
            self.time_ms += self.block_ms
            self._step(bool(k))
        return "".join(self.text[start_len:])

    def _step(self, on: bool) -> None:
        if self.state == 0:
            if on:
                self.signal_start = self.time_ms
                self.gap_length = self.signal_start - self.signal_end
                if (LOWEST_ATOM_TIME < self.gap_length
                        < self.threshold * 3
                        and self.signal_start - self.hist_old_time > 5000.0):
                    self._gap_histogram(self.gap_length)
                    self.hist_old_time = self.signal_start
                self.state = 1
                return
            gap = self.time_ms - self.signal_end
            if gap > self.dit_length * 1.95 and self.char_in_progress:
                self.state = 5
            elif (gap > self.dit_length * 4.5 and not self.blank_printed
                  and not self.char_in_progress):
                self.state = 6
        elif self.state == 1:
            if not on:
                self.signal_elapsed = self.time_ms - self.signal_start
                if self.signal_elapsed < LOWEST_ATOM_TIME:
                    self.state = 0
                    return
                if (self.signal_elapsed < HISTOGRAM_ELEMENTS
                        and self.time_ms - self.hist_old_time > 5000.0):
                    self._signal_histogram(self.signal_elapsed)
                    self.hist_old_time = self.time_ms
                self.signal_end = self.time_ms
                self.state = 2
                self._step(on)  # state2 processes immediately
        elif self.state == 2:
            if self.signal_elapsed > 0.5 * self.dit_length:
                self.dash_jump >>= 1
                self.char_in_progress = True
                if self.signal_elapsed < self.threshold:
                    self.decoder_index += 1          # dit
                else:
                    self.decoder_index += self.dash_jump  # dah
            self.state = 0
        elif self.state == 5:
            self._emit_char()
            self.state = 0
        elif self.state == 6:
            self.text.append(" ")
            self.blank_printed = True
            self.state = 0


def decode_envelope(keyed, block_ms: float = C.BLOCK_SECONDS * 1000.0,
                    wpm_hint: float = 15.0) -> str:
    """One-shot: decode a full keying-envelope array to text."""
    dec = MorseDecoder(block_ms, wpm_hint)
    out = dec.feed(keyed)
    # flush a trailing character
    dec.feed(np.zeros(int(10 * dec.dah_length / block_ms), bool))
    return "".join(dec.text).strip()
