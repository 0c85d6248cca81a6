"""FT8 15-second slot scheduler (host side).

Re-expression of the reference's FT8 timing machinery (tmr4/T41_SDR
`auto_sync_FT8` `ft8.cpp:126-145`, `update_synchronization:154-167`,
decode driving `Process.cpp:627-685`): FT8 transmissions start on UTC
seconds divisible by 15; the receiver aligns its 12.64 s capture window
to those boundaries, accumulates audio, and decodes at window end.

`SlotManager` consumes demodulated audio blocks (any block size) with an
injectable clock, so tests can drive synthetic time and a live runner
can pass wall-clock UTC.

A copy of `t41x.decode.ft8.slots`, so the port never imports JAX
(`tests/test_torch_host_copies.py` pins the two equal).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from t41x_torch import constants as C

SLOT_SECONDS = 15.0
CAPTURE_SECONDS = 13.5  # leave margin for decode before the next slot


class SlotManager:
    def __init__(self, decode_fn: Callable[[np.ndarray], list] | None = None,
                 rate: float = C.AUDIO_RATE,
                 clock: Callable[[], float] | None = None,
                 my_grid: str | None = None):
        """decode_fn: called with each completed slot's audio.
        clock: returns seconds (UTC-like); defaults to sample counting
        (assume feed() is called in real time from stream start).
        my_grid: station locator — decodes carry distance_km and the
        session's call-hash table persists across slots (the reference
        keeps both for the duration of FT8 mode, ft8.cpp:798-874)."""
        if decode_fn is None:
            from t41x_torch.decode.ft8 import decode as ft8_decode, message

            hashes = message.CallHashTable()
            decode_fn = lambda a: ft8_decode.decode_audio(  # noqa: E731
                a, hashes=hashes, my_grid=my_grid)
        self.decode_fn = decode_fn
        self.rate = rate
        self.clock = clock
        self.samples_fed = 0
        self.synced = False
        self.buffer: list[np.ndarray] = []
        self.buffered = 0
        self.results: list = []
        self.slots_decoded = 0

    def _now(self) -> float:
        if self.clock is not None:
            return self.clock()
        return self.samples_fed / self.rate

    def feed(self, audio: np.ndarray) -> list:
        """Feed an audio block; returns decodes completed by this call."""
        audio = np.asarray(audio, np.float32).ravel()
        new = []
        t = self._now()
        self.samples_fed += len(audio)
        if not self.synced:
            # wait for a slot boundary (reference: RTC second % 15 == 0)
            phase = t % SLOT_SECONDS
            next_boundary = (SLOT_SECONDS - phase) % SLOT_SECONDS
            samples_to_skip = int(next_boundary * self.rate)
            if len(audio) > samples_to_skip:
                self.synced = True
                audio = audio[samples_to_skip:]
            else:
                return new
        self.buffer.append(audio)
        self.buffered += len(audio)
        cap = int(CAPTURE_SECONDS * self.rate)
        slot_len = int(SLOT_SECONDS * self.rate)
        if self.buffered >= slot_len:
            all_audio = np.concatenate(self.buffer)
            slot_audio = all_audio[:cap]
            remainder = all_audio[slot_len:]
            self.buffer = [remainder] if len(remainder) else []
            self.buffered = len(remainder)
            decoded = self.decode_fn(slot_audio)
            self.results.extend(decoded)
            self.slots_decoded += 1
            new.extend(decoded)
        return new
