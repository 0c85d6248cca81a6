"""ctypes bindings for the native runtime (native/t41x_runtime.cpp).

Provides the host-side streaming layer — lock-free block rings, paced
capture streamers, load metering, and a fast WAV reader — the native
equivalent of the reference firmware's audio-library queues and
interrupt-driven pacing (SURVEY.md §2.4).  Builds the shared library on
first use if the toolchain is present; every entry point has a
pure-Python fallback so the package works without a compiler.

A copy of `t41x.io.runtime`, so the port never imports JAX
(`tests/test_torch_host_copies.py` pins the two equal).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time

import numpy as np

from t41x_torch import constants as C

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libt41x_runtime.so"))
_lib = None
_lib_tried = False


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR)],
                           check=True, capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.t41x_ring_create.restype = ctypes.c_void_p
    lib.t41x_ring_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
    lib.t41x_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.t41x_ring_available.restype = ctypes.c_size_t
    lib.t41x_ring_available.argtypes = [ctypes.c_void_p]
    lib.t41x_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.t41x_ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.t41x_ring_overruns.restype = ctypes.c_uint64
    lib.t41x_ring_overruns.argtypes = [ctypes.c_void_p]
    lib.t41x_streamer_create.restype = ctypes.c_void_p
    lib.t41x_streamer_create.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.c_double, ctypes.c_double]
    lib.t41x_streamer_running.argtypes = [ctypes.c_void_p]
    lib.t41x_streamer_blocks_sent.restype = ctypes.c_uint64
    lib.t41x_streamer_blocks_sent.argtypes = [ctypes.c_void_p]
    lib.t41x_streamer_destroy.argtypes = [ctypes.c_void_p]
    lib.t41x_load_create.restype = ctypes.c_void_p
    lib.t41x_load_create.argtypes = [ctypes.c_double]
    lib.t41x_load_begin.argtypes = [ctypes.c_void_p]
    lib.t41x_load_end.argtypes = [ctypes.c_void_p]
    lib.t41x_load_percent.restype = ctypes.c_double
    lib.t41x_load_percent.argtypes = [ctypes.c_void_p]
    lib.t41x_load_destroy.argtypes = [ctypes.c_void_p]
    lib.t41x_wav_read.restype = ctypes.POINTER(ctypes.c_float)
    lib.t41x_wav_read.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint64)]
    lib.t41x_wav_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


class BlockRing:
    """SPSC ring of fixed-size float blocks (complex I/Q interleaved)."""

    def __init__(self, block_floats: int = 2 * C.BLOCK_SIZE,
                 capacity: int = 64):
        self.block_floats = block_floats
        self.capacity = capacity
        lib = _load()
        if lib:
            self._h = lib.t41x_ring_create(block_floats, capacity)
            self._lib = lib
        else:
            self._h = None
            self._q: list[np.ndarray] = []
            self._lock = threading.Lock()
            self._overruns = 0

    def available(self) -> int:
        if self._h:
            return int(self._lib.t41x_ring_available(self._h))
        with self._lock:
            return len(self._q)

    def push(self, block: np.ndarray) -> bool:
        block = np.ascontiguousarray(block, np.float32)
        assert block.size == self.block_floats
        if self._h:
            return bool(self._lib.t41x_ring_push(
                self._h, block.ctypes.data_as(ctypes.c_void_p)))
        with self._lock:
            if len(self._q) >= self.capacity - 2:
                self._q.clear()
                self._overruns += 1
            self._q.append(block.copy())
        return True

    def pop(self) -> np.ndarray | None:
        if self._h:
            out = np.empty(self.block_floats, np.float32)
            if self._lib.t41x_ring_pop(
                    self._h, out.ctypes.data_as(ctypes.c_void_p)):
                return out
            return None
        with self._lock:
            return self._q.pop(0) if self._q else None

    def pop_iq(self) -> np.ndarray | None:
        b = self.pop()
        if b is None:
            return None
        return b.view(np.complex64)

    @property
    def overruns(self) -> int:
        if self._h:
            return int(self._lib.t41x_ring_overruns(self._h))
        return self._overruns

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.t41x_ring_destroy(self._h)
            self._h = None


class CaptureStreamer:
    """Feeds an I/Q capture into a ring at (a multiple of) real time —
    the acquisition-interrupt analog.  rate_factor=0 streams flat out."""

    def __init__(self, ring: BlockRing, iq: np.ndarray,
                 rate_factor: float = 1.0,
                 block_seconds: float = C.BLOCK_SECONDS):
        flat = np.ascontiguousarray(iq, np.complex64).view(np.float32)
        self._ring = ring
        lib = _load()
        if lib and ring._h:
            self._lib = lib
            self._h = lib.t41x_streamer_create(
                ring._h, flat.ctypes.data_as(ctypes.c_void_p), flat.size,
                ring.block_floats, block_seconds, rate_factor)
        else:
            self._h = None
            self._running = True
            self._sent = 0

            def run():
                nb = flat.size // ring.block_floats
                nxt = time.monotonic()
                for i in range(nb):
                    if not self._running:
                        break
                    if rate_factor > 0:
                        nxt += block_seconds / rate_factor
                        dt = nxt - time.monotonic()
                        if dt > 0:
                            time.sleep(dt)
                    ring.push(flat[i * ring.block_floats:
                                   (i + 1) * ring.block_floats])
                    self._sent += 1
                self._running = False

            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()

    @property
    def running(self) -> bool:
        if self._h:
            return bool(self._lib.t41x_streamer_running(self._h))
        return self._running

    @property
    def blocks_sent(self) -> int:
        if self._h:
            return int(self._lib.t41x_streamer_blocks_sent(self._h))
        return self._sent

    def stop(self) -> None:
        if self._h:
            self._lib.t41x_streamer_destroy(self._h)
            self._h = None
        else:
            self._running = False


class LoadMeter:
    """Processor-load % — mean block time over the real-time budget.

    force_python: skip the native meter (needed for multi-block
    accounting, `end(n_blocks=...)`, which the native API has no
    weighted form for)."""

    def __init__(self, budget_s: float = C.BLOCK_SECONDS,
                 force_python: bool = False):
        lib = None if force_python else _load()
        if lib:
            self._lib = lib
            self._h = lib.t41x_load_create(budget_s)
        else:
            self._h = None
            self._budget = budget_s
            self._sum = 0.0
            self._n = 0
            self._t0 = 0.0

    def begin(self):
        if self._h:
            self._lib.t41x_load_begin(self._h)
        else:
            self._t0 = time.perf_counter()

    def end(self, n_blocks: int = 1):
        """Finish a measurement covering n_blocks real-time budgets (a
        batched dispatch amortizes one launch over several blocks)."""
        if self._h:
            assert n_blocks == 1, "native meter is per-block"
            self._lib.t41x_load_end(self._h)
        else:
            self._sum += time.perf_counter() - self._t0
            self._n += n_blocks

    @property
    def percent(self) -> float:
        if self._h:
            return float(self._lib.t41x_load_percent(self._h))
        return 100.0 * (self._sum / max(self._n, 1)) / self._budget

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.t41x_load_destroy(self._h)
            self._h = None


def read_wav_native(path: str):
    """Fast WAV read via the native parser; falls back to t41x_torch.io.wav."""
    lib = _load()
    if lib:
        rate = ctypes.c_uint32()
        nch = ctypes.c_uint32()
        frames = ctypes.c_uint64()
        ptr = lib.t41x_wav_read(path.encode(), ctypes.byref(rate),
                                ctypes.byref(nch), ctypes.byref(frames))
        if ptr:
            n = frames.value * nch.value
            data = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
            lib.t41x_wav_free(ptr)
            if nch.value > 1:
                data = data.reshape(-1, nch.value)
            return data, int(rate.value)
    from t41x_torch.io import wav

    return wav.read_wav(path)
