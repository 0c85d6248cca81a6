"""Build and load the port's CUDA kernels.

Every `t41x_torch/csrc/*.cu` is compiled by `nvcc` for Hopper
(`sm_90a`), one process a source, all at once, and linked into one
shared library with a plain C interface, loaded with `ctypes`.  The
build runs at the first CUDA use, never at import (the CPU tests
import every module on machines without `nvcc`), and
lands in `t41x_torch/build/` under a name keyed by the sources and the
flags, so a changed source rebuilds.  No `--use_fast_math`: the NCO
`sincosf` and the AGC `log10f` need full accuracy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from t41x_torch.utils.tracing import setup_span

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "-Xcompiler", "-fPIC"]

_lib = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the t41x_torch CUDA kernels")
    return found


def build(sources: list, name: str, verbose: bool = False) -> Path:
    """Compile `sources` (.cu paths) and link them into
    `BUILD_DIR/{name}_{key}.so`, keyed by the sources and the flags; an
    existing one is reused.  Returns its path."""
    key = hashlib.sha256()
    for f in sources:
        key.update(f.name.encode())
        key.update(f.read_bytes())
    key.update(" ".join(FLAGS).encode())
    out = BUILD_DIR / f"{name}_{key.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    # one nvcc a source, all at once, then one link
    objs = [tmp.with_suffix(f".{f.stem}.o") for f in sources]
    procs = [subprocess.Popen(
        [_nvcc(), *FLAGS, "-c", *(["-Xptxas", "-v"] if verbose else []),
         "-o", str(o), str(f)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for f, o in zip(sources, objs)]
    logs = [(p, p.communicate()[0]) for p in procs]
    res = subprocess.run([_nvcc(), *FLAGS, "-shared", "-o", str(tmp),
                          *map(str, objs)], capture_output=True, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [log for p, log in logs if p.returncode != 0]
    if failed or res.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed)
                           + f"\n{res.stdout}\n{res.stderr}")
    if verbose:
        print("".join(log for _, log in logs))
    os.replace(tmp, out)
    return out


def library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built on first call.  `verbose` adds
    `-Xptxas -v` to a fresh build and prints what the compiler says
    (registers, shared memory, spills per kernel).  The build or load is
    the set-up span `kernel_load` (`t41x_torch.utils.tracing`)."""
    global _lib
    if _lib is not None:
        return _lib
    with setup_span("kernel_load"):
        out = build(sorted(SRC_DIR.glob("*.cu")), "libt41x_kernels",
                    verbose)
        _lib = ctypes.CDLL(str(out))
    return _lib


# argument types of the C entry points: every pointer and the stream
# as c_void_p (a bare Python int would be passed as a 32-bit int)
PTR, INT, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def launch(name: str, argtypes: list, device, *args) -> None:
    """Call the C entry point `name`, which launches its kernel on the
    stream it is given and returns `cudaGetLastError()`, on `device`:
    inside `torch.cuda.device(device)`, with `device`'s current stream
    appended to `args`.  A tensor in `args` passes as its data pointer
    and must lie on `device`: CUDA launches only into a stream of the
    current card, so a kernel for a tensor on `cuda:1` runs there, not
    on whichever card is current.  Raise if the entry point does not
    return 0 (a refused launch never runs, and a later synchronize
    would not report it)."""
    import torch
    ptrs = []
    for a in args:
        if isinstance(a, torch.Tensor):
            if a.device != device:
                raise ValueError(f"{name}: a tensor on {a.device}, the "
                                 f"launch is on {device}")
            a = a.data_ptr()
        ptrs.append(a)
    fn = getattr(library(), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        rc = fn(*ptrs, stream_of(device))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_of(device) -> int:
    """The current CUDA stream of `device`, as an int."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def cuda_input(name: str, t, dtype, shape: tuple, device):
    """`t` as the kernel takes it: raise unless it is a `dtype` tensor of
    `shape` on `device`; a strided view (a slice of a carried history,
    the real part of a complex block) is copied to a contiguous one."""
    if t.device != device or t.dtype != dtype or \
            tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected a {dtype} tensor of shape {tuple(shape)} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def aligned(t, nbytes: int = 16):
    """`t`, or a copy of it where its data do not start on an `nbytes`
    boundary (a contiguous view at an odd offset): for a kernel that
    reads it as 16-byte vectors."""
    return t.clone() if t.data_ptr() % nbytes else t


def stamp_buffer(channels: int, per_block: int, rows: int, device):
    """A zeroed (blocks, rows) int64 buffer for a kernel's `clock64`
    stamps: one row a thread block of `per_block` channels."""
    import torch
    blocks = -(-channels // per_block)
    return torch.zeros(blocks, rows, dtype=torch.int64, device=device)


def phase_split(stamps, names) -> dict:
    """Mean µs a block spends in each phase, from the stamps of a phases
    launch; the SM clock (cycles a ns) from the blocks' total cycles over
    their nanoseconds.  Also the block's mean µs and that clock."""
    import torch
    s = stamps.to(torch.float64).cpu()
    ghz = float(s[:, -2].sum() / s[:, -1].sum())
    out = {nm: float(s[:, i].mean()) / ghz / 1e3
           for i, nm in enumerate(names)}
    out["block"] = float(s[:, -1].mean()) / 1e3
    out["sm_ghz"] = ghz
    return out
