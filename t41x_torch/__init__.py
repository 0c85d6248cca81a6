"""t41x_torch — the t41x software-defined-radio framework in PyTorch.

A port of `t41x` (JAX/Pallas on a TPU) to PyTorch and hand-written CUDA
kernels for one NVIDIA H100.  Each module sits at the same relative path
as its `t41x` twin and keeps its inputs, outputs and carried-state
layout, so the two are held equal on the same input
(`tests/test_torch_*.py`).  The package imports torch and NumPy, never
JAX: the design-time code (`constants`, `utils.windows`,
`dsp.firdesign`, the operator constructors in `dsp.iir` / `dsp.osfilter`
/ `dsp.chunk_ops`, the EQ, CW and zoom designs) is a copy pinned equal
to `t41x`'s.

    t41x_torch.Radio, t41x_torch.RadioConfig — the user-facing radio
                                           (lazy exports, as `t41x`'s)
    t41x_torch.RxChain, t41x_torch.ChainSpec — the receive chain
    t41x_torch.runner.StreamRunner       — the live loop (one CUDA graph
                                           a chain spec on the card)
    python -m t41x_torch.cli             — the command line
    t41x_torch.kernels.*                 — the CUDA kernels and their
                                           plain PyTorch versions
    t41x_torch.mesh.*                    — the channelizer, channel and
                                           time sharding, and
                                           torch.distributed
    python -m t41x_torch.tools.*         — multihost_bench, livebench

The JAX-free host modules of `t41x` (config, wav, signals, the native
runtime's bindings, ...) are copies pinned to their originals
(`tests/test_torch_host_copies.py`).
"""

import torch

from t41x_torch import constants
from t41x_torch.version import __version__

# Full fp32 on the audio path: a TF32 product keeps ~3 decimal digits,
# and reduced matmul precision cost the TPU chain 48.9 dB of audio
# parity against a 55 dB budget.  cuDNN convolutions (the plain FIR
# stages) default to TF32 on the card, so both switches are pinned.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["constants", "__version__", "Radio", "RadioConfig",
           "RxChain", "ChainSpec"]


def __getattr__(name):
    if name == "Radio":
        from t41x_torch.radio import Radio
        return Radio
    if name == "RadioConfig":
        from t41x_torch.config import RadioConfig
        return RadioConfig
    if name in ("RxChain", "ChainSpec"):
        from t41x_torch import chain
        return getattr(chain, name)
    raise AttributeError(name)
