"""Demodulators (torch): AM, synchronous AM, narrow-band FM."""

from t41x_torch.demod.nfm import nfm_demod, nfm_state  # noqa: F401
