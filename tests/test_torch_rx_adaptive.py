"""The port's receive chain in its adaptive specs against t41x's: the
SAM PLL, LMS NR and the automatic notch feed rounding back into their
own state, so their trajectories drift apart between any two arithmetic
orders.  They are held by the steady-state audio PSD over the last 2 of
12 blocks (<= 3 dB, the bound of tools/chipcheck.py), and SAM's carrier
estimate within 0.1 Hz; kernels (plain versions on the CPU) against
t41x's Pallas path in interpret mode, and plain against plain.
"""

import numpy as np
import pytest
import torch

from t41x_torch.utils import parity
from tests.test_torch_rx_modes import ADAPTIVE, _iq, _pair, _stream

torch.set_num_threads(1)

ADAPTIVE_BLOCKS = 12


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("spec", sorted(ADAPTIVE))
def test_adaptive_modes_match_t41x_in_steady_state(spec, kernels):
    ch = 3
    kw = ADAPTIVE[spec]
    jc, tc = _pair(kw, kernels)
    blocks = _iq(ch, ADAPTIVE_BLOCKS, am=spec == "sam")
    _, _, jo, to = _stream(jc, tc, blocks, ch)
    for k in ("audio", "audio_24k"):
        ref = np.stack([o[k] for o in jo])
        got = np.stack([o[k] for o in to])
        assert np.isfinite(got).all(), k
        assert parity.psd_err_db(ref, got) <= parity.PSD_ERR_MAX_DB, k
    if spec == "sam":
        np.testing.assert_allclose(to[-1]["sam_carrier_hz"],
                                   jo[-1]["sam_carrier_hz"], rtol=0,
                                   atol=0.1)
