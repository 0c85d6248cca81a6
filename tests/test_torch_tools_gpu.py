"""The port's measurement tools on the card: `t41x_torch.tools.bench`'s
graphed dispatch against its eager loop, and a short `stagebench` run.

Every case needs a CUDA card and skips without one; the file imports
nothing of `t41x` or JAX, so the card's machine runs it as

    python -m pytest --noconftest -m gpu tests/test_torch_tools_gpu.py
"""

import pytest
import torch

from t41x_torch.chain import ChainSpec
from t41x_torch.runner import _clone
from t41x_torch.tools import bench, stagebench

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n_ch", [7, 1024])
@pytest.mark.parametrize("config", ["rx", "tx", "channelizer"])
def test_graphed_checksum_equals_eager(cuda, config, n_ch):
    """One replay of the captured dispatch gives the eager loop's
    checksum bit for bit, and so does the next one, which continues from
    the state the first wrote back (the channelizer at K = n_ch for 7
    channels, one wideband capture)."""
    spec = None if config == "tx" else ChainSpec(
        spectrum_taps=True, use_matmul_osfilter=True, use_kernels=True,
        interpolate_out=True, **bench.cfg_map()[config])
    k = 7 if n_ch == 7 else 16
    fn, params, state, blocks = bench.build(config, spec, n_ch, 4, cuda, k)
    st = _clone(state)
    d, e1, equal = bench.checked_dispatch(fn, params, state, blocks)
    assert d.graphed and equal is True
    st, e_1 = fn(params, st, blocks)
    _, e_2 = fn(params, st, blocks)
    assert e1 == e_1.item()
    d.replay()
    assert torch.equal(d.acc, e_2), (d.acc.item(), e_2.item())


def test_stagebench_four_variants(cuda, capsys):
    names = ["full", "pallas", "pallas_nospec", "pallas_nr_kim_batch"]
    rows = stagebench.main(["--channels", "64", "--blocks", "2",
                            "--min-ms", "5", "--variants", ",".join(names)])
    out = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in out] == names
    assert all("failed" not in r and r["graphed"] and r["us_per_block"] > 0
               for r in rows.values()), rows
