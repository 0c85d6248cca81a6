"""The frozen reference against the port's plain chain, on the CPU.

At a tiny size both configurations' reference (float64) and the port's
chain (`use_kernels` on CPU tensors runs its plain torch versions,
float32) stream the same seeded blocks; every compared output and the
carried state must agree to float32 rounding.  Run from the repository
root: `python -m pytest sdrbench/tests -q`.
"""

import pytest
import torch

from sdrbench import check, spec, traffic
from sdrbench.program import Program
from sdrbench.references.ssb_chain import Reference

# float32 rounding carried through the chain, relative to the weakest
# channel's level: the readings at this size are ~1e-4 (audio) and
# ~1e-4 dB (panadapter); one precision step lower reads ~1e-3 or more
TOL = {"rel": 2e-3, "display_db": 1e-2}
STATE_TOL = 2e-3


@pytest.mark.parametrize("config", ["ssb_pan", "ssb_headless"])
def test_reference_equals_plain_chain(config):
    cell = spec.Cell(f"{config}.bulk4k")
    channels, blocks = 5, 3
    i16, q16, params = traffic.make(cell.traffic["signal"], channels, blocks,
                                    seed=2**31 + 77, device="cpu")
    prog = Program(cell.config["chain"], channels, params, "cpu")
    d = prog.dispatch([(i16[b], q16[b]) for b in range(blocks)])
    d.replay()
    ref = Reference(cell.config["chain"], "cpu")
    st, outs = ref.init_state(channels), []
    for b in range(blocks):
        st, o = ref.block(params, st, i16[b], q16[b])
        outs.append(o)
    compare = cell.config["compare"]
    for row in check.outputs(compare, d.out, outs):
        for name, value in row.items():
            assert value <= TOL[compare[name]], (name, value)
    s = check.state(prog.state_leaves(), st, ref.DECISIONS, ref.COMPLEX,
                    ref.ANGLES)
    assert s["state"] <= STATE_TOL, s
    got = prog.state_leaves()
    for k in ("agc.state", "agc.decay_type", "agc.hang_counter"):
        assert torch.equal(got[k].long(), st[k]), k   # no tie at this size


def test_reference_follows_from_a_handed_over_state():
    """The reference continued from the program's carried state (the
    check's last dispatch) equals the program's next block."""
    cell = spec.Cell("ssb_pan.bulk4k")
    i16, q16, params = traffic.make(cell.traffic["signal"], 4, 2, 5, "cpu")
    prog = Program(cell.config["chain"], 4, params, "cpu")
    d0 = prog.dispatch([(i16[0], q16[0])])
    d1 = prog.dispatch([(i16[1], q16[1])])
    d0.replay()
    snap = {k: v.clone() for k, v in prog.state_leaves().items()}
    d1.replay()
    ref = Reference(cell.config["chain"], "cpu")
    st, o = ref.block(params, ref.state_from(snap), i16[1], q16[1])
    for name, value in check.outputs(cell.config["compare"], d1.out,
                                     [o])[0].items():
        assert value <= TOL[cell.config["compare"][name]], (name, value)
    assert check.state(prog.state_leaves(), st, ref.DECISIONS,
                       ref.COMPLEX, ref.ANGLES)["state"] <= STATE_TOL


def test_reference_refuses_what_it_does_not_compute():
    with pytest.raises(ValueError):
        Reference({"mode": "usb", "nr_mode": 2}, "cpu")
    with pytest.raises(ValueError):
        Reference({"mode": "usb", "spectrum_zoom": 2}, "cpu")


def test_traffic_is_the_seeds():
    sig = spec.Cell("ssb_pan.bulk4k").traffic["signal"]
    a = traffic.make(sig, 3, 2, 2**31 + 5, "cpu")
    b = traffic.make(sig, 3, 2, 2**31 + 5, "cpu")
    c = traffic.make(sig, 3, 2, 2**31 + 6, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == c[0].shape == (2, 3, 2048)
    assert a[0].dtype == torch.int16
