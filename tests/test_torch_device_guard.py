"""Every hand-written kernel launches on its tensors' card.

CUDA launches a kernel only into a stream of the current card, so a
launch for tensors on `cuda:1` has to make `cuda:1` current first.
`t41x_torch.kernels._build.launch` does that for every kernel: these
CPU tests drive it with a recorder in place of `torch.cuda.device` and
a fake library whose entry points record how they were called; check,
by reading the sources, that every launch site under
`t41x_torch/kernels/` hands it the device and its tensors (not bare
pointers); and check that `mesh.distributed.initialize` makes the
rank's card current before an NCCL process group binds to it.
"""

import ast
import contextlib
from pathlib import Path

import pytest
import torch

from t41x_torch.kernels import _build
from t41x_torch.mesh import distributed as dist

KERNELS = Path(__file__).resolve().parent.parent / "t41x_torch" / "kernels"


class _Recorder:
    """Stands in for `torch.cuda.device`: records the devices entered and
    which one is current."""

    def __init__(self):
        self.entered, self.current = [], []

    def __call__(self, device):
        @contextlib.contextmanager
        def guard():
            self.entered.append(device)
            self.current.append(device)
            try:
                yield
            finally:
                self.current.pop()
        return guard()


class _Entry:
    """A C entry point of the fake library: records its arguments and
    the card current when it was called; returns `rc`."""

    def __init__(self, recorder, calls, rc=0):
        self.argtypes, self.restype = None, None
        self.recorder, self.calls, self.rc = recorder, calls, rc

    def __call__(self, *args):
        self.calls.append((args, list(self.recorder.current)))
        return self.rc


@pytest.fixture
def fake(monkeypatch):
    rec, calls = _Recorder(), []
    entries = {}

    class Lib:
        def __getattr__(self, name):
            return entries.setdefault(name, _Entry(rec, calls))

    monkeypatch.setattr(torch.cuda, "device", rec)
    monkeypatch.setattr(_build, "library", lambda verbose=False: Lib())
    monkeypatch.setattr(_build, "stream_of", lambda device: 0xBEEF)
    return rec, calls, entries


def test_launch_runs_inside_its_tensors_card(fake):
    rec, calls, entries = fake
    dev = torch.device("cuda", 1)
    _build.launch("t41x_probe", [_build.PTR, _build.INT, _build.PTR], dev,
                  0x1000, 7)
    (args, current), = calls
    assert current == [dev] and rec.entered == [dev]
    # the stream, dev's own, comes last
    assert args == (0x1000, 7, 0xBEEF)
    assert entries["t41x_probe"].argtypes == [_build.PTR, _build.INT,
                                              _build.PTR]
    assert rec.current == []


def test_launch_refuses_a_tensor_on_another_card(fake):
    rec, calls, _ = fake
    with pytest.raises(ValueError, match="cuda:1"):
        _build.launch("t41x_probe", [_build.PTR, _build.PTR],
                      torch.device("cuda", 1), torch.zeros(4))
    assert calls == [] and rec.entered == []


def test_launch_passes_tensors_as_their_pointers(fake):
    _, calls, _ = fake
    t = torch.zeros(4)
    _build.launch("t41x_probe", [_build.PTR, _build.PTR, _build.PTR],
                  t.device, t, None)
    (args, current), = calls
    assert args == (t.data_ptr(), None, 0xBEEF)
    assert current == [t.device]


def test_launch_raises_on_a_refused_launch(fake, monkeypatch):
    rec, calls, entries = fake
    entries["t41x_probe"] = _Entry(rec, calls, rc=9)
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        _build.launch("t41x_probe", [_build.PTR], torch.device("cuda", 0))


def _launch_calls():
    """(file, line, call) of every `_build.launch(...)` under
    t41x_torch/kernels/."""
    out = []
    for f in sorted(KERNELS.glob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "launch"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "_build"):
                out.append((f.name, node.lineno, node))
    return out


def test_every_launch_site_passes_its_device():
    sites = _launch_calls()
    # agc (K2, K5), compressor, eq, frontend, interp, nb, nr_gain,
    # os_filter, os_spectrum (B1), sam (K6, its loop ops), spectral_nr
    # (S1, its arithmetic probe for the card tests), xanr
    assert len(sites) == 15, [(f, ln) for f, ln, _ in sites]
    for f, line, call in sites:
        where = f"{f}:{line}"
        assert len(call.args) >= 3, where
        device = ast.unparse(call.args[2])
        assert device == "dev" or device.endswith(".device"), (where,
                                                                device)
        for arg in call.args[3:]:
            text = ast.unparse(arg)
            # pointers go in as tensors, so that launch checks their
            # device; launch appends the stream itself
            assert "data_ptr" not in text and "stream" not in text, (
                where, text)


def test_initialize_sets_the_ranks_card_for_nccl(monkeypatch):
    set_to, groups = [], []
    monkeypatch.setattr(torch.cuda, "set_device", set_to.append)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(dist.tdist, "init_process_group",
                        lambda backend, **kw: groups.append(
                            (backend, kw, list(set_to))))
    dist.initialize("tcp://localhost:1", 8, 6, "nccl")
    assert set_to == [2]
    # the card is current before the group is made
    assert groups == [("nccl", dict(init_method="tcp://localhost:1",
                                    world_size=8, rank=6), [2])]
    dist.initialize("file:///nowhere", 2, 1, "gloo")
    assert set_to == [2] and groups[-1][0] == "gloo"
    dist.initialize(num_processes=1)
    assert len(groups) == 2
