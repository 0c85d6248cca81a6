"""The system under test: the port's receive chain, as the window drives it.

The one module of the harness that imports the port (`t41x_torch`): the
chain (`RxChain.block`), its CUDA-graph capture (`runner.capture`), and
the carried state as named leaves.  On a CPU device (the CPU tests) a
dispatch runs eagerly with the same state hand-over.
"""

from __future__ import annotations

import torch


def leaves(state, prefix: str = "") -> dict:
    """A state's tensors by dotted field name (`agc.volts`); fields that
    hold no tensor (stages the spec leaves out) are skipped."""
    out = {}
    for name, v in zip(state._fields, state):
        if isinstance(v, torch.Tensor):
            out[prefix + name] = v
        elif hasattr(v, "_fields"):
            out.update(leaves(v, prefix + name + "."))
    return out


class Program:
    """The chain for one configuration on `device`, with `channels`
    channels and their parameters (a dict of (C,) tensors)."""

    def __init__(self, chain_kw: dict, channels: int, params: dict, device):
        from t41x_torch.chain import ChainSpec, RxChain, default_params

        self.device = torch.device(device)
        self.chain = RxChain(ChainSpec(**chain_kw), device=self.device)
        p = default_params((channels,), device=self.device)
        self.params = p._replace(**{k: v.to(self.device)
                                    for k, v in params.items()
                                    if k in p._fields})
        self.state = self.chain.init_state((channels,))

    def dispatch(self, blocks: list) -> "Dispatch":
        """One dispatch over `blocks`, a list of (i, q) int16 pairs (or
        complex tensors) already on the device: each through
        `RxChain.block`, the state carried; outputs keyed `name.b`."""
        chain, params = self.chain, self.params

        def fn(st):
            outs = {}
            for b, blk in enumerate(blocks):
                st, o = chain.block(params, st, blk)
                outs.update({f"{k}.{b}": v for k, v in o.items()})
            return st, outs

        inputs = [t for blk in blocks for t in (
            blk if isinstance(blk, tuple) else (blk,))]
        return Dispatch(fn, self.state, inputs, self.device)

    def state_leaves(self) -> dict:
        return leaves(self.state)


class Dispatch:
    """A captured dispatch: `replay()` runs it from the chain's state and
    leaves the new state in the same tensors; `out` holds its outputs,
    which the next replay overwrites."""

    def __init__(self, fn, state, inputs: list, device: torch.device):
        self.fn, self.state = fn, state
        if device.type == "cuda":
            from t41x_torch.runner import capture

            with torch.cuda.device(device):
                self.graph, self.out = capture(fn, state, inputs, device)
        else:
            self.graph, self.out = None, {}

    def replay(self) -> None:
        if self.graph is not None:
            self.graph.replay()
            return
        new, self.out = self.fn(self.state)
        old = leaves(self.state)
        for k, v in leaves(new).items():
            if v is not old[k]:
                old[k].copy_(v)
