"""Mesh construction and channel sharding (torch), port of
`t41x.mesh.sharding`.

The scale-out model:

  * `ch` mesh axis: channel parallelism.  Each device owns a disjoint,
    contiguous slice of the receiver channels; nothing in the chain mixes
    channels, so the steady state needs no communication.
  * `t` mesh axis: time sharding for offline captures, consecutive time
    segments on consecutive devices with the filter histories handed on
    as halos (`t41x_torch.mesh.halo`, `t41x_torch.mesh.timeshard`).

Torch has no single-controller mesh (`DeviceMesh` wants one process a
device), so `Mesh` here is a NumPy object array of `torch.device` with
axis names, and a sharded function runs each shard's slice on its device
from one host thread: the launches are queued shard after shard with no
host sync between them, so shards on separate cards overlap.  A device
may appear more than once (several shards on one card, or on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from t41x_torch import constants as C
from t41x_torch.chain.rx import join_blocks
from t41x_torch.utils.checkpoint import flatten_with_path, map_leaves


def canonical_device(device) -> torch.device:
    """`device` as a `torch.device`, an unindexed CUDA device given the
    current device's index (`"cuda"` and `"cuda:0"` name one card)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """Devices laid out on named axes: `devices` is an object array of
    `torch.device` (each `canonical_device`) whose shape pairs with
    `axis_names`; `shape[axis]` is an axis' size, as in JAX's `Mesh`."""

    def __init__(self, devices, axis_names):
        devs = np.asarray(devices, dtype=object)
        self.devices = np.empty(devs.shape, dtype=object)
        for idx in np.ndindex(devs.shape):
            self.devices[idx] = canonical_device(devs[idx])
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{self.axis_names} for a mesh of shape "
                             f"{self.devices.shape}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def local_devices() -> list:
    """Every CUDA device visible to this process; raises with none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is visible; pass devices=[...] "
                           "(e.g. [\"cpu\"] * n) to build a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, axis: str = "ch",
              devices=None) -> Mesh:
    """A 1-D mesh over `devices` (default: every visible CUDA device),
    cut to the first `n_devices`."""
    devices = list(devices) if devices is not None else local_devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"{n_devices} devices asked, {len(devices)} "
                             "given")
        devices = devices[:n_devices]
    return Mesh(devices, (axis,))


def shard_bounds(n: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous equal slices of n rows, in mesh order (the layout of a
    `NamedSharding(P(axis))` dimension); n must divide evenly."""
    if n % n_shards:
        raise ValueError(f"{n} rows do not split over {n_shards} shards")
    m = n // n_shards
    return [(i * m, (i + 1) * m) for i in range(n_shards)]


def split_tree(tree, lo: int, hi: int, device):
    """Rows lo:hi of every leaf's leading dim, on `device`."""
    return map_leaves(lambda _, t: torch.as_tensor(t)[lo:hi].to(device),
                      tree)


def concat_trees(trees: list, device):
    """The leaves of same-layout trees concatenated along dim 0, on
    `device`."""
    parts = {}
    for t in trees:
        for path, leaf in flatten_with_path(t):
            parts.setdefault(path, []).append(leaf.to(device))
    return map_leaves(lambda path, _: torch.cat(parts[path]), trees[0])


def chains_on(chain, devices) -> dict:
    """One chain of `chain.spec` for each distinct device (`chain` itself
    on its own device)."""
    own = canonical_device(chain.device)
    out = {}
    for d in map(canonical_device, devices):
        if d not in out:
            out[d] = chain if d == own else type(chain)(chain.spec,
                                                        device=d)
    return out


def channel_sharded_outputs(chain, mesh: Mesh, params, iq, state=None,
                            axis: str = "ch"):
    """Stream the chain over iq (C, n_blocks*BLOCK) complex with the
    channel dim split over `mesh`'s `axis` in contiguous equal slices;
    each shard's params, state and samples go to its device and one chain
    a device runs them.  Blocks are outermost and shards inner, with no
    host sync, so shards on separate cards run at once.  `state` (None:
    a fresh one) may live anywhere, e.g. a checkpoint loaded on the host,
    and is re-split on this mesh, whatever mesh wrote it.

    Returns (state, outputs): both gathered in channel order on the
    mesh's first device, the outputs streamed with time last."""
    if mesh.axis_names != (axis,):
        raise ValueError(f"a 1-D {axis!r} mesh, not {mesh.axis_names}")
    devs = list(mesh.devices.flat)
    iq = torch.as_tensor(iq)
    n_ch = iq.shape[0]
    n_blocks = iq.shape[-1] // C.BLOCK_SIZE
    bounds = shard_bounds(n_ch, len(devs))
    chains = chains_on(chain, devs)
    home = devs[0]
    if state is None:
        state = chains[home].init_state((n_ch,))
    shards = []
    for d, (lo, hi) in zip(devs, bounds):
        blocks = iq[lo:hi, : n_blocks * C.BLOCK_SIZE].to(d).reshape(
            hi - lo, n_blocks, C.BLOCK_SIZE).transpose(0, 1).contiguous()
        shards.append([chains[d], split_tree(params, lo, hi, d),
                       split_tree(state, lo, hi, d), blocks, []])
    for b in range(n_blocks):
        for sh in shards:
            ch, p, st, blocks, outs = sh
            sh[2], out = ch.block(p, st, blocks[b])
            outs.append(out)
    state = concat_trees([sh[2] for sh in shards], home)
    outs = [join_blocks(sh[4], 1) for sh in shards]
    return state, {k: torch.cat([o[k].to(home) for o in outs])
                   for k in outs[0]}


def channel_sharded_stream(chain, mesh: Mesh, params, iq, state=None,
                           axis: str = "ch"):
    """Resumable channel-sharded execution: accepts and returns the carry
    state, so a stream can be checkpointed and continued, on another
    device count too (elastic recovery: a checkpoint taken on an 8-shard
    mesh resumes on 4).  iq: (C, n_blocks*BLOCK) complex.
    Returns (state, audio_24k (C, n_blocks*256))."""
    state, outs = channel_sharded_outputs(chain, mesh, params, iq, state,
                                          axis)
    return state, outs["audio_24k"]


def channel_sharded_run(chain, mesh: Mesh, params, iq, n_blocks: int,
                        axis: str = "ch"):
    """The chain over the first n_blocks blocks of iq (C, N) with the
    channel dim sharded over `mesh`, from a fresh state.  Returns
    audio_24k (C, n_blocks*256) on the mesh's first device."""
    iq = torch.as_tensor(iq)[:, : n_blocks * C.BLOCK_SIZE]
    return channel_sharded_stream(chain, mesh, params, iq, None, axis)[1]
