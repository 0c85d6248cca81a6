"""Multi-process deployment (torch.distributed), port of
`t41x.mesh.distributed`.

The scale-out story: each process (a host, or a card of a host) feeds its
local devices a DISJOINT set of receiver channels; the steady state has
no cross-process communication (channel parallelism is embarrassing),
so scaling is limited only by each process' ingest.  Cross-process
traffic appears only for:

  * time-sharded offline captures: the halos (`t41x_torch.mesh.halo`)
    never leave a process by construction, because the mesh is laid out
    with the `t` axis innermost over a process' own devices;
  * global reductions (fleet-wide spectrum or S-meter summaries): one
    small all-reduce a reporting interval.

Usage in each process:

    from t41x_torch.mesh import distributed as dist
    dist.initialize(init_method, num_processes, process_id)
    mesh = dist.global_mesh(axis="ch")
    local = dist.shard_local_channels(mesh, local_iq)
    ... channel_sharded_run(chain, mesh, params_local, local.iq, ...)

Every helper works in a single process too (no process group: local
reductions).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as tdist

from t41x_torch.mesh.sharding import Mesh, local_devices


def initialize(init_method: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """`torch.distributed.init_process_group`, skipped with one process.
    The backend defaults to NCCL where a card is visible and to gloo on
    the CPU; `init_method` is a `tcp://host:port` or `file://path`
    rendezvous.  With NCCL the rank's card, `process_id` modulo the
    visible cards, becomes the current one first: NCCL binds a
    communicator to the current card."""
    if num_processes is None or num_processes <= 1:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    tdist.init_process_group(backend, init_method=init_method,
                             world_size=num_processes, rank=process_id)


def _world() -> tuple[int, int]:
    """(rank, world size); (0, 1) with no process group."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1


def global_mesh(axis: str = "ch", time_axis: str | None = None,
                n_time: int = 1, devices=None) -> Mesh:
    """This process' mesh over its local devices (default: every visible
    CUDA device; `devices=[...]` on the CPU).  With a time axis the
    devices are laid out (ch, t) with `t` innermost, so that time halos
    never leave a process."""
    devs = list(devices) if devices is not None else local_devices()
    if time_axis is None or n_time <= 1:
        return Mesh(devs, (axis,))
    if len(devs) % n_time:
        raise ValueError(f"{len(devs)} devices do not split into {n_time} "
                         "time shards")
    return Mesh([devs[i:i + n_time] for i in range(0, len(devs), n_time)],
                (axis, time_axis))


class LocalChannels(NamedTuple):
    """This process' rows of the global channel-sharded capture."""
    iq: torch.Tensor            # (C_local, ...) on the mesh's first device
    offset: int                 # global index of local row 0
    global_shape: tuple         # (C_local * processes, ...)


def shard_local_channels(mesh: Mesh, local_iq, axis: str = "ch"
                         ) -> LocalChannels:
    """This process' block of a global channel-sharded capture: its rows,
    their global channel offset (rank x local count) and the global
    shape.  Nothing moves between processes."""
    if axis not in mesh.axis_names:
        raise ValueError(f"no {axis!r} axis in {mesh.axis_names}")
    rank, world = _world()
    iq = torch.as_tensor(local_iq).to(mesh.devices.flat[0])
    return LocalChannels(iq, rank * iq.shape[0],
                         (iq.shape[0] * world, *iq.shape[1:]))


def _all_reduce(t: torch.Tensor, op=tdist.ReduceOp.SUM) -> torch.Tensor:
    """`t` reduced in place over the process group (if there is one)."""
    if tdist.is_available() and tdist.is_initialized():
        tdist.all_reduce(t, op=op)
    return t


def fleet_summary(values: torch.Tensor) -> dict:
    """Mean, max and min of every process' values (e.g. per-channel dBm),
    each one all-reduce over the process group (a float64 sum and count
    for the mean); in a single process, local reductions.  Complex values
    travel as their real view (gloo has no complex dtypes) and give their
    mean alone."""
    t = values.detach()
    parts = torch.view_as_real(t) if t.is_complex() else t[..., None]
    sums = parts.reshape(-1, parts.shape[-1]).to(torch.float64).sum(dim=0)
    stats = _all_reduce(torch.cat([sums, sums.new_tensor([t.numel()])]))
    mean = stats[:-1] / stats[-1]
    if t.is_complex():
        return {"mean": torch.complex(mean[0], mean[1]).to(t.dtype)}
    return {"mean": mean[0].to(t.dtype),
            "max": _all_reduce(t.max().reshape(1), tdist.ReduceOp.MAX)[0],
            "min": _all_reduce(t.min().reshape(1), tdist.ReduceOp.MIN)[0]}
