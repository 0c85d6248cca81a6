"""The mesh layer: the wideband channelizer, channel and time sharding
over a mesh of devices, and multi-process deployment (port of
`t41x.mesh`)."""

from t41x_torch.mesh.sharding import (  # noqa: F401
    channel_sharded_run,
    make_mesh,
)
