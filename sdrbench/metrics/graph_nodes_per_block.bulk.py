"""graph_nodes_per_block.bulk: the device-op nodes (kernel, memcpy,
memset) of the dispatch's CUDA graph, counted by the program at capture
(`t41x_torch.utils.tracing`), over the blocks a dispatch.  None where
the program keeps no stage map."""


def read(ctx):
    try:
        from t41x_torch.utils import tracing
    except ImportError:   # a program without the tracer
        return None
    maps = tracing.maps()
    if not maps:
        return None
    return maps[-1].nodes / int(ctx.mix["blocks_per_dispatch"])
