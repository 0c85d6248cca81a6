"""k1_roofline_pct.bulk: K1, the fused front end (`csrc/frontend.cu`),
its share of the roofline in the chain: the bound of its work at the
cell's shapes (`roofline.k1_work`) over its device time a block, %."""

from sdrbench.readers import roofline_pct
from sdrbench.roofline import k1_work

NAMES = ("frontend_kernel",)


def read(ctx):
    chain = ctx.cell.config["chain"]
    return roofline_pct(ctx, NAMES, k1_work(
        ctx.channels, int(chain.get("spectrum_zoom", -1)),
        bool(chain.get("q15_input", False))))
