"""k4_roofline_pct.bulk: K4, the overlap-save band-pass as a hand-written
GEMM (`csrc/os_filter.cu`), its share of the roofline in the chain: the
bound of y = [h | x] @ W.T at the cell's shapes (`roofline.k4_work`)
over its device time a block, %."""

from sdrbench.readers import roofline_pct
from sdrbench.roofline import k4_work

NAMES = ("os_filter_kernel",)


def read(ctx):
    return roofline_pct(ctx, NAMES, k4_work(ctx.channels))
