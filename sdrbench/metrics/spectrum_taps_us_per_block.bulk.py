"""spectrum_taps_us_per_block.bulk: device µs a block of the two complex
GEMMs that `t41x_torch.dsp.osfilter.os_filter_matmul_spectrum` launches
(X = xw @ F.T, y = X @ W2.T), found by the cuBLAS kernels' names: no
other stage of a display chain at zoom x1 runs a GEMM (the zoom tap is
a cuFFT).  The |X|^2 mask_sq product is an elementwise kernel that
shares its name with others and is not counted."""

from sdrbench.readers import device_s_per_block

NAMES = ("gemm", "Gemm", "GEMM", "splitKreduce")


def read(ctx):
    s = device_s_per_block(ctx, NAMES)
    return None if s is None else s * 1e6
