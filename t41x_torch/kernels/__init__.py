"""Hand-written CUDA kernels (csrc/*.cu), each with its wrapper and its
plain torch version.  Nothing here needs nvcc, CUDA or Triton at import:
the kernels build at their first CUDA launch (`_build`)."""
