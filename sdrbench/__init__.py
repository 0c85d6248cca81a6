"""The port's benchmark harness: see `sdrbench/run.py` and PERF.md."""
