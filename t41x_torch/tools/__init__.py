"""Command-line tools over the port: `python -m t41x_torch.tools.NAME`
(`multihost_bench`, `livebench`)."""
