"""Command-line tools over the port: `python -m t41x_torch.tools.NAME`
(`bench`, `stagebench`, `ft8_sensitivity`, `multihost_bench`,
`livebench`)."""
