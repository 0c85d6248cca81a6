"""`BENCHMARK.json` and the harness's files: names and units in the
allowed characters, every entry found by name, nothing of JAX or the JAX
package imported, the reference independent of the port, and a new cell
added as files alone."""

import ast
import json
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from sdrbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert LINE.match(c["source"]) and LINE.match(c["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert all(LINE.match(w) for w in BENCH["command"])
    assert all(re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p)
               for p in BENCH["paths"])


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
    for w in cells:
        reported = [m for m in e2e.values() if w in m.get("workloads", [w])]
        assert len(reported) >= 2   # setup_s and another
        assert any(w in m["workloads"] for m in BENCH["per_layer"])


def test_every_entry_is_found_by_name():
    for c in BENCH["configs"]:
        f = spec.ROOT / c["file"]
        assert f.is_file() and f.parent == spec.HERE / "configs"
        assert f.stem == c["name"]
        cfg = json.loads(f.read_text())
        assert set(cfg["limits"]) >= set(cfg["compare"]) | {"state"}
        assert (spec.HERE / "references" / f"{cfg['reference']}.py").is_file()
    for w in BENCH["workloads"]:
        cell = spec.Cell(w["name"])
        assert "channels" in cell.traffic
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    for f in spec.HERE.rglob("*.py"):
        for name in _imports(f):
            assert name.split(".")[0] not in {"jax", "jaxlib", "flax",
                                              "t41x"}, (f, name)


def test_reference_and_check_import_nothing_of_the_port():
    files = list((spec.HERE / "references").glob("*.py")) + [
        spec.HERE / "check.py", spec.HERE / "traffic.py",
        spec.HERE / "roofline.py"]
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in {"t41x_torch", "t41x"}, (f, name)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = textwrap.dedent("""
        import sys
        from sdrbench import run
        run.WARM_ROUNDS = 1
        run.run("ssb_headless.bulk4k", 3, 0.05, False, device="cpu",
                overrides={"channels": 2, "blocks_per_dispatch": 1,
                           "resident_blocks": 1})
        print(run.forbidden_modules())
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=spec.ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_a_new_cell_is_files_alone(tmp_path):
    """Copy the benchmark, add a configuration, a traffic mix, a cell file
    and a per-layer metric as new files and entries, and run the new cell
    from the copy with no edit to an existing file."""
    shutil.copytree(spec.HERE, tmp_path / "sdrbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((spec.HERE / "configs" / "ssb_pan.json").read_text())
    cfg["chain"].update(mode="lsb", f_lo=-2800.0, f_hi=-300.0)
    (tmp_path / "sdrbench/configs/lsb_pan.json").write_text(json.dumps(cfg))
    mix = json.loads((spec.HERE / "traffic" / "bulk4k.json").read_text())
    mix.update(channels=64)
    (tmp_path / "sdrbench/traffic/small.json").write_text(json.dumps(mix))
    (tmp_path / "sdrbench/cells/lsb_pan.small.json").write_text(
        json.dumps({"channels": 3, "blocks_per_dispatch": 1,
                    "resident_blocks": 1}))
    (tmp_path / "sdrbench/metrics/blocks_done.small.py").write_text(
        "def read(ctx):\n    return float(ctx.blocks)\n")
    bench["configs"].append(dict(BENCH["configs"][0], name="lsb_pan",
                                 file="sdrbench/configs/lsb_pan.json"))
    bench["workloads"].append({"name": "lsb_pan.small", "config": "lsb_pan",
                               "traffic": "small", "chips": 1, "why": "t"})
    bench["end_to_end"][0]["workloads"].append("lsb_pan.small")
    bench["per_layer"].append({"name": "blocks_done.small", "unit": "blocks",
                               "better": "higher", "source": "host_clock",
                               "layer": "load generator",
                               "moves": "rx_samples_per_s",
                               "workloads": ["lsb_pan.small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent(f"""
        import sys, json
        sys.path[:0] = [{str(tmp_path)!r}, {str(spec.ROOT)!r}]
        from sdrbench import run, spec
        assert spec.ROOT == __import__("pathlib").Path({str(tmp_path)!r})
        cell = spec.Cell("lsb_pan.small")
        assert [m["name"] for m in cell.per_layer] == ["blocks_done.small"]
        run.WARM_ROUNDS = 1
        r = run.run("lsb_pan.small", 9, 0.05, False, device="cpu")
        print(json.dumps(r))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    r = json.loads(res.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert set(r["metrics"]) == {"rx_samples_per_s", "setup_s"}


@pytest.mark.gpu
def test_control_is_not_correct():
    """The reference control (the reference in float32 with TF32 matmuls,
    in the program's place) fails the check on three seeds, at 256
    channels (on the card only: TF32 exists there)."""
    import torch

    from sdrbench import control
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (TF32 matmuls)")
    for workload in ("ssb_pan.bulk4k", "ssb_headless.bulk4k",
                     "ssb_pan.live80"):
        for seed in (11, 12, 13):
            r = control.reference_run(workload, seed,
                                      overrides={"channels": 256})
            assert r["correct"] is False, (workload, seed, r["checks"])


@pytest.mark.gpu
def test_program_tf32_is_not_correct():
    """The program's own TF32 path (TF32 switched on before the chain is
    captured: the spectrum taps' cuBLAS GEMMs) fails the check on three
    seeds, at 256 channels, 2 s windows (on the card only)."""
    import torch

    from sdrbench import control
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (TF32 matmuls)")
    try:
        for workload in ("ssb_pan.bulk4k", "ssb_pan.live80"):
            for seed in (21, 22, 23):
                r = control.program_run(workload, seed, 2.0,
                                        overrides={"channels": 256})
                assert r["correct"] is False, (workload, seed, r["checks"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
