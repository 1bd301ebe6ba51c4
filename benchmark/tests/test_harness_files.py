"""BENCHMARK.json against its contract, every name in it resolved to a
file, and the harness's imports: nothing under benchmark/ loads JAX or
the JAX package, and the reference loads nothing of the program."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import cell as cellmod
from benchmark.run import FORBIDDEN

ROOT = cellmod.ROOT
BENCH = cellmod.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_name_resolves_to_a_file():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("benchmark/")
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"]
        assert (cellmod.BENCH_DIR / "meshes" /
                f"{cfg['mesh']['kind']}.py").is_file()
    assert len({c["file"] for c in BENCH["configs"]}) == len(configs)
    used = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs
        used.add(w["config"])
        assert (cellmod.BENCH_DIR / "traffic" /
                f"{w['traffic']}.json").is_file()
        for trace in (False, True):
            cell = cellmod.resolve(BENCH, w["name"], trace)
            assert cell.metrics
    assert used == set(configs)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert cellmod.metric_path(m["name"]).is_file(), m["name"]


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    for n in names:
        assert NAME.match(n), n
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_bounds_and_metric_coverage():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert "\n" not in m["layer"]
    for w in BENCH["workloads"]:
        ends = [m for m in cellmod.resolve(BENCH, w["name"], False).metrics]
        assert "setup_s" in [m["name"] for m in ends] and len(ends) >= 2
        assert cellmod.resolve(BENCH, w["name"], True).metrics
    for m in BENCH["per_layer"]:
        for w in m.get("workloads", []):
            assert cellmod.applies(BENCH, e2e[m["moves"]], w)
    roofs = [m for m in BENCH["per_layer"] if "roofline" in m["name"]]
    assert roofs and all(m["unit"] == "%" for m in roofs)


def test_a_metric_without_workloads_follows_the_metric_it_moves():
    # The contract lets a metric leave out ``workloads``: it is then read
    # in every cell that reports the end-to-end metric it moves, cells
    # added later included.
    bench = {"end_to_end": [{"name": "a"},
                            {"name": "b", "workloads": ["x"]}],
             "per_layer": []}
    for w in ("x", "y"):
        assert cellmod.applies(bench, {"name": "m", "moves": "a"}, w)
        assert cellmod.applies(bench, bench["end_to_end"][0], w)
    assert cellmod.applies(bench, {"name": "m", "moves": "b"}, "x")
    assert not cellmod.applies(bench, {"name": "m", "moves": "b"}, "y")


def test_configs_hold_limits_and_a_control():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert {"flux_l1", "flux_max"} <= set(cfg["limits"])
        assert cfg["control"]
        if cfg["scoring"] is not None:
            assert {"bank_l1", "stats_l1"} <= set(cfg["limits"])


def imports_of(path: Path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(node.args[0].value)
    return out


SOURCES = sorted(cellmod.BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_by_whole_top_level_name(path):
    tops = {m.split(".")[0] for m in imports_of(path)}
    assert not tops & set(FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (cellmod.BENCH_DIR / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in imports_of(path)}
        assert "pumiumtally_tpu_torch" not in tops, path
        assert not tops & set(FORBIDDEN), path


def test_whole_name_compare():
    # The port's name begins with the JAX package's; only a whole
    # top-level name counts.
    from benchmark.run import forbidden_modules

    assert "pumiumtally_tpu_torch" not in forbidden_modules()
    assert "pumiumtally_tpu_torch".split(".")[0] not in FORBIDDEN


def test_run_refuses_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        BENCH["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
