"""The check that decides ``correct``, run through the whole harness at a
tiny size on the CPU (the chip's look skipped): sound runs pass; the
program's own lower-precision path (the control) and each fault a run
of these cells can have, planted under the timed path, fail.

Faults: a move that returns its state unchanged; half of each batch
left out and the rest counted double (the mean kept); one particle's
element answer altered as the walk produces it. These
cells run on one chip, so none has an exchange between chips to leave
out. The control at the cells' own size runs on the card
(``test_control_on_the_card``).
"""

import json
import subprocess
import sys

import pytest
import torch

import pumiumtally_tpu_torch.api.tally as tally_mod
from _tiny import MIXES, run_tiny
from benchmark import check
from benchmark.cell import ROOT, load_benchmark

CELLS = [w["name"] for w in load_benchmark()["workloads"]]


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("bench_cache")


@pytest.mark.parametrize("mix", MIXES)
def test_sound_run_is_correct(mix, cache):
    res, nums = run_tiny(CELLS[0], cache, mix=mix)
    assert res["correct"], res["check"]
    assert list(res)[-1] == "check"
    assert res["attempted"] > 0 and res["failed"] == 0
    for k, v in res["metrics"].items():
        assert v["value"] > 0, k
    assert set(res["check"]) <= set(nums)


def scored(cell):
    """The cell with an energy x time mesh tally and batch statistics:
    the scoring path of the harness and the check, which no cell of
    BENCHMARK.json drives yet."""
    cell.config["scoring"] = {"scores": ["flux", "heating", "events"],
                              "energy_edges": ["geomspace", 1e-5, 2e7, 9],
                              "time_edges": ["linspace", 0.0, 1.0, 5],
                              "overflow": "drop"}
    cell.config["tally_config"] = {"batch_stats": True}
    cell.config["limits"].update(bank_l1=5e-3, stats_l1=5e-3)
    cell.traffic.update(energy={"kind": "log_uniform", "out_share": 0.01},
                        time={"kind": "uniform"})
    return cell


def test_sound_scored_run_is_correct(cache):
    from _tiny import TINY_N, tiny_cell

    from benchmark.harness import run_cell

    cell = scored(tiny_cell(CELLS[0]))
    assert cell.config["particles"] == TINY_N
    res, nums = run_cell(cell, 2**33 + 9, 0.3, False, device="cpu",
                         cache=cache)
    assert res["correct"], res["check"]
    assert {"bank_l1", "stats_l1"} <= set(res["check"])


@pytest.mark.parametrize("facade,keys", [
    ("PumiTally", {"calls": ["arm_deterministic"]}),
    ("StreamingTally", {"facade_args": {"chunk_size": 700}}),
    ("PartitionedPumiTally", {}),
])
def test_other_facades_by_configuration_alone(facade, keys, cache):
    # A later cell on the deterministic commit, the streaming facade or
    # the partitioned one adds a configuration file and edits no code.
    from _tiny import tiny_cell

    from benchmark.harness import run_cell

    cell = tiny_cell(CELLS[0])
    cell.config.update(keys, facade=facade)
    res, _ = run_cell(cell, 2**33 + 7, 0.3, False, device="cpu",
                      cache=cache)
    assert res["correct"], res["check"]


@pytest.mark.parametrize("mix", MIXES)
def test_control_is_not_correct(mix, cache):
    # The control at a size where its readings near the cells' own: a
    # whole FLAGSHIP pincell, 20,000 particles, one batch.
    from _tiny import tiny_cell

    from benchmark.harness import run_cell

    cell = tiny_cell(CELLS[0], mix)
    cell.config["mesh"].update(nx=1, ny=1, n_theta=32, n_rings_fuel=5,
                               n_rings_pad=5, nz=4)
    cell.config["particles"] = 20000
    cell.traffic["pool_batches"] = 1
    res, nums = run_cell(cell, 17, 0.01, False, device="cpu", cache=cache,
                         control=True)
    assert not res["correct"], (res["check"], nums)


def unchanged(orig):
    def step(mesh, x, elem, dests, flying, weights, flux, **kw):
        n = x.shape[0]
        return (x, elem, torch.ones(n, dtype=torch.bool),
                torch.zeros(n, dtype=x.dtype))
    return step


def half_left_out(orig):
    def step(mesh, x, elem, dests, flying, weights, flux, **kw):
        fly = flying.clone()
        fly[::2] = 0
        return orig(mesh, x, elem, dests, fly, weights * 2, flux, **kw)
    return step


def answer_altered(orig):
    def step(mesh, x, elem, dests, flying, weights, flux, **kw):
        x2, elem2, done, s = orig(mesh, x, elem, dests, flying, weights,
                                  flux, **kw)
        elem2 = elem2.clone()
        elem2[0] = (elem2[0] + 1) % flux.shape[0]
        return x2, elem2, done, s
    return step


@pytest.mark.parametrize("fault", [unchanged, half_left_out,
                                   answer_altered])
@pytest.mark.parametrize("mix", MIXES)
def test_planted_fault_is_not_correct(mix, fault, cache, monkeypatch):
    monkeypatch.setattr(tally_mod, "move_step_continue",
                        fault(tally_mod.move_step_continue))
    res, _ = run_tiny(CELLS[0], cache, mix=mix)
    assert not res["correct"], (fault.__name__, res["check"])


def test_judge():
    ok, compared = check.judge({"a": 1e-6, "b": 0.5}, {"a": 1e-5})
    assert ok and compared == {"a": {"value": 1e-6, "limit": 1e-5}}
    assert not check.judge({"a": 2e-5}, {"a": 1e-5})[0]
    assert not check.judge({"a": float("nan")}, {"a": 1e-5})[0]
    assert not check.judge({}, {"a": 1e-5})[0]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_on_the_card(workload, card):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        workload, "--seed", "2147483711", "--seconds", "2",
                        "--trace", "0", "--control"], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["control"] and not res["correct"]


def test_float64_program_agrees_with_the_reference_closely(cache):
    # Run in float64 (on float64 inputs; the reference walks their
    # float32 rounding), the program and the reference differ by the
    # inputs' rounding alone: no segment's track is credited to another
    # tet. Destinations clipped in x and y at shares that put clipped
    # corners on a pincell's corner diagonal (a mesh face) make whole
    # vertical segments lie in a face: flux_max reads 0.16 at this size.
    from _tiny import tiny_cell

    from benchmark.harness import run_cell

    cell = tiny_cell(CELLS[0])
    cell.config["dtype"] = "float64"
    cell.config["mesh"].update(nx=1, ny=1, n_theta=32, n_rings_fuel=5,
                               n_rings_pad=5, nz=4)
    cell.config["particles"] = 20000
    cell.traffic["pool_batches"] = 1
    _, nums = run_cell(cell, 99, 0.01, False, device="cpu", cache=cache)
    assert nums["flux_l1"] < 1e-6 and nums["flux_max"] < 1e-4
    assert nums["final_miss"] == 0.0
