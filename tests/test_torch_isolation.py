"""PyTorch port, isolation and device rules:

- importing ``pumiumtally_tpu_torch`` (every module) and ``chip_smoke``
  with ``jax`` and ``ml_dtypes`` blocked works and loads no
  ``pumiumtally_tpu`` module;
- no port source or ``chip_smoke.py`` imports jax, ml_dtypes or
  pumiumtally_tpu, and service/ imports and starts with them blocked;
- a facade built without ``device=`` raises when no GPU is present;
- on the CPU every wrapper runs its plain version (both tiers, both
  facades): the kernel launch counters stay 0;
- the CUDA-side argument checks and the build refuse what they cannot
  take, and ``chip_smoke.py`` exits non-zero without a GPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pumiumtally_tpu_torch import (
    CheckpointPolicy,
    EnergyFilter,
    PartitionedPumiTally,
    PumiTally,
    ScoringSpec,
    StreamingPartitionedTally,
    SentinelPolicy,
    StreamingTally,
    TallyConfig,
    TetMesh,
    build_box,
    kernels,
)
from pumiumtally_tpu_torch.experiments.pallas_gather import gather
from pumiumtally_tpu_torch.experiments.r3_vmem import setup, walk_vmem

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "pumiumtally_tpu_torch"

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "ml_dtypes"):
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, _Block())
import pumiumtally_tpu_torch as p
for m in pkgutil.walk_packages(p.__path__, "pumiumtally_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "ml_dtypes", "pumiumtally_tpu"))
print("LOADED", bad)
"""


def test_imports_with_jax_blocked_load_nothing_of_jax():
    r = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "LOADED []" in r.stdout


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_port_source_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    # The experiment entry points, the mesh IO and the pincell geometry
    # are under the check too.
    for rel in ("experiments/r3_vmem.py", "experiments/pallas_gather.py",
                "io/osh.py", "io/gmsh.py", "io/load.py", "mesh/pincell.py",
                "api/staging.py", "api/streaming.py", "scoring/filters.py",
                "scoring/scores.py", "scoring/binding.py",
                "stats/accumulators.py", "stats/estimators.py",
                "stats/triggers.py", "sentinel/__init__.py",
                "sentinel/policy.py", "sentinel/audit.py",
                "sentinel/quarantine.py", "sentinel/runner.py",
                "sentinel/straggler.py", "resilience/__init__.py",
                "resilience/faults.py", "resilience/generations.py",
                "resilience/policy.py", "utils/checkpoint.py",
                "ops/det_commit.py", "service/__init__.py",
                "service/scheduler.py", "service/session.py",
                "service/staging.py", "service/fusion.py",
                "service/server.py", "api/native.py", "native/build.py",
                "native/__init__.py", "cli.py", "utils/autotune.py",
                "utils/postprocess.py"):
        assert PORT / rel in files, rel
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & {"jax", "jaxlib", "pumiumtally_tpu",
                            "ml_dtypes"}, f


_SERVICE_BLOCKED = r"""
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "ml_dtypes", "pumiumtally_tpu"):
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, _Block())
from pumiumtally_tpu_torch.service import SocketFrontend, TallyService
from pumiumtally_tpu_torch.service import fusion
svc = TallyService()
front = SocketFrontend(svc, device="cpu")
front.stop()
svc.shutdown(drain=False, timeout=30)
print("SERVED", sorted(m for m in sys.modules
                       if m.startswith("pumiumtally_tpu_torch.service")))
"""


def test_service_imports_and_starts_with_jax_blocked():
    """service/ (the scheduler, sessions, staging, fusion, the server and
    its socket front end) imports and starts with jax and the JAX
    package blocked."""
    r = subprocess.run([sys.executable, "-c", _SERVICE_BLOCKED], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "pumiumtally_tpu_torch.service.fusion" in r.stdout
    for f in sorted((PORT / "service").glob("*.py")):
        assert not set(_imported_roots(f)) & {"jax", "jaxlib",
                                              "pumiumtally_tpu"}, f


def test_facade_without_device_raises_when_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    mesh = build_box(1, 1, 1, 1, 1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PumiTally(mesh, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PartitionedPumiTally(mesh, 4, TallyConfig(walk_vmem_max_elems=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingTally(mesh, 4, chunk_size=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingPartitionedTally(mesh, 4, chunk_size=2,
                                  config=TallyConfig(walk_vmem_max_elems=2))


def test_cpu_runs_plain_versions_and_counts_no_launch(tmp_path):
    kernels.reset_launch_counts()
    mesh = build_box(1, 1, 1, 3, 3, 3, dtype=torch.float64)
    pts = np.random.default_rng(2).uniform(0.05, 0.95, (50, 3))
    bf16 = dict(walk_table_dtype="bfloat16")
    for t in (PumiTally(mesh, 50, device="cpu"),
              PartitionedPumiTally(mesh, 50,
                                   TallyConfig(walk_vmem_max_elems=40),
                                   device="cpu"),
              PumiTally(mesh, 50, TallyConfig(**bf16), device="cpu"),
              PartitionedPumiTally(mesh, 50,
                                   TallyConfig(walk_kernel="pallas",
                                               walk_vmem_max_elems=40,
                                               **bf16),
                                   device="cpu"),
              StreamingTally(mesh, 50, chunk_size=20, device="cpu"),
              StreamingPartitionedTally(mesh, 50, chunk_size=20,
                                        config=TallyConfig(
                                            walk_vmem_max_elems=40),
                                        device="cpu"),
              # The gather block walk W4: one block, the sub-split, the
              # bf16 reroute.
              PartitionedPumiTally(mesh, 50, device="cpu"),
              PartitionedPumiTally(mesh, 50, TallyConfig(
                  walk_vmem_max_elems=40, walk_block_kernel="gather"),
                  device="cpu"),
              PartitionedPumiTally(mesh, 50, TallyConfig(
                  walk_vmem_max_elems=40, **bf16), device="cpu"),
              # The unpacked layout, and the sentinel's ladders (W0's
              # and the engine's) with a starved step budget.
              PumiTally(TetMesh.from_arrays(
                  mesh.coords.numpy(), mesh.tet2vert.numpy(),
                  dtype=torch.float64, force_unpacked=True), 50,
                  device="cpu"),
              PumiTally(mesh, 50, TallyConfig(
                  max_iters=2, sentinel=SentinelPolicy(), **bf16),
                  device="cpu"),
              PartitionedPumiTally(mesh, 50, TallyConfig(
                  max_iters=2, sentinel=SentinelPolicy()), device="cpu"),
              # A CheckpointPolicy: the deterministic commit's plain
              # version (W0's and W4's records, det_commit_plain).
              PumiTally(mesh, 50, TallyConfig(checkpoint=CheckpointPolicy(
                  dir=str(tmp_path / "m"), handle_signals=False)),
                  device="cpu"),
              PartitionedPumiTally(mesh, 50, TallyConfig(
                  checkpoint=CheckpointPolicy(dir=str(tmp_path / "p"),
                                              handle_signals=False)),
                  device="cpu")):
        t.CopyInitialPosition(pts.reshape(-1).copy())
        t.MoveToNextLocation(None, (1.0 - pts).reshape(-1).copy())
        np.testing.assert_allclose(
            t.flux.sum().item(),
            np.linalg.norm(1.0 - 2 * pts, axis=1).sum(), rtol=1e-10,
        )
    # W3 and both entries of G1 run their plain versions on the CPU.
    n = 40
    m32, x, elem, dest = setup(2, n, device="cpu")
    r = walk_vmem(m32, x, elem, dest, torch.ones(n, dtype=torch.int8),
                  torch.ones(n), torch.zeros(m32.nelems), tol=1e-6,
                  max_iters=4096)
    assert bool(r.done.all())
    tab = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    idx = torch.tensor([5, -6], dtype=torch.int32)
    for fill in (0.0, float("nan")):
        assert torch.equal(gather(tab, idx, fill), tab[[5, 0]])
    # The scoring instantiations' wrappers (W0 both tiers, W2, W4) too.
    spec = ScoringSpec([EnergyFilter([0.0, 1.0, 2.0])],
                       ["flux", "events"])
    for kw in ({}, bf16, dict(walk_kernel="pallas", walk_vmem_max_elems=40,
                             **bf16), dict(walk_vmem_max_elems=40)):
        facade = (PartitionedPumiTally if "walk_vmem_max_elems" in kw
                  else PumiTally)
        t = facade(mesh, 50, TallyConfig(scoring=spec, **kw), device="cpu")
        t.CopyInitialPosition(pts.reshape(-1).copy())
        t.MoveToNextLocation(None, (1.0 - pts).reshape(-1).copy(),
                             energy=np.full(50, 0.5))
        assert t.score_bank.sum().item() > 0
    assert kernels.launch_counts == {"walk": 0, "walk_twotier": 0,
                                     "walk_unpacked": 0,
                                     "walk_scored": 0,
                                     "walk_twotier_scored": 0,
                                     "walk_unpacked_scored": 0,
                                     "block_walk": 0,
                                     "twotier_block_walk": 0,
                                     "twotier_block_walk_scored": 0,
                                     "resident_walk": 0,
                                     "row_gather_take": 0,
                                     "row_gather_take_along_axis": 0,
                                     "gather_block_walk": 0,
                                     "gather_block_walk_twotier": 0,
                                     "gather_block_walk_scored": 0,
                                     "gather_block_walk_twotier_scored": 0,
                                     "gather_work_list": 0,
                                     "det_commit": 0}


def test_cuda_argument_checks():
    t = torch.zeros((4, 3))
    dev = torch.device("cpu")
    kernels.check_cuda_args("k", dev, [("x", t, torch.float32, (4, 3)),
                                       ("s", None, torch.float32, (4,))])
    with pytest.raises(TypeError, match="float64"):
        kernels.check_cuda_args("k", dev, [("x", t, torch.float64, (4, 3))])
    with pytest.raises(ValueError, match="shape"):
        kernels.check_cuda_args("k", dev, [("x", t, torch.float32, (5, 3))])
    with pytest.raises(ValueError, match="contiguous"):
        kernels.check_cuda_args("k", dev, [("x", t.T, torch.float32,
                                            (3, 4))])
    with pytest.raises(ValueError, match="is on"):
        kernels.check_cuda_args("k", torch.device("meta"),
                                [("x", t, torch.float32, (4, 3))])
    # W3 and G1 are float32 only: a float64 launch is refused before
    # any library is loaded.
    for entry in ("resident_walk", "row_gather_take",
                  "row_gather_take_along_axis"):
        with pytest.raises(TypeError, match="no torch.float64 entry"):
            kernels.launch(entry, torch.float64, dev)


def test_build_needs_nvcc_and_keys_on_the_sources(monkeypatch, tmp_path):
    p = kernels._library_path("walk")
    assert p.parent == kernels.BUILD_DIR and p.name.startswith("libwalk_")
    assert kernels._library_path("block_walk") != p
    if kernels.shutil.which("nvcc") or os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed: the refusal path is not reachable")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
