"""PyTorch port, the CLI (``python -m pumiumtally_tpu_torch.cli``) against
the JAX package's (``python -m pumiumtally_tpu.cli``).

The mesh verbs run in-process through both ``main`` functions on the same
arguments and must write byte-identical files and print the same text.
``serve`` runs as a subprocess on the CPU (``--device cpu``), answers one
socket session and exits 0 on SIGTERM; without a device request it
refuses here (no GPU). ``aot-check`` fails naming nvcc where nvcc is
missing, and its timeout names PUMIUMTALLY_SUBPROC_TIMEOUT. ``autotune``
at a tiny size prints its ``best:`` line.
"""

import base64
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pumiumtally_tpu import cli as jax_cli
from pumiumtally_tpu_torch import cli as port_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree_bytes(path: Path) -> dict:
    """A file's bytes, or every file's bytes under a directory."""
    if path.is_file():
        return {"": path.read_bytes()}
    return {str(p.relative_to(path)): p.read_bytes()
            for p in sorted(path.rglob("*")) if p.is_file()}


def _run_both(capsys, tmp_path, argv_of):
    """Run one verb through both CLIs; ``argv_of(dir)`` gives the argv
    writing into ``dir``. Returns (port stdout, jax stdout, port dir, jax
    dir)."""
    out = {}
    for name, main in (("port", port_cli.main), ("jax", jax_cli.main)):
        d = tmp_path / name
        d.mkdir()
        main(argv_of(d))
        out[name] = (capsys.readouterr().out, d)
    return out["port"][0], out["jax"][0], out["port"][1], out["jax"][1]


_PIN = ["--n-theta", "8", "--nz", "2", "--rings-fuel", "2", "--rings-pad",
        "2"]
_GENERATORS = {
    "box_msh": lambda d: ["box", str(d / "m.msh"), "--nx", "3", "--ny", "2",
                          "--nz", "2", "--lx", "2.5"],
    "box_osh": lambda d: ["box", str(d / "m.osh"), "--nx", "2", "--ny", "3",
                          "--nz", "2"],
    "pincell_osh": lambda d: ["pincell", str(d / "m.osh"), *_PIN],
    "pincell_msh": lambda d: ["pincell", str(d / "m.msh"), *_PIN],
    "lattice_osh": lambda d: ["lattice", str(d / "m.osh"), "--nx", "2",
                              "--ny", "2", *_PIN],
    "lattice_msh": lambda d: ["lattice", str(d / "m.msh"), "--nx", "2",
                              "--ny", "1", *_PIN],
}


@pytest.mark.parametrize("verb", sorted(_GENERATORS))
def test_generators_write_the_jax_clis_bytes(verb, capsys, tmp_path):
    """box / pincell / lattice write byte-identical .msh files and .osh
    directories (element tags included), with the same message."""
    out_p, out_j, dp, dj = _run_both(capsys, tmp_path, _GENERATORS[verb])
    name = "m.msh" if verb.endswith("msh") else "m.osh"
    assert _tree_bytes(dp / name) == _tree_bytes(dj / name)
    assert out_p.replace(str(dp), "") == out_j.replace(str(dj), "")


@pytest.fixture
def src_meshes(tmp_path, capsys):
    """A small box as .msh and a pincell as .osh, written by the port."""
    d = tmp_path / "src"
    d.mkdir()
    port_cli.main(["box", str(d / "b.msh"), "--nx", "2", "--ny", "2",
                   "--nz", "3", "--lz", "1.5"])
    port_cli.main(["pincell", str(d / "p.osh"), *_PIN])
    capsys.readouterr()
    return {"msh": d / "b.msh", "osh": d / "p.osh"}


@pytest.mark.parametrize("case", ["msh2osh", "scale_msh", "scale_osh",
                                  "scale_msh_to_osh"])
def test_converters_write_the_jax_clis_bytes(case, src_meshes, capsys,
                                             tmp_path):
    """msh2osh and scale (each format in and out) write the same bytes
    as the JAX CLI."""
    argv = {
        "msh2osh": lambda d: ["msh2osh", str(src_meshes["msh"]),
                              str(d / "o.osh")],
        "scale_msh": lambda d: ["scale", str(src_meshes["msh"]),
                                str(d / "o.msh"), "10"],
        "scale_osh": lambda d: ["scale", str(src_meshes["osh"]),
                                str(d / "o.osh"), "0.5"],
        "scale_msh_to_osh": lambda d: ["scale", str(src_meshes["msh"]),
                                       str(d / "o.osh"), "3"],
    }[case]
    out_p, out_j, dp, dj = _run_both(capsys, tmp_path, argv)
    name = next(p.name for p in dp.iterdir())
    assert _tree_bytes(dp / name) == _tree_bytes(dj / name)
    assert out_p.replace(str(dp), "") == out_j.replace(str(dj), "")


@pytest.mark.parametrize("kind", ["msh", "osh"])
def test_describe_prints_the_jax_clis_text(kind, src_meshes, capsys):
    """describe: sizes, coordinate ranges and (for .osh) the tags."""
    port_cli.main(["describe", str(src_meshes[kind])])
    got = capsys.readouterr().out
    jax_cli.main(["describe", str(src_meshes[kind])])
    assert got == capsys.readouterr().out
    assert "tets     :" in got
    if kind == "osh":
        assert "tag      : class_id [int32, 2 distinct]" in got


def test_unsupported_mesh_format_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="unsupported mesh format"):
        port_cli.main(["describe", str(tmp_path / "m.vtk")])


def _rpc(f, obj):
    f.write(json.dumps(obj).encode() + b"\n")
    f.flush()
    return json.loads(f.readline())


def test_serve_roundtrip_and_sigterm_exit(tmp_path):
    """``serve --port 0 --device cpu`` binds, serves one socket session
    (a box mesh from the open request, float64), conserves the track
    length, and exits 0 on SIGTERM."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pumiumtally_tpu_torch.cli", "serve",
         "--port", "0", "--device", "cpu", "--dtype", "float64"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(tmp_path), env=env,
    )
    try:
        addr = json.loads(proc.stdout.readline())["serving"]
        n = 32
        rng = np.random.default_rng(3)
        src = rng.uniform(0.1, 0.9, (n, 3))
        dst = rng.uniform(0.1, 0.9, (n, 3))

        def b64(a):
            return base64.b64encode(np.asarray(a, "<f8").tobytes()).decode()

        with socket.create_connection((addr["host"], addr["port"]),
                                      timeout=300) as conn:
            f = conn.makefile("rwb")
            r = _rpc(f, {"op": "open", "facade": "mono",
                         "num_particles": n, "max_queue": 8,
                         "mesh": {"box": [1, 1, 1, 2, 2, 2]}})
            assert r["ok"], r
            sid = r["session"]
            assert _rpc(f, {"op": "source", "session": sid,
                            "positions": b64(src.reshape(-1))})["ok"]
            assert _rpc(f, {"op": "move", "session": sid,
                            "dests": b64(dst.reshape(-1))})["ok"]
            r = _rpc(f, {"op": "flux", "session": sid})
            assert r["ok"]
            flux = np.frombuffer(base64.b64decode(r["flux"]), "<f8")
        assert flux.shape == (6 * 2 * 2 * 2,)
        want = np.linalg.norm(dst - src, axis=1).sum()
        assert abs(flux.sum() - want) / want < 1e-12
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        assert rc == 0, proc.stderr.read()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_serve_refuses_without_a_gpu():
    """With no device request and no CUDA device, serve refuses before
    it binds: no session quietly runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(SystemExit, match="no CUDA device.*--device cpu"):
        port_cli.main(["serve", "--port", "0"])


def test_route_and_loadgen_refuse_malformed_addresses():
    with pytest.raises(SystemExit, match="is not host:port"):
        port_cli.main(["route", "--backend", "nohost"])
    with pytest.raises(SystemExit, match="is not host:port"):
        port_cli.main(["loadgen", "--connect", "nohost"])


def test_aot_check_fails_naming_nvcc(capsys):
    """Where nvcc is missing, aot-check reports the CUDA job [FAILED]
    with the reason, builds the C ABI, and exits 1: it never skips."""
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed: the failure path is not reachable")
    with pytest.raises(SystemExit) as e:
        port_cli.main(["aot-check"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "[FAILED] CUDA kernels (nvcc, sm_90a)" in out
    assert "nvcc not found" in out
    assert "[OK] C ABI library and hosts" in out


def test_aot_check_timeout_names_the_variable(capsys, monkeypatch):
    monkeypatch.setenv("PUMIUMTALLY_SUBPROC_TIMEOUT", "0.001")
    with pytest.raises(SystemExit) as e:
        port_cli.main(["aot-check"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert out.count("set PUMIUMTALLY_SUBPROC_TIMEOUT to extend") == 2
    monkeypatch.setenv("PUMIUMTALLY_SUBPROC_TIMEOUT", "soon")
    with pytest.raises(SystemExit, match="PUMIUMTALLY_SUBPROC_TIMEOUT"):
        port_cli.main(["aot-check"])


def test_autotune_prints_best(src_meshes, capsys):
    """autotune at a tiny size on the CPU: one line a candidate (both
    table tiers), then ``best:`` with the float32 tier's rate (the
    two-tier tier is measured, not adopted)."""
    port_cli.main(["autotune", str(src_meshes["msh"]), "--particles",
                   "300", "--moves", "1", "--device", "cpu", "--dtype",
                   "float64"])
    out = capsys.readouterr().out
    assert out.count("autotune: {'walk_table_dtype'") == 2
    best = [ln for ln in out.splitlines() if ln.startswith("best:")]
    assert len(best) == 1 and "M moves/s with TallyConfig(" in best[0]
