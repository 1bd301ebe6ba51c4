"""PyTorch port, the examples (``pumiumtally_tpu_torch/examples/``)
against the JAX package's (``examples/``), on the CPU in float64.

Each JAX example runs in this process at a reduced N (its module global
patched, its facade recorded by wrapping the class it builds), each
example in its own ``tmp_path``; the port's example runs through its
``run`` at the same N with ``device="cpu"``, from the same seeds:

- openmc_style_driver, every mode and protocol and the blocked walk:
  flux at rtol 1e-10 (``_same_flux``), the same auto_continue hit count,
  conservation, the VTK file;
- multi_client_service: both sessions bitwise their serial runs (the
  printed lines of ``main``);
- multichip_checkpointed_run on 8 CPU shards: 8 ``.vtu`` pieces, the
  checkpoint file, flux equal to the JAX example's (8 virtual devices).
"""

import importlib.util
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from pumiumtally_tpu_torch.examples import (
    multi_client_service,
    multichip_checkpointed_run,
    openmc_style_driver,
)

ROOT = Path(__file__).resolve().parent.parent
N = 1500  # particles, both packages (the examples' default is 20,000)
DIV = 8  # the examples' box: 8^3 cells of 6 tets


def _same_flux(got, want) -> None:
    """Flux at rtol 1e-10, element by element outside the tie cells and
    summed over each hex cell everywhere. The examples clamp
    destinations to [0.01, 0.99] (0.02, 0.98), so a track whose two
    coordinates are clamped runs along the line where they are equal:
    inside the box's edge cells that line lies in a diagonal face of
    the cell's tets, a tie of positive measure. The packages form the
    face projections in another order (an einsum against columns), so
    they may credit such a segment to either tet of the face; the cell
    holds it either way."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape == (6 * DIV ** 3,)
    idx = np.stack(np.unravel_index(np.arange(DIV ** 3), (DIV,) * 3), 1)
    tie = np.repeat(((idx == 0) | (idx == DIV - 1)).sum(1) >= 2, 6)
    np.testing.assert_allclose(got[~tie], want[~tie], rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(got.reshape(-1, 6).sum(1),
                               want.reshape(-1, 6).sum(1), rtol=1e-10,
                               atol=1e-12)


def _jax_example(name: str):
    """The JAX package's examples/<name>.py as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(monkeypatch, mod, attr: str) -> list:
    """Wrap ``mod.<attr>`` (a facade class or factory) so that every
    object it makes is kept."""
    made, real = [], getattr(mod, attr)

    def wrapped(*args, **kw):
        made.append(real(*args, **kw))
        return made[-1]

    monkeypatch.setattr(mod, attr, wrapped)
    return made


@pytest.mark.parametrize("mode,protocol,bound", [
    ("mono", "fast", None),
    ("mono", "reference", None),
    ("stream", "fast", None),
    ("stream", "reference", None),
    ("part", "fast", None),
    ("part", "reference", None),
    ("part", "fast", 200),  # the blocked walk: W1 on the card
])
def test_openmc_style_driver_equals_jax(tmp_path, monkeypatch, mode,
                                        protocol, bound):
    jmod = _jax_example("openmc_style_driver")
    monkeypatch.setattr(jmod, "N", N)
    made = _record(monkeypatch, jmod, "make_tally")
    argv = ["openmc_style_driver.py", "--mode", mode, "--protocol", protocol]
    if bound is not None:
        argv += ["--vmem-bound", str(bound)]
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", argv)
    jmod.main()
    want = made[-1]

    (tmp_path / "port").mkdir()
    got = openmc_style_driver.run(mode, protocol, bound, "cpu", n=N,
                                  out_dir=str(tmp_path / "port"))
    assert got["rel"] < 1e-6
    _same_flux(got["tally"].flux.numpy(), want.flux)
    assert got["hits"] == want.auto_continue_hits
    if protocol == "reference":
        assert got["hits"] == openmc_style_driver.BATCHES * (
            openmc_style_driver.STEPS_PER_BATCH - 1)
    out = sorted(os.listdir(tmp_path / "port"))
    if mode == "part":
        # One piece a device of the mesh: one CPU shard here, the JAX
        # package's 8 virtual devices there.
        assert out == ["fluxresult.pvtu"] + [
            f"fluxresult_p{i}.vtu" for i in range(got["tally"].engine.ndev)]
    else:
        assert out == ["fluxresult.vtk"]
        assert os.listdir(tmp_path / "jax") == out


def test_multi_client_service_bitwise(monkeypatch, capsys):
    monkeypatch.setattr(multi_client_service, "N", N)
    multi_client_service.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("bitwise vs serial run: True") == 2
    assert "zero cross-talk" in out


def test_multi_client_service_equals_jax(monkeypatch, capsys):
    """The served fluxes equal the JAX example's (its sessions on the
    JAX service) at rtol 1e-10."""
    jmod = _jax_example("multi_client_service")
    monkeypatch.setattr(jmod, "N", N)
    opened = []
    real_open = jmod.TallyService.open_session

    def open_session(self, tally, *a, **kw):
        opened.append(tally)
        return real_open(self, tally, *a, **kw)

    monkeypatch.setattr(jmod.TallyService, "open_session", open_session)
    jmod.main()
    assert capsys.readouterr().out.count("bitwise vs serial run: True") == 2
    got = multi_client_service.run("cpu", n=N)
    for name, t in zip(multi_client_service.CLIENTS, opened):
        served, solo = got[name]
        assert np.array_equal(served, solo)
        _same_flux(served, t.flux)


def test_multichip_checkpointed_run_equals_jax(tmp_path, monkeypatch):
    jmod = _jax_example("multichip_checkpointed_run")
    monkeypatch.setattr(jmod, "N", N)
    made = _record(monkeypatch, jmod, "PartitionedPumiTally")
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jmod.main()
    want = made[-1]
    assert want.engine.ndev == 8

    out_dir = tmp_path / "port"
    out_dir.mkdir()
    got = multichip_checkpointed_run.run("cpu", n=N, out_dir=str(out_dir))
    assert got.engine.ndev == 8
    _same_flux(got.flux.numpy(), want.flux)
    out = sorted(os.listdir(out_dir))
    assert "flux_result.pvtu" in out and "campaign.npz" in out
    assert sum(f.endswith(".vtu") for f in out) == 8
    assert out == sorted(os.listdir(tmp_path / "jax"))
