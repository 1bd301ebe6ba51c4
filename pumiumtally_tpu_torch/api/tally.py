"""The three-call public API (port of ``pumiumtally_tpu/api/tally.py``,
reference PumiTally.h:34-107): ``CopyInitialPosition`` /
``MoveToNextLocation`` / ``WriteTallyResults`` over flat host buffers.

Semantics kept from the reference and the JAX package:

- Construction seeds every particle at element 0's centroid
  (PumiTallyImpl.cpp:492-528); ``CopyInitialPosition`` then walks them,
  without tallying, to the source points (cpp:195-221).
- ``MoveToNextLocation`` is the two-phase move (cpp:66-149): phase A
  relocates flying particles to their origins with weights zeroed and
  is skipped when it would walk zero distance for everyone; phase B
  transports and tallies. ``particle_origin=None`` continues from the
  committed positions (phase B only).
- The caller's ``flying`` buffer is zeroed in place after staging
  (cpp:169-172).
- Leavers clamp to the boundary point (vacuum BC, cpp:256-286).
- ``WriteTallyResults`` divides flux by element volume only and writes a
  VTK file with "flux" and "volume" cell data (cpp:382-416).

``TallyConfig(walk_table_dtype="bfloat16")`` walks the two-tier tables
(``TetMesh.with_lowp_tables``, W0's two-tier variant); point location and
``WriteTallyResults`` read the full-precision planes and volumes.

The facades run on ``device="cuda"`` by default and raise when no GPU is
present, unless the caller asks for ``device="cpu"`` (where every
kernel's plain PyTorch version runs). Left out so far (ROADMAP.md): the
host origin-echo ``auto_continue`` upload skip (results are identical
without it), sentinels, resilience, batch statistics, scoring, the
service-fusion surface and ``intersection_points``.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Any, Optional, Union

import numpy as np
import torch

from pumiumtally_tpu_torch.config import TallyConfig
from pumiumtally_tpu_torch.io.load import load_mesh
from pumiumtally_tpu_torch.io.vtk import merge_cell_data, write_vtk
from pumiumtally_tpu_torch.mesh.tetmesh import TetMesh
from pumiumtally_tpu_torch.ops.geometry import locate_by_planes
from pumiumtally_tpu_torch.ops.walk import walk


@dataclass
class TallyTimes:
    """Per-phase wall-clock accumulation (reference PumiTallyImpl.h:18-27).
    Every protocol call synchronizes the device before its end stamp."""

    initialization_time: float = 0.0
    total_time_to_tally: float = 0.0
    vtk_file_write_time: float = 0.0

    def print_times(self) -> None:  # reference PrintTimes, cpp:22-29
        print()
        print(f"[TIME] Initialization time     : {self.initialization_time:f} seconds")
        print(f"[TIME] Total time to tally     : {self.total_time_to_tally:f} seconds")
        print(f"[TIME] VTK file write time     : {self.vtk_file_write_time:f} seconds")
        total = (
            self.initialization_time
            + self.total_time_to_tally
            + self.vtk_file_write_time
        )
        print(f"[TIME] Total PUMI-Tally time   : {total:f} seconds")


def resolve_device(device: Any) -> torch.device:
    """The facades' device: CUDA unless the caller asks otherwise, and
    no silent fall back to the CPU when there is no GPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device}")
    return device


def host_positions(buf, size: Optional[int], n: int) -> np.ndarray:
    """Validate a caller position buffer -> flat [3n] float64 array."""
    a = np.asarray(buf, dtype=np.float64).reshape(-1)
    if size is not None and size != 3 * n:
        raise ValueError(f"size {size} != 3*num_particles {3 * n}")
    if a.shape[0] < 3 * n:
        raise ValueError(
            f"position buffer has {a.shape[0]} values, need {3 * n}"
        )
    return a[: 3 * n]


def host_scalar_field(buf, n: int, what: str) -> np.ndarray:
    """Validate a caller per-particle scalar buffer -> flat [n] float64
    array, with shape errors that name the argument."""
    a = np.asarray(buf, dtype=np.float64).reshape(-1)
    if a.shape[0] < n:
        raise ValueError(f"{what} buffer has {a.shape[0]} values, need {n}")
    return a[:n]


def check_finite(a: np.ndarray, what: str, offset: int = 0) -> None:
    """Raise on NaN/Inf in a staged host array (after the working-dtype
    cast, so an f64 value that overflows f32 is caught too): one
    non-finite value would poison the whole accumulated flux."""
    if not np.isfinite(a).all():
        flat = np.asarray(a).reshape(-1)
        bad = np.flatnonzero(~np.isfinite(flat))
        raise ValueError(
            f"{what} contains {bad.size} non-finite value(s); first at "
            f"flat index {offset + bad[0]} ({flat[bad[0]]!r}). Fix the "
            "host buffer"
        )


def zero_flying_side_effect(flying, n: int) -> None:
    """Zero the caller's flying buffer in place after staging (the
    reference's documented host side effect, cpp:169-172). Unwritable
    buffers get a warning, never a silent skip."""
    if isinstance(flying, np.ndarray):
        if flying.flags.writeable:
            flying.flat[:n] = 0
        else:
            warnings.warn(
                "flying array is read-only: skipping the in-place "
                "zeroing side effect the host protocol specifies"
            )
    elif isinstance(flying, list):
        flying[:n] = [0] * min(n, len(flying))
    elif flying is not None:
        try:
            for i in range(min(n, len(flying))):
                flying[i] = 0
        except (TypeError, ValueError):
            warnings.warn(
                "flying buffer is not writeable: skipping the "
                "in-place zeroing side effect the host protocol "
                "specifies"
            )


def adopt_located(x, elem, dest, e0):
    """Locate-mode adoption rule: located particles (``e0 >= 0``) adopt
    (dest, element) so the follow-up walk retires them at once;
    unlocated ones keep their committed (x, elem) and walk/clamp."""
    missing = e0 < 0
    return (torch.where(missing[:, None], x, dest),
            torch.where(missing, elem, e0))


def _localize_step(mesh, x, elem, dest, *, tol, max_iters):
    """Non-tallying walk of every particle to ``dest``."""
    n = x.shape[0]
    r = walk(
        mesh, x, elem, dest,
        torch.ones((n,), dtype=torch.int8, device=x.device),
        torch.zeros((n,), dtype=x.dtype, device=x.device), None,
        tally=False, tol=tol, max_iters=max_iters,
    )
    return r.x, r.elem, r.done, r.exited


def move_step_continue(mesh, x, elem, dests, flying, weights, flux, *, tol,
                       max_iters):
    """Phase-B-only move: transport from the committed state straight
    to the destinations, tallying into ``flux`` (in place). Returns
    (x, elem, done, s)."""
    dest_b = torch.where((flying == 1)[:, None], dests, x)  # stopped: hold
    rb = walk(mesh, x, elem, dest_b, flying, weights, flux, tally=True,
              tol=tol, max_iters=max_iters)
    return rb.x, rb.elem, rb.done, rb.s


def move_step(mesh, x, elem, origins, dests, flying, weights, flux, *, tol,
              max_iters):
    """One full MoveToNextLocation: phase A (relocate, no tally) then
    phase B (transport, tally). Phase A is skipped when every staged
    origin already equals the committed position (it would walk zero
    distance for everyone). Returns (x, elem, done, s)."""
    dest_a = torch.where((flying == 1)[:, None], origins, x)
    if bool((dest_a == x).all()):  # the `trivial` skip
        done_a = torch.ones_like(elem, dtype=torch.bool)
    else:
        ra = walk(mesh, x, elem, dest_a, flying, torch.zeros_like(weights),
                  None, tally=False, tol=tol, max_iters=max_iters)
        x, elem, done_a = ra.x, ra.elem, ra.done
    x2, elem2, done_b, s_b = move_step_continue(
        mesh, x, elem, dests, flying, weights, flux, tol=tol,
        max_iters=max_iters,
    )
    return x2, elem2, done_a & done_b, s_b


class PumiTally:
    """Track-length tally over an unstructured tet mesh.

    Args:
      mesh: a ``TetMesh`` (moved to ``device`` and the working dtype),
        or the path of a ``.osh`` or ``.msh`` mesh file.
      num_particles: particle-batch capacity.
      config: engine knobs; see ``TallyConfig``.
      device: "cuda" (default) or "cpu".
    """

    def __init__(self, mesh: Union[TetMesh, str],
                 num_particles: int = 100_000,
                 config: Optional[TallyConfig] = None, device: Any = None):
        t0 = time.perf_counter()
        mesh = self._init_common(mesh, num_particles, config, device)
        # Seed every particle at the centroid of element 0, as the
        # reference does: localization then happens by walking.
        c0 = mesh.coords[mesh.tet2vert[0].long()].mean(dim=0)
        self.x = c0.expand(self.num_particles, 3).contiguous()
        self.elem = torch.zeros((self.num_particles,), dtype=torch.int32,
                                device=self.device)
        self.flux = torch.zeros((mesh.nelems,), dtype=self.dtype,
                                device=self.device)
        self._sync()
        self.tally_times.initialization_time += time.perf_counter() - t0

    def _init_common(self, mesh, num_particles, config, device,
                     lowp_mesh: bool = True) -> TetMesh:
        """Shared construction: config, device, working dtype, mesh.
        ``lowp_mesh``: a facade whose walks read ``self.mesh`` takes the
        two-tier tables when the configured tier is bf16 (the
        partitioned facade builds its own block tables instead)."""
        self.config = config or TallyConfig()
        self.device = resolve_device(device)
        if isinstance(mesh, str):
            # A mesh file is built in the config's dtype (float32 when
            # it sets none, the JAX package's default off x64 mode).
            self.dtype = (torch.float32 if self.config.dtype is None
                          else self.config.dtype)
            mesh = load_mesh(mesh, dtype=self.dtype)
        else:
            # A prebuilt mesh fixes the working dtype unless the config
            # asks for one explicitly.
            self.dtype = mesh.dtype if self.config.dtype is None \
                else self.config.dtype
        mesh = mesh.to(dtype=self.dtype, device=self.device)
        if lowp_mesh and self.config.resolved_table_dtype() == "bfloat16":
            mesh = mesh.with_lowp_tables()
        elif lowp_mesh:
            # The float32 tier walks a two-tier mesh's full-precision
            # planes, as the JAX walk does.
            mesh = mesh.with_packed_table()
        self.mesh = mesh
        self.num_particles = int(num_particles)
        self._tol = self.config.resolved_tolerance(self.dtype)
        self._max_iters = self.config.resolved_max_iters(self.mesh.nelems)
        self.iter_count = 0
        self.is_initialized = False
        self.tally_times = TallyTimes()
        self._lost_total = 0
        return self.mesh

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- staging helpers -------------------------------------------------
    def _as_positions(self, buf, size: Optional[int],
                      what: str = "positions") -> torch.Tensor:
        """[n,3] working-dtype tensor on the device, checked finite after
        the cast."""
        a = host_positions(buf, size, self.num_particles)
        cast = np.asarray(a.reshape(self.num_particles, 3),
                          dtype=_np_dtype(self.dtype))
        check_finite(cast, what)
        return torch.from_numpy(cast.copy()).to(self.device)

    def _stage_flying(self, flying) -> torch.Tensor:
        n = self.num_particles
        if flying is None:
            return torch.ones((n,), dtype=torch.int8, device=self.device)
        flying_np = np.asarray(flying)
        if flying_np.size < n:
            raise ValueError(
                f"flying buffer has {flying_np.size} values, need {n}"
            )
        # Copy BEFORE the caller's buffer is zeroed below.
        fly = np.array(flying_np.reshape(-1)[:n], dtype=np.int8)
        return torch.from_numpy(fly).to(self.device)

    def _stage_weights(self, weights) -> torch.Tensor:
        n = self.num_particles
        if weights is None:
            return torch.ones((n,), dtype=self.dtype, device=self.device)
        w = np.asarray(host_scalar_field(weights, n, "weights"),
                       dtype=_np_dtype(self.dtype))
        check_finite(w, "weights")
        return torch.from_numpy(w.copy()).to(self.device)

    # -- the three-call protocol ----------------------------------------
    def CopyInitialPosition(self, init_particle_positions,
                            size: Optional[int] = None):
        """Localize particles to the host app's sampled source points
        (reference PumiTally.h:66-67; non-tallying initial search)."""
        t0 = time.perf_counter()
        # Fold the closing batch's still-lost particles into the
        # cumulative counter before the new localization resets them.
        self._lost_total += self._current_lost()
        dest = self._as_positions(init_particle_positions, size)
        found_all, n_exited = self._dispatch_localize(dest)
        if self.config.check_found_all:
            if not found_all:
                print(
                    "ERROR: Not all particles are found. May need more loops "
                    "in search"
                )
            if n_exited:
                print(
                    f"WARNING: {n_exited} particles exited the domain during "
                    "localization (non-convex mesh?); they were clamped to "
                    "the boundary"
                )
        self.is_initialized = True
        self._sync()
        self.tally_times.initialization_time += time.perf_counter() - t0

    def _dispatch_localize(self, dest: torch.Tensor):
        """Non-tallying localization; returns (found_all, n_exited)."""
        x, elem = self.x, self.elem
        if self.config.localization == "locate":
            # Half-space point location first: located particles enter
            # the walk already at their destination and retire at once.
            x, elem = adopt_located(x, elem, dest, locate_by_planes(
                self.mesh.face_normals, self.mesh.face_offsets, dest,
                self._tol,
            ))
        self.x, self.elem, done, exited = _localize_step(
            self.mesh, x, elem, dest, tol=self._tol,
            max_iters=self._max_iters,
        )
        return bool(done.all()), int(exited.sum())

    def MoveToNextLocation(self, particle_origin, particle_destinations,
                           flying=None, weights=None,
                           size: Optional[int] = None):
        """Two-phase tracked move (reference PumiTally.h:87-89).

        ``particle_origin=None`` continues from the committed positions
        (phase A skipped); ``flying=None`` means every particle flies
        (nothing to zero); ``weights=None`` means unit weights."""
        if not self.is_initialized:
            raise RuntimeError(
                "CopyInitialPosition must be called before MoveToNextLocation "
                "(reference invariant, PumiTallyImpl.cpp:437-438)"
            )
        t0 = time.perf_counter()
        dests = self._as_positions(particle_destinations, size,
                                   "destinations")
        origins = (None if particle_origin is None
                   else self._as_positions(particle_origin, size, "origins"))
        fly = self._stage_flying(flying)
        w = self._stage_weights(weights)
        zero_flying_side_effect(flying, self.num_particles)
        found_all = self._dispatch_move(origins, dests, fly, w)
        self.iter_count += 1
        if self.config.check_found_all and not found_all:
            print("ERROR: Not all particles are found. May need more loops in search")
        self._sync()
        self.tally_times.total_time_to_tally += time.perf_counter() - t0

    def _dispatch_move(self, origins, dests, fly, w) -> bool:
        """One tallied move from staged inputs (origins None: continue
        mode). Returns whether every particle finished."""
        if origins is None:
            self.x, self.elem, done, _ = move_step_continue(
                self.mesh, self.x, self.elem, dests, fly, w, self.flux,
                tol=self._tol, max_iters=self._max_iters,
            )
        else:
            self.x, self.elem, done, _ = move_step(
                self.mesh, self.x, self.elem, origins, dests, fly, w,
                self.flux, tol=self._tol, max_iters=self._max_iters,
            )
        return bool(done.all())

    def WriteTallyResults(self, filename: Optional[str] = None) -> None:
        """Normalize flux by element volume and write a legacy VTK file
        (reference PumiTallyImpl.cpp:151-157, 382-416)."""
        t0 = time.perf_counter()
        write_vtk(
            filename or self.config.output_filename,
            self.mesh.coords.cpu().numpy(),
            self.mesh.tet2vert.cpu().numpy(),
            cell_data=merge_cell_data({
                "flux": self.normalized_flux().cpu().numpy(),
                "volume": self.mesh.volumes.cpu().numpy(),
            }),
            field_data=self._vtk_field_data(),
        )
        self.tally_times.vtk_file_write_time += time.perf_counter() - t0
        self.tally_times.print_times()

    def _vtk_field_data(self) -> dict:
        """Campaign-level payload: the cumulative lost-particle count."""
        return {"lost_particles": np.asarray([float(self.lost_particles)],
                                             np.float64)}

    # -- leakage accounting ----------------------------------------------
    def _current_lost(self) -> int:
        """Particles currently excluded from transport. This engine
        clamps out-of-hull sources to the boundary instead of dropping
        them, so only the partitioned facade overrides this."""
        return 0

    @property
    def lost_particles(self) -> int:
        """Cumulative count of particles excluded from transport."""
        return self._lost_total + self._current_lost()

    # -- inspection ------------------------------------------------------
    def normalized_flux(self) -> torch.Tensor:
        """flux / element volume (NOT divided by total weight, matching
        the reference's code rather than its README)."""
        return self.flux / self.mesh.volumes

    @property
    def elem_ids(self) -> np.ndarray:
        """Current element of each particle."""
        return self.elem.cpu().numpy()[: self.num_particles]

    @property
    def positions(self) -> np.ndarray:
        """Committed particle positions."""
        return self.x.cpu().numpy()[: self.num_particles]


def _np_dtype(dtype: torch.dtype):
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]
