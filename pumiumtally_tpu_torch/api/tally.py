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

Staging follows the JAX facade (api/tally.py:533-640, :1156-1295): the
``auto_continue`` origin-echo upload skip with its disarm/re-arm state
machine, the device all-ones and weights caches, ``validate_inputs``
and ``fenced_timing``. Each caller buffer is cast and copied in one pass
into a page-locked buffer and uploaded without blocking (api/staging.py).
The phase-A skip is decided on the device (W0's ``skip`` flag) and the
found-all verdict is fetched only when ``check_found_all`` is on, so with
``check_found_all=False, fenced_timing=False`` a continue move and an
echoing two-phase move make no host synchronization.

Filtered scoring (``TallyConfig.scoring``, a ``ScoringSpec``) follows
the JAX facade (api/tally.py:849-1062): ``MoveToNextLocation`` takes
``energy=`` / ``time=`` (refused, naming the argument, where the spec
reads no such attribute or needs one that is missing), stages them
through the pinned path, resolves each particle's bin on the device and
hands the bank to the walk (W0's scoring instantiation), so staging
stays sync-free: an unfenced, unchecked continue move with scoring makes
no host synchronization. ``score_bank`` / ``score_array()`` read the
lanes. Batch statistics (``TallyConfig.batch_stats``): each
``CopyInitialPosition`` closes the open batch and opens the next;
``close_batch()`` / ``finalize()`` close one explicitly;
``batch_statistics()`` and, with scoring, ``score_statistics()`` read
the lanes. ``WriteTallyResults`` adds ``flux_mean``/``rel_err`` and
``<score>_bin<k>`` cell arrays beside flux and volume. With both off
nothing of either is constructed.

Runtime sentinels (``TallyConfig.sentinel``, a ``SentinelPolicy``;
sentinel/): each move is audited on the device (one scalar fetch), its
stragglers go through the escalation ladder (W0 at a multiplied budget
continuing the exact ray parametrisation, then, on a two-tier mesh, the
full-precision planes), the unrecoverable ones are counted in
``lost_particles`` and quarantined, and ``health_report()`` returns the
cumulative ``HealthReport`` (also in the VTK FIELD data). A
localization's stragglers go through the same ladder at zero weight.
With ``sentinel=None`` nothing of it is constructed and no path changes.

``TallyConfig(record_xpoints=True)``: the move keeps its staged inputs
and ``intersection_points()`` replays it (``ops.walk.walk_xpoints``),
the reference's ``getIntersectionPoints()``; the partitioned and
streaming facades refuse it, as the JAX facades do.

Fault tolerance (``TallyConfig.checkpoint``, a ``CheckpointPolicy``;
resilience/, the JAX facade's api/tally.py:637-686): every facade calls
the autosave runner at batch close (each ``CopyInitialPosition`` that
closes a non-empty batch, ``close_batch``, ``finalize``) and at the end
of each move, which saves atomic, digest-sealed generations at the
policy's cadence and drains on SIGTERM/SIGINT; ``checkpoint_now()``
writes one now and ``resume_latest()`` restores the newest intact one.
With a policy the tallying walks commit through the deterministic
commit (ops/det_commit.py), so a resumed run equals an uninterrupted one
bit for bit on the card too. A partitioned engine whose overflow ladder
is exhausted writes an ``overflow_safety`` generation before the
poisoned refusal (``on_poisoned``).

The facades run on ``device="cuda"`` by default and raise when no GPU is
present, unless the caller asks for ``device="cpu"`` (where every
kernel's plain PyTorch version runs). The poisoned latch (the JAX
facade's): once a partitioned engine's overflow-recovery ladder is
exhausted, every protocol call refuses with ``EnginePoisonedError``,
checked before anything else.

With ``TallyConfig(device_mesh=...)`` (a ``parallel.DeviceMesh``) the
capacity pads to a multiple of the mesh size (padded slots never fly)
and localization and both moves run sharded (parallel/sharded.py): each
shard walks its slice on its own device against its copy of the mesh,
and the flux (and bank) deltas are summed in fixed shard order.
``flux``, ``positions``, ``elem_ids`` and the bank are whole, in caller
order. Sharded facades never fuse; ``intersection_points`` refuses a
mesh, as in the JAX package.

The service-fusion surface (service/fusion.py, the JAX facade's
api/tally.py:1368-1470): ``_fusion_key`` names the moves that may share
one fused launch, ``_fused_move_stage`` stages a service op's move on
the host without touching the facade's state, ``_fused_move_commit``
adopts its slice of the shared launch and runs the solo move's post-walk
sequence; ``arm_deterministic`` switches the deterministic commit on
(every service session walks with it, so each equals its solo run bit
for bit on the card). Facades built from one caller ``TetMesh`` in the
same dtype, device and tier share one converted mesh (``shared_mesh``),
so their moves can fuse and they hold one copy of the tables.
"""

from __future__ import annotations

import threading
import time
import warnings
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from pumiumtally_tpu_torch.api.staging import (  # noqa: F401 (re-export)
    HostStaging,
    check_finite,
)
from pumiumtally_tpu_torch.config import TallyConfig
from pumiumtally_tpu_torch.io.load import load_mesh
from pumiumtally_tpu_torch.io.vtk import (
    health_field_data,
    merge_cell_data,
    stats_cell_data,
    write_vtk,
)
from pumiumtally_tpu_torch.mesh.tetmesh import TetMesh
from pumiumtally_tpu_torch.ops.det_commit import DetWorkspace
from pumiumtally_tpu_torch.ops.geometry import locate_by_planes
from pumiumtally_tpu_torch.ops.walk import walk, walk_xpoints
from pumiumtally_tpu_torch.parallel.sharded import (
    ShardLayout,
    replicate_mesh,
    sharded_locate,
    sharded_localize_step,
    sharded_move_step,
    sharded_move_step_continue,
)
from pumiumtally_tpu_torch.resilience import AutosaveRunner, resume_latest
from pumiumtally_tpu_torch.scoring.binding import (
    ScoringRuntime,
    score_cell_data,
)
from pumiumtally_tpu_torch.sentinel.policy import (  # noqa: F401 (re-export)
    POISONED_MESSAGE,
    EnginePoisonedError,
)
from pumiumtally_tpu_torch.sentinel.quarantine import (
    append_quarantine,
    build_records,
)
from pumiumtally_tpu_torch.sentinel.runner import build_runner
from pumiumtally_tpu_torch.sentinel.straggler import run_ladder
from pumiumtally_tpu_torch.stats import (
    BatchAccumulator,
    BatchStatistics,
    evaluate_trigger,
)
from pumiumtally_tpu_torch.utils.profiling import span


# MoveToNextLocation's ``time`` keyword (the TimeFilter attribute)
# shadows the module inside that method.
_perf_counter = time.perf_counter

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _np_dtype(dtype: torch.dtype):
    return np.dtype(_NP_DTYPES[dtype])


# Consecutive origin-echo misses after which a facade stops paying for
# echo snapshots (the caller has proven it resamples every move).
_ECHO_MISS_LIMIT = 8
# While disarmed, one snapshot is retained every this-many moves so the
# next move can probe again: a caller that echoes intermittently
# regains the upload skip within a period.
_ECHO_REARM_PERIOD = 64


@dataclass
class TallyTimes:
    """Per-phase wall-clock accumulation (reference PumiTallyImpl.h:18-27).
    With ``fenced_timing`` (the default) every protocol call
    synchronizes the device before its end stamp."""

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


# Converted meshes shared by the facades built from one caller mesh
# (``shared_mesh``): held weakly, so the last facade's end frees them.
_SHARED_MESHES: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()
_SHARED_SOURCES: dict = {}
_SHARED_LOCK = threading.Lock()


def shared_mesh(src: TetMesh, dtype: torch.dtype, device: torch.device,
                tier: str, build: Callable[[], TetMesh]) -> TetMesh:
    """The facade mesh converted from the caller's ``src`` for
    ``(dtype, device, tier)``: built by ``build()`` once and shared by
    every facade built from the same ``src`` object while one of them
    lives. The service keys fusion on the facade mesh's identity (the
    JAX facade's ``id(self.mesh)``), so sessions opened on one caller
    mesh co-fuse, and they hold one copy of the tables."""
    key = (id(src), dtype, str(device), tier)
    with _SHARED_LOCK:
        ref = _SHARED_SOURCES.get(key)
        mesh = _SHARED_MESHES.get(key)
        if mesh is not None and ref is not None and ref() is src:
            return mesh
        mesh = build()
        for k in [k for k, r in _SHARED_SOURCES.items() if r() is None]:
            del _SHARED_SOURCES[k]
        _SHARED_MESHES[key] = mesh
        _SHARED_SOURCES[key] = weakref.ref(src)
        return mesh


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


def read_on_host(t, kind=bool):
    """``kind(t)`` of a device scalar: the host waits for the device to
    produce it (a ``ptt.sync`` span)."""
    with span("ptt.sync"):
        return kind(t)


def zero_flying_side_effect(flying, n: int) -> None:
    """Zero the caller's flying buffer in place after staging (the
    reference's documented host side effect, cpp:169-172). Unwritable
    buffers get a warning, never a silent skip. A contiguous array is
    zeroed through a flat view: ``ndarray.flat`` (which writes through
    any strides) takes milliseconds per 500,000 flags."""
    if isinstance(flying, np.ndarray):
        if flying.flags.writeable and flying.flags.c_contiguous:
            flying.reshape(-1)[:n] = 0
        elif flying.flags.writeable:
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


def owned_snapshot(keep: Optional[np.ndarray], src: np.ndarray) -> np.ndarray:
    """``src``'s values in a host array the facade owns: ``keep`` refilled
    when it has the shape and dtype, else a new copy. The caller drops
    its reference to ``keep`` before the refill."""
    if keep is None or keep.shape != src.shape or keep.dtype != src.dtype:
        return src.copy()
    np.copyto(keep, src)
    return keep


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
                       max_iters, scoring=None, deterministic=False,
                       tally_seg=None):
    """Phase-B-only move: transport from the committed state straight
    to the destinations, tallying into ``flux`` (in place) and, with
    ``scoring=(kinds, bank, bin_off, fac)``, into the bank (through the
    deterministic commit with ``deterministic``). ``tally_seg``: the
    walk's segmented commit (``flux`` then concatenates several
    sessions' banks; the service's fused move). Returns (x, elem, done,
    s)."""
    dest_b = torch.where((flying == 1)[:, None], dests, x)  # stopped: hold
    rb = walk(mesh, x, elem, dest_b, flying, weights, flux, tally=True,
              tol=tol, max_iters=max_iters, scoring=scoring,
              deterministic=deterministic, tally_seg=tally_seg)
    return rb.x, rb.elem, rb.done, rb.s


def move_step(mesh, x, elem, origins, dests, flying, weights, flux, *, tol,
              max_iters, scoring=None, deterministic=False, tally_seg=None):
    """One full MoveToNextLocation: phase A (relocate, no tally) then
    phase B (transport, tally). Phase A walks nothing when every staged
    origin already equals the committed position (it would walk zero
    distance for everyone), decided on the device: the JAX move's
    ``lax.cond(trivial, skip_a, run_a)`` as W0's ``skip`` flag. Returns
    (x, elem, done, s). Phase A never scores nor tallies; ``tally_seg``
    reaches phase B."""
    dest_a = torch.where((flying == 1)[:, None], origins, x)
    ra = walk(mesh, x, elem, dest_a, flying, torch.zeros_like(weights),
              None, tally=False, tol=tol, max_iters=max_iters,
              skip=(dest_a == x).all())
    x, elem, done_a = ra.x, ra.elem, ra.done
    x2, elem2, done_b, s_b = move_step_continue(
        mesh, x, elem, dests, flying, weights, flux, tol=tol,
        max_iters=max_iters, scoring=scoring, deterministic=deterministic,
        tally_seg=tally_seg,
    )
    return x2, elem2, done_a & done_b, s_b


@dataclass
class FusedMoveStage:
    """One session's share of a fused cross-session launch (the JAX
    facade's ``FusedMoveStage``): the host half of a move, made by
    ``PumiTally._fused_move_stage`` and packed by service/fusion.py.
    Positions and weights are HOST arrays in the working dtype (None
    weights / flying: the unit defaults); the scoring operands are the
    device tensors a solo move would resolve (None with scoring off).
    ``x_prev`` is the committed positions before the move: the phase-B
    start the sentinel's audit needs in continue mode."""

    dests: np.ndarray  # [n,3] working dtype, host
    origins: Optional[np.ndarray]  # [n,3] host, None: continue mode
    fly: Optional[np.ndarray]  # [n] int8 host, None: all in flight
    w: Optional[np.ndarray]  # [n] working dtype host, None: unit
    sbin: Optional[torch.Tensor]  # [n] int32 device (scoring only)
    sfac: Optional[torch.Tensor]  # [n,S] device (scoring only)
    x_prev: Optional[torch.Tensor] = None


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
        # The internal capacity: padded up to a multiple of the device
        # mesh so the particles shard evenly.
        dm = self.config.device_mesh
        self._cap = self.num_particles
        if dm is not None:
            self._cap = ShardLayout.padded(self.num_particles, dm)
            self._shard_over(dm, self._cap, mesh)
        # Seed every particle at the centroid of element 0, as the
        # reference does: localization then happens by walking.
        c0 = mesh.coords[mesh.tet2vert[0].long()].mean(dim=0)
        self.x = c0.expand(self._cap, 3).contiguous()
        self.elem = torch.zeros((self._cap,), dtype=torch.int32,
                                device=self.device)
        self.flux = torch.zeros((mesh.nelems,), dtype=self.dtype,
                                device=self.device)
        self._arm_scoring()
        if self._scoring is not None:
            self._score_bank = self._scoring.zero_bank()
        self._sync()
        self.tally_times.initialization_time += time.perf_counter() - t0

    def _init_common(self, mesh, num_particles, config, device,
                     lowp_mesh: bool = True) -> TetMesh:
        """Shared construction: config, device, working dtype, mesh.
        ``lowp_mesh``: a facade whose walks read ``self.mesh`` takes the
        two-tier tables when the configured tier is bf16 (the
        partitioned facade builds its own block tables instead)."""
        self.config = config or TallyConfig()
        dm = self.config.device_mesh
        if dm is not None and device is None:
            device = dm.home
        self.device = resolve_device(device)
        if dm is not None and dm.home.type != self.device.type:
            raise ValueError(
                f"the device mesh's home device {dm.home} and the facade's "
                f"device {self.device} differ")
        # Particles sharded over a device mesh (``_shard_over``); None:
        # one device.
        self._shards = None
        self._shard_meshes = None
        if isinstance(mesh, str):
            # A mesh file is built in the config's dtype (float32 when
            # it sets none, the JAX package's default off x64 mode).
            self.dtype = (torch.float32 if self.config.dtype is None
                          else self.config.dtype)
            mesh = self._facade_mesh(load_mesh(mesh, dtype=self.dtype),
                                     lowp_mesh)
        else:
            # A prebuilt mesh fixes the working dtype unless the config
            # asks for one explicitly.
            self.dtype = mesh.dtype if self.config.dtype is None \
                else self.config.dtype
            src = mesh
            mesh = shared_mesh(
                src, self.dtype, self.device,
                self.config.resolved_table_dtype() if lowp_mesh else "",
                lambda: self._facade_mesh(src, lowp_mesh))
        self.mesh = mesh
        self.num_particles = int(num_particles)
        self._tol = self.config.resolved_tolerance(self.dtype)
        self._max_iters = self.config.resolved_max_iters(self.mesh.nelems)
        self.iter_count = 0
        self.is_initialized = False
        self.tally_times = TallyTimes()
        self._lost_total = 0
        self._staging = HostStaging(self.device)
        # Auto-continue bookkeeping: the working-dtype destinations of
        # the previous move, as an owned host array (the echo compare)
        # and as the device tensor that staged them (substituted for the
        # caller's origins on an echo). Reset whenever something other
        # than a move changes particle state.
        self._last_dests_host: Optional[np.ndarray] = None
        self._last_dests_dev = None
        # Pure input caches: device all-ones flying/weights, and the
        # previous move's weights for the unchanged-weights echo.
        self._ones_cache: dict = {}
        self._last_weights_host: Optional[np.ndarray] = None
        self._last_weights_dev = None
        self.auto_continue_hits = 0  # moves that skipped the origin upload
        self._echo_misses = 0  # consecutive non-echo moves
        # Batch statistics over the [E] flux (None: off). Scoring is
        # armed by each facade once its bank geometry is known
        # (``_arm_scoring``).
        self._stats = (BatchAccumulator(mesh.nelems, self.dtype, self.device)
                       if self.config.batch_stats else None)
        self._scoring = None
        self._score_bank = None
        self._score_stats = None
        # The sentinel's runner (None: off, nothing constructed) and the
        # last move's staged inputs for intersection_points().
        self._sentinel = build_runner(self.config.sentinel, self.dtype,
                                      self.device)
        self._xpoint_stash = None
        # Fault tolerance: the autosave/drain runner (None: no policy, no
        # handler installed), and the record streams of the deterministic
        # commit it needs (the walks' ``deterministic=``).
        self._resilience = self._deterministic = None
        if self.config.checkpoint is not None:
            self._resilience = AutosaveRunner(self.config.checkpoint)
            self._deterministic = DetWorkspace()
        return self.mesh

    def _shard_over(self, device_mesh, cap: int, mesh: TetMesh) -> None:
        """Shard ``cap`` particle slots over ``device_mesh``, with the
        mesh tables copied once to each distinct device."""
        self._shards = ShardLayout(device_mesh, cap)
        self._shard_meshes = replicate_mesh(mesh, self._shards)

    def _pad_particles(self, a: Optional[torch.Tensor], tail,
                       cap: Optional[int] = None):
        """A staged [n,...] array padded to the capacity ``cap`` (the
        facade's by default) with ``tail``'s rows past n (a tensor of the
        capacity's rows, or a fill value)."""
        cap = self._cap if cap is None else cap
        if a is None or a.shape[0] == cap:
            return a
        if not isinstance(tail, torch.Tensor):
            tail = torch.full((cap,) + tuple(a.shape[1:]), tail,
                              dtype=a.dtype, device=a.device)
        return torch.cat([a, tail[a.shape[0]:cap].to(a.device)])

    def _adopt_positions(self, x: torch.Tensor, elem: torch.Tensor) -> None:
        """Commit caller-order [n] positions and elements (a restore):
        padded slots keep theirs."""
        self.x = self._pad_particles(x, self.x)
        self.elem = self._pad_particles(elem, self.elem)

    def _facade_mesh(self, mesh: TetMesh, lowp_mesh: bool) -> TetMesh:
        """The caller's mesh in the working dtype on the device, with the
        tables of the configured tier when ``lowp_mesh``."""
        mesh = mesh.to(dtype=self.dtype, device=self.device)
        if lowp_mesh and self.config.resolved_table_dtype() == "bfloat16":
            return mesh.with_lowp_tables()
        if lowp_mesh:
            # The float32 tier walks a two-tier mesh's full-precision
            # planes, as the JAX walk does: packed once here, so every
            # move runs the packed W0 (a call-time tier reads them in
            # place, ops.walk.mesh_for_tier).
            return mesh.with_packed_table()
        return mesh

    def _engine_poisoned(self) -> bool:
        """Whether this tally's engine state is known-corrupt: only a
        partitioned engine's exhausted recovery ladder latches it, so
        the partitioned facades override this with their engines'
        latches."""
        return False

    def _wire_engine_hooks(self, engine) -> None:
        """Connect a partitioned engine's overflow-recovery ladder to the
        facade: recoveries report into the sentinel's health record, and
        an exhausted ladder writes a safety generation (the intact
        pre-overflow state) right before the poisoned raise."""
        if self._sentinel is not None:
            engine.on_overflow_recovered = \
                self._sentinel.note_overflow_recovery
        engine.on_poisoned = self._overflow_safety_save

    def _overflow_safety_save(self) -> None:
        if self._resilience is not None:
            self._resilience.save(self, reason="overflow_safety")

    # -- fault tolerance (TallyConfig.checkpoint) ------------------------
    def _resilience_roll_batch(self) -> None:
        """Batch-close hook of the autosave runner: every
        ``CopyInitialPosition`` that closes a non-empty batch (and
        ``close_batch`` / ``finalize``), before the lost counter rolls and
        new sources rewrite the state, so a saved generation is the
        closed batch's end state."""
        if self._resilience is not None:
            self._resilience.on_batch_close(self)

    def _resilience_note_move(self) -> None:
        """Move-end hook: the drain's safety point and the
        ``every_seconds`` cadence check."""
        if self._resilience is not None:
            self._resilience.on_move(self)

    def checkpoint_now(self, **meta):
        """Write one checkpoint generation now through the configured
        ``TallyConfig.checkpoint`` policy (e.g. the seal after a
        campaign's last batch, which no re-sourcing closes); returns
        (generation, path). Keyword arguments ride in the generation's
        metadata (the runner's reason/iter_count/batches_closed win). A
        pending drain request exits cleanly (code 0) after the save."""
        if self._resilience is None:
            raise RuntimeError(
                "checkpoint_now() needs TallyConfig(checkpoint="
                "resilience.CheckpointPolicy(...)); for one-off manual "
                "saves use utils.checkpoint.save_tally_state")
        out = self._resilience.save(self, reason="manual", meta=meta)
        if self._resilience.drain_requested:
            self._resilience.close()  # hand the signals back
            raise SystemExit(0)
        return out

    def resume_latest(self):
        """Restore the newest intact generation of the configured
        policy's directory into this tally (falling back past corrupt
        ones); returns the ``resilience.ResumeInfo``, or None when no
        generation exists yet."""
        return resume_latest(self)

    def _check_poisoned(self) -> None:
        if self._engine_poisoned():
            raise EnginePoisonedError(POISONED_MESSAGE)

    # -- runtime sentinels (TallyConfig.sentinel) ------------------------
    def health_report(self):
        """The cumulative ``sentinel.HealthReport`` of this campaign
        (audited moves, anomaly mask union, worst conservation residual,
        straggler and overflow ladder outcomes). Requires
        ``TallyConfig(sentinel=SentinelPolicy(...))``."""
        if self._sentinel is None:
            raise RuntimeError(
                "runtime sentinels are disabled; construct the tally "
                "with TallyConfig(sentinel=sentinel.SentinelPolicy())"
            )
        return self._sentinel.health_report()

    def _sentinel_post_move(self, x_start, dests, fly, w, done, s_b,
                            sbin=None, sfac=None):
        """Audit one committed move and run the straggler ladder over its
        unfinished residue. ``x_start``: the phase-B start (the staged
        origins, or the committed positions before a continue move);
        ``s_b``: phase B's ray coordinates; with them the retry continues
        the exact parametrisation. Returns the found-all verdict."""
        n_unf, mask = self._sentinel.audit(x_start, self.x, fly, w, done,
                                           self.flux)
        recovered = lost = 0
        ok = done.all()
        if n_unf and self.config.sentinel.straggler_retry:
            self.x, self.elem, recovered, lost = self._recover_move(
                self.x, self.elem, self.flux, self._score_bank, done,
                x_start, dests, fly, w, s_b, sbin, sfac, self.iter_count)
            # The ladder tallied after the audit took the flux sum.
            self._sentinel.resync(self.flux)
            ok = lost == 0
        self._sentinel.note_outcome(mask, n_unf, recovered, lost,
                                    self.iter_count)
        return ok

    def _recover_move(self, x, elem, flux, bank, done, x_start, dests, fly,
                      w, s_b, sbin, sfac, move: int, pid_offset: int = 0):
        """The straggler ladder over one move's (or one chunk's)
        unfinished flying particles, tallying into ``flux`` (and
        ``bank``) in place; the lost ones are counted in
        ``lost_particles`` and quarantined. Returns ``(x, elem,
        recovered, lost)``."""
        unfinished = (~done & (fly == 1)).cpu().numpy()
        if not unfinished.any():
            return x, elem, 0, 0
        x, elem, rec_idx, lost_idx = run_ladder(
            self.mesh, x, elem, dests, fly, w, flux, unfinished,
            tol=self._tol, base_iters=self._max_iters,
            retry_factor=self.config.sentinel.retry_iters_factor,
            two_tier=self.mesh.two_tier, x_start=x_start, s_init=s_b,
            scoring=self._score_ops(bank, sbin, sfac),
            deterministic=self._deterministic)
        if lost_idx.size:
            self._lost_total += int(lost_idx.size)
            self._quarantine_lost(lost_idx, x_start, dests, w, elem, move,
                                  pid_offset)
        return x, elem, int(rec_idx.size), int(lost_idx.size)

    def _quarantine_lost(self, idx: np.ndarray, x_start, dests, w, elem,
                         move: int, pid_offset: int = 0) -> None:
        """One quarantine record per unrecoverable particle (pid, origin,
        dest, element, weight, move); the file only with a
        ``quarantine_dir`` (the report counts them either way)."""
        sel = torch.as_tensor(idx, device=self.device)
        append_quarantine(
            self.config.sentinel.quarantine_dir,
            build_records(idx, x_start[sel].cpu().numpy(),
                          dests[sel].cpu().numpy(), elem[sel].cpu().numpy(),
                          w[sel].cpu().numpy(), move, pid_offset=pid_offset))

    def _sentinel_post_localize(self, x, elem, dest, done, flux):
        """The localization ladder: unfinished particles are re-walked
        with the escalated budget at zero weight (``flux`` is untouched).
        Returns ``(x, elem, done)``."""
        if self._sentinel is None or not self.config.sentinel.straggler_retry:
            return x, elem, done
        unfinished = (~done).cpu().numpy()
        if not unfinished.any():
            return x, elem, done
        n = unfinished.size
        x, elem, rec_idx, lost_idx = run_ladder(
            self.mesh, x, elem, dest,
            torch.ones((n,), dtype=torch.int8, device=self.device),
            torch.zeros((n,), dtype=self.dtype, device=self.device), flux,
            unfinished, tol=self._tol, base_iters=self._max_iters,
            retry_factor=self.config.sentinel.retry_iters_factor,
            two_tier=self.mesh.two_tier)
        self._sentinel.note_localization(rec_idx.size, lost_idx.size)
        done = done.clone()
        done[torch.as_tensor(rec_idx, device=self.device)] = True
        return x, elem, done

    def _sync(self) -> None:
        with span("ptt.sync"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def _fence(self) -> None:
        """The end-of-call fence of ``TallyConfig.fenced_timing``."""
        if self.config.fenced_timing:
            self._sync()

    # -- staging helpers -------------------------------------------------
    def _position_spec(self, a: np.ndarray, name: str, what: Optional[str]):
        """Staging spec of a flat [3n] float64 host array as [n,3] in the
        working dtype, checked finite after the cast (``what=None``: not
        checked)."""
        n = self.num_particles

        def fill(dst: np.ndarray) -> None:
            self._staging.cast(dst, a, what if self.config.validate_inputs
                               else None)

        return (name, (n, 3), self.dtype, fill)

    def _stage_positions(self, a: np.ndarray, name: str,
                         what: Optional[str]) -> torch.Tensor:
        return self._staging.stage(name, [self._position_spec(a, name,
                                                              what)])[0]

    def _cached_ones(self, kind: str) -> torch.Tensor:
        """Device all-ones [n] (int8 flying / working-dtype weights),
        allocated once and reused every move (never written to)."""
        a = self._ones_cache.get(kind)
        if a is None:
            dt = torch.int8 if kind == "fly" else self.dtype
            a = torch.ones((self.num_particles,), dtype=dt,
                           device=self.device)
            self._ones_cache[kind] = a
        return a

    def _origins_echo_raw(self, raw: Optional[np.ndarray]) -> bool:
        """The echo rule (JAX ``_origins_echo_raw``): the caller's
        origins, cast to the working dtype, equal the previous move's
        destinations bit for bit. Counts the hit. A 64-point strided
        sample is compared before the whole batch, so origin streams
        that never echo pay almost nothing; after _ECHO_MISS_LIMIT
        consecutive misses the snapshots are dropped (see
        ``_retain_echo_snapshots``)."""
        if raw is None or not self.config.auto_continue:
            return False
        if self._last_dests_host is None:
            # Nothing to compare against (start of a batch, or
            # disarmed): the move still counts, so the periodic re-arm
            # clock advances.
            self._echo_misses += 1
            return False
        prev = self._last_dests_host  # [n,3] working dtype, owned
        n = self.num_particles
        raw = raw.reshape(n, 3)
        idx = np.linspace(0, n - 1, num=min(n, 64), dtype=np.int64)
        with span("ptt.echo"):
            hit = np.array_equal(
                np.asarray(raw[idx], dtype=prev.dtype), prev[idx]
            ) and np.array_equal(np.asarray(raw, dtype=prev.dtype), prev)
        if hit:
            self.auto_continue_hits += 1
            self._echo_misses = 0
            return True
        self._echo_misses += 1
        if self._echo_misses >= _ECHO_MISS_LIMIT:
            # A caller that resamples every move: stop paying for
            # snapshots it never hits until CopyInitialPosition or a
            # periodic retry re-arms the detector.
            self._last_dests_host = None
            self._last_dests_dev = None
        return False

    def _retain_echo_snapshots(self) -> bool:
        """Whether this move's destinations are kept for the next move's
        echo check: origin-passing callers that have not proven
        themselves never-echoing, plus one retry snapshot per
        _ECHO_REARM_PERIOD while disarmed."""
        return self.config.auto_continue and (
            self._echo_misses < _ECHO_MISS_LIMIT
            or self._echo_misses % _ECHO_REARM_PERIOD
            == _ECHO_REARM_PERIOD - 1
        )

    def _stage_flying(self, flying) -> torch.Tensor:
        n = self.num_particles
        if flying is None:
            return self._cached_ones("fly")
        flying_np = np.asarray(flying)
        if flying_np.size < n:
            raise ValueError(
                f"flying buffer has {flying_np.size} values, need {n}"
            )
        fly = flying_np.reshape(-1)[:n].astype(np.int8, copy=False)
        if self.config.auto_continue and np.all(fly == 1):
            # All in flight, the common physics batch: the cached ones.
            return self._cached_ones("fly")
        # Staged (copied) BEFORE the caller's buffer is zeroed.
        return self._staging.stage("fly", [(
            "fly", (n,), torch.int8,
            lambda dst: np.copyto(dst, fly, casting="unsafe"),
        )])[0]

    def _stage_weights(self, weights) -> torch.Tensor:
        n = self.num_particles
        if weights is None:
            return self._cached_ones("w")
        w_raw = host_scalar_field(weights, n, "weights")
        prev = self._last_weights_host if self.config.auto_continue else None
        unchanged = False

        def fill(dst: np.ndarray) -> None:
            nonlocal unchanged
            # The weights' compare rides the cast's pass.
            unchanged = self._staging.cast(
                dst, w_raw,
                "weights" if self.config.validate_inputs else None, prev)

        (w_host,) = self._staging.fill("w", [("w", (n,), self.dtype, fill)])
        if unchanged:
            # Unchanged weights: the device tensor already holds them.
            return self._last_weights_dev
        (w,) = self._staging.upload("w")
        if self.config.auto_continue:
            keep, self._last_weights_host = self._last_weights_host, None
            self._last_weights_host = owned_snapshot(keep, w_host)
            self._last_weights_dev = w
        return w

    # -- batch statistics (TallyConfig.batch_stats) ----------------------
    def _stats_roll_batch(self) -> None:
        """Batch boundary: every ``CopyInitialPosition`` closes the open
        batch (if a move landed in it) and opens the next."""
        if self._stats is not None:
            self._close_lanes(reopen=True)

    def _close_lanes(self, reopen: bool) -> None:
        """Close the open batch of the flux lanes and, with scoring, of
        the bank's lanes."""
        self._stats.close(self.flux, reopen=reopen)
        if self._score_stats is not None:
            self._score_stats.close(self.score_bank, reopen=reopen)

    def _stats_note_move(self) -> None:
        if self._stats is not None:
            self._stats.note_move()
        if self._score_stats is not None:
            self._score_stats.note_move()

    def _require_stats(self) -> BatchAccumulator:
        if self._stats is None:
            raise RuntimeError(
                "batch statistics are disabled; construct the tally "
                "with TallyConfig(batch_stats=True)"
            )
        return self._stats

    def _stats_elapsed(self) -> Optional[float]:
        """Transport seconds for the figure of merit; None before any
        move."""
        t = self.tally_times.total_time_to_tally
        return t if t > 0.0 else None

    def close_batch(self, trigger=None):
        """Close the open batch into the statistics lanes and open the
        next (elementwise on the device, no host sync). With a
        ``TriggerSpec`` (passed, or ``TallyConfig.batch_stats_trigger``)
        the trigger is evaluated right after (one reduction and one
        scalar read) and its ``TriggerResult`` returned; else None. A
        batch with no move closes as a no-op."""
        with span("ptt.close_batch"):
            stats = self._require_stats()
            self._close_lanes(reopen=True)
            self._resilience_roll_batch()  # an explicit close closes a batch
            spec = trigger if trigger is not None \
                else self.config.batch_stats_trigger
            return None if spec is None else evaluate_trigger(stats, spec)

    def finalize(self) -> BatchStatistics:
        """Close the open batch without opening another and return the
        final ``BatchStatistics``; later moves belong to no batch until
        the next ``CopyInitialPosition`` (or ``close_batch``)."""
        self._require_stats()
        self._close_lanes(reopen=False)
        self._resilience_roll_batch()  # the final close is a batch close
        return self.batch_statistics()

    def batch_statistics(self) -> BatchStatistics:
        """The closed batches' ``BatchStatistics`` (>= 1 closed batch
        for ``mean``, >= 2 for the variance-derived fields)."""
        stats = self._require_stats()
        return BatchStatistics(
            flux_sum=stats.flux_sum, flux_sq_sum=stats.flux_sq_sum,
            num_batches=stats.num_batches,
            elapsed_seconds=self._stats_elapsed(),
        )

    # -- filtered scoring (TallyConfig.scoring) ---------------------------
    def _arm_scoring(self, bank_size: Optional[int] = None) -> None:
        """Build the ScoringRuntime once the facade's bank geometry is
        known (``bank_size``: the padded bank of a partitioned facade;
        None: ``E*B*S``), and with ``batch_stats`` the bank's own
        statistics lanes."""
        if self.config.scoring is None:
            return
        self._scoring = ScoringRuntime(self.config.scoring,
                                       self.mesh.nelems, self.dtype,
                                       self.device, bank_size=bank_size)
        if self.config.batch_stats:
            self._score_stats = BatchAccumulator(
                self.mesh.nelems * self._scoring.stride, self.dtype,
                self.device)

    def _require_scoring(self) -> ScoringRuntime:
        if self._scoring is None:
            raise RuntimeError(
                "filtered scoring is disabled; construct the tally "
                "with TallyConfig(scoring=scoring.ScoringSpec(...))"
            )
        return self._scoring

    @property
    def score_bank(self) -> torch.Tensor:
        """The scoring lanes, flattened [E*B*S] in original element
        order (the partitioned and streaming facades assemble theirs)."""
        self._require_scoring()
        return self._score_bank

    def score_array(self) -> torch.Tensor:
        """The scoring lanes as [E, n_bins, n_scores]; ``spec.scores``
        names the last axis."""
        spec = self._require_scoring().spec
        return self.score_bank.reshape(self.mesh.nelems, spec.n_bins,
                                       spec.n_scores)

    def score_statistics(self) -> BatchStatistics:
        """Per-batch ``BatchStatistics`` over the flattened scoring lanes;
        needs both ``batch_stats=True`` and a scoring spec."""
        self._require_scoring()
        self._require_stats()
        return BatchStatistics(
            flux_sum=self._score_stats.flux_sum,
            flux_sq_sum=self._score_stats.flux_sq_sum,
            num_batches=self._score_stats.num_batches,
            elapsed_seconds=self._stats_elapsed(),
        )

    def _score_args_check(self, energy, time_) -> None:
        """Refuse mismatched energy=/time= with errors that name the
        argument."""
        if self._scoring is None:
            if energy is not None or time_ is not None:
                raise ValueError(
                    "energy=/time= require TallyConfig(scoring="
                    "scoring.ScoringSpec(...)); this tally has no "
                    "scoring lanes to bin them into"
                )
            return
        spec = self._scoring.spec
        if spec.needs_energy and energy is None:
            raise ValueError(
                "this ScoringSpec bins (or scales) by energy: pass "
                "energy= (one value per particle) to MoveToNextLocation"
            )
        if spec.needs_time and time_ is None:
            raise ValueError(
                "this ScoringSpec bins by time: pass time= (one value "
                "per particle) to MoveToNextLocation"
            )
        if energy is not None and not spec.needs_energy:
            raise ValueError(
                "energy= passed but this ScoringSpec has no "
                "EnergyFilter and no energy-scaled score"
            )
        if time_ is not None and not spec.needs_time:
            raise ValueError(
                "time= passed but this ScoringSpec has no TimeFilter"
            )

    def _stage_move_attr(self, buf, what: str) -> Optional[torch.Tensor]:
        """Validate and stage one per-particle move attribute ([n],
        working dtype, checked finite after the cast) through the pinned
        path."""
        if buf is None:
            return None
        a = host_scalar_field(buf, self.num_particles, what)

        def fill(dst: np.ndarray) -> None:
            self._staging.cast(dst, a, what if self.config.validate_inputs
                               else None)

        return self._staging.stage(what, [(what, (self.num_particles,),
                                           self.dtype, fill)])[0]

    def _resolve_move_scoring(self, energy, time_):
        """The move's scoring operands (sbin, sfac), resolved on the
        device, or (None, None) with scoring off."""
        self._score_args_check(energy, time_)
        if self._scoring is None:
            return None, None
        return self._scoring.resolve(self._stage_move_attr(energy, "energy"),
                                     self._stage_move_attr(time_, "time"),
                                     self.num_particles)

    def _score_ops(self, bank, sbin, sfac):
        """The walk's ``scoring=`` bundle over ``bank``, or None with
        scoring off."""
        if self._scoring is None:
            return None
        return (self._scoring.spec.kinds, bank, sbin, sfac)

    # -- the three-call protocol ----------------------------------------
    def CopyInitialPosition(self, init_particle_positions,
                            size: Optional[int] = None):
        """Localize particles to the host app's sampled source points
        (reference PumiTally.h:66-67; non-tallying initial search)."""
        with span("ptt.copy_initial"):
            self._check_poisoned()
            t0 = time.perf_counter()
            self._stats_roll_batch()  # each sourcing opens a new batch
            self._resilience_roll_batch()  # autosave/drain at batch close
            # Fold the closing batch's still-lost particles into the
            # cumulative counter before the new localization resets
            # them.
            self._lost_total += self._current_lost()
            self._last_dests_host = None  # localization rewrites state
            self._last_dests_dev = None
            self._echo_misses = 0  # a new batch re-arms the echo detector
            self._xpoint_stash = None  # xpoints reset to the new positions
            # Staged through the destinations' buffer: one pinned [n,3].
            dest = self._stage_positions(
                host_positions(init_particle_positions, size,
                               self.num_particles), "dests", "positions")
            found_all, n_exited = self._dispatch_localize(dest)
            if self.config.check_found_all:
                if not read_on_host(found_all):
                    print(
                        "ERROR: Not all particles are found. May need more "
                        "loops in search"
                    )
                n_exited = read_on_host(n_exited, int)
                if n_exited:
                    print(
                        f"WARNING: {n_exited} particles exited the domain "
                        "during localization (non-convex mesh?); they were "
                        "clamped to the boundary"
                    )
            self.is_initialized = True
            self._fence()
            self.tally_times.initialization_time += time.perf_counter() - t0

    def _dispatch_localize(self, dest: torch.Tensor):
        """Non-tallying localization; returns (found_all, n_exited),
        device scalars that are fetched only when they are read."""
        if self._shards is not None:
            return self._dispatch_localize_sharded(dest)
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
        self.x, self.elem, done = self._sentinel_post_localize(
            self.x, self.elem, dest, done, self.flux)
        return done.all(), exited.sum()

    def _dispatch_localize_sharded(self, dest: torch.Tensor):
        """``_dispatch_localize`` with the particles sharded."""
        dest = self._pad_particles(dest, self.x)
        self.x, self.elem, dones, exited = self._sharded_localize(
            self.x, self.elem, dest)
        sh = self._shards
        if self._sentinel is None:
            return sh.all(dones), exited.sum()
        self.x, self.elem, done = self._sentinel_post_localize(
            self.x, self.elem, dest, sh.gather(dones), self.flux)
        return done.all(), exited.sum()

    def _sharded_localize(self, x, elem, dest):
        """The non-tallying localization of [cap] arrays over the shards:
        each shard walks (or first locates) its slice on its own device.
        Returns the whole (x, elem), the per-shard done flags and the
        whole exited flags."""
        sh, meshes = self._shards, self._shard_meshes
        x, elem, dl = sh.split(x), sh.split(elem), sh.split(dest)
        if self.config.localization == "locate":
            e0 = sharded_locate(sh, meshes, dl, tol=self._tol)
            for i in sh.local:
                x[i], elem[i] = adopt_located(x[i], elem[i], dl[i], e0[i])
        xs, es, dones, exited = sharded_localize_step(
            sh, meshes, x, elem, dl, tol=self._tol,
            max_iters=self._max_iters)
        return sh.gather(xs), sh.gather(es), dones, sh.gather(exited)

    def MoveToNextLocation(self, particle_origin, particle_destinations,
                           flying=None, weights=None,
                           size: Optional[int] = None, energy=None,
                           time=None):
        """Two-phase tracked move (reference PumiTally.h:87-89).

        ``particle_origin=None`` continues from the committed positions
        (phase A skipped); ``flying=None`` means every particle flies
        (nothing to zero); ``weights=None`` means unit weights.
        ``energy=`` / ``time=``: per-particle [n] attributes for the
        scoring spec's filters and energy-scaled scores."""
        with span("ptt.move"):
            # First: a corrupt engine refuses whatever else is wrong.
            self._check_poisoned()
            if not self.is_initialized:
                raise RuntimeError(
                    "CopyInitialPosition must be called before "
                    "MoveToNextLocation (reference invariant, "
                    "PumiTallyImpl.cpp:437-438)"
                )
            t0 = _perf_counter()
            n = self.num_particles
            dests_raw = host_positions(particle_destinations, size, n)
            origins_raw = (None if particle_origin is None
                           else host_positions(particle_origin, size, n))
            dests = self._stage_positions(dests_raw, "dests",
                                          "destinations")
            if self._origins_echo_raw(origins_raw):
                # The origins echo the previous destinations in the
                # working dtype: the device tensor that staged those
                # holds exactly the caller's origins. Phase A still runs
                # on the device (and skips its walk when every particle
                # is there).
                origins = self._last_dests_dev
            elif origins_raw is None:
                origins = None
            else:
                origins = self._stage_positions(origins_raw, "origins",
                                                "origins")
            fly = self._stage_flying(flying)
            w = self._stage_weights(weights)
            # Before the flying side effect: a move refused for its
            # energy= or time= leaves the caller's buffers untouched.
            sbin, sfac = self._resolve_move_scoring(energy, time)
            zero_flying_side_effect(flying, n)
            found_all = self._dispatch_move(origins, dests, fly, w, sbin,
                                            sfac)
            if origins_raw is not None and self._retain_echo_snapshots():
                # Only origin-passing callers can echo. The device tensor
                # is this move's own (staging allocates anew each upload).
                keep, self._last_dests_host = self._last_dests_host, None
                self._last_dests_dev = None
                self._last_dests_host = owned_snapshot(
                    keep, self._staging.host("dests")[0])
                self._last_dests_dev = dests
            self.iter_count += 1
            self._stats_note_move()
            if self.config.check_found_all and not read_on_host(found_all):
                print("ERROR: Not all particles are found. May need more "
                      "loops in search")
            self._fence()
            self.tally_times.total_time_to_tally += _perf_counter() - t0
            self._resilience_note_move()  # drain/timer-cadence safe point

    def _dispatch_move(self, origins, dests, fly, w, sbin=None, sfac=None):
        """One tallied move from staged inputs (origins None: continue
        mode; sbin/sfac: the scoring operands, None with scoring off).
        Returns whether every particle finished, as a device scalar
        fetched only when read."""
        if self._shards is not None:
            return self._dispatch_move_sharded(origins, dests, fly, w, sbin,
                                               sfac)
        kw = dict(tol=self._tol, max_iters=self._max_iters,
                  scoring=self._score_ops(self._score_bank, sbin, sfac),
                  deterministic=self._deterministic)
        x_prev = self.x  # the phase-B start of a continue move
        if self.config.record_xpoints:
            # What intersection_points() needs to replay this move.
            self._xpoint_stash = (self.x, self.elem, origins, dests, fly)
        if origins is None:
            self.x, self.elem, done, s_b = move_step_continue(
                self.mesh, self.x, self.elem, dests, fly, w, self.flux, **kw)
        else:
            self.x, self.elem, done, s_b = move_step(
                self.mesh, self.x, self.elem, origins, dests, fly, w,
                self.flux, **kw)
        if self._sentinel is None:
            return done.all()
        return self._sentinel_post_move(
            x_prev if origins is None else origins, dests, fly, w, done,
            s_b, sbin, sfac)

    def _sharded_move(self, sh, meshes, x, elem, origins, dests, fly, w,
                      flux, bank, sbin, sfac):
        """One tallied move of [cap] arrays over the shards of ``sh``;
        returns the whole (x, elem, flux, bank) and the per-shard
        (done, s)."""
        split = sh.split
        scoring = None
        if self._scoring is not None:
            scoring = (self._scoring.spec.kinds, bank, split(sbin),
                       split(sfac))
        kw = dict(tol=self._tol, max_iters=self._max_iters, scoring=scoring,
                  deterministic=self._deterministic)
        if origins is None:
            res = sharded_move_step_continue(
                sh, meshes, split(x), split(elem), split(dests), split(fly),
                split(w), flux, **kw)
        else:
            res = sharded_move_step(
                sh, meshes, split(x), split(elem), split(origins),
                split(dests), split(fly), split(w), flux, **kw)
        xs, es, dones, ss, flux, bank = res
        return sh.gather(xs), sh.gather(es), flux, bank, dones, ss

    def _dispatch_move_sharded(self, origins, dests, fly, w, sbin, sfac):
        """``_dispatch_move`` over the device mesh: the staged arrays
        padded to the capacity (padded slots never fly, dest = x), each
        shard's slice walked on its own device, the deltas summed in
        shard order (parallel/sharded.py)."""
        sh = self._shards
        pad = self._pad_particles
        dests = pad(dests, self.x)
        fly = pad(fly, 0)
        w = pad(w, 0.0)
        origins = pad(origins, self.x)
        if sbin is not None:
            sbin, sfac = pad(sbin, 0), pad(sfac, 0.0)
        x_prev = self.x
        self.x, self.elem, self.flux, bank, dones, ss = self._sharded_move(
            sh, self._shard_meshes, self.x, self.elem, origins, dests, fly,
            w, self.flux, self._score_bank, sbin, sfac)
        if self._scoring is not None:
            self._score_bank = bank
        if self._sentinel is None:
            return sh.all(dones)
        return self._sentinel_post_move(
            x_prev if origins is None else origins, dests, fly, w,
            sh.gather(dones), sh.gather(ss), sbin, sfac)

    # -- the service's cross-session fusion (service/fusion.py) ----------
    def arm_deterministic(self) -> None:
        """Commit every tallying walk of this facade (its engines' too)
        through the deterministic commit from now on: what the service
        arms on each session, so that a session equals its solo run bit
        for bit on the card, fused or not, and what a caller arms to run
        a facade bitwise equal to such a session (or to another run).
        Values do not change: the plain versions' flux is the same
        either way."""
        if self._deterministic is None:
            self._deterministic = DetWorkspace()
        for eng in self._engines():
            eng.deterministic = self._deterministic

    def _engines(self) -> list:
        """The partitioned engines this facade walks through (none
        here)."""
        return []

    def _fusion_key(self):
        """The co-fusability identity of this facade's moves, or None
        when they never share a fused launch (the JAX facade's): the
        same mesh object, dtype, device, tolerance, step budget, table
        tier, commit and the scoring spec's static key. Subclasses other
        than ``StreamingTally`` (partitioned: engine-owned state),
        sharded facades and xpoint recorders never fuse."""
        if (type(self) is not PumiTally or self.config.record_xpoints
                or self._shards is not None):
            return None
        return ("mono",) + self._fusion_statics()

    def _fusion_statics(self) -> tuple:
        spec = self.config.scoring
        return (id(self.mesh), str(self.dtype), str(self.device), self._tol,
                self._max_iters, self.config.resolved_table_dtype(),
                self._deterministic is not None,
                None if spec is None else spec.static_key())

    def _check_movable(self) -> None:
        """The protocol-order checks a move runs first."""
        self._check_poisoned()
        if not self.is_initialized:
            raise RuntimeError(
                "CopyInitialPosition must be called before "
                "MoveToNextLocation (reference invariant, "
                "PumiTallyImpl.cpp:437-438)"
            )

    def _fused_move_stage(self, op) -> FusedMoveStage:
        """The host half of one move for a fused group: the service op's
        buffers (validated at submit, service/staging.py) cast to the
        working dtype, and the scoring operands resolved, with NO facade
        state changed, so a failed launch can still run the move solo.
        The protocol-order checks re-run, with the solo move's errors."""
        self._check_movable()
        n = self.num_particles
        wd = _np_dtype(self.dtype)
        sbin, sfac = self._resolve_move_scoring(op.energy, op.time)
        return FusedMoveStage(
            dests=np.asarray(op.dests.reshape(n, 3), dtype=wd),
            origins=(None if op.origins is None
                     else np.asarray(op.origins.reshape(n, 3), dtype=wd)),
            fly=op.flying,
            w=None if op.weights is None else np.asarray(op.weights, wd),
            sbin=sbin, sfac=sfac, x_prev=self.x)

    def _fused_move_commit(self, res, stage: FusedMoveStage, t0: float,
                           sentinel_ops=None) -> None:
        """The state half of one fused move: adopt this session's slice
        ``res = (x, elem, flux, done, s, bank or None)`` of the shared
        launch (flux and bank copied into the facade's own tensors), then
        the solo move's post-walk sequence in its order: the sentinel's
        audit and ladder (``sentinel_ops = (x_start, dests, fly, w)``,
        device slices, needed iff a sentinel is armed), counters, the
        found-all check, fence, timing, the resilience hook. ``t0`` is
        the group's start. The echo snapshots stay as they were (their
        host and device halves still agree)."""
        x2, elem2, flux2, done, s_b, bank2 = res
        self.x, self.elem = x2, elem2
        self.flux.copy_(flux2)
        if self._scoring is not None:
            self._score_bank.copy_(bank2)
        found_all = done.all()
        if self._sentinel is not None:
            x_start, dests, fly, w = sentinel_ops
            found_all = self._sentinel_post_move(
                x_start, dests, fly, w, done, s_b, stage.sbin, stage.sfac)
        self.iter_count += 1
        self._stats_note_move()
        if self.config.check_found_all and not bool(found_all):
            print("ERROR: Not all particles are found. May need more loops in search")
        self._fence()
        self.tally_times.total_time_to_tally += _perf_counter() - t0
        self._resilience_note_move()  # drain/timer-cadence safe point

    def WriteTallyResults(self, filename: Optional[str] = None) -> None:
        """Normalize flux by element volume and write a legacy VTK file
        (reference PumiTallyImpl.cpp:151-157, 382-416)."""
        with span("ptt.write"):
            self._check_poisoned()
            t0 = time.perf_counter()
            write_vtk(
                filename or self.config.output_filename,
                self.mesh.coords.cpu().numpy(),
                self.mesh.tet2vert.cpu().numpy(),
                cell_data=merge_cell_data({
                    "flux": self.normalized_flux().cpu().numpy(),
                    "volume": self.mesh.volumes.cpu().numpy(),
                }, *self._optional_cell_data()),
                field_data=self._vtk_field_data(),
            )
            self.tally_times.vtk_file_write_time += time.perf_counter() - t0
            self.tally_times.print_times()

    def _optional_cell_data(self) -> tuple:
        """The statistics and scoring cell arrays (each {} when off, so
        the default payload is the reference's flux and volume)."""
        vol = self.mesh.volumes.cpu().numpy()
        stats, scores = {}, {}
        if self._stats is not None and self._stats.num_batches >= 1:
            st = self.batch_statistics()
            stats = stats_cell_data(BatchStatistics(
                flux_sum=st.flux_sum.cpu(), flux_sq_sum=st.flux_sq_sum.cpu(),
                num_batches=st.num_batches), vol)
        if self._scoring is not None:
            scores = score_cell_data(self._scoring.spec,
                                     self.score_bank.cpu().numpy(), vol)
        return stats, scores

    def _vtk_field_data(self) -> dict:
        """Campaign-level payload: the cumulative lost-particle count
        and, with a sentinel armed, the health report."""
        out = {"lost_particles": np.asarray([float(self.lost_particles)],
                                            np.float64)}
        if self._sentinel is not None:
            out.update(health_field_data(self.health_report()))
        return out

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

    def intersection_points(self) -> np.ndarray:
        """Each particle's last face-intersection point: the reference's
        ``getIntersectionPoints()`` (PumiTallyImpl.h:177-178). Requires
        ``TallyConfig.record_xpoints=True``. Before any move, and for a
        particle that crossed no face in the last move, it is the
        particle's starting position. The walk keeps no crossing points,
        so this replays the last move (``walk_xpoints``, plain PyTorch);
        phase A is replayed first when it walked a non-zero distance, and
        only phase B's crossings are recorded."""
        if not self.config.record_xpoints:
            raise RuntimeError(
                "intersection_points() needs TallyConfig.record_xpoints="
                "True (the facade does not retain move inputs otherwise)"
            )
        if not self.is_initialized:
            raise RuntimeError(
                "CopyInitialPosition must be called before "
                "intersection_points()"
            )
        if type(self)._dispatch_move is not PumiTally._dispatch_move or (
            type(self).MoveToNextLocation is not PumiTally.MoveToNextLocation
        ):
            # A facade that moves through its own engine never fills the
            # stash: start positions would be wrong data.
            raise NotImplementedError(
                f"intersection_points() is implemented for the "
                f"monolithic/sharded PumiTally facade only, not "
                f"{type(self).__name__}"
            )
        if self.config.device_mesh is not None:
            # The JAX facade's refusal: the replay would mix the sharded
            # stash with a monolithic walk.
            raise NotImplementedError(
                "intersection_points() replay does not support a "
                "device_mesh yet: the sharded replay path is untested. "
                "Drop device_mesh (or record_xpoints) to use this "
                "debug surface"
            )
        if self._xpoint_stash is None:
            return self.positions  # no move yet: the start points
        x0, e0, origins, dests, fly = self._xpoint_stash
        if origins is not None:
            # Phase A's relocation gives phase B's start, unless it
            # walked zero distance (the move's own skip).
            dest_a = torch.where((fly == 1)[:, None], origins, x0)
            if not bool((dest_a == x0).all()):
                x0, e0, _, _ = _localize_step(
                    self.mesh, x0, e0, dest_a, tol=self._tol,
                    max_iters=self._max_iters)
        xp = walk_xpoints(self.mesh, x0, e0, dests, fly, tol=self._tol,
                          max_iters=self._max_iters)
        return xp.cpu().numpy()[: self.num_particles]
