"""Streaming facades (port of ``pumiumtally_tpu/api/streaming.py``):
particle batches far larger than one staging buffer, in chunks.

The reference sizes its device buffers once at ``num_particles`` and
stages the whole batch per call; BASELINE.json's fifth configuration
asks for 10M particles a batch through a double-buffered host -> device
pipeline. ``StreamingTally`` keeps the three-call protocol and splits
the batch into ``chunk_size`` chunks:

- Per-chunk state: each chunk keeps its positions, element ids and its
  own flux on the device; the fluxes are summed when ``flux`` is read.
  The last chunk is padded by repeating its last row; pad slots never
  fly.
- The double buffering is explicit (XLA's asynchronous dispatch gave it
  to the JAX package for free): two page-locked staging slots and one
  copy stream (api/staging.py). Chunk k+1 is cast into its slot on the
  host, then chunk k's walk is launched, then chunk k+1's upload is
  issued on the copy stream, so that it runs while chunk k's walk does;
  the compute stream (the current stream, where every walk runs) waits
  on the slot's event, on the device, before it reads a chunk.
- Checks before dispatch: a non-finite value anywhere in the batch, in
  the working dtype too (an f64 value that overflows f32), raises before
  any chunk is dispatched, so a refused move commits nothing.
- ``auto_continue`` works chunk-wise: an echoing move reuses the
  previous move's per-chunk device destinations instead of uploading
  the origins (``_last_dests_dev`` is a list).
- The flying-zeroing side effect zeroes the whole caller buffer.

``StreamingPartitionedTally`` runs each chunk through a
``PartitionedEngine`` (the gather block walk W4 by default, W1 or W2 as
the knobs choose); all chunk engines share one partition, and their
owned flux is summed on read. Each engine runs its own overflow-recovery
ladder, and the facade refuses every call once any engine is poisoned.

Scoring and batch statistics are the base facade's, chunk-wise: each
chunk has its own bank (``StreamingTally``) or its engine's
(``StreamingPartitionedTally``), summed when ``score_bank`` is read; a
move's ``energy=`` / ``time=`` are checked before any chunk dispatches
and staged with the chunk's other inputs (on the copy stream, with
``record_stream`` on the compute stream, api/staging.py), and each
chunk's bins are resolved on the compute stream after it waits for that
upload. Pad slots never fly, so they never score.

With a sentinel armed (``TallyConfig.sentinel``) a move keeps each
chunk's phase-B start, staged inputs, done mask and ray coordinates; at
the end of the call ONE audit runs over the concatenated chunks (one
scalar fetch), then the straggler ladder chunk by chunk: W0's ladder
(sentinel/straggler.py) for ``StreamingTally``, the chunk engine's
resumed phase and declared losses for ``StreamingPartitionedTally``.
``StreamingTally``'s localization runs the zero-weight ladder per chunk.
``intersection_points`` is refused, as in the JAX package.

Fault tolerance as the base facade's: the autosave runner's batch-close
hook in ``CopyInitialPosition`` and its move-end hook after each move
(after every chunk dispatched), the chunks' walks through the
deterministic commit, and each chunk engine's exhausted overflow ladder
saving an ``overflow_safety`` generation first; a checkpoint carries the
per-chunk flux and banks (or every chunk engine's slot rows).

The service's chunk-wise fusion (service/fusion.py, the JAX facade's
api/streaming.py:623-792): ``StreamingTally._fusion_key`` pins the chunk
grid, ``_fused_move_stage`` stages a move chunk by chunk on the host
under the solo staging's padding rules (``FusedStreamStage``), and
``_fused_move_commit`` adopts each chunk's slice of the shared per-chunk
launches and runs the solo move's post-dispatch sequence.
``StreamingPartitionedTally`` never fuses.

Left out against the JAX package (ROADMAP.md): sharded chunks and
``device_groups`` (one device here). The JAX
partitioned chunks defer their overflow check to a batch sync point
(``_recover_deferred_overflow``); the port's engine checks each round on
the host and recovers inside the chunk's own call, so the JAX
"deferred two-phase" poison corner (a phase-A overflow read only after
phase B walked) cannot arise.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, List, Optional, Union

import numpy as np
import torch

from pumiumtally_tpu_torch.api.staging import HostStaging
from pumiumtally_tpu_torch.api.tally import (
    PumiTally,
    TallyConfig,
    _localize_step,
    _perf_counter,
    adopt_located,
    check_finite,
    host_positions,
    host_scalar_field,
    move_step,
    move_step_continue,
    zero_flying_side_effect,
)
from pumiumtally_tpu_torch.mesh.tetmesh import TetMesh
from pumiumtally_tpu_torch.ops.geometry import locate_by_planes
from pumiumtally_tpu_torch.api.partitioned import engine_straggler_rung
from pumiumtally_tpu_torch.parallel.partition import (
    PartitionedEngine,
    engine_partition,
)

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


@dataclass
class FusedStreamStage:
    """One streaming session's share of a fused chunk-wise launch (the
    JAX ``FusedStreamStage``): the host half of a move, one entry a
    chunk, padded to ``chunk_size`` by the solo staging's rules
    (positions repeat the last row; pad slots never fly; unit weights
    include the pad rows, staged weights pad 0.0), so each slab segment
    holds the rows a solo chunk stages. The scoring operands are the
    per-chunk device tensors a solo move resolves (None with scoring
    off)."""

    dests: List[np.ndarray]  # per chunk [chunk,3] working dtype, host
    origins: Optional[List[np.ndarray]]  # None: continue mode
    fly: List[np.ndarray]  # per chunk [chunk] int8 host, pads grounded
    w: List[np.ndarray]  # per chunk [chunk] working dtype, host
    sbin: Optional[List[torch.Tensor]]  # per chunk, device (scoring only)
    sfac: Optional[List[torch.Tensor]]


class StreamingTally(PumiTally):
    """Three-call tally over batches far larger than one staging buffer.

    Args:
      mesh: a ``TetMesh`` or a mesh file path.
      num_particles: the whole batch (e.g. 10_000_000).
      chunk_size: particles staged and walked per pipeline step.
      config: engine knobs; see ``TallyConfig``.
      device: "cuda" (default) or "cpu".
    """

    _replicated_mesh_walk = True  # walks read self.mesh's tables

    def __init__(self, mesh: Union[TetMesh, str], num_particles: int,
                 chunk_size: int = 1_000_000,
                 config: Optional[TallyConfig] = None, device: Any = None):
        t0 = time.perf_counter()
        mesh = self._init_common(mesh, num_particles, config, device,
                                 lowp_mesh=self._replicated_mesh_walk)
        self.chunk_size = int(min(chunk_size, self.num_particles))
        self.nchunks = -(-self.num_particles // self.chunk_size)
        self._staging = HostStaging(self.device, copy_stream=True)
        self._snapshot_keep: Optional[np.ndarray] = None
        self._narrow_scratch: Optional[np.ndarray] = None
        self._alloc_chunks(mesh)
        self._arm_chunk_scoring()
        self._sync()
        self.tally_times.initialization_time += time.perf_counter() - t0

    def _arm_chunk_scoring(self) -> None:
        """Scoring runtime and one bank per chunk."""
        self._arm_scoring()
        if self._scoring is not None:
            self._score = [self._scoring.zero_bank()
                           for _ in range(self.nchunks)]

    def _alloc_chunks(self, mesh: TetMesh) -> None:
        """Per-chunk device state (the partitioned facade has engines)."""
        c0 = mesh.coords[mesh.tet2vert[0].long()].mean(dim=0)
        self._x = [c0.expand(self.chunk_size, 3).contiguous()
                   for _ in range(self.nchunks)]
        self._elem = [torch.zeros((self.chunk_size,), dtype=torch.int32,
                                  device=self.device)
                      for _ in range(self.nchunks)]
        self._flux = [torch.zeros((mesh.nelems,), dtype=self.dtype,
                                  device=self.device)
                      for _ in range(self.nchunks)]

    # -- chunk staging ----------------------------------------------------
    def _chunk_bounds(self, k: int):
        lo = k * self.chunk_size
        return lo, min(lo + self.chunk_size, self.num_particles)

    def _narrow(self) -> bool:
        """Whether the working-dtype cast can overflow a finite value."""
        return self.dtype != torch.float64

    def _positions_spec(self, host: np.ndarray, k: int, name: str,
                        what: Optional[str] = None, snapshot=None):
        """Chunk k of a flat [3n] float64 buffer as [chunk,3] in the
        working dtype, padded by repeating the last row. ``what``: the
        working-dtype finite check here (CopyInitialPosition's; moves
        check before dispatch). ``snapshot``: an [n,3] host array that
        gets the chunk's working-dtype values too."""
        lo, hi = self._chunk_bounds(k)
        m = hi - lo

        def fill(dst: np.ndarray) -> None:
            np.copyto(dst[:m], host[3 * lo:3 * hi].reshape(m, 3),
                      casting="unsafe")
            if (what is not None and self.config.validate_inputs
                    and self._narrow()):
                check_finite(dst[:m], what, offset=3 * lo)
            dst[m:] = dst[m - 1]
            if snapshot is not None:
                snapshot[lo:hi] = dst[:m]

        return (name, (self.chunk_size, 3), self.dtype, fill)

    def _vec_spec(self, host: np.ndarray, k: int, name: str,
                  dtype: torch.dtype, pad):
        lo, hi = self._chunk_bounds(k)

        def fill(dst: np.ndarray) -> None:
            np.copyto(dst[:hi - lo], host[lo:hi], casting="unsafe")
            dst[hi - lo:] = pad

        return (name, (self.chunk_size,), dtype, fill)

    def _pipeline(self, specs_of, dispatch) -> list:
        """The double buffer: chunk k+1 is cast into its slot on the
        host, chunk k is dispatched on the compute stream (which first
        waits, on the device, for chunk k's upload), and only then is
        chunk k+1's upload issued on the copy stream, so that it runs
        while chunk k's walk does. Returns the dispatches' results in
        chunk order."""
        names = []

        def fill(k):
            specs = specs_of(k)
            names.append([spec[0] for spec in specs])
            self._staging.fill(k % 2, specs)

        def upload(k):
            return dict(zip(names[k], self._staging.upload(k % 2)))

        results = []
        fill(0)
        staged = upload(0)
        for k in range(self.nchunks):
            if k + 1 < self.nchunks:
                fill(k + 1)
            self._staging.consume(k % 2)
            results.append(dispatch(k, staged))
            if k + 1 < self.nchunks:
                staged = upload(k + 1)
        return results

    def _chunk_ones(self, kind: str, k: int) -> torch.Tensor:
        """Device constants: all-ones weights, and flying ones with the
        last chunk's pad slots grounded (never written to)."""
        lo, hi = self._chunk_bounds(k)
        key = (kind, hi - lo)
        a = self._ones_cache.get(key)
        if a is None:
            if kind == "fly":
                a = torch.zeros((self.chunk_size,), dtype=torch.int8,
                                device=self.device)
                a[:hi - lo] = 1
            else:
                a = torch.ones((self.chunk_size,), dtype=self.dtype,
                               device=self.device)
            self._ones_cache[key] = a
        return a

    def _prevalidate_narrow(self, dests_h, origins_h, w_h, e_h=None,
                            t_h=None) -> None:
        """The working-dtype finite check of a move's buffers, chunk by
        chunk into one scratch array, BEFORE any chunk dispatches (so a
        refused move commits nothing). Nothing to do in float64 (the
        raw batch was checked at entry) or with validation off."""
        if not self.config.validate_inputs or not self._narrow():
            return
        if self._narrow_scratch is None:
            self._narrow_scratch = np.empty(3 * self.chunk_size,
                                            _NP_DTYPE[self.dtype])
        scratch = self._narrow_scratch
        for k in range(self.nchunks):
            lo, hi = self._chunk_bounds(k)
            for buf, what, a, b in ((dests_h, "destinations", 3 * lo, 3 * hi),
                                    (origins_h, "origins", 3 * lo, 3 * hi),
                                    (w_h, "weights", lo, hi),
                                    (e_h, "energy", lo, hi),
                                    (t_h, "time", lo, hi)):
                if buf is not None:
                    np.copyto(scratch[:b - a], buf[a:b], casting="unsafe")
                    check_finite(scratch[:b - a], what, offset=a)

    # -- the three-call protocol -----------------------------------------
    def CopyInitialPosition(self, init_particle_positions,
                            size: Optional[int] = None):
        self._check_poisoned()
        t0 = time.perf_counter()
        self._stats_roll_batch()  # each sourcing opens a new batch
        self._resilience_roll_batch()  # autosave/drain at batch close
        self._lost_total += self._current_lost()
        self._last_dests_host = None  # localization rewrites the state
        self._last_dests_dev = None
        self._echo_misses = 0  # a new batch re-arms the echo detector
        host = host_positions(init_particle_positions, size,
                              self.num_particles)
        if self.config.validate_inputs:
            check_finite(host, "positions")
        dones = self._pipeline(
            lambda k: [self._positions_spec(host, k, "x", "positions")],
            lambda k, st: self._chunk_localize(k, st["x"]),
        )
        self._after_chunk_dispatch()
        if self.config.check_found_all and not all(bool(d) for d in dones):
            print("ERROR: Not all particles are found. May need more loops "
                  "in search")
        self.is_initialized = True
        self._fence()
        self.tally_times.initialization_time += time.perf_counter() - t0

    def MoveToNextLocation(self, particle_origin, particle_destinations,
                           flying=None, weights=None,
                           size: Optional[int] = None, energy=None,
                           time=None):
        self._check_poisoned()
        if not self.is_initialized:
            raise RuntimeError(
                "CopyInitialPosition must be called before MoveToNextLocation"
            )
        t0 = _perf_counter()
        n = self.num_particles
        # The scoring attributes are checked before anything is staged.
        self._score_args_check(energy, time)
        e_h = None if energy is None else host_scalar_field(energy, n,
                                                            "energy")
        t_h = None if time is None else host_scalar_field(time, n, "time")
        dests_h = host_positions(particle_destinations, size, n)
        origins_h = (None if particle_origin is None
                     else host_positions(particle_origin, size, n))
        if self.config.validate_inputs:
            check_finite(dests_h, "destinations")
            if origins_h is not None:
                check_finite(origins_h, "origins")
        # Origin-echo dedup, chunk-wise: the previous move's per-chunk
        # device destinations stand in for the caller's origins.
        echo = self._origins_echo_raw(origins_h)
        echo_chunks = self._last_dests_dev if echo else None
        fly_h = None
        if flying is not None:
            fly_h = np.asarray(flying).reshape(-1)
            if fly_h.size < n:
                raise ValueError(
                    f"flying buffer has {fly_h.size} values, need {n}")
        w_h = (None if weights is None
               else host_scalar_field(weights, n, "weights"))
        if self.config.validate_inputs:
            for buf, what in ((w_h, "weights"), (e_h, "energy"),
                              (t_h, "time")):
                if buf is not None:
                    check_finite(buf, what)
        self._prevalidate_narrow(dests_h, None if echo else origins_h, w_h,
                                 e_h, t_h)
        retain = origins_h is not None and self._retain_echo_snapshots()
        snapshot = None
        if retain:
            # Refilled chunk by chunk below; dropped first, so a move
            # that fails halfway leaves no half-written snapshot behind.
            snapshot = self._snapshot_keep
            if snapshot is None or snapshot.dtype != _NP_DTYPE[self.dtype]:
                snapshot = np.empty((n, 3), _NP_DTYPE[self.dtype])
            self._last_dests_host = self._last_dests_dev = None
        staged_origins = origins_h is not None and not echo
        # The sentinel's per-chunk record of the move (None: off).
        stash = [] if self._sentinel is not None else None
        if stash is not None:
            self._move_done, self._move_s = {}, {}

        def specs_of(k):
            specs = [self._positions_spec(dests_h, k, "dest",
                                          snapshot=snapshot)]
            if staged_origins:
                specs.append(self._positions_spec(origins_h, k, "orig"))
            if fly_h is not None:
                specs.append(self._vec_spec(fly_h, k, "fly", torch.int8, 0))
            if w_h is not None:
                specs.append(self._vec_spec(w_h, k, "w", self.dtype, 0.0))
            for buf, name in ((e_h, "energy"), (t_h, "time")):
                if buf is not None:
                    specs.append(self._vec_spec(buf, k, name, self.dtype,
                                                0.0))
            return specs

        dest_chunks: List[torch.Tensor] = []

        def dispatch(k, st):
            dest_chunks.append(st["dest"])
            if fly_h is None:
                fly = self._chunk_ones("fly", k)
            else:
                fly = st["fly"]  # pad slots staged as 0: never fly
            w = self._chunk_ones("w", k) if w_h is None else st["w"]
            if origins_h is None:
                orig = None
            elif echo:
                orig = echo_chunks[k]
            else:
                orig = st["orig"]
            sbin = sfac = None
            if self._scoring is not None:
                # On the compute stream, after it waited for the upload.
                sbin, sfac = self._scoring.resolve(
                    st.get("energy"), st.get("time"), self.chunk_size)
            if stash is not None:
                stash.append((k, self._chunk_phase_b_start(k, orig),
                              st["dest"], fly, w, sbin, sfac))
            return self._chunk_move(k, orig, st["dest"], fly, w, sbin, sfac)

        oks = self._pipeline(specs_of, dispatch)
        zero_flying_side_effect(flying, n)
        if retain:
            self._snapshot_keep = snapshot
            self._last_dests_host = snapshot
            self._last_dests_dev = dest_chunks
        self.iter_count += 1
        self._stats_note_move()
        self._after_chunk_dispatch()
        if stash is not None:
            oks = self._sentinel_chunks_post_move(stash, oks)
        if self.config.check_found_all and not all(bool(o) for o in oks):
            print("ERROR: Not all particles are found. May need more loops "
                  "in search")
        self._fence()
        self.tally_times.total_time_to_tally += _perf_counter() - t0
        self._resilience_note_move()  # drain/timer-cadence safe point

    def _after_chunk_dispatch(self) -> None:
        """Hook: per-call checks after every chunk dispatched
        (partitioned mode)."""

    # -- runtime sentinels (the chunked arms) ----------------------------
    def _chunk_phase_b_start(self, k: int, orig):
        """Chunk k's phase-B start for the audit: the staged origins, or
        the chunk's committed positions before the move."""
        return self._x[k] if orig is None else orig

    def _sentinel_chunks_post_move(self, stash, oks):
        """At the end of a move: ONE audit over every chunk (concatenated
        caller-order views), then W0's straggler ladder chunk by chunk
        over the residue the done masks show. Returns the verdicts."""
        pol = self.config.sentinel
        n_unf, mask = self._sentinel.audit(
            torch.cat([c[1] for c in stash]), torch.cat(self._x),
            torch.cat([c[3] for c in stash]), torch.cat([c[4] for c in stash]),
            torch.cat([self._move_done[c[0]] for c in stash]), self.flux)
        recovered = lost = 0
        if n_unf and pol.straggler_retry:
            new_oks = []
            for (k, x0, dest, fly, w, sbin, sfac), ok in zip(stash, oks):
                bank = None if self._scoring is None else self._score[k]
                self._x[k], self._elem[k], rec, lst = self._recover_move(
                    self._x[k], self._elem[k], self._flux[k], bank,
                    self._move_done[k], x0, dest, fly, w, self._move_s[k],
                    sbin, sfac, self.iter_count - 1,
                    pid_offset=self._chunk_bounds(k)[0])
                recovered += rec
                lost += lst
                new_oks.append(ok if rec + lst == 0 else lst == 0)
            oks = new_oks
            self._sentinel.resync(self.flux)
        self._sentinel.note_outcome(mask, n_unf, recovered, lost,
                                    self.iter_count - 1)
        return oks

    # -- per-chunk dispatch (overridden by StreamingPartitionedTally) ----
    def _chunk_localize(self, k: int, dest: torch.Tensor):
        """Localize chunk k to staged [chunk,3] destinations; returns
        whether it all converged, as a device scalar."""
        x, elem = self._x[k], self._elem[k]
        if self.config.localization == "locate":
            x, elem = adopt_located(x, elem, dest, locate_by_planes(
                self.mesh.face_normals, self.mesh.face_offsets, dest,
                self._tol,
            ))
        self._x[k], self._elem[k], done, _ = _localize_step(
            self.mesh, x, elem, dest, tol=self._tol,
            max_iters=self._max_iters,
        )
        self._x[k], self._elem[k], done = self._sentinel_post_localize(
            self._x[k], self._elem[k], dest, done, self._flux[k])
        return done.all()

    def _chunk_move(self, k: int, orig, dest, fly, w, sbin=None, sfac=None):
        """One tallied move of chunk k (orig None: continue mode) into
        the chunk's own flux and bank; returns whether every particle
        finished, as a device scalar."""
        bank = None if self._scoring is None else self._score[k]
        kw = dict(tol=self._tol, max_iters=self._max_iters,
                  scoring=self._score_ops(bank, sbin, sfac),
                  deterministic=self._deterministic)
        if orig is None:
            x, elem, done, s_b = move_step_continue(
                self.mesh, self._x[k], self._elem[k], dest, fly, w,
                self._flux[k], **kw)
        else:
            x, elem, done, s_b = move_step(
                self.mesh, self._x[k], self._elem[k], orig, dest, fly, w,
                self._flux[k], **kw)
        self._x[k], self._elem[k] = x, elem
        if self._sentinel is not None:
            self._move_done[k], self._move_s[k] = done, s_b
        return done.all()

    # -- the service's chunk-wise fusion (service/fusion.py) -------------
    def _fusion_key(self):
        """The streaming arm of ``PumiTally._fusion_key``: streaming
        sessions on one chunk grid fuse chunk by chunk (one shared launch
        a chunk index). The kind leads, so monolithic and streaming heads
        never mix; ``StreamingPartitionedTally`` and xpoint recorders
        never fuse."""
        if type(self) is not StreamingTally or self.config.record_xpoints:
            return None
        return (("stream",) + self._fusion_statics()
                + (self.num_particles, self.chunk_size))

    def _fused_chunk_positions(self, host: np.ndarray, k: int) -> np.ndarray:
        """Chunk k of a flat [3n] buffer as ``_positions_spec`` stages it
        (working dtype, the last row repeated), left on the host."""
        lo, hi = self._chunk_bounds(k)
        a = np.empty((self.chunk_size, 3), _NP_DTYPE[self.dtype])
        np.copyto(a[:hi - lo], host[3 * lo:3 * hi].reshape(hi - lo, 3),
                  casting="unsafe")
        a[hi - lo:] = a[hi - lo - 1]
        return a

    def _fused_chunk_vec(self, host: np.ndarray, k: int, dtype,
                         pad) -> np.ndarray:
        """Chunk k of a flat [n] buffer as ``_vec_spec`` stages it."""
        lo, hi = self._chunk_bounds(k)
        a = np.empty((self.chunk_size,), dtype)
        np.copyto(a[:hi - lo], host[lo:hi], casting="unsafe")
        a[hi - lo:] = pad
        return a

    def _fused_move_stage(self, op) -> FusedStreamStage:
        """The host half of one streaming move for a fused group (the
        contract of ``PumiTally._fused_move_stage``), chunk by chunk; the
        scoring operands are resolved per chunk as a solo move resolves
        them."""
        self._check_movable()
        self._score_args_check(op.energy, op.time)
        wd = _NP_DTYPE[self.dtype]
        st = FusedStreamStage(
            dests=[], origins=None if op.origins is None else [], fly=[],
            w=[], sbin=None if self._scoring is None else [],
            sfac=None if self._scoring is None else [])
        for k in range(self.nchunks):
            lo, hi = self._chunk_bounds(k)
            st.dests.append(self._fused_chunk_positions(op.dests, k))
            if op.origins is not None:
                st.origins.append(self._fused_chunk_positions(op.origins, k))
            if op.flying is None:
                f = np.zeros((self.chunk_size,), np.int8)
                f[:hi - lo] = 1  # pad slots never fly
            else:
                f = self._fused_chunk_vec(op.flying, k, np.int8, 0)
            st.fly.append(f)
            st.w.append(np.ones((self.chunk_size,), wd) if op.weights is None
                        else self._fused_chunk_vec(op.weights, k, wd, 0.0))
            if self._scoring is not None:
                attrs = [None if a is None else torch.from_numpy(
                    self._fused_chunk_vec(a, k, wd, 0.0)).to(self.device)
                    for a in (op.energy, op.time)]
                sb, sf = self._scoring.resolve(*attrs, self.chunk_size)
                st.sbin.append(sb)
                st.sfac.append(sf)
        return st

    def _fused_move_commit(self, res, stage: FusedStreamStage, t0: float,
                           sentinel_ops=None) -> None:
        """The state half of one fused streaming move: adopt each chunk's
        slice ``(x, elem, flux, done, s, bank or None)`` of the shared
        per-chunk launches (flux and banks copied into the chunk's own
        tensors), then the solo move's post-dispatch sequence in its
        order. ``sentinel_ops``: one ``(origins or None, dests, fly, w)``
        tuple of device slices a chunk, needed iff a sentinel is
        armed."""
        stash = [] if self._sentinel is not None else None
        if stash is not None:
            self._move_done, self._move_s = {}, {}
        oks = []
        for k, (x2, elem2, flux2, done, s_b, bank2) in enumerate(res):
            if stash is not None:
                org, dest, fly, w = sentinel_ops[k]
                stash.append((
                    k, self._chunk_phase_b_start(k, org), dest, fly, w,
                    None if stage.sbin is None else stage.sbin[k],
                    None if stage.sfac is None else stage.sfac[k]))
                self._move_done[k], self._move_s[k] = done, s_b
            self._x[k], self._elem[k] = x2, elem2
            self._flux[k].copy_(flux2)
            if self._scoring is not None:
                self._score[k].copy_(bank2)
            oks.append(done.all())
        self.iter_count += 1
        self._stats_note_move()
        self._after_chunk_dispatch()
        if stash is not None:
            oks = self._sentinel_chunks_post_move(stash, oks)
        if self.config.check_found_all and not all(bool(o) for o in oks):
            print("ERROR: Not all particles are found. May need more loops "
                  "in search")
        self._fence()
        self.tally_times.total_time_to_tally += _perf_counter() - t0
        self._resilience_note_move()  # drain/timer-cadence safe point

    # -- state views ------------------------------------------------------
    @property
    def x(self) -> torch.Tensor:
        return torch.cat(self._x)[: self.num_particles]

    @property
    def elem(self) -> torch.Tensor:
        return torch.cat(self._elem)[: self.num_particles]

    @property
    def flux(self) -> torch.Tensor:
        total = self._flux[0].clone()
        for f in self._flux[1:]:
            total += f
        return total

    @property
    def score_bank(self) -> torch.Tensor:
        """The scoring lanes summed over the chunks' banks."""
        self._require_scoring()
        total = self._score[0].clone()
        for b in self._score[1:]:
            total += b
        return total


class StreamingPartitionedTally(StreamingTally):
    """Streaming chunks through the PARTITIONED engine on one device: the
    mesh in blocks AND the batch too large for one slot array. Each chunk
    owns a ``PartitionedEngine`` sized to its real particles; all share
    one partition (built once), and their owned flux is summed on read.
    Knobs as ``PartitionedPumiTally``'s: by default one block and W4;
    ``walk_vmem_max_elems`` sub-splits for W1 (or W4 with
    ``walk_block_kernel="gather"``); ``walk_table_dtype="bfloat16",
    walk_kernel="pallas"`` runs W2. ``cap_frontier`` reaches every
    chunk engine."""

    _replicated_mesh_walk = False  # the engines build their own tables

    def _alloc_chunks(self, mesh: TetMesh) -> None:
        cfg = self.config
        kw = dict(vmem_walk_max_elems=cfg.walk_vmem_max_elems,
                  block_kernel=cfg.resolved_walk_kernel(),
                  table_dtype=cfg.resolved_table_dtype())
        part = engine_partition(mesh, **kw)
        self.engines = []
        for k in range(self.nchunks):
            lo, hi = self._chunk_bounds(k)
            self.engines.append(PartitionedEngine(
                mesh, hi - lo, capacity_factor=cfg.capacity_factor,
                tol=self._tol, max_iters=self._max_iters,
                max_rounds=cfg.max_migration_rounds,
                # The lost-source warning is printed once per call, for
                # every chunk (_after_chunk_dispatch).
                check_found_all=False, part=part, scoring=cfg.scoring,
                cap_frontier=cfg.cap_frontier,
                deterministic=self._deterministic, **kw,
            ))
            self._wire_engine_hooks(self.engines[-1])
        self._dispatched_localize = False

    def _engine_poisoned(self) -> bool:
        return any(e.poisoned for e in self.engines)

    def _engines(self) -> list:
        return list(self.engines)

    def _arm_chunk_scoring(self) -> None:
        # The DROP sentinel is the shared partition's padded bank size.
        eng = self.engines[0]
        self._arm_scoring(bank_size=None if eng.score_padded is None
                          else eng.score_padded.numel())

    def _chunk_localize(self, k: int, dest: torch.Tensor):
        self._dispatched_localize = True
        eng = self.engines[k]
        return eng.localize(dest[: eng.n])  # engines hold only real slots

    def _chunk_move(self, k: int, orig, dest, fly, w, sbin=None, sfac=None):
        n = self.engines[k].n
        return self.engines[k].move(
            None if orig is None else orig[:n], dest[:n], fly[:n], w[:n],
            None if sbin is None else sbin[:n],
            None if sfac is None else sfac[:n])

    def _chunk_phase_b_start(self, k: int, orig):
        n = self.engines[k].n
        if orig is not None:
            return orig[:n]
        return self.engines[k].caller_order_view(("x",))["x"]

    def _sentinel_chunks_post_move(self, stash, oks):
        """The partitioned-chunk arm: one audit over the engines'
        concatenated caller-order views, then each chunk engine's
        straggler rung (a resumed phase at multiplied budgets, then the
        residue declared lost, with quarantine records; lost particles
        stay in the engines' ``lost`` flags, which ``lost_particles``
        counts)."""
        pol = self.config.sentinel
        views = [e.caller_order_view(("x", "done")) for e in self.engines]
        n = [self.engines[c[0]].n for c in stash]
        n_unf, mask = self._sentinel.audit(
            torch.cat([c[1] for c in stash]),
            torch.cat([v["x"] for v in views]),
            torch.cat([c[3][:m] for c, m in zip(stash, n)]),
            torch.cat([c[4][:m] for c, m in zip(stash, n)]),
            torch.cat([v["done"] for v in views]), self.flux)
        recovered = lost = 0
        if n_unf and pol.straggler_retry:
            new_oks = []
            for (k, x0, dest, fly, w, _, _), m, ok in zip(stash, n, oks):
                unf = int((~views[k]["done"] & (fly[:m] == 1)).sum())
                if not unf:
                    new_oks.append(ok)
                    continue
                rec, lost_k = engine_straggler_rung(
                    self, self.engines[k], x0, dest[:m], fly[:m], w[:m],
                    unf, self.iter_count - 1,
                    pid_offset=self._chunk_bounds(k)[0])
                lost += lost_k
                recovered += rec
                new_oks.append(lost_k == 0)
            oks = new_oks
            self._sentinel.resync(self.flux)
        self._sentinel.note_outcome(mask, n_unf, recovered, lost,
                                    self.iter_count - 1)
        return oks

    def _after_chunk_dispatch(self) -> None:
        was_localize, self._dispatched_localize = (
            self._dispatched_localize, False)
        n_lost = self._current_lost()
        if n_lost and was_localize and self.config.check_found_all:
            print(
                f"[WARNING] {n_lost} source points lie in no mesh "
                "element; their particles are excluded from transport"
            )

    def _current_lost(self) -> int:
        return sum(e.n_lost for e in self.engines)

    @property
    def x(self) -> torch.Tensor:
        return torch.as_tensor(self.positions)

    @property
    def elem(self) -> torch.Tensor:
        return torch.as_tensor(self.elem_ids)

    @property
    def flux(self) -> torch.Tensor:
        total = self.engines[0].flux_original().clone()
        for e in self.engines[1:]:
            total += e.flux_original()
        return total

    @property
    def score_bank(self) -> torch.Tensor:
        """The scoring lanes summed over the chunk engines' canonical
        views."""
        self._require_scoring()
        total = self.engines[0].score_original()
        for e in self.engines[1:]:
            total += e.score_original()
        return total

    @property
    def positions(self) -> np.ndarray:
        return np.concatenate([e.positions() for e in self.engines])

    @property
    def elem_ids(self) -> np.ndarray:
        return np.concatenate([e.elem_ids() for e in self.engines])
