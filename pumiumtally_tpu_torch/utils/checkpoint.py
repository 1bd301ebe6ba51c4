"""Checkpoint and resume of tally state (port of
``pumiumtally_tpu/utils/checkpoint.py``).

The complete engine state (flux, committed positions, element ids, the
move counter, the statistics lanes and the scoring bank) round-trips
through one ``.npz`` file in the JAX package's format: version 3, the
same key names and the same ``kind`` strings, so a checkpoint written by
either package loads in the other.

Failure-mode contract (docs/DESIGN.md "Fault tolerance"):

- ``save_tally_state`` is atomic: the payload goes to a temporary file
  in the target directory, which is flushed, fsynced and renamed over
  the destination, then the directory is fsynced; a crash mid-save
  leaves the old checkpoint or the new one, never a hybrid.
- ``load_tally_state`` raises ``CorruptCheckpointError`` (a ValueError)
  on a truncated, bit-flipped or foreign file; a header mismatch (other
  mesh, other particle count, a newer format) stays a plain ValueError:
  a mis-configured target, not a damaged file.
- Besides the canonical payload (caller particle order, original
  element order), a checkpoint carries the saving engine's exact layout
  (the partitioned engines' slot rows, ``sbin``/``sfac`` included, their
  padded flux and bank; the streaming facade's per-chunk flux and
  banks). Restored into an identically configured engine, transport
  continues bit for bit; a differently configured target falls back to
  the canonical restore (exact state, its flux summed in another
  order from then on).
"""

from __future__ import annotations

import io
import os
import warnings
import zipfile
import zlib
from typing import Union

import numpy as np
import torch

# v3 added the batch-statistics lanes; a checkpoint without statistics
# still writes v2, so that older readers can read plain tallies. The
# layout extras (``eng*_*``, ``chunk_flux``, ``lost_total``) and the
# scoring keys do not bump the version: older readers ignore them and
# restore canonically.
_FORMAT_VERSION = 3


class CorruptCheckpointError(ValueError):
    """The checkpoint file itself is damaged (truncated, bit-flipped, or
    not a checkpoint at all), as opposed to a well-formed checkpoint
    that does not fit the target engine (plain ValueError). The
    generation store catches this to fall back to an earlier
    generation."""


def _host(a) -> np.ndarray:
    """A host numpy array of a tensor or an array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _engine_kind(tally) -> str:
    # Local imports: the facades import this module's package.
    from pumiumtally_tpu_torch.api.partitioned import PartitionedPumiTally
    from pumiumtally_tpu_torch.api.streaming import (
        StreamingPartitionedTally,
        StreamingTally,
    )

    if isinstance(tally, PartitionedPumiTally):
        return "partitioned"
    if isinstance(tally, StreamingPartitionedTally):
        return "streaming_partitioned"
    if isinstance(tally, StreamingTally):
        return "streaming"
    return "monolithic"


def _engine_layout_arrays(eng, prefix: str) -> dict:
    """One PartitionedEngine's exact slot state, key-prefixed. The
    engine's own state keys are iterated, so the scoring rows ride
    exactly when the engine carries them."""
    out = {prefix + k: _host(v) for k, v in eng.state.items()}
    out[prefix + "flux_padded"] = _host(eng.flux_padded)
    if eng.score_padded is not None:
        out[prefix + "score_padded"] = _host(eng.score_padded)
    out[prefix + "cap"] = np.int64(eng.cap)
    out[prefix + "nparts"] = np.int64(eng.nparts)
    out[prefix + "L"] = np.int64(eng.part.L)
    out[prefix + "n"] = np.int64(eng.n)
    return out


def _stats_arrays(acc, prefix: str) -> dict:
    """A BatchAccumulator's lanes, counters and open-batch snapshot."""
    return {
        f"{prefix}_flux_sum": _host(acc.flux_sum),
        f"{prefix}_flux_sq_sum": _host(acc.flux_sq_sum),
        f"{prefix}_num_batches": np.int64(acc.num_batches),
        f"{prefix}_moves_in_batch": np.int64(acc.moves_in_batch),
        f"{prefix}_batch_open": np.bool_(acc.open_flux is not None),
        f"{prefix}_open_flux": (
            np.zeros((acc.nelems,), np.float64) if acc.open_flux is None
            else _host(acc.open_flux)
        ),
    }


def collect_tally_state(tally) -> dict:
    """The full checkpoint payload of any facade as a name -> array dict
    (what ``save_tally_state`` serializes; the generation store seals
    the same dict)."""
    kind = _engine_kind(tally)
    if kind == "monolithic":
        x, elem = _host(tally.x), _host(tally.elem)
    else:
        # Caller order; the engines re-derive their layout.
        x, elem = tally.positions, tally.elem_ids
    stats = getattr(tally, "_stats", None)
    extra = {} if stats is None else _stats_arrays(stats, "stats")
    scoring = getattr(tally, "_scoring", None)
    if scoring is not None:
        extra["score_bank"] = _host(tally.score_bank)
        # The saving spec's identity: a bank saved under another lane
        # layout is refused on restore.
        extra["score_spec"] = np.str_(repr(scoring.spec.static_key()))
        sstats = getattr(tally, "_score_stats", None)
        if sstats is not None:
            extra.update(_stats_arrays(sstats, "sstats"))
    # The layout-exact extras: the saving engine's own arrangement.
    if kind == "streaming":
        extra["chunk_flux"] = np.stack([_host(f) for f in tally._flux])
        extra["chunk_size"] = np.int64(tally.chunk_size)
        if scoring is not None:
            extra["chunk_score"] = np.stack([_host(b) for b in tally._score])
    elif kind == "partitioned":
        extra["eng_count"] = np.int64(1)
        extra.update(_engine_layout_arrays(tally.engine, "eng0_"))
    elif kind == "streaming_partitioned":
        extra["eng_count"] = np.int64(len(tally.engines))
        extra["chunk_size"] = np.int64(tally.chunk_size)
        for k, eng in enumerate(tally.engines):
            extra.update(_engine_layout_arrays(eng, f"eng{k}_"))
    return {
        # The oldest version that can read the payload.
        "format_version": np.int64(_FORMAT_VERSION if stats is not None
                                   else 2),
        "kind": np.str_(kind),
        "flux": _host(tally.flux),
        "x": x,
        "elem": elem,
        "iter_count": np.int64(tally.iter_count),
        "num_particles": np.int64(tally.num_particles),
        "capacity": np.int64(x.shape[0]),
        "nelems": np.int64(tally.mesh.nelems),
        "is_initialized": np.bool_(tally.is_initialized),
        # The rolled part of ``lost_particles`` (the open batch's lost
        # particles ride in the state and re-derive on restore).
        "lost_total": np.int64(getattr(tally, "_lost_total", 0)),
        **extra,
    }


def save_tally_state(tally, path: str) -> None:
    """Write the full state of any facade to ``path`` (``.npz`` appended
    when missing), atomically. The canonical form restores into another
    engine configuration over the same mesh; the saving engine's layout
    rides along, so an identically configured engine resumes bit for
    bit."""
    if not path.endswith(".npz"):
        path += ".npz"
    arrays = collect_tally_state(tally)
    atomic_write(path, lambda f: np.savez_compressed(f, **arrays))


def atomic_write(path: str, write_payload, tmp_path: str = None,
                 pre_replace=None) -> None:
    """The atomic-durability sequence every checkpoint writer shares:
    payload -> temporary file in the same directory -> flush -> fsync ->
    ``os.replace`` -> directory fsync. ``pre_replace`` runs between the
    fsync and the rename (the fault harness's kill-mid-save point)."""
    tmp = tmp_path or f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write_payload(f)
            f.flush()
            os.fsync(f.fileno())
        if pre_replace is not None:
            pre_replace()
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(os.path.dirname(path) or ".")


def atomic_append(path: str, payload: bytes) -> None:
    """Append ``payload`` to ``path`` through ``atomic_write``: the old
    content and the payload are written anew and renamed over the file,
    so a crash leaves the old log or the extended one, never a torn
    record. O(file) an append (the quarantine log's appends are
    rare)."""
    try:
        with open(path, "rb") as f:
            existing = f.read()
    except FileNotFoundError:
        existing = b""
    atomic_write(path, lambda f: (f.write(existing), f.write(payload)))


def _fsync_dir(d: str) -> None:
    """Best-effort directory fsync, so that the rename itself is
    durable."""
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def read_checkpoint_arrays(path: Union[str, io.IOBase]) -> dict:
    """Load a checkpoint ``.npz`` (path or file-like object) eagerly into
    a name -> array dict. Every decompression happens here, so damage
    anywhere surfaces as one ``CorruptCheckpointError`` before a tally
    is touched; a missing file stays ``FileNotFoundError``."""
    label = path if isinstance(path, str) else "<buffer>"
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, zlib.error, EOFError, OSError,
            KeyError, ValueError) as e:
        raise CorruptCheckpointError(
            f"corrupt checkpoint {label!r}: not a readable checkpoint "
            f"archive ({type(e).__name__}: {e}). The file is truncated, "
            "bit-flipped, or not a checkpoint; restore from an earlier "
            "generation (pumiumtally_tpu_torch.resilience keeps several)"
        ) from e


def _check_header(z, tally) -> None:
    for key in ("format_version", "nelems", "num_particles", "flux",
                "x", "elem", "iter_count", "is_initialized"):
        if key not in z:
            raise CorruptCheckpointError(
                f"corrupt checkpoint: required array {key!r} missing")
    if int(z["format_version"]) > _FORMAT_VERSION:
        raise ValueError(f"checkpoint format {int(z['format_version'])} "
                         f"newer than {_FORMAT_VERSION}")
    if int(z["nelems"]) != tally.mesh.nelems:
        raise ValueError(f"checkpoint mesh has {int(z['nelems'])} elements, "
                         f"target has {tally.mesh.nelems}")
    if int(z["num_particles"]) != tally.num_particles:
        raise ValueError(f"checkpoint has {int(z['num_particles'])} "
                         f"particles, target has {tally.num_particles}")


def load_tally_state(tally, path: Union[str, io.IOBase]) -> None:
    """Restore state saved by ``save_tally_state`` (by either package)
    into ``tally``: same mesh and particle count, any engine kind; the
    saved layout restores bit for bit where kind and layout match. A
    damaged file raises ``CorruptCheckpointError`` before the tally is
    touched."""
    apply_tally_state(tally, read_checkpoint_arrays(path))


def apply_tally_state(tally, z: dict) -> None:
    """Restore an already-loaded checkpoint dict into ``tally``."""
    _apply_tally_state_inner(tally, z)
    # A restore rewrites flux outside any move: re-baseline the
    # sentinel's conservation delta.
    sentinel = getattr(tally, "_sentinel", None)
    if sentinel is not None:
        sentinel.resync(tally.flux)


def _tensor(a, dtype, device) -> torch.Tensor:
    """A new device tensor holding ``a``'s values in ``dtype``."""
    return torch.as_tensor(np.asarray(a)).to(device=device,
                                             dtype=dtype).clone()


def _apply_tally_state_inner(tally, z: dict) -> None:
    _check_header(z, tally)
    # A restore rewrites committed positions under the auto-continue
    # echo check: drop its bookkeeping.
    tally._last_dests_host = None
    tally._last_dests_dev = None
    tally._echo_misses = 0
    tally._lost_total = int(z.get("lost_total", 0))
    kind = _engine_kind(tally)
    n = tally.num_particles
    flux = np.asarray(z["flux"], dtype=np.float64)
    x = np.asarray(z["x"], dtype=np.float64)[:n]
    elem = np.asarray(z["elem"], dtype=np.int32)[:n]
    saved_kind = str(z["kind"]) if "kind" in z else "monolithic"
    dev, dt = tally.device, tally.dtype
    if (saved_kind == "monolithic" and kind == "monolithic"
            and int(z["capacity"]) == n):
        tally.flux = _tensor(z["flux"], dt, dev)
        tally.x = _tensor(z["x"], dt, dev).reshape(n, 3)
        tally.elem = _tensor(z["elem"], torch.int32, dev)
        _restore_counters(tally, z)
        _restore_stats(tally, z)
        _restore_scoring(tally, kind, z, layout_done=False)
        return
    if saved_kind == kind and _restore_layout_exact(tally, kind, z):
        _restore_counters(tally, z)
        _restore_stats(tally, z)
        # The layout-exact path placed the per-engine / per-chunk banks.
        _restore_scoring(tally, kind, z, layout_done=True)
        return
    _restore_canonical(tally, kind, x, elem, flux)
    _restore_counters(tally, z)
    _restore_stats(tally, z)
    _restore_scoring(tally, kind, z, layout_done=False)


def _restore_counters(tally, z) -> None:
    tally.iter_count = int(z["iter_count"])
    tally.is_initialized = bool(z["is_initialized"])


def _restore_stats(tally, z) -> None:
    """Batch-statistics restore across version skew: a stats checkpoint
    into a stats target restores exactly; a pre-stats (v2) checkpoint
    zeroes the lanes and opens a batch at the restored flux; a stats
    checkpoint into a stats-less target drops the lanes with a
    warning."""
    stats = getattr(tally, "_stats", None)
    has = "stats_flux_sum" in z
    if stats is None:
        if has:
            warnings.warn(
                "checkpoint carries batch statistics but the target "
                "engine has batch_stats disabled; statistics lanes "
                "dropped (flux restored unchanged)")
        return
    if not has:
        stats.reset(open_flux=tally.flux.clone())
        return
    _restore_accumulator(stats, z, "stats")


def _restore_accumulator(acc, z, prefix: str) -> None:
    acc.restore(
        z[f"{prefix}_flux_sum"], z[f"{prefix}_flux_sq_sum"],
        int(z[f"{prefix}_num_batches"]), int(z[f"{prefix}_moves_in_batch"]),
        z[f"{prefix}_open_flux"] if bool(z[f"{prefix}_batch_open"])
        else None)


def _restore_scoring(tally, kind, z, layout_done: bool) -> None:
    """Scoring-lane restore, mirroring the statistics contract: exact
    into a scoring target with the same spec; zero banks (statistics
    reset) from a pre-scoring checkpoint or, with a warning, from a bank
    saved under another spec; lanes dropped with a warning into a
    scoring-less target."""
    scoring = getattr(tally, "_scoring", None)
    has = "score_bank" in z
    if scoring is None:
        if has:
            warnings.warn(
                "checkpoint carries scoring lanes but the target engine "
                "has no TallyConfig.scoring; scoring lanes dropped (flux "
                "restored unchanged)")
        return
    want_spec = repr(scoring.spec.static_key())
    want_size = tally.mesh.nelems * scoring.stride
    if has and (str(z.get("score_spec", want_spec)) != want_spec
                or np.asarray(z["score_bank"]).size != want_size):
        warnings.warn(
            "checkpoint scoring lanes were saved under a different "
            f"ScoringSpec ({z.get('score_spec')!s} vs {want_spec}); banks "
            "zeroed — scoring restarts at the restore point (flux "
            "restored unchanged)")
        has = False
    sstats = getattr(tally, "_score_stats", None)
    if not has:
        _zero_scoring_banks(tally, kind)
        if sstats is not None:
            sstats.reset(open_flux=tally.score_bank.clone())
        return
    if not layout_done:
        _restore_scoring_canonical(tally, kind,
                                   np.asarray(z["score_bank"], np.float64))
    if sstats is None:
        return
    if "sstats_flux_sum" in z:
        _restore_accumulator(sstats, z, "sstats")
    else:
        sstats.reset(open_flux=tally.score_bank.clone())


def _zero_scoring_banks(tally, kind) -> None:
    if kind == "streaming":
        tally._score = [torch.zeros_like(b) for b in tally._score]
    elif kind == "partitioned":
        eng = tally.engine
        eng.score_padded = torch.zeros_like(eng.score_padded)
    elif kind == "streaming_partitioned":
        for eng in tally.engines:
            eng.score_padded = torch.zeros_like(eng.score_padded)
    else:
        tally._score_bank = tally._scoring.zero_bank()


def _restore_partitioned_score(eng, bank: np.ndarray) -> None:
    """Canonical [E*B*S] bank -> the engine's padded-glid lane layout
    (the inverse of ``score_original``)."""
    stride = eng.score_stride
    rows = np.zeros((eng.nparts * eng.part.L, stride), np.float64)
    rows[_host(eng.part.glid_of_orig)] = bank.reshape(-1, stride)
    eng.score_padded = _tensor(rows.reshape(-1), eng.flux_padded.dtype,
                               eng.device)


def _restore_scoring_canonical(tally, kind, bank: np.ndarray) -> None:
    dev, dt = tally.device, tally.dtype
    if kind == "streaming":
        # The whole bank in chunk 0 (the flux convention).
        tally._score = [_tensor(bank, dt, dev)] + [
            torch.zeros_like(tally._score[0])
            for _ in range(tally.nchunks - 1)]
    elif kind == "partitioned":
        _restore_partitioned_score(tally.engine, bank)
    elif kind == "streaming_partitioned":
        for k, eng in enumerate(tally.engines):
            if k == 0:
                _restore_partitioned_score(eng, bank)
            else:
                eng.score_padded = torch.zeros_like(eng.score_padded)
    else:
        tally._score_bank = _tensor(bank, dt, dev)


def _engine_layout_matches(eng, z, prefix: str) -> bool:
    """The saved layout fits this engine verbatim: the same slot
    geometry and every state row this engine carries, of its shape."""
    for key, want in (("cap", eng.cap), ("nparts", eng.nparts),
                      ("L", eng.part.L), ("n", eng.n)):
        if prefix + key not in z or int(z[prefix + key]) != int(want):
            return False
    if eng.score_padded is not None and (
            prefix + "score_padded" not in z
            or z[prefix + "score_padded"].size != eng.score_padded.numel()):
        return False
    return all(
        prefix + k in z
        and tuple(z[prefix + k].shape) == tuple(eng.state[k].shape)
        for k in eng.state
    ) and prefix + "flux_padded" in z


def _restore_engine_layout(eng, z, prefix: str) -> None:
    eng.state = {k: _tensor(z[prefix + k], v.dtype, eng.device)
                 for k, v in eng.state.items()}
    eng.flux_padded = _tensor(z[prefix + "flux_padded"],
                              eng.flux_padded.dtype, eng.device)
    if eng.score_padded is not None:
        eng.score_padded = _tensor(z[prefix + "score_padded"],
                                   eng.score_padded.dtype, eng.device)
    eng.n_lost = int(np.asarray(z[prefix + "lost"]).sum())


def _restore_layout_exact(tally, kind, z) -> bool:
    """The layout-exact restore; False, leaving the tally untouched,
    whenever the saved layout does not fit this target exactly."""
    if kind == "streaming":
        cf, cs = z.get("chunk_flux"), z.get("chunk_score")
        scoring_armed = getattr(tally, "_scoring", None) is not None
        if (cf is None or "chunk_size" not in z
                or int(z["chunk_size"]) != tally.chunk_size
                or cf.shape[0] != tally.nchunks
                or (scoring_armed and (
                    cs is None or cs.shape[0] != tally.nchunks
                    or cs.shape[1] != tally._scoring.bank_size))):
            return False
        # Positions and elements through the canonical staging (the
        # canonical arrays are bit copies of the chunk state), then the
        # per-chunk flux replaces the all-in-chunk-0 layout, so that the
        # flux sum keeps the saving engine's addition order.
        n = tally.num_particles
        _restore_canonical(tally, kind,
                           np.asarray(z["x"], dtype=np.float64)[:n],
                           np.asarray(z["elem"], dtype=np.int32)[:n],
                           np.asarray(z["flux"], dtype=np.float64))
        tally._flux = [_tensor(cf[k], tally.dtype, tally.device)
                       for k in range(tally.nchunks)]
        if scoring_armed:
            tally._score = [_tensor(cs[k], tally.dtype, tally.device)
                            for k in range(tally.nchunks)]
        return True
    if kind == "partitioned":
        if int(z.get("eng_count", 0)) != 1 or not _engine_layout_matches(
                tally.engine, z, "eng0_"):
            return False
        _restore_engine_layout(tally.engine, z, "eng0_")
        return True
    if kind == "streaming_partitioned":
        engines = tally.engines
        if (int(z.get("eng_count", 0)) != len(engines)
                or "chunk_size" not in z
                or int(z["chunk_size"]) != tally.chunk_size
                or not all(_engine_layout_matches(eng, z, f"eng{k}_")
                           for k, eng in enumerate(engines))):
            return False
        for k, eng in enumerate(engines):
            _restore_engine_layout(eng, z, f"eng{k}_")
        return True
    return False


def _restore_canonical(tally, kind, x, elem, flux) -> None:
    n = tally.num_particles
    dev, dt = tally.device, tally.dtype
    if kind in ("monolithic", "streaming") and np.any(elem[:n] < 0):
        # elem == -1 marks a lost particle (a partitioned engine's
        # state); these engines cannot keep it out of transport.
        raise ValueError(
            "checkpoint contains lost particles (element id -1); "
            "restore it into a partitioned engine")
    if kind == "monolithic":
        tally.x = _tensor(x, dt, dev)
        tally.elem = _tensor(elem, torch.int32, dev)
        tally.flux = _tensor(flux, dt, dev)
    elif kind == "streaming":
        # The last chunk pads by repeating its last row (x and elem).
        for k in range(tally.nchunks):
            lo, hi = tally._chunk_bounds(k)
            xc = np.empty((tally.chunk_size, 3), np.float64)
            ec = np.empty((tally.chunk_size,), np.int32)
            xc[:hi - lo], ec[:hi - lo] = x[lo:hi], elem[lo:hi]
            xc[hi - lo:], ec[hi - lo:] = x[hi - 1], elem[hi - 1]
            tally._x[k] = _tensor(xc, dt, dev)
            tally._elem[k] = _tensor(ec, torch.int32, dev)
        tally._flux = [_tensor(flux, dt, dev)] + [
            torch.zeros_like(tally._flux[0])
            for _ in range(tally.nchunks - 1)]
    elif kind == "partitioned":
        _restore_partitioned_engine(tally.engine, x, elem, flux)
    elif kind == "streaming_partitioned":
        # The accumulated flux lives wholly in engine 0 (the flux
        # property sums the engines).
        for k, eng in enumerate(tally.engines):
            lo, hi = tally._chunk_bounds(k)
            _restore_partitioned_engine(eng, x[lo:hi], elem[lo:hi],
                                        flux if k == 0 else None)


def _restore_partitioned_engine(eng, x, elem, flux) -> None:
    """Rebuild one PartitionedEngine's slot layout from caller-order
    state: particle pid in slot pid, then one migration to the owning
    blocks. ``elem == -1`` marks a lost particle, kept out of transport.
    ``flux`` (original element order) None leaves the engine's flux
    zero."""
    from pumiumtally_tpu_torch.parallel.partition import (
        OVERFLOW_MESSAGE,
        migrate,
    )

    n, dev, dt = eng.n, eng.device, eng.flux_padded.dtype
    glid_all = _host(eng.part.glid_of_orig)
    lost = elem < 0
    glid = np.where(lost, -1, glid_all[np.clip(elem, 0, None)])
    pid = np.full(eng.cap, -1, np.int32)
    pid[:n] = np.arange(n, dtype=np.int32)
    alive = pid >= 0
    xf = np.zeros((eng.cap, 3), np.float64)
    xf[:n] = x
    pend = np.full(eng.cap, -1, np.int32)
    pend[:n] = glid
    lostf = np.zeros(eng.cap, bool)
    lostf[:n] = lost
    st = dict(eng.state)
    st["x"] = _tensor(xf, dt, dev)
    st["pid"] = _tensor(pid, torch.int32, dev)
    st["alive"] = _tensor(alive, torch.bool, dev)
    st["pending"] = _tensor(pend, torch.int32, dev)
    st["lelem"] = torch.zeros((eng.cap,), dtype=torch.int32, device=dev)
    st["done"] = _tensor(~alive, torch.bool, dev)
    st["exited"] = torch.zeros((eng.cap,), dtype=torch.bool, device=dev)
    st["lost"] = _tensor(lostf, torch.bool, dev)
    eng.state, overflow = migrate(eng.part.L, eng.nparts, eng.cap_per_block,
                                  st)
    if overflow:
        # The saved distribution does not fit this engine's
        # provisioning (the saving engine escalated its capacity):
        # escalate by demand over the intact snapshot, as the live
        # ladder does, and retry once.
        eng._escalate_capacity(eng._needed_capacity_growth())
        eng.state, overflow = migrate(eng.part.L, eng.nparts,
                                      eng.cap_per_block, eng.state)
        if overflow:
            raise RuntimeError(OVERFLOW_MESSAGE)
    eng.state["done"] = torch.ones((eng.cap,), dtype=torch.bool, device=dev)
    eng.state["pending"] = torch.full((eng.cap,), -1, dtype=torch.int32,
                                      device=dev)
    eng.n_lost = int(lost.sum())
    if flux is not None:
        fpad = np.zeros((eng.nparts * eng.part.L,), np.float64)
        fpad[glid_all] = flux
        eng.flux_padded = _tensor(fpad, dt, dev)
    else:
        eng.flux_padded = torch.zeros_like(eng.flux_padded)
