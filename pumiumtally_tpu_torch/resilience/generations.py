"""Atomic generational checkpoint store (port of
``pumiumtally_tpu/resilience/generations.py``: the same file names,
header line and payload, so either package resumes the other's
generations).

One checkpoint file is not fault tolerance: a crash mid-save corrupts
the only copy, and storage damage (a truncated write on a preempted VM,
a flipped bit) turns "resume" into a crash at the worst moment. The
store keeps the last K GENERATIONS, each written atomically and sealed
with an integrity digest, and on load walks backward past any damaged
generation with a warning instead of dying:

- **Atomic writes**: payload → temp file in the store directory →
  flush → fsync → ``os.replace`` → directory fsync. A crash at ANY
  instant leaves every previously committed generation untouched.
- **Integrity header**: each file opens with one ASCII line ::

      PUMIUMTALLY-CKPT1 gen=<n> sha256=<hex> bytes=<n> meta=<b64 json>

  followed by the raw ``.npz`` payload. Load recomputes the sha256
  over the payload; any mismatch (truncation, bit flip, foreign file)
  is ``CorruptCheckpointError`` — detected BEFORE the tally is
  touched, never a half-restored engine.
- **Generational fallback**: ``load_latest`` tries the newest
  generation first and falls back generation-by-generation past
  corrupt files (one warning each); only when EVERY generation is
  damaged does it raise. Header mismatches (wrong mesh / particle
  count) are configuration errors, not damage — those raise
  immediately.
- **Payload validation**: a digest-clean payload carrying non-finite
  flux/positions (e.g. a NaN that poisoned the engine before the save)
  is treated as corrupt too — resuming it would relive the poisoning.
"""

from __future__ import annotations

import base64
import hashlib
import io
import json
import os
import re
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pumiumtally_tpu_torch.resilience import faults
from pumiumtally_tpu_torch.utils.checkpoint import (
    CorruptCheckpointError,
    apply_tally_state,
    atomic_write,
    collect_tally_state,
    read_checkpoint_arrays,
)

_MAGIC = "PUMIUMTALLY-CKPT1"
_NAME_RE = re.compile(r"^gen-(\d{8})\.ckpt$")
# Header fields are bounded: a damaged file must not make the reader
# slurp gigabytes hunting for a newline.
_MAX_HEADER = 64 * 1024


@dataclass(frozen=True)
class ResumeInfo:
    """What ``load_latest``/``resume_latest`` restored: which
    generation, from which file, with the saver's metadata (at least
    ``iter_count`` and ``batches_closed`` for autosaved generations)."""

    generation: int
    path: str
    meta: Dict[str, Any] = field(default_factory=dict)


class GenerationStore:
    """Atomic, digest-sealed, keep-last-K checkpoint directory."""

    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep!r}")
        self.directory = directory
        self.keep = int(keep)
        os.makedirs(directory, exist_ok=True)
        # A hard kill between the temp-file fsync and the rename (the
        # kill@save fault; a real preemption SIGKILL) orphans one
        # checkpoint-sized .tmp file. Stores are single-writer, so at
        # startup any temp file is a dead writer's — sweep them rather
        # than leak one per preemption across a long campaign.
        for name in os.listdir(directory):
            if name.startswith(".tmp-gen-"):
                try:
                    os.unlink(os.path.join(directory, name))
                except OSError:
                    pass

    # -- enumeration ----------------------------------------------------
    def generations(self) -> List[Tuple[int, str]]:
        """(generation, path) pairs, ascending. Temp files and foreign
        names are ignored."""
        out = []
        for name in os.listdir(self.directory):
            m = _NAME_RE.match(name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.directory, name)))
        out.sort()
        return out

    def _path(self, generation: int) -> str:
        return os.path.join(self.directory, f"gen-{generation:08d}.ckpt")

    # -- save -----------------------------------------------------------
    def save(self, tally, meta: Optional[Dict[str, Any]] = None
             ) -> Tuple[int, str]:
        """Write the next generation atomically; returns (gen, path).
        Fault-injection hooks (resilience.faults) fire at their
        documented points when PUMIUMTALLY_FAULT is armed."""
        gens = self.generations()
        generation = gens[-1][0] + 1 if gens else 1
        arrays = collect_tally_state(tally)
        faults.corrupt_payload_arrays(arrays, generation)
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        payload = buf.getvalue()
        digest = hashlib.sha256(payload).hexdigest()
        meta_b64 = base64.urlsafe_b64encode(
            json.dumps(meta or {}, sort_keys=True, default=str).encode()
        ).decode("ascii")
        header = (
            f"{_MAGIC} gen={generation} sha256={digest} "
            f"bytes={len(payload)} meta={meta_b64}\n"
        ).encode("ascii")
        final = self._path(generation)

        def write_payload(f):
            f.write(header)
            f.write(payload)

        atomic_write(
            final, write_payload,
            tmp_path=os.path.join(
                self.directory, f".tmp-gen-{generation:08d}-{os.getpid()}"
            ),
            pre_replace=lambda: faults.maybe_kill_mid_save(generation),
        )
        faults.damage_after_save(final, generation)
        self.prune()
        return generation, final

    def prune(self) -> None:
        """Drop the oldest generations beyond ``keep`` (never the
        newest — the fallback chain shrinks from the tail)."""
        gens = self.generations()
        for _, path in gens[: max(0, len(gens) - self.keep)]:
            try:
                os.unlink(path)
            except OSError:
                pass

    # -- load -----------------------------------------------------------
    def read_generation(self, path: str) -> Tuple[bytes, int, Dict[str, Any]]:
        """Verify one generation file end-to-end; returns
        (payload bytes, generation, meta). ANY damage — bad magic,
        unparseable header, short payload, digest mismatch — raises
        ``CorruptCheckpointError``."""
        try:
            with open(path, "rb") as f:
                head = f.readline(_MAX_HEADER)
                payload = f.read()
        except OSError as e:
            raise CorruptCheckpointError(
                f"unreadable checkpoint {path!r}: {e}"
            ) from e
        try:
            text = head.decode("ascii").rstrip("\n")
            if not text.startswith(_MAGIC + " "):
                raise ValueError("bad magic")
            fields = dict(
                kv.split("=", 1) for kv in text.split(" ")[1:]
            )
            generation = int(fields["gen"])
            digest = fields["sha256"]
            nbytes = int(fields["bytes"])
            meta = json.loads(
                base64.urlsafe_b64decode(fields["meta"].encode("ascii"))
            )
        # json/base64/int errors are all ValueError subclasses.
        except (ValueError, KeyError, UnicodeDecodeError) as e:
            raise CorruptCheckpointError(
                f"corrupt checkpoint {path!r}: unparseable header ({e})"
            ) from e
        if len(payload) != nbytes:
            raise CorruptCheckpointError(
                f"corrupt checkpoint {path!r}: payload is {len(payload)} "
                f"bytes, header promises {nbytes} (truncated write?)"
            )
        if hashlib.sha256(payload).hexdigest() != digest:
            raise CorruptCheckpointError(
                f"corrupt checkpoint {path!r}: sha256 digest mismatch "
                "(bit flip or partial overwrite)"
            )
        return payload, generation, meta

    def load_latest(self, tally) -> Optional[ResumeInfo]:
        """Restore the newest loadable generation into ``tally``.

        Falls back generation-by-generation past corrupt files, each
        with a warning; returns None when the store holds no
        generations at all; raises ``CorruptCheckpointError`` when
        every generation present is damaged, and plain ValueError when
        a VALID generation does not fit the target (config error —
        older generations would not fit either)."""
        gens = self.generations()
        if not gens:
            return None
        for generation, path in reversed(gens):
            try:
                payload, g, meta = self.read_generation(path)
                z = read_checkpoint_arrays(io.BytesIO(payload))
                _validate_payload(z, path)
                apply_tally_state(tally, z)
            except CorruptCheckpointError as e:
                warnings.warn(
                    f"checkpoint generation {generation} is corrupt and "
                    f"was skipped ({e}); falling back to the previous "
                    "generation"
                )
                continue
            return ResumeInfo(generation=g, path=path, meta=meta)
        raise CorruptCheckpointError(
            f"every checkpoint generation in {self.directory!r} is "
            f"corrupt ({len(gens)} tried); nothing to resume from"
        )


def _validate_payload(z: dict, path: str) -> None:
    """Digest-clean but non-physical payloads are corruption too: a
    NaN/Inf flux or position would silently poison every tally after
    the resume (the same failure TallyConfig.validate_inputs refuses
    at staging time)."""
    for key in ("flux", "x"):
        if key in z and not np.isfinite(np.asarray(z[key])).all():
            raise CorruptCheckpointError(
                f"corrupt checkpoint {path!r}: non-finite values in "
                f"{key!r} payload"
            )


def resume_latest(tally, directory: Optional[str] = None
                  ) -> Optional[ResumeInfo]:
    """Discovery-and-restore for a restarted campaign: find the newest
    loadable generation under ``directory`` (default: the tally's
    ``TallyConfig.checkpoint.dir``) and restore it into ``tally``.

    Returns the ``ResumeInfo`` (its ``meta`` carries the saver's
    ``iter_count``/``batches_closed``) or None when no checkpoint
    exists yet — the idempotent start-of-campaign pattern::

        tally = PumiTally(mesh, n, TallyConfig(checkpoint=policy))
        info = resume_latest(tally)
        start = tally.iter_count if info else 0

    When the tally runs an autosave policy, its runner's batch/cadence
    counters are re-synced from the restored metadata so generation
    numbering and cadence continue seamlessly."""
    if directory is None:
        policy = getattr(tally.config, "checkpoint", None)
        if policy is None:
            raise ValueError(
                "resume_latest needs a directory (or a tally built "
                "with TallyConfig(checkpoint=CheckpointPolicy(...)))"
            )
        directory = policy.dir
        keep = policy.keep
    else:
        keep = 3
    store = GenerationStore(directory, keep=keep)
    info = store.load_latest(tally)
    runner = getattr(tally, "_resilience", None)
    if info is not None and runner is not None:
        runner.sync_from_resume(info)
    return info
