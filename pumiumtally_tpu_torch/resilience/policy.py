"""Autosave policy and preemption-safe drain (port of
``pumiumtally_tpu/resilience/policy.py``).

The checkpoint format alone leaves saving manual, and nothing handles
the signal a preempted machine receives (SIGTERM, with a short grace
window). This module closes both holes:

- ``CheckpointPolicy`` — declarative autosave cadence, carried on
  ``TallyConfig.checkpoint``. The facades call the runner's hooks at
  batch close (every ``CopyInitialPosition`` that closes a non-empty
  source batch, plus ``close_batch``/``finalize``) and at the end of
  each move; saves happen OFF the critical path — only when the
  cadence fires, never per call.
- ``AutosaveRunner`` — the per-tally engine behind the policy: owns
  the ``GenerationStore``, tracks batch/move counters, and implements
  graceful drain. First SIGTERM/SIGINT sets a flag; the in-flight
  particle batch finishes (signals never interrupt device work
  mid-move), the next hook saves a final generation and exits 0. A
  SECOND signal restores the previous handler and re-delivers — an
  operator's double ctrl-C still kills immediately.

Cadence semantics: ``every_n_batches`` counts CLOSED source batches
(an empty batch is not a sample, mirroring the statistics layer);
``every_seconds`` is wall time since the last save, checked at every
hook (so a single long source batch still checkpoints). Either may be
None; with both None only drain/manual saves happen.
"""

from __future__ import annotations

import dataclasses
import signal
import threading
import time
import warnings
from typing import Any, Dict, Optional, Tuple

from pumiumtally_tpu_torch.resilience import faults
from pumiumtally_tpu_torch.resilience.generations import GenerationStore, ResumeInfo


@dataclasses.dataclass
class CheckpointPolicy:
    """Declarative autosave for a campaign (TallyConfig.checkpoint).

    Attributes:
      dir: generation-store directory (created on first use).
      every_n_batches: save after this many closed source batches
        (None disables the batch cadence).
      every_seconds: save when this much wall time passed since the
        last save, checked at every batch close and move end (None
        disables the timer cadence).
      keep: how many generations the store retains (older ones are
        pruned; the on-load fallback chain is at most this long).
      handle_signals: install the SIGTERM/SIGINT graceful-drain
        handler (main thread only; silently skipped elsewhere).
    """

    dir: str
    every_n_batches: Optional[int] = 1
    every_seconds: Optional[float] = None
    keep: int = 3
    handle_signals: bool = True

    def __post_init__(self) -> None:
        if not self.dir:
            raise ValueError("CheckpointPolicy.dir must be a directory path")
        if self.keep < 1:
            raise ValueError(f"keep must be >= 1, got {self.keep!r}")
        if self.every_n_batches is not None and int(self.every_n_batches) < 1:
            raise ValueError(
                f"every_n_batches must be >= 1 or None, "
                f"got {self.every_n_batches!r}"
            )
        if self.every_seconds is not None and float(self.every_seconds) <= 0:
            raise ValueError(
                f"every_seconds must be > 0 or None, "
                f"got {self.every_seconds!r}"
            )


# Process-wide signal state: ONE dispatcher owns SIGTERM/SIGINT no
# matter how many checkpoint-armed tallies exist, and the second-signal
# escalation always restores the ORIGINAL (pre-any-runner) disposition
# — stacking per-runner handlers would make a second ctrl-C land in a
# stale runner's handler and merely set a dead drain flag.
_signal_originals: Dict[int, Any] = {}
_active_runner: Optional["AutosaveRunner"] = None


def _signal_dispatch(signum, frame) -> None:
    runner = _active_runner
    if runner is None or runner._drain:
        # Second signal (or no live runner): the operator means it.
        # Restore the original dispositions and re-deliver immediately.
        _restore_signal_originals()
        signal.raise_signal(signum)
        return
    runner._drain = True


def _install_signal_dispatch(runner: "AutosaveRunner") -> None:
    global _active_runner
    if threading.current_thread() is not threading.main_thread():
        warnings.warn(
            "CheckpointPolicy(handle_signals=True) outside the main "
            "thread: Python only delivers signals to the main "
            "thread, so the graceful-drain handler was not installed"
        )
        return
    if not _signal_originals:
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                _signal_originals[sig] = signal.signal(
                    sig, _signal_dispatch
                )
            except (ValueError, OSError):  # embedded/exotic runtimes
                _signal_originals.pop(sig, None)
    _active_runner = runner


def _restore_signal_originals() -> None:
    global _active_runner
    _active_runner = None
    for sig, prev in list(_signal_originals.items()):
        try:
            signal.signal(sig, prev)
        except (ValueError, OSError):
            pass
    _signal_originals.clear()


def install_drain_owner(owner: Any) -> None:
    """Hand the process-wide SIGTERM/SIGINT drain dispatch to ``owner``
    — any object with a writable ``_drain`` flag (duck-typed: an
    ``AutosaveRunner``, or the multi-session service, which drains
    EVERY open session when its flag trips). Newest owner wins, the
    second-signal escalation still restores the original dispositions
    and re-delivers, and the originals are captured exactly once —
    the same single-dispatcher invariant the runners rely on.
    Idempotent: re-installing the current owner is a no-op (no
    duplicate capture, no spurious warnings)."""
    if _active_runner is owner:
        return
    _install_signal_dispatch(owner)


def release_drain_owner(owner: Any) -> None:
    """Detach ``owner`` from the drain dispatch (restores the original
    signal dispositions iff ``owner`` is the current owner; a stale
    release after a newer owner took over is a no-op)."""
    if _active_runner is owner:
        _restore_signal_originals()


class AutosaveRunner:
    """Per-tally autosave engine (built by the facades from
    ``TallyConfig.checkpoint``; one per tally instance). The newest
    runner with ``handle_signals`` owns the process's drain handler."""

    def __init__(self, policy: CheckpointPolicy):
        self.policy = policy
        self.store = GenerationStore(policy.dir, keep=policy.keep)
        self.batches_closed = 0
        self.moves_since_close = 0
        self._drain = False
        self._last_save_monotonic = time.monotonic()
        self._last_saved_iter: Optional[int] = None
        if policy.handle_signals:
            _install_signal_dispatch(self)

    # -- signals ---------------------------------------------------------
    @property
    def drain_requested(self) -> bool:
        return self._drain

    def _restore_handlers(self) -> None:
        if _active_runner is self:
            _restore_signal_originals()

    def close(self) -> None:
        """Detach from the process (restore the original signal
        dispositions when this runner owns them). Called by tests; a
        draining exit restores them itself."""
        self._restore_handlers()

    # -- hooks (called by the facades) ------------------------------------
    def on_move(self, tally) -> None:
        """End of one MoveToNextLocation: a state-exact point (device
        work for the particle batch is complete). A pending drain
        writes a SAFETY generation here — if the preemption grace
        window expires before the source batch closes, at most one
        move is lost — but the clean exit waits for the batch close,
        so the newest generation a drained process leaves behind is
        batch-aligned (the resume recipe drivers actually use)."""
        self.moves_since_close += 1
        if self._drain:
            if self._last_saved_iter != int(tally.iter_count):
                self.save(tally, reason="drain_safety")
        elif self._timer_due():
            self.save(tally, reason="every_seconds")

    def on_batch_close(self, tally) -> None:
        """A source batch closed (CopyInitialPosition over a non-empty
        batch, close_batch, finalize). The primary autosave point."""
        if self.moves_since_close == 0:
            # Empty batch (back-to-back re-sourcing): not a sample,
            # not a cadence tick — but a pending drain still exits.
            if self._drain:
                self._drain_exit(tally)
            return
        self.batches_closed += 1
        self.moves_since_close = 0
        faults.maybe_sigterm_at_batch(self.batches_closed)
        if self._drain:
            self._drain_exit(tally)
        n = self.policy.every_n_batches
        if (n is not None and self.batches_closed % int(n) == 0) or (
            self._timer_due()
        ):
            self.save(tally, reason="batch_close")

    def _timer_due(self) -> bool:
        s = self.policy.every_seconds
        return s is not None and (
            time.monotonic() - self._last_save_monotonic >= float(s)
        )

    # -- saving ------------------------------------------------------------
    def save(self, tally, reason: str = "manual",
             meta: Optional[Dict[str, Any]] = None) -> Tuple[int, str]:
        m = dict(meta) if meta else {}
        # Reserved keys win over caller extras: sync_from_resume reads
        # them back into the cadence counters, so a checkpoint_now
        # kwarg shadowing iter_count would desynchronize every resume.
        m.update(
            reason=reason,
            iter_count=int(tally.iter_count),
            batches_closed=int(self.batches_closed),
        )
        gen, path = self.store.save(tally, meta=m)
        self._last_save_monotonic = time.monotonic()
        self._last_saved_iter = int(tally.iter_count)
        return gen, path

    def _drain_exit(self, tally) -> None:
        """Graceful drain at a batch close: the in-flight source batch
        just finished, so save — unless this exact state was just
        saved — restore the signal handlers, and exit cleanly."""
        if self._last_saved_iter != int(tally.iter_count):
            self.save(tally, reason="drain")
        self._restore_handlers()
        raise SystemExit(0)

    def sync_from_resume(self, info: ResumeInfo) -> None:
        """Continue counters from a restored generation so cadence and
        metadata stay monotone across the restart."""
        self.batches_closed = int(info.meta.get("batches_closed", 0))
        self.moves_since_close = 0
        self._last_save_monotonic = time.monotonic()
        self._last_saved_iter = int(info.meta.get("iter_count", -1))
