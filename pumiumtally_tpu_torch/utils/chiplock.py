"""Single-client interlock for the accelerator window.

The port's copy of ``pumiumtally_tpu/utils/chiplock.py``, with the same
variables: ``PUMIUMTALLY_CHIP_LOCK`` names the lock file and
``PUMIUMTALLY_CHIP_LOCK_HELD`` passes a held window to children. A second
client inside a measurement window contends for the device and skews
what it measures.

The default lock file is ``pumiumtally_chip.lock`` in the process's
temporary directory (``tempfile.gettempdir()``, so ``TMPDIR``), which is
the JAX module's ``/tmp/pumiumtally_chip.lock`` where ``TMPDIR`` is
unset. Two checkouts run with temporary directories of their own (two
sides of an A/B, each with its ``TMPDIR``) then do not wait on each
other; tools that must exclude each other across checkouts or across
the two packages name one file in ``PUMIUMTALLY_CHIP_LOCK``.

This is a cooperative flock(2) interlock every device-touching tool takes
around its device window:

- ``chip_smoke.py`` holds it exclusively for its run (every mode), with
  a bounded wait, and exits non-zero naming the lock path when it stays
  busy;
- shell tools use ``flock <LOCK_PATH> cmd``: same file, same semantics.

Reentrancy: in-process nesting is tracked by a module-level flag
(``_held_in_process``): flock(2) is per-open-file, so a second acquire in
the same process would self-deadlock without it. A holder ALSO exports
``PUMIUMTALLY_CHIP_LOCK_HELD=1``, which exists purely for CHILD-PROCESS
inheritance (chip_smoke's campaign subprocesses, its C hosts and its
two-process ranks): children see the variable and skip re-acquiring the
parent's window. A stale value inherited from a crashed parent shell is
honoured as "a parent holds the window", which is exactly its meaning.
The lock protects a *window*, not correctness: a non-cooperating process
can still use the device; the interlock makes the in-repo tools honest
with each other.
"""

from __future__ import annotations

import os
import tempfile
import time
from contextlib import contextmanager

LOCK_PATH = os.environ.get(
    "PUMIUMTALLY_CHIP_LOCK",
    os.path.join(tempfile.gettempdir(), "pumiumtally_chip.lock"),
)
_HELD_ENV = "PUMIUMTALLY_CHIP_LOCK_HELD"
# THIS process already holds the lock (nested chip_lock contexts).
# Module state, not the env var: os.environ is process-global mutable
# state that anything (a test harness, a parent tool) may scrub mid-window,
# and the env var's documented meaning is child-inheritance only.
_held_in_process = False


@contextmanager
def chip_lock(timeout_s: float | None = None, *, blocking: bool = True):
    """Acquire the accelerator window lock.

    Yields True when the lock is held (or inherited from a parent
    holder/outer context), False when ``blocking=False``/timeout
    expired and the lock is busy: the caller decides whether to skip
    or to stop.
    """
    global _held_in_process
    if _held_in_process:
        yield True  # an outer context in this process owns the window
        return
    if os.environ.get(_HELD_ENV) == "1":
        yield True  # a parent process owns the window (inherited env)
        return
    try:
        import fcntl
    except ImportError:  # non-POSIX: interlock degrades to a no-op
        yield True
        return
    fd = os.open(LOCK_PATH, os.O_CREAT | os.O_RDWR, 0o666)
    acquired = False
    try:
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                acquired = True
                break
            except OSError:
                if not blocking or (
                    deadline is not None and time.monotonic() >= deadline
                ):
                    break
                time.sleep(1.0)
        if acquired:
            _held_in_process = True
            os.environ[_HELD_ENV] = "1"  # for child processes only
        try:
            yield acquired
        finally:
            if acquired:
                _held_in_process = False
                os.environ.pop(_HELD_ENV, None)
                fcntl.flock(fd, fcntl.LOCK_UN)
    finally:
        os.close(fd)
