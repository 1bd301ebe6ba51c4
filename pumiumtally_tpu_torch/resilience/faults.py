"""Deterministic fault injection for the resilience layer (port of
``pumiumtally_tpu/resilience/faults.py``: the same variable, grammar and
sites, so one spec arms either package).

A fault-tolerance subsystem that is only ever exercised by real crashes
is untested by construction. This module injects the failure modes the
checkpoint layer claims to survive, at DETERMINISTIC points keyed to
checkpoint generation / batch ordinals (cross-process stable, so a
kill-and-resume test reproduces exactly), driven by one environment
variable:

    PUMIUMTALLY_FAULT=<action>@<site>:<ordinal>[:<arg>]

Grammar (docs/DESIGN.md "Fault tolerance" holds the contract each
fault is meant to violate):

- ``kill@save:N``      SIGKILL this process in the middle of writing
                       checkpoint generation N — after the temp file is
                       flushed and fsync'd, BEFORE the atomic
                       ``os.replace``. The atomicity contract says the
                       store must be left with generation N-1 intact
                       and no generation N.
- ``sigterm@batch:N``  deliver SIGTERM to this process at the Nth
                       batch-close hook (before any cadence save) —
                       exercises the graceful-drain handler: finish the
                       hook, save, exit 0.
- ``truncate@gen:N[:B]``  after generation N is fully written, cut B
                       bytes (default 64) off the end of the file —
                       the digest check must catch it on load.
- ``bitflip@gen:N[:OFF]`` after generation N is fully written, XOR one
                       byte at offset OFF (default: middle of the
                       payload) — the digest check must catch it.
- ``nan@gen:N``        poison the flux array with NaN BEFORE the
                       payload is serialized and digested — the file
                       verifies clean, so this exercises the loader's
                       payload validation, not the digest.

All hooks are no-ops when the variable is unset; a malformed spec
raises immediately (a typo'd fault that silently never fires would be
a green test proving nothing).
"""

from __future__ import annotations

import os
import signal
from dataclasses import dataclass
from typing import Optional

import numpy as np

FAULT_ENV = "PUMIUMTALLY_FAULT"

_VALID = {
    ("kill", "save"),
    ("sigterm", "batch"),
    ("truncate", "gen"),
    ("bitflip", "gen"),
    ("nan", "gen"),
}
_GRAMMAR = (
    "expected <action>@<site>:<ordinal>[:<arg>] with (action, site) one "
    "of kill@save, sigterm@batch, truncate@gen, bitflip@gen, nan@gen"
)


@dataclass(frozen=True)
class FaultSpec:
    action: str
    site: str
    ordinal: int
    arg: Optional[int] = None

    def matches(self, site: str, ordinal: int) -> bool:
        return self.site == site and self.ordinal == int(ordinal)


def parse_fault(spec: str) -> FaultSpec:
    """Parse one fault spec; raises ValueError with the grammar on any
    malformation."""
    try:
        action, rest = spec.split("@", 1)
        parts = rest.split(":")
        site = parts[0]
        ordinal = int(parts[1])
        arg = int(parts[2]) if len(parts) > 2 else None
        if len(parts) > 3:
            raise ValueError("too many ':' fields")
    except (ValueError, IndexError) as e:
        raise ValueError(
            f"bad {FAULT_ENV} spec {spec!r}: {_GRAMMAR}"
        ) from e
    if (action, site) not in _VALID:
        raise ValueError(
            f"bad {FAULT_ENV} spec {spec!r}: unknown fault "
            f"{action}@{site}; {_GRAMMAR}"
        )
    if ordinal < 1:
        raise ValueError(
            f"bad {FAULT_ENV} spec {spec!r}: ordinal must be >= 1 "
            "(generations and batch closes count from 1)"
        )
    return FaultSpec(action=action, site=site, ordinal=ordinal, arg=arg)


def active_fault() -> Optional[FaultSpec]:
    """The process's injected fault, or None. Read from the environment
    on every call (cheap) so tests can arm/disarm without reloads."""
    spec = os.environ.get(FAULT_ENV)
    if not spec:
        return None
    return parse_fault(spec)


# -- hooks (called by the generation store / autosave runner) -----------

def corrupt_payload_arrays(arrays: dict, generation: int) -> None:
    """``nan@gen:N``: poison the flux BEFORE serialization, so the
    written file carries a VALID digest around non-physical data."""
    f = active_fault()
    if f is not None and f.action == "nan" and f.matches("gen", generation):
        arrays["flux"] = np.full_like(
            np.asarray(arrays["flux"], np.float64), np.nan
        )


def maybe_kill_mid_save(generation: int) -> None:
    """``kill@save:N``: SIGKILL between the temp-file fsync and the
    atomic rename — the hardest point for a non-atomic writer."""
    f = active_fault()
    if f is not None and f.action == "kill" and f.matches("save", generation):
        os.kill(os.getpid(), signal.SIGKILL)


def damage_after_save(path: str, generation: int) -> None:
    """``truncate@gen:N`` / ``bitflip@gen:N``: storage-level damage to
    a fully written generation file."""
    f = active_fault()
    if f is None or not f.matches("gen", generation):
        return
    if f.action == "truncate":
        cut = f.arg if f.arg is not None else 64
        size = os.path.getsize(path)
        with open(path, "r+b") as fh:
            fh.truncate(max(0, size - cut))
    elif f.action == "bitflip":
        size = os.path.getsize(path)
        off = f.arg if f.arg is not None else size // 2
        off = min(max(0, off), size - 1)
        with open(path, "r+b") as fh:
            fh.seek(off)
            b = fh.read(1)
            fh.seek(off)
            fh.write(bytes([b[0] ^ 0xFF]))


def maybe_sigterm_at_batch(batches_closed: int) -> None:
    """``sigterm@batch:N``: deliver a real SIGTERM to this process at
    the Nth batch-close hook (the handler runs synchronously in the
    main thread, so the drain flag is set before the hook continues)."""
    f = active_fault()
    if f is not None and f.action == "sigterm" and f.matches(
        "batch", batches_closed
    ):
        os.kill(os.getpid(), signal.SIGTERM)
