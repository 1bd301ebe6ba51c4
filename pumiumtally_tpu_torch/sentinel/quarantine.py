"""Quarantine records for particles nothing could recover (port of
``pumiumtally_tpu/sentinel/quarantine.py``).

When the straggler ladder exhausts its rungs the particle is declared
lost: counted in the facade's ``lost_particles`` and, when the policy
names a ``quarantine_dir``, appended to ``quarantine.jsonl`` there, one
JSON object a particle:

    {"pid": 7, "move": 12, "origin": [...], "dest": [...],
     "elem": 4311, "weight": 1.0, "reason": "iteration_budget"}

An append writes the old content plus the new records to a temporary
file and renames it over the log (flush, fsync, replace, directory
fsync), so a crash leaves the old log or the extended one, never a torn
record. ``read_quarantine`` skips a torn final line all the same (logs
from other writers may carry one).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

from pumiumtally_tpu_torch.utils.checkpoint import atomic_append

QUARANTINE_FILENAME = "quarantine.jsonl"


def quarantine_path(directory: str) -> str:
    return os.path.join(directory, QUARANTINE_FILENAME)


def build_records(idx, origins, dests, elems, weights, move: int, *,
                  pid_offset: int = 0,
                  reason: str = "iteration_budget") -> List[dict]:
    """The record schema. ``idx``: the residue's caller-order indices;
    ``origins`` / ``dests`` [k,3] and ``elems`` / ``weights`` [k] aligned
    with it (host arrays); ``pid_offset`` shifts chunk-local indices to
    global particle ids."""
    return [
        {
            "pid": int(pid_offset + idx[i]),
            "move": int(move),
            "origin": [float(v) for v in origins[i]],
            "dest": [float(v) for v in dests[i]],
            "elem": int(elems[i]),
            "weight": float(weights[i]),
            "reason": reason,
        }
        for i in range(len(idx))
    ]


def append_quarantine(directory: Optional[str], records: List[dict]) -> None:
    """Append one JSONL line per record, atomically; nothing without a
    directory or without records."""
    if directory is None or not records:
        return
    os.makedirs(directory, exist_ok=True)
    payload = "".join(
        json.dumps(r, sort_keys=True) + "\n" for r in records
    ).encode()
    atomic_append(quarantine_path(directory), payload)


def read_quarantine(path: str) -> List[dict]:
    """Parse a quarantine JSONL file. A torn final line (no newline, or
    unparseable JSON) is skipped; a torn line anywhere else is
    corruption and raises."""
    records: List[dict] = []
    with open(path, "rb") as f:
        raw = f.read()
    lines = raw.split(b"\n")
    # A well-formed file ends with a newline: the last piece is empty.
    body, tail = lines[:-1], lines[-1]
    for i, line in enumerate(body):
        if not line:
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(body) - 1 and not tail:
                break  # a torn last line that kept its newline
            raise ValueError(
                f"corrupt quarantine file {path!r}: unparseable record "
                f"at line {i + 1}"
            )
    if tail:
        try:
            records.append(json.loads(tail))
        except json.JSONDecodeError:
            pass  # torn tail
    return records
