"""Host -> device staging of the caller's buffers, for every facade.

A staged float array is written once on the host, by ``cast`` into its
destination: one pass of the hand-written fill (``native/host_fill.cpp``)
casts the caller's float64 values to the working dtype, tests every
written value for Inf/NaN and, given the previous snapshot (the
weights), whether the values are unchanged. No intermediate copy is
made. Arrays of ``host_fill.inline_below()`` elements or more are split
in cache-sized chunks over a small pool of host threads (as many as the
process's CPU affinity allows, capped); smaller ones, such as the C
ABI's few particles, run on the calling thread. ``threaded_fills`` and
``inline_fills`` count the casts that took each path. The destination
depends on the device:

- CUDA: a page-locked host buffer per (slot, name), allocated once and
  reused, uploaded with a non-blocking copy into a freshly allocated
  device tensor (so a device tensor that a facade keeps, such as the
  origin-echo snapshot, is never overwritten by a later upload). A
  CUDA event recorded after a slot's uploads is waited on before the
  slot is filled again: an unfenced call may return with that upload
  still in flight. With ``copy_stream`` the uploads run on a stream of
  their own and the consumer (the current stream) waits on the slot's
  event, on the device, before it reads them (``consume``): the
  streaming facade's double buffering.
- CPU: a new tensor per call, filled in place; it owns its memory, so a
  caller that recycles its buffer changes nothing staged.

Pinned memory and streams exist only for CUDA; there is no fall back
from one device to the other.

On the profiler's timeline (``utils.profiling.span``) a slot's wait is a
``ptt.sync`` span, the casts, checks and the weights' compare a
``ptt.stage.fill`` one and the upload a ``ptt.stage.upload`` one.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pumiumtally_tpu_torch.native import host_fill
from pumiumtally_tpu_torch.utils.profiling import span

# (name, shape, dtype, fill): ``fill(dst)`` writes the values into the
# host array ``dst`` (and may raise, before anything is uploaded).
Spec = Tuple[str, tuple, torch.dtype, Callable[[np.ndarray], None]]


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
            "host buffer, or set TallyConfig(validate_inputs=False) to "
            "stage unchecked"
        )


class HostStaging:
    """Staging buffers of one facade (see the module docstring)."""

    def __init__(self, device: torch.device, copy_stream: bool = False):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = (torch.cuda.Stream(device) if self.cuda and copy_stream
                       else None)
        self._pinned: Dict[tuple, torch.Tensor] = {}
        self._events: Dict[Hashable, torch.cuda.Event] = {}
        self._filled: Dict[Hashable, list] = {}
        self._host: Dict[Hashable, List[np.ndarray]] = {}
        self.threaded_fills = 0  # casts split over the pool's threads
        self.inline_fills = 0  # casts run on the calling thread alone

    def cast(self, dst: np.ndarray, src: np.ndarray,
             what: Optional[str] = None,
             prev: Optional[np.ndarray] = None) -> bool:
        """Write the float64 ``src`` into ``dst`` in ``dst``'s dtype, as
        ``np.copyto(..., casting="unsafe")`` does, in one pass (a spec's
        fill). With ``what``, raise ``check_finite``'s error on a
        non-finite written value. Returns whether ``dst`` equals
        ``prev`` (``np.array_equal``; False without one)."""
        finite, equal, threaded = host_fill.fill(dst, src, prev)
        if threaded:
            self.threaded_fills += 1
        else:
            self.inline_fills += 1
        if what is not None and not finite:
            check_finite(dst, what)
        return equal

    def fill(self, slot: Hashable, specs: Sequence[Spec]) -> List[np.ndarray]:
        """Write each spec's values into the slot's host buffers and
        return them (valid until the slot is filled again)."""
        event = self._events.get(slot)
        if event is not None:
            with span("ptt.sync"):
                event.synchronize()  # the slot's previous upload has ended
        with span("ptt.stage.fill"):
            if not self.cuda:
                out = [torch.empty(shape, dtype=dtype) for _, shape, dtype, _
                       in specs]
                for t, (_, _, _, fill) in zip(out, specs):
                    fill(t.numpy())
                self._filled[slot] = out
                self._host[slot] = [t.numpy() for t in out]
                return self._host[slot]
            bufs = []
            for name, shape, dtype, fill in specs:
                buf = self._pinned.get((slot, name))
                if buf is None or buf.shape != shape or buf.dtype != dtype:
                    buf = torch.empty(shape, dtype=dtype, pin_memory=True)
                    self._pinned[(slot, name)] = buf
                fill(buf.numpy())
                bufs.append(buf)
            self._filled[slot] = bufs
            self._host[slot] = [b.numpy() for b in bufs]
            return self._host[slot]

    def host(self, slot: Hashable) -> List[np.ndarray]:
        """The host arrays of the slot's last ``fill`` (valid until the
        slot is filled again)."""
        return self._host[slot]

    def upload(self, slot: Hashable) -> List[torch.Tensor]:
        """Device tensors holding what ``fill`` last wrote into the
        slot (on the CPU, the filled tensors themselves)."""
        with span("ptt.stage.upload"):
            bufs = self._filled.pop(slot)
            if not self.cuda:
                return bufs
            stream = self.stream or torch.cuda.current_stream(self.device)
            with torch.cuda.stream(stream):
                out = [torch.empty(b.shape, dtype=b.dtype, device=self.device)
                       for b in bufs]
                for dst, src in zip(out, bufs):
                    dst.copy_(src, non_blocking=True)
                event = self._events.setdefault(slot, torch.cuda.Event())
                event.record(stream)
            if self.stream is not None:
                consumer = torch.cuda.current_stream(self.device)
                for t in out:
                    # Allocated on the copy stream, read on the consumer's:
                    # the allocator must not reuse them before it is done.
                    t.record_stream(consumer)
            return out

    def stage(self, slot: Hashable, specs: Sequence[Spec]) -> List[torch.Tensor]:
        """``fill`` then ``upload``."""
        self.fill(slot, specs)
        return self.upload(slot)

    def consume(self, slot: Hashable) -> None:
        """Make the current stream wait (on the device) for the slot's
        last upload; a no-op without a copy stream."""
        if self.stream is not None:
            torch.cuda.current_stream(self.device).wait_event(
                self._events[slot])
