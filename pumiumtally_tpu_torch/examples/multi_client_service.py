"""Two concurrent OpenMC-style drivers sharing one tally server (the port
of examples/multi_client_service.py).

The multi-session service (pumiumtally_tpu_torch/service) owns the
device; each driver attaches as an independent session with its OWN
facade, flux, and batch statistics: the serving-layer counterpart of
openmc_style_driver's single-client loop. The two client threads below
submit moves concurrently; the service's deficit-round-robin scheduler
interleaves them on the device, and the staging layer means neither
client ever blocks on the other's device compute (futures resolve in
submission order).

The contract this example then CHECKS is the service's core invariant,
determinism under concurrency: after both concurrent campaigns finish,
each session's flux is asserted BITWISE identical to a serial
single-client run of the same campaign on a bare facade. The service
arms the deterministic commit on every session it opens (on the card the
flux is otherwise summed by float atomics in an order that varies run to
run), so the serial run arms it on its facade too. Multi-tenancy costs
accuracy nothing, not even rounding.

Run:  python -m pumiumtally_tpu_torch.examples.multi_client_service
          [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

from pumiumtally_tpu_torch import (
    PumiTally,
    ServiceBusyError,
    TallyService,
    build_box,
)

N = 10_000
BATCHES = 2
STEPS_PER_BATCH = 3
CLIENTS = {"alice": 7, "bob": 8}  # session id -> rng seed


def campaign(seed, n: int):
    """One driver's full deterministic trajectory (sources +
    destinations + weights per batch): both the concurrent and the
    serial runs replay exactly this."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(BATCHES):
        src = rng.uniform(0.05, 0.95, (n, 3))
        steps = []
        pos = src
        for _ in range(STEPS_PER_BATCH):
            dest = np.clip(pos + rng.normal(scale=0.15, size=pos.shape),
                           0.01, 0.99)
            steps.append((dest, rng.uniform(0.5, 1.5, n)))
            pos = dest
        out.append((src, steps))
    return out


def drive_session(handle, work):
    """An OpenMC-style client loop against the service: submit a
    batch's staged moves, retry on backpressure, wait at the batch
    boundary. The caller's buffers are recycled immediately: staging
    copied them out at submit."""
    def submit(fn, *args, **kw):
        while True:
            try:
                return fn(*args, **kw)
            except ServiceBusyError:
                # Queue full: an earlier move is still walking.
                time.sleep(0.001)
    for src, steps in work:
        futures = [submit(handle.copy_initial_position,
                          src.reshape(-1).copy())]
        for dest, weights in steps:
            futures.append(submit(
                handle.move, None, dest.reshape(-1).copy(),
                np.ones(len(src), np.int8), weights.copy(),
            ))
        for f in futures:
            f.result(timeout=600)


def drive_direct(tally, work):
    """The serial single-client reference: the same campaign on a bare
    facade."""
    for src, steps in work:
        tally.CopyInitialPosition(src.reshape(-1).copy())
        for dest, weights in steps:
            tally.MoveToNextLocation(None, dest.reshape(-1).copy(),
                                     np.ones(len(src), np.int8),
                                     weights.copy())


def run(device="cuda", n=None) -> dict:
    """Both clients' concurrent campaigns through one ``TallyService``,
    then each replayed serially. Returns, per session, the served flux
    and the serial run's (host float64 arrays)."""
    n = N if n is None else n
    mesh = build_box(1.0, 1.0, 1.0, 8, 8, 8, dtype=torch.float64)
    with TallyService() as service:
        handles = {
            name: service.open_session(PumiTally(mesh, n, device=device),
                                       session_id=name)
            for name in CLIENTS
        }
        threads = [
            threading.Thread(target=drive_session,
                             args=(handles[name], campaign(seed, n)),
                             name=name)
            for name, seed in CLIENTS.items()
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        served = {
            name: handles[name].flux().result(timeout=600)
            for name in CLIENTS
        }

    out = {}
    for name, seed in CLIENTS.items():
        solo = PumiTally(mesh, n, device=device)
        solo.arm_deterministic()  # what open_session arms
        drive_direct(solo, campaign(seed, n))
        out[name] = (np.asarray(served[name]), solo.flux.cpu().numpy())
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    for name, (served, solo) in run(args.device).items():
        match = np.array_equal(served, solo)
        print(f"session {name}: sum(flux) = {float(served.sum()):.4f}  "
              f"bitwise vs serial run: {match}")
        assert match, f"{name}: concurrent flux diverged from serial"
    print(f"{len(CLIENTS)} concurrent clients, one device, "
          "zero cross-talk: every session bitwise-identical to its "
          "serial run")


if __name__ == "__main__":
    main()
