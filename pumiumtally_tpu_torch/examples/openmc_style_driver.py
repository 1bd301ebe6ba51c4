"""An OpenMC-style host driver, end to end (the port of
examples/openmc_style_driver.py).

Models how a physics code drives the tally (the reference's OpenMC
integration calls the constructor in openmc_init, the localization in
initialize_batch, the moves in process_advance_particle_events, and the
write in openmc_run): sample sources, localize, run transport "batches"
where each step hands origins/destinations/flags/weights to the tally,
then write VTK.

Run:  python -m pumiumtally_tpu_torch.examples.openmc_style_driver
          [--mode mono|stream|part] [--protocol fast|reference]
          [--vmem-bound B] [--device cuda|cpu] [--out-dir DIR]

--protocol reference passes origins on EVERY move exactly as the
reference's host does; the facade's auto_continue detects the echoes and
skips the redundant uploads, so it costs the same as the explicit
origins=None fast path. Partitioned mode writes rank-aware .pvtu pieces,
one a device of the mesh (every visible card; one CPU shard with
``--device cpu``); ``--vmem-bound`` sub-splits its mesh into blocks of at
most that many elements, walked by the block walk W1.

The mesh and the walk run in float64, so the 1e-6 conservation check is
meaningful on any device. The transport physics here is a stand-in
random walk; swap in a real physics code by replacing `sample_step`.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from pumiumtally_tpu_torch import (
    PartitionedPumiTally,
    PumiTally,
    StreamingTally,
    TallyConfig,
    build_box,
)

N = 20_000
BATCHES = 3
STEPS_PER_BATCH = 4
CHUNK = 8192  # StreamingTally's particles a chunk


def sample_step(rng, pos):
    """Next flight destinations + per-particle weights (physics stand-in)."""
    d = pos + rng.normal(scale=0.15, size=pos.shape)
    return np.clip(d, 0.01, 0.99), rng.uniform(0.5, 1.5, pos.shape[0])


def make_tally(mode: str, mesh, n: int, device, vmem_bound=None):
    if mode == "stream":
        return StreamingTally(mesh, n, chunk_size=CHUNK, device=device)
    if mode == "part":
        from pumiumtally_tpu_torch.parallel import make_device_mesh

        dev = torch.device(device)
        dm = (make_device_mesh() if dev.type == "cuda"
              else make_device_mesh(devices=[dev]))
        return PartitionedPumiTally(
            mesh, n,
            TallyConfig(device_mesh=dm, capacity_factor=4.0,
                        walk_vmem_max_elems=vmem_bound),
            device=device,
        )
    return PumiTally(mesh, n, device=device)


def run(mode: str = "mono", protocol: str = "fast", vmem_bound=None,
        device="cuda", n=None, out_dir: str = ".") -> dict:
    """One campaign of BATCHES x STEPS_PER_BATCH moves of ``n``
    particles on the 3,072-tet box. Returns the facade, the flux sum and
    its analytic value, the relative error, the auto_continue hits and
    the file written."""
    n = N if n is None else n
    mesh = build_box(1.0, 1.0, 1.0, 8, 8, 8, dtype=torch.float64)
    tally = make_tally(mode, mesh, n, device, vmem_bound=vmem_bound)
    rng = np.random.default_rng(0)

    total_expected = 0.0
    for batch in range(BATCHES):
        # New batch: resample every source (so the first move passes
        # explicit origins: the reference's phase-A relocation path).
        pos = rng.uniform(0.05, 0.95, (n, 3))
        tally.CopyInitialPosition(pos.reshape(-1).copy())
        origins = pos
        for step in range(STEPS_PER_BATCH):
            dests, weights = sample_step(rng, origins)
            flying = np.ones(n, np.int8)
            if step == 0 or protocol == "reference":
                # Reference protocol: origins passed every call. After
                # step 0 they echo the committed positions, so
                # auto_continue skips the upload and phase A.
                tally.MoveToNextLocation(
                    origins.reshape(-1).copy(), dests.reshape(-1).copy(),
                    flying, weights,
                )
            else:
                # Continuing particles: the fast path skips phase A.
                tally.MoveToNextLocation(
                    None, dests.reshape(-1).copy(), flying, weights,
                )
            assert flying.sum() == 0  # zeroed in place, per the protocol
            total_expected += float(
                (np.linalg.norm(dests - origins, axis=1) * weights).sum()
            )
            origins = dests
        print(f"batch {batch}: done")

    got = float(tally.flux.sum())
    rel = abs(got - total_expected) / total_expected
    out = os.path.join(out_dir, "fluxresult.pvtu" if mode == "part"
                       else "fluxresult.vtk")
    tally.WriteTallyResults(out)
    return {"tally": tally, "flux_sum": got, "expected": total_expected,
            "rel": rel, "hits": tally.auto_continue_hits, "out": out}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["mono", "stream", "part"],
                    default="mono")
    ap.add_argument("--protocol", choices=["fast", "reference"],
                    default="fast",
                    help="reference = origins passed every move (the "
                         "host-side echo is deduped automatically)")
    ap.add_argument("--vmem-bound", type=int, default=None,
                    help="part mode: per-device element bound of the "
                         "block walk (oversized partitions sub-split into "
                         "blocks; see TallyConfig.walk_vmem_max_elems)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--out-dir", default=".",
                    help="where the VTK output goes")
    args = ap.parse_args(argv)

    r = run(args.mode, args.protocol, args.vmem_bound, args.device,
            out_dir=args.out_dir)
    print(f"sum(flux) = {r['flux_sum']:.4f}  analytic = "
          f"{r['expected']:.4f}  rel err = {r['rel']:.2e}")
    if args.protocol == "reference":
        print(f"origin uploads deduped: {r['hits']} "
              f"of {BATCHES * STEPS_PER_BATCH} moves")
    assert r["rel"] < 1e-6
    print(f"wrote {os.path.basename(r['out'])} ({args.mode} mode)")


if __name__ == "__main__":
    main()
