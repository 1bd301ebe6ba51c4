"""Multi-shard partitioned run with autotuning, checkpointing, and
rank-aware output: the features a long physics campaign combines (the
port of examples/multichip_checkpointed_run.py).

The JAX example spans every visible device (8 virtual CPU devices from
XLA_FLAGS off the TPU); here the shards are given explicitly through
``make_device_mesh(devices=...)``: every card where there are several,
else 4 logical shards of cuda:0, and 8 CPU shards with ``--device cpu``.

Flow:
  1. build a mesh and autotune the walk for this device,
  2. transport moves on the partitioned engine (the mesh's blocks over
     the shards, particles migrating at block faces),
  3. checkpoint mid-campaign; restore into a FRESH engine and continue
     (checkpoints are canonical: any engine kind can resume them),
  4. write a rank-aware multi-piece .pvtu, one piece a shard.

Run:  python -m pumiumtally_tpu_torch.examples.multichip_checkpointed_run
          [--device cuda|cpu] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from pumiumtally_tpu_torch import (
    PartitionedPumiTally,
    TallyConfig,
    build_box,
)
from pumiumtally_tpu_torch.api.tally import resolve_device
from pumiumtally_tpu_torch.parallel import make_device_mesh
from pumiumtally_tpu_torch.utils import (
    autotune_walk,
    load_tally_state,
    save_tally_state,
)
from pumiumtally_tpu_torch.utils.autotune import walk_kwargs

N = 20_000
MOVES_BEFORE, MOVES_AFTER = 2, 2


def shard_devices(device) -> list:
    """The device mesh's entries: every card where there are several,
    else 4 logical shards of cuda:0; 8 shards of the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * 8
    if torch.cuda.device_count() > 1:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cuda", 0)] * 4


def transport(tally, prev, moves, rng):
    for _ in range(moves):
        dst = np.clip(prev + rng.normal(scale=0.2, size=prev.shape),
                      0.02, 0.98)
        tally.MoveToNextLocation(prev.reshape(-1).copy(),
                                 dst.reshape(-1).copy(),
                                 np.ones(len(prev), np.int8),
                                 np.ones(len(prev)))
        prev = dst
    return prev


def run(device="cuda", n=None, out_dir: str = "."):
    """The campaign; returns the resumed facade (its flux is the
    campaign's)."""
    n = N if n is None else n
    dev = resolve_device(device)  # no GPU and no "cpu": raises
    mesh = build_box(1.0, 1.0, 1.0, 8, 8, 8,
                     dtype=torch.float64)  # 3072 tets
    dm = make_device_mesh(devices=shard_devices(dev))

    # 1. measure the walk knobs for THIS device (seconds, done once
    #    per deployment; tuning cannot change physics).
    tuned, report = autotune_walk(mesh, n_particles=min(n, 50_000),
                                  moves=2, device=dev)
    print(f"autotuned: {dict(walk_kwargs(tuned)) or 'defaults win'}")

    cfg = TallyConfig(
        device_mesh=dm,
        capacity_factor=3.0,
        walk_cond_every=tuned.walk_cond_every,
        walk_min_window=tuned.walk_min_window,
    )
    t = PartitionedPumiTally(mesh, n, cfg)

    rng = np.random.default_rng(0)
    src = rng.uniform(0.05, 0.95, (n, 3))
    t.CopyInitialPosition(src.reshape(-1).copy())

    # 2. first half of the campaign
    prev = transport(t, src, MOVES_BEFORE, rng)

    # 3. checkpoint; resume in a FRESH engine (same mesh + n required;
    #    the engine kind need not match the saver's).
    ckpt = os.path.join(out_dir, "campaign.npz")
    save_tally_state(t, ckpt)
    t2 = PartitionedPumiTally(mesh, n, cfg)
    load_tally_state(t2, ckpt)
    transport(t2, prev, MOVES_AFTER, rng)

    # 4. one .vtu piece per shard + the .pvtu index
    t2.WriteTallyResults(os.path.join(out_dir, "flux_result.pvtu"))
    print(f"wrote flux_result.pvtu (+ {dm.size} pieces, one a shard)")
    return t2


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--out-dir", default=".",
                    help="where the checkpoint and the VTK output go")
    args = ap.parse_args(argv)
    run(args.device, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
