"""Stable bucket partition over small-alphabet int keys (port of
``pumiumtally_tpu/ops/bucketize.py``).

Given keys in ``[0, num_buckets)``, every slot's stable within-bucket
position: bucket 0 first, original order kept inside each bucket. The
JAX package computes this sort-free with counting ranks because an XLA
argsort was its cost; here a stable ``torch.sort`` gives the IDENTICAL
integer permutation, which is all the callers (particle migration)
depend on:

    rank[i]  = #{j < i : key[j] == key[i]}
    start[b] = #{j : key[j] < b}
    perm     = argsort(key, stable=True)
"""

from __future__ import annotations

import torch


def bucket_counts(key: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """[num_buckets] occupancy of each bucket."""
    return torch.bincount(key.long(), minlength=int(num_buckets))


def partition_perm(key: torch.Tensor, num_buckets: int):
    """(perm, counts, starts): ``perm == argsort(key, stable=True)``,
    the per-bucket counts and their exclusive prefix sums."""
    key = key.long()
    counts = bucket_counts(key, num_buckets)
    starts = torch.cumsum(counts, 0) - counts
    perm = torch.sort(key, stable=True).indices
    return perm, counts, starts


def counting_ranks(key: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Stable within-bucket rank of every slot, as int32."""
    key = key.long()
    perm, _, starts = partition_perm(key, num_buckets)
    pos = torch.arange(key.shape[0], device=key.device)
    rank = torch.empty_like(key)
    rank[perm] = pos - starts[key[perm]]
    return rank.to(torch.int32)
