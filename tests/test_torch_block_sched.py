"""PyTorch port, the launch geometry the block walks W1 and W2 share
(csrc/block_walk_sched.cuh, mirrored in ops/vmem_walk.py): the
(blocks, k) persistent grid, each CUDA block's share of its partition
block's slots, the shared-memory layout with its work list, and the
batches a share is walked in. The kernels run only on the card; these
checks hold the arithmetic their launcher follows."""

import numpy as np
import pytest
import torch

from pumiumtally_tpu_torch.experiments import block_rounds
from pumiumtally_tpu_torch.experiments.block_rounds import (
    make_trajectory,
    round_bytes,
)
from pumiumtally_tpu_torch.ops import vmem_walk
from pumiumtally_tpu_torch.ops.pallas_walk import (
    pallas_walk_local,
    w2_uses_shared,
)
from pumiumtally_tpu_torch.ops.vmem_walk import (
    SCHED_LIST_MAX,
    SCHED_THREADS,
    SMEM_BYTES_PER_BLOCK,
    sched_batches,
    sched_blocks_per_part,
    sched_chunks,
    sched_smem_layout,
    smem_ceiling_elems,
    vmem_walk_local,
)

H100_SMS = 132
# (partition blocks, slots per block, resident CUDA blocks): chip_smoke's
# W1 and W2 partitions at two resident blocks per SM, W2's one-block
# global regime, and more partition blocks than resident CUDA blocks.
GRIDS = [(47, 21504, 2 * H100_SMS), (24, 41984, 2 * H100_SMS),
         (1, 1_000_001, 2 * H100_SMS), (1000, 1024, H100_SMS),
         (7, 3, 4 * H100_SMS)]


def _itemsize(dt):
    return torch.empty((), dtype=dt).element_size()


@pytest.mark.parametrize("nparts,cap_b,resident", GRIDS)
def test_every_slot_has_exactly_one_cuda_block(nparts, cap_b, resident):
    k = sched_blocks_per_part(nparts, resident)
    assert k >= 1
    # The whole grid is resident at once unless the partition blocks
    # alone outnumber the resident places.
    assert nparts * k <= max(resident, nparts)
    owner = np.full(cap_b, -1)
    for j in range(k):
        for lo, hi in sched_chunks(cap_b, k, j):
            assert 0 <= lo < hi <= cap_b and hi - lo <= SCHED_THREADS
            assert lo % SCHED_THREADS == 0
            assert (owner[lo:hi] == -1).all()
            owner[lo:hi] = j
    assert (owner >= 0).all()  # the same for every partition block b


def test_a_run_of_active_slots_spreads_over_the_cuda_blocks():
    # Migration ranks arrivals by source block: a round's active slots
    # come in runs. A run of 4,000 slots (8 chunks) reaches all five CUDA
    # blocks of a W1 partition block, none holding more than two chunks.
    k = sched_blocks_per_part(47, 264)
    per_block = [sum(max(0, min(hi, 4000) - lo)
                     for lo, hi in sched_chunks(21504, k, j))
                 for j in range(k)]
    assert sum(per_block) == 4000
    assert min(per_block) > 0 and max(per_block) <= 2 * SCHED_THREADS


def test_chip_smoke_partitions_get_five_and_eleven_cuda_blocks():
    # 264 resident CUDA blocks (two per SM): 47 W1 blocks get 5 each
    # (235 resident, no second wave), 24 W2 blocks 11 each.
    assert sched_blocks_per_part(47, 264) == 5
    assert sched_blocks_per_part(24, 264) == 11
    assert sched_blocks_per_part(1, 264) == 264
    assert sched_blocks_per_part(500, 264) == 1


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_shared_bytes_fit_at_the_ceilings(dt):
    it = _itemsize(dt)
    for L, row in ((smem_ceiling_elems(dt), 20 * it),
                   (max(L for L in range(1, 7000) if w2_uses_shared(L, dt)),
                    32)):
        smem, cap = sched_smem_layout(L * row, L * it)
        assert smem <= SMEM_BYTES_PER_BLOCK
        assert SCHED_THREADS <= cap <= SCHED_LIST_MAX
        assert cap % SCHED_THREADS == 0
        # One element more leaves no room for one pass of the list.
        assert sched_smem_layout((L + 1) * row, (L + 1) * it) is None
    # Never staging leaves the whole list.
    smem, cap = sched_smem_layout(0, 0)
    assert cap == SCHED_LIST_MAX and smem <= SMEM_BYTES_PER_BLOCK


def test_layout_of_the_main_path_blocks():
    # W1's 1,022-element f32 blocks: 81,760 B of table, 4,096 B of
    # partial, a 16 KB list; two such CUDA blocks fit one SM's 228 KB.
    smem, cap = sched_smem_layout(1022 * 80, 1022 * 4)
    assert (smem, cap) == (32 + 81_760 + 4_096 + 4 * 4096, 4096)
    assert 2 * (smem + 1024) <= 228 * 1024
    # W2's 2,000-element blocks: 64,000 B of bf16 rows, 8,000 B partial.
    smem, cap = sched_smem_layout(2000 * 32, 2000 * 4)
    assert (smem, cap) == (32 + 64_000 + 8_000 + 4 * 4096, 4096)


@pytest.mark.parametrize("cap_b,k,list_cap", [(21504, 1, 4096),
                                              (21504, 5, 4096),
                                              (41984, 2, 512),
                                              (4096, 1, 4096), (100, 3, 512),
                                              (0, 1, 512)])
def test_batches_cover_a_share_longer_than_the_list(cap_b, k, list_cap):
    for j in range(k):
        chunks = sched_chunks(cap_b, k, j)
        batches = sched_batches(chunks, list_cap)
        per = list_cap // SCHED_THREADS
        assert len(batches) == -(-len(chunks) // per)
        # Every slot of a batch, active or not, fits the list.
        assert all(sum(hi - lo for lo, hi in b) <= list_cap
                   for b in batches)
        assert [c for b in batches for c in b] == chunks


def test_schedule_walks_every_active_slot_once():
    # A later round's input: ~3% of 24 x 41,984 slots active, scattered.
    nparts, cap_b = 24, 41984
    rng = np.random.default_rng(4)
    done = rng.random((nparts, cap_b)) > 0.03
    k = sched_blocks_per_part(nparts, 2 * H100_SMS)
    _, cap = sched_smem_layout(2000 * 32, 2000 * 4)
    walked = np.zeros_like(done, dtype=int)
    for b in range(nparts):
        for j in range(k):
            for batch in sched_batches(sched_chunks(cap_b, k, j), cap):
                act = np.concatenate([np.flatnonzero(~done[b, lo:hi]) + lo
                                      for lo, hi in batch])
                assert act.size <= cap
                walked[b, act] += 1
    np.testing.assert_array_equal(walked, (~done).astype(int))


def test_cpu_refuses_sched_counts():
    # The counts are the kernel's; the plain version has no schedule.
    assert vmem_walk.SCHED_COUNTS[:3] == ("no active slot", "global rows",
                                          "TMA-staged")
    counts = torch.zeros(len(vmem_walk.SCHED_COUNTS), dtype=torch.int32)
    z = torch.zeros((4, 3), dtype=torch.float64)
    i = torch.zeros(4, dtype=torch.int32)
    f = torch.zeros(4, dtype=torch.int8)
    w = torch.zeros(4, dtype=torch.float64)
    b = torch.ones(4, dtype=torch.bool)
    kw = dict(tally=False, tol=1e-8, max_iters=4, blocks=1,
              sched_counts=counts)
    with pytest.raises(ValueError, match="sched_counts"):
        vmem_walk_local(torch.zeros((1, 20), dtype=torch.float64), z, i, z,
                        f, w, b, b, None, **kw)
    lo = torch.zeros((1, 16), dtype=torch.bfloat16)
    hi = torch.zeros((4, 5), dtype=torch.float64)
    with pytest.raises(ValueError, match="sched_counts"):
        pallas_walk_local(lo, hi, z, i, z, f, w, b, b, None, **kw)


def test_round_bytes_counts_what_each_slot_needs():
    # Two blocks of four slots; block 1 has no active slot. f32: 57 B an
    # active slot, 40 B an idle one, 12 B more for an idle one that left
    # the mesh; block 0's 3 elements of 80 B rows and its flux read and
    # written.
    done = torch.tensor([0, 1, 1, 1, 1, 1, 1, 1], dtype=torch.bool)
    exited = torch.tensor([0, 0, 1, 0, 0, 0, 0, 1], dtype=torch.bool)
    got = round_bytes(done, exited, nparts=2, L=3, row_bytes=80, itemsize=4)
    assert got == 57 + 7 * 40 + 2 * 12 + 3 * (80 + 8)
    # Nothing active: only the pass over the slots.
    assert round_bytes(torch.ones(8, dtype=torch.bool), exited, 2, 3, 80,
                       4) == 8 * 40 + 2 * 12


def test_block_rounds_trajectory_is_bench_generator():
    import bench

    for box in (None, [3.78, 3.78, 1.0]):
        got = make_trajectory(np.random.default_rng(3), 50, 2, box=box)
        want = bench.make_trajectory(np.random.default_rng(3), 50, 2,
                                     box=box)
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, w)


def test_block_rounds_records_rounds_on_cpu():
    # A rehearsal at a small size: both kernels' facades record their
    # first move's rounds and a continue move, with a bound for each.
    result = block_rounds.rounds_main(n=300, div=3, device="cpu")
    for kind in ("W1", "W2"):
        line = result[kind]
        assert line["first_move_rounds"] >= 1
        assert line["launches_per_move"] >= 1
        rounds = min(2, line["first_move_rounds"]) + \
            line["launches_per_move"]
        assert len(line["bound_ms"]) == len(line["active"]) == rounds
        assert all(b > 0 for b in line["bound_ms"])
        assert line["active"][0] == 300
