"""The deterministic commit's host plan (``ops/det_commit.py`` ``dc_plan``)
and a model of DC's partition over it, on the CPU.

DC (csrc/det_commit.cu) runs only on the card; chip_smoke.py holds it
bitwise against ``det_commit_plain`` there. Here the plan that sizes its
launches is held to what the kernels need of it, over hypothesis-drawn
record counts, bank sizes and dtypes on an H100's numbers: the shared
memory each kernel asks for fits a block (two tile-commit CTAs an SM),
the stage's layout fits what is asked, the scratch fits what
``DetRecords.reserve`` holds, and every place fits int32 up to the
58M-record case of the 17.2M-tet box. A numpy model of the partition
(tile, window, split digit, key group, the over-full choice) over the
plan then commits records tile by tile in (key, ord) order and equals
``det_commit_plain`` bitwise; ``det_commit_plain`` itself agrees with the
JAX scatter-add of the same records.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pumiumtally_tpu_torch.ops import det_commit as dc

H100 = (232448, 233472, 132)  # opt-in smem a block, smem an SM, SMs
A100 = (166912, 167936, 108)
I32 = 2**31
CSRC = (Path(dc.__file__).resolve().parents[1] / "csrc"
        / "det_commit.cu").read_text()


def _define(name: str) -> int:
    return int(re.search(rf"#define {name} (\d+)", CSRC)[1])


def test_constants_match_the_kernels():
    """The plan's copies of csrc/det_commit.cu's constants, and the
    length of the plan the entry reads."""
    assert dc.DC_THREADS == _define("DC_THREADS")
    assert dc.DC_SUB == _define("DC_SUB")
    assert dc.DC_HIST_MAX == _define("DC_HIST_MAX")
    assert dc.DC_BIG_MAX == _define("DC_BIG_MAX")
    assert dc.DC_WARP_MAX == _define("DC_WARP_MAX")
    plan = dc.dc_plan(1000, 48000, 4, *H100)
    assert len(plan.host_args()) == _define("DC_PLAN_LEN")


def _check_plan(m: int, K: int, elem: int, dev=H100) -> dc.DcPlan:
    smem_block, smem_sm, sms = dev
    p = dc.dc_plan(m, K, elem, *dev)
    # The stage and the group arrays are the tile commit's dynamic
    # shared memory, and two such CTAs (with their static arrays and
    # the system's share) fit an SM.
    assert p.stage >= 1
    assert p.tiles_smem == p.stage * (12 + elem) + 8 * (dc.DC_HIST_MAX + 1)
    assert p.tiles_smem <= smem_block
    assert dc.CTAS_PER_SM * (p.tiles_smem + dc.STATIC_SMEM) <= smem_sm
    assert p.stage <= dc.DC_BIG_MAX * dc.DC_WARP_MAX
    # The splits and the histogram fit a block.
    assert p.coarse_smem == dc.split_smem(p.windows, elem) <= smem_block
    assert p.fine_smem == dc.split_smem(p.tw, elem) <= smem_block
    assert 4 * p.tiles <= smem_block
    # Tiles cover the keys, windows the tiles, chunks the records.
    assert 1 <= p.tk <= K
    assert (p.tiles - 1) * p.tk < K <= p.tiles * p.tk
    assert p.tiles <= max(dc.DC_TILES_MAX, 1)
    assert 1 <= p.groups <= dc.DC_HIST_MAX
    assert ((p.tk - 1) >> p.group_shift) + 1 == p.groups
    assert 1 <= p.tw <= dc.DC_HIST_MAX and p.windows <= dc.DC_HIST_MAX
    assert (p.windows - 1) * p.tw < p.tiles <= p.windows * p.tw
    assert p.chunk_records % dc.DC_THREADS == 0
    assert (p.chunks - 1) * p.chunk_records < m <= p.chunks * p.chunk_records
    assert 1 <= p.overfull_grid <= min(p.tiles, sms)
    # Every place, count and grid fits int32.
    assert p.scratch_ints == 3 * p.tiles + p.windows + 2 + p.windows * p.chunks
    for v in (p.scratch_ints, p.windows * p.chunks, p.tiles * p.chunks,
              -(-m // dc.DC_SUB) + p.windows, p.chunk_records):
        assert v < I32
    # The scratch fits what DetRecords.reserve(m) holds: two buffers of
    # partitioned records.
    dtype = torch.float32 if elem == 4 else torch.float64
    assert 2 * m * dc.rec_bytes(elem) <= 8 * dc.b_rec_words(m, dtype)
    return p


@settings(max_examples=300, deadline=None, database=None, derandomize=True)
@given(m=st.integers(1, I32 - 1), K=st.integers(1, I32 - 1),
       elem=st.sampled_from([4, 8]))
def test_plan_fits_the_kernels(m, K, elem):
    _check_plan(m, K, elem)


@settings(max_examples=100, deadline=None, database=None, derandomize=True)
@given(m=st.integers(1, 60_000_000), K=st.integers(1, 20_000_000),
       elem=st.sampled_from([4, 8]), dev=st.sampled_from([H100, A100]))
def test_plan_fits_the_kernels_on_the_main_paths_sizes(m, K, elem, dev):
    p = _check_plan(m, K, elem, dev)
    # A tile's expected records fill at most half the stage unless the
    # cap on the tiles widened them or a key alone holds more.
    if p.tk > max(1, -(-K // dc.DC_TILES_MAX)):
        assert m * p.tk <= (p.stage // 2) * K


@pytest.mark.parametrize("m,K,elem,expect", [
    (1, 1, 4, dict(tk=1, tiles=1)),
    (5_000, 1, 4, dict(tk=1, tiles=1, groups=1)),
    (100, 48_000, 4, dict(tk=48_000, tiles=1)),  # m under one tile
    (3_072, 1_025, 4, dict(tk=1_024, tiles=2)),  # K = TK + 1
    (8_218_077, 48_000, 4, dict(group_shift=0)),  # box flux
    (23_917_392, 4_608_000, 4, dict(group_shift=0)),  # stride-96 lanes
    (13_401_825, 984_960, 4, dict(group_shift=0)),  # lattice flux
    (9_867_793, 6 * 48_000, 4, dict(group_shift=0)),  # service bank
    (1_643_615, 48_000, 8, dict(group_shift=0)),  # float64 box
    (58_000_000, 17_179_728, 4, {}),  # the 17.2M-tet box with a policy
    (1_000_000, 300_000_000, 4, {}),  # a sparse bank: key groups
    (I32 - 1, I32 - 1, 8, {}),
])
def test_plan_cases(m, K, elem, expect):
    p = _check_plan(m, K, elem)
    for k, v in expect.items():
        assert getattr(p, k) == v, (k, p)
    if K % p.tk:
        # The last tile is partial: its keys and groups stop at K.
        nk = K - (p.tiles - 1) * p.tk
        assert 0 < nk < p.tk
    if m * p.tk < K:
        assert p.tiles * p.chunks < I32


def test_plan_sizes_the_tiles_to_the_stage():
    """The box's flux: about half a stage a tile, in whole rounds of the
    warps' sorts; a bank much larger than the records groups its keys."""
    p = dc.dc_plan(8_218_077, 48_000, 4, *H100)
    assert p.tk % dc.DC_WARPS == 0
    assert p.stage // 4 <= 8_218_077 * p.tk / 48_000 <= p.stage // 2
    q = dc.dc_plan(1_000_000, 300_000_000, 4, *H100)
    assert q.group_shift > 0 and q.groups <= dc.DC_HIST_MAX


def test_plan_refuses_nothing_it_cannot_hold():
    with pytest.raises(ValueError):
        dc.dc_plan(0, 10, 4, *H100)
    with pytest.raises(ValueError):
        dc.dc_plan(10, 10, 4, 48 * 1024, 64 * 1024, 1)


def _records(seed: int, m: int, K: int, dtype, hot=None):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, K, m).astype(np.int32)
    if hot is not None:
        key[: hot[1]] = hot[0]
    rng.shuffle(key)
    ords = ((rng.integers(0, 64, m).astype(np.int64) << 32)
            | rng.permutation(m).astype(np.int64))
    val = (rng.uniform(-0.5, 1.5, m)).astype(dtype)
    start = rng.uniform(0, 1, K).astype(dtype)
    return key, ords, val, start


def _model_commit(key, ords, val, start, plan: dc.DcPlan, K: int):
    """DC's partition over ``plan`` as the kernels index it, then each
    tile committed in (key, ord) order: a tile past the stage by the
    over-full path, the others group by group. Returns the target and
    the over-full tiles."""
    tile = key // plan.tk
    assert tile.max() < plan.tiles
    win = tile // plan.tw
    assert win.max() < plan.windows
    digit = tile - win * plan.tw
    assert digit.max() < plan.tw
    out = start.copy()
    overfull = 0
    for t in np.unique(tile):
        sel = np.nonzero(tile == t)[0]
        k0 = int(t) * plan.tk
        nk = min(plan.tk, K - k0)
        groups = ((nk - 1) >> plan.group_shift) + 1
        grp = (key[sel] - k0) >> plan.group_shift
        assert grp.min() >= 0 and grp.max() < groups <= dc.DC_HIST_MAX
        if sel.size > plan.stage:
            overfull += 1
            order = sel[np.lexsort((ords[sel], key[sel]))]
        else:
            order = np.concatenate([
                sel[grp == j][np.lexsort((ords[sel][grp == j],
                                          key[sel][grp == j]))]
                for j in np.unique(grp)])
        for r in order:
            out[key[r]] = out[key[r]] + val[r]
    return out, overfull


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,K,hot,overfull", [
    (4_000, 48_000, None, 0),
    (9_000, 48_000, (1_234, 7_000), 1),  # one hot key past the stage
    (3_000, 1, None, 0),  # K = 1
    (20_000, 5_000, None, 0),
    (3_000, 10_000_000, None, 0),  # a sparse bank: key groups
])
def test_model_of_the_partition_equals_det_commit_plain(dtype, m, K, hot,
                                                        overfull):
    key, ords, val, start = _records(7 + m, m, K, dtype, hot)
    plan = dc.dc_plan(m, K, np.dtype(dtype).itemsize, *H100)
    got, n_over = _model_commit(key, ords, val, start, plan, K)
    assert n_over == overfull
    want = torch.tensor(start)
    dc.det_commit_plain(want, torch.tensor(key), torch.tensor(ords),
                        torch.tensor(val))
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_det_commit_on_the_cpu_is_the_plain_version(dtype):
    """CPU tensors take ``det_commit_plain``; the records are left as
    they were."""
    m, K = 5_000, 300
    key, ords, val, start = _records(3, m, K,
                                     np.float32 if dtype == torch.float32
                                     else np.float64)
    rec = dc.DetRecords(torch.device("cpu"), dtype)
    rec.reserve(m + 100)
    rec.key[:m], rec.ord[:m] = torch.tensor(key), torch.tensor(ords)
    rec.val[:m] = torch.tensor(val)
    got, want = torch.tensor(start), torch.tensor(start)
    dc.det_commit(got, rec, m)
    dc.det_commit_plain(want, torch.tensor(key), torch.tensor(ords),
                        torch.tensor(val))
    assert torch.equal(got, want)
    assert torch.equal(rec.key[:m], torch.tensor(key))
    assert rec.b_rec.numel() == dc.b_rec_words(m + 100, dtype)


def test_det_commit_plain_agrees_with_the_jax_scatter_add():
    """The JAX walks commit flux by a scatter-add; the deterministic
    commit's sum of the same records in float64 agrees with it to
    rounding (the orders differ)."""
    key, ords, val, start = _records(11, 20_000, 777, np.float64)
    want = jnp.asarray(start).at[jnp.asarray(key)].add(jnp.asarray(val))
    got = torch.tensor(start)
    dc.det_commit_plain(got, torch.tensor(key), torch.tensor(ords),
                        torch.tensor(val))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
