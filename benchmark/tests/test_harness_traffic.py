"""The traffic generator: deterministic from the seed, the same sizes for
every seed, points inside the box, scoring attributes over the filter's
edges."""

import numpy as np
import pytest

from benchmark import traffic
from benchmark.cell import BENCH_DIR, read_json

BOX = [3.78, 3.78, 1.0]
SCORING = {"energy_edges": np.geomspace(1e-5, 2e7, 9),
           "time_edges": np.linspace(0.0, 1.0, 5),
           "scores": ["flux", "heating", "events"]}
# Energy and time draws for a configuration that scores (no cell of
# BENCHMARK.json does yet): the generator's primitives.
ATTRS = {"energy": {"kind": "log_uniform", "out_share": 0.01},
         "time": {"kind": "uniform"}}


def mix(name="two_phase"):
    return dict(read_json(BENCH_DIR / "traffic" / f"{name}.json"), **ATTRS)


def flat(pool):
    out = []
    for b in pool:
        out += b.points + (b.energy or []) + (b.time or []) + [b.weights]
    return out


@pytest.mark.parametrize("seed", [0, 12345, 2**31 + 17, 2**33 + 5])
def test_same_seed_same_traffic(seed):
    a = traffic.make_pool(mix(), seed, 500, BOX, SCORING)
    b = traffic.make_pool(mix(), seed, 500, BOX, SCORING)
    for x, y in zip(flat(a), flat(b), strict=True):
        assert np.array_equal(x, y)


def test_seeds_change_values_not_sizes():
    a = traffic.make_pool(mix(), 1, 400, BOX, SCORING)
    b = traffic.make_pool(mix(), 2, 400, BOX, SCORING)
    assert [x.shape for x in flat(a)] == [x.shape for x in flat(b)]
    assert not np.array_equal(a[0].points[0], b[0].points[0])


def test_points_in_the_box_and_steps_of_the_mean_length():
    m = mix()
    pool = traffic.make_pool(m, 3, 20000, BOX, None)
    box = np.asarray(BOX)
    assert len(pool) == m["pool_batches"]
    for b in pool:
        assert b.moves == m["moves_per_batch"]
        assert b.energy is None and b.time is None
        for p in b.points:
            assert p.flags.c_contiguous and p.dtype == np.float64
            assert (p >= 0.02 * box).all() and (p <= 0.98 * box).all()
        steps = np.linalg.norm(np.diff(np.stack(b.points), axis=0), axis=2)
        # Gaussian steps of per-axis sigma mean_step/sqrt(3): a mean
        # length of mean_step * sqrt(8 / (3 pi)) before reflection, which
        # only shortens them.
        want = m["mean_step"] * np.sqrt(8 / (3 * np.pi))
        assert 0.85 * want < steps.mean() < 1.01 * want


def test_energies_and_times_over_the_edges():
    pool = traffic.make_pool(mix(), 4, 100000, BOX, SCORING)
    e, t = pool[0].energy[0], pool[0].time[0]
    lo, hi = SCORING["energy_edges"][[0, -1]]
    below, above = (e < lo).mean(), (e >= hi).mean()
    assert 0.003 < below < 0.007 and 0.003 < above < 0.007
    assert ((t >= 0) & (t <= 1)).all()


def test_continue_mix_differs_only_in_protocol():
    a, b = mix("two_phase"), mix("continue")
    assert a.pop("protocol") == "two_phase"
    assert b.pop("protocol") == "continue"
    assert a == b


def test_unknown_protocol_refused():
    with pytest.raises(ValueError, match="protocol"):
        traffic.make_pool(dict(mix(), protocol="resample"), 0, 10, BOX,
                          None)


@pytest.mark.parametrize("name", ["two_phase", "continue"])
def test_clipped_corners_lie_on_no_cell_diagonal(name):
    # Clipping piles destinations onto the clip planes, and where two
    # axes clip, onto vertical lines that can lie in a mesh face (a
    # pincell's corner diagonal), so that no tet owns a vertical
    # segment's track. Reflected at the walls, no destination shares its
    # origin's x and y, and none lies on a wall.
    m = mix(name)
    assert "clip_range" not in m
    box = np.asarray(BOX)
    for b in traffic.make_pool(m, 6, 20000, BOX, None):
        for a, c in zip(b.points, b.points[1:]):
            assert not ((a[:, 0] == c[:, 0]) & (a[:, 1] == c[:, 1])).any()
            for k, (lo, hi) in enumerate(zip(0.02 * box, 0.98 * box)):
                assert ((c[:, k] > lo) & (c[:, k] < hi)).all()


def test_reflect_folds_at_both_walls():
    lo, hi = np.array([1.0]), np.array([3.0])
    x = np.array([2.0, 0.5, 3.25, -1.5, 5.5, 7.5])
    assert traffic.reflect(x, lo, hi).tolist() == \
        [2.0, 1.5, 2.75, 2.5, 1.5, 2.5]
