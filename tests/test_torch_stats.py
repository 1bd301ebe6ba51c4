"""PyTorch port, batch statistics: the ports of tests/test_stats.py's
cases on the port's four facades, against a numpy reference of the
per-batch flux deltas and against the JAX package on the same inputs;
plus the scoring bank's statistics lanes (``score_statistics``).

Tolerances, float64: estimators against numpy at rtol 1e-12 (the mean)
and 1e-9 (the variance-derived ones, the textbook sum-of-squares form);
the estimator functions against the JAX package's on the same lanes at
rtol 1e-14 (XLA fuses the arithmetic: an ulp here and there); against
the JAX facades at rtol 1e-10 (flux in another addition order, so
relative errors near zero at atol 1e-10); triggers against the fetched
estimators at rtol 1e-12; within the port, statistics never change
flux, ids or positions: bitwise."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pumiumtally_tpu import PumiTally as JaxPumiTally
from pumiumtally_tpu import TallyConfig as JaxTallyConfig
from pumiumtally_tpu import TriggerSpec as JaxTriggerSpec
from pumiumtally_tpu.io.vtk import read_vtk_cell_scalars
from pumiumtally_tpu.mesh.box import build_box as jax_build_box
from pumiumtally_tpu.stats import estimators as jax_est
from pumiumtally_tpu.stats.triggers import (
    evaluate_trigger as jax_evaluate_trigger,
)
from pumiumtally_tpu_torch import (
    EnergyFilter,
    PartitionedPumiTally,
    PumiTally,
    ScoringSpec,
    StreamingPartitionedTally,
    StreamingTally,
    TallyConfig,
    TriggerSpec,
    convert,
    evaluate_trigger,
)
from pumiumtally_tpu_torch.stats import BatchStatistics
from pumiumtally_tpu_torch.stats import estimators as port_est

N = 240
E = 6 * 4**3
_JMESH = jax_build_box(1, 1, 1, 4, 4, 4)
_MESH = convert.tetmesh_from_arrays(convert.mesh_arrays(_JMESH))
FACADES = ("monolithic", "streaming", "partitioned", "streaming_partitioned")
# The partitioned facades' block walks: W1 on the float32 tables, or W2
# on the two-tier tables (the only scoring block walk) with a spec.
W1 = dict(capacity_factor=4.0, walk_vmem_max_elems=40)
W2 = dict(walk_table_dtype="bfloat16", walk_kernel="pallas", **W1)


def _make(name, **kw):
    cfg = lambda **k: TallyConfig(**kw, **k)  # noqa: E731
    part = W2 if "scoring" in kw else W1
    return {
        "monolithic": lambda: PumiTally(_MESH, N, cfg(), device="cpu"),
        "streaming": lambda: StreamingTally(_MESH, N, chunk_size=100,
                                            config=cfg(), device="cpu"),
        "partitioned": lambda: PartitionedPumiTally(_MESH, N, cfg(**part),
                                                    device="cpu"),
        "streaming_partitioned": lambda: StreamingPartitionedTally(
            _MESH, N, chunk_size=100, config=cfg(**part), device="cpu"),
    }[name]()


def _random_batches(rng, batches, moves):
    """tests/test_stats.py's workload: fresh sources, destinations and
    weights every batch."""
    out = []
    for _ in range(batches):
        src = rng.uniform(0.1, 0.9, (N, 3))
        segs = [(rng.uniform(0.1, 0.9, (N, 3)), rng.uniform(0.5, 1.5, N))
                for _ in range(moves)]
        out.append((src, segs))
    return out


def _drive(t, work, close_each=False, trigger=None):
    results = []
    for src, segs in work:
        t.CopyInitialPosition(src.reshape(-1).copy())
        for d, w in segs:
            t.MoveToNextLocation(None, d.reshape(-1).copy(), None, w.copy())
        if close_each:
            results.append(t.close_batch(trigger))
    return results


def _np(a):
    return convert.host(a).astype(np.float64)


# -- estimators -----------------------------------------------------------------

def test_estimators_match_numpy_and_jax():
    """mean, std dev, rel err and FOM from the lanes against the numpy
    statistics of the per-batch flux deltas, and the estimator functions
    against the JAX package's on the same lanes."""
    t = _make("monolithic", batch_stats=True)
    work = _random_batches(np.random.default_rng(3), 5, 2)
    deltas, prev = [], np.zeros(E)
    for src, segs in work:
        _drive(t, [(src, segs)])
        now = _np(t.flux)
        deltas.append(now - prev)
        prev = now
        t.close_batch()
    st = t.finalize()
    assert st.num_batches == 5
    x = np.stack(deltas)
    np.testing.assert_allclose(_np(st.mean), x.mean(0), rtol=1e-12)
    np.testing.assert_allclose(_np(st.std_dev), x.std(0, ddof=1),
                               rtol=1e-9, atol=1e-13)
    re = _np(st.rel_err)
    scored = x.mean(0) > 0
    expect = x.std(0, ddof=1)[scored] / np.sqrt(5) / x.mean(0)[scored]
    np.testing.assert_allclose(re[scored], expect, rtol=1e-9, atol=1e-13)
    assert np.all(np.isinf(re[~scored]))
    fom = _np(st.figure_of_merit)
    assert np.all(fom[scored][expect > 0] > 0) and np.all(fom[~scored] == 0)
    # The estimator functions against the JAX package's, same lanes.
    js, jq = jnp.asarray(_np(st.flux_sum)), jnp.asarray(_np(st.flux_sq_sum))
    for name in ("sample_variance", "std_dev", "rel_err"):
        np.testing.assert_allclose(
            _np(getattr(port_est, name)(st.flux_sum, st.flux_sq_sum, 5)),
            np.asarray(getattr(jax_est, name)(js, jq, 5)), rtol=1e-14,
            err_msg=name)
    np.testing.assert_allclose(
        _np(port_est.batch_mean(st.flux_sum, 5)),
        np.asarray(jax_est.batch_mean(js, 5)), rtol=1e-14)
    np.testing.assert_allclose(
        _np(port_est.figure_of_merit(st.rel_err, 2.5)),
        np.asarray(jax_est.figure_of_merit(jax_est.rel_err(js, jq, 5), 2.5)),
        rtol=1e-14)


def test_empty_batch_is_not_a_sample_and_sourcing_rolls_batches():
    t = _make("monolithic", batch_stats=True)
    rng = np.random.default_rng(4)
    _drive(t, _random_batches(rng, 2, 1), close_each=True)
    assert t._stats.num_batches == 2
    before = _np(t._stats.flux_sum).copy()
    t.close_batch()  # nothing moved since the last close
    t.close_batch()
    assert t._stats.num_batches == 2
    np.testing.assert_array_equal(_np(t._stats.flux_sum), before)
    for _ in range(2):  # CopyInitialPosition with no move: a no-op close
        t.CopyInitialPosition(rng.uniform(0.1, 0.9, (N, 3)).reshape(-1))
    assert t._stats.num_batches == 2
    # Without close_batch: each CopyInitialPosition closes the batch
    # before it; finalize closes the last and leaves none open.
    t2 = _make("monolithic", batch_stats=True)
    _drive(t2, _random_batches(rng, 3, 2))
    assert t2._stats.num_batches == 2
    assert t2.finalize().num_batches == 3 and not t2._stats.batch_open


def test_stats_disabled_surface_raises():
    t = _make("monolithic")
    for call in (t.close_batch, t.batch_statistics, t.finalize):
        with pytest.raises(RuntimeError, match="batch_stats=True"):
            call()


@pytest.mark.parametrize("kw,match", [
    (dict(threshold=0.1, metric="variance"), "metric"),
    (dict(threshold=0.0), "threshold"),
    (dict(threshold=0.1, quantile=0.0), "quantile"),
])
def test_trigger_spec_validation_matches_jax(kw, match):
    msgs = []
    for cls in (JaxTriggerSpec, TriggerSpec):
        with pytest.raises(ValueError, match=match) as e:
            cls(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# -- the facades -----------------------------------------------------------------

@pytest.mark.parametrize("name", FACADES)
def test_stats_never_perturb_the_engine(name):
    """Statistics on, closing batches and evaluating a trigger
    throughout, leave flux, positions and ids bitwise those of the run
    without."""
    work = _random_batches(np.random.default_rng(11), 2, 2)
    t_off, t_on = _make(name), _make(name, batch_stats=True)
    _drive(t_off, work)
    _drive(t_on, work, close_each=True, trigger=TriggerSpec(threshold=0.5))
    np.testing.assert_array_equal(_np(t_on.flux), _np(t_off.flux))
    np.testing.assert_array_equal(t_on.positions, t_off.positions)
    np.testing.assert_array_equal(t_on.elem_ids, t_off.elem_ids)
    assert t_off._stats is None and t_on._stats.num_batches == 2


@pytest.mark.parametrize("name", FACADES)
def test_facade_statistics_match_jax(name):
    """The same batches through the port's facade and the JAX package's
    ``PumiTally`` (tests/test_stats.py holds each JAX engine to that
    one): equal batch counts, means, relative errors and trigger
    verdicts."""
    work = _random_batches(np.random.default_rng(12), 3, 2)
    trig = dict(threshold=0.2, quantile=0.5)
    ref = JaxPumiTally(_JMESH, N, JaxTallyConfig(batch_stats=True))
    port = _make(name, batch_stats=True)
    rj = _drive(ref, work, close_each=True, trigger=JaxTriggerSpec(**trig))
    rp = _drive(port, work, close_each=True, trigger=TriggerSpec(**trig))
    for a, b in zip(rp, rj):
        assert (a.converged, a.num_batches, a.batches_remaining) == \
            (b.converged, b.num_batches, b.batches_remaining)
        np.testing.assert_allclose(a.value, b.value, rtol=1e-10)
    sj, sp = ref.finalize(), port.finalize()
    assert sp.num_batches == sj.num_batches == 3
    np.testing.assert_allclose(_np(sp.mean), np.asarray(sj.mean),
                               rtol=1e-10, atol=1e-13)
    re_j, re_p = np.asarray(sj.rel_err), _np(sp.rel_err)
    np.testing.assert_array_equal(np.isfinite(re_p), np.isfinite(re_j))
    fin = np.isfinite(re_j)
    np.testing.assert_allclose(re_p[fin], re_j[fin], rtol=1e-10, atol=1e-10)


# -- triggers --------------------------------------------------------------------

def test_trigger_early_stop_on_box_workload():
    """tests/test_stats.py's alternating-weight batches (identical
    geometry, weights 1.0/1.2): monotone decay, the stop at the
    threshold, and the first projection within 2x of the stop."""
    t = _make("monolithic", batch_stats=True,
              batch_stats_trigger=TriggerSpec(threshold=0.035))
    rng = np.random.default_rng(13)
    src = rng.uniform(0.1, 0.9, (N, 3))
    dst = rng.uniform(0.1, 0.9, (N, 3))
    values, projection, actual = [], None, None
    for b in range(40):
        t.CopyInitialPosition(src.reshape(-1).copy())
        t.MoveToNextLocation(None, dst.reshape(-1).copy(), None,
                             np.full(N, 1.0 if b % 2 == 0 else 1.2))
        res = t.close_batch()
        assert res.num_batches == b + 1
        if np.isfinite(res.value):
            values.append(res.value)
        if projection is None and res.batches_remaining not in (None, 0):
            projection = res.num_batches + res.batches_remaining
        if res.converged:
            assert res.batches_remaining == 0
            actual = res.num_batches
            break
    assert actual is not None and values[-1] <= 0.035
    assert all(b < a for a, b in zip(values, values[1:])), values
    assert projection is not None and actual / 2 <= projection <= actual * 2


def test_trigger_quantile_and_std_err_metrics_match_jax():
    """Quantiles of the per-element metric and the std_err metric
    against the fetched estimators and against the JAX
    ``evaluate_trigger`` on the same lanes."""
    t = _make("monolithic", batch_stats=True)
    _drive(t, _random_batches(np.random.default_rng(14), 4, 2),
           close_each=True)
    stats = t._stats

    class JaxLanes:  # the JAX evaluator reads the lanes duck-typed
        num_batches = stats.num_batches
        flux_sum = np.asarray(_np(stats.flux_sum))
        flux_sq_sum = np.asarray(_np(stats.flux_sq_sum))

    re = _np(t.batch_statistics().rel_err)
    scored = np.sort(re[np.isfinite(re)])
    sem = _np(t.batch_statistics().std_dev) / np.sqrt(4)
    for kw, want in ((dict(), scored[-1]),
                     (dict(quantile=0.5),
                      scored[int(np.ceil(0.5 * scored.size)) - 1]),
                     (dict(metric="std_err"), np.max(sem[np.isfinite(re)]))):
        got = evaluate_trigger(stats, TriggerSpec(threshold=1e-9, **kw))
        ref = jax_evaluate_trigger(JaxLanes,
                                   JaxTriggerSpec(threshold=1e-9, **kw))
        np.testing.assert_allclose(got.value, want, rtol=1e-12)
        np.testing.assert_allclose(got.value, ref.value, rtol=1e-12)
        assert got.converged == ref.converged
        assert got.batches_remaining == pytest.approx(ref.batches_remaining,
                                                      rel=1e-12)


def test_negative_flux_elements_stay_scored():
    t = _make("monolithic", batch_stats=True)
    rng = np.random.default_rng(18)
    for b in range(3):
        t.CopyInitialPosition(rng.uniform(0.1, 0.9, (N, 3)).reshape(-1))
        t.MoveToNextLocation(None, rng.uniform(0.1, 0.9, (N, 3)).reshape(-1),
                             None, np.full(N, -1.0 - 0.1 * b))
        t.close_batch()
    st = t.batch_statistics()
    mean, re = _np(st.mean), _np(st.rel_err)
    assert (mean < 0).any() and np.all(np.isfinite(re[mean < 0]))
    np.testing.assert_array_equal(np.isinf(re), mean == 0.0)
    res = evaluate_trigger(t._stats, TriggerSpec(threshold=1e-9))
    np.testing.assert_allclose(res.value, np.max(re[np.isfinite(re)]),
                               rtol=1e-12)


def test_trigger_needs_two_batches():
    t = _make("monolithic", batch_stats=True)
    res = t.close_batch(TriggerSpec(threshold=0.1))
    assert not res.converged and np.isinf(res.value)
    assert res.batches_remaining is None and res.num_batches == 0
    _drive(t, _random_batches(np.random.default_rng(15), 1, 1))
    res = t.close_batch(TriggerSpec(threshold=0.1))
    assert not res.converged and res.num_batches == 1
    assert res.batches_remaining is None


# -- VTK payload and the scoring lanes -------------------------------------------

def test_write_tally_results_stats_arrays(tmp_path):
    """flux_mean (volume-normalised) and rel_err (infs written as 0)
    beside flux and volume; with stats off, or no closed batch, the
    reference payload only."""
    t = _make("monolithic", batch_stats=True)
    _drive(t, _random_batches(np.random.default_rng(16), 3, 2),
           close_each=True)
    out = str(tmp_path / "stats.vtk")
    t.WriteTallyResults(out)
    st = t.batch_statistics()
    vol = _np(_MESH.volumes)
    np.testing.assert_allclose(read_vtk_cell_scalars(out, "flux_mean"),
                               _np(st.mean) / vol, rtol=1e-12)
    re = _np(st.rel_err)
    np.testing.assert_allclose(read_vtk_cell_scalars(out, "rel_err"),
                               np.where(np.isfinite(re), re, 0.0),
                               rtol=1e-12)
    np.testing.assert_allclose(read_vtk_cell_scalars(out, "flux"),
                               _np(t.flux) / vol, rtol=1e-12)
    for cfg in ({}, {"batch_stats": True}):
        t = _make("monolithic", **cfg)
        _drive(t, _random_batches(np.random.default_rng(17), 1, 1))
        out = str(tmp_path / f"plain_{bool(cfg)}.vtk")
        t.WriteTallyResults(out)
        assert read_vtk_cell_scalars(out, "flux").size
        with pytest.raises(KeyError):
            read_vtk_cell_scalars(out, "flux_mean")


@pytest.mark.parametrize("name", FACADES)
def test_score_statistics_lanes(name):
    """With batch_stats and a spec the bank gets its own lanes: their
    per-lane mean over closed batches is the numpy mean of the bank's
    batch deltas; the flux statistics ride beside them."""
    spec = ScoringSpec([EnergyFilter([0.0, 1.0, 2.0])],
                       ["flux", "heating", "events"])
    t = _make(name, batch_stats=True, scoring=spec)
    rng = np.random.default_rng(43)
    deltas, prev = [], np.zeros(E * 6)
    for src, segs in _random_batches(rng, 3, 1):
        t.CopyInitialPosition(src.reshape(-1).copy())
        for d, w in segs:
            t.MoveToNextLocation(None, d.reshape(-1).copy(), None, w,
                                 energy=rng.uniform(0.0, 2.0, N))
        now = _np(t.score_bank)
        deltas.append(now - prev)
        prev = now
        t.close_batch()
    st = t.score_statistics()
    assert st.num_batches == 3 and t.batch_statistics().num_batches == 3
    np.testing.assert_allclose(_np(st.mean), np.stack(deltas).mean(0),
                               rtol=1e-12, atol=1e-300)
    # The lanes ride convert's facade state and come back exactly.
    if name in ("monolithic", "partitioned"):
        state = convert.facade_state(t)
        t2 = _make(name, batch_stats=True, scoring=spec)
        convert.load_facade_state(t2, state)
        for k in ("stats_flux_sum", "sstats_flux_sq_sum", "sstats_open_flux"):
            np.testing.assert_array_equal(convert.facade_state(t2)[k],
                                          state[k])
        assert t2.score_statistics().num_batches == 3
        np.testing.assert_array_equal(_np(t2.score_bank), _np(t.score_bank))
    with pytest.raises(RuntimeError, match="batch_stats=True"):
        _make(name, scoring=spec).score_statistics()


def test_statistics_tensors_stay_on_the_lanes_device():
    st = BatchStatistics(torch.ones(3, dtype=torch.float32),
                         torch.ones(3, dtype=torch.float32) * 2, 2)
    for f in ("mean", "std_dev", "rel_err"):
        v = getattr(st, f)
        assert v.dtype == torch.float32 and v.device.type == "cpu"
    with pytest.raises(ValueError, match="elapsed_seconds"):
        st.figure_of_merit
