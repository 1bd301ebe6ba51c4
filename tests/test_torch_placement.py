"""PyTorch port, topology-aware placement: ``pod_rcb_partition`` and
``build_partition(placement=, hosts=)`` give the JAX package's owner
and partition arrays element for element, the cross-host byte models
give its numbers, ``derive_host_counts`` reads a mesh's process
boundaries, the config and the engine validate the knobs as the JAX
package does, and on eight CPU shards the engine's "pod_rcb" class on
the pinned (3, 5) host layout keeps positions bitwise, ids differing
only at face ties, and the flux conserved (rtol 1e-12), with the
modeled cross-host bytes dropping."""

import numpy as np
import pytest
import torch

from pumiumtally_tpu import PartitionedPumiTally as JaxPartitioned
from pumiumtally_tpu import TallyConfig as JaxTallyConfig
from pumiumtally_tpu.mesh.box import build_box as jax_build_box
from pumiumtally_tpu.parallel import make_device_mesh as jax_device_mesh
from pumiumtally_tpu.parallel import distributed as jdist
from pumiumtally_tpu.parallel import partition as jpart
from pumiumtally_tpu_torch import PartitionedPumiTally, TallyConfig, convert
from pumiumtally_tpu_torch.parallel import DeviceMesh, make_device_mesh
from pumiumtally_tpu_torch.parallel.distributed import (
    derive_host_counts,
    modeled_cross_host_migration_bytes,
)
from pumiumtally_tpu_torch.parallel.partition import (
    PLACEMENTS,
    build_partition,
    pod_rcb_partition,
)

CPU = torch.device("cpu")
FCOLS, ICOLS = 10, 9


def _pmesh(*box):
    jm = jax_build_box(*box)
    return jm, convert.tetmesh_from_arrays(convert.mesh_arrays(jm))


@pytest.mark.parametrize("nparts,hosts", [
    (8, (4, 4)), (8, (3, 5)), (16, (6, 10)), (5, (1, 2, 2)),
])
def test_pod_rcb_partition_arrays_match_jax(nparts, hosts):
    jm, mesh = _pmesh(2, 1, 1, 6, 3, 3)
    c = np.asarray(jm.coords)[np.asarray(jm.tet2vert)].mean(axis=1)
    np.testing.assert_array_equal(
        pod_rcb_partition(c, nparts, hosts),
        jpart.pod_rcb_partition(c, nparts, hosts))
    p = build_partition(mesh, nparts, placement="pod_rcb", hosts=hosts)
    j = jpart.build_partition(jm, nparts, placement="pod_rcb", hosts=hosts)
    got, want = convert.partition_arrays(p), convert.partition_arrays(j)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(p.remote_faces, j.remote_faces)


def test_placement_owner_rules():
    _, mesh = _pmesh(1, 1, 1, 6, 6, 6)
    lin = build_partition(mesh, 8)
    np.testing.assert_array_equal(
        lin.owner,
        build_partition(mesh, 8, placement="pod_rcb", hosts=[4, 4]).owner)
    assert not np.array_equal(
        lin.owner,
        build_partition(mesh, 8, placement="pod_rcb", hosts=[3, 5]).owner)
    np.testing.assert_array_equal(
        lin.owner, build_partition(mesh, 8, placement="linear").owner)
    with pytest.raises(ValueError, match="placement"):
        build_partition(mesh, 8, placement="hilbert")
    with pytest.raises(ValueError, match="hosts="):
        build_partition(mesh, 8, placement="pod_rcb")
    with pytest.raises(ValueError, match="host_parts"):
        pod_rcb_partition(np.zeros((4, 3)), 8, [3, 4])
    assert PLACEMENTS == jpart.PLACEMENTS == ("linear", "pod_rcb")


@pytest.mark.parametrize("bpc", [1, 2])
def test_modeled_cross_host_bytes_match_jax(bpc):
    jm, mesh = _pmesh(2, 1, 1, 8, 4, 4)
    hosts = (3, 5)
    out = []
    for placement in ("linear", "pod_rcb"):
        kw = dict(placement=placement,
                  hosts=None if placement == "linear"
                  else [h * bpc for h in hosts])
        p = build_partition(mesh, 8 * bpc, **kw)
        j = jpart.build_partition(jm, 8 * bpc, **kw)
        got = modeled_cross_host_migration_bytes(p.remote_faces, bpc,
                                                 hosts, FCOLS, ICOLS)
        assert got == jdist.modeled_cross_host_migration_bytes(
            j.remote_faces, bpc, hosts, FCOLS, ICOLS)
        out.append(got)
    assert 0 < out[1] < out[0], out
    p = build_partition(mesh, 8)
    assert modeled_cross_host_migration_bytes(
        p.remote_faces, 1, (8,), FCOLS, ICOLS) == 0


def test_derive_host_counts():
    assert derive_host_counts(make_device_mesh(8, devices=[CPU] * 8)) == (8,)
    five = DeviceMesh((CPU,) * 5, ranks=(0, 0, 0, 1, 1))
    assert derive_host_counts(five) == (3, 2)
    with pytest.raises(ValueError, match="interleaves"):
        derive_host_counts(DeviceMesh((CPU,) * 4, ranks=(0, 1, 0, 1)))


def test_config_and_engine_validate_placement_like_jax():
    assert TallyConfig().placement == "linear"
    assert TallyConfig().placement_hosts is None
    for kw in (dict(placement="hilbert"), dict(placement_hosts=(3, 0)),
               dict(placement_hosts=())):
        msgs = []
        for cls in (JaxTallyConfig, TallyConfig):
            with pytest.raises(ValueError) as e:
                cls(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], kw
    _, mesh = _pmesh(1, 1, 1, 3, 3, 3)
    with pytest.raises(ValueError, match="placement_hosts"):
        PartitionedPumiTally(mesh, 64, TallyConfig(
            device_mesh=make_device_mesh(8, devices=[CPU] * 8),
            placement="pod_rcb", placement_hosts=(3, 4)), device="cpu")


def _campaign(n=1500, seed=3):
    rng = np.random.default_rng(seed)
    dims = np.array([2.0, 1.0, 1.0])
    src = rng.uniform(0.05, 0.95, (n, 3)) * dims
    d1 = np.clip(src + rng.normal(scale=0.3, size=(n, 3)) * dims,
                 0.01 * dims, 0.99 * dims)
    d2 = np.clip(d1 + rng.normal(scale=0.3, size=(n, 3)) * dims,
                 0.01 * dims, 0.99 * dims)
    fly = (rng.uniform(size=n) > 0.1).astype(np.int8)
    w = rng.uniform(0.5, 2.0, n)
    return src, d1, d2, fly, w


def _run(t, src, d1, d2, fly, w):
    n = len(w)
    t.CopyInitialPosition(src.reshape(-1).copy())
    t.MoveToNextLocation(None, d1.reshape(-1).copy(), fly.copy(), w)
    t.MoveToNextLocation(None, d2.reshape(-1).copy(), np.ones(n, np.int8), w)
    return t


def test_engine_pod_rcb_parity_class_and_byte_drop():
    jm, mesh = _pmesh(2, 1, 1, 8, 4, 4)
    n = 1500
    arrays = _campaign(n)
    dm = make_device_mesh(8, devices=[CPU] * 8)
    lin = _run(PartitionedPumiTally(mesh, n, TallyConfig(
        device_mesh=dm, placement_hosts=(3, 5)), device="cpu"), *arrays)
    pod = _run(PartitionedPumiTally(mesh, n, TallyConfig(
        device_mesh=dm, placement="pod_rcb", placement_hosts=(3, 5)),
        device="cpu"), *arrays)
    b_lin = lin.engine.modeled_cross_host_bytes()
    b_pod = pod.engine.modeled_cross_host_bytes()
    assert 0 < b_pod < b_lin, (b_lin, b_pod)
    np.testing.assert_array_equal(lin.positions, pod.positions)
    el, ep = lin.elem_ids, pod.elem_ids
    adj = mesh.face_adj.numpy()
    for i in np.nonzero(el != ep)[0]:
        assert el[i] in adj[ep[i]] or ep[i] in adj[el[i]], i
    np.testing.assert_allclose(float(lin.flux.sum()), float(pod.flux.sum()),
                               rtol=1e-12)
    # The JAX engine on the same layout: its owner and its modeled bytes.
    ref = JaxPartitioned(jm, n, JaxTallyConfig(
        device_mesh=jax_device_mesh(8), placement="pod_rcb",
        placement_hosts=(3, 5)))
    np.testing.assert_array_equal(pod.engine.part.owner,
                                  ref.engine.part.owner)
    assert b_pod == ref.engine.modeled_cross_host_bytes()


def test_engine_default_knobs_single_host():
    _, mesh = _pmesh(1, 1, 1, 4, 4, 4)
    t = PartitionedPumiTally(mesh, 500, TallyConfig(
        device_mesh=make_device_mesh(8, devices=[CPU] * 8)), device="cpu")
    assert t.engine.placement == "linear"
    assert tuple(t.engine.host_chips) == (8,)
    assert t.engine.modeled_cross_host_bytes() == 0
    np.testing.assert_array_equal(t.engine.part.owner,
                                  build_partition(mesh, 8).owner)
