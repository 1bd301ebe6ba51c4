"""PyTorch port, the service's NDJSON socket front end and the load
generator (tools/loadgen.py) against it, on the CPU (float64, the
kernels' plain versions).

- One request script sent line by line to the JAX package's
  ``SocketFrontend`` and to the port's: the replies are equal apart from
  the timing fields (``stats``' latency quantiles and the telemetry
  counters, which the worker updates just after an op resolves) and the
  flux payloads,
  which are held at rtol 1e-10 (a 1e-13 floor) after decoding; error
  replies carry the same class names and messages.
- ``tools/loadgen.py`` ``run_load(collect_flux=2)`` against the port's
  front end: every client served, no errors, and the collected fluxes
  bitwise the solo replay of those clients' campaigns.

Sockets carry timeouts, and every wait is bounded; no sleeps in the
test itself."""

import base64
import json
import os
import socket
import sys

import numpy as np
import torch

import pumiumtally_tpu as jx
from pumiumtally_tpu.service import SocketFrontend as JaxFrontend
from pumiumtally_tpu_torch import PumiTally, TallyConfig, build_box
from pumiumtally_tpu_torch.service import SocketFrontend, TallyService

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import loadgen  # noqa: E402

F64 = torch.float64
N = 48
BOX = [1.0, 1.0, 1.0, 3, 3, 3]
TIMEOUT = 120


def _b64(a, dtype="<f8"):
    return base64.b64encode(np.ascontiguousarray(a, dtype=dtype)
                            .tobytes()).decode("ascii")


def _script():
    rng = np.random.default_rng(17)
    pos = [rng.uniform(0.1, 0.9, 3 * N) for _ in range(5)]
    fly = np.ones(N, np.int8)
    fly[::7] = 0
    open_mono = {"op": "open", "facade": "mono", "num_particles": N,
                 "mesh": {"box": BOX}, "max_queue": 4}
    return [
        {"op": "ping"},
        open_mono,
        dict(open_mono, facade="stream", chunk_size=20, batch_stats=True,
             priority="high"),
        dict(open_mono, priority="bogus"),
        {"op": "source", "session": "s1", "positions": _b64(pos[0])},
        {"op": "move", "session": "s1", "dests": _b64(pos[1])},
        {"op": "move", "session": "s1", "dests": _b64(pos[2]),
         "flying": _b64(fly, "<i1"), "weights": _b64(np.full(N, 0.5)),
         "wait": False},
        {"op": "sync", "session": "s1"},
        {"op": "flux", "session": "s1"},
        {"op": "normalized_flux", "session": "s1"},
        {"op": "lost", "session": "s1"},
        {"op": "close_batch", "session": "s1"},
        {"op": "source", "session": "s2", "positions": _b64(pos[3])},
        {"op": "move", "session": "s2", "origins": _b64(pos[3]),
         "dests": _b64(pos[4])},
        {"op": "close_batch", "session": "s2"},
        {"op": "flux", "session": "s2"},
        {"op": "move", "session": "s2", "dests": _b64(pos[4][:-3])},
        {"op": "write", "session": "s2"},
        {"op": "health", "session": "s2"},
        {"op": "frobnicate", "session": "s2"},
        {"op": "flux", "session": "nope"},
        {"op": "stats"},
        {"op": "ping"},
        {"op": "close", "session": "s2"},
        {"op": "close", "session": "s1"},
        {"op": "ping"},
    ]


def _converse(frontend, script):
    frontend.start()
    try:
        with socket.create_connection((frontend.host, frontend.port),
                                      timeout=TIMEOUT) as conn:
            f = conn.makefile("rwb")
            replies = []
            for req in script:
                f.write(json.dumps(req).encode("utf-8") + b"\n")
                f.flush()
                replies.append(json.loads(f.readline().decode("utf-8")))
        return replies
    finally:
        frontend.stop()
        frontend.service.shutdown(drain=False, timeout=TIMEOUT)


def _strip_timing(reply):
    """Drop what depends on timing: ``stats``' latency quantiles, and the
    telemetry counters the worker updates just AFTER it resolves an op's
    future (a read that follows a reply may see them before or after);
    their keys stay compared."""
    st = reply.get("stats")
    if st is not None:
        for s in st["sessions"].values():
            for k in ("latency_p50_ms", "latency_p99_ms", "ops_completed",
                      "moves_completed"):
                s.pop(k)
        for k in ("admitted_cost", "queued_cost", "inflight_cost"):
            st["admission"].pop(k)
        st["fusion"] = sorted(st["fusion"])
    if "load" in reply:
        for k in ("queued_cost", "inflight_cost", "admitted_cost"):
            reply["load"].pop(k)
        reply["fusion"] = sorted(reply["fusion"])
    return reply


def _assert_same(port, ref, where):
    if isinstance(ref, dict):
        assert isinstance(port, dict) and port.keys() == ref.keys(), where
        for k in ref:
            if k == "flux":
                a = np.frombuffer(base64.b64decode(port[k]), "<f8")
                b = np.frombuffer(base64.b64decode(ref[k]), "<f8")
                np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-13,
                                           err_msg=where)
                assert np.abs(b).sum() > 0
            else:
                _assert_same(port[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, list):
        assert isinstance(port, list) and len(port) == len(ref), where
        for i, (a, b) in enumerate(zip(port, ref)):
            _assert_same(a, b, f"{where}[{i}]")
    elif isinstance(ref, float):
        np.testing.assert_allclose(port, ref, rtol=1e-9, atol=1e-12,
                                   err_msg=where)
    else:
        assert port == ref, where


def test_socket_replies_equal_the_jax_frontend():
    script = _script()
    ref = _converse(JaxFrontend(jx.TallyService()), script)
    port = _converse(SocketFrontend(TallyService(), device="cpu",
                                    dtype=F64), script)
    for i, (p, r) in enumerate(zip(port, ref)):
        _assert_same(_strip_timing(p), _strip_timing(r),
                     f"reply {i} to {script[i]['op']}")
    # The script exercised the error replies, not only the happy path.
    errors = [r.get("error") for r in port if not r.get("ok")]
    assert {"KeyError", "ValueError", "RuntimeError"} <= set(errors)


def test_loadgen_against_the_port_frontend_is_bitwise_vs_solo():
    svc = TallyService()
    front = SocketFrontend(svc, device="cpu", dtype=F64)
    front.start()
    try:
        report = loadgen.run_load(
            front.host, front.port, clients=6, rate=1e6, particles=N,
            batches=2, moves=2, seed=3, collect_flux=2, timeout=TIMEOUT)
    finally:
        front.stop()
        svc.shutdown(drain=False, timeout=TIMEOUT)
    assert report["clients_failed"] == 0 and report["errors"] == []
    assert report["clients_timed_out"] == 0
    assert report["served_moves"] == 6 * 2 * 2
    mesh = build_box(*BOX, dtype=F64)
    for row in report["parity"]:
        solo = PumiTally(mesh, N, TallyConfig(check_found_all=False),
                         device="cpu")
        solo._arm_deterministic()  # as the service arms its sessions
        for src, dests in loadgen.client_campaign(3, row["client"], N, 2,
                                                  2):
            solo.CopyInitialPosition(src)
            for d in dests:
                solo.MoveToNextLocation(None, d, np.ones(N, np.int8))
        np.testing.assert_array_equal(row["flux"], solo.flux.numpy())
