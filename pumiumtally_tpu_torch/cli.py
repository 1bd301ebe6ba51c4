"""Mesh tool CLI — the framework's ``msh2osh`` / ``describe`` / ``scale``.

The reference's mesh pipeline uses Omega_h's command-line tools
(reference README.md:115-125):

    msh2osh input.msh output.osh      # convert Gmsh -> .osh
    describe output.osh               # print coordinate min/max
    scale output.osh scaled.osh 10    # scale coordinates

Here the same three verbs live behind
``python -m pumiumtally_tpu_torch.cli``
(or the ``pumiumtally`` console script), operating on Gmsh ``.msh`` and
this package's ``.osh`` directories (io/osh.py).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _load(path: str):
    p = path.rstrip("/")
    if p.endswith(".msh"):
        from pumiumtally_tpu_torch.io.gmsh import read_gmsh

        return read_gmsh(p)
    if p.endswith(".osh"):
        from pumiumtally_tpu_torch.io.osh import read_osh

        return read_osh(p)
    raise SystemExit(f"unsupported mesh format: {path!r} (.msh or .osh)")


def _save(path: str, coords, tets, elem_tags=None) -> None:
    """Write by output extension: ``.msh`` → Gmsh 2.2 ASCII, anything
    else → ``.osh`` directory. (Generators previously always wrote
    ``.osh``, silently producing an .osh DIRECTORY at a ``.msh`` path.)"""
    p = path.rstrip("/")
    if p.endswith(".msh"):
        from pumiumtally_tpu_torch.io.gmsh import write_gmsh

        elem_tags = elem_tags or {}
        write_gmsh(p, coords, tets, physical=elem_tags.get("class_id"))
        dropped = sorted(set(elem_tags) - {"class_id"})
        if dropped:
            print(f"note: tags {dropped} not representable in MSH 2.2; "
                  "use an .osh output to keep them")
        return
    from pumiumtally_tpu_torch.io.osh import write_osh

    write_osh(path, coords, tets, elem_tags=elem_tags)


def cmd_msh2osh(args) -> None:
    from pumiumtally_tpu_torch.io.osh import write_osh

    coords, tets = _load(args.input)
    write_osh(args.output, coords, tets)
    print(f"wrote {args.output}: {coords.shape[0]} vertices, "
          f"{tets.shape[0]} tets")


def cmd_describe(args) -> None:
    mesh_path = args.mesh.rstrip("/")
    tags = {}
    if mesh_path.endswith(".osh"):
        from pumiumtally_tpu_torch.io.osh import read_osh

        # One parse serves both the geometry lines and the tag listing
        # (legacy directories return an empty tag dict, no error).
        coords, tets, tags = read_osh(mesh_path, with_tags=True)
    else:
        coords, tets = _load(mesh_path)
    lo, hi = coords.min(axis=0), coords.max(axis=0)
    print(f"vertices : {coords.shape[0]}")
    print(f"tets     : {tets.shape[0]}")
    print(f"x range  : [{lo[0]:.6g}, {hi[0]:.6g}]")
    print(f"y range  : [{lo[1]:.6g}, {hi[1]:.6g}]")
    print(f"z range  : [{lo[2]:.6g}, {hi[2]:.6g}]")
    for name, v in tags.items():
        v = np.asarray(v)
        kinds = np.unique(v).size if v.dtype.kind in "iu" else None
        extra = f", {kinds} distinct" if kinds is not None else ""
        print(f"tag      : {name} [{v.dtype}{extra}]")


def cmd_scale(args) -> None:
    coords, tets = _load(args.input)
    _save(args.output, coords * args.factor, tets)
    print(f"wrote {args.output}: scaled by {args.factor}")


def cmd_box(args) -> None:
    from pumiumtally_tpu_torch.mesh.box import box_arrays

    coords, tets = box_arrays(args.lx, args.ly, args.lz,
                              args.nx, args.ny, args.nz)
    _save(args.output, coords, tets)
    print(f"wrote {args.output}: {coords.shape[0]} vertices, "
          f"{len(tets)} tets")


def cmd_pincell(args) -> None:
    """Generate the pincell benchmark geometry (BASELINE configs[0-1])
    as an .osh directory — the reference obtains this via Gmsh +
    msh2osh (reference README.md:115-125)."""
    from pumiumtally_tpu_torch.mesh.pincell import pincell_arrays

    coords, tets, region = pincell_arrays(
        pitch=args.pitch, fuel_radius=args.fuel_radius, height=args.height,
        n_theta=args.n_theta, n_rings_fuel=args.rings_fuel,
        n_rings_pad=args.rings_pad, nz=args.nz,
    )
    # Material classification rides along as the class_id element tag
    # (the tag name Omega_h meshes carry for geometric classification).
    _save(args.output, coords, tets,
          elem_tags={"class_id": region.astype(np.int32)})
    nf = int((region == 0).sum())
    print(f"wrote {args.output}: {coords.shape[0]} vertices, "
          f"{len(tets)} tets ({nf} fuel / {len(tets) - nf} moderator)")


def cmd_lattice(args) -> None:
    """Generate an nx×ny pincell assembly (BASELINE configs[1-2] scale
    class) as an .osh directory with class_id (material) and cell_id
    element tags."""
    from pumiumtally_tpu_torch.mesh.pincell import lattice_arrays

    coords, tets, region, cell_id = lattice_arrays(
        args.nx, args.ny,
        pitch=args.pitch, fuel_radius=args.fuel_radius, height=args.height,
        n_theta=args.n_theta, n_rings_fuel=args.rings_fuel,
        n_rings_pad=args.rings_pad, nz=args.nz,
    )
    _save(args.output, coords, tets,
          elem_tags={"class_id": region.astype(np.int32),
                     "cell_id": cell_id.astype(np.int32)})
    print(f"wrote {args.output}: {coords.shape[0]} vertices, "
          f"{len(tets)} tets, {args.nx}x{args.ny} cells")


def _dtype(name: str):
    import torch

    return {"float32": torch.float32, "float64": torch.float64}[name]


def cmd_autotune(args) -> None:
    """Measure the walk's tuning knob (the table tier) on the given
    device for the given mesh and print the winning TallyConfig settings
    (see utils/autotune.py — the deployment-measures-instead-of-guesses
    counterpart of the reference's hard-coded Kokkos launch params)."""
    from pumiumtally_tpu_torch.mesh.tetmesh import TetMesh
    from pumiumtally_tpu_torch.utils.autotune import autotune_walk, walk_kwargs

    coords, tets = _load(args.mesh)
    mesh = TetMesh.from_arrays(coords, tets, dtype=_dtype(args.dtype))
    cfg, report = autotune_walk(
        mesh, n_particles=args.particles, moves=args.moves, verbose=True,
        device=args.device,
    )
    kw = walk_kwargs(cfg)  # normalized: () when the winner == defaults
    settings = (
        ", ".join(f"walk_{k}={v!r}" for k, v in kw)
        if kw else "<defaults — no knob beats them on this device>"
    )
    # The adopted entry, not report[0]: an approximate-tier candidate
    # (never adopted by default) may top the raw sweep — and an
    # all-approximate sweep adopts nothing, so no rate is paired with
    # the kept defaults.
    adopted = next((r for r in report if r.get("adopted")), None)
    if adopted is None:
        print(f"\nbest: no adoptable candidate (approximate tiers are "
              f"measured but not adopted); keeping TallyConfig({settings})")
    else:
        print(f"\nbest: {adopted['moves_per_sec'] / 1e6:.3f}M moves/s with "
              f"TallyConfig({settings})")


def cmd_serve(args) -> None:
    """Run the multi-session campaign service with the NDJSON socket
    front end (service/server.py): external host codes attach as
    independent sessions over TCP, each with its own facade, flux,
    and checkpoint stream. SIGTERM drains: intake stops, in-flight
    moves finish, every autosave-armed session writes one generation,
    and the process exits 0 (preemption-safe serving). The sessions'
    facades run on ``--device`` (cuda unless "cpu" is asked for); with
    no CUDA device the verb refuses before it binds, rather than serve
    from the CPU."""
    import json as _json
    import time as _time

    from pumiumtally_tpu_torch.api.tally import resolve_device
    from pumiumtally_tpu_torch.mesh.tetmesh import TetMesh
    from pumiumtally_tpu_torch.service import SocketFrontend, TallyService

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"serve: {e} (--device cpu)") from None
    dtype = _dtype(args.dtype)
    default_mesh = None
    if args.mesh is not None:
        coords, tets = _load(args.mesh)
        default_mesh = TetMesh.from_arrays(coords, tets, dtype=dtype)
    service = TallyService(handle_signals=True,
                           fuse_sessions=not args.no_fuse,
                           admission_budget=args.admission_budget)
    frontend = SocketFrontend(
        service, host=args.host, port=args.port,
        default_mesh=default_mesh, default_particles=args.particles,
        allow_mesh_paths=args.allow_mesh_paths,
        allow_write=args.allow_write, device=device, dtype=dtype,
    )
    frontend.start()
    # One parseable line so clients and tests can discover the bound port
    # (--port 0 binds an ephemeral one).
    print(_json.dumps({"serving": {"host": frontend.host,
                                   "port": frontend.port}}), flush=True)
    try:
        while not service.drain_requested:
            _time.sleep(0.1)
        print("serve: drain requested; checkpointing open sessions",
              flush=True)
    finally:
        frontend.stop()
        service.shutdown(drain=True)
    raise SystemExit(0)


def cmd_route(args) -> None:
    """Run the session router over per-host service workers
    (service/server.py SessionRouter, round 13): each worker is a
    ``pumiumtally serve`` process on its own host/devices; the router
    pins every session to a home worker at open (least-loaded, or the
    request's "home" hint) and forwards its NDJSON ops there — the
    horizontal scaling front of the multi-session service. SIGTERM
    (or SIGINT) stops intake, closes the worker links, and exits 0 —
    same preemption-safe contract as ``serve``; the workers' own
    vanished-client handling drain-closes any sessions the router
    still had open."""
    import json as _json
    import signal as _signal
    import time as _time

    from pumiumtally_tpu_torch.service import SessionRouter

    backends = []
    for spec in args.backend:
        host, sep, port = spec.rpartition(":")
        if not sep or not port.isdigit():
            raise SystemExit(
                f"--backend {spec!r} is not host:port"
            )
        backends.append((host, int(port)))
    router = SessionRouter(backends, host=args.host, port=args.port)
    router.start()
    # Same one-parseable-line discovery contract as `serve`.
    print(_json.dumps({"routing": {"host": router.host,
                                   "port": router.port,
                                   "backends": len(backends)}}),
          flush=True)
    stop = {"requested": False}
    prev = _signal.signal(_signal.SIGTERM,
                          lambda _sig, _frm: stop.update(requested=True))
    try:
        while not stop["requested"]:
            _time.sleep(0.1)
        print("route: drain requested; closing worker links", flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        _signal.signal(_signal.SIGTERM, prev)
        router.stop()
    raise SystemExit(0)


def cmd_loadgen(args) -> None:
    """Drive scripted OpenMC-style clients at a running ``serve``
    worker or ``route`` router and print the heavy-traffic report
    (tools/loadgen.py, round 20): served moves/s, p50/p99
    submit→resolve latency, per-lane Jain fairness, refusal counts.
    Pure client side — needs only the repository's tools/ directory
    and numpy, no jax, no device."""
    import importlib.util as _ilu
    import json as _json

    tools = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools")
    lg_path = os.path.join(tools, "loadgen.py")
    if not os.path.isfile(lg_path):
        raise SystemExit(
            "loadgen needs the repository's tools/ directory "
            f"(expected {lg_path}); run from a source checkout"
        )
    spec = _ilu.spec_from_file_location("pumiumtally_loadgen", lg_path)
    loadgen = _ilu.module_from_spec(spec)
    spec.loader.exec_module(loadgen)

    host, sep, port = args.connect.rpartition(":")
    if not sep or not port.isdigit():
        raise SystemExit(f"--connect {args.connect!r} is not host:port")
    try:
        mix = tuple(float(x) for x in args.priority_mix.split(","))
        if len(mix) != 3:
            raise ValueError
    except ValueError:
        raise SystemExit(
            f"--priority-mix {args.priority_mix!r} is not "
            "three comma-separated weights (high,normal,low)"
        ) from None
    report = loadgen.run_load(
        host, int(port), clients=args.clients, rate=args.rate,
        particles=args.particles, batches=args.batches,
        moves=args.moves, facade=args.facade,
        chunk_size=args.chunk_size,
        mesh_box=tuple(args.mesh_box), priority_mix=mix,
        seed=args.seed, timeout=args.timeout,
    )
    if args.json:
        print(_json.dumps(report, default=float))
    else:
        print(loadgen.format_report(report))
    if report["clients_failed"] or report["clients_timed_out"]:
        raise SystemExit(1)


def _subproc_timeout() -> float:
    """Helper-subprocess timeout in seconds (default 1800). Deployments
    with slow toolchains raise it via PUMIUMTALLY_SUBPROC_TIMEOUT; the
    expiry message names the env var so the fix is discoverable from
    the failure itself."""
    raw = os.environ.get("PUMIUMTALLY_SUBPROC_TIMEOUT")
    if raw is None:
        return 1800.0
    try:
        t = float(raw)
        if t <= 0:
            raise ValueError
    except ValueError:
        raise SystemExit(
            f"PUMIUMTALLY_SUBPROC_TIMEOUT={raw!r} is not a positive "
            "number of seconds"
        ) from None
    return t


# Each aot-check job builds into a temporary directory of its own, so a
# green report means this deployment's toolchain compiled every source
# now, not that an earlier build is cached.
_AOT_KERNELS = """
import tempfile
from pathlib import Path
from pumiumtally_tpu_torch import kernels
with tempfile.TemporaryDirectory() as d:
    kernels.BUILD_DIR = Path(d)
    secs = kernels.build()
print(f"built {len(kernels.SOURCES)} libraries "
      f"({', '.join(kernels.SOURCES.values())}) for sm_90a in {secs:.1f} s")
"""
_AOT_NATIVE = """
import tempfile
from pathlib import Path
from pumiumtally_tpu_torch.native import build
with tempfile.TemporaryDirectory() as d:
    build.BUILD_DIR = Path(d)
    secs = build.build_native()
print(f"built {build.LIBRARY} and {', '.join(build.HOSTS)} in {secs:.1f} s")
"""


def cmd_aot_check(args) -> None:
    """Certify, without a device, that this deployment can build every
    kernel the package ships: the CUDA kernels of csrc/ with nvcc for
    sm_90a (``kernels.build``), and the C ABI library with its host
    programs (``native/build.py``), each in a subprocess under
    PUMIUMTALLY_SUBPROC_TIMEOUT. Useful as a cluster pre-flight: a green
    aot-check means the deployment's toolchain builds everything before
    any GPU time is booked. A missing nvcc is a failure, never a skip."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    jobs = [("CUDA kernels (nvcc, sm_90a)",
             [sys.executable, "-c", _AOT_KERNELS]),
            ("C ABI library and hosts (g++, cc)",
             [sys.executable, "-c", _AOT_NATIVE])]
    rc = 0
    tmo = _subproc_timeout()
    for label, cmd in jobs:
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=tmo, env=env)
            job_rc, text = r.returncode, (r.stdout + r.stderr)
        except subprocess.TimeoutExpired as e:
            # A hung compile is a result too — report it and move on to
            # the remaining jobs.
            job_rc = 1
            text = "".join(
                s if isinstance(s, str) else s.decode("utf-8", "replace")
                for s in (e.stdout, e.stderr) if s
            ) + (
                f"\n(compile timed out after {tmo:g}s; set "
                "PUMIUMTALLY_SUBPROC_TIMEOUT to extend)"
            )
        lines = text.strip().splitlines()
        # Success: a terse tail. Failure: the whole child output, so
        # the root cause (e.g. nvcc missing) is never truncated away.
        shown = lines[-4:] if job_rc == 0 else lines
        print(f"[{'OK' if job_rc == 0 else 'FAILED'}] {label}\n  "
              + ("\n  ".join(shown) if shown else "(no output)"))
        rc |= 1 if job_rc else 0
    if rc:
        raise SystemExit(1)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="pumiumtally-torch",
        description="mesh tools (Gmsh .msh / pumiumtally .osh)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("msh2osh", help="convert Gmsh .msh to .osh directory")
    c.add_argument("input")
    c.add_argument("output")
    c.set_defaults(fn=cmd_msh2osh)

    c = sub.add_parser("describe", help="print mesh size and coordinate range")
    c.add_argument("mesh")
    c.set_defaults(fn=cmd_describe)

    c = sub.add_parser("scale", help="scale mesh coordinates by a factor")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("factor", type=float)
    c.set_defaults(fn=cmd_scale)

    c = sub.add_parser("box", help="generate a structured box tet mesh")
    c.add_argument("output")
    c.add_argument("--lx", type=float, default=1.0)
    c.add_argument("--ly", type=float, default=1.0)
    c.add_argument("--lz", type=float, default=1.0)
    c.add_argument("--nx", type=int, default=10)
    c.add_argument("--ny", type=int, default=10)
    c.add_argument("--nz", type=int, default=10)
    c.set_defaults(fn=cmd_box)

    # Shared pin-geometry options (one definition; pincell and lattice
    # stay in lockstep).
    pin_opts = argparse.ArgumentParser(add_help=False)
    pin_opts.add_argument("--pitch", type=float, default=1.26)
    pin_opts.add_argument("--fuel-radius", type=float, default=0.4095)
    pin_opts.add_argument("--height", type=float, default=1.0)
    pin_opts.add_argument("--n-theta", type=int, default=16)
    pin_opts.add_argument("--rings-fuel", type=int, default=3)
    pin_opts.add_argument("--rings-pad", type=int, default=3)
    pin_opts.add_argument("--nz", type=int, default=4)

    c = sub.add_parser(
        "pincell", help="generate the pincell benchmark mesh (O-grid)",
        parents=[pin_opts],
    )
    c.add_argument("output")
    c.set_defaults(fn=cmd_pincell)

    c = sub.add_parser(
        "lattice", help="generate an nx×ny pincell assembly mesh",
        parents=[pin_opts],
    )
    c.add_argument("output")
    c.add_argument("--nx", type=int, default=17)
    c.add_argument("--ny", type=int, default=17)
    c.set_defaults(fn=cmd_lattice)

    c = sub.add_parser(
        "autotune",
        help="measure walk-kernel knobs on a device, print the best",
    )
    c.add_argument("mesh")
    c.add_argument("--particles", type=int, default=200_000)
    c.add_argument("--moves", type=int, default=3)
    c.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    c.add_argument("--dtype", choices=("float32", "float64"),
                   default="float32")
    c.set_defaults(fn=cmd_autotune)

    c = sub.add_parser(
        "serve",
        help="run the multi-session campaign service (NDJSON over TCP)",
    )
    c.add_argument("--mesh", default=None,
                   help="default mesh (.msh/.osh) for open requests "
                        "that pass none")
    c.add_argument("--particles", type=int, default=100_000,
                   help="default num_particles for open requests")
    c.add_argument("--host", default="127.0.0.1")
    c.add_argument("--port", type=int, default=0,
                   help="0 = ephemeral (the bound port is printed as "
                        "one JSON line)")
    c.add_argument("--allow-mesh-paths", action="store_true",
                   help="let open requests load meshes by filesystem "
                        "path")
    c.add_argument("--allow-write", action="store_true",
                   help="let sessions write VTK output files")
    c.add_argument("--no-fuse", action="store_true",
                   help="disable cross-session batch fusion (serve "
                        "every session's ops one launch at a time — "
                        "the pre-round-12 dispatch path)")
    c.add_argument("--admission-budget", type=int, default=None,
                   metavar="COST",
                   help="global cap on queued + in-flight transport "
                        "cost units (particles); beyond it, opens and "
                        "submits refuse with a structured overloaded "
                        "error instead of growing the staging heap "
                        "(default: unbounded)")
    c.add_argument("--device", default="cuda",
                   help="where the sessions' facades run: cuda "
                        "(default; refused without a GPU) or cpu")
    c.add_argument("--dtype", choices=("float32", "float64"),
                   default="float32",
                   help="working dtype of the meshes the server builds")
    c.set_defaults(fn=cmd_serve)

    c = sub.add_parser(
        "route",
        help="route NDJSON sessions over per-host service workers",
    )
    c.add_argument("--backend", action="append", required=True,
                   metavar="HOST:PORT",
                   help="a worker's serve address (repeat per host)")
    c.add_argument("--host", default="127.0.0.1")
    c.add_argument("--port", type=int, default=0,
                   help="0 = ephemeral (the bound port is printed as "
                        "one JSON line)")
    c.set_defaults(fn=cmd_route)

    c = sub.add_parser(
        "loadgen",
        help="drive scripted clients at a serve/route address and "
             "report served throughput, latency, fairness, refusals",
    )
    c.add_argument("--connect", required=True, metavar="HOST:PORT",
                   help="a running serve worker or route router")
    c.add_argument("--clients", type=int, default=100)
    c.add_argument("--rate", type=float, default=200.0,
                   help="Poisson arrival rate, clients/second")
    c.add_argument("--particles", type=int, default=64)
    c.add_argument("--batches", type=int, default=1)
    c.add_argument("--moves", type=int, default=2,
                   help="moves per batch")
    c.add_argument("--facade", choices=("mono", "stream"),
                   default="mono")
    c.add_argument("--chunk-size", type=int, default=None,
                   help="streaming chunk size (facade=stream)")
    c.add_argument("--mesh-box", type=float, nargs=6,
                   default=(1.0, 1.0, 1.0, 3.0, 3.0, 3.0),
                   metavar=("LX", "LY", "LZ", "NX", "NY", "NZ"),
                   help="box mesh every client opens against")
    c.add_argument("--priority-mix", default="0.2,0.6,0.2",
                   metavar="H,N,L",
                   help="lane probabilities high,normal,low")
    c.add_argument("--seed", type=int, default=0,
                   help="schedule seed (arrivals, priorities, "
                        "positions — the work is deterministic)")
    c.add_argument("--timeout", type=float, default=600.0,
                   help="per-client join bound, seconds")
    c.add_argument("--json", action="store_true",
                   help="print the full report as one JSON line")
    c.set_defaults(fn=cmd_loadgen)

    c = sub.add_parser(
        "aot-check",
        help="build the CUDA kernels and the C ABI, no device needed",
    )
    c.set_defaults(fn=cmd_aot_check)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
