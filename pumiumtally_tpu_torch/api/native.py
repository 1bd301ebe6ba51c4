"""Engine factory for the port's C ABI (``pumiumtally_tpu_torch/native/``).

The C boundary (native/pumiumtally_c.h) keeps the reference's
builtin-typed constructor signature, ``(mesh_filename, num_particles)``
(reference PumiTally.h:50), so a physics host selects the engine, the
device and the precision through the environment:

    PUMIUMTALLY_ENGINE            mono (default) | streaming |
                                  partitioned | streaming_partitioned
    PUMIUMTALLY_DEVICE            cuda (default) | cpu: where the tally
                                  runs (a bare "cuda" is the current
                                  CUDA device, "cuda:N" names one)
    PUMIUMTALLY_DTYPE             float32 (default) | float64: the
                                  working dtype the mesh file is built
                                  in (TallyConfig.dtype)
    PUMIUMTALLY_ALLOW_CPU_FALLBACK  1 to ACCEPT running on the CPU when
                                  the GPU was asked for and no CUDA
                                  device is available; default: refuse
                                  with an error
    PUMIUMTALLY_DEVICES           N: a device mesh of N shards (the
                                  first N CUDA devices; with
                                  PUMIUMTALLY_DEVICE=cpu, N CPU shards);
                                  the partitioned engines take every
                                  CUDA device when it is unset
    PUMIUMTALLY_CHUNK_SIZE        streaming chunk size (default 1e6)
    PUMIUMTALLY_CAPACITY_FACTOR   partitioned slot over-provisioning
    PUMIUMTALLY_VMEM_MAX_ELEMS    partitioned engines: the block length
                                  bound of the block walks
                                  (TallyConfig.walk_vmem_max_elems)
    PUMIUMTALLY_BLOCK_KERNEL      partitioned engines: vmem (default) |
                                  gather, the kernel of the sub-split's
                                  block walk (TallyConfig.walk_block_kernel)
    PUMIUMTALLY_TOLERANCE         walk tolerance override
    PUMIUMTALLY_OUTPUT            default VTK output path
    PUMIUMTALLY_LOCALIZATION      walk (default) | locate, see
                                  TallyConfig.localization
    PUMIUMTALLY_AUTO_CONTINUE     1 (default) | 0: host staging dedup
    PUMIUMTALLY_FENCED_TIMING     1 (default) | 0: 0 lets calls return
                                  after dispatch and implies
                                  CHECK_FOUND_ALL=0 unless that is set
                                  explicitly (the convergence read-back
                                  is itself a per-move sync)
    PUMIUMTALLY_CHECK_FOUND_ALL   1 (default) | 0: per-move "Not all
                                  particles are found" check
    PUMIUMTALLY_DEVICE_GROUPS     streaming_partitioned only: disjoint
                                  device groups of the mesh

The switches, their checks and their messages are the JAX package's
(pumiumtally_tpu/api/native.py); ``PUMIUMTALLY_DEVICE`` and
``PUMIUMTALLY_DTYPE`` take the place of ``JAX_PLATFORMS`` and
``JAX_ENABLE_X64`` for an embedding host.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pumiumtally_tpu_torch.utils.logging import get_logger

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def native_device() -> torch.device:
    """The device ``PUMIUMTALLY_DEVICE`` asks for, or a refusal.

    The GPU is the default. Without a CUDA device the tally does not
    run silently on the CPU: a physics host would get CPU numbers
    believing the GPU ran. ``PUMIUMTALLY_DEVICE=cpu`` asks for the CPU;
    ``PUMIUMTALLY_ALLOW_CPU_FALLBACK=1`` accepts it in place of a
    missing GPU, with a loud warning."""
    raw = os.environ.get("PUMIUMTALLY_DEVICE", "").strip().lower() or "cuda"
    try:
        device = torch.device(raw)
    except RuntimeError:
        device = None
    if device is None or device.type not in ("cuda", "cpu"):
        raise ValueError(
            f"PUMIUMTALLY_DEVICE={raw!r}: expected cuda, cuda:N or cpu"
        )
    if device.type == "cpu" or torch.cuda.is_available():
        return device
    if os.environ.get("PUMIUMTALLY_ALLOW_CPU_FALLBACK") != "1":
        raise RuntimeError(
            f"PUMIUMTALLY_DEVICE={raw!r} requested the GPU but no CUDA "
            "device is available in this (embedded) interpreter. "
            "Refusing to run the tally silently on CPU — fix the host's "
            "CUDA setup, set PUMIUMTALLY_DEVICE=cpu to ask for the CPU, "
            "or set PUMIUMTALLY_ALLOW_CPU_FALLBACK=1 to accept CPU "
            "execution."
        )
    get_logger().warning(
        "ACCELERATOR FALLBACK: PUMIUMTALLY_DEVICE=%r requested the GPU "
        "but the tally is running on CPU "
        "(PUMIUMTALLY_ALLOW_CPU_FALLBACK=1). Performance numbers from "
        "this run are CPU numbers.", raw
    )
    return torch.device("cpu")


def native_dtype() -> torch.dtype:
    """The working dtype ``PUMIUMTALLY_DTYPE`` asks for (float32 by
    default, as the facades build a mesh file)."""
    raw = os.environ.get("PUMIUMTALLY_DTYPE", "").strip().lower() or "float32"
    if raw not in _DTYPES:
        raise ValueError(
            f"PUMIUMTALLY_DTYPE={raw!r}: expected float32 or float64"
        )
    return _DTYPES[raw]


def host_array(tally, attr: str, dtype: str) -> np.ndarray:
    """A C-contiguous 1-D numpy copy of ``tally.<attr>`` in ``dtype``,
    for the C accessors: a tensor (on any device) goes through
    ``.detach().cpu()`` first, an ndarray is taken as it is."""
    val = getattr(tally, attr)
    if isinstance(val, torch.Tensor):
        val = val.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(val).reshape(-1), np.dtype(dtype))


def native_create(mesh_filename: str, num_particles: int):
    """Build the engine the environment asks for (see module doc)."""
    from pumiumtally_tpu_torch import (
        PartitionedPumiTally,
        PumiTally,
        StreamingPartitionedTally,
        StreamingTally,
        TallyConfig,
    )

    device = native_device()
    engine = os.environ.get("PUMIUMTALLY_ENGINE", "mono").lower()
    kwargs = {"dtype": native_dtype()}
    tol = os.environ.get("PUMIUMTALLY_TOLERANCE")
    if tol:
        kwargs["tolerance"] = float(tol)
    capf = os.environ.get("PUMIUMTALLY_CAPACITY_FACTOR")
    if capf:
        kwargs["capacity_factor"] = float(capf)
    out = os.environ.get("PUMIUMTALLY_OUTPUT")
    if out:
        kwargs["output_filename"] = out

    def env_flag(name: str):
        v = os.environ.get(name, "").strip().lower()
        return None if not v else v not in ("0", "false", "off", "no")

    loc = os.environ.get("PUMIUMTALLY_LOCALIZATION")
    if loc:
        kwargs["localization"] = loc.strip().lower()
    auto = env_flag("PUMIUMTALLY_AUTO_CONTINUE")
    if auto is not None:
        kwargs["auto_continue"] = auto
    vmem = os.environ.get("PUMIUMTALLY_VMEM_MAX_ELEMS")
    if vmem:
        if engine not in ("partitioned", "streaming_partitioned"):
            raise ValueError(
                "PUMIUMTALLY_VMEM_MAX_ELEMS applies only to the "
                f"partitioned engines, not PUMIUMTALLY_ENGINE={engine!r}"
            )
        kwargs["walk_vmem_max_elems"] = int(vmem)
    bk = os.environ.get("PUMIUMTALLY_BLOCK_KERNEL")
    if bk:
        if engine not in ("partitioned", "streaming_partitioned"):
            raise ValueError(
                "PUMIUMTALLY_BLOCK_KERNEL applies only to the "
                f"partitioned engines, not PUMIUMTALLY_ENGINE={engine!r}"
            )
        kwargs["walk_block_kernel"] = bk.strip().lower()
    fenced = env_flag("PUMIUMTALLY_FENCED_TIMING")
    check = env_flag("PUMIUMTALLY_CHECK_FOUND_ALL")
    if fenced is not None:
        kwargs["fenced_timing"] = fenced
        if not fenced and check is None:
            # Unfenced dispatch only pipelines without the per-move
            # convergence read-back; imply it off unless asked for.
            check = False
    if check is not None:
        kwargs["check_found_all"] = check
    groups = os.environ.get("PUMIUMTALLY_DEVICE_GROUPS")
    if groups:
        if engine != "streaming_partitioned":
            raise ValueError(
                "PUMIUMTALLY_DEVICE_GROUPS applies only to "
                f"PUMIUMTALLY_ENGINE=streaming_partitioned, not {engine!r}"
            )
        kwargs["device_groups"] = int(groups)
    ndev = os.environ.get("PUMIUMTALLY_DEVICES", "").strip()
    partitioned = engine in ("partitioned", "streaming_partitioned")
    if ndev or (partitioned and device.type == "cuda"):
        # The JAX package's rule (api/native.py:248-256): a mesh when
        # asked for, and over every device for the partitioned engines.
        # CPU shards only where the CPU was asked for.
        from pumiumtally_tpu_torch.parallel.device import make_device_mesh

        asked_cpu = os.environ.get("PUMIUMTALLY_DEVICE", "").strip() \
            .lower() == "cpu"
        kwargs["device_mesh"] = make_device_mesh(
            int(ndev) if ndev else None,
            devices=[device] * int(ndev) if asked_cpu else None)
    cfg = TallyConfig(**kwargs)
    chunk = int(os.environ.get("PUMIUMTALLY_CHUNK_SIZE", "1000000"))
    if engine == "mono":
        t = PumiTally(mesh_filename, num_particles, cfg, device=device)
    elif engine == "streaming":
        t = StreamingTally(mesh_filename, num_particles, chunk, cfg,
                           device=device)
    elif engine == "partitioned":
        t = PartitionedPumiTally(mesh_filename, num_particles, cfg,
                                 device=device)
    elif engine == "streaming_partitioned":
        t = StreamingPartitionedTally(
            mesh_filename, num_particles, chunk, cfg, device=device
        )
    else:
        raise ValueError(
            f"PUMIUMTALLY_ENGINE={engine!r}: expected mono, streaming, "
            "partitioned, or streaming_partitioned"
        )
    get_logger().info("native_create: %s on %s (%s, %d tets)",
                      type(t).__name__, t.device, t.dtype, t.mesh.nelems)
    return t
