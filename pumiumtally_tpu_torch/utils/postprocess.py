"""Label-wise tally reductions (per-cell / per-material summaries).

The reference emits only the per-element flux field (VTK cell data,
reference PumiTallyImpl.cpp:411-416); physics users then want it
reduced over labels — per-pincell powers across an assembly, fuel vs
moderator averages. These helpers do that reduction against any
integer element labeling (the ``region`` / ``cell_id`` arrays the mesh
generators return, or a ``class_id`` tag read from an ``.osh`` file),
as deterministic ``segment_sum``-style bincounts. The inputs may be
numpy arrays or torch tensors on any device (a facade's ``flux``,
``normalized_flux()`` or ``mesh.volumes``); the reductions run on the
host in float64, as the JAX package's do.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _host(a) -> np.ndarray:
    """A numpy view or copy of an array or a tensor (any device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _check(labels, n: int, name: str) -> np.ndarray:
    lab = _host(labels).reshape(-1)
    if lab.shape[0] != n:
        raise ValueError(f"{name} has {lab.shape[0]} entries for {n} elements")
    if not np.issubdtype(lab.dtype, np.integer):
        # A float tag (e.g. read back from VTK cell data) must be
        # exactly integral — truncation would silently re-bin elements.
        as_int = lab.astype(np.int64)
        if not np.array_equal(as_int, lab):
            raise ValueError(f"{name} must hold integral values")
        lab = as_int
    if lab.size and lab.min() < 0:
        raise ValueError(f"{name} must be non-negative integers")
    return lab.astype(np.int64)


def label_totals(
    flux,
    volumes,
    labels,
    num_labels: int = 0,
) -> np.ndarray:
    """Integrated tally per label: ``sum(flux_e · volume_e)`` over the
    elements carrying each label — with ``flux`` the volume-normalized
    field the engine reports (``normalized_flux``), this is the total
    track length (∝ reaction-rate integral) per pincell / material.
    Returns [max(max(label)+1, num_labels)] float64, zeros for unused
    labels — pass ``num_labels`` (e.g. nx·ny) so trailing empty labels
    keep their slots when reducing a slice."""
    flux = np.asarray(_host(flux), np.float64).reshape(-1)
    vol = np.asarray(_host(volumes), np.float64).reshape(-1)
    lab = _check(labels, flux.shape[0], "labels")
    if vol.shape[0] != flux.shape[0]:
        raise ValueError(
            f"volumes has {vol.shape[0]} entries for {flux.shape[0]} elements"
        )
    return np.bincount(lab, weights=flux * vol, minlength=num_labels)


def label_averages(
    flux,
    volumes,
    labels,
    num_labels: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(volume-weighted mean flux per label, total volume per label).
    Labels with zero volume report a zero mean (not NaN)."""
    flux = np.asarray(_host(flux), np.float64).reshape(-1)
    vol = np.asarray(_host(volumes), np.float64).reshape(-1)
    lab = _check(labels, flux.shape[0], "labels")
    if vol.shape[0] != flux.shape[0]:
        raise ValueError(
            f"volumes has {vol.shape[0]} entries for {flux.shape[0]} elements"
        )
    totals = np.bincount(lab, weights=flux * vol, minlength=num_labels)
    vols = np.bincount(lab, weights=vol, minlength=num_labels)
    mean = np.divide(
        totals, vols, out=np.zeros_like(totals), where=vols > 0
    )
    return mean, vols
