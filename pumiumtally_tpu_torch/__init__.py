"""pumiumtally_tpu_torch: the PyTorch/CUDA port of pumiumtally_tpu.

Track-length tallies over a tetrahedral mesh, driven through the
reference's three-call protocol (``CopyInitialPosition`` /
``MoveToNextLocation`` / ``WriteTallyResults``), on one NVIDIA H100. The
device work runs in hand-written CUDA kernels (``csrc/``, built by
``kernels.py`` at first use); every kernel's plain PyTorch version runs
when the caller asks for ``device="cpu"``. The package imports torch
and numpy, never jax and nothing of ``pumiumtally_tpu``.
"""

from pumiumtally_tpu_torch.api.partitioned import PartitionedPumiTally
from pumiumtally_tpu_torch.api.tally import PumiTally, TallyTimes
from pumiumtally_tpu_torch.config import TallyConfig
from pumiumtally_tpu_torch.mesh.box import build_box
from pumiumtally_tpu_torch.mesh.pincell import build_lattice, build_pincell
from pumiumtally_tpu_torch.mesh.tetmesh import TetMesh

__all__ = [
    "PartitionedPumiTally",
    "PumiTally",
    "TallyConfig",
    "TallyTimes",
    "TetMesh",
    "build_box",
    "build_lattice",
    "build_pincell",
]
