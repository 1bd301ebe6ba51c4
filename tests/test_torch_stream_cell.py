"""PyTorch port, the benchmark's streaming cell on the CPU against its
plain reference: ``assembly3x3-10M-stream.two_phase4`` run through the
harness's own path (``benchmark.harness.run_cell``), cut here to the
tiny lattice and 2,000 particles, in 7 chunks (the last one short) and
in one. Each run is ``correct``, every compared number within the
configuration's limits. Two pipelines with a planted fault, one that
never dispatches the last chunk and one that dispatches each chunk on
the other slot's staged tensors, come out not ``correct``."""

import pytest
import torch

import pumiumtally_tpu_torch as ptt
from benchmark.cell import load_benchmark, resolve
from benchmark.harness import run_cell
from benchmark.tests._tiny import TINY_MESH

CELL = "assembly3x3-10M-stream.two_phase4"
N = 2000
SEED = 2**33 + 11


def tiny(chunk_size: int):
    cell = resolve(load_benchmark(), CELL, False)
    assert cell.config["facade"] == "StreamingTally"
    cell.config["mesh"].update(TINY_MESH)
    cell.config["particles"] = N
    cell.config["facade_args"] = {"chunk_size": chunk_size}
    return cell


def run(tmp_path, cell):
    return run_cell(cell, SEED, 0.2, False, device="cpu", cache=tmp_path)


class SkipsLastChunk(ptt.StreamingTally):
    def _pipeline(self, specs_of, dispatch):
        def faulty(k, staged):
            if k == self.nchunks - 1:
                return torch.ones((), dtype=torch.bool)
            return dispatch(k, staged)
        return super()._pipeline(specs_of, faulty)


class OtherSlot(ptt.StreamingTally):
    def _pipeline(self, specs_of, dispatch):
        seen = []

        def faulty(k, staged):
            seen.append(staged)
            return dispatch(k, seen[k - 1] if k else staged)
        return super()._pipeline(specs_of, faulty)


@pytest.mark.parametrize("chunk_size,chunks", [(300, 7), (N, 1)])
def test_stream_cell_is_correct(tmp_path, chunk_size, chunks):
    assert -(-N // chunk_size) == chunks
    cell = tiny(chunk_size)
    res, _ = run(tmp_path, cell)
    assert res["correct"], res["check"]
    limits = cell.config["limits"]
    assert set(res["check"]) == set(limits)
    for k, c in res["check"].items():
        assert c["value"] <= c["limit"] == limits[k], (k, c)
    assert res["attempted"] > 0 and res["attempted"] % 4 == 0


@pytest.mark.parametrize("faulty", [SkipsLastChunk, OtherSlot])
def test_planted_pipeline_fault_is_not_correct(tmp_path, monkeypatch,
                                               faulty):
    monkeypatch.setattr(ptt, "StreamingTally", faulty)
    res, _ = run(tmp_path, tiny(300))
    assert not res["correct"], (faulty.__name__, res["check"])
