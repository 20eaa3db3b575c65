"""Whole runs at the tiny size on the CPU (the look for a card skipped),
sound and with the timed path broken underneath: the sound run comes out
correct, every fault not. The cells run on one card, so no exchange
between cards can be left out."""

import time

import pytest
import torch

from fhebench import harness
from fhebench.faults import answer_altered, half_batch_left_out, layer_returns_its_input


CELLS = ["mnist-bsgs.e2e", "mnist-bsgs.server", "mnist-boot.e2e"]


def run(tiny, workload, seconds=0.5):
    bench = harness.load_benchmark(tiny.parent)
    cell = harness.find(bench["workloads"], workload, "workload")
    return harness.run_cell(bench, cell, 2**31 + 5, seconds, False, torch.device("cpu"),
                            time.perf_counter(), here=tiny, root=tiny.parent)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tiny, workload):
    res = run(tiny, workload)
    assert res["correct"] is True, res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [layer_returns_its_input, half_batch_left_out,
                                   answer_altered])
def test_fault_is_not_correct(tiny, workload, fault, monkeypatch):
    fault(monkeypatch)
    res = run(tiny, workload)
    assert res["correct"] is False, res["compared"]
    assert res["failed"] > 0
