"""On the card: one short run of the server cell through the command, and
the control there."""

import json
import subprocess
import sys

import pytest
import torch

from fhebench import control, harness

ROOT = harness.ROOT


@pytest.mark.cuda
def test_short_run_prints_a_correct_result(cuda_device):
    out = subprocess.run([sys.executable, "fhebench/run.py", "--workload", "mnist-bsgs.server",
                          "--seed", str(2**31 + 9), "--seconds", "2", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert set(res["metrics"]) <= {m["name"] for m in harness.load_benchmark()["per_layer"]}
    assert all(k == c for k, c in res["k1_check"])
    assert out.stderr.strip().splitlines()[-1].startswith("compared ")


@pytest.mark.cuda
def test_control_on_the_card_is_not_correct(cuda_device):
    bench = harness.load_benchmark()
    dtype = getattr(torch, control.control_dtype(bench, "mnist-bsgs.e2e"))
    res = control.control_readings(bench, "mnist-bsgs.e2e", 13, 40, dtype, cuda_device)
    assert res["correct"] is False
