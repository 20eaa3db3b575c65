"""The control (the plain reference in the configuration's lower
precision, put in the program's place) fails the cell's limit, at the
cell's own size, on three seeds; and the reference judged against itself
passes it."""

import pytest
import torch

from fhebench import control, harness

REQUESTS = {"mnist-bsgs.e2e": 190, "mnist-boot.e2e": 40, "mnist-bsgs.server": 16}
SEEDS = [11, 2**31 + 3, 987654321]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", sorted(REQUESTS))
def test_control_is_not_correct(workload, seed):
    bench = harness.load_benchmark()
    dtype = getattr(torch, control.control_dtype(bench, workload))
    res = control.control_readings(bench, workload, seed, REQUESTS[workload], dtype,
                                   torch.device("cpu"))
    assert res["correct"] is False, res


@pytest.mark.parametrize("workload", sorted(REQUESTS))
def test_reference_in_float64_is_correct(workload):
    bench = harness.load_benchmark()
    res = control.control_readings(bench, workload, SEEDS[0], 4, torch.float64,
                                   torch.device("cpu"))
    assert res["correct"] is True
    # float64 roundings, 2^-42 of a float16 one, summed over the pass
    assert max(res["readings"].values()) < 1e-9
