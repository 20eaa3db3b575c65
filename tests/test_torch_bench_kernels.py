"""toyfhe_tpu_torch command-line tools on the CPU: the kernel A/B entry
point at a small size, every row passing its bit-equality checks through
the plain twins, and the profiling tool's kernel grouping and its refusal
to run without a card."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from toyfhe_tpu_torch.tools import bench_kernels, profile_mnist

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
ROWS = ("k1", "k2_7grp", "k2_paired", "polymul_unfused", "polymul_k4")


def test_run_returns_the_five_rows():
    """The five rows of the reference tool."""
    res = bench_kernels.run(n=256, limbs=2, rows=4, device="cpu", reps=1)
    assert tuple(res["rows_ms"]) == ROWS and res["paired_ok"]
    assert (res["n"], res["limbs"], res["rows"], res["device"]) == (256, 2, 4, "cpu")
    for row in res["rows_ms"].values():
        assert row["ms"] > 0 and row["plain_ms"] > 0 and row["transforms_per_s"] > 0
    assert set(res["ratios"]) == {"k2_7grp_vs_k1", "k2_paired_vs_k1", "k2_paired_vs_7grp",
                                  "polymul_k4_vs_unfused"}
    lines = bench_kernels.report(res)
    assert len(lines) == 5 and all("ms/batch" in ln for ln in lines)


@pytest.mark.parametrize("n, limbs, rows", [(128, 1, 1), (512, 3, 2)])
def test_run_other_shapes(n, limbs, rows):
    res = bench_kernels.run(n=n, limbs=limbs, rows=rows, device="cpu", reps=1)
    assert tuple(res["rows_ms"]) == ROWS


def test_command_line_on_the_cpu():
    res = subprocess.run([sys.executable, "-m", "toyfhe_tpu_torch.tools.bench_kernels",
                          "--n", "256", "--limbs", "2", "--rows", "2", "--device", "cpu",
                          "--reps", "1"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = res.stdout.strip().splitlines()
    assert len(out) == 6 and out[0].startswith("device=cpu")
    assert "polymul unfused" in out[-2] and "polymul K4" in out[-1]


def test_command_line_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        bench_kernels.main(["--n", "256", "--limbs", "1", "--rows", "1"])


def test_profile_tool_groups_and_needs_a_card():
    assert profile_mnist.group_of("void (anonymous namespace)::ntt_cluster_kernel<3, true, true>(long const*)") \
        == "K1 transforms"
    assert profile_mnist.group_of("void at::native::vectorized_elementwise_kernel<4, ...>") \
        == "elementwise"
    assert profile_mnist.group_of("void at::native::reduce_kernel<512, 1, ...>") == "reductions"
    assert profile_mnist.group_of("something else") == "other"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        profile_mnist.main([])
