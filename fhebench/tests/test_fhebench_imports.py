"""The benchmark loads neither JAX nor the JAX package, and refuses to run
without a card."""

import subprocess
import sys
import types

from fhebench import harness

ROOT = harness.ROOT


def test_forbidden_names_are_compared_whole(monkeypatch):
    assert "toyfhe_tpu_torch" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "toyfhe_tpu.core", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["jaxlib", "toyfhe_tpu"]


def test_a_cpu_run_loads_no_jax(tiny):
    """A whole run of each cell at the tiny size, in a fresh interpreter."""
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from pathlib import Path\n"
        "from fhebench import harness, control\n"
        f"here = Path({str(tiny)!r})\n"
        "bench = harness.load_benchmark(here.parent)\n"
        "for cell in bench['workloads']:\n"
        "    if cell['config'] == 'mnist-bsgs':\n"
        "        harness.run_cell(bench, cell, 3, 0.5, False, torch.device('cpu'),\n"
        "                         time.perf_counter(), here=here, root=here.parent)\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result():
    code = ("import torch\ntorch.cuda.is_available = lambda: False\n"
            "import runpy, sys\n"
            "sys.argv = ['run.py', '--workload', 'mnist-bsgs.e2e', '--seed', '1',"
            " '--seconds', '1', '--trace', '0']\n"
            f"runpy.run_path({str(ROOT / 'fhebench/run.py')!r}, run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
