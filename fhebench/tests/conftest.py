"""Fixtures of the benchmark's own tests (``python -m pytest fhebench/tests``).

``tiny`` is a checkout-like folder holding a copy of the benchmark's data
at a size the CPU runs in seconds: the configurations cut to a 8×8 image,
a 4×4 kernel and N = 2^6 (8 images a request), the pooled mixes to 3
batches, and the systems, references and metric readers themselves
(linked, not copied). ``cuda_device`` skips a test where no card is present.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "fhebench"
TINY_MODEL = dict(image=8, kernel=4, stride=4, channels=2, classes=4, ring_logn=6)


def make_tiny(root: Path) -> Path:
    """A checkout at ``root`` with the tiny data; returns its fhebench/."""
    here = root / "fhebench"
    (here / "configs").mkdir(parents=True)
    (here / "traffic").mkdir()
    for kind in ("systems", "reference", "metrics"):
        os.symlink(BENCH / kind, here / kind)
    for path in (BENCH / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["model"].update(TINY_MODEL)
        (here / "configs" / path.name).write_text(json.dumps(cfg))
    for path in (BENCH / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(pool_batches=min(mix["pool_batches"], 3))
        (here / "traffic" / path.name).write_text(json.dumps(mix))
    (root / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    return here


@pytest.fixture
def tiny(tmp_path):
    return make_tiny(tmp_path)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
