"""Faults planted under the timed path, for the check that ``correct``
comes out false when the program is broken underneath.

    python3 fhebench/faults.py --workload <cell> --seed <n> --seconds <s> \
        --fault layer_returns_its_input|half_batch_left_out|answer_altered

runs the cell as ``run.py`` does (one card), with the fault planted before
the system is built, and prints the result line with the numbers compared.
The benchmark's runs never plant one; the CPU tests plant each under whole
tiny runs (``fhebench/tests/test_fhebench_faults.py``). Each fault takes an
object with ``setattr(target, name, value)``, as pytest's ``monkeypatch``.
The cells run on one card, so no exchange between cards can be left out.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from fhebench import run  # noqa: E402,F401  (a run's cache directories and host threads)

import numpy as np  # noqa: E402


def layer_returns_its_input(patch) -> None:
    """A dense layer returns its input state unchanged."""
    from toyfhe_tpu_torch.models import mnist as M
    from toyfhe_tpu_torch.parallel import layers as JL
    patch.setattr(M._BsgsDense, "__call__",
                  lambda self, gks, c1, c2, dual, place=None: (c1[0], c2[0]))
    patch.setattr(JL.RotateMatmulLayer, "compute",
                  lambda self, c1p, c2p, diag_dual: (c1p, c2p))


def half_batch_left_out(patch) -> None:
    """Only the first half of the batch is served; the rest get the
    first half's mean image."""
    from toyfhe_tpu_torch.models import mnist as M
    orig = M.public_preprocess

    def half(cfg, batch):
        b = np.array(batch, dtype=np.float64)
        b[len(b) // 2:] = b[:len(b) // 2].mean(axis=0)
        return orig(cfg, b)
    patch.setattr(M, "public_preprocess", half)


def answer_altered(patch) -> None:
    """One logit of each request (the first class of the first image) is
    altered where the answers are decrypted: moved by the largest logit's
    magnitude."""
    from toyfhe_tpu_torch.models import mnist as M
    orig = M.decrypt

    def altered(key, c):
        out = np.array(orig(key, c))
        out[0] += np.max(np.abs(out))
        return out
    patch.setattr(M, "decrypt", altered)


FAULTS = {f.__name__: f for f in (layer_returns_its_input, half_batch_left_out,
                                  answer_altered)}


class _Patch:
    @staticmethod
    def setattr(target, name, value) -> None:
        setattr(target, name, value)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    args = ap.parse_args(argv)

    import torch

    from fhebench import harness

    bench = harness.load_benchmark()
    cell = harness.find(bench["workloads"], args.workload, "workload")
    if not torch.cuda.is_available():
        print("fhebench: a planted fault runs on a CUDA device", file=sys.stderr)
        return 2
    FAULTS[args.fault](_Patch)
    result = harness.run_cell(bench, cell, args.seed, args.seconds, False,
                              torch.device("cuda", 0), T_START)
    for line in harness.compared_lines(result):
        print(line, file=sys.stderr, flush=True)
    print(json.dumps({"fault": args.fault, **result}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
