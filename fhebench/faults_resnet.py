"""Faults planted in the encrypted ResNet, for the check that ``correct``
comes out false when its pipeline is broken underneath.

    python3 fhebench/faults_resnet.py --workload resnet20-cifar10.e2e --seed <n> \
        --seconds <s> --fault conv_tap_dropped|shortcut_dropped|last_relu_component_skipped

runs the cell as ``run.py`` does (one card), with the fault planted before
the system is built, and prints the result line with the numbers compared.
The benchmark's runs never plant one; the CPU tests plant each at a toy size
(``fhebench/tests/test_fhebench_resnet.py``). Each fault takes an object
with ``setattr(target, name, value)``, as pytest's ``monkeypatch``.
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


def conv_tap_dropped(patch) -> None:
    """Every conv leaves out one of its nine taps, the right-hand neighbour."""
    from toyfhe_tpu_torch.models import resnet as RN
    orig = RN.conv_plan

    def dropped(w, bias, lin, lout, stride=1):
        w = w.copy()
        w[:, :, 1, 2] = 0.0
        return orig(w, bias, lin, lout, stride)
    patch.setattr(RN, "conv_plan", dropped)


def shortcut_dropped(patch) -> None:
    """The identity shortcut is left out: a block's output is its second
    conv's alone."""
    from toyfhe_tpu_torch.models import resnet as RN
    patch.setattr(RN, "identity_shortcut", lambda h, x: h)


def last_relu_component_skipped(patch) -> None:
    """Every ReLU's sign polynomial stops before its last component."""
    from toyfhe_tpu_torch.models import resnet as RN
    orig = RN.app_relu
    patch.setattr(RN, "app_relu", lambda ek, u, comps, store: orig(ek, u, comps[:-1], store))


FAULTS = {f.__name__: f for f in (conv_tap_dropped, shortcut_dropped,
                                  last_relu_component_skipped)}


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
