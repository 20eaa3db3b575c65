"""The benchmark of toyfhe_tpu_torch on an NVIDIA GPU: one run of one cell.

    python3 fhebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's system from the seed (keys on the card, weights and images
from the seed), warms up every graph the cell replays, serves the cell's
traffic for ``--seconds`` and checks every answer against the plain
reference. The last line of standard output is the result as one JSON
object; the last lines of standard error are the numbers compared, each with
its limit. With ``--trace 0`` the metrics are the cell's end-to-end ones,
with ``--trace 1`` its per-layer ones. Exits non-zero, printing no result,
without a CUDA device, or when the run loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".fhebench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
# one host thread: the load comes from one process, and a run on a shared
# host spreads less (and sets up faster) than with a pool per core
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from fhebench import harness

    torch.set_num_threads(1)

    bench = harness.load_benchmark()
    cell = harness.find(bench["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"fhebench: {args.workload} needs {cell['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"fhebench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for line in harness.compared_lines(result):
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
