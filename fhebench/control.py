"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, computed in a lower precision.

    python3 fhebench/control.py --workload <cell> --seeds 1 2 3 --requests 160 \
        [--dtype float32|float16|bfloat16 ...] [--device cuda]

For each seed it builds the images a run of the cell with that seed sends
(``--requests`` requests; a pooled mix repeats its pool) and the same
weights, computes the x²-CNN in each ``--dtype`` (by default the
configuration's ``control``) with torch on ``--device`` (TF32 off), and
judges those logits against the float64 reference as a run judges the
program's. It prints one JSON line per seed and precision with
the readings beside the cell's limits; a sound limit makes every control
line read ``"correct": false``. The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from fhebench import harness  # noqa: E402
from fhebench.client import Requests  # noqa: E402


FP8 = ("float8_e4m3fn", "float8_e5m2")


def forward_lowp(reference, model: dict, params: dict, imgs: np.ndarray, dtype,
                 device) -> np.ndarray:
    """The reference's pass with every operand and result in ``dtype``:
    logits [B, classes] as float64. The float8 types have no general
    arithmetic: each operand and each op's result is rounded to them, the
    op itself computed in float32."""
    fp8 = str(dtype).split(".")[-1] in FP8
    work = torch.float32 if fp8 else dtype
    q = (lambda x: x.to(dtype).to(work)) if fp8 else (lambda x: x)
    t = lambda a: q(torch.as_tensor(np.asarray(a, dtype=np.float64)).to(device=device,
                                                                         dtype=work))
    c = model["channels"]
    pt = t(reference.patches(model, np.asarray(imgs, dtype=np.float64)))
    conv = q(q(torch.einsum("bpk,kc->bpc", pt, t(params["conv_w"]).reshape(-1, c)))
             + t(params["conv_b"]))
    sq1 = q(conv * conv)
    feats = torch.cat([sq1[:, :, ch] for ch in range(c)], dim=1)
    fq1 = q(q(feats @ t(params["w1"]).T) + t(params["b1"]))
    sq2 = q(fq1 * fq1)
    out = q(q(sq2 @ t(params["w2"]).T) + t(params["b2"]))
    return out.to(torch.float64).cpu().numpy()


def control_readings(bench: dict, workload: str, seed: int, requests: int, dtype, device,
                     here: Path = harness.HERE, root: Path = harness.ROOT) -> dict:
    """The control's readings and verdict on ``requests`` requests of a run
    of ``workload`` with ``seed``."""
    cell = harness.find(bench["workloads"], workload, "workload")
    entry = harness.find(bench["configs"], cell["config"], "configuration")
    config = harness.load_json(root / entry["file"])
    mix = harness.load_json(here / "traffic" / f"{cell['traffic']}.json")
    reference = harness.load_module("reference", config["reference"], here)
    s = harness.seed_words(seed)
    weights = reference.init_params(config["model"], np.random.default_rng([s, 1]))
    client = Requests(mix, config["model"], s)
    answers = [(i, forward_lowp(reference, config["model"], weights, client.batch(i), dtype,
                                device).T) for i in range(requests)]
    limits = config["limits"]
    readings, failed = harness.judge(answers, client, reference, config["model"], weights,
                                     limits)
    return {"correct": failed == 0 and all(readings[k] <= v for k, v in limits.items()),
            "readings": readings, "limits": limits}


def control_dtype(bench: dict, workload: str, root: Path = harness.ROOT) -> str:
    """The precision a configuration names for its control."""
    cell = harness.find(bench["workloads"], workload, "workload")
    entry = harness.find(bench["configs"], cell["config"], "configuration")
    return harness.load_json(root / entry["file"])["control"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, required=True)
    ap.add_argument("--dtype", nargs="+", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    bench = harness.load_benchmark()
    dtypes = args.dtype or [control_dtype(bench, args.workload)]
    for dt in dtypes:
        for seed in args.seeds:
            out = control_readings(bench, args.workload, seed, args.requests,
                                   getattr(torch, dt), device)
            print(json.dumps({"workload": args.workload, "dtype": dt, "seed": seed, **out}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
