"""A configuration, a mix, a cell and a metric added as files are found by
name, with no edit of the harness; the result line keeps the contract."""

import json
import time

import torch

from fhebench import harness


def test_new_files_are_found_by_name(tiny):
    root = tiny.parent
    cfg = json.loads((tiny / "configs/mnist-bsgs.json").read_text())
    cfg["model"]["channels"] = 3
    (tiny / "configs/mnist-bsgs-c3.json").write_text(json.dumps(cfg))
    mix = json.loads((tiny / "traffic/closed-e2e.json").read_text())
    mix["pixel_high"] = 0.5
    (tiny / "traffic/closed-dim.json").write_text(json.dumps(mix))
    metrics = tiny / "metrics_new"
    metrics.mkdir()
    (metrics / "requests_seen.py").write_text(
        "def read(win):\n    return float(len(win.latencies_s))\n")
    for name in ("images_per_s", "batch_p90_ms", "setup_s"):
        (metrics / f"{name}.py").symlink_to(harness.HERE / "metrics" / f"{name}.py")
    (tiny / "metrics").unlink()
    metrics.rename(tiny / "metrics")
    bench = harness.load_benchmark(root)
    bench["configs"].append({"name": "mnist-bsgs-c3", "source": "x",
                             "file": "fhebench/configs/mnist-bsgs-c3.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "c3.dim", "config": "mnist-bsgs-c3",
                               "traffic": "closed-dim", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "requests_seen", "unit": "requests",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["c3.dim"]})
    cell = harness.find(bench["workloads"], "c3.dim", "workload")
    res = harness.run_cell(bench, cell, 2**31 + 77, 1.0, False, torch.device("cpu"),
                           time.perf_counter(), here=tiny, root=root)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "compared"
    assert res["correct"] is True and res["failed"] == 0
    assert res["metrics"]["requests_seen"]["value"] == res["attempted"] > 0
    assert set(res["metrics"]) == {"images_per_s", "setup_s", "requests_seen"}
    assert res["device"]["count"] == 1


def test_same_seed_same_inputs(tiny):
    from fhebench.client import images
    mix = json.loads((tiny / "traffic/closed-e2e.json").read_text())
    model = json.loads((tiny / "configs/mnist-bsgs.json").read_text())["model"]
    a, b = images(mix, model, 2**33 + 1, 7), images(mix, model, 2**33 + 1, 7)
    assert a.shape == (8, 8, 8) and np_equal(a, b)      # the batch N = 2^6 serves
    assert not np_equal(a, images(mix, model, 2**33 + 2, 7))


def np_equal(a, b):
    import numpy as np
    return bool(np.array_equal(a, b))
