"""A configuration, a mix, a cell and a metric added as files are found by
name, with no edit of the harness; the result line keeps the contract."""

import json
import time

import numpy as np
import pytest
import torch

from fhebench import harness, work


def own_folder(here, kind):
    """Turn the tiny checkout's linked ``kind/`` folder into a folder of its
    own that links each file of the benchmark's, so a test can add one."""
    folder = here / f"{kind}_new"
    folder.mkdir()
    for path in (harness.HERE / kind).glob("*.py"):
        (folder / path.name).symlink_to(path)
    (here / kind).unlink()
    folder.rename(here / kind)
    return here / kind


def test_new_files_are_found_by_name(tiny):
    root = tiny.parent
    cfg = json.loads((tiny / "configs/mnist-bsgs.json").read_text())
    cfg["model"]["channels"] = 3
    (tiny / "configs/mnist-bsgs-c3.json").write_text(json.dumps(cfg))
    mix = json.loads((tiny / "traffic/closed-e2e.json").read_text())
    mix["pixel_high"] = 0.5
    (tiny / "traffic/closed-dim.json").write_text(json.dumps(mix))
    (own_folder(tiny, "metrics") / "requests_seen.py").write_text(
        "def read(win):\n    return float(len(win.latencies_s))\n")
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
    cfg = json.loads((tiny / "configs/mnist-bsgs.json").read_text())
    request = harness.load_module("reference", cfg["reference"], tiny).request_shape(cfg["model"])
    a, b = images(mix, request, 2**33 + 1, 7), images(mix, request, 2**33 + 1, 7)
    assert a.shape == (8, 8, 8) and np_equal(a, b)      # the batch N = 2^6 serves
    assert not np_equal(a, images(mix, request, 2**33 + 2, 7))


def np_equal(a, b):
    return bool(np.array_equal(a, b))


TOY_REFERENCE = '''"""A model that is no MNIST: one dense layer over [3, 8, 8] inputs, four a
request."""
import numpy as np


def request_shape(model):
    return model["batch"], tuple(model["input"])


def init_params(model, rng):
    f = int(np.prod(model["input"]))
    return {"w": rng.normal(size=(model["classes"], f)) / np.sqrt(f),
            "b": rng.normal(size=model["classes"])}


def forward(model, params, inputs, bits=None):
    def t(a):
        a = np.asarray(a, dtype=np.float64)
        if bits is None:
            return a
        m, e = np.frexp(a)
        return np.ldexp(np.round(m * (1 << bits)) / (1 << bits), e)
    x = t(inputs).reshape(len(inputs), -1)
    return t(t(x @ t(params["w"]).T) + t(params["b"]))
'''

TOY_SYSTEM = '''"""The same dense layer in float32 numpy."""
import numpy as np


class System:
    def __init__(self, config, weights, gen):
        self.w, self.b = np.float32(weights["w"]), np.float32(weights["b"])

    def run(self, inputs, gen, layer_times=None):
        x = np.asarray(inputs, dtype=np.float32).reshape(len(inputs), -1)
        return (x @ self.w.T + self.b).T
'''

TOY_FLOOR = '''import math


def floor_bytes(config, encoded_inputs):
    m = config["model"]
    f = math.prod(m["input"])
    return 4 * (m["batch"] * f + m["classes"] * f + m["classes"] + m["classes"] * m["batch"])
'''


def test_a_model_that_is_no_mnist_is_added_as_files(tiny, monkeypatch):
    """A configuration whose request is 4 inputs of [3, 8, 8], with its own
    reference, a numpy system and its byte floor, runs through the harness
    with no file of it edited: correct, its throughput counted at 4 a
    request, and ``mfu`` reading the floor from ``floors/<system>.py``."""
    root = tiny.parent
    (own_folder(tiny, "reference") / "toy_dense.py").write_text(TOY_REFERENCE)
    (own_folder(tiny, "systems") / "toy_dense.py").write_text(TOY_SYSTEM)
    (tiny / "floors").mkdir()
    (tiny / "floors/toy_dense.py").write_text(TOY_FLOOR)
    cfg = {"system": "toy_dense", "reference": "toy_dense", "limits": {"logit_f16": 1.0},
           "model": {"input": [3, 8, 8], "batch": 4, "classes": 5}}
    (tiny / "configs/toy-dense.json").write_text(json.dumps(cfg))
    bench = harness.load_benchmark(root)
    bench["configs"].append({"name": "toy-dense", "source": "x",
                             "file": "fhebench/configs/toy-dense.json", "reduced": [],
                             "why": "x"})
    cell = {"name": "toy-dense.e2e", "config": "toy-dense", "traffic": "closed-e2e",
            "chips": 1, "why": "x"}
    bench["workloads"].append(cell)
    harness.find(bench["per_layer"], "mfu", "metric")["workloads"].append(cell["name"])
    monkeypatch.setattr(work, "HERE", tiny)

    floor = 4 * (4 * 192 + 5 * 192 + 5 + 5 * 4)
    assert work.floor_bytes(cfg, False) == floor
    win = harness.Window(cfg, {"encode_in_request": True}, 1.0, 4)
    win.chunks = [{"requests": 3, "wall_s": 2e-3}]
    assert harness.load_module("metrics", "mfu").read(win) == pytest.approx(
        100 * work.seconds_at_hbm(floor) * 3 / 2e-3)

    t0 = time.perf_counter()
    res = harness.run_cell(bench, cell, 2**31 + 11, 0.2, False, torch.device("cpu"), t0,
                           here=tiny, root=root)
    assert res["correct"] is True and res["failed"] == 0, res["compared"]
    assert set(res["metrics"]) == {"images_per_s", "setup_s"}
    rate = res["metrics"]["images_per_s"]["value"]
    assert 4 * res["attempted"] / 0.5 < rate <= 4 * res["attempted"] / 0.2
    traced = harness.run_cell(bench, cell, 2**31 + 12, 0.2, True, torch.device("cpu"),
                              time.perf_counter(), here=tiny, root=root)
    assert traced["correct"] is True
    assert traced["metrics"]["mfu"]["value"] > 0
