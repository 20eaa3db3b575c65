"""The ResNet-20 cell's files: found by name, loading no JAX, its reference
against the port's plain model, its byte floor against what the set-up
holds, its metric readers, its control and its planted faults — the whole
pipeline at a toy size (8×8 images, widths 2/4/8, one block a stage,
N = 2^7, sign components of degree 7) on the CPU."""

import copy
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from fhebench import control, faults_resnet, harness, work
from fhebench.client import Requests

ROOT = harness.ROOT
CELL = "resnet20-cifar10.e2e"


def config():
    return harness.load_json(ROOT / "fhebench/configs/resnet20-cifar10.json")


_TOY = []


def toy_config():
    """The served configuration cut to the toy size, its bound from the
    same sweep (doubled: the toy's weights spread more)."""
    if not _TOY:
        from toyfhe_tpu_torch.models import resnet_plain as P
        from toyfhe_tpu_torch.models import sign_fit
        cfg = copy.deepcopy(config())
        m = cfg["model"]
        m.update(image=8, widths=[2, 4, 8], blocks_per_stage=1, classes=4, ring_logn=7)
        m["relu"] = dict(alpha=6, degrees=[7, 7, 7],
                         coeffs=sign_fit.fit_composite_sign((7, 7, 7), alpha=6))
        m["bound"] = 2.0 * P.bound_sweep(dict(m, bound=1.0), 64)
        cfg["recipe"]["depth"] = 50
        _TOY.append(cfg)
    return copy.deepcopy(_TOY[0])


def test_files_are_found_by_name():
    bench = harness.load_benchmark()
    cell = harness.find(bench["workloads"], CELL, "workload")
    assert cell["chips"] == 1 and cell["traffic"] == "closed-e2e"
    cfg = config()
    assert cfg["reduced"] == [] and cfg["model"]["widths"] == [16, 32, 64]
    assert cfg["model"]["blocks_per_stage"] == 3 and cfg["model"]["image"] == 32
    ref = harness.load_module("reference", cfg["reference"])
    assert ref.request_shape(cfg["model"]) == (1, (3, 32, 32))
    assert hasattr(harness.load_module("systems", cfg["system"]), "System")
    assert work.floor_bytes(cfg, False) > work.floor_bytes(cfg, False) - 1 > 0
    names = [m["name"] for m in harness.cell_metrics(bench, cell, "per_layer")]
    assert names == ["r20_idle_share", "r20_k1_roofline", "r20_mfu"]
    assert [m["name"] for m in harness.cell_metrics(bench, cell, "end_to_end")] == [
        "images_per_s", "setup_s"]


def test_reference_equals_the_ports_plain_model():
    """The benchmark's reference, written again, against
    ``models/resnet_plain.py`` on seeded weights: the same draws, logits
    within 1e-12."""
    from toyfhe_tpu_torch.models import resnet_plain as P
    ref = harness.load_module("reference", "resnet20")
    model = config()["model"]
    mine = ref.init_params(model, np.random.default_rng([2**31 + 1, 1]))
    theirs = P.init_params(model, np.random.default_rng([2**31 + 1, 1]))
    assert mine.keys() == theirs.keys()
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k])
    imgs = np.random.default_rng(4).uniform(0.0, 1.0, (2, 3, 32, 32))
    np.testing.assert_allclose(ref.forward(model, mine, imgs), P.forward(model, theirs, imgs),
                               rtol=0, atol=1e-12)


def test_system_and_reference_load_no_jax(tmp_path):
    """The system built at the toy size and the reference's pass, in a
    fresh interpreter."""
    path = tmp_path / "toy.json"
    path.write_text(json.dumps(toy_config()))
    code = (
        "import json, sys, numpy as np, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from fhebench import harness\n"
        f"cfg = json.load(open({str(path)!r}))\n"
        "ref = harness.load_module('reference', cfg['reference'])\n"
        "sysm = harness.load_module('systems', cfg['system'])\n"
        "w = ref.init_params(cfg['model'], np.random.default_rng(1))\n"
        "ref.forward(cfg['model'], w, np.zeros((1, 3, 8, 8)), bits=11)\n"
        "sysm.System(cfg, w, torch.Generator().manual_seed(1))\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def judged(cfg, ref, weights, system, seed=2**31 + 7):
    mix = harness.load_json(harness.HERE / "traffic/closed-e2e.json")
    client = Requests(mix, ref.request_shape(cfg["model"]), seed)
    logits = system.run(client.batch(0), torch.Generator().manual_seed(6))
    return harness.judge([(0, np.asarray(logits))], client, ref, cfg["model"], weights,
                         cfg["limits"])


@pytest.fixture(scope="module")
def toy_run():
    """The toy system after one request, and that request's readings."""
    cfg = toy_config()
    ref = harness.load_module("reference", cfg["reference"])
    weights = ref.init_params(cfg["model"], np.random.default_rng([2**33 + 3, 1]))
    system = harness.load_module("systems", cfg["system"]).System(
        cfg, weights, torch.Generator().manual_seed(5))
    return cfg, ref, weights, system, judged(cfg, ref, weights, system)


def test_sound_toy_request_is_correct(toy_run):
    readings, failed = toy_run[-1]
    assert failed == 0, readings
    assert readings["logit_f16"] < 1.0


def test_floor_matches_what_the_setup_holds(toy_run):
    """The floor's keys are the set-up's Galois keys; its vectors a layer
    are the layer's encoded vectors and biases, at no more limbs than the
    layer holds them."""
    from toyfhe_tpu_torch.models import resnet as RN
    cfg, _, _, system, _ = toy_run
    n = 1 << cfg["model"]["ring_logn"]
    parts = harness.load_module("floors", "resnet20_boot").parts(cfg)
    assert parts["keys"] == system.setup.shifts
    assert [k.galois_element for k in system.setup.gks.keys] == [
        RN.galois_element(n, s) for s in parts["keys"]]
    counted = held = 0
    for name, count, limbs in parts["vectors"]:
        layer = system.pipe.layers[name]
        plan = layer.plan
        vectors = plan.vecs.shape[0] + (0 if plan.bias is None else plan.n_out)
        assert count <= vectors, name
        (w, _, _), = layer._enc.values()
        assert w.shape[-2] >= limbs, name
        counted += count * limbs * n * work.RESIDUE_BYTES
        held += vectors * w.shape[-2] * n * work.RESIDUE_BYTES
    assert 0 < counted <= held


def test_floor_counts_the_served_plans():
    """At the served size the floor counts every vector of every layer's
    plan (the channels fill each ciphertext), but the first conv's, whose
    3 input channels need 4 channel offsets where it counts 3 (for each
    of 4 output ciphertexts and 9 taps), and the FC's bias, which the
    pipeline adds after the rotate-and-sum."""
    from toyfhe_tpu_torch.models import resnet as RN
    from toyfhe_tpu_torch.models import resnet_plain as P
    cfg = config()
    model = cfg["model"]
    parts = harness.load_module("floors", "resnet20_boot").parts(cfg)
    assert parts["keys"] == RN.rotation_shifts(model, 4096)
    assert parts["layer_limbs"] == 25 and parts["tower"] == (60, 6, 12)
    params = P.init_params(model, np.random.default_rng(1))
    lays = RN.stage_layouts(model, 4096)
    plans = {"stem": RN.conv_plan(*RN.stem_weights(model, params), lays[0], lays[1])}
    for i, width in enumerate(model["widths"]):
        for j in range(model["blocks_per_stage"]):
            name = f"s{i}.b{j}"
            w1, b1 = RN.conv_weights(model, params, name + ".conv1")
            if i and not j:
                lfull = RN.strided_layout(lays[i], width)
                plans[name + ".conv1"] = RN.conv_plan(w1, b1, lays[i], lfull, 2)
                plans[name + ".repack"] = RN.repack_plan(lfull, lays[i + 1], width)
                plans[name + ".shortcut"] = RN.repack_plan(lays[i], lays[i + 1],
                                                           model["widths"][i - 1])
            else:
                plans[name + ".conv1"] = RN.conv_plan(w1, b1, lays[i + 1], lays[i + 1])
            plans[name + ".conv2"] = RN.conv_plan(*RN.conv_weights(model, params, name + ".conv2"),
                                                  lays[i + 1], lays[i + 1])
    plans["fc"] = RN.fc_plan(params["fc.w"], lays[-1])
    for name, count, _ in parts["vectors"]:
        vectors = plans[name].vecs.shape[0] + (0 if plans[name].bias is None
                                               else plans[name].n_out)
        extra = {"stem": -4 * 9, "fc": 1}.get(name, 0)       # the FC's bias: after the sums
        assert count == vectors + extra, name


@pytest.mark.parametrize("fault", sorted(faults_resnet.FAULTS))
def test_planted_fault_is_not_correct(toy_run, fault, monkeypatch):
    cfg, ref, weights, _, _ = toy_run
    faults_resnet.FAULTS[fault](monkeypatch)
    system = harness.load_module("systems", cfg["system"]).System(
        cfg, weights, torch.Generator().manual_seed(5))
    readings, failed = judged(cfg, ref, weights, system)
    assert failed == 1, readings


@pytest.mark.parametrize("seed", [11, 2**31 + 3, 987654321])
def test_control_is_not_correct(seed):
    bench = harness.load_benchmark()
    dtype = getattr(torch, control.control_dtype(bench, CELL))
    res = control.control_readings(bench, CELL, seed, 2, dtype, torch.device("cpu"))
    assert res["correct"] is False, res


def test_reference_in_float64_is_correct():
    bench = harness.load_benchmark()
    res = control.control_readings(bench, CELL, 11, 2, torch.float64, torch.device("cpu"))
    assert res["correct"] is True
    assert max(res["readings"].values()) < 1e-9


def test_metric_readers():
    cfg = config()
    win = harness.Window(cfg, {"encode_in_request": True}, 50.0, 1)
    win.chunks = [{"requests": 1, "wall_s": 10.0, "busy_s": 9.0, "k1_device_s": 0.5,
                   "k1_transforms": 1000, "idle": {}}]
    read = lambda name: harness.load_module("metrics", name).read(win)
    for mine, theirs in (("r20_idle_share", "idle_share"), ("r20_k1_roofline", "k1_roofline"),
                         ("r20_mfu", "mfu")):
        assert read(mine) == pytest.approx(read(theirs)) and read(mine) > 0
    assert read("r20_mfu") == pytest.approx(
        100 * work.seconds_at_hbm(work.floor_bytes(cfg, False)) / 10.0)
    empty = harness.Window(cfg, {"encode_in_request": True}, 50.0, 1)
    assert all(harness.load_module("metrics", n).read(empty) is None
               for n in ("r20_idle_share", "r20_k1_roofline", "r20_mfu"))


def test_a_traced_toy_run_reports_every_metric(tmp_path):
    """The cell through the harness at the toy size, traced: correct, and
    its per-layer metrics read."""
    from fhebench.tests.conftest import make_tiny
    here = make_tiny(tmp_path)
    (here / "configs/resnet20-cifar10.json").write_text(json.dumps(toy_config()))
    (here / "floors").symlink_to(harness.HERE / "floors")
    bench = harness.load_benchmark(tmp_path)
    cell = harness.find(bench["workloads"], CELL, "workload")
    res = harness.run_cell(bench, cell, 2**33 + 5, 0.1, True, torch.device("cpu"),
                           time.perf_counter(), here=here, root=tmp_path)
    assert res["correct"] is True, res["compared"]
    assert {"r20_idle_share", "r20_mfu"} <= set(res["metrics"])
