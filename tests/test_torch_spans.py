"""The port's spans (``utils.metrics.span``).

One request of each tiny pipeline (N = 2^6: 8×8 images, a 4×4 kernel,
stride 4, 2 channels, 4 classes) under ``torch.profiler`` holds the span
tree — its names, how many of each, and each span's nearest spanned
ancestor; without a profiler the same request opens no span and records
nothing; CPU and eager calls capture nothing. A request encodes its grid
as one batch (the counters ``ckks.encode_batches`` and
``ckks.encode_vectors``, at the production 7×7 kernel). A span is a host
event of the profiler, not a user annotation (which kineto also draws on
the device's timeline). The ``cuda`` tests hold, on the card, that one
capture is recorded once and replays add none, that a replay's spans nest
inside its stage's, that no span reaches the device's timeline, and that a
request's encode on the card equals the CPU's.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from toyfhe_tpu_torch.models import mnist as M
from toyfhe_tpu_torch.utils import graphs, metrics

torch.set_num_threads(1)

SMALL = dict(image=8, kernel=4, stride=4, channels=2, classes=4, ring_logn=6)
GRID7 = dict(image=10, kernel=7, stride=3, channels=2, classes=4, ring_logn=6)   # 49 vectors
BOOT = dict(depth=46, K=5.0, deg=24, scale_limbs=2, radix=16, arcsin=True, double_angle=2,
            hamming_weight=4)
BSGS_STAGES = ("encrypt", "conv", "square1", "dense1", "bias_rescale", "square2", "dense2")
BOOT_STAGES = ("encrypt", "conv", "square1", "dense1", "bias_rescale", "square2", "exhaust",
               "modraise_c2s", "evalmod", "s2c", "dense2")
ENCODE = ("slots", "fft", "quantize", "upload")
DECRYPT = ("raw", "download", "crt", "fft")


def build(kind: str, device, shape=SMALL):
    cfg = M.MNISTConfig(**shape)
    gen = torch.Generator(device=device).manual_seed(1)
    weights = M.init_params(cfg, 2)
    if kind == "bsgs":
        setup = M.fhe_setup(cfg, gen)
        gks = M.keygen_matmul_bsgs(setup, gen)
        run = M.build_inference_pipeline(setup, weights, gks_bsgs=gks)
    else:
        setup, ctx = M.fhe_setup_bootstrapped(cfg, gen, **BOOT)
        run = M.build_bootstrapped_pipeline(setup, ctx, weights, prescale=32.0)
    imgs = np.random.default_rng(3).uniform(0.0, 1.0, (cfg.batch, cfg.image, cfg.image))
    return cfg, setup, run, imgs, gen


@pytest.fixture(scope="module")
def pipelines():
    """``get(kind)``: the CPU pipeline of ``kind``, built once and called
    once (the cold call encodes the refresh's constants)."""
    built = {}

    def get(kind: str):
        if kind not in built:
            cfg, setup, run, imgs, gen = build(kind, torch.device("cpu"))
            run(imgs, gen)
            built[kind] = cfg, setup, run, imgs, gen
        return built[kind]
    return get


def spans(prof):
    """[(name, nearest ancestor span's name or None, device event?)] of
    every ``toyfhe.`` event of the trace."""
    out = []
    for ev in prof.events():
        if not ev.name.startswith("toyfhe."):
            continue
        up = ev.cpu_parent
        while up is not None and not up.name.startswith("toyfhe."):
            up = up.cpu_parent
        out.append((ev.name, None if up is None else up.name,
                    ev.device_type != torch.autograd.DeviceType.CPU))
    return out


def expected_tree(stages, replays: bool, server: bool = False) -> Counter:
    """Counts of (span, nearest spanned ancestor) of one request: a
    pipeline call, or the server's request (``forward``, then decrypt). The
    grid's vectors are encoded as one batch: each encode span once."""
    top = None if server else "toyfhe.run"
    want = Counter({("toyfhe.forward", top): 1, ("toyfhe.decrypt", top): 1})
    if not server:
        want.update({("toyfhe.run", None): 1, ("toyfhe.encode", "toyfhe.run"): 1,
                     ("toyfhe.encode.preprocess", "toyfhe.encode"): 1})
        for part in ENCODE:
            want[(f"toyfhe.encode.{part}", "toyfhe.encode")] = 1
    for part in DECRYPT:
        want[(f"toyfhe.decrypt.{part}", "toyfhe.decrypt")] = 1
    for st in stages:
        want[(f"toyfhe.stage.{st}", "toyfhe.forward")] = 1
        if replays:
            for part in ("inputs", "launch", "outputs"):
                want[(f"toyfhe.replay.{part}", f"toyfhe.stage.{st}")] = 1
    return want


@pytest.mark.parametrize("kind", ["bsgs", "boot"])
def test_a_request_holds_the_span_tree(pipelines, kind):
    cfg, setup, run, imgs, gen = pipelines(kind)
    stages = BSGS_STAGES if kind == "bsgs" else BOOT_STAGES
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(imgs, gen)
    got = spans(prof)
    assert not any(dev for _, _, dev in got)
    tree = Counter((n, p) for n, p, _ in got)
    assert tree == expected_tree(stages, replays=False)
    # run, encode, preprocess, forward; the batch encode's 4; 1 a stage
    # (eager on the CPU: no replay spans); decrypt and its 4
    assert len(got) == 4 + 4 + len(stages) + 5


@pytest.mark.parametrize("kind", ["bsgs", "boot"])
def test_a_request_encodes_its_grid_as_one_batch(kind):
    cfg, setup, run, imgs, gen = build(kind, torch.device("cpu"), GRID7)
    run(imgs, gen)
    metrics.reset()
    run(imgs, gen)
    got = metrics.snapshot()
    assert cfg.grid ** 2 == 49
    assert got["ckks.encode_batches"] == 1 and got["ckks.encode_vectors"] == 49


def test_the_server_request_holds_forward_and_decrypt(pipelines):
    cfg, setup, run, imgs, gen = pipelines("bsgs")
    pts = run.encode(imgs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        M._decrypt_logits(setup, run.forward(pts, gen))
    tree = Counter((n, p) for n, p, _ in spans(prof))
    assert tree == expected_tree(BSGS_STAGES, replays=False, server=True)


@pytest.mark.parametrize("kind", ["bsgs", "boot"])
def test_without_a_profiler_nothing_is_recorded(pipelines, kind, monkeypatch):
    cfg, setup, run, imgs, gen = pipelines(kind)
    assert not torch.autograd._profiler_enabled()
    assert metrics.span("toyfhe.a") is metrics.span("toyfhe.b") is metrics.NO_SPAN
    opened = []
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name: opened.append(name))
    run(imgs, gen)
    assert opened == []
    with metrics.NO_SPAN as got:
        assert got is None


def test_a_call_inside_a_compiled_body_opens_no_stage_span():
    """A compiled function called inside another's warm-up or capture
    (``graphs.trace``) runs inline, recorded once and replayed without
    Python: no ``toyfhe.stage`` span, even under a profiler."""
    f = graphs.jit(lambda x: x + 1, name="spans_inner")
    x = torch.arange(4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        f(x)
        with graphs.trace():
            f(x)
    assert [n for n, _, _ in spans(prof)] == ["toyfhe.stage.spans_inner"]


def test_a_span_is_a_host_event_of_the_profiler():
    """``span`` rests on torch's private ``_RecordFunctionFast``: its event
    is a host operator, not a ``record_function`` user annotation."""
    assert hasattr(torch._C._profiler, "_RecordFunctionFast")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.span("toyfhe.probe"):
            torch.arange(4).sum()
        with torch.profiler.record_function("toyfhe.annotation"):
            pass
    events = {ev.name: ev for ev in prof.events()}
    probe = events["toyfhe.probe"]
    assert probe.device_type == torch.autograd.DeviceType.CPU
    assert not probe.is_user_annotation and events["toyfhe.annotation"].is_user_annotation
    assert any(ev.cpu_parent is probe for ev in prof.events())


@pytest.mark.parametrize("kind", ["bsgs", "boot"])
def test_cpu_and_eager_calls_capture_nothing(pipelines, kind):
    cfg, setup, run, imgs, gen = pipelines(kind)
    run(imgs, gen)
    run.eager(imgs, gen)
    f = graphs.jit(lambda x: x + 1)
    f(torch.arange(4))
    assert run.pool.captures == [] and run.pool.graphs == []
    assert f.pool.captures == []


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_one_capture_counts_once():
    dev = _card()
    f = graphs.jit(lambda x: x * 3 + 1, name="spans_affine")
    x = torch.arange(8, device=dev)
    assert torch.equal(f(x), x * 3 + 1)
    assert len(f.pool.captures) == 1
    for i in range(10):
        assert torch.equal(f(x + i), (x + i) * 3 + 1)
    torch.cuda.synchronize()
    assert len(f.pool.captures) == 1 and f.pool.graphs[0].replays == 11


@pytest.mark.cuda
def test_cuda_request_spans_nest_and_stay_off_the_device():
    """The first request captures (a ``toyfhe.capture`` in each stage, one
    capture a stage), the second replays (the three replay spans in each
    stage, no capture); the card's timeline holds kernels and no span."""
    dev = _card()
    cfg, setup, run, imgs, gen = build("bsgs", dev)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as first:
        run(imgs, gen)
        torch.cuda.synchronize()
    assert len(run.pool.captures) == len(BSGS_STAGES)
    got = Counter((n, p) for n, p, _ in spans(first))
    assert all(got[("toyfhe.capture", f"toyfhe.stage.{st}")] == 1 for st in BSGS_STAGES)
    with profile(activities=acts) as second:
        run(imgs, gen)
        torch.cuda.synchronize()
    assert len(run.pool.captures) == len(BSGS_STAGES)
    got = spans(second)
    assert not any(dev_ for _, _, dev_ in got)
    assert Counter((n, p) for n, p, _ in got) == expected_tree(BSGS_STAGES, replays=True)
    kinds = torch.autograd.DeviceType.CUDA
    kernels = [ev.name for ev in second.events() if ev.device_type == kinds]
    assert kernels and not any(k.startswith("toyfhe.") for k in kernels)


@pytest.mark.cuda
def test_cuda_a_request_encode_equals_the_cpu():
    """The grid's residues reduced on the card equal those reduced on the
    CPU, bit for bit, in both pipelines (the encode reads no key)."""
    dev = _card()
    for kind in ("bsgs", "boot"):
        _, _, run_cpu, imgs, _ = build(kind, torch.device("cpu"), GRID7)
        _, _, run_card, _, _ = build(kind, dev, GRID7)
        want = run_cpu.encode(imgs)
        got = run_card.encode(imgs)
        assert got.device.type == "cuda" and got.dtype == torch.int64
        assert torch.equal(got.cpu(), want)
