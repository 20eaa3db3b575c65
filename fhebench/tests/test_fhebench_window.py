"""The window's arithmetic and the readers of the trace, on synthetic data."""

import math

import numpy as np
import pytest

from fhebench import harness, trace, work

ROOT = harness.ROOT


MODEL = {"image": 28, "kernel": 7, "stride": 3, "ring_logn": 13}     # 64 images a request


def window(config=None, encoded=False, **kw):
    mix = {"encode_in_request": not encoded}
    win = harness.Window(config or {"model": MODEL}, mix, 12.5)
    for k, v in kw.items():
        setattr(win, k, v)
    return win


def metric(name):
    return harness.load_module("metrics", name)


def test_rate_and_tail_cover_every_request():
    lat = [0.1] * 89 + [0.5] * 11          # 100 requests, 11 slow
    win = window(latencies_s=lat, seconds=15.0)
    assert metric("images_per_s").read(win) == pytest.approx(64 * 100 / 15.0)
    # the 90th percentile of all requests sits among the slow ones
    assert metric("batch_p90_ms").read(win) == pytest.approx(
        1e3 * np.percentile(lat, 90))
    assert metric("batch_p90_ms").read(win) > 100.0
    assert metric("setup_s").read(win) == 12.5


def test_stage_readers_average_per_request():
    stages = [{"encode": 160.0, "encrypt": 1.0, "dense1": 4.0, "decrypt": 5.0},
              {"encode": 170.0, "encrypt": 1.0, "dense1": 6.0, "decrypt": 7.0}]
    win = window(stages=stages)
    assert metric("encode_ms").read(win) == pytest.approx(165.0)
    assert metric("stages_ms").read(win) == pytest.approx(6.0)
    assert metric("decrypt_ms").read(win) == pytest.approx(6.0)
    assert metric("refresh_ms").read(win) is None
    boot = window(stages=[{"encode": 1.0, "modraise_c2s": 90.0, "evalmod": 30.0, "s2c": 20.0,
                           "dense2": 25.0, "decrypt": 9.0}])
    assert metric("refresh_ms").read(boot) == pytest.approx(140.0)
    assert metric("stages_ms").read(boot) == pytest.approx(165.0)
    server = window(stages=[{"forward": 8.0, "decrypt": 5.0}], encoded=True)
    assert metric("stages_ms").read(server) == pytest.approx(8.0)
    assert metric("encode_ms").read(server) is None


K1 = "void ntt_cluster_kernel<4>(long*, long const*)"


def chunk_events():
    """Two requests: kernels 0–10, 5–12 (overlap), K1 20–30, idle 30–80,
    K1 80–90, idle to 120; host spans around them."""
    return [(trace.REQUEST_SPAN, False, 0.0, 45.0), (trace.REQUEST_SPAN, False, 45.0, 120.0),
            (trace.REQUEST_SPAN, True, 0.0, 45.0), (trace.REQUEST_SPAN, True, 45.0, 120.0),
            ("aten::stack", False, 50.0, 85.0),
            ("elementwise_kernel", True, 0.0, 10.0), ("elementwise_kernel", True, 5.0, 12.0),
            (K1, True, 20.0, 30.0), (K1, True, 80.0, 90.0)]


def test_summary_busy_k1_and_idle_gaps():
    s = trace.summarize(chunk_events(), 120e-6, 2, {"launches": 2, "transforms": 56})
    assert s["busy_s"] == pytest.approx(32e-6)          # union: 12 + 10 + 10
    assert s["k1_kernels"] == 2 and s["k1_device_s"] == pytest.approx(20e-6)
    assert s["kernels"] == 4
    # gaps: 12–20 (short), 30–80 (under aten::stack at 55), 90–120 (request span)
    assert s["idle"]["aten::stack"] == pytest.approx(50e-6)
    assert s["idle"]["host code, no torch call"] == pytest.approx(30e-6)
    assert sum(s["idle"].values()) == pytest.approx(88e-6)
    b = trace.breakdown([s, s])
    assert b["device_ops"][0] == ["K1 transforms: " + K1, pytest.approx(40e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_k1_roofline_idle_share_and_mfu_readers():
    s = trace.summarize(chunk_events(), 120e-6, 2, {"launches": 2, "transforms": 56})
    win = window(chunks=[s])
    n = 1 << 13
    floor = 56 * work.ntt_bytes(n, 1) / work.H100_HBM_BYTES_PER_S
    assert metric("k1_roofline").read(win) == pytest.approx(100 * floor / 20e-6)
    assert metric("idle_share").read(win) == pytest.approx(100 * (1 - 32 / 120))
    cfg = harness.load_json(ROOT / "fhebench/configs/mnist-bsgs.json")
    w = window(config=cfg, chunks=[s])
    floor_s = work.floor_bytes(cfg, False) / work.H100_HBM_BYTES_PER_S
    assert metric("mfu").read(w) == pytest.approx(100 * floor_s * 2 / 120e-6)
    empty = window()
    for name in ("k1_roofline", "idle_share", "mfu"):
        assert metric(name).read(empty) is None


def test_judge_reads_the_worst_request():
    class Pool:
        pool = []

        def batch(self, i):
            return np.full((2, 8, 8), 0.1 * (i + 1))

    class Ref:
        @staticmethod
        def forward(model, params, imgs, bits=None):
            out = np.stack([imgs[:, 0, 0], -2 * imgs[:, 0, 0]], 1)     # [B, 2]
            return out if bits is None else out * (1 + 2.0 ** -bits)

    want = [Ref.forward(None, None, Pool().batch(i)).T for i in range(3)]
    unit = [2.0 ** -11 * np.sqrt(np.mean(w ** 2)) for w in want]   # rms(F − R)
    limits = {"logit_f16": 3.0, "image_f16": 3.0}
    answers = [(0, want[0]), (1, want[1] + 1e-4), (2, want[2])]
    read, failed = harness.judge(answers, Pool(), Ref, {}, {}, limits)
    assert failed == 0
    assert read["logit_f16"] == pytest.approx(1e-4 / unit[1])
    assert read["image_f16"] == pytest.approx(1e-4 / unit[1])
    assert read["logit_gap_rel"] == pytest.approx(1e-4 / 0.4)
    assert read["logit_rms_rel"] == pytest.approx(1e-4 / np.sqrt(np.mean(want[1] ** 2)))
    answers[2] = (2, want[2] * (1 + 2.0 ** -9))     # one request off by 4 roundings
    read, failed = harness.judge(answers, Pool(), Ref, {}, {}, limits)
    assert failed == 1 and read["logit_f16"] == pytest.approx(4.0)
    one = want[1].copy()
    one[:, 0] *= 1 + 4 * 2.0 ** -11                  # one image of two off by 4
    read, failed = harness.judge([(0, want[0]), (1, one)], Pool(), Ref, {}, {}, limits)
    assert read["logit_f16"] == pytest.approx(4 / np.sqrt(2))       # diluted: under 3
    assert failed == 1 and read["image_f16"] == pytest.approx(4.0)
    answers[0] = (0, want[0] * math.nan)
    read, failed = harness.judge(answers, Pool(), Ref, {}, {}, limits)
    assert failed == 2 and read["logit_f16"] == math.inf
