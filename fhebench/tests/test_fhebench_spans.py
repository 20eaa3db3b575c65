"""The program's spans in the trace's summary, and the readers of the idle
shares by layer, on synthetic events.

The program's spans are host events alone (function-scope record
functions: ``tests/test_torch_spans.py`` holds on the card that none
reaches the device's timeline), so with them the summary reads the same
device time, kernels, operations and K1 fields, and only the idle gaps'
names change: a gap the host spent in the program's own code carries the
innermost span's name, a gap inside a torch call the call's name.
"""

import pytest

from fhebench import harness, spans, trace

K1 = "void ntt_cluster_kernel<4>(long*, long const*)"
EW = "elementwise_kernel"


def chunk_events(with_spans: bool):
    """Two requests on 0–200 us. A is a pipeline call: its encode's FFT
    (0–30 idle), a replay whose launch the card waits on (34–64 idle under
    cudaGraphLaunch), the C++ CRT of its decrypt (76–97 idle). B is the
    server's: a replay's input copies (99–140 idle), then decrypt, its
    download and its CRT (165–200 idle)."""
    req = trace.REQUEST_SPAN
    events = [(req, False, 0.0, 100.0), (req, True, 0.0, 100.0),
              (req, False, 100.0, 200.0), (req, True, 100.0, 200.0),
              ("cudaGraphLaunch", False, 36.0, 62.0), ("cudaGraphLaunch", False, 132.0, 140.0),
              ("aten::copy_", False, 161.0, 165.0),
              ("Memcpy HtoD (Pageable -> Device)", True, 30.0, 34.0), (EW, True, 64.0, 70.0),
              (K1, True, 70.0, 76.0), (EW, True, 97.0, 99.0), (K1, True, 140.0, 150.0),
              (EW, True, 152.0, 158.0), ("Memcpy DtoH (Device -> Pageable)", True, 163.0, 165.0)]
    program = [("toyfhe.run", 1, 99), ("toyfhe.encode", 2, 33), ("toyfhe.encode.fft", 5, 29),
               ("toyfhe.forward", 34, 80), ("toyfhe.stage.conv", 34, 72),
               ("toyfhe.replay.launch", 35, 63), ("toyfhe.decrypt", 81, 99.5),
               ("toyfhe.decrypt.crt", 84, 92),
               ("toyfhe.forward", 101, 150), ("toyfhe.stage.dense1", 102, 149),
               ("toyfhe.replay.inputs", 103, 130), ("toyfhe.replay.launch", 131, 141),
               ("toyfhe.decrypt", 151, 199), ("toyfhe.decrypt.raw", 152, 160),
               ("toyfhe.decrypt.download", 160, 166), ("toyfhe.decrypt.crt", 166, 190),
               ("toyfhe.decrypt.fft", 190, 199)]
    if with_spans:
        events += [(n, False, float(s), float(e)) for n, s, e in program]
    return events


COUNTED = {"launches": 2, "transforms": 56}
US = 1e-6


def summary(with_spans: bool) -> dict:
    return trace.summarize(chunk_events(with_spans), 200 * US, 2, COUNTED)


def window(*chunks):
    win = harness.Window({"model": {"image": 28, "kernel": 7, "stride": 3, "ring_logn": 13}},
                         {"encode_in_request": True}, 1.0, 64)
    win.chunks = list(chunks)
    return win


def test_program_spans_leave_the_device_readings_as_they_were():
    bare, spanned = summary(False), summary(True)
    for key in ("requests", "wall_s", "busy_s", "kernels", "ops", "k1_kernels", "k1_device_s",
                "k1_launches", "k1_transforms"):
        assert spanned[key] == bare[key], key
    assert bare["busy_s"] == pytest.approx(36 * US) and bare["kernels"] == 7
    assert bare["k1_kernels"] == 2 and bare["k1_device_s"] == pytest.approx(16 * US)
    assert sum(spanned["idle"].values()) == pytest.approx(sum(bare["idle"].values()))
    assert sum(bare["idle"].values()) == pytest.approx(164 * US)


def test_idle_gaps_take_the_innermost_program_span():
    bare, spanned = summary(False)["idle"], summary(True)["idle"]
    assert bare["host code, no torch call"] == pytest.approx(127 * US)
    assert "host code, no torch call" not in spanned
    assert spanned["toyfhe.encode.fft"] == pytest.approx(30 * US)
    assert spanned["toyfhe.replay.inputs"] == pytest.approx(41 * US)
    assert spanned["toyfhe.decrypt.crt"] == pytest.approx((21 + 35) * US)
    # inside a torch call the gap keeps the call's name, spans or none
    assert spanned["cudaGraphLaunch"] == bare["cudaGraphLaunch"] == pytest.approx(30 * US)
    short = f"gaps under {trace.SHORT_GAP_US:g} us between kernels"
    assert spanned[short] == bare[short] == pytest.approx(7 * US)


@pytest.mark.parametrize("name,want", [("encode_idle_share", 15.0),
                                       ("stages_idle_share", 35.5),
                                       ("decrypt_idle_share", 28.0)])
def test_layer_idle_shares(name, want):
    reader = harness.load_module("metrics", name)
    assert reader.read(window(summary(True))) == pytest.approx(want)
    assert reader.read(window(summary(True), summary(True))) == pytest.approx(want)
    # a program without spans reads nothing, and so does an empty window
    assert reader.read(window(summary(False))) is None
    assert reader.read(window()) is None


def test_the_shares_and_the_unowned_gaps_make_idle_share():
    win = window(summary(True))
    shares = sum(harness.load_module("metrics", n).read(win)
                 for n in ("encode_idle_share", "stages_idle_share", "decrypt_idle_share"))
    unowned = sum(v for k, v in win.chunks[0]["idle"].items()
                  if not spans.under(k, spans.ENCODE + spans.STAGES + spans.DECRYPT))
    idle = harness.load_module("metrics", "idle_share").read(win)
    assert idle == pytest.approx(82.0)
    assert shares + 100 * unowned / (200 * US) == pytest.approx(idle)


def test_under_names_a_span_and_the_spans_below_it():
    assert spans.under("toyfhe.encode", spans.ENCODE)
    assert spans.under("toyfhe.encode.upload", spans.ENCODE)
    assert not spans.under("toyfhe.encoder", spans.ENCODE)
    assert spans.under("toyfhe.stage.modraise_c2s", spans.STAGES)
    assert spans.under("toyfhe.capture", spans.STAGES)
    assert spans.under("cudaGraphLaunch", spans.STAGES)
    assert not spans.under("cudaMemcpyAsync", spans.ENCODE + spans.STAGES + spans.DECRYPT)
    assert not spans.under("toyfhe.run", spans.ENCODE + spans.STAGES + spans.DECRYPT)
