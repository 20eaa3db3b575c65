"""The device's idle time put down to the program's spans.

The port marks each layer of a request with ``toyfhe.`` spans while a
profiler runs (``toyfhe_tpu_torch/utils/metrics.py::span``): host events
on the profiler's timeline, never on the device's. ``trace.summarize``
names every idle gap of a profiled chunk by the innermost host event
around its middle, so a gap the host spent in the program's own code
between torch calls (numpy, the C++ CRT, a graph's Python) carries the name
of the span it lies in; a gap inside a torch call carries the call's name.

A layer's idle share is the idle seconds carrying one of its spans' names,
over the profiled requests' host-clock span, in ``idle_share``'s unit: the
layers' shares and the gaps they do not own add up to ``idle_share``. A
gap goes whole to the event at its middle, so a layer's share is exact
where its gaps lie inside its spans, and the split among the spans below
it (``toyfhe.encode.slots`` against ``toyfhe.encode.fft``) follows where
each gap's middle falls.

A gap inside a torch call keeps the call's name, and so belongs to no span
by name. ``cudaGraphLaunch`` is the one such call the stages' layer owns:
the program launches a CUDA graph only in a compiled stage's replay
(``toyfhe.replay.launch``), and the device waits there on the stages' own
work.
"""

PREFIX = "toyfhe."
ENCODE = ("toyfhe.encode",)
STAGES = ("toyfhe.forward", "toyfhe.stage", "toyfhe.replay", "toyfhe.capture",
          "cudaGraphLaunch")
DECRYPT = ("toyfhe.decrypt",)


def under(label: str, spans) -> bool:
    """True where ``label`` is one of ``spans`` or a span below one
    (``toyfhe.encode.fft`` is below ``toyfhe.encode``)."""
    return any(label == s or label.startswith(s + ".") for s in spans)


def idle_share(win, spans):
    """Percent of the profiled requests' host-clock span that the device
    idled with the host in ``spans``; None where no idle gap of the window
    carries a program span (a program without spans)."""
    wall = sum(c["wall_s"] for c in win.chunks)
    gaps = [(k, v) for c in win.chunks for k, v in c["idle"].items()]
    if wall <= 0 or not any(k.startswith(PREFIX) for k, _ in gaps):
        return None
    return 100.0 * sum(v for k, v in gaps if under(k, spans)) / wall
