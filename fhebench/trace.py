"""Device traces of the window's requests: ``torch.profiler`` over short
consecutive chunks, each reduced at once to a small summary (the trace
itself is dropped).

A chunk's summary holds its requests, its host-clock length (the device
synchronised at both ends), the device-busy time (the union of the kernel
intervals), the K1 kernels found by name with their device time, the K1
launches and limb transforms the program counted over the same requests
(``ops.ntt_cuda.launches`` / ``transforms``, which replays re-add), the
device time of each kernel name (prefixed by its group in ``work.GROUPS``),
and the idle gaps labelled by what the host was doing: the innermost host
event of the trace around the gap's middle.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

from . import work

REQUEST_SPAN = "fhebench.request"
NAME_CHARS = 96
SHORT_GAP_US = 20.0          # shorter idle gaps are launch spacing, not host work


def _union_us(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _gaps(intervals, lo: float, hi: float):
    """Idle stretches of [lo, hi] outside the union of ``intervals``."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def _label(host, starts, mid: float) -> str:
    """The innermost host event around ``mid`` (``host`` sorted by start,
    ``starts`` its starts): the covering event that started last. The
    request's own span means Python or numpy between torch calls."""
    i = bisect.bisect_right(starts, mid) - 1
    while i >= 0 and host[i][2] < mid:
        i -= 1
    if i < 0:
        return "outside the requests"
    name = host[i][0]
    return "host code, no torch call" if name == REQUEST_SPAN else name[:NAME_CHARS]


def summarize(events, wall_s: float, requests: int, counted: dict) -> dict:
    """Reduce one chunk's profiler events (name, device or host, start us,
    end us) to its summary. The request's span also appears on the device's
    timeline, as the annotation of its kernels: it is no device operation."""
    kernels = [(n, s, e) for n, dev, s, e in events if dev and n != REQUEST_SPAN]
    host = [(n, s, e) for n, dev, s, e in events if not dev]
    spans = [(s, e) for n, s, e in host if n == REQUEST_SPAN]
    ops = defaultdict(float)
    k1_count, k1_us = 0, 0.0
    for n, s, e in kernels:
        ops[f"{work.group_of(n)}: {n}"[:NAME_CHARS]] += (e - s) * 1e-6
        if work.is_k1(n):
            k1_count += 1
            k1_us += e - s
    idle = defaultdict(float)
    if spans:
        lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
        host.sort(key=lambda h: h[1])
        starts = [s for _, s, _ in host]
        for s, e in _gaps([(s, e) for _, s, e in kernels], lo, hi):
            label = (_label(host, starts, (s + e) / 2) if e - s >= SHORT_GAP_US
                     else f"gaps under {SHORT_GAP_US:g} us between kernels")
            idle[label] += (e - s) * 1e-6
    return {"requests": requests, "wall_s": wall_s,
            "busy_s": _union_us([(s, e) for _, s, e in kernels]) * 1e-6,
            "kernels": len(kernels), "k1_kernels": k1_count, "k1_device_s": k1_us * 1e-6,
            "k1_launches": counted["launches"], "k1_transforms": counted["transforms"],
            "ops": dict(ops), "idle": dict(idle)}


def _k1_counts() -> dict:
    from toyfhe_tpu_torch.ops import ntt_cuda
    return {"launches": sum(ntt_cuda.launches.values()),
            "transforms": sum(ntt_cuda.transforms.values())}


def profile_chunk(do_requests, device) -> dict:
    """Run ``do_requests()`` (which returns how many requests it made)
    under the profiler and return the chunk's summary."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    before = _k1_counts()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        sync()
        t0 = time.perf_counter()
        requests = do_requests()
        sync()
        wall_s = time.perf_counter() - t0
    after = _k1_counts()
    kind = torch.autograd.DeviceType.CUDA
    events = [(ev.name, ev.device_type == kind, ev.time_range.start, ev.time_range.end)
              for ev in prof.events()]
    del prof
    return summarize(events, wall_s, requests,
                     {k: after[k] - before[k] for k in before})


def breakdown(chunks) -> dict:
    """The ten kernels that took most device time and the ten host
    activities the device waited longest on, over all chunks, in seconds."""
    ops, idle = defaultdict(float), defaultdict(float)
    for c in chunks:
        for k, v in c["ops"].items():
            ops[k] += v
        for k, v in c["idle"].items():
            idle[k] += v
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}
