"""Op counters, spans, profiler traces and roofline helpers.

Port of ``toyfhe_tpu/utils/metrics.py``:

  * **op counters** — key switches, rotations, rescales, tensor products
    and limb transforms (``ntt_limb_transform``, counted where the
    reference counts them) increment a process-wide counter: a per-workload
    op census without tracing. The reference counts while ``jit`` traces,
    so a compiled function counts once however often it runs; the port
    counts every call, eager or replayed (``utils.graphs`` adds a capture's
    counts on each replay);
  * **spans** — :func:`span` marks a stretch of host work with a ``toyfhe.``
    name while a ``torch.profiler`` runs, on the timeline the profiler
    gives the device's kernels, and costs one flag check otherwise;
  * **profiler traces** — :func:`profile_trace` records a ``torch.profiler``
    trace of CPU and CUDA activity, the spans among it, to a Chrome trace
    file;
  * **roofline helpers** — analytic byte counts of the hot kernels, and the
    least time those bytes take at a memory rate (by default an NVIDIA
    H100's 3.35 TB/s, the bound ``chip_smoke.py`` uses).
"""

from __future__ import annotations

import collections
import contextlib
import os
from typing import Dict, Iterator

import torch

H100_HBM_GBPS = 3350.0      # NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3

counters: Dict[str, int] = collections.defaultdict(int)


def count(name: str, n: int = 1) -> None:
    counters[name] += n


def reset() -> None:
    counters.clear()


def snapshot() -> Dict[str, int]:
    return dict(counters)


class _NoSpan:
    """What :func:`span` returns while no profiler runs: one shared no-op
    (cheaper to enter than ``contextlib.nullcontext``)."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, typ, value, tb) -> None:
        return None


NO_SPAN = _NoSpan()


def span(name: str):
    """A context that marks the block as ``name`` (``toyfhe.<layer>...``)
    in the trace of a running ``torch.profiler``: a host event on the
    profiler's timeline, nested by the host thread's call stack. Without a
    profiler it is :data:`NO_SPAN`.

    The event is a function-scope record function, not a
    ``record_function`` user annotation: a user annotation is also drawn
    on the device's timeline, over the kernels it launched, where a reader
    of device time would count it as work. The class is private to torch:
    this was verified on torch 2.13 (CPU) and 2.11 (CUDA 12.8, H100), and
    ``tests/test_torch_spans.py`` fails if it goes or its event stops being
    a host event."""
    if not torch.autograd._profiler_enabled():
        return NO_SPAN
    return torch._C._profiler._RecordFunctionFast(name)


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[None]:
    """Record a ``torch.profiler`` trace of CPU and CUDA activity into
    ``logdir/trace.json`` (Chrome / Perfetto format). Wrapped around
    requests, the trace holds the program's ``toyfhe.`` spans and the
    kernels on one timeline: each stretch where the device idles lies
    under the span of the host work it waited on."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# ---------------------------------------------------------------------------
# rooflines (per device)
# ---------------------------------------------------------------------------

def ntt_bytes(n: int, nlimbs: int, batch: int = 1) -> int:
    """Least device-memory traffic of a batched limb transform: read and
    write each 32-bit residue once."""
    return 2 * batch * nlimbs * n * 4


def keyswitch_bytes(n: int, nlimbs: int, ndigits: int | None = None) -> int:
    """Least device-memory traffic of one key switch: read the ciphertext
    component and the key (2·ndig·L rows), write two components; the digit
    tensors stay on chip (the fused kernels' target)."""
    nd = ndigits if ndigits is not None else nlimbs
    rows = 1 + 2 * nd * nlimbs + 2 * nlimbs
    return rows * n * 4


def seconds_at_roofline(nbytes: int, hbm_gbps: float = H100_HBM_GBPS) -> float:
    """Seconds to move ``nbytes`` at ``hbm_gbps`` GB/s (default: an NVIDIA
    H100's 3.35 TB/s)."""
    return nbytes / (hbm_gbps * 1e9)
