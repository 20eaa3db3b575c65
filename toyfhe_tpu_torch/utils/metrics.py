"""Op counters, timers, profiler traces and roofline helpers.

Port of ``toyfhe_tpu/utils/metrics.py``:

  * **op counters** — key switches, rotations, rescales, tensor products
    and limb transforms (``ntt_limb_transform``, counted where the
    reference counts them) increment a process-wide counter: a per-workload
    op census without tracing. The reference counts while ``jit`` traces,
    so a compiled function counts once however often it runs; the port
    counts every call, eager or replayed (``utils.graphs`` adds a capture's
    counts on each replay);
  * **timers** — :func:`timed` adds wall time under a name, synchronising
    the CUDA device (when one is in use) before it reads the clock at either
    end, so that the time covers the device work the block launched;
  * **profiler traces** — :func:`profile_trace` records a ``torch.profiler``
    trace of CPU and CUDA activity to a Chrome trace file;
  * **roofline helpers** — analytic byte counts of the hot kernels, and the
    least time those bytes take at a memory rate (by default an NVIDIA
    H100's 3.35 TB/s, the bound ``chip_smoke.py`` uses).
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Dict, Iterator

import torch

H100_HBM_GBPS = 3350.0      # NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3

counters: Dict[str, int] = collections.defaultdict(int)
timers: Dict[str, float] = collections.defaultdict(float)


def count(name: str, n: int = 1) -> None:
    counters[name] += n


def reset() -> None:
    counters.clear()
    timers.clear()


def snapshot() -> Dict[str, int]:
    return dict(counters)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(name: str) -> Iterator[None]:
    _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        timers[name] += time.perf_counter() - t0


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[None]:
    """Record a ``torch.profiler`` trace of CPU and CUDA activity into
    ``logdir/trace.json`` (Chrome / Perfetto format)."""
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
