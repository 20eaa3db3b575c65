"""Kernel-level A/B of the transform and product kernels.

    python3 -m toyfhe_tpu_torch.tools.bench_kernels [--n 16384] [--limbs 8] [--rows 16]

Port of the reference's ``tools/bench_kernels.py``: on one batch of ``rows``
polynomials over ``limbs`` 28-bit primes it compares

  * the transform K1 (``csrc/ntt.cu``),
  * the four-step digit transform K2 (``csrc/ntt_mxu.cu``, int8 tensor
    cores) with the 7-term and with the paired recombination,
  * the unfused product ``intt(mul_mod(ntt(a), ntt(b)))`` through K1,
  * the fused product K4 (``csrc/polymul.cu``),

and prints ms per batch, limb transforms per second and the ratios. Each row
is first held bit-equal to its plain torch twin on the same tensors, K2 to
K1 and K4 to the unfused product.

Runs on the CUDA device unless ``--device cpu`` is given; there every entry
point takes its plain twin and the times are host-clock times of the CPU,
not device times. On the card ``ms`` is the median of ``--reps`` CUDA-event
measurements of one call after 3 warm-up calls, so it holds the wrapper's
host time before the launch too; ``device_ms`` is the call's share of a
captured CUDA graph of 50 calls replayed, the device time alone. (The
reference tool's chained-slope timing works around a remote TPU's dispatch
noise and has no counterpart here.)
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

WARMUP = 3


def time_ms(fn, device: torch.device, reps: int, warmup: int = WARMUP) -> float:
    """Median time of ``fn()`` in ms: CUDA events on the card, the host
    clock on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def graph_ms(fn, count: int = 50, replays: int = 5) -> float:
    """Device time of one ``fn()`` in ms: ``count`` calls captured into one
    CUDA graph on the current device, the graph replayed ``replays`` times
    between two events, the median divided by ``count``. No host time of the
    calls is in it, only the device's gap between two kernels."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(count):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / count)
    return float(np.median(times))


def run(n: int = 1 << 14, limbs: int = 8, rows: int = 16, device="cuda",
        reps: int = 25) -> dict:
    """Check and time the five rows on ``device``. Returns ``{"n", "limbs",
    "rows", "device", "paired_ok", "rows_ms": {name: {"ms", "device_ms",
    "plain_ms", "transforms_per_s"}}, "ratios": {...}}``; raises if a row differs from
    its plain twin."""
    from ..ops import modmath, ntt as nttmod, ntt_mxu as mxu
    from ..ops import ntt_mxu_pallas as mxp, ntt_pallas as npal
    from ..utils import numtheory as nt

    device = torch.device(device)
    t = nttmod.NttTables(n, nt.ntt_prime_chain(n, tuple([28] * limbs)))
    mt = mxu.MxuNttTables(t)
    pt = npal.PallasNttTables(t)
    rng = np.random.default_rng(0)
    xt = torch.as_tensor(rng.integers(0, 2 ** 27, (rows, limbs, n)), device=device)
    xl = xt.transpose(0, 1).contiguous()                       # [L, R, N]
    xr = xl.reshape(limbs, rows, mxp.N1, n // mxp.N1)
    psis = mxp.psi_table(mt, device)

    def unfused(fwd, inv):
        return lambda: inv(t, modmath.mul_mod(fwd(t, xt), fwd(t, xt), t.mp))

    # name -> (entry point, plain twin, limb transforms per call)
    cases = {
        "k1": (lambda: nttmod.ntt(t, xt), lambda: nttmod.ntt_plain(t, xt), 1),
        "k2_7grp": (lambda: mxp.ntt_mxu_pallas(mt, xr, psis, False),
                    lambda: mxp.ntt_mxu_pallas_plain(mt, xr, psis, False), 1),
        "k2_paired": (lambda: mxp.ntt_mxu_pallas(mt, xr, psis, True),
                      lambda: mxp.ntt_mxu_pallas_plain(mt, xr, psis, True), 1),
        "polymul_unfused": (unfused(nttmod.ntt, nttmod.intt),
                            unfused(nttmod.ntt_plain, nttmod.intt_plain), 3),
        "polymul_k4": (lambda: npal.polymul_pallas_raw(pt, xl, xl),
                       lambda: npal.polymul_plain(pt, xl, xl), 3),
    }
    if not mt.paired_ok:
        raise ValueError("the paired recombination is not valid for these primes")

    outs = {}
    for name, (fn, plain, _) in cases.items():
        outs[name] = fn()
        if not torch.equal(outs[name], plain()):
            raise AssertionError(f"{name} differs from its plain twin")
    nat = lambda c: c.transpose(-1, -2).reshape(limbs, rows, n).transpose(0, 1)
    if not (torch.equal(nat(outs["k2_7grp"]), outs["k1"])
            and torch.equal(outs["k2_paired"], outs["k2_7grp"])):
        raise AssertionError("the four-step transform differs from K1")
    if not torch.equal(outs["polymul_k4"].transpose(0, 1), outs["polymul_unfused"]):
        raise AssertionError("the fused product differs from the unfused product")
    del outs

    polys = rows * limbs
    result = {}
    for name, (fn, plain, tf) in cases.items():
        ms = time_ms(fn, device, reps)
        result[name] = {"ms": ms, "plain_ms": time_ms(plain, device, reps),
                        "device_ms": graph_ms(fn) if device.type == "cuda" else None,
                        "transforms_per_s": tf * polys / ms * 1e3}
    ms = lambda k: result[k]["ms"]
    ratios = {
        "k2_7grp_vs_k1": ms("k1") / ms("k2_7grp"),
        "k2_paired_vs_k1": ms("k1") / ms("k2_paired"),
        "k2_paired_vs_7grp": ms("k2_7grp") / ms("k2_paired"),
        "polymul_k4_vs_unfused": ms("polymul_unfused") / ms("polymul_k4"),
    }
    return {"n": n, "limbs": limbs, "rows": rows, "device": str(device),
            "paired_ok": bool(mt.paired_ok), "rows_ms": result, "ratios": ratios}


def report(res: dict) -> list:
    """The tool's five lines for a :func:`run` result."""
    r, q = res["rows_ms"], res["ratios"]
    dev_ms = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    line = lambda label, k, tail="": (
        f"{label:<17}: {r[k]['ms']:8.3f} ms/batch  {r[k]['transforms_per_s']:10.0f} tf/s  "
        f"(device {dev_ms(r[k]['device_ms'])}, plain {r[k]['plain_ms']:.3f} ms){tail}")
    return [
        line("K1 cluster", "k1"),
        line("four-step K2 7grp", "k2_7grp", f"  x{q['k2_7grp_vs_k1']:.2f} vs K1"),
        line("four-step K2 pair", "k2_paired", f"  x{q['k2_paired_vs_k1']:.2f} vs K1, "
                                               f"x{q['k2_paired_vs_7grp']:.2f} vs 7grp"),
        line("polymul unfused", "polymul_unfused"),
        line("polymul K4", "polymul_k4", f"  x{q['polymul_k4_vs_unfused']:.2f} vs unfused"),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 14)
    ap.add_argument("--limbs", type=int, default=8)
    ap.add_argument("--rows", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_kernels: no CUDA device available (give --device cpu "
                         "to run the plain twins)")
    res = run(args.n, args.limbs, args.rows, device, args.reps)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu (plain twins, host clock)")
    print(f"device={where} N={res['n']} L={res['limbs']} R={res['rows']} "
          f"paired_ok={res['paired_ok']}", flush=True)
    for ln in report(res):
        print(ln, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
