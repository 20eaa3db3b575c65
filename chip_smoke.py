#!/usr/bin/env python3
"""On-card smoke run of the toyfhe_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA NTT kernel from ``toyfhe_tpu_torch/csrc/ntt.cu``, holds it
bit-equal to its plain radix-2 torch twin on the card, runs the CKKS
square → relinearize → rescale step at the ``__graft_entry__`` shape (bit-equal to
the same step on the CPU) and with real keys at the encrypted-MNIST tower
width (decoded against the expected squares), times kernel, twin and step
with CUDA events, and checks that the step went through the kernel.

Phases print as they run. The line before the last is one JSON object
describing each kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failing phase raises, and the script exits non-zero; it also exits
non-zero, printing no result, when no CUDA device is available.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from fractions import Fraction

import numpy as np
import torch

REPS = 25          # timed repetitions per measurement (median reported)
WARMUP = 3
DECODE_ATOL = 2e-4


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps=REPS, warmup=WARMUP) -> float:
    """Median device time of ``fn()`` in ms, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def random_residues(primes, lead, n, gen, device):
    return torch.cat([torch.randint(0, p, tuple(lead) + (1, n), generator=gen,
                                    device=device, dtype=torch.int64)
                      for p in primes], dim=-2)


def phase_environment():
    from toyfhe_tpu_torch.ops import ntt_cuda

    log("== phase 1: environment")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"torch.version.cuda {torch.version.cuda}")
    nvcc = subprocess.run([ntt_cuda._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"nvcc: {nvcc[-1]}")
    try:
        import triton
        log(f"triton {triton.__version__}")
    except ImportError:
        log("triton: not importable")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}  (torch: {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()})")
    return smi


def phase_build():
    from toyfhe_tpu_torch.ops import ntt_cuda

    log("== phase 2: build")
    t0 = time.perf_counter()
    ntt_cuda._load()
    log(f"built and loaded {ntt_cuda.LIBRARY.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {ntt_cuda.build_info.get('seconds', 0.0):.2f} s)")
    for line in ntt_cuda.build_info.get("log", "").strip().splitlines():
        log(f"  {line}")


def phase_kernel_vs_plain(dev):
    from toyfhe_tpu_torch.ops import ntt as nttmod
    from toyfhe_tpu_torch.utils import numtheory as nt

    log("== phase 3: kernel against plain radix-2 on the card")
    gen = torch.Generator(device=dev).manual_seed(3)
    err = {"fwd": 0, "inv": 0}
    ncase = 0
    for n in (256, 4096, 8192, 16384):
        for tower in ((30, 29, 29, 28), (28,) * 7, (28,) * 8):
            tables = nttmod.NttTables(n, nt.ntt_prime_chain(n, tower))
            for lead in ((), (4,), (4, 7), (16,)):
                x = random_residues(tables.primes, lead, n, gen, dev)
                kf, pf = nttmod.ntt(tables, x), nttmod.ntt_plain(tables, x)
                ki, pi = nttmod.intt(tables, x), nttmod.intt_plain(tables, x)
                back = nttmod.intt(tables, kf)
                torch.cuda.synchronize()
                err["fwd"] = max(err["fwd"], int((kf - pf).abs().max()))
                err["inv"] = max(err["inv"], int((ki - pi).abs().max()))
                ok = torch.equal(kf, pf) and torch.equal(ki, pi) and torch.equal(back, x)
                if not ok:
                    raise AssertionError(f"kernel != plain at N={n} tower={tower} lead={lead}")
                ncase += 1
            log(f"N={n:5d} tower={tower}: 4 leads bit-equal, round trip exact")
    log(f"{ncase} cases: kernel == plain, intt(ntt(x)) == x")
    return err


def _entry_operands(n, tower, batch, seed):
    """Synthetic operands as ``__graft_entry__.entry()`` makes them."""
    from toyfhe_tpu_torch import make_rns_ring

    ring = make_rns_ring(n, tower)
    L = len(tower)
    rng = np.random.default_rng(seed)
    lim = min(ring.primes)
    masks = rng.integers(0, lim, (L, L, n))
    maskeds = rng.integers(0, lim, (L, L, n))
    cts = rng.integers(0, lim, (batch, 2, L, n))
    return ring, masks, maskeds, cts


def phase_entry_step(dev):
    from toyfhe_tpu_torch.parallel import ops as pops
    from toyfhe_tpu_torch.utils import interop as I

    log("== phase 4: step at the __graft_entry__ shape (N=4096, L=4, batch 4)")
    ring, masks, maskeds, cts = _entry_operands(4096, (30, 29, 29, 28), 4, 0)
    outs = {}
    for d in (dev, "cpu"):
        step = pops.make_single_chip_step(ring.tables, I.tensor(masks, d),
                                          I.tensor(maskeds, d))
        outs[d] = step(I.tensor(cts, d)).cpu()
    if not torch.equal(outs[dev], outs["cpu"]):
        raise AssertionError("CUDA step differs from the CPU step")
    if outs[dev][:, :, -1].any():
        raise AssertionError("dropped limb not zeroed")
    log(f"step on {dev} == step on cpu, shape {tuple(outs[dev].shape)}, dropped limb zero")
    step = pops.make_single_chip_step(ring.tables, I.tensor(masks, dev),
                                      I.tensor(maskeds, dev))
    return step, I.tensor(cts, dev)


def phase_real_keys(dev):
    import toyfhe_tpu_torch as T
    from toyfhe_tpu_torch.ops import ntt_cuda
    from toyfhe_tpu_torch.parallel import ops as pops

    n, tower, B = 1 << 13, (28,) * 7, 4
    log(f"== phase 5: real keys at the MNIST tower width (N={n}, {tower}, batch {B})")
    t0 = time.perf_counter()
    ring = T.make_rns_ring(n, tower)
    params = T.CKKSParams(ring, 0, 3.2)
    gen = torch.Generator(device=dev).manual_seed(0)
    kp = T.keygen(params, gen)
    ek = T.keygen_eval_mult(gen, kp.priv)
    masks = torch.stack([T.ringops.ensure_dual(ring, kc.mask).dual for kc in ek.key.key])
    maskeds = torch.stack([T.ringops.ensure_dual(ring, kc.masked).dual for kc in ek.key.key])
    vals = np.linspace(0.1, 1.0, n // 2)
    scale = Fraction(2) ** 45
    cts = []
    for i in range(B):
        c = T.encrypt(kp, T.make_plaintext(ring, vals * (i + 1), scale), gen)
        cts.append(torch.stack([T.ringops.ensure_dual(ring, x).dual for x in c.cs]))
    batch = torch.stack(cts)
    step = pops.make_single_chip_step(ring.tables, masks, maskeds)
    torch.cuda.synchronize()
    log(f"keygen + eval key + {B} encryptions: {time.perf_counter() - t0:.2f} s (host clock)")

    for k in ntt_cuda.launches:
        ntt_cuda.launches[k] = 0
    out = step(batch)
    torch.cuda.synchronize()
    launches = dict(ntt_cuda.launches)
    log(f"kernel launches over one step: {launches}")

    sub = ring.drop_last()
    new_scale = scale * scale / ring.primes[-1]
    worst = 0.0
    for i in range(B):
        cs = tuple(T.RingElt(dual=out[i, j, :ring.nlimbs - 1].contiguous()) for j in range(2))
        got = T.decrypt(kp, T.CipherText(params, cs, sub, enc=T.CKKSTag(new_scale))).real
        if got.shape != (n // 2,) or not np.all(np.isfinite(got)):
            raise AssertionError(f"ciphertext {i}: bad decode shape or non-finite values")
        worst = max(worst, float(np.max(np.abs(got - (vals * (i + 1)) ** 2))))
    log(f"decoded (vals*(i+1))^2: max abs error {worst:.3e} (limit {DECODE_ATOL})")
    if not worst < DECODE_ATOL:
        raise AssertionError(f"decode error {worst} >= {DECODE_ATOL}")
    return step, batch, launches


def phase_timing(dev, smi, entry, mnist):
    from toyfhe_tpu_torch.ops import ntt as nttmod
    from toyfhe_tpu_torch.utils import numtheory as nt

    log(f"== phase 6: timing, CUDA events, median of {REPS} after {WARMUP} warm-up [{smi}]")
    gen = torch.Generator(device=dev).manual_seed(6)
    times = {}
    for label, n, tower, lead in (("B*L=28, N=2^13", 1 << 13, (28,) * 7, (4,)),
                                  ("16x8, N=2^14", 1 << 14, (28,) * 8, (16,))):
        tables = nttmod.NttTables(n, nt.ntt_prime_chain(n, tower))
        x = random_residues(tables.primes, lead, n, gen, dev)
        row = {
            "fwd": cuda_ms(lambda: nttmod.ntt(tables, x)),
            "fwd_plain": cuda_ms(lambda: nttmod.ntt_plain(tables, x)),
            "inv": cuda_ms(lambda: nttmod.intt(tables, x)),
            "inv_plain": cuda_ms(lambda: nttmod.intt_plain(tables, x)),
        }
        times[label] = row
        polys = x.numel() // n
        log(f"NTT {label}: kernel fwd {row['fwd']:.4f} ms, inv {row['inv']:.4f} ms; "
            f"plain fwd {row['fwd_plain']:.4f} ms, inv {row['inv_plain']:.4f} ms; "
            f"kernel {polys / row['fwd'] * 1e3:.0f} limb-NTT/s fwd [{smi}]")
    for label, (step, c) in (("entry N=4096 L=4 B=4", entry),
                             ("MNIST tower N=8192 L=7 B=4", mnist)):
        ms = cuda_ms(lambda: step(c))
        B = c.shape[0]
        log(f"step {label}: {ms:.4f} ms/step, {1e3 / ms:.1f} steps/s, "
            f"{B * 1e3 / ms:.1f} ciphertexts/s [{smi}]")
        times[label] = ms
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_environment()
    phase_build()
    err = phase_kernel_vs_plain(dev)
    entry = phase_entry_step(dev)
    step, batch, launches = phase_real_keys(dev)
    times = phase_timing(dev, smi, entry, (step, batch))

    log("== phase 7: kernel use over one step")
    if launches != {"fwd": 2, "inv": 2}:
        raise AssertionError(f"expected 2 forward and 2 inverse launches, got {launches}")
    log("2 forward and 2 inverse kernel launches per step, as the step body makes them")

    shape = "B*L=28, N=2^13"
    kernels = [
        {"name": f"k1_ntt_{k}", "route": "cuda", "source": "toyfhe_tpu_torch/csrc/ntt.cu",
         "replaces": f"toyfhe_tpu/ops/ntt_mxu_pallas.py:{line}",
         "launches": launches[k], "max_abs_err": err[k],
         "ms": times[shape][k], "plain_ms": times[shape][f"{k}_plain"]}
        for k, line in (("fwd", 242), ("inv", 255))]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
