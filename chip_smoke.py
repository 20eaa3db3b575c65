#!/usr/bin/env python3
"""On-card smoke run of the toyfhe_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``toyfhe_tpu_torch/csrc/`` (one ``nvcc`` per
source, started together): the NTT (K1, ``ntt.cu``) and the fused hybrid
key switch (K3, ``hybrid_ks.cu``). Then, for each path:

* the per-limb RNS gadget step: K1 bit-equal to its plain radix-2 torch
  twin, the square → relinearize → rescale step at the ``__graft_entry__``
  shape (bit-equal to the same step on the CPU) and with real keys at the
  encrypted-MNIST tower width (decoded against the expected squares);
* the dnum-grouped hybrid gadget step, the encrypted-MNIST serving key
  switch: K3 bit-equal to its plain twin over 36 shapes, the three step
  flavours (v1, ``fused=True`` through K3, the fused schedule) with real
  keys at the MNIST serving shape on the full and the one-limb-shorter
  tower (bit-equal to each other and to the CPU, decoded against the
  squares), and at ``bench.py``'s hybrid fixture shape.

Kernels, plain twins and steps are timed with CUDA events, and each path is
run once with the launch counts set to 0 to show it went through its
kernels.

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


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def phase_environment():
    from toyfhe_tpu_torch.ops import cuda_lib

    log("== phase 1: environment")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"torch.version.cuda {torch.version.cuda}")
    nvcc = subprocess.run([cuda_lib.nvcc(), "--version"], capture_output=True,
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
    from toyfhe_tpu_torch.ops import cuda_lib, hybrid_ks_cuda, ntt_cuda

    log("== phase 2: build (one nvcc per source, in parallel)")
    t0 = time.perf_counter()
    cuda_lib.build_all([ntt_cuda.LIB, hybrid_ks_cuda.LIB])
    for lib in (ntt_cuda.LIB, hybrid_ks_cuda.LIB):
        lib.load()
        log(f"{lib.library.name}: nvcc {lib.build_info.get('seconds', 0.0):.2f} s")
        for line in lib.build_info.get("log", "").strip().splitlines():
            log(f"  {line}")
    log(f"built and loaded both in {time.perf_counter() - t0:.2f} s")


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



# ---------------------------------------------------------------------------
# the hybrid (dnum-gadget) path
# ---------------------------------------------------------------------------

# (name, tower bits, dnum, num_special, ct limbs the step runs on)
HYBRID_CONFIGS = (
    ("mnist", (28,) * 7 + (29,) * 4, 2, 4, 7),      # models/mnist.py serving gadget
    ("mnist_ring1", (28,) * 7 + (29,) * 4, 2, 4, 6),  # its square layer one limb down
    ("bench", (28,) * 7 + (29,) * 3, 4, 3, 7),      # bench.py's hybrid fixture
)
HYBRID_N = 1 << 13
HYBRID_B = 4
# K1 / K3 launches one step of each flavour makes (the bodies'
# transform calls)
FLAVOUR_LAUNCHES = {
    "v1": {"fwd": 2, "inv": 3, "k3": 0},
    "fused_k3": {"fwd": 1, "inv": 3, "k3": 1},
    "fused_schedule": {"fwd": 2, "inv": 2, "k3": 0},
}


def hybrid_params(n, tower, dnum, k):
    import toyfhe_tpu_torch as T
    ring = T.make_rns_ring(n, tower)
    return T.HybridRaised(T.CKKSParams(ring, 0, 3.2), dnum, k)


def synthetic_eval_key(params, seed, device):
    """``bench.py``'s synthetic key: ``dnum`` components of uniform duals
    over the key tower, from a numpy seed."""
    from toyfhe_tpu_torch.utils import interop as I
    key_ring = params.ring_key
    rng = np.random.default_rng(seed)
    lim = min(key_ring.primes)
    shape = (params.dnum, key_ring.nlimbs, key_ring.n)
    return I.eval_mult_key(params, rng.integers(0, lim, shape), rng.integers(0, lim, shape),
                           device=device)


def eval_key_to(ek, device):
    import toyfhe_tpu_torch as T
    mv = lambda x: T.RingElt(primal=None if x.primal is None else x.primal.to(device),
                             dual=None if x.dual is None else x.dual.to(device))
    ksk = ek.key
    comps = [T.KeyComponent(mask=mv(c.mask), masked=mv(c.masked)) for c in ksk.key]
    return T.EvalMultKey(T.KeySwitchKey(ksk.params, comps, ksk.ring))


def flavour_steps(params, ek, ct_ring):
    """The three single-device hybrid steps on the key's device."""
    from toyfhe_tpu_torch.parallel import ops as pops
    mk = lambda **kw: pops.make_hybrid_sharded_step(None, params, ek, ct_ring=ct_ring, **kw)[0]
    return {"v1": mk(), "fused_k3": mk(fused=True), "fused_schedule": mk(fused_schedule=True)}


def reset_launches():
    from toyfhe_tpu_torch.ops import hybrid_ks_cuda, ntt_cuda
    for d in (ntt_cuda.launches, ntt_cuda.transforms, hybrid_ks_cuda.launches):
        for k in d:
            d[k] = 0


def census(batch: int) -> str:
    """K1 limb transforms per ciphertext since :func:`reset_launches`."""
    from toyfhe_tpu_torch.ops import ntt_cuda
    t = ntt_cuda.transforms
    return (f"K1 limb transforms per ciphertext: {t['fwd'] // batch} forward + "
            f"{t['inv'] // batch} inverse = {(t['fwd'] + t['inv']) // batch}")


def read_launches() -> dict:
    from toyfhe_tpu_torch.ops import hybrid_ks_cuda, ntt_cuda
    return {**ntt_cuda.launches, **hybrid_ks_cuda.launches}


def phase_k3_vs_plain(dev):
    from toyfhe_tpu_torch.ops import hybrid_ks

    log("== phase 8: K3 (fused hybrid key switch) against its plain twin on the card")
    gen = torch.Generator(device=dev).manual_seed(8)
    err, ncase = 0, 0
    for n in (256, 4096, 8192, 16384):
        for name, tower, dnum, k, lt in HYBRID_CONFIGS:
            params = hybrid_params(n, tower, dnum, k)
            fks = hybrid_ks.FusedHybridKS(params, synthetic_eval_key(params, n + lt, dev), lt=lt)
            primes = params.ring_cipher.primes[:lt]
            for lead in ((), (4,), (16,)):
                y = random_residues(primes, lead, n, gen, dev)
                got = fks(y)
                want = hybrid_ks.fused_hybrid_ks_plain(fks, y)
                sync(dev)
                for g, w in zip(got, want):
                    err = max(err, int((g - w).abs().max()))
                    if not torch.equal(g, w):
                        raise AssertionError(f"K3 != plain at N={n} {name} lead={lead}")
                ncase += 1
            log(f"N={n:5d} {name}: T={fks.exp_ring.nlimbs} dnum_t={fks.dnum_t} "
                f"alpha={fks.alpha}, 3 leads bit-equal")
    log(f"{ncase} cases: K3 == plain twin")
    return err


def _mnist_fixture(dev):
    """Real keys made on the card for the MNIST serving gadget, and four
    encryptions of vals·(i+1) at scale 2^45 on the full ct tower."""
    import toyfhe_tpu_torch as T

    name, tower, dnum, k, _ = HYBRID_CONFIGS[0]
    params = hybrid_params(HYBRID_N, tower, dnum, k)
    gen = torch.Generator(device=dev).manual_seed(9)
    t0 = time.perf_counter()
    kp = T.keygen(params, gen)
    ek = T.keygen_eval_mult(gen, kp.priv)
    vals = np.linspace(0.1, 1.0, HYBRID_N // 2)
    scale = Fraction(2) ** 45
    ring = params.ring_cipher
    cts = []
    for i in range(HYBRID_B):
        c = T.encrypt(kp, T.make_plaintext(ring, vals * (i + 1), scale), gen)
        cts.append(torch.stack([T.ringops.ensure_dual(ring, x).dual for x in c.cs]))
    sync(dev)
    log(f"keygen + eval key ({len(ek.key.key)} components over {params.ring_key.nlimbs} "
        f"limbs) + {HYBRID_B} encryptions: {time.perf_counter() - t0:.2f} s (host clock)")
    return params, kp, ek, torch.stack(cts), vals, scale


def phase_hybrid_mnist(dev):
    """The three flavours with real keys at the MNIST serving shape, on the
    7-limb tower (square 1 of a fresh ciphertext) and the 6-limb tower
    (``ring1``, ``models/mnist.py``'s first square layer)."""
    import toyfhe_tpu_torch as T

    log(f"== phase 9: hybrid steps with real keys at the MNIST serving shape "
        f"(N={HYBRID_N}, {HYBRID_CONFIGS[0][1]}, dnum=2, k=4, batch {HYBRID_B})")
    params, kp, ek, batch7, vals, scale = _mnist_fixture(dev)
    ek_cpu = eval_key_to(ek, "cpu")
    full = params.ring_cipher
    out = {}
    main_launches = None
    worst = 0.0
    for lt in (7, 6):
        ring = full.select(range(lt))
        batch = batch7[:, :, :lt].contiguous()           # limb drop: same plaintext
        steps = flavour_steps(params, ek, ring)
        results = {}
        for fl, step in steps.items():
            reset_launches()
            results[fl] = step(batch)
            sync(dev)
            got = read_launches()
            want = FLAVOUR_LAUNCHES[fl]
            if got != want:
                raise AssertionError(f"{fl} at {lt} limbs: launches {got}, expected {want}")
            if fl == "fused_k3" and lt == 7:
                main_launches = got
            log(f"{lt} limbs, {fl}: one step launched {got}; {census(HYBRID_B)}")
        t0 = time.perf_counter()
        cpu = {fl: step(batch.cpu()) for fl, step in flavour_steps(params, ek_cpu, ring).items()}
        log(f"{lt} limbs: the three flavours on the CPU in {time.perf_counter() - t0:.2f} s")
        ref = results["v1"].cpu()
        for fl in results:
            if not (torch.equal(results[fl].cpu(), ref) and torch.equal(cpu[fl], ref)):
                raise AssertionError(f"{fl} at {lt} limbs differs from v1 on the card or the CPU")
        if ref[:, :, -1].any():
            raise AssertionError("dropped limb not zeroed")
        log(f"{lt} limbs: v1 == fused_k3 == fused_schedule on the card == on the CPU")
        sub = ring.drop_last()
        new_scale = scale * scale / ring.primes[-1]
        for i in range(HYBRID_B):
            cs = tuple(T.RingElt(dual=results["fused_k3"][i, j, :lt - 1].contiguous())
                       for j in range(2))
            got = T.decrypt(kp, T.CipherText(params, cs, sub, enc=T.CKKSTag(new_scale))).real
            if got.shape != (HYBRID_N // 2,) or not np.all(np.isfinite(got)):
                raise AssertionError(f"ciphertext {i}: bad decode shape or non-finite values")
            worst = max(worst, float(np.max(np.abs(got - (vals * (i + 1)) ** 2))))
        log(f"{lt} limbs: decoded (vals*(i+1))^2 within {worst:.3e} so far (limit {DECODE_ATOL})")
        out[lt] = (steps, batch)
    if not worst < DECODE_ATOL:
        raise AssertionError(f"decode error {worst} >= {DECODE_ATOL}")
    return out, main_launches, worst


def phase_hybrid_bench(dev):
    """The three flavours at ``bench.py``'s hybrid fixture shape (synthetic
    keys and ciphertexts from numpy seeds 1 and 2)."""
    from toyfhe_tpu_torch.utils import interop as I

    name, tower, dnum, k, lt = HYBRID_CONFIGS[2]
    log(f"== phase 10: hybrid steps at bench.py's fixture shape (N={HYBRID_N}, {tower}, "
        f"dnum={dnum}, k={k}, batch {HYBRID_B})")
    params = hybrid_params(HYBRID_N, tower, dnum, k)
    ek = synthetic_eval_key(params, 1, dev)
    lim = min(params.ring_key.primes)
    cts = np.random.default_rng(2).integers(0, lim, (HYBRID_B, 2, lt, HYBRID_N))
    batch = I.tensor(cts, dev)
    steps = flavour_steps(params, ek, params.ring_cipher)
    results = {}
    for fl, step in steps.items():
        reset_launches()
        results[fl] = step(batch).cpu()
        got = read_launches()
        log(f"{fl}: one step launched {got}; {census(HYBRID_B)}")
        if got != FLAVOUR_LAUNCHES[fl]:
            raise AssertionError(f"{fl}: launches {got}, expected {FLAVOUR_LAUNCHES[fl]}")
    cpu = flavour_steps(params, eval_key_to(ek, "cpu"), params.ring_cipher)["v1"](batch.cpu())
    for fl, r in results.items():
        if not torch.equal(r, cpu):
            raise AssertionError(f"{fl} at the bench shape differs from v1 on the CPU")
    log("v1 == fused_k3 == fused_schedule on the card == v1 on the CPU; launches as expected")
    return steps, batch


def phase_hybrid_timing(dev, smi, mnist, bench):
    from toyfhe_tpu_torch.ops import hybrid_ks

    log(f"== phase 11: hybrid timing, CUDA events, median of {REPS} after {WARMUP} "
        f"warm-up [{smi}]")
    times = {}
    shapes = [("mnist 7 limbs", *mnist[7]), ("mnist 6 limbs", *mnist[6]),
              ("bench", *bench)]
    for label, steps, batch in shapes:
        for fl, step in steps.items():
            ms = cuda_ms(lambda: step(batch))
            times[(label, fl)] = ms
            log(f"step {label}, {fl}: {ms:.4f} ms/step, "
                f"{batch.shape[0] * 1e3 / ms:.1f} ciphertexts/s [{smi}]")
    gen = torch.Generator(device=dev).manual_seed(11)
    k3 = {}
    for name, tower, dnum, k, lt in (HYBRID_CONFIGS[0], HYBRID_CONFIGS[2]):
        params = hybrid_params(HYBRID_N, tower, dnum, k)
        fks = hybrid_ks.FusedHybridKS(params, synthetic_eval_key(params, 3, dev), lt=lt)
        y = random_residues(params.ring_cipher.primes, (HYBRID_B,), HYBRID_N, gen, dev)
        row = {"kernel": cuda_ms(lambda: fks(y)),
               "plain": cuda_ms(lambda: hybrid_ks.fused_hybrid_ks_plain(fks, y))}
        k3[name] = row
        log(f"K3 {name} (R={HYBRID_B}, T={fks.exp_ring.nlimbs}, dnum={fks.dnum_t}, "
            f"N={HYBRID_N}): kernel {row['kernel']:.4f} ms, plain {row['plain']:.4f} ms [{smi}]")
    return times, k3


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

    k3_err = phase_k3_vs_plain(dev)
    mnist, hybrid_launches, decode_err = phase_hybrid_mnist(dev)
    bench = phase_hybrid_bench(dev)
    htimes, k3_times = phase_hybrid_timing(dev, smi, mnist, bench)

    log("== phase 12: kernel use over one hybrid step (fused=True, MNIST serving shape)")
    if hybrid_launches != FLAVOUR_LAUNCHES["fused_k3"]:
        raise AssertionError(f"hybrid main path launches {hybrid_launches}")
    log(f"K3 launched once, K1 {hybrid_launches['fwd']} forward and "
        f"{hybrid_launches['inv']} inverse, as the step body makes them; "
        f"real-key decode error {decode_err:.3e}")

    shape = "B*L=28, N=2^13"
    kernels = [
        {"name": f"k1_ntt_{k}", "route": "cuda", "source": "toyfhe_tpu_torch/csrc/ntt.cu",
         "replaces": f"toyfhe_tpu/ops/ntt_mxu_pallas.py:{line}",
         "launches": launches[k], "max_abs_err": err[k],
         "ms": times[shape][k], "plain_ms": times[shape][f"{k}_plain"]}
        for k, line in (("fwd", 242), ("inv", 255))]
    kernels.append(
        {"name": "k3_hybrid_ks", "route": "cuda", "source": "toyfhe_tpu_torch/csrc/hybrid_ks.cu",
         "replaces": "toyfhe_tpu/ops/pallas_hybrid_ks.py:47",
         "launches": hybrid_launches["k3"], "max_abs_err": k3_err,
         "ms": k3_times["mnist"]["kernel"], "plain_ms": k3_times["mnist"]["plain"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
