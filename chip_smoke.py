#!/usr/bin/env python3
"""On-card smoke run of the toyfhe_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``toyfhe_tpu_torch/csrc/`` (one ``nvcc`` per
source, started together): the NTT (K1, ``ntt.cu``: a cluster-split
register-radix kernel and the one-block radix-2 kernel it replaced), the
four-step digit transform on the int8 tensor cores (K2, ``ntt_mxu.cu``), the
fused hybrid key switch (K3,
``hybrid_ks.cu``: a register-radix kernel that spends a thread-block cluster
on the digits or on the polynomial, and the one-block radix-2 loop kernel it
replaced), the fused polynomial product (K4, ``polymul.cu``: a
cluster-split register-radix kernel and the one-block radix-2 kernel it
replaced), the bit-reversed DIF transform (K5, ``ntt_bitrev.cu``: a
register-radix kernel over 1, 2 or 4 independent blocks a polynomial, and the
one-block radix-2 kernel it replaced) and the
fused windowed key switch (K6, ``keyswitch.cu``: a kernel that spreads the
digits over a thread-block cluster and the one-block loop kernel it
replaced). Then, for each path:

* the per-limb RNS gadget step: K1 bit-equal to its plain radix-2 torch
  twin (the cluster kernel at every legal cluster size, with lazy and with
  fully reduced butterflies, and the radix-2 kernel), the square → relinearize → rescale step at the ``__graft_entry__``
  shape (bit-equal to the same step on the CPU) and with real keys at the
  encrypted-MNIST tower width (decoded against the expected squares);
* the dnum-grouped hybrid gadget step, the encrypted-MNIST serving key
  switch: K3 bit-equal to its plain twin over 40 cases (as dispatched, the
  digits and the polynomial over every legal cluster size with lazy and with
  fully reduced arithmetic, and the loop kernel), the three step
  flavours (v1, ``fused=True`` through K3, the fused schedule) with real
  keys at the MNIST serving shape on the full and the one-limb-shorter
  tower (bit-equal to each other and to the CPU, decoded against the
  squares), and at ``bench.py``'s hybrid fixture shape;
* the windowed special-prime rotation: K5 and K6 bit-equal to their plain
  twins over shape sweeps (each as dispatched, at every legal cluster size
  or block count with lazy and with fully reduced butterflies, and the
  kernel it replaced; K5 limb-major and row-major), then
  K5 + K6 + the special-prime rescale with a
  real Galois key at the MNIST data width (N = 2^13, seven 28-bit limbs +
  one special, window 8), bit-equal to ``layers._modraise_keyswitch`` on the
  card and on the CPU and decoded against the rotated slots; the windowed
  and hybrid layers on the card bit-equal to the CPU;
* the encrypted-MNIST serving pipeline at the reference's full
  ``MNISTConfig()`` through ``encrypted_inference_fast``: 64 images, a 7×7
  grid of ciphertexts, 315 hybrid rotations and 2 relinearizations per
  batch, logits held against the plaintext forward pass;
* the kernel A/B entry point ``toyfhe_tpu_torch.tools.bench_kernels`` at its
  full width (N = 2^14, eight 28-bit limbs, 16 rows): K2 in both
  recombinations and K4 bit-equal to their plain twins over shape sweeps
  (K2 also to K1; K4 as dispatched, at every legal cluster size with lazy
  and with fully reduced butterflies, and the radix-2 kernel, also to the
  unfused product through K1), then the tool's rows at that width and at
  the serving transform shape (N = 2^13, seven limbs, four rows), the
  radix-2 K1 and K4 beside the cluster kernels;
* the production serving configuration of encrypted MNIST: hoisted
  rotations (``rotate_many`` / ``rotate_sum``) with real keys on the card
  bit-equal to the CPU and decoded, then the same full-width pipeline with
  the 14 BSGS Galois keys and the dual flow, its logits held against the
  plaintext pass and against the iterated schedule on the same encrypted
  grid, its key products, decompositions and K1 launches counted;
* device time apart from wrapper time for K1 (both kernels, at the small
  and the large end of the MNIST launches, the timed shape and the A/B
  batch), K2, K4 (both kernels, at the A/B batch and the serving transform
  shape), K6 (both kernels, at the windowed rotation's shape), K3 (both
  kernels, at the serving gadget with 4 and 16 rows and at ``bench.py``'s
  fixture), K5 (both kernels, at the windowed rotation's shape, the serving
  transform shape and the A/B batch), every variant of each, and
  the whole windowed key switch fused against unfused: one launch between
  two events, 200 launches back to back, one launch's share of a replayed
  CUDA graph, and the host's time a call.

Kernels, plain twins and steps are timed with CUDA events, and each path is
run once with the launch counts set to 0 to show it went through its
kernels. The kernels line gives each kernel's time beside its plain twin's
and beside the least time the card could take for the same bytes and
operations.

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
    from toyfhe_tpu_torch.ops import (cuda_lib, hybrid_ks_cuda, ntt_cuda, ntt_mxu_pallas_cuda,
                                      ntt_pallas_cuda, pallas_keyswitch_cuda)

    log("== phase 2: build (one nvcc per source, in parallel)")
    t0 = time.perf_counter()
    libs = [ntt_cuda.LIB, hybrid_ks_cuda.LIB, ntt_pallas_cuda.LIB, pallas_keyswitch_cuda.LIB,
            ntt_mxu_pallas_cuda.LIB, ntt_pallas_cuda.LIB_POLYMUL]
    cuda_lib.build_all(libs)
    for lib in libs:
        lib.load()
        log(f"{lib.library.name}: nvcc {lib.build_info.get('seconds', 0.0):.2f} s")
        for line in lib.build_info.get("log", "").strip().splitlines():
            log(f"  {line}")
    log(f"built and loaded all {len(libs)} in {time.perf_counter() - t0:.2f} s")


K1_SWEEP_TOWERS = ((30, 29, 29, 28), (28,) * 7, (28,) * 8, (30, 30))


def phase_kernel_vs_plain(dev):
    """K1 against its plain twin: the kernel every caller gets, the cluster
    kernel at every legal cluster size with lazy and with fully reduced
    butterflies (a tower with a prime in [2^30, 2^31) takes only the latter),
    and the one-block radix-2 kernel."""
    from toyfhe_tpu_torch.ops import ntt as nttmod
    from toyfhe_tpu_torch.ops import ntt_cuda
    from toyfhe_tpu_torch.utils import numtheory as nt

    log("== phase 3: K1 against plain radix-2 on the card: the cluster kernel at every legal "
        "cluster size, lazy and fully reduced, and the one-block radix-2 kernel")
    gen = torch.Generator(device=dev).manual_seed(3)
    err = {"fwd": 0, "inv": 0}
    ncase = nlaunch = 0
    for n in (256, 4096, 8192, 16384):
        for tower in K1_SWEEP_TOWERS:
            tables = nttmod.NttTables(n, nt.ntt_prime_chain(n, tower))
            can_lazy = max(tables.primes) < ntt_cuda.LAZY_PRIME_LIMIT
            variants = [(c, lz) for c in ntt_cuda.legal_clusters(n)
                        for lz in ((True, False) if can_lazy else (False,))]
            for lead in ((), (4,), (4, 7), (16,)):
                x = random_residues(tables.primes, lead, n, gen, dev)
                polys = x.numel() // n
                for which, inverse, plain in (("fwd", False, nttmod.ntt_plain),
                                              ("inv", True, nttmod.intt_plain)):
                    want = plain(tables, x)
                    got = [nttmod.intt(tables, x) if inverse else nttmod.ntt(tables, x),
                           ntt_cuda.launch(tables, x, inverse, variant="radix2")]
                    got += [ntt_cuda.launch_cluster(tables, x, inverse, c, lz)
                            for c, lz in variants]
                    torch.cuda.synchronize()
                    nlaunch += len(got)
                    for i, g in enumerate(got):
                        err[which] = max(err[which], int((g - want).abs().max()))
                        if not torch.equal(g, want):
                            what = (["default", "radix2"] + [f"C={c} lazy={lz}"
                                                             for c, lz in variants])[i]
                            raise AssertionError(f"K1 {what} != plain at N={n} tower={tower} "
                                                 f"lead={lead} {which}")
                back = nttmod.intt(tables, nttmod.ntt(tables, x))
                if not torch.equal(back, x):
                    raise AssertionError(f"round trip at N={n} tower={tower} lead={lead}")
                ncase += 1
            log(f"N={n:5d} tower={tower}: 4 leads, clusters {ntt_cuda.legal_clusters(n)} x "
                f"{'lazy and full' if can_lazy else 'full (a prime >= 2^30)'} + radix-2 + the "
                f"chooser's pick (here C={ntt_cuda.choose_cluster(polys, n, tables.primes)[0]} "
                f"for {polys} polynomials): bit-equal, round trip exact")
    log(f"{ncase} cases, {nlaunch} launches: every K1 variant == plain, intt(ntt(x)) == x")
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
    "v1": {"fwd": 2, "inv": 3, "k3": 0, "k5": 0, "k6": 0},
    "fused_k3": {"fwd": 1, "inv": 3, "k3": 1, "k5": 0, "k6": 0},
    "fused_schedule": {"fwd": 2, "inv": 2, "k3": 0, "k5": 0, "k6": 0},
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
    """An EvalMultKey or GaloisKey with its components moved to ``device``."""
    import toyfhe_tpu_torch as T
    mv = lambda x: T.RingElt(primal=None if x.primal is None else x.primal.to(device),
                             dual=None if x.dual is None else x.dual.to(device))
    ksk = ek.key
    comps = [T.KeyComponent(mask=mv(c.mask), masked=mv(c.masked)) for c in ksk.key]
    moved = T.KeySwitchKey(ksk.params, comps, ksk.ring)
    if isinstance(ek, T.GaloisKey):
        return T.GaloisKey(ek.galois_element, moved)
    return T.EvalMultKey(moved)


def flavour_steps(params, ek, ct_ring):
    """The three single-device hybrid steps on the key's device."""
    from toyfhe_tpu_torch.parallel import ops as pops
    mk = lambda **kw: pops.make_hybrid_sharded_step(None, params, ek, ct_ring=ct_ring, **kw)[0]
    return {"v1": mk(), "fused_k3": mk(fused=True), "fused_schedule": mk(fused_schedule=True)}


def reset_launches():
    from toyfhe_tpu_torch.ops import hybrid_ks_cuda, ntt_cuda, ntt_pallas_cuda, pallas_keyswitch_cuda
    for d in (ntt_cuda.launches, ntt_cuda.transforms, hybrid_ks_cuda.launches,
              ntt_pallas_cuda.launches, pallas_keyswitch_cuda.launches):
        for k in d:
            d[k] = 0


def census(batch: int) -> str:
    """K1 limb transforms per ciphertext since :func:`reset_launches`."""
    from toyfhe_tpu_torch.ops import ntt_cuda
    t = ntt_cuda.transforms
    return (f"K1 limb transforms per ciphertext: {t['fwd'] // batch} forward + "
            f"{t['inv'] // batch} inverse = {(t['fwd'] + t['inv']) // batch}")


def read_launches() -> dict:
    from toyfhe_tpu_torch.ops import hybrid_ks_cuda, ntt_cuda, ntt_pallas_cuda, pallas_keyswitch_cuda
    return {**ntt_cuda.launches, **hybrid_ks_cuda.launches, **ntt_pallas_cuda.launches,
            **pallas_keyswitch_cuda.launches}


# a gadget with a raising prime in [2^30, 2^31): fully reduced arithmetic
HYBRID_FULL_CONFIG = ("full", (28,) * 4 + (30, 29), 2, 2, 4)


def phase_k3_vs_plain(dev):
    from toyfhe_tpu_torch.ops import hybrid_ks, hybrid_ks_cuda as k3c

    log("== phase 8: K3 (fused hybrid key switch) against its plain twin on the card: the "
        "cluster kernel as dispatched, the digits over every legal cluster size and the "
        "polynomial over every legal one, with lazy and with fully reduced arithmetic, and "
        "the one-block loop kernel")
    gen = torch.Generator(device=dev).manual_seed(8)
    err, ncase, nlaunch = 0, 0, 0
    cases = [(n, cfg, lead) for n in (256, 4096, 8192, 16384) for cfg in HYBRID_CONFIGS
             for lead in ((), (4,), (16,))]
    cases += [(n, HYBRID_FULL_CONFIG, lead) for n, lead in ((256, (4,)), (8192, ()))]
    cases += [(32768, HYBRID_CONFIGS[0], ()), (32768, HYBRID_CONFIGS[2], (2,))]
    made = {}
    for n, cfg, lead in cases:
        name, tower, dnum, k, lt = cfg
        if (n, name) not in made:
            params = hybrid_params(n, tower, dnum, k)
            made[(n, name)] = params, hybrid_ks.FusedHybridKS(
                params, synthetic_eval_key(params, n + lt, dev), lt=lt)
        params, fks = made[(n, name)]
        y = random_residues(params.ring_cipher.primes[:lt], lead, n, gen, dev)
        want = hybrid_ks.fused_hybrid_ks_plain(fks, y)
        rows = y.numel() // (lt * n)
        chosen = k3c.choose_cluster(rows * fks.exp_ring.nlimbs, n, fks.dnum_t,
                                    fks.exp_ring.primes)
        variants = [("dispatched", lambda: fks(y)),
                    ("loop", lambda: k3c.launch(fks, y, variant="loop"))]
        for scheme in k3c.SCHEMES:
            for g in k3c.legal_clusters(n, fks.dnum_t, scheme):
                for lazy in ((False, True) if chosen[2] else (False,)):
                    variants.append((f"{scheme} {g} lazy={lazy}",
                                     lambda scheme=scheme, g=g, lazy=lazy: k3c.launch(
                                         fks, y, cluster=g, scheme=scheme, lazy=lazy)))
        for vname, fn in variants:
            got = fn()
            sync(dev)
            for g_, w_ in zip(got, want):
                err = max(err, int((g_ - w_).abs().max()))
                if not torch.equal(g_, w_):
                    raise AssertionError(f"K3 {vname} != plain at N={n} {name} lead={lead}")
            nlaunch += 1
        ncase += 1
        log(f"N={n:5d} {name} lead={lead}: T={fks.exp_ring.nlimbs} dnum_t={fks.dnum_t} "
            f"alpha={fks.alpha}{'' if chosen[2] else ' (full)'}, dispatched {chosen[0]} "
            f"{chosen[1]}; digits over {k3c.legal_clusters(n, fks.dnum_t)}, polynomial over "
            f"{k3c.legal_clusters(n, fks.dnum_t, 'poly')}, and the loop kernel bit-equal")
    log(f"{ncase} cases, {nlaunch} launches: every K3 variant == plain twin (accumulators in "
        f"registers up to 2^13 residues a block, partial rows in shared memory at N=2^14, in "
        f"device scratch at 2^15)")
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
               "plain": cuda_ms(lambda: hybrid_ks.fused_hybrid_ks_plain(fks, y)), "fks": fks,
               "y": y}
        k3[name] = row
        log(f"K3 {name} (R={HYBRID_B}, T={fks.exp_ring.nlimbs}, dnum={fks.dnum_t}, "
            f"N={HYBRID_N}): kernel {row['kernel']:.4f} ms, plain {row['plain']:.4f} ms [{smi}]")
    return times, k3


# ---------------------------------------------------------------------------
# the windowed special-prime rotation (K5, K6) and the layers
# ---------------------------------------------------------------------------

PHASE3_TOWERS = ((30, 29, 29, 28), (28,) * 7, (28,) * 8)
# path (b): the MNIST data width with one special prime and window 8
K6_N, K6_TOWER, K6_WINDOW, K6_STEPS = 1 << 13, (28,) * 7 + (29,), 8, 64


def phase_k5_vs_plain(dev):
    from toyfhe_tpu_torch.ops import ntt as nttmod
    from toyfhe_tpu_torch.ops import ntt_pallas, ntt_pallas_cuda as k5c
    from toyfhe_tpu_torch.utils import numtheory as nt

    log("== phase 13: K5 (bit-reversed DIF transform) against its plain twin on the card: the "
        "register-radix kernel as dispatched, limb-major and row-major, at every legal block "
        "count a polynomial with lazy and with fully reduced butterflies, and the one-block "
        "radix-2 kernel")
    gen = torch.Generator(device=dev).manual_seed(13)
    err, ncase, nlaunch = 0, 0, 0
    for n in (256, 1024, 4096, 8192, 16384, 32768):
        towers = PHASE3_TOWERS if n < 32768 else PHASE3_TOWERS[:2]   # one full, one lazy
        for tower in towers:
            tables = nttmod.NttTables(n, nt.ntt_prime_chain(n, tower))
            pt = ntt_pallas.PallasNttTables(tables)
            brev = torch.as_tensor(tables.bitrev, device=dev)
            lazy_ok = max(tables.primes) < k5c.LAZY_PRIME_LIMIT
            for rows in (1, 4, 16):
                rm = random_residues(tables.primes, (rows,), n, gen, dev)      # [R, L, N]
                a = rm.transpose(0, 1).contiguous()
                want = ntt_pallas.ntt_bitrev_plain(pt, a)
                nat = nttmod.ntt(tables, rm).transpose(0, 1)[..., brev]
                outs = [ntt_pallas.ntt_pallas_bitrev(pt, a),
                        ntt_pallas.ntt_bitrev_rows(pt, rm).transpose(0, 1),
                        k5c.launch(pt, a, variant="radix2")]
                for c in k5c.legal_bitrev_clusters(n):
                    for lazy in ((False, True) if lazy_ok else (False,)):
                        outs.append(k5c.launch(pt, a, cluster=c, lazy=lazy))
                sync(dev)
                for got in outs:
                    err = max(err, int((got - want).abs().max()))
                    if not (torch.equal(got, want) and torch.equal(got, nat)):
                        raise AssertionError(f"K5 != plain at N={n} tower={tower} rows={rows}")
                nlaunch += len(outs)
                ncase += 1
        log(f"N={n:5d}: {len(towers)} towers x rows (1, 4, 16): dispatched (limb-major and "
            f"row-major), C in {k5c.legal_bitrev_clusters(n)} lazy and full, and the radix-2 "
            f"kernel bit-equal to the plain twin and to K1 read bit-reversed")
    log(f"{ncase} cases, {nlaunch} launches: every K5 variant == plain twin == bit-reversed K1")
    return err


def synthetic_fused_keyswitch(n, tower, window, seed, device):
    """A FusedKeyswitch over ``tower`` (its last prime the special) with
    uniform key duals from a numpy seed."""
    from toyfhe_tpu_torch.ops import ntt as nttmod
    from toyfhe_tpu_torch.ops.pallas_keyswitch import FusedKeyswitch
    from toyfhe_tpu_torch.utils import interop as I
    from toyfhe_tpu_torch.utils import numtheory as nt

    tables = nttmod.NttTables(n, nt.ntt_prime_chain(n, tower))
    lc = len(tower) - 1
    kpl = -(-max(p.bit_length() for p in tables.primes[:lc]) // window)
    rng = np.random.default_rng(seed)
    keys = [I.tensor(np.stack([rng.integers(0, p, (lc * kpl, n)) for p in tables.primes], 1),
                     device) for _ in range(2)]
    return FusedKeyswitch(tables, keys[0], keys[1], window, kpl, lc)


K6_FULL_TOWER = (30, 29, 28, 28, 29)     # a prime above 2^30: fully reduced butterflies


def phase_k6_vs_plain(dev):
    from toyfhe_tpu_torch.ops import pallas_keyswitch, pallas_keyswitch_cuda as k6c

    log("== phase 14: K6 (fused windowed key switch) against its plain twin on the card: the "
        "cluster kernel as dispatched, at every legal cluster size with lazy and with fully "
        "reduced butterflies, and the one-block loop kernel")
    gen = torch.Generator(device=dev).manual_seed(14)
    err, ncase, nlaunch = 0, 0, 0
    cases = [(n, K6_TOWER, w, lead) for n in (256, 4096, 8192, 16384) for w in (8, 5)
             for lead in ((), (2,))] + [(32768, K6_TOWER, 8, ())] + \
            [(n, K6_FULL_TOWER, 8, lead) for n, lead in ((256, (2,)), (8192, ()))]
    for n, tower, window, lead in cases:
        fk = synthetic_fused_keyswitch(n, tower, window, n + window, dev)
        primes = fk.pt.primes
        c2 = random_residues(primes[:-1], lead, n, gen, dev)
        c1e = random_residues(primes, lead, n, gen, dev)
        want = pallas_keyswitch.fused_keyswitch_plain(fk, c2, c1e)
        pairs = (2 if lead else 1) * len(primes)
        chosen, lazy_ok = k6c.choose_cluster(pairs, n, fk.ndig, primes)
        variants = [("dispatched", lambda: fk(c2, c1e)),
                    ("loop", lambda: k6c.launch(fk, c2, c1e, variant="loop"))]
        legal = k6c.legal_clusters(n, fk.ndig)
        for g in legal:
            for lazy in ((False, True) if lazy_ok else (False,)):
                variants.append((f"G={g} lazy={lazy}",
                                 lambda g=g, lazy=lazy: k6c.launch(fk, c2, c1e, cluster=g,
                                                                   lazy=lazy)))
        for name, fn in variants:
            got = fn()
            sync(dev)
            for g_, w_ in zip(got, want):
                err = max(err, int((g_ - w_).abs().max()))
                if not torch.equal(g_, w_):
                    raise AssertionError(f"K6 {name} != plain at N={n} tower={tower} "
                                         f"window={window} lead={lead}")
            nlaunch += 1
        ncase += 1
        log(f"N={n:5d} tower={len(tower)} limbs{' (full)' if not lazy_ok else ''} window={window} "
            f"kpl={fk.kpl} ndig={fk.ndig} lead={lead}: dispatched G={chosen}, G in {legal} x "
            f"{'lazy and full' if lazy_ok else 'full'}, and the loop kernel bit-equal")
    log(f"{ncase} cases, {nlaunch} launches: every K6 variant == plain twin (partial rows in "
        f"shared memory up to N=2^14, in device scratch at 2^15)")
    return err


def modraise_params(n, tower, window):
    import toyfhe_tpu_torch as T
    return T.ModulusRaised(T.CKKSParams(T.make_rns_ring(n, tower), window, 3.2))


def phase_k6_path(dev):
    """K5 + K6 + the special-prime rescale with a real Galois key at the
    MNIST data width, against ``layers._modraise_keyswitch`` on the card and
    on the CPU and against the engine's ``rotate``, decoded."""
    import toyfhe_tpu_torch as T
    from toyfhe_tpu_torch.parallel import layers as TL

    log(f"== phase 15: windowed special-prime rotation with real keys (N={K6_N}, "
        f"{K6_TOWER}, window {K6_WINDOW}, {K6_STEPS}-slot rotation)")
    params = modraise_params(K6_N, K6_TOWER, K6_WINDOW)
    gen = torch.Generator(device=dev).manual_seed(15)
    t0 = time.perf_counter()
    kp = T.keygen(params, gen)
    gk = T.keygen_galois(gen, kp.priv, steps=K6_STEPS)
    ek = T.keygen_eval_mult(gen, kp.priv)
    vals = np.linspace(0.1, 1.0, K6_N // 2)
    scale = Fraction(2) ** 40
    ring = params.ring_cipher
    c = T.encrypt(kp, T.make_plaintext(ring, vals, scale), gen)
    g = T.apply_galois_ct(c, gk.galois_element)
    c1p, c2p = (T.ringops.ensure_primal(ring, x).primal for x in g.cs)
    ka = TL.build_modraise_key_arrays(params, gk.key)
    fk = TL.build_fused_keyswitch(ka)
    sync(dev)
    log(f"keygen + Galois key ({len(gk.key.key)} components) + eval key + encryption + "
        f"K6 tables: {time.perf_counter() - t0:.2f} s (host clock)")

    reset_launches()
    fused = TL._modraise_keyswitch_fused(ka, fk, c1p, c2p)
    sync(dev)
    launches = read_launches()
    want = {"fwd": 0, "inv": 0, "k3": 0, "k5": 1, "k6": 1}
    if launches != want:
        raise AssertionError(f"fused key switch launched {launches}, expected {want}")
    log(f"one fused key switch launched {launches}")
    reset_launches()
    for _ in range(3):
        TL._modraise_keyswitch_fused(ka, fk, c1p, c2p)
    if read_launches()["k6"] != 3:
        raise AssertionError("expected one K6 launch per call")
    log("three calls: three K6 launches, one per call")

    unfused = TL._modraise_keyswitch(ka, c1p, c2p)
    ka_cpu = TL.build_modraise_key_arrays(params, eval_key_to(gk, "cpu").key)
    cpu = TL._modraise_keyswitch(ka_cpu, c1p.cpu(), c2p.cpu())
    eng = T.rotate(gk, c)
    eng_p = [T.ringops.ensure_primal(eng.ring, x).primal for x in eng.cs]
    for f, u, h, e in zip(fused, unfused, cpu, eng_p):
        if not (torch.equal(f, u) and torch.equal(f.cpu(), h) and torch.equal(f, e)):
            raise AssertionError("K5 + K6 + rescale differs from _modraise_keyswitch or rotate")
    log("K5 + K6 + rescale == _modraise_keyswitch on the card == on the CPU == engine rotate")
    out = T.CipherText(params, tuple(T.RingElt(primal=x) for x in fused), ring, enc=c.enc)
    got = T.decrypt(kp, out).real
    if got.shape != (K6_N // 2,) or not np.all(np.isfinite(got)):
        raise AssertionError("bad decode shape or non-finite values")
    worst = float(np.max(np.abs(got - np.roll(vals, K6_STEPS))))
    log(f"decoded np.roll(vals, {K6_STEPS}): max abs error {worst:.3e} (limit {DECODE_ATOL})")
    if not worst < DECODE_ATOL:
        raise AssertionError(f"rotation decode error {worst} >= {DECODE_ATOL}")
    return dict(params=params, kp=kp, gk=gk, ek=ek, c=c, ka=ka, fk=fk, c1p=c1p, c2p=c2p,
                launches=launches, decode_err=worst)


def _layers_card_vs_cpu(label, params, gk, ek, rot_ring, sq_ring, d, gen):
    from toyfhe_tpu_torch.parallel import layers as TL

    dev = gen.device
    rot = {dv: TL.RotateMatmulLayer(params, k, gk.galois_element, d, rot_ring)
           for dv, k in ((dev, gk), ("cpu", eval_key_to(gk, "cpu")))}
    sq = {dv: TL.SquareRelinLayer(params, k, sq_ring)
          for dv, k in ((dev, ek), ("cpu", eval_key_to(ek, "cpu")))}
    x = [random_residues(rot_ring.primes, (), rot_ring.n, gen, dev) for _ in range(2)]
    diag = random_residues(rot_ring.primes, (d,), rot_ring.n, gen, dev)
    y = [random_residues(sq_ring.primes, (2,), sq_ring.n, gen, dev) for _ in range(2)]
    t0 = time.perf_counter()
    card = (rot[dev](*x, diag), sq[dev](*y))
    sync(dev)
    t1 = time.perf_counter()
    host = (rot["cpu"](*[v.cpu() for v in x], diag.cpu()), sq["cpu"](*[v.cpu() for v in y]))
    t2 = time.perf_counter()
    for name, a, b in (("RotateMatmulLayer", card[0], host[0]),
                       ("SquareRelinLayer", card[1], host[1])):
        for u, v in zip(a, b):
            if not torch.equal(u.cpu(), v):
                raise AssertionError(f"{label} {name} on the card differs from the CPU")
    log(f"{label}: RotateMatmulLayer (d={d}, {rot_ring.nlimbs} limbs) and SquareRelinLayer "
        f"({sq_ring.nlimbs} limbs, batch 2) on the card == on the CPU "
        f"[card {(t1 - t0) * 1e3:.1f} ms, CPU {(t2 - t1) * 1e3:.1f} ms, host clock]")


def phase_layers(dev, kpath):
    import toyfhe_tpu_torch as T

    log("== phase 16: the windowed and hybrid layers on the card against the CPU, bit-equal")
    gen = torch.Generator(device=dev).manual_seed(16)
    params = kpath["params"]
    ring = params.ring_cipher
    _layers_card_vs_cpu(f"ModulusRaised window {K6_WINDOW}, N={K6_N}", params, kpath["gk"],
                        kpath["ek"], ring, ring, 4, gen)
    name, tower, dnum, k, _ = HYBRID_CONFIGS[0]
    hp = hybrid_params(HYBRID_N, tower, dnum, k)
    kp = T.keygen(hp, gen)
    hek = T.keygen_eval_mult(gen, kp.priv)
    hgk = T.keygen_galois(gen, kp.priv, steps=K6_STEPS)
    full = hp.ring_cipher
    _layers_card_vs_cpu(f"HybridRaised dnum={dnum} k={k}, N={HYBRID_N}", hp, hgk, hek,
                        full.select(range(5)), full.select(range(6)), 4, gen)


PIPE_REPS = 3


def pipeline_launches(cfg) -> dict:
    """K1 launches one batch of the pipeline makes: encryption 2 forward;
    conv 1 inverse; each square 2 + 2; each dense channel 1 forward plus,
    per rotation, 3 forward and 1 inverse; the bias rescale 1 inverse;
    decryption 1 + 1."""
    rot = cfg.positions - 1
    dense = cfg.channels + 1
    return {"fwd": 2 + 2 * 2 + dense * (1 + 3 * rot) + 1,
            "inv": 1 + 2 * 2 + dense * rot + 1 + 1, "k3": 0, "k5": 0, "k6": 0}


PIPE_ENC_SEED = 170     # the encryption randomness of the batch both schedules are held on


def time_pipeline(run, imgs, gen, dev):
    """Warm wall ms per batch (median and the runs) and the median ms of
    each stage, the device synchronised between stages."""
    walls = []
    for _ in range(PIPE_REPS):
        sync(dev)
        t = time.perf_counter()
        run(imgs, gen)
        sync(dev)
        walls.append((time.perf_counter() - t) * 1e3)
    per_layer = []
    for _ in range(PIPE_REPS):
        lt = {}
        run(imgs, gen, layer_times=lt)
        per_layer.append(lt)
    layers = {k: float(np.median([lt[k] for lt in per_layer])) for k in per_layer[0]}
    return float(np.median(walls)), walls, layers


def phase_mnist_pipeline(dev, smi, cfg=None):
    from toyfhe_tpu_torch.models import mnist as M
    from toyfhe_tpu_torch.ops import ntt_cuda

    cfg = M.MNISTConfig() if cfg is None else cfg
    rots = (cfg.channels + 1) * (cfg.positions - 1)
    log(f"== phase 17: the encrypted-MNIST serving pipeline at MNISTConfig() (N=2^{cfg.ring_logn}, "
        f"{cfg.limb_bits}, {cfg.gadget} dnum={cfg.dnum} k={cfg.num_special}, {cfg.batch} "
        f"images, {cfg.grid}x{cfg.grid} grid, {cfg.channels} channels, {rots} rotations)")
    gen = torch.Generator(device=dev).manual_seed(17)
    t0 = time.perf_counter()
    setup = M.fhe_setup(cfg, gen)
    sync(dev)
    log(f"fhe_setup (key pair, eval key, Galois key of {cfg.batch} slots): "
        f"{time.perf_counter() - t0:.2f} s (host clock)")
    weights = M.init_params(cfg, 17)
    imgs = np.random.default_rng(17).uniform(0.0, 1.0, (cfg.batch, cfg.image, cfg.image))
    plain = M.model_forward(cfg, weights, imgs)
    t0 = time.perf_counter()
    M.encrypted_inference_fast(setup, weights, imgs, gen)
    sync(dev)
    log(f"build (layers, {cfg.channels * cfg.positions + cfg.positions} diagonal encodings) + "
        f"first batch: {time.perf_counter() - t0:.2f} s (host clock)")

    reset_launches()
    logits = M.encrypted_inference_fast(                                  # the main path
        setup, weights, imgs, torch.Generator(device=dev).manual_seed(PIPE_ENC_SEED)).T
    sync(dev)
    launches = read_launches()
    transforms = dict(ntt_cuda.transforms)
    want = pipeline_launches(cfg)
    log(f"one batch launched {launches}; K1 limb transforms {transforms['fwd']} forward + "
        f"{transforms['inv']} inverse")
    if launches != want:
        raise AssertionError(f"pipeline launched {launches}, expected {want}")
    if logits.shape != (cfg.batch, cfg.classes) or not np.all(np.isfinite(logits)):
        raise AssertionError(f"bad logits: shape {logits.shape} or non-finite values")
    err = float(np.max(np.abs(logits - plain)))
    top2 = np.sort(plain, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * err
    agree = np.argmax(logits, -1) == np.argmax(plain, -1)
    log(f"logits vs model_forward: max abs error {err:.3e} (limit 0.5); labels agree on "
        f"{int(agree.sum())}/{cfg.batch} images; {int(clear.sum())} images have a plaintext "
        f"top-two margin > 2x error, labels agree on {int(agree[clear].sum())} of them")
    if not err < 0.5:
        raise AssertionError(f"logit error {err} >= 0.5")
    if not agree[clear].all():
        raise AssertionError("a label differs on an image with a clear plaintext margin")

    ms, walls, layers = time_pipeline(setup._pipeline, imgs, gen, dev)
    log(f"warm batch: {ms:.1f} ms/batch (median of {PIPE_REPS}: "
        f"{', '.join(f'{w:.1f}' for w in walls)}), {cfg.batch * 1e3 / ms:.1f} images/s [{smi}]")
    log("per stage (median ms, synchronised between stages): " +
        ", ".join(f"{k} {v:.2f}" for k, v in layers.items()) + f" [{smi}]")
    return dict(launches=launches, transforms=transforms, err=err, ms=ms, layers=layers,
                agree=int(agree.sum()), clear=int(clear.sum()), batch=cfg.batch,
                cfg=cfg, setup=setup, weights=weights, imgs=imgs, plain=plain, logits=logits,
                gen=gen)


def phase_k5_k6_timing(dev, smi, kpath):
    from toyfhe_tpu_torch.ops import ntt as nttmod
    from toyfhe_tpu_torch.ops import ntt_pallas, pallas_keyswitch
    from toyfhe_tpu_torch.parallel import layers as TL
    from toyfhe_tpu_torch.utils import numtheory as nt

    log(f"== phase 18: K5 and K6 timing, CUDA events, median of {REPS} after {WARMUP} "
        f"warm-up [{smi}]")
    gen = torch.Generator(device=dev).manual_seed(18)
    out = {}
    fk = kpath["fk"]
    for label, pt, rows in (("path (b): 8 limbs x 1 row", fk.pt, 1),
                            ("28 x N=2^13: 7 limbs x 4 rows", ntt_pallas.PallasNttTables(
                                nttmod.NttTables(K6_N, nt.ntt_prime_chain(K6_N, (28,) * 7))), 4)):
        a = random_residues(pt.primes, (rows,), pt.n, gen, dev).transpose(0, 1).contiguous()
        row = {"kernel": cuda_ms(lambda: ntt_pallas.ntt_pallas_bitrev(pt, a)),
               "plain": cuda_ms(lambda: ntt_pallas.ntt_bitrev_plain(pt, a))}
        out[("k5", label)] = row
        log(f"K5 {label}: kernel {row['kernel']:.4f} ms, plain {row['plain']:.4f} ms [{smi}]")
    c1e = random_residues(fk.pt.primes, (), fk.n, gen, dev)
    c2p = kpath["c2p"]
    row = {"kernel": cuda_ms(lambda: fk(c2p, c1e)),
           "plain": cuda_ms(lambda: pallas_keyswitch.fused_keyswitch_plain(fk, c2p, c1e))}
    out["k6"] = row
    log(f"K6 path (b) (Lc={fk.Lc}, {fk.ndig} digits, N={fk.n}): kernel {row['kernel']:.4f} ms, "
        f"plain {row['plain']:.4f} ms [{smi}]")
    ka, c1p = kpath["ka"], kpath["c1p"]
    row = {"fused": cuda_ms(lambda: TL._modraise_keyswitch_fused(ka, fk, c1p, c2p)),
           "unfused": cuda_ms(lambda: TL._modraise_keyswitch(ka, c1p, c2p))}
    out["keyswitch"] = row
    log(f"whole windowed key switch at path (b): K5 + K6 + rescale {row['fused']:.4f} ms, "
        f"_modraise_keyswitch (K1 + torch) {row['unfused']:.4f} ms [{smi}]")
    return out


# ---------------------------------------------------------------------------
# the kernel A/B entry point (K2, K4)
# ---------------------------------------------------------------------------

K2_TOWERS = ((29, 29, 28, 28),) + PHASE3_TOWERS[1:] + ((29, 28),)   # primes < 2^30
BENCH_N, BENCH_LIMBS, BENCH_ROWS = 1 << 14, 8, 16     # tools.bench_kernels' defaults


def phase_k2_vs_plain(dev):
    from toyfhe_tpu_torch.ops import ntt as nttmod
    from toyfhe_tpu_torch.ops import ntt_mxu, ntt_mxu_pallas as mxp
    from toyfhe_tpu_torch.utils import numtheory as nt

    log("== phase 19: K2 (four-step digit transform) against its plain twin on the card")
    gen = torch.Generator(device=dev).manual_seed(19)
    err, ncase = 0, 0
    for n2 in (2, 8, 32, 64, 128):
        n = 128 * n2
        for tower in K2_TOWERS:
            tables = nttmod.NttTables(n, nt.ntt_prime_chain(n, tower))
            mt = ntt_mxu.MxuNttTables(tables)
            if not mt.paired_ok:
                raise AssertionError(f"paired bound fails at N={n} tower={tower}")
            psis = mxp.psi_table(mt, dev)
            L = len(tower)
            for rows in (1, 4, 16):
                a = random_residues(tables.primes, (rows,), n, gen, dev).transpose(0, 1).contiguous()
                x = a.reshape(L, rows, mxp.N1, n2)
                got = {pr: mxp.ntt_mxu_pallas(mt, x, psis, pr) for pr in (False, True)}
                want = {pr: mxp.ntt_mxu_pallas_plain(mt, x, psis, pr) for pr in (False, True)}
                nat = mxp.ntt_mxu_pallas_natural(mt, a)
                k1 = nttmod.ntt(tables, a.transpose(0, 1)).transpose(0, 1)
                sync(dev)
                for pr in (False, True):
                    err = max(err, int((got[pr] - want[pr]).abs().max()))
                if not (torch.equal(got[False], want[False]) and torch.equal(got[True], want[True])
                        and torch.equal(got[True], got[False]) and torch.equal(nat, k1)):
                    raise AssertionError(f"K2 != plain at N={n} tower={tower} rows={rows}")
                ncase += 1
        log(f"N={n:5d} (n2={n2:3d}): {len(K2_TOWERS)} towers x rows (1, 4, 16), 7-term and "
            f"paired bit-equal to the plain twin and to each other, natural order == K1")
    log(f"{ncase} cases: K2 == plain twin in both recombinations == K1")
    return err


def phase_k4_vs_plain(dev):
    from toyfhe_tpu_torch.ops import modmath
    from toyfhe_tpu_torch.ops import ntt as nttmod
    from toyfhe_tpu_torch.ops import ntt_pallas, ntt_pallas_cuda as k4c
    from toyfhe_tpu_torch.utils import numtheory as nt

    log("== phase 20: K4 (fused polynomial product) against its plain twin on the card: the "
        "cluster kernel as dispatched, at every legal cluster size with lazy and with fully "
        "reduced butterflies, and the one-block radix-2 kernel with and without the parked row")
    gen = torch.Generator(device=dev).manual_seed(20)
    err, ncase, nlaunch = 0, 0, 0
    for n in (16, 256, 4096, 8192, 16384, 32768):
        towers = PHASE3_TOWERS if n < 32768 else PHASE3_TOWERS[:2]
        legal = k4c.legal_polymul_clusters(n)
        for tower in towers:
            tables = nttmod.NttTables(n, nt.ntt_prime_chain(n, tower))
            pt = ntt_pallas.PallasNttTables(tables)
            lazy_ok = max(tables.primes) < k4c.LAZY_PRIME_LIMIT
            for rows in (1, 4, 16):
                a, b = (random_residues(tables.primes, (rows,), n, gen, dev)
                        .transpose(0, 1).contiguous() for _ in range(2))
                want = ntt_pallas.polymul_plain(pt, a, b)
                at, bt = a.transpose(0, 1), b.transpose(0, 1)
                k1 = nttmod.intt(tables, modmath.mul_mod(nttmod.ntt(tables, at),
                                                         nttmod.ntt(tables, bt), tables.mp))
                outs = {"dispatched": ntt_pallas.polymul_pallas_raw(pt, a, b),
                        "radix2 parked": k4c.launch_polymul(pt, a, b, park=True,
                                                            variant="radix2")}
                if n <= k4c.PARK_ABOVE:
                    outs["radix2"] = k4c.launch_polymul(pt, a, b, variant="radix2")
                for c in legal:
                    for lazy in ((False, True) if lazy_ok else (False,)):
                        outs[f"C={c} lazy={lazy}"] = k4c.launch_polymul(pt, a, b, cluster=c,
                                                                        lazy=lazy)
                sync(dev)
                for name, got in outs.items():
                    err = max(err, int((got - want).abs().max()))
                    if not torch.equal(got, want):
                        raise AssertionError(f"K4 {name} != plain at N={n} tower={tower} "
                                             f"rows={rows}")
                if not torch.equal(outs["dispatched"].transpose(0, 1), k1):
                    raise AssertionError(f"K4 != K1 product at N={n} tower={tower} rows={rows}")
                nlaunch += len(outs)
                ncase += 1
        log(f"N={n:5d}: {len(towers)} towers (lazy and full) x rows (1, 4, 16): dispatched, C in "
            f"{legal} x lazy / full, radix-2 with the parked row"
            f"{' and with two rows' if n <= k4c.PARK_ABOVE else ''} bit-equal to the plain twin; "
            f"dispatched == K1-inverse(K1(a) * K1(b))")
    log(f"{ncase} cases, {nlaunch} launches: every K4 variant == plain twin == unfused product "
        f"through K1")
    return err


def reset_ab_launches():
    from toyfhe_tpu_torch.ops import ntt_mxu_pallas_cuda, ntt_pallas_cuda
    ntt_mxu_pallas_cuda.launches["k2"] = 0
    ntt_pallas_cuda.polymul_launches["k4"] = 0


def read_ab_launches() -> dict:
    from toyfhe_tpu_torch.ops import ntt_mxu_pallas_cuda, ntt_pallas_cuda
    return {**ntt_mxu_pallas_cuda.launches, **ntt_pallas_cuda.polymul_launches}


SERVING_AB = (1 << 13, 7, 4)      # the serving transform shape: N, limbs, rows


def phase_bench_kernels(dev, smi):
    from toyfhe_tpu_torch.tools import bench_kernels

    log(f"== phase 21: the kernel A/B entry point at its full width (N={BENCH_N}, "
        f"{BENCH_LIMBS} limbs of 28 bits, {BENCH_ROWS} rows), CUDA events, median of {REPS} "
        f"after {WARMUP} warm-up; device = one call's share of a replayed graph of 50 [{smi}]")
    reset_launches()
    reset_ab_launches()
    res = bench_kernels.run(BENCH_N, BENCH_LIMBS, BENCH_ROWS, dev, REPS)     # the main path
    sync(dev)
    launches = {**read_launches(), **read_ab_launches()}
    log(f"one run launched {launches}")
    for k in ("fwd", "inv", "k2", "k4"):
        if launches[k] == 0:
            raise AssertionError(f"the A/B entry point never launched {k}")
    for ln in bench_kernels.report(res):
        log(f"{ln} [{smi}]")
    n, limbs, rows = SERVING_AB
    log(f"the same rows at the serving transform shape (N={n}, {limbs} limbs, {rows} rows):")
    serving = bench_kernels.run(n, limbs, rows, dev, REPS)
    for ln in bench_kernels.report(serving):
        log(f"{ln} [{smi}]")
    return res, launches


# (label, N, tower, lead): the small and the large end of the MNIST launches,
# the shape the kernels line times, and the A/B batch
DEVICE_TIME_SHAPES = (("12 x 2^13", 1 << 13, (28,) * 6, (2,)),
                      ("28 x 2^13", 1 << 13, (28,) * 7, (4,)),
                      ("196 x 2^12", 1 << 12, (28,) * 7, (28,)),
                      ("128 x 2^14", 1 << 14, (28,) * 8, (16,)))
B2B_LAUNCHES = 200


def back_to_back_ms(fn, count=B2B_LAUNCHES) -> float:
    """``count`` calls between one pair of events, per call: the larger of
    the device time and the host time of a call."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(count):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / count


def host_ms(fn, count=B2B_LAUNCHES) -> float:
    """Host clock per call with the device left to run behind: what a call
    costs the Python thread."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(count):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / count * 1e3


def four_times(*fns) -> list:
    """ms, b2b_ms, device_ms and host_ms of each function. Two functions are
    measured in turns (first, second, second, first) and each gets the mean
    of its two readings, so that neither has the quieter moment."""
    from toyfhe_tpu_torch.tools.bench_kernels import graph_ms
    order = fns if len(fns) == 1 else (fns[0], fns[1], fns[1], fns[0])
    meters = {"ms": cuda_ms, "b2b_ms": back_to_back_ms,
              "device_ms": lambda fn: graph_ms(fn, 100), "host_ms": host_ms}
    out = [{} for _ in fns]
    for key, meter in meters.items():
        readings = [(fns.index(fn), meter(fn)) for fn in order]
        for i, row in enumerate(out):
            row[key] = float(np.mean([v for j, v in readings if j == i]))
    return out


def phase_device_time(dev, smi):
    """Device time apart from wrapper time, for K1 (the cluster kernel and
    the one-block radix-2 kernel at the same shapes) and K2."""
    from toyfhe_tpu_torch.ops import ntt as nttmod
    from toyfhe_tpu_torch.ops import ntt_cuda, ntt_mxu, ntt_mxu_pallas as mxp
    from toyfhe_tpu_torch.ops import ntt_mxu_pallas_cuda as k2c
    from toyfhe_tpu_torch.utils import numtheory as nt

    log(f"== phase 24: device time and wrapper time of K1 and K2. ms: one launch between two "
        f"events, median of {REPS} (wrapper included); b2b: {B2B_LAUNCHES} launches between "
        f"one pair of events, per launch; device: one launch's share of a replayed CUDA graph "
        f"of 100; host: the Python thread's time a call; wrapper = ms - device; the two K1 "
        f"kernels in turns (new, old, old, new), means of two readings [{smi}]")
    gen = torch.Generator(device=dev).manual_seed(24)
    fmt = lambda t: (f"ms {t['ms']:.4f}, b2b {t['b2b_ms']:.4f}, device {t['device_ms']:.4f}, "
                     f"host {t['host_ms']:.4f}, wrapper {t['ms'] - t['device_ms']:.4f}")
    out = {}
    tiny = nttmod.NttTables(16, nt.ntt_prime_chain(16, (28,)))
    xt = random_residues(tiny.primes, (), 16, gen, dev)
    floor, = four_times(lambda: ntt_cuda.launch_cluster(tiny, xt, False, 1))
    log(f"floor, one polynomial of N=16 through the cluster kernel: {fmt(floor)} [{smi}]")
    out["floor"] = floor
    for label, n, tower, lead in DEVICE_TIME_SHAPES:
        tables = nttmod.NttTables(n, nt.ntt_prime_chain(n, tower))
        x = random_residues(tables.primes, lead, n, gen, dev)
        polys = x.numel() // n
        c, lazy = ntt_cuda.choose_cluster(polys, n, tables.primes)
        local, kf = ntt_cuda.schedule_plan(n.bit_length() - 1, c)
        shape = ntt_cuda.block_shape(n, c)
        log(f"K1 {label}: C={c}, lazy={lazy}, grid {polys * c} blocks x {shape['threads']} "
            f"threads, {shape['smem']} B shared memory a block, local passes {local} + closing "
            f"{kf} stages, {1 + len(local) + (c > 1)} barriers (radix-2: "
            f"{n.bit_length()}); registers " + ", ".join(
                f"{w} {ntt_cuda.kernel_attrs(kf, inv, lazy)['registers']}"
                for w, inv in (("fwd", False), ("inv", True))))
        for which, inverse in (("fwd", False), ("inv", True)):
            new, old = four_times(
                lambda: ntt_cuda.launch(tables, x, inverse),
                lambda: ntt_cuda.launch(tables, x, inverse, variant="radix2"))
            out[(label, which)] = {"new": new, "old": old, "cluster": c}
            log(f"  {which} cluster kernel: {fmt(new)} [{smi}]")
            log(f"  {which} one-block radix-2: {fmt(old)}; device time old / new "
                f"x{old['device_ms'] / new['device_ms']:.2f} [{smi}]")
    tables = nttmod.NttTables(BENCH_N, nt.ntt_prime_chain(BENCH_N, (28,) * BENCH_LIMBS))
    mt = ntt_mxu.MxuNttTables(tables)
    psis = mxp.psi_table(mt, dev)
    x = random_residues(tables.primes, (BENCH_ROWS,), BENCH_N, gen, dev).transpose(0, 1) \
        .contiguous().reshape(BENCH_LIMBS, BENCH_ROWS, mxp.N1, mt.n2)
    rpb = k2c.rows_per_block(BENCH_LIMBS, BENCH_ROWS)
    log(f"K2 128 x 2^14: grid {BENCH_LIMBS} x {-(-BENCH_ROWS // rpb)} blocks x 512 threads, "
        f"{rpb} row(s) a block, {k2c.block_smem(mt.n2)} B shared memory a block; registers "
        f"7-term {k2c.kernel_registers(False)}, paired {k2c.kernel_registers(True)}")
    for name, paired in (("paired", True), ("7-term", False)):
        t, = four_times(lambda: mxp.ntt_mxu_pallas(mt, x, psis, paired))
        out[("k2", name)] = t
        log(f"  {name}: {fmt(t)} [{smi}]")
    return out


# (label, N, limbs, rows): the A/B batch and the serving transform shape
K4_DEVICE_TIME_SHAPES = (("128 x 2^14", BENCH_N, BENCH_LIMBS, BENCH_ROWS),
                         ("28 x 2^13",) + SERVING_AB)


def phase_device_time_fused(dev, smi, kpath, k3row):
    """Phase 24, continued: device time apart from wrapper time for the
    fused kernels. K4, K6, K3 and K5 each beside the kernel it replaced, in
    turns, with the device time of every variant; the whole windowed key
    switch fused against unfused, in turns."""
    from toyfhe_tpu_torch.ops import hybrid_ks, hybrid_ks_cuda as k3c, modmath
    from toyfhe_tpu_torch.ops import ntt as nttmod
    from toyfhe_tpu_torch.ops import ntt_pallas, ntt_pallas_cuda as k4c
    from toyfhe_tpu_torch.ops import pallas_keyswitch_cuda as k6c
    from toyfhe_tpu_torch.parallel import layers as TL
    from toyfhe_tpu_torch.tools.bench_kernels import graph_ms
    from toyfhe_tpu_torch.utils import numtheory as nt

    log(f"== phase 24, continued: device time and wrapper time of K4, K6, K3 and K5 (the new "
        f"kernel and the kernel it replaced in turns: new, old, old, new), and of the whole "
        f"windowed key switch (K5 + K6 + rescale against K1 + torch, in turns); the same four "
        f"readings [{smi}]")
    gen = torch.Generator(device=dev).manual_seed(241)
    fmt = lambda t: (f"ms {t['ms']:.4f}, b2b {t['b2b_ms']:.4f}, device {t['device_ms']:.4f}, "
                     f"host {t['host_ms']:.4f}, wrapper {t['ms'] - t['device_ms']:.4f}")
    ratio = lambda new, old: f"device time old / new x{old['device_ms'] / new['device_ms']:.2f}"
    out = {}
    for label, n, limbs, rows in K4_DEVICE_TIME_SHAPES:
        tables = nttmod.NttTables(n, nt.ntt_prime_chain(n, (28,) * limbs))
        pt = ntt_pallas.PallasNttTables(tables)
        a, b = (random_residues(tables.primes, (rows,), n, gen, dev).transpose(0, 1).contiguous()
                for _ in range(2))
        c, lazy = k4c.choose_polymul_cluster(limbs * rows, n, tables.primes)
        plan, shape = k4c.polymul_plan(pt.logn, c), k4c.polymul_block_shape(n, c)
        log(f"K4 {label}: C={c}, lazy={lazy}, grid {limbs * rows * c} blocks x "
            f"{shape['threads']} threads, {shape['smem']} B shared memory a block, load pass "
            f"{plan['kl']} + DIF passes {plan['fwd']} + middle 3 | 3 + DIT passes {plan['bwd']} "
            f"+ closing {plan['kf']} stages, {k4c.plan_barriers(plan)} barriers (radix-2: "
            f"{3 * pt.logn + 3}); registers {k4c.polymul_attrs(c, lazy)['registers']}")
        new, old = four_times(lambda: ntt_pallas.polymul_pallas_raw(pt, a, b),
                              lambda: k4c.launch_polymul(pt, a, b, variant="radix2"))
        sweep = {f"C={x}{'' if lz else ' full'}": graph_ms(
            lambda: k4c.launch_polymul(pt, a, b, cluster=x, lazy=lz), 100)
            for x in k4c.legal_polymul_clusters(n) for lz in (True, False)}
        out[("k4", label)] = {"new": new, "old": old, "cluster": c, "sweep": sweep}
        log(f"  cluster kernel: {fmt(new)} [{smi}]")
        log(f"  one-block radix-2: {fmt(old)}; {ratio(new, old)} [{smi}]")
        log("  device ms at each cluster size, lazy and fully reduced: " +
            ", ".join(f"{k} {v:.4f}" for k, v in sweep.items()) + f" [{smi}]")

    fk, c2p, ka, c1p = (kpath[k] for k in ("fk", "c2p", "ka", "c1p"))
    c1e = random_residues(fk.pt.primes, (), fk.n, gen, dev)
    pairs = fk.Lc + 1
    g, lazy = k6c.choose_cluster(pairs, fk.n, fk.ndig, fk.pt.primes)
    plan, shape = k6c.keyswitch_plan(fk.logn, g), k6c.block_shape(fk.n)
    log(f"K6 path (b) (Lc={fk.Lc}, {fk.ndig} digits, N={fk.n}): G={g}, lazy={lazy}, grid "
        f"{pairs * g} blocks x {shape['threads']} threads, {shape['smem']} B shared memory a "
        f"block, {-(-fk.ndig // g)} or {fk.ndig // g} digits a block, a digit: load pass "
        f"{plan['kl']} + DIF passes {plan['fwd']} + last 3 with the key products "
        f"({k6c.acc_items(fk.n)} item(s) of accumulators in registers); an inverse over "
        f"{k6c.half(g)} blocks: DIT passes {plan['bwd']} + closing {plan['kf']}; registers "
        f"{k6c.kernel_attrs(fk.n, lazy)['registers']}")
    new, old = four_times(lambda: fk(c2p, c1e),
                          lambda: k6c.launch(fk, c2p, c1e, variant="loop"))
    sweep = {f"G={x}{'' if lz else ' full'}": graph_ms(
        lambda: k6c.launch(fk, c2p, c1e, cluster=x, lazy=lz), 100)
        for x in k6c.legal_clusters(fk.n, fk.ndig) for lz in (True, False)}
    out["k6"] = {"new": new, "old": old, "cluster": g, "sweep": sweep}
    log(f"  cluster kernel: {fmt(new)} [{smi}]")
    log(f"  one-block loop kernel: {fmt(old)}; {ratio(new, old)} [{smi}]")
    log("  device ms at each cluster size, lazy and fully reduced: " +
        ", ".join(f"{k} {v:.4f}" for k, v in sweep.items()) + f" [{smi}]")

    # K3: the serving gadget (R = 4 and R = 16) and bench.py's fixture
    out["k3"] = {}
    for label, cfg, rows in (("MNIST serving shape", HYBRID_CONFIGS[0], HYBRID_B),
                             ("bench.py's fixture", HYBRID_CONFIGS[2], HYBRID_B),
                             ("MNIST gadget, R=16", HYBRID_CONFIGS[0], 16)):
        if label == "MNIST serving shape":
            fks, y = k3row["fks"], k3row["y"]
        else:
            _, tower, dnum, k, lt = cfg
            params = hybrid_params(HYBRID_N, tower, dnum, k)
            fks = hybrid_ks.FusedHybridKS(params, synthetic_eval_key(params, 3, dev), lt=lt)
            y = random_residues(params.ring_cipher.primes[:lt], (rows,), HYBRID_N, gen, dev)
        T_, n, dn = fks.exp_ring.nlimbs, fks.exp_ring.n, fks.dnum_t
        scheme, g, lazy = k3c.choose_cluster(rows * T_, n, dn, fks.exp_ring.primes)
        plan = k3c.hybrid_ks_plan(n.bit_length() - 1, g, scheme)
        shape = k3c.block_shape(n, g, scheme)
        mangled = f"hybrid_ks_cluster_kernelILi{plan['kf']}ELb{int(lazy)}EE"
        log(f"K3 {label} (R={rows}, T={T_}, dnum={dn}, N={n}): {scheme} over {g}, lazy={lazy}, "
            f"grid {rows * T_ * g} blocks x {shape['threads']} threads, {shape['smem']} B shared "
            f"memory a block, {-(-dn // g) if scheme == 'digits' else dn} digit(s) a block, a "
            f"digit: load pass + DIT passes {plan['local']} + closing {plan['kf']} with the key "
            f"products, {shape['barriers']} barriers (loop kernel: {n.bit_length() + 1}); "
            f"registers {k3c.kernel_attrs(plan['kf'], lazy)['registers']}, spill stores "
            f"{k3c.LIB.spill_bytes(mangled)} B; bound {bound_k3(fks, rows)['bound_ms']:.5f} ms")
        new, old = four_times(lambda: fks(y), lambda: k3c.launch(fks, y, variant="loop"))
        sweep = {f"{sc} {x}{'' if lz else ' full'}": graph_ms(
            lambda: k3c.launch(fks, y, cluster=x, scheme=sc, lazy=lz), 100)
            for sc in k3c.SCHEMES for x in k3c.legal_clusters(n, dn, sc) for lz in (True, False)}
        out["k3"][label] = {"new": new, "old": old, "cluster": (scheme, g), "sweep": sweep}
        log(f"  cluster kernel: {fmt(new)} [{smi}]")
        log(f"  one-block loop kernel: {fmt(old)}; {ratio(new, old)} [{smi}]")
        log("  device ms, the digits or the polynomial over each cluster size, lazy and fully "
            "reduced: " + ", ".join(f"{k_} {v:.4f}" for k_, v in sweep.items()) + f" [{smi}]")

    # K5: path (b), the serving transform shape and the A/B batch
    out["k5"] = {}
    for label, n, limbs, rows in (("path (b), 8 x 2^13", fk.n, pairs, 1),
                                  ("28 x 2^13",) + SERVING_AB,
                                  ("128 x 2^14", BENCH_N, BENCH_LIMBS, BENCH_ROWS)):
        if label.startswith("path"):
            pt = fk.pt
        else:
            pt = ntt_pallas.PallasNttTables(
                nttmod.NttTables(n, nt.ntt_prime_chain(n, (28,) * limbs)))
        a5 = random_residues(pt.primes, (rows,), n, gen, dev).transpose(0, 1).contiguous()
        c, lazy = k4c.choose_bitrev_cluster(limbs * rows, n, pt.primes)
        plan, shape = k4c.bitrev_plan(pt.logn, c), k4c.bitrev_block_shape(n, c)
        mangled = f"ntt_bitrev_radix_kernelILi{c.bit_length() - 1}ELb{int(lazy)}EE"
        log(f"K5 {label}: C={c}, lazy={lazy}, grid {limbs * rows * c} independent blocks x "
            f"{shape['threads']} threads, {shape['smem']} B shared memory a block, load pass "
            f"{plan['kl']} (+ {c.bit_length() - 1} cross-block) + DIF passes {plan['fwd']} + last "
            f"3 stages, {shape['barriers']} barriers (radix-2: {pt.logn + 1}); registers "
            f"{k4c.bitrev_attrs(c, lazy)['registers']}, spill stores "
            f"{k4c.LIB.spill_bytes(mangled)} B; bound "
            f"{bound_transform(limbs * rows, limbs, n)['bound_ms']:.5f} ms")
        new, old = four_times(lambda: ntt_pallas.ntt_pallas_bitrev(pt, a5),
                              lambda: k4c.launch(pt, a5, variant="radix2"))
        sweep = {f"C={x}{'' if lz else ' full'}": graph_ms(
            lambda: k4c.launch(pt, a5, cluster=x, lazy=lz), 100)
            for x in k4c.legal_bitrev_clusters(n) for lz in (True, False)}
        out["k5"][label] = {"new": new, "old": old, "cluster": c, "sweep": sweep}
        log(f"  register-radix kernel: {fmt(new)} [{smi}]")
        log(f"  one-block radix-2: {fmt(old)}; {ratio(new, old)} [{smi}]")
        log("  device ms at each block count a polynomial, lazy and fully reduced: " +
            ", ".join(f"{k_} {v:.4f}" for k_, v in sweep.items()) + f" [{smi}]")

    fused_fn = lambda: TL._modraise_keyswitch_fused(ka, fk, c1p, c2p)

    def with_copies():
        """The fused key switch as it was glued before K5 took row-major
        batches: a limb-major copy in, a transposed view out."""
        c1x = torch.cat([modmath.mul_mod(c1p, ka.ps_res, ka.ct_ring.mp),
                         TL._special_zeros(c1p, ka)], -2)
        rows = c1x.reshape((-1,) + c1x.shape[-2:]).transpose(0, 1)
        c1e = ntt_pallas.ntt_pallas_bitrev(fk.pt, rows.contiguous()).transpose(0, 1)
        rescale = TL._ps_rescale(ka)
        return tuple(rescale(o) for o in fk(c2p, c1e.reshape(c1x.shape)))

    if not all(torch.equal(a, b) for a, b in zip(fused_fn(), with_copies())):
        raise AssertionError("the fused key switch differs from its limb-major gluing")
    fused, unfused = four_times(fused_fn, lambda: TL._modraise_keyswitch(ka, c1p, c2p))
    out["keyswitch"] = {"fused": fused, "unfused": unfused}
    log(f"whole windowed key switch at path (b), K5 + K6 + rescale: {fmt(fused)} [{smi}]")
    log(f"  _modraise_keyswitch (K1 + torch): {fmt(unfused)}; device time unfused / fused "
        f"x{unfused['device_ms'] / fused['device_ms']:.2f} [{smi}]")
    after, before = four_times(fused_fn, with_copies)
    out["keyswitch"].update(after=after, before=before)
    log(f"  K5 on the row-major batch as it lies (now) against a limb-major copy in and a "
        f"transposed result out (before), in turns: host ms a call {after['host_ms']:.4f} now, "
        f"{before['host_ms']:.4f} before; device ms {after['device_ms']:.4f} now, "
        f"{before['device_ms']:.4f} before [{smi}]")
    return out


# ---------------------------------------------------------------------------
# the production serving configuration: hoisted rotations, BSGS + dual flow
# ---------------------------------------------------------------------------

HOIST_STEPS = (64, 128, 512)      # two baby steps and a giant step of the MNIST dense layers


def galois_keys_to(gks, device):
    import toyfhe_tpu_torch as T
    return T.GaloisKeys([eval_key_to(k, device) for k in gks.keys])


def ciphertext_to(c, device):
    import toyfhe_tpu_torch as T
    mv = lambda x: T.RingElt(primal=None if x.primal is None else x.primal.to(device),
                             dual=None if x.dual is None else x.dual.to(device))
    return T.CipherText(c.params, tuple(mv(x) for x in c.cs), c.ring, enc=c.enc)


def phase_hoisted_rotations(dev):
    """``rotate_many`` / ``rotate_sum`` with real keys under the serving
    gadget: the card against the CPU bit for bit, and the decoded slots."""
    import toyfhe_tpu_torch as T
    from toyfhe_tpu_torch.core import rlwe

    name, tower, dnum, k, _ = HYBRID_CONFIGS[0]
    log(f"== phase 22: hoisted rotations with real keys under the serving gadget "
        f"(N={HYBRID_N}, {tower}, dnum={dnum}, k={k}, steps {HOIST_STEPS})")
    params = hybrid_params(HYBRID_N, tower, dnum, k)
    gen = torch.Generator(device=dev).manual_seed(22)
    t0 = time.perf_counter()
    kp = T.keygen(params, gen)
    gks = T.keygen_galois_set(gen, kp.priv, HOIST_STEPS)
    els = [T.galois_element_for_steps(HYBRID_N, s) for s in HOIST_STEPS]
    vals = np.linspace(0.1, 1.0, HYBRID_N // 2)
    c = T.encrypt(kp, T.make_plaintext(params.ring_cipher, vals, Fraction(2) ** 45), gen)
    sync(dev)
    log(f"keygen + {len(gks.keys)} Galois keys + encryption: {time.perf_counter() - t0:.2f} s "
        f"(host clock)")
    gks_cpu, c_cpu = galois_keys_to(gks, "cpu"), ciphertext_to(c, "cpu")
    terms = lambda ct: [(None, ct)] + [(g, ct) for g in els]

    for key in rlwe.hoist_counts:
        rlwe.hoist_counts[key] = 0
    reset_launches()
    many = T.rotate_many(gks, c, els)
    lazy = T.rotate_sum(gks, terms(c))
    sync(dev)
    counts, launches = dict(rlwe.hoist_counts), read_launches()
    want = {"decompositions": 1 + 3, "decompose_calls": 1 + 3,
            "key_products": 3 + 3, "key_product_calls": 3 + 3}
    log(f"rotate_many of 3 + rotate_sum of identity + 3: {counts}; K1 launches "
        f"{launches['fwd']} forward + {launches['inv']} inverse")
    if counts != want:
        raise AssertionError(f"hoisting counts {counts}, expected {want}")
    many_cpu = T.rotate_many(gks_cpu, c_cpu, els)
    lazy_cpu = T.rotate_sum(gks_cpu, terms(c_cpu))
    same = lambda a, b: all(torch.equal(T.ringops.ensure_dual(a.ring, x).dual.cpu(),
                                        T.ringops.ensure_dual(b.ring, y).dual)
                            for x, y in zip(a.cs, b.cs))
    if not (all(same(many[g], many_cpu[g]) for g in els) and same(lazy, lazy_cpu)):
        raise AssertionError("hoisted rotations on the card differ from the CPU")
    log("rotate_many and rotate_sum on the card == on the CPU")
    worst = 0.0
    for s, g in zip(HOIST_STEPS, els):
        got = T.decrypt(kp, many[g]).real
        ref = T.decrypt(kp, T.rotate(gks, c, steps=s)).real
        worst = max(worst, float(np.max(np.abs(got - np.roll(vals, s)))),
                    float(np.max(np.abs(got - ref))))
    log(f"decoded np.roll(vals, s) for each step, and against per-rotation rotate: max abs "
        f"error {worst:.3e} (limit {DECODE_ATOL})")
    expect = vals + sum(np.roll(vals, s) for s in HOIST_STEPS)
    err_sum = float(np.max(np.abs(T.decrypt(kp, lazy).real - expect)))
    log(f"decoded the sum of the identity and the three rotations: max abs error "
        f"{err_sum:.3e} (limit {4 * DECODE_ATOL})")
    if not (worst < DECODE_ATOL and err_sum < 4 * DECODE_ATOL):
        raise AssertionError(f"hoisted rotation decode error {worst} / {err_sum}")
    return dict(decode_err=worst, sum_err=err_sum)


def bsgs_counts(cfg) -> dict:
    """Ciphertext decompositions and key products, and the calls that make
    them, of one batch on the BSGS schedule: dense 1 hoists its channels as
    one batched ciphertext (one decomposition each) and merges their giant
    steps; dense 2 is one ciphertext."""
    from toyfhe_tpu_torch.core.bootstrap import bsgs_split
    bs, gs = bsgs_split(cfg.positions)
    nb, ng = bs - 1, gs - 1
    return {"decompositions": cfg.channels + ng + 1 + ng, "decompose_calls": 2 * (1 + ng),
            "key_products": cfg.channels * nb + ng + nb + ng,
            "key_product_calls": 2 * (nb + ng)}


def bsgs_pipeline_launches(cfg, params) -> dict:
    """K1 launches of one batch of the BSGS + dual-flow pipeline:
    encryption 2 forward; the dual rescales of conv and bias 1 + 1 each; each
    fused square 2 + 2; each dense layer one inverse per decomposition and
    one forward per digit group of it, one inverse and one forward per
    stacked contraction (each baby rotation, and the layer's one lazy
    ModDown); decryption 1 + 1."""
    from toyfhe_tpu_torch.core.bootstrap import bsgs_split
    bs, gs = bsgs_split(cfg.positions)
    nb, ng = bs - 1, gs - 1
    lc = params.ring_cipher.nlimbs
    fwd, inv = 2 + 1 + 2 * 2 + 1 + 1, 1 + 2 * 2 + 1 + 1
    for lt in (lc - 2, lc - 4):                          # the towers of dense 1 and dense 2
        ndig = -(-lt // params.alpha)
        fwd += (1 + ng) * ndig + nb + 1
        inv += (1 + ng) + nb + 1
    return {"fwd": fwd, "inv": inv, "k3": 0, "k5": 0, "k6": 0}


def phase_bsgs_pipeline(dev, smi, base):
    """The serving pipeline of phase 17 again with BSGS keys and the default
    dual flow, on the same setup, weights, images and encryption seed."""
    from toyfhe_tpu_torch.core import rlwe
    from toyfhe_tpu_torch.models import mnist as M
    from toyfhe_tpu_torch.ops import ntt_cuda

    cfg, setup, weights, imgs, gen = (base[k] for k in ("cfg", "setup", "weights", "imgs", "gen"))
    baby, giant = M.bsgs_steps(cfg)
    log(f"== phase 23: the production serving configuration, BSGS dense layers + dual flow, at "
        f"the same MNISTConfig ({len(baby)} baby + {len(giant)} giant Galois keys, "
        f"{cfg.batch} images)")
    t0 = time.perf_counter()
    gks = M.keygen_matmul_bsgs(setup, gen)
    sync(dev)
    key_mb = sum(2 * c.mask.primal.numel() * 8 for k in gks.keys for c in k.key.key) / 2 ** 20
    log(f"keygen_matmul_bsgs: {len(gks.keys)} keys, {key_mb:.1f} MiB as int64, "
        f"{time.perf_counter() - t0:.2f} s (host clock)")
    t0 = time.perf_counter()
    M.encrypted_inference_fast(setup, weights, imgs, gen, gks_bsgs=gks)
    sync(dev)
    log(f"build (layers, diagonal encodings) + first batch: {time.perf_counter() - t0:.2f} s "
        f"(host clock)")

    for key in rlwe.hoist_counts:
        rlwe.hoist_counts[key] = 0
    reset_launches()
    logits = M.encrypted_inference_fast(                                  # the main path
        setup, weights, imgs, torch.Generator(device=dev).manual_seed(PIPE_ENC_SEED),
        gks_bsgs=gks).T
    sync(dev)
    launches, counts = read_launches(), dict(rlwe.hoist_counts)
    transforms = dict(ntt_cuda.transforms)
    log(f"one batch launched {launches}; K1 limb transforms {transforms['fwd']} forward + "
        f"{transforms['inv']} inverse; {counts}")
    want_l, want_c = bsgs_pipeline_launches(cfg, setup.params), bsgs_counts(cfg)
    if launches != want_l:
        raise AssertionError(f"BSGS pipeline launched {launches}, expected {want_l}")
    if counts != want_c:
        raise AssertionError(f"BSGS pipeline counts {counts}, expected {want_c}")
    plain = base["plain"]
    if logits.shape != (cfg.batch, cfg.classes) or not np.all(np.isfinite(logits)):
        raise AssertionError(f"bad logits: shape {logits.shape} or non-finite values")
    err = float(np.max(np.abs(logits - plain)))
    diff = float(np.max(np.abs(logits - base["logits"])))
    top2 = np.sort(plain, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * err
    agree = np.argmax(logits, -1) == np.argmax(plain, -1)
    log(f"logits vs model_forward: max abs error {err:.3e} (limit 0.5); vs the iterated "
        f"pipeline on the same encrypted grid: {diff:.3e} (limit 1e-2); labels agree on "
        f"{int(agree.sum())}/{cfg.batch} images and on {int(agree[clear].sum())} of the "
        f"{int(clear.sum())} with a clear plaintext margin")
    if not (err < 0.5 and diff < 1e-2):
        raise AssertionError(f"logit error {err} or distance to the iterated pipeline {diff}")
    if not agree[clear].all():
        raise AssertionError("a label differs on an image with a clear plaintext margin")

    ms, walls, layers = time_pipeline(setup._pipeline, imgs, gen, dev)
    log(f"warm batch: {ms:.1f} ms/batch (median of {PIPE_REPS}: "
        f"{', '.join(f'{w:.1f}' for w in walls)}), {cfg.batch * 1e3 / ms:.1f} images/s; the "
        f"iterated schedule in this call: {base['ms']:.1f} ms/batch [{smi}]")
    log("per stage, BSGS + dual flow / iterated (median ms, synchronised between stages): " +
        ", ".join(f"{k} {v:.2f} / {base['layers'][k]:.2f}" for k, v in layers.items())
        + f" [{smi}]")
    return dict(launches=launches, transforms=transforms, counts=counts, err=err, diff=diff,
                ms=ms, layers=layers)


# ---------------------------------------------------------------------------
# the least time the card could take (the kernels line's bound_ms)
# ---------------------------------------------------------------------------

# Published peaks of one H100 SXM: device-memory rate, the int8 tensor-core
# rate (K2's digit products are int8 multiply-adds) and, for 32-bit integer
# work on the CUDA cores, the non-tensor float32 rate (NVIDIA publishes no
# separate integer figure; the integer lanes are no faster, so the bound
# stays a lower bound).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
ALU32_OPS_PER_S = 67e12
MONT_OPS = 5           # three 32-bit multiplies, an add and a conditional subtract
MODADD_OPS = 2
BUTTERFLY_OPS = MONT_OPS + 2 * MODADD_OPS
RESIDUE_BYTES = 8      # residues travel as int64


def stage_ops(n: int) -> int:
    """32-bit operations of the log2 N radix-2 stages of one polynomial."""
    return n // 2 * (n.bit_length() - 1) * BUTTERFLY_OPS


def bound(nbytes: float, ops32: float, ops8: float = 0.0) -> dict:
    """bound_ms and bound_by from the bytes a call must move (each input
    read once, each output written once) and the operations it does."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(ops32 / ALU32_OPS_PER_S, ops8 / INT8_OPS_PER_S)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bound_transform(polys: int, limbs: int, n: int) -> dict:
    """K1 / K5: residues in and out, the twist and stage-twiddle rows."""
    nbytes = 2 * polys * n * RESIDUE_BYTES + 2 * limbs * n * 4 + limbs * 8
    return bound(nbytes, polys * (stage_ops(n) + n * MONT_OPS))


def bound_k2(limbs: int, rows: int, n: int) -> dict:
    polys, n2 = limbs * rows, n // 128
    nbytes = ((2 * polys + limbs) * n * RESIDUE_BYTES            # x, out, psis
              + limbs * 4 * (128 * 128 + n2 * n2) + limbs * n * 4 + limbs * 64)
    macs = polys * (128 + n2) * n * 16                           # int8 multiply-adds
    ops32 = polys * n * (2 * MONT_OPS + 2 * (7 + 2 * MONT_OPS + 2 * MODADD_OPS + 8))
    return bound(nbytes, ops32, 2 * macs)


def bound_k4(limbs: int, rows: int, n: int) -> dict:
    polys = limbs * rows
    nbytes = 3 * polys * n * RESIDUE_BYTES + 4 * limbs * n * 4 + limbs * 12
    return bound(nbytes, polys * (3 * stage_ops(n) + 5 * n * MONT_OPS))


def bound_k3(fks, rows: int) -> dict:
    T, n = fks.exp_ring.nlimbs, fks.exp_ring.n
    widths = [hi - lo for lo, hi in fks.bounds]
    nbytes = ((rows * fks.lt + 2 * rows * T + 2 * fks.dnum_t * T) * n * RESIDUE_BYTES
              + 2 * T * n * 4 + fks.dnum_t * T * fks.alpha * 4)
    ops = rows * T * sum(n * a * (MONT_OPS + MODADD_OPS) + stage_ops(n)
                         + 2 * n * (MONT_OPS + MODADD_OPS) for a in widths)
    return bound(nbytes, ops)


def bound_k6(fk, lead: int = 1) -> dict:
    Le, n, ndig = fk.Lc + 1, fk.n, fk.ndig
    nbytes = ((lead * (fk.Lc + 3 * Le) + 2 * ndig * Le) * n * RESIDUE_BYTES + 4 * Le * n * 4)
    ops = lead * Le * (ndig * (n * (2 + 2 * MONT_OPS) + stage_ops(n)
                               + 2 * n * (MONT_OPS + MODADD_OPS))
                       + 2 * (stage_ops(n) + n * MONT_OPS))
    return bound(nbytes, ops)


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

    k5_err = phase_k5_vs_plain(dev)
    k6_err = phase_k6_vs_plain(dev)
    kpath = phase_k6_path(dev)
    phase_layers(dev, kpath)
    pipe = phase_mnist_pipeline(dev, smi)
    k56 = phase_k5_k6_timing(dev, smi, kpath)

    k2_err = phase_k2_vs_plain(dev)
    k4_err = phase_k4_vs_plain(dev)
    ab, ab_launches = phase_bench_kernels(dev, smi)
    hoist = phase_hoisted_rotations(dev)
    bsgs = phase_bsgs_pipeline(dev, smi, pipe)
    dtime = phase_device_time(dev, smi)
    dtime.update(phase_device_time_fused(dev, smi, kpath, k3_times["mnist"]))

    # No single PyTorch call computes a modular transform, a modular
    # polynomial product or a key switch, so library_ms is null in every row.
    shape = "B*L=28, N=2^13"
    kernels = [
        {"name": f"k1_ntt_{k}", "route": "cuda", "source": "toyfhe_tpu_torch/csrc/ntt.cu",
         "replaces": f"toyfhe_tpu/ops/ntt_mxu_pallas.py:{line}",
         "launches": pipe["launches"][k], "max_abs_err": err[k],
         "ms": times[shape][k], "device_ms": dtime[("28 x 2^13", k)]["new"]["device_ms"],
         "plain_ms": times[shape][f"{k}_plain"],
         **bound_transform(28, 7, 1 << 13), "library_ms": None}
        for k, line in (("fwd", 242), ("inv", 255))]
    ab_rows = ab["rows_ms"]
    kernels.append(
        {"name": "k2_ntt_mxu", "route": "cuda", "source": "toyfhe_tpu_torch/csrc/ntt_mxu.cu",
         "replaces": "toyfhe_tpu/ops/ntt_mxu_pallas.py:153",
         "launches": ab_launches["k2"], "max_abs_err": k2_err,
         "ms": ab_rows["k2_paired"]["ms"], "device_ms": dtime[("k2", "paired")]["device_ms"],
         "plain_ms": ab_rows["k2_paired"]["plain_ms"],
         **bound_k2(BENCH_LIMBS, BENCH_ROWS, BENCH_N), "library_ms": None})
    kernels.append(
        {"name": "k3_hybrid_ks", "route": "cuda", "source": "toyfhe_tpu_torch/csrc/hybrid_ks.cu",
         "replaces": "toyfhe_tpu/ops/pallas_hybrid_ks.py:47",
         "launches": hybrid_launches["k3"], "max_abs_err": k3_err,
         "ms": k3_times["mnist"]["kernel"],
         "device_ms": dtime["k3"]["MNIST serving shape"]["new"]["device_ms"],
         "plain_ms": k3_times["mnist"]["plain"],
         **bound_k3(k3_times["mnist"]["fks"], HYBRID_B), "library_ms": None})
    kernels.append(
        {"name": "k4_polymul", "route": "cuda", "source": "toyfhe_tpu_torch/csrc/polymul.cu",
         "replaces": "toyfhe_tpu/ops/ntt_pallas.py:180",
         "launches": ab_launches["k4"], "max_abs_err": k4_err,
         "ms": ab_rows["polymul_k4"]["ms"],
         "device_ms": dtime[("k4", "128 x 2^14")]["new"]["device_ms"],
         "plain_ms": ab_rows["polymul_k4"]["plain_ms"],
         **bound_k4(BENCH_LIMBS, BENCH_ROWS, BENCH_N), "library_ms": None})
    k5_row = k56[("k5", "path (b): 8 limbs x 1 row")]
    kernels.append(
        {"name": "k5_ntt_bitrev", "route": "cuda", "source": "toyfhe_tpu_torch/csrc/ntt_bitrev.cu",
         "replaces": "toyfhe_tpu/ops/ntt_pallas.py:246",
         "launches": kpath["launches"]["k5"], "max_abs_err": k5_err,
         "ms": k5_row["kernel"],
         "device_ms": dtime["k5"]["path (b), 8 x 2^13"]["new"]["device_ms"],
         "plain_ms": k5_row["plain"],
         **bound_transform(len(K6_TOWER), len(K6_TOWER), K6_N), "library_ms": None})
    kernels.append(
        {"name": "k6_fused_keyswitch", "route": "cuda", "source": "toyfhe_tpu_torch/csrc/keyswitch.cu",
         "replaces": "toyfhe_tpu/ops/pallas_keyswitch.py:40",
         "launches": kpath["launches"]["k6"], "max_abs_err": k6_err,
         "ms": k56["k6"]["kernel"], "device_ms": dtime["k6"]["new"]["device_ms"],
         "plain_ms": k56["k6"]["plain"],
         **bound_k6(kpath["fk"]), "library_ms": None})
    log(f"== summary: MNIST pipeline {pipe['ms']:.1f} ms per {pipe['batch']}-image batch on the "
        f"iterated schedule (K1 {pipe['launches']['fwd']} + {pipe['launches']['inv']} launches, "
        f"logit error {pipe['err']:.3e}), {bsgs['ms']:.1f} ms with BSGS + dual flow (K1 "
        f"{bsgs['launches']['fwd']} + {bsgs['launches']['inv']} launches, "
        f"{bsgs['counts']['key_products']} key products, {bsgs['counts']['decompositions']} "
        f"decompositions, logit error {bsgs['err']:.3e}); rotation decode error "
        f"{kpath['decode_err']:.3e}, hoisted {hoist['decode_err']:.3e}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
