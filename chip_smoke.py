#!/usr/bin/env python3
"""On-card smoke run of the toyfhe_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S]

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
  CUDA graph, and the host's time a call;
* CKKS bootstrapping: a small refresh (N = 2^10 on the production 55-limb
  tower) on the card bit-equal to the CPU stage by stage (ModRaise, CoeffToSlot, EvalMod,
  SlotToCoeff, the whole); one refresh at the full width of the
  bootstrapped MNIST configuration (N = 2^13, 55 limbs, the hybrid gadget
  with dnum = 9, 26 rotation keys), cold and warm with each phase's time,
  levels regained and error, and the batch of two bit-equal to the singles;
  then the bootstrapped encrypted-MNIST pipeline at ``MNISTConfig()`` on a
  depth-46 tower (conv → square → dense 1 → square → exhaust → refresh →
  dense 2), its logits held against the plaintext pass, its K1 launches
  counted and its stages timed (every transform of these paths is K1);
* the exact schemes (every transform K1 again): K1 bit-equal to its plain
  twin in every variant at their towers (the 16-limb BEHZ tower of
  ``bfv_params(65537, eval_mult_count=4)`` at the product tree's batches,
  the 17-bit plaintext slot ring, the ``bfv_crt`` towers past 2^30, the
  BGV towers and their drops) and the golden scenarios ``bfv_triv``,
  ``bfv_keyswitch``, ``bfv_simd``, ``bgv_triv`` and ``bfv_crt`` decoded
  exactly on the card; SIMD BFV at N = 2^13: a depth-4 product tree over 16
  ciphertexts (keys made on the CPU, slot vectors and encryptions from
  ``--seed``), each level one batched BEHZ multiply and one
  relinearization, card == CPU and the noise budget read at every level,
  the last slots equal to the numpy product; leveled BGV at N = 2^13
  (tower (28,)×5 + (30, 30), p = 65537): square → key switch → rescale, 3
  levels under ModulusRaised and 2 under HybridRaised(3, 2), card == CPU
  and the slots exact at every level;
* the host side: the exact host RLWE engine (Python integers, the
  Kronecker-substitution multiply) as the card's oracle at the serving data
  tower (N = 2^13, seven 28-bit limbs, the RNS-limb gadget): it makes a
  secret, an eval key and an encryption of 4096 slots, squares, key-switches
  and rescales, and the card, given the same secret, ciphertext and eval
  key, must decrypt its own square → key switch → rescale to the host's raw
  integers exactly; the C++ CRT (``toyfhe_tpu_torch/native``, built with
  g++) decoding the production MNIST logits ciphertext, the last BFV level
  and the last BGV levels exactly as the Python CRT does; the production
  BSGS setup (key pair, relinearization key, 14 Galois keys, an input
  ciphertext) saved to files and loaded back onto the card, the pipeline on
  the loaded keys giving the logits ciphertext of the original keys bit for
  bit; plaintext training at ``MNISTConfig()`` on the card (300 steps, the
  reference's recipe, held-out accuracy > 0.9; three updates equal to the
  same updates on the CPU), then the trained weights served encrypted
  through the BSGS + dual-flow pipeline (labels equal to the plaintext
  pass's on at least 62 of 64 images);
* the sharded paths (``parallel/sharding.py``, ``parallel/distributed.py``,
  every per-shard transform K1): every sharded entry point over a mesh of
  one rank in this process, then 8 gloo ranks spawned on the same card
  (``parallel/launch.py``): ``make_sharded_step`` at N = 2^13, eight 28-bit
  limbs, batch 4 over dp 2 x rp 4, the hybrid steps (v1 and the fused
  schedule) at the serving gadget's 6-limb level over rp 2 and rp 3,
  ``make_2axis_step`` at N = 2^13 over rp 2 x cp 2, each bit-equal to the
  single-device step on the card, its dropped limb zero and its collective
  counter equal to the communication model, K1 counted per rank; the
  encrypted-MNIST pipeline at ``MNISTConfig()`` (BSGS + dual flow) over dp 2
  x rp 2, its logits ciphertext on every rank bit-equal to the
  single-device pipeline's; and ``tools.dryrun.dryrun_multihost(2)``.

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

import argparse
import hashlib
import json
import os
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
K1_SWEEP_LEADS = ((), (4,), (4, 7), (16,))
# The bootstrapped path's own K1 shapes at N = 2^13 on the production tower
# (``bootstrap.make_boot_ring(8192, 46, 7)``: 2 x 29-bit base, 46 balanced
# 26-bit levels, 7 x 29-bit raising primes): the raised 55-limb tower with
# its 9 digits alone and for 4 stacked ciphertexts, and the 48-limb
# ciphertext tower as the refresh's batch of 2 x 2 x 4 chains and the
# encryptor's 49 x 3 polynomials hold it.
K1_BOOT_CASES = ((55, ((9,), (4, 9))), (48, ((2, 2, 4), (49, 3))))


def k1_sweep_cases():
    """(N, tower label, primes, leads) of phase 3: the small towers at every
    size, then the production bootstrap tower at the main path's shapes."""
    from toyfhe_tpu_torch.core import bootstrap as B
    from toyfhe_tpu_torch.utils import numtheory as nt

    cases = [(n, tower, nt.ntt_prime_chain(n, tower), K1_SWEEP_LEADS)
             for n in (256, 4096, 8192, 16384) for tower in K1_SWEEP_TOWERS]
    boot = B.make_boot_ring(8192, 46, 7).primes
    cases += [(8192, f"boot[:{limbs}]", boot[:limbs], leads)
              for limbs, leads in K1_BOOT_CASES]
    return cases


def phase_kernel_vs_plain(dev):
    """K1 against its plain twin: the kernel every caller gets, the cluster
    kernel at every legal cluster size with lazy and with fully reduced
    butterflies (a tower with a prime in [2^30, 2^31) takes only the latter),
    and the one-block radix-2 kernel; on small towers and on the production
    bootstrap tower at the bootstrapped path's own polynomial counts."""
    log("== phase 3: K1 against plain radix-2 on the card: the cluster kernel at every legal "
        "cluster size, lazy and fully reduced, and the one-block radix-2 kernel")
    gen = torch.Generator(device=dev).manual_seed(3)
    err = {"fwd": 0, "inv": 0}
    k1_check(dev, k1_sweep_cases(), gen, err)
    return err


def k1_check(dev, cases, gen, err):
    """Every K1 variant against the plain twin over ``cases`` (N, tower
    label, primes, leads): as dispatched, the radix-2 kernel and the cluster
    kernel at every legal cluster size, lazy and fully reduced where the
    tower allows lazy; then the round trip. Raises on the first difference,
    keeps the largest difference in ``err``."""
    from toyfhe_tpu_torch.ops import ntt as nttmod
    from toyfhe_tpu_torch.ops import ntt_cuda

    ncase = nlaunch = 0
    for n, tower, primes, leads in cases:
        tables = nttmod.NttTables(n, primes)
        can_lazy = max(tables.primes) < ntt_cuda.LAZY_PRIME_LIMIT
        variants = [(c, lz) for c in ntt_cuda.legal_clusters(n)
                    for lz in ((True, False) if can_lazy else (False,))]
        picks = []
        for lead in leads:
            x = random_residues(tables.primes, lead, n, gen, dev)
            polys = x.numel() // n
            picks.append(f"C={ntt_cuda.choose_cluster(polys, n, tables.primes)[0]} "
                         f"for {polys}")
            for which, inverse, plain in (("fwd", False, nttmod.ntt_plain),
                                          ("inv", True, nttmod.intt_plain)):
                want = plain(tables, x)
                names = ["default", "radix2"] + [f"C={c} lazy={lz}" for c, lz in variants]
                for i, what in enumerate(names):
                    if i == 0:
                        g = nttmod.intt(tables, x) if inverse else nttmod.ntt(tables, x)
                    elif i == 1:
                        g = ntt_cuda.launch(tables, x, inverse, variant="radix2")
                    else:
                        g = ntt_cuda.launch_cluster(tables, x, inverse, *variants[i - 2])
                    torch.cuda.synchronize()
                    nlaunch += 1
                    err[which] = max(err[which], int((g - want).abs().max()))
                    if not torch.equal(g, want):
                        raise AssertionError(f"K1 {what} != plain at N={n} tower={tower} "
                                             f"lead={lead} {which}")
                    del g
                del want
            back = nttmod.intt(tables, nttmod.ntt(tables, x))
            if not torch.equal(back, x):
                raise AssertionError(f"round trip at N={n} tower={tower} lead={lead}")
            del x, back
            ncase += 1
        log(f"N={n:5d} tower={tower} ({len(primes)} limbs, "
            f"{min(primes).bit_length()}-{max(primes).bit_length()} bit): leads {list(leads)}, "
            f"clusters {ntt_cuda.legal_clusters(n)} x "
            f"{'lazy and full' if can_lazy else 'full (a prime >= 2^30)'} + radix-2 + the "
            f"chooser's pick ({', '.join(picks)} polynomials): bit-equal, round trip exact")
    log(f"{ncase} cases, {nlaunch} launches: every K1 variant == plain, intt(ntt(x)) == x")


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
    from toyfhe_tpu_torch.utils.interop import to_device
    import toyfhe_tpu_torch as T

    log(f"== phase 9: hybrid steps with real keys at the MNIST serving shape "
        f"(N={HYBRID_N}, {HYBRID_CONFIGS[0][1]}, dnum=2, k=4, batch {HYBRID_B})")
    params, kp, ek, batch7, vals, scale = _mnist_fixture(dev)
    ek_cpu = to_device(ek, "cpu")
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
    from toyfhe_tpu_torch.utils.interop import to_device
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
    cpu = flavour_steps(params, to_device(ek, "cpu"), params.ring_cipher)["v1"](batch.cpu())
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
    from toyfhe_tpu_torch.utils.interop import to_device
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
    ka_cpu = TL.build_modraise_key_arrays(params, to_device(gk, "cpu").key)
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
    from toyfhe_tpu_torch.utils.interop import to_device
    from toyfhe_tpu_torch.parallel import layers as TL

    dev = gen.device
    rot = {dv: TL.RotateMatmulLayer(params, k, gk.galois_element, d, rot_ring)
           for dv, k in ((dev, gk), ("cpu", to_device(gk, "cpu")))}
    sq = {dv: TL.SquareRelinLayer(params, k, sq_ring)
          for dv, k in ((dev, ek), ("cpu", to_device(ek, "cpu")))}
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


def phase_hoisted_rotations(dev):
    """``rotate_many`` / ``rotate_sum`` with real keys under the serving
    gadget: the card against the CPU bit for bit, and the decoded slots."""
    from toyfhe_tpu_torch.utils.interop import to_device
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
    gks_cpu, c_cpu = to_device(gks, "cpu"), to_device(c, "cpu")
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
                ms=ms, layers=layers, gks=gks)


# ---------------------------------------------------------------------------
# CKKS bootstrapping and the bootstrapped encrypted-MNIST pipeline
# ---------------------------------------------------------------------------

BOOT_SCALE = Fraction(2) ** 52            # the composite base scale (two 26-bit levels)
BOOT_SMALL_LOGN = 10                      # phase 25: N = 2^10 on the production tower
BOOT_REPS = 3


def boot_recipe():
    """``mnist.BOOTSTRAPPED_RECIPE``: the production composite recipe."""
    from toyfhe_tpu_torch.models import mnist as M
    return dict(M.BOOTSTRAPPED_RECIPE)


def boot_vals(h, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, h) + 1j * rng.uniform(-1, 1, h)) * 0.7


def boot_exhausted(setup_params, kp, vals, gen):
    """An encryption of ``vals`` at the composite base scale, exhausted to
    the two base limbs."""
    import toyfhe_tpu_torch as T
    from toyfhe_tpu_torch.core import ckks_encoding as CE
    c = T.encrypt(kp, T.make_plaintext(setup_params.ring_cipher, vals, BOOT_SCALE), gen)
    return CE.ct_drop_to(c, 2)


def same_ct(a, b) -> bool:
    """Same tower, scale tag and residues (compared on the CPU)."""
    import toyfhe_tpu_torch as T
    if a.ring is not b.ring or a.enc != b.enc or len(a.cs) != len(b.cs):
        return False
    return all(torch.equal(T.ringops.ensure_dual(a.ring, x).dual.cpu(),
                           T.ringops.ensure_dual(b.ring, y).dual.cpu())
               for x, y in zip(a.cs, b.cs))


def non_k1_launches(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if k not in ("fwd", "inv") and v}


def key_bytes(*keys) -> int:
    """Device bytes of key-switching keys (every held domain)."""
    total = 0
    for k in keys:
        for gk in getattr(k, "keys", [k]):
            for c in gk.key.key:
                for e in (c.mask, c.masked):
                    total += sum(t.numel() * t.element_size() for t in (e.primal, e.dual)
                                 if t is not None)
    return total


def cache_bytes(ctx) -> int:
    return sum(t.numel() * t.element_size() for e in ctx.plain_cache.values()
               for t in (e.primal, e.dual) if t is not None)


def refresh_phases(ctx, c, dev):
    """One refresh through its three phases; (out, (ms of each phase))."""
    from toyfhe_tpu_torch.core import bootstrap as B
    marks = [time.perf_counter()]

    def mark():
        sync(dev)
        marks.append(time.perf_counter())

    lo, hi = B.bootstrap_phase1(ctx, c)
    mark()
    ev = B.bootstrap_phase2(ctx, lo, hi)
    mark()
    out = B.bootstrap_phase3(ctx, ev, *B._phase3_statics(ctx, c))
    mark()
    return out, tuple((b - a) * 1e3 for a, b in zip(marks, marks[1:]))


def phase_boot_card_vs_cpu(dev, smi):
    """A small refresh (N = 2^10, 24 level limbs) on the card, stage by stage
    bit-equal to the same refresh on the CPU."""
    import toyfhe_tpu_torch as T
    from toyfhe_tpu_torch.core import bootstrap as B
    from toyfhe_tpu_torch.core import ckks_encoding as CE
    from toyfhe_tpu_torch.models import mnist as M
    from toyfhe_tpu_torch.ops import ntt_cuda
    from toyfhe_tpu_torch.utils import interop as I

    logn, recipe = BOOT_SMALL_LOGN, boot_recipe()
    depth, hw = recipe.pop("depth"), recipe.pop("hamming_weight")
    params, _ = M.make_bootstrapped_params(M.MNISTConfig(ring_logn=logn), depth,
                                           hamming_weight=hw, scale_limbs=recipe["scale_limbs"])
    log(f"== phase 25: CKKS refresh on the card against the CPU (N=2^{logn}, "
        f"{params.params.ring_cipher.nlimbs} limbs: 2 base + {depth} levels + "
        f"{params.num_special} raising, HybridRaised dnum={params.dnum}, {recipe})")
    gen = torch.Generator().manual_seed(25)
    t0 = time.perf_counter()
    kp = T.keygen(params, gen)
    ctx = B.setup_bootstrap(gen, kp.priv, **recipe)
    vals = boot_vals(1 << (logn - 1), 25)
    c = boot_exhausted(params, kp, vals, gen)
    log(f"keys on the CPU ({len(ctx.gks.keys)} rotation keys): "
        f"{time.perf_counter() - t0:.2f} s (host clock)")
    ctx_d, c_d = I.to_device(ctx, dev), I.to_device(c, dev)

    def stages(cx, ct, d):
        t = time.perf_counter()
        mr = B.mod_raise(ct)
        lo, hi = B.bootstrap_phase1(cx, ct)
        ev = B.bootstrap_phase2(cx, lo, hi)
        out = B.bootstrap_phase3(cx, ev, *B._phase3_statics(cx, ct))
        sync(d)
        return (mr, lo, hi, ev, out), (time.perf_counter() - t) * 1e3

    cpu, cpu_ms = stages(ctx, c, "cpu")
    card, card_cold = stages(ctx_d, c_d, dev)
    names = ("mod_raise", "C2S lo", "C2S hi", "EvalMod", "S2C")
    bad = [nm for nm, a, b in zip(names, cpu, card) if not same_ct(a, b)]
    if bad:
        raise AssertionError(f"refresh stages on the card differ from the CPU: {bad}")
    reset_launches()
    whole = B.bootstrap(ctx_d, c_d)                                       # the refresh path
    sync(dev)
    launches = read_launches()
    transforms = dict(ntt_cuda.transforms)
    if not (launches["fwd"] and launches["inv"]) or non_k1_launches(launches):
        raise AssertionError(f"the refresh launched {launches}")
    if not same_ct(whole, cpu[-1]):
        raise AssertionError("the whole refresh on the card differs from the CPU")
    warm = []
    for _ in range(BOOT_REPS):
        t = time.perf_counter()
        B.bootstrap(ctx_d, c_d)
        sync(dev)
        warm.append((time.perf_counter() - t) * 1e3)
    err = float(np.max(np.abs(T.decrypt(kp, cpu[-1]) - vals)))
    log(f"mod_raise, C2S (lo, hi), EvalMod, S2C and the whole refresh on the card == on the "
        f"CPU; {cpu[-1].ring.nlimbs} limbs out, max abs error {err:.3e}; K1 launches per "
        f"refresh {launches['fwd']} forward + {launches['inv']} inverse over "
        f"{transforms['fwd']} + {transforms['inv']} limb polynomials, "
        f"no other kernel")
    log(f"refresh ms: CPU {cpu_ms:.1f}; card cold {card_cold:.1f}, warm "
        f"{float(np.median(warm)):.1f} (median of {BOOT_REPS}: "
        f"{', '.join(f'{w:.1f}' for w in warm)}) [{smi}]")
    if not err < 1e-3:
        raise AssertionError(f"small refresh error {err}")
    return dict(launches=launches, err=err, cpu_ms=cpu_ms, warm_ms=float(np.median(warm)))


BOOT_FULL_SEED = 26


def boot_full_keys(dev, cfg):
    """Phase 26's generator, MNIST setup and bootstrap context at ``cfg``,
    made alike in every process from one seed (phase 39's ranks make them
    again); the exhausted inputs follow from the generator."""
    from toyfhe_tpu_torch.models import mnist as M
    gen = torch.Generator(device=dev).manual_seed(BOOT_FULL_SEED)
    setup, ctx = M.fhe_setup_bootstrapped(cfg, gen, **boot_recipe())
    return gen, setup, ctx


def ct_numpy(c) -> list:
    """A whole ciphertext's dual components as host arrays."""
    import toyfhe_tpu_torch as T
    return [T.ringops.ensure_dual(c.ring, x).dual.cpu().numpy() for x in c.cs]


def phase_boot_full(dev, smi, cfg=None):
    """One refresh at the full width of the bootstrapped MNIST configuration
    (N = 2^13, 55 limbs), cold and warm, each phase timed; the batch of 2.
    ``cfg`` (default ``MNISTConfig()``) sets the ring."""
    import toyfhe_tpu_torch as T
    from toyfhe_tpu_torch.core import bootstrap as B
    from toyfhe_tpu_torch.models import mnist as M
    from toyfhe_tpu_torch.ops import ntt_cuda

    cfg = M.MNISTConfig() if cfg is None else cfg
    log(f"== phase 26: one CKKS refresh at full width (N=2^{cfg.ring_logn}, {boot_recipe()})")
    t0 = time.perf_counter()
    gen, setup, ctx = boot_full_keys(dev, cfg)
    sync(dev)
    setup_s = time.perf_counter() - t0
    params = setup.params
    kb = key_bytes(setup.ek, setup.gk, ctx.ek, ctx.gks, ctx.gk_conj)
    log(f"fhe_setup_bootstrapped: {params.params.ring_cipher.nlimbs} limbs "
        f"({params.ring_cipher.nlimbs} ciphertext + {params.num_special} raising), "
        f"HybridRaised dnum={params.dnum} alpha={params.alpha}, {len(ctx.gks.keys)} rotation "
        f"keys + conjugation + 2 relinearization + 1 dense Galois key = "
        f"{kb / 2 ** 20:.1f} MiB on the card; {setup_s:.2f} s (host clock)")
    vals = boot_vals(1 << (cfg.ring_logn - 1), BOOT_FULL_SEED)
    c = boot_exhausted(params, setup.kp, vals, gen)

    t0 = time.perf_counter()
    cold = B.bootstrap(ctx, c)
    sync(dev)
    cold_ms = (time.perf_counter() - t0) * 1e3
    log(f"cold refresh (encodes {len(ctx.plain_cache)} transform diagonals and EvalMod "
        f"constants, {cache_bytes(ctx) / 2 ** 20:.1f} MiB kept on the card): {cold_ms:.1f} ms")
    runs = []
    for _ in range(BOOT_REPS):
        out, ph = refresh_phases(ctx, c, dev)
        if not same_ct(out, cold):
            raise AssertionError("a warm refresh differs from the cold one")
        runs.append(ph)
    tot = [sum(r) for r in runs]
    med = {nm: float(np.median([r[i] for r in runs]))
           for i, nm in enumerate(("modraise_c2s", "evalmod", "s2c"))}
    warm_ms = float(np.median(tot))
    reset_launches()
    B.bootstrap(ctx, c)                                                   # the refresh path
    sync(dev)
    launches = read_launches()
    transforms = dict(ntt_cuda.transforms)
    if not (launches["fwd"] and launches["inv"]) or non_k1_launches(launches):
        raise AssertionError(f"the refresh launched {launches}")
    err = float(np.max(np.abs(T.decrypt(setup.kp, cold) - vals)))
    levels = cold.ring.nlimbs
    log(f"warm refresh: {warm_ms:.1f} ms (median of {BOOT_REPS}: "
        f"{', '.join(f'{t:.1f}' for t in tot)}); phases (median ms, share): " +
        ", ".join(f"{k} {v:.1f} ({100 * v / sum(med.values()):.0f}%)" for k, v in med.items())
        + f" [{smi}]")
    log(f"{levels} limbs regained (limit >= 13), max abs error {err:.3e} against the input "
        f"(limit 1e-3; the reference's TPU figure, 6.9e-5, is of the h=8, degree-59 sine recipe "
        f"of tools.bench_bootstrap 13 16 8 5 1 1.5 2); K1 launches per refresh "
        f"{launches['fwd']} forward + {launches['inv']} inverse over {transforms['fwd']} + "
        f"{transforms['inv']} limb polynomials, no other kernel")
    if not (levels >= 13 and err < 1e-3):
        raise AssertionError(f"full-width refresh: {levels} limbs, error {err}")

    vals2 = boot_vals(1 << (cfg.ring_logn - 1), BOOT_FULL_SEED + 100)
    c2 = boot_exhausted(params, setup.kp, vals2, gen)        # the refreshes draw nothing
    single2 = B.bootstrap(ctx, c2)
    both = T.ct_stack([c, c2])
    batch_ms = []
    for _ in range(2):
        sync(dev)
        t0 = time.perf_counter()
        outb = B.bootstrap_batched(ctx, both)
        sync(dev)
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    if not (same_ct(T.ct_index(outb, 0), cold) and same_ct(T.ct_index(outb, 1), single2)):
        raise AssertionError("the batched refresh differs from the single refreshes")
    log(f"bootstrap_batched on 2 ciphertexts == the two single refreshes; "
        f"{min(batch_ms) / 2:.1f} ms per refresh (best of 2 batches: "
        f"{', '.join(f'{t:.1f}' for t in batch_ms)} ms) [{smi}]")
    return dict(setup=setup, ctx=ctx, setup_s=setup_s, key_bytes=kb, cold_ms=cold_ms,
                warm_ms=warm_ms, phases=med, launches=launches, transforms=transforms,
                err=err, levels=levels, batch_ms=min(batch_ms) / 2, gen=gen,
                cache_bytes=cache_bytes(ctx), want=[ct_numpy(cold), ct_numpy(single2)])


def phase_boot_mnist(dev, smi, boot):
    """The bootstrapped encrypted-MNIST pipeline at the full reference shape,
    on the keys and context of phase 26."""
    from toyfhe_tpu_torch.models import mnist as M
    from toyfhe_tpu_torch.ops import ntt_cuda

    setup, ctx, gen = boot["setup"], boot["ctx"], boot["gen"]
    cfg = setup.cfg
    log(f"== phase 27: bootstrapped encrypted MNIST at MNISTConfig() (N=2^{cfg.ring_logn}, "
        f"{cfg.batch} images, {cfg.grid}x{cfg.grid} grid, {cfg.channels} channels, "
        f"{(cfg.channels + 1) * (cfg.positions - 1)} rotations on the depth-"
        f"{M.BOOTSTRAPPED_RECIPE['depth']} tower, prescale {M.BOOTSTRAPPED_PRESCALE})")
    weights = M.init_params(cfg, 27)
    imgs = np.random.default_rng(27).uniform(0.0, 1.0, (cfg.batch, cfg.image, cfg.image))
    plain = M.model_forward(cfg, weights, imgs)
    mem = lambda: torch.cuda.memory_allocated(dev) if torch.device(dev).type == "cuda" else 0
    mem0 = mem()
    t0 = time.perf_counter()
    run = M.build_bootstrapped_pipeline(setup, ctx, weights, prescale=M.BOOTSTRAPPED_PRESCALE)
    sync(dev)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run(imgs, gen)
    sync(dev)
    cold_ms = (time.perf_counter() - t0) * 1e3
    built = mem() - mem0
    log(f"build (layers, {cfg.channels * cfg.positions} dense-1 diagonals at "
        f"{setup.params.ring_cipher.nlimbs - 2} limbs): {build_s:.2f} s; cold first batch (dense 2 "
        f"built at the regained tower): {cold_ms:.1f} ms; {built / 2 ** 20:.1f} MiB of layer "
        f"constants on the card (host clock)")

    reset_launches()
    logits, depth_out = run(imgs, torch.Generator(device=dev).manual_seed(PIPE_ENC_SEED))
    sync(dev)                                                             # the main path
    launches = read_launches()
    transforms = dict(ntt_cuda.transforms)
    if not (launches["fwd"] and launches["inv"]) or non_k1_launches(launches):
        raise AssertionError(f"the bootstrapped pipeline launched {launches}")
    logits = logits.T
    if logits.shape != (cfg.batch, cfg.classes) or not np.all(np.isfinite(logits)):
        raise AssertionError(f"bad logits: shape {logits.shape} or non-finite values")
    err = float(np.max(np.abs(logits - plain)))
    top2 = np.sort(plain, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * err
    agree = np.argmax(logits, -1) == np.argmax(plain, -1)
    log(f"one batch launched {launches} (K1 over {transforms['fwd']} + {transforms['inv']} limb "
        f"polynomials; the refresh's share {boot['launches']['fwd']} + "
        f"{boot['launches']['inv']}); depth_out {depth_out} (limit >= 13); logits vs "
        f"model_forward: max abs error {err:.3e} (limit 5e-2; the reference's compiled TPU run: "
        f"2.1e-2); labels agree on {int(agree.sum())}/{cfg.batch}, on {int(agree[clear].sum())} "
        f"of the {int(clear.sum())} with a plaintext top-two margin > 2x error")
    if not (depth_out >= 13 and err < 5e-2):
        raise AssertionError(f"bootstrapped MNIST: depth_out {depth_out}, error {err}")
    if not agree[clear].all():
        raise AssertionError("a label differs on an image with a clear plaintext margin")

    walls, per_stage = [], []
    for _ in range(BOOT_REPS):
        lt = {}
        sync(dev)
        t0 = time.perf_counter()
        run(imgs, gen, layer_times=lt)
        walls.append((time.perf_counter() - t0) * 1e3)
        per_stage.append(lt)
    stages = {k: float(np.median([lt[k] for lt in per_stage])) for k in per_stage[0]}
    ms = float(np.median(walls))
    log(f"warm batch: {ms:.1f} ms/batch (median of {BOOT_REPS}: "
        f"{', '.join(f'{w:.1f}' for w in walls)}), {cfg.batch * 1e3 / ms:.1f} images/s [{smi}]")
    log("per stage (median ms, synchronised between stages): " +
        ", ".join(f"{k} {v:.2f}" for k, v in stages.items()) + f" [{smi}]")
    return dict(launches=launches, transforms=transforms, err=err, depth_out=depth_out,
                ms=ms, cold_ms=cold_ms, build_s=build_s, stages=stages, built=built,
                agree=int(agree.sum()), clear=int(clear.sum()))


# ---------------------------------------------------------------------------
# the exact schemes: BFV with the BEHZ multiply and leveled BGV
# ---------------------------------------------------------------------------

GOLDEN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
                           "reference_vectors.json")
GOLDEN_SEED = 20260820      # the seed the goldens' plaintext vectors were drawn from
EXACT_GOLDENS = ("bfv_triv", "bfv_keyswitch", "bfv_simd", "bgv_triv", "bfv_crt")
BFV_P, BFV_EMC = 65537, 4   # bfv_params(65537, eval_mult_count=4): N = 8192, 7 x 28-bit limbs
BFV_TREE = 16               # ciphertexts at the leaves of the depth-4 product tree
BGV_N, BGV_P, BGV_BATCH = 1 << 13, 65537, 4
BGV_TOWER = (28,) * 5 + (30, 30)


def vec_matches(rec: dict, xs) -> bool:
    """A decoded vector against its golden record: the whole list, or its
    length, its first 64 entries and the sha256 of the list's ``repr``."""
    xs = [int(x) for x in xs]
    if "full" in rec:
        return rec["full"] == xs
    return (rec["len"] == len(xs) and rec["prefix"] == xs[:64]
            and hashlib.sha256(repr(xs).encode()).hexdigest() == rec["sha256"])


def golden_plain_vec(n, p):
    return np.random.default_rng(GOLDEN_SEED).integers(0, p, size=n)


def bfv_crt_params():
    """The ``bfv_crt`` scenario's hand-built parameters: a (30, 29)-bit tower
    at N = 2048, an auxiliary base of four primes continuing the prime walk
    past it (above 2^30), p = 53, window 1, σ = 3.2, Δ = ⌊q/53⌋."""
    import toyfhe_tpu_torch as T
    from toyfhe_tpu_torch.utils import numtheory as nt

    n = 2048
    ring = T.make_rns_ring(n, (30, 29))
    last, aux = max(ring.primes), []
    for _ in range(4):
        last = nt.next_prime(last + 2 * n, interval=2 * n)
        aux.append(last)
    return T.BFVParams(ring, T.make_ring(n, aux), T.PlainRing(n, 53), 1, 3.2,
                       delta=ring.modulus // 53)


def exact_golden_vectors(name, dev):
    """Golden scenario ``name`` on ``dev`` with the port's own keys: (N, the
    decoded vectors by check name, with the drawn plaintext vectors under
    "plain/..."), after the literal asserts of the reference's test of the
    scenario. An exact scheme decodes the recorded vectors whatever the keys
    and the noise."""
    import toyfhe_tpu_torch as T

    gen = torch.Generator(device=dev).manual_seed(GOLDEN_SEED)
    dec = lambda kp, c: T.decrypt(kp, c).coeffs
    slots = lambda kp, c: T.slot_decode(T.decrypt(kp, c), device=dev)
    out = {}
    if name == "bfv_simd":
        params = T.bfv_params(65537, eval_mult_count=1)
        pring = params.plaintext_space()
        n = pring.n
        kp = T.keygen(params, gen)
        s1 = np.zeros(n, dtype=np.int64)
        s1[:2] = 1
        s2 = np.full(n, 10, dtype=np.int64)
        s2[0] = 5
        c1, c2 = (T.encrypt(kp, T.slot_encode(pring, s, device=dev), gen) for s in (s1, s2))
        d = slots(kp, T.ct_mul(c1, c2))
        if d[0] != 5 or d[1] != 10 or d[2:].any():
            raise AssertionError("bfv_simd: slot products wrong")
        out["slots_mul"] = d
        sv = out["plain/slots"] = golden_plain_vec(n, 65537)
        cv = T.encrypt(kp, T.slot_encode(pring, sv, device=dev), gen)
        out["vec_slots_sq"] = slots(kp, T.ct_mul(cv, cv))
        return n, out
    p, scalar = {"bfv_triv": (53, 6), "bfv_keyswitch": (7, 2), "bgv_triv": (256, 6),
                 "bfv_crt": (53, 6)}[name]
    if name == "bgv_triv":
        params = T.BGVParams(T.cryptparams.palisade_ring(4096), 256, 8 / (2 * np.pi) ** 0.5)
    elif name == "bfv_crt":
        params = bfv_crt_params()
    else:
        params = T.bfv_params(p, eval_mult_count={"bfv_triv": 2, "bfv_keyswitch": 3}[name])
    pring = params.plaintext_space()
    kp = T.keygen(params, gen)
    c = T.encrypt(kp, T.scalar_encode(pring, scalar), gen)
    m = out["plain/vec"] = golden_plain_vec(pring.n, p)
    cv = T.encrypt(kp, T.coeff_encode(pring, m), gen)
    if name == "bfv_keyswitch":
        ek = T.keygen_eval_mult(gen, kp.priv)
        csq = T.ct_mul(c, c)
        out["dec_sq"] = dec(kp, csq)
        cs = T.keyswitch(ek, csq)
        cvs = T.keyswitch(ek, T.ct_mul(cv, cv))
        if len(cs.cs) != 2 or len(cvs.cs) != 2:
            raise AssertionError("bfv_keyswitch: the key switch left three components")
        out["dec_keyswitched"] = dec(kp, cs)
        out["dec_mul_after_switch"] = dec(kp, T.ct_mul(cs, c))
        out["vec_sq_switched"] = dec(kp, cvs)
        return pring.n, out
    out["dec"] = dec(kp, c)
    dsq = dec(kp, T.ct_mul(c, c))
    if dsq[0] != 36:
        raise AssertionError(f"{name}: 6 squared decoded as {dsq[0]}")
    if name == "bfv_crt":
        # the recorded full square wraps the literal big ring of the source
        # test; the BEHZ base does not, so it is held against the sound record
        out["dec_sq0"], out["dec_sq_sound"] = int(dsq[0]), dsq
    else:
        out["dec_sq"] = dsq
    if name == "bfv_triv":
        out["vec_dec"] = dec(kp, cv)
    out["vec_sq"] = dec(kp, T.ct_mul(cv, cv))
    return pring.n, out


def check_exact_golden(name, scenarios, dev) -> int:
    """Run golden scenario ``name`` on ``dev`` and hold every decoded vector
    to its record, exactly; the number of vectors checked."""
    g = scenarios[name]
    n, vecs = exact_golden_vectors(name, dev)
    if n != g["params"]["n"]:
        raise AssertionError(f"{name}: parameter generation gave N={n}, the record {g['params']['n']}")
    for key, xs in vecs.items():
        group, _, k = key.rpartition("/")
        rec = g["plain" if group else "checks"][k]
        if not (rec == xs if isinstance(rec, int) else vec_matches(rec, xs)):
            raise AssertionError(f"{name}: {key} differs from the golden record")
    return len(vecs)


def exact_k1_cases():
    """(N, tower label, primes, leads) of phase 28: the towers the exact
    schemes put through K1, at their polynomial counts."""
    import toyfhe_tpu_torch as T

    bfv = T.bfv_params(BFV_P, eval_mult_count=BFV_EMC)
    q, ext = bfv.ring_cipher.primes, bfv.mul_ctx().ext_ring.primes
    crt = bfv_crt_params()
    bgv = T.make_rns_ring(BGV_N, BGV_TOWER).primes
    cases = [(8192, "BFV q+Bsk", ext, ((8,), (4,), (2,), (1,))),
             (8192, "BFV q", q, ((8,), (1,), (7, 8), (7, 1))),
             (8192, "slots p=65537", [BFV_P], ((), (BGV_BATCH,), (BFV_TREE,))),
             (2048, "bfv_crt q+Bsk", crt.mul_ctx().ext_ring.primes, ((), (2,))),
             (2048, "bfv_crt q", crt.ring_cipher.primes, ((), (2,))),
             (8192, "BGV key tower", bgv, ((),))]
    # ModulusRaised: the ciphertext tower at each level, and its key switch's
    # digits over the tower raised by the special prime
    for lt in (6, 5, 4):
        cases.append((8192, f"BGV q[:{lt}]", bgv[:lt], ((BGV_BATCH,),)))
        cases.append((8192, f"BGV q[:{lt}]+special", bgv[:lt] + bgv[-1:],
                      ((lt, BGV_BATCH), (BGV_BATCH,))))
    # HybridRaised(3, 2): the raised towers Q_t ∪ P, and the out-of-group
    # rows of each digit that its key switch transforms
    hybrid = T.HybridRaised(T.BGVParams(T.make_rns_ring(BGV_N, BGV_TOWER), BGV_P, 3.2), 3, 2)
    for lt in (5, 4):
        raised = bgv[:lt] + bgv[5:]
        cases.append((8192, f"BGV q[:{lt}]+P", raised, ((2, BGV_BATCH),)))
        for j, (_, _, out_idx) in enumerate(hybrid.digit_rows(lt)):
            cases.append((8192, f"BGV q[:{lt}]+P digit {j} out-of-group",
                          [raised[i] for i in out_idx], ((BGV_BATCH,),)))
    return cases


def phase_exact_k1_goldens(dev):
    """K1 held against its plain twin at the exact schemes' shapes in every
    variant, then the exact golden scenarios on the card."""
    log("== phase 28: K1 at the exact schemes' shapes (the BFV extended tower, the plaintext "
        "slot ring, the bfv_crt tower past 2^30, the BGV towers and their drops), every "
        "variant; the exact golden scenarios on the card")
    gen = torch.Generator(device=dev).manual_seed(28)
    err = {"fwd": 0, "inv": 0}
    k1_check(dev, exact_k1_cases(), gen, err)
    with open(GOLDEN_PATH) as f:
        scenarios = json.load(f)["scenarios"]
    for name in EXACT_GOLDENS:
        t0 = time.perf_counter()
        nvec = check_exact_golden(name, scenarios, dev)
        log(f"golden {name} (N={scenarios[name]['params']['n']}): {nvec} vectors decode "
            f"exactly as recorded, {time.perf_counter() - t0:.2f} s with keygen")
    return err


def ct_rows(c, lo, hi):
    """Entries [lo, hi) of a ciphertext batched on its first axis."""
    import toyfhe_tpu_torch as T
    cut = lambda t: None if t is None else t[lo:hi]
    return T.CipherText(c.params, tuple(T.RingElt(primal=cut(x.primal), dual=cut(x.dual))
                                        for x in c.cs), c.ring, enc=c.enc)


def pub_key_bytes(kp) -> int:
    return sum(t.numel() * t.element_size()
               for e in (kp.pub.key.mask, kp.pub.key.masked, kp.priv.secret)
               for t in (e.primal, e.dual) if t is not None)


def phase_bfv_tree(dev, smi, seed):
    """SIMD BFV at full width: a depth-4 product tree over 16 ciphertexts,
    each level one batched multiply and one relinearization, the card held
    to the CPU at every level, the noise budget read at every level and the
    last slots decoded against numpy; each level timed warm, in its parts,
    and once under ``torch.profiler`` (device-busy share)."""
    import toyfhe_tpu_torch as T
    from toyfhe_tpu_torch.core import rlwe
    from toyfhe_tpu_torch.ops import ntt_cuda
    from toyfhe_tpu_torch.tools.profile_mnist import profile_batch
    from toyfhe_tpu_torch.utils import interop as I

    params = T.bfv_params(BFV_P, eval_mult_count=BFV_EMC)
    ring, n = params.ring_cipher, params.ring_cipher.n
    ext = params.mul_ctx().ext_ring
    log(f"== phase 29: SIMD BFV at full width (bfv_params({BFV_P}, eval_mult_count={BFV_EMC}): "
        f"N={n}, q {ring.nlimbs} limbs = {ring.log2q:.1f} bits, "
        f"BEHZ tower {ext.nlimbs} limbs), a depth-4 product tree over {BFV_TREE} ciphertexts "
        f"[{smi}]")
    t0 = time.perf_counter()
    gen_cpu = torch.Generator().manual_seed(seed)
    kp = T.keygen(params, gen_cpu)
    ek = T.keygen_eval_mult(gen_cpu, kp.priv)
    kp_d, ek_d = I.to_device(kp, dev), I.to_device(ek, dev)
    log(f"keys on the CPU and copied to the card in {time.perf_counter() - t0:.2f} s: "
        f"relinearization key {key_bytes(ek_d) / 2**20:.1f} MiB ({len(ek.key.key)} digits), "
        f"public key and secret {pub_key_bytes(kp_d) / 2**20:.1f} MiB")
    pring = params.plaintext_space()
    vals = np.random.default_rng(seed).integers(0, BFV_P, (BFV_TREE, n))
    gen = torch.Generator(device=dev).manual_seed(seed)
    pts = T.slot_encode(pring, vals, device=dev)
    c = T.ct_stack([T.encrypt(kp_d, T.PlainPoly(pring, pts.coeffs[i]), gen)
                    for i in range(BFV_TREE)])
    cpu = I.to_device(c, "cpu")

    def level(ek_, x):
        h = x.cs[0].shape[0] // 2
        return T.keyswitch(ek_, T.ct_mul(ct_rows(x, 0, h), ct_rows(x, h, 2 * h)))

    levels = []
    budget0 = min(T.invariant_noise_budget(kp_d, T.ct_index(c, i)) for i in range(BFV_TREE))
    for depth in range(1, 5):
        prev = c
        sync(dev)
        reset_launches()
        c = level(ek_d, prev)
        sync(dev)
        launches, polys = dict(ntt_cuda.launches), sum(ntt_cuda.transforms.values())
        h = c.cs[0].shape[0]
        cpu = level(ek, cpu)
        if not same_ct(c, cpu):
            raise AssertionError(f"BFV level {depth}: the card differs from the CPU")
        vals = vals[:h] * vals[h:2 * h] % BFV_P
        t0 = time.perf_counter()
        budgets = [T.invariant_noise_budget(kp_d, T.ct_index(c, i)) for i in range(h)]
        meter_s = (time.perf_counter() - t0) / h
        if min(budgets) <= 0:
            raise AssertionError(f"BFV level {depth}: noise budget {min(budgets):.1f} bits")
        # warm timings of the level and of its parts on the previous level's batch
        a, b = ct_rows(prev, 0, h), ct_rows(prev, h, 2 * h)
        _, (ea, eb) = params.mul_expand_pair(a, b)
        prod = rlwe.tensor_product(ext, ea, eb)
        sq = T.ct_mul(a, b)
        ms = {"level": cuda_ms(lambda: level(ek_d, prev)),
              "ct_mul": cuda_ms(lambda: T.ct_mul(a, b)),
              "expand": cuda_ms(lambda: params.mul_expand_pair(a, b)),
              "tensor": cuda_ms(lambda: rlwe.tensor_product(ext, ea, eb)),
              "contract": cuda_ms(lambda: params.mul_contract_pair(ext, prod)),
              "keyswitch": cuda_ms(lambda: T.keyswitch(ek_d, sq))}
        prof = profile_batch(lambda *_: level(ek_d, prev), None, None, dev)
        levels.append(dict(depth=depth, batch=h, launches=launches, polys=polys, ms=ms,
                           budget=min(budgets), meter_s=meter_s, prof=prof))
        log(f"level {depth}: {h} ct_mul + keyswitch in one batched call each, card == CPU; "
            f"K1 {launches['fwd']} + {launches['inv']} launches, {polys} limb polynomials; "
            f"noise budget >= {min(budgets):.1f} bits (fresh {budget0:.1f}); warm ms: level "
            f"{ms['level']:.3f}, ct_mul {ms['ct_mul']:.3f} (expand {ms['expand']:.3f}, tensor "
            f"{ms['tensor']:.3f}, contract {ms['contract']:.3f}), keyswitch "
            f"{ms['keyswitch']:.3f}; host meter {meter_s * 1e3:.1f} ms a ciphertext [{smi}]")
        log(f"  profiled level {depth}: {prof['kernels']} device kernels, device busy "
            f"{prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} (idle "
            f"{100 - 100 * prof['busy_ms'] / prof['wall_ms']:.1f}%); by group: " +
            ", ".join(f"{g} {c} / {t:.3f} ms" for g, (c, t) in sorted(prof["groups"].items())))
    t0 = time.perf_counter()
    got = T.slot_decode(T.decrypt(kp_d, T.ct_index(c, 0)), device=dev)
    decode_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(got, vals[0]):
        raise AssertionError("BFV product tree: the final slots differ from the numpy product")
    launches = {k: sum(lv["launches"][k] for lv in levels) for k in ("fwd", "inv")}
    log(f"final slot_decode == the product of the {BFV_TREE} slot vectors mod {BFV_P}, exactly "
        f"(host decrypt + decode {decode_ms:.1f} ms); the tree: K1 {launches['fwd']} + "
        f"{launches['inv']} launches")
    return dict(levels=levels, launches=launches, decode_ms=decode_ms, budget0=budget0,
                key_mib=key_bytes(ek_d) / 2**20, final=(kp_d, T.ct_index(c, 0)))


def phase_bgv_levels(dev, smi, seed):
    """Leveled BGV at full width: square → key switch → rescale, 3 levels
    under ModulusRaised and 2 under HybridRaised(dnum=3, num_special=2), on a
    batch of slot vectors, the card held to the CPU at every level and the
    slots decoded exactly through the BGVTag factor."""
    import toyfhe_tpu_torch as T
    from toyfhe_tpu_torch.core import bfv
    from toyfhe_tpu_torch.ops import ntt_cuda
    from toyfhe_tpu_torch.utils import interop as I

    log(f"== phase 30: leveled BGV at full width (N={BGV_N}, tower {BGV_TOWER}, p={BGV_P}, "
        f"a batch of {BGV_BATCH}): square -> key switch -> rescale [{smi}]")
    ring = T.make_rns_ring(BGV_N, BGV_TOWER)
    base = T.BGVParams(ring, BGV_P, bfv.DEFAULT_SIGMA)
    out = {}
    for label, params, depth in (("modraised", T.ModulusRaised(base), 3),
                                 ("hybrid", T.HybridRaised(base, 3, 2), 2)):
        gen_cpu = torch.Generator().manual_seed(seed)
        kp = T.keygen(params, gen_cpu)
        ek = T.keygen_eval_mult(gen_cpu, kp.priv)
        kp_d, ek_d = I.to_device(kp, dev), I.to_device(ek, dev)
        pring = params.plaintext_space()
        vals = np.random.default_rng(seed).integers(0, BGV_P, (BGV_BATCH, BGV_N))
        gen = torch.Generator(device=dev).manual_seed(seed)
        pts = T.slot_encode(pring, vals, device=dev)
        c = T.ct_stack([T.encrypt(kp_d, T.PlainPoly(pring, pts.coeffs[i]), gen)
                        for i in range(BGV_BATCH)])
        cpu = I.to_device(c, "cpu")
        step = lambda k, x: T.ct_rescale(T.keyswitch(k, T.ct_mul(x, x)))
        rows = []
        for lvl in range(1, depth + 1):
            prev = c
            sync(dev)
            reset_launches()
            c = step(ek_d, prev)
            sync(dev)
            launches, polys = dict(ntt_cuda.launches), sum(ntt_cuda.transforms.values())
            cpu = step(ek, cpu)
            if not same_ct(c, cpu):
                raise AssertionError(f"BGV {label} level {lvl}: the card differs from the CPU")
            vals = vals * vals % BGV_P
            for i in range(BGV_BATCH):
                got = T.slot_decode(T.decrypt(kp_d, T.ct_index(c, i)), device=dev)
                if not np.array_equal(got, vals[i]):
                    raise AssertionError(f"BGV {label} level {lvl}: slots of {i} differ")
            budget = min(T.bgv_noise_budget(kp_d, T.ct_index(c, i)) for i in range(BGV_BATCH))
            ms = cuda_ms(lambda: step(ek_d, prev))
            rows.append(dict(level=lvl, limbs=c.ring.nlimbs, launches=launches, polys=polys,
                             budget=budget, ms=ms))
            log(f"{label} level {lvl}: {c.ring.nlimbs} limbs left, card == CPU, slots exact "
                f"(BGVTag factor {c.enc.mult}), budget {budget:.1f} bits, K1 {launches['fwd']} "
                f"+ {launches['inv']} launches ({polys} limb polynomials), warm {ms:.3f} ms "
                f"[{smi}]")
        out[label] = dict(rows=rows, launches={k: sum(r["launches"][k] for r in rows)
                                               for k in ("fwd", "inv")},
                          final=(kp_d, T.ct_index(c, 0)))
    return out


# ---------------------------------------------------------------------------
# the exact host engine, the C++ CRT, serialization and training
# ---------------------------------------------------------------------------

HOST_N = 1 << 13
HOST_BITS = (28,) * 7                     # the serving data tower
HOST_SCALE = Fraction(2) ** 26
# The RNS-limb gadget's key switch adds about 7 digits × 2^27 × σ·√N of noise
# before the rescale; the decode spreads it over N coefficients: the host
# engine's slots come out within a few 1e-2 at N = 2^13 (6.7e-2 on a CPU run
# with seed 0), so the bound only catches a broken decode. The card is held
# to the host's integers exactly.
HOST_DECODE_ATOL = 0.25


def phase_host_oracle(dev, smi, seed):
    """The exact host engine as the card's oracle at serving width: the
    ``ckks_device_tower`` scenario at N = 2^13. The host engine (exact Python
    integers, RNS-limb gadget) makes a secret, an eval key and an encryption
    of 4096 slots, squares, key-switches and rescales, and decrypts to raw
    integers; the card imports the secret, the ciphertext and the eval key,
    runs ``ct_mul`` → ``keyswitch`` → ``ct_rescale`` through K1, and its
    ``decrypt_raw`` must be the host's integers exactly."""
    import random

    import toyfhe_tpu_torch as T
    from toyfhe_tpu_torch.core import host_engine as HE
    from toyfhe_tpu_torch.utils import interop as I
    from toyfhe_tpu_torch.utils import numtheory as nt

    tower = nt.ntt_prime_chain(HOST_N, HOST_BITS)
    log(f"== phase 31: the exact host engine as the card's oracle (N={HOST_N}, tower "
        f"{HOST_BITS}, RNS-limb gadget, {HOST_N // 2} slots at scale 2^26): host square -> "
        f"key switch -> rescale against the card's, raw decrypted integers bit-equal")
    ring = HE.Pow2HostRing(HOST_N, moduli=tower)
    hp = HE.HostParams(ring=ring, scheme="ckks", sigma=3.2, relin_window=0)
    rng = random.Random(seed)
    slots = np.linspace(0.1, 1.0, HOST_N // 2).astype(np.complex128)
    secs = {}

    def host(name, fn):
        t = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t
        return out

    t0 = time.perf_counter()
    kp = host("keygen", lambda: HE.keygen(hp, rng))
    ek = host("keygen_eval_mult", lambda: HE.keygen_eval_mult(hp, kp, rng))
    pt = host("encode", lambda: HE.ckks_encode_host(ring, slots, HOST_SCALE))
    c = host("encrypt", lambda: HE.encrypt(hp, kp, pt, rng))
    csq = host("ct_mul", lambda: HE.ct_mul(hp, c, c))
    cks = host("keyswitch", lambda: HE.keyswitch(hp, ek, csq))
    sub, crs = host("modswitch", lambda: HE.modswitch(hp, cks))
    raw = host("decrypt_raw", lambda: HE.decrypt_raw(sub, kp, crs, sub.ring))
    host_s = time.perf_counter() - t0
    dec = HE.ckks_decode_host(sub.ring, raw, HOST_SCALE ** 2 / tower[-1])
    host_err = float(np.max(np.abs(dec - slots ** 2)))
    log(f"host engine: {host_s:.1f} s in all; seconds a step: " +
        ", ".join(f"{k} {v:.2f}" for k, v in secs.items()) +
        f"; decode error {host_err:.3e} (limit {HOST_DECODE_ATOL})")
    if not host_err < HOST_DECODE_ATOL:
        raise AssertionError(f"host engine decode error {host_err}")

    dring = T.make_ring(HOST_N, tower)
    params = T.CKKSParams(dring, 0, 3.2)
    res = lambda xs: dring.from_bigint(xs)
    kpd = I.priv_key(params, res(kp.secret), device=dev)
    cd = I.ciphertext(params, dring, [res(x) for x in c], domain="primal", device=dev)
    ekd = I.eval_mult_key(params, np.stack([res(m) for m in ek.masks]),
                          np.stack([res(m) for m in ek.maskeds]), "primal", device=dev)
    step = lambda: T.ct_rescale(T.keyswitch(ekd, T.ct_mul(cd, cd)))
    sync(dev)
    reset_launches()
    out = step()                                                          # the main path
    sync(dev)
    launches = read_launches()
    got = T.ringops.ensure_primal(out.ring, T.decrypt_raw(kpd, out)).primal.cpu().numpy()
    if out.ring.primes != sub.ring.moduli or out.ring.to_bigint(got) != raw:
        raise AssertionError("the card's decrypt_raw differs from the host engine's integers")
    ms = {"ct_mul": cuda_ms(lambda: T.ct_mul(cd, cd))}
    sq = T.ct_mul(cd, cd)
    ms["keyswitch"] = cuda_ms(lambda: T.keyswitch(ekd, sq))
    ks = T.keyswitch(ekd, sq)
    ms["ct_rescale"] = cuda_ms(lambda: T.ct_rescale(ks))
    ms["all"] = cuda_ms(step)
    log(f"card: decrypt_raw == the host engine's {HOST_N} integers over {out.ring.nlimbs} "
        f"limbs, exactly; launched {launches}; warm ms (CUDA events, median of {REPS}): " +
        ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) +
        f"; the same three steps on the host: "
        f"{secs['ct_mul'] + secs['keyswitch'] + secs['modswitch']:.1f} s [{smi}]")
    return dict(launches=launches, secs=secs, host_s=host_s, ms=ms, host_err=host_err)


def phase_native_decodes(dev, smi, bsgs_setup, tree, bgv):
    """The C++ CRT on ciphertexts made on the card: the production MNIST
    logits ciphertext, the last level of the BFV product tree and the last
    BGV levels, decrypted on the card and decoded on the host through
    ``RingContext.native()`` and through the exact Python CRT."""
    import toyfhe_tpu_torch as T
    from toyfhe_tpu_torch.utils import numtheory as nt

    log("== phase 32: the C++ CRT on the card's ciphertexts (decode_centered_double, "
        "decode_bfv, decode_centered_mod) against the exact Python CRT")
    setup, gen = bsgs_setup["setup"], torch.Generator(device=dev).manual_seed(PIPE_ENC_SEED)
    logits_ct = setup._pipeline(bsgs_setup["imgs"], gen, _return_ct=True)
    cases = [("mnist_logits", "ckks", setup.kp, logits_ct),
             ("bfv_tree_last", "bfv", *tree["final"])]
    cases += [(f"bgv_{label}_last", "bgv", *v["final"]) for label, v in bgv.items()]
    rows = {}
    for name, kind, kp, c in cases:
        ring = c.ring
        raw = T.ringops.ensure_primal(ring, T.decrypt_raw(kp, c)).primal.cpu().numpy()
        q = ring.modulus
        nat = ring.native()
        t0 = time.perf_counter()
        xs = [nt.centered(x, q) for x in ring.to_bigint(raw)]
        crt_ms = (time.perf_counter() - t0) * 1e3
        if kind == "ckks":
            t0 = time.perf_counter()
            got = nat.decode_centered_double(raw)
            native_ms = (time.perf_counter() - t0) * 1e3
            want = np.array([float(x) for x in xs])
            bad = int(np.sum(np.abs(got - want) > np.abs(want) * 2.0 ** -51))
            what = f"decode_centered_double within 2^-51 of float(centered) ({bad} outside)"
        else:
            p = c.params.plaintext_space().p
            t0 = time.perf_counter()
            got = (nat.decode_bfv(raw, q // p, p) if kind == "bfv"
                   else nat.decode_centered_mod(raw, p))
            native_ms = (time.perf_counter() - t0) * 1e3
            want = [nt.divround(x, q // p) % p if kind == "bfv" else x % p for x in xs]
            bad = int(np.sum(np.asarray(got) != np.asarray(want)))
            if kind == "bfv":
                bad += int(np.sum(nat.decode_centered_mod(raw, p) != np.array([x % p for x in xs])))
            what = ("decode_bfv and decode_centered_mod bit-equal" if kind == "bfv"
                    else "decode_centered_mod bit-equal")
        log(f"{name} ({ring.nlimbs} limbs): {what}; C++ CRT {native_ms:.2f} ms, exact Python "
            f"CRT {crt_ms:.2f} ms for {ring.n} coefficients [{smi}]")
        if bad:
            raise AssertionError(f"{name}: {bad} coefficients differ from the exact CRT")
        rows[name] = dict(native_ms=native_ms, crt_ms=crt_ms, limbs=ring.nlimbs)
    log(f"phase 23's decrypt + decode stage, now on the C++ CRT: "
        f"{bsgs_setup['layers']['decrypt']:.2f} ms (the exact-CRT figure in PERF.md section 5: "
        f"41.48 ms)")
    return rows


def phase_serialization(dev, smi, base, bsgs):
    """The production BSGS setup saved from the card and loaded back: the key
    pair, the relinearization key, the 14 Galois keys and one input
    ciphertext; the BSGS pipeline on the loaded keys gives the logits
    ciphertext of the original keys, bit for bit."""
    import tempfile

    import toyfhe_tpu_torch as T
    from toyfhe_tpu_torch.models import mnist as M
    from toyfhe_tpu_torch.utils import serialization as S

    cfg, setup, gks = base["cfg"], base["setup"], bsgs["gks"]
    params = setup.params
    log(f"== phase 33: serialization of the production setup ({len(gks.keys)} Galois keys, "
        f"the key pair, the relinearization key, one input ciphertext) and the BSGS pipeline "
        f"on the loaded keys")
    grid = M.public_preprocess(cfg, base["imgs"])
    c = T.encrypt(setup.kp, T.make_plaintext(params.ring_cipher, grid[0, 0], setup.scale),
                  torch.Generator(device=dev).manual_seed(33))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        path = lambda name: os.path.join(d, f"{name}.npz")
        sync(dev)
        t0 = time.perf_counter()
        S.save_keypair(path("kp"), setup.kp)
        S.save_eval_mult_key(path("ek"), setup.ek)
        for i, gk in enumerate(gks.keys):
            S.save_galois_key(path(f"gk{i}"), gk)
        S.save_ciphertext(path("ct"), c)
        save_ms = (time.perf_counter() - t0) * 1e3
        sizes = {f: os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)}
        t0 = time.perf_counter()
        kp2 = S.load_keypair(path("kp"), params, device=dev)
        ek2 = S.load_eval_mult_key(path("ek"), params, device=dev)
        gks2 = T.GaloisKeys([S.load_galois_key(path(f"gk{i}"), params, device=dev)
                             for i in range(len(gks.keys))])
        c2 = S.load_ciphertext(path("ct"), params, device=dev)
        sync(dev)
        load_ms = (time.perf_counter() - t0) * 1e3
    gk_bytes = sum(v for k, v in sizes.items() if k.startswith("gk"))
    log(f"saved {len(sizes)} files, {sum(sizes.values()) / 2**20:.1f} MiB "
        f"({gk_bytes / 2**20:.1f} MiB of Galois keys) in {save_ms:.0f} ms; loaded onto the "
        f"card in {load_ms:.0f} ms (host clock) [{smi}]")
    if not (same_ct(c, c2) and c2.ring is params.ring_cipher):
        raise AssertionError("the reloaded ciphertext differs")
    if not np.array_equal(T.decrypt(kp2, c2), T.decrypt(setup.kp, c)):
        raise AssertionError("the reloaded key pair decrypts differently")

    # the BSGS pipeline does not use the iterated schedule's Galois key
    setup2 = M.FHESetup(cfg, params, kp2, ek2, None, setup.scale)
    run2 = M.build_inference_pipeline(setup2, base["weights"], gks2)
    enc = lambda: torch.Generator(device=dev).manual_seed(PIPE_ENC_SEED)
    sync(dev)
    reset_launches()
    out2 = run2(base["imgs"], enc(), _return_ct=True)                     # the main path
    sync(dev)
    launches = read_launches()
    out = setup._pipeline(base["imgs"], enc(), _return_ct=True)
    if not same_ct(out, out2):
        raise AssertionError("the logits ciphertext on the loaded keys differs")
    log(f"BSGS pipeline on the loaded keys: the logits ciphertext is bit-equal to the one on "
        f"the original keys; launched {launches}")
    return dict(launches=launches, save_ms=save_ms, load_ms=load_ms,
                mib=sum(sizes.values()) / 2**20, gk_mib=gk_bytes / 2**20, files=len(sizes))


TRAIN_STEPS = 300
TRAIN_PARITY_STEPS = 3
TRAIN_PARITY_ATOL = 1e-5         # float32 parameters after three Adam steps, card against CPU
TRAIN_MIN_ACC = 0.9
TRAIN_MIN_AGREE = 62             # of 64 encrypted labels equal to the plaintext ones


def phase_training(dev, smi, base, bsgs, seed):
    """Plaintext training at ``MNISTConfig()`` on the card (the reference's
    default recipe: 300 steps, warmup-cosine, clipping, the augmentation pool;
    real digits when the host has them, else 512 synthetic images), three
    updates from shared weights on a shared batch on the card and on the
    CPU, then the trained weights served encrypted through the BSGS + dual
    flow pipeline (train.jl → infer.jl)."""
    from toyfhe_tpu_torch.models import mnist as M

    cfg, setup, gks = base["cfg"], base["setup"], bsgs["gks"]
    log(f"== phase 34: plaintext training at MNISTConfig() ({TRAIN_STEPS} steps), then serving "
        f"the trained weights encrypted [{smi}]")
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("float32 matmuls must not run in TF32 here")

    # three updates from shared weights on a shared batch, card against CPU
    weights = {k: v.astype(np.float32) for k, v in M.init_params(cfg, seed).items()}
    x, y = M.synthetic_dataset(cfg, torch.Generator().manual_seed(seed), 256)
    sched = M.warmup_cosine(1e-3, TRAIN_STEPS)
    params = {}
    for where in ("cpu", dev):
        model = M.PlainCNN(cfg, weights, where)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
        for count in range(60, 60 + TRAIN_PARITY_STEPS):
            M.train_step(model, opt, x.to(where), y.to(where), sched(count), clip=True,
                         smoothing=0.05)
        params[str(where)] = model.params()
    diff = max(float(np.max(np.abs(params["cpu"][k] - params[str(dev)][k]))) for k in weights)
    step = max(float(np.max(np.abs(params["cpu"][k] - weights[k]))) for k in weights)
    log(f"{TRAIN_PARITY_STEPS} clipped Adam updates on 256 images, card against CPU: "
        f"max |difference| {diff:.3e} (limit {TRAIN_PARITY_ATOL}) for a largest change of "
        f"{step:.3e}")
    if not diff <= TRAIN_PARITY_ATOL:
        raise AssertionError(f"training on the card differs from the CPU by {diff}")

    gen = torch.Generator(device=dev).manual_seed(seed)
    data = M.load_real_digits(cfg)
    source = "real digits"
    if data is None:
        data, source = M.synthetic_dataset(cfg, gen, 512), "512 synthetic images"
    sync(dev)
    t0 = time.perf_counter()
    trained, acc = M.train(cfg, gen, steps=TRAIN_STEPS, data=data, device=dev)
    sync(dev)
    train_s = time.perf_counter() - t0
    log(f"train on {source}: {train_s:.2f} s for {TRAIN_STEPS} steps "
        f"({train_s * 1e3 / TRAIN_STEPS:.2f} ms a step, the augmentation pool included), "
        f"held-out accuracy {acc:.4f} (limit > {TRAIN_MIN_ACC}) [{smi}]")
    if not acc > TRAIN_MIN_ACC:
        raise AssertionError(f"held-out accuracy {acc}")

    imgs = torch.as_tensor(data[0]).cpu().numpy()
    n = min(len(imgs), 2048)
    held = imgs[(n * 4) // 5:n][:cfg.batch]
    plain = M.model_forward(cfg, trained, held)
    M.encrypted_inference_fast(setup, trained, held, gen, gks_bsgs=gks)     # build
    sync(dev)
    reset_launches()
    logits = M.encrypted_inference_fast(                                  # the main path
        setup, trained, held, torch.Generator(device=dev).manual_seed(PIPE_ENC_SEED),
        gks_bsgs=gks).T
    sync(dev)
    launches = read_launches()
    if logits.shape != (cfg.batch, cfg.classes) or not np.all(np.isfinite(logits)):
        raise AssertionError(f"bad logits: shape {logits.shape} or non-finite values")
    err = float(np.max(np.abs(logits - plain)))
    agree = int(np.sum(np.argmax(logits, -1) == np.argmax(plain, -1)))
    log(f"the trained weights encrypted (BSGS + dual flow, {cfg.batch} held-out images): "
        f"labels agree with the plaintext pass on {agree}/{cfg.batch} (limit "
        f">= {TRAIN_MIN_AGREE}), max logit error {err:.3e} (largest |logit| "
        f"{float(np.max(np.abs(plain))):.2f}); launched {launches}")
    if agree < TRAIN_MIN_AGREE:
        raise AssertionError(f"encrypted labels agree on {agree} of {cfg.batch}")
    return dict(launches=launches, acc=acc, train_s=train_s, err=err, agree=agree,
                parity=diff, source=source)


# ---------------------------------------------------------------------------
# the sharded paths: a mesh of one rank here, then gloo ranks sharing the card
# ---------------------------------------------------------------------------

SHARD_N = 1 << 13
SHARD_TOWER = (28,) * 8              # the per-limb step: 8 x 28-bit limbs, batch 4
SHARD_B = 4
SHARD_WORLD = 8                      # ranks of the spawn; each case takes the first it needs
SHARD_2AXIS_TOWER = (29, 29, 28, 28)  # the four-step digit products need primes < 2^30
SHARD_2AXIS_B = 2
SHARD_PIPE_SEED = 37                 # keys of the sharded pipeline, made alike on every rank
SHARD_PIPE_MESH = (2, 2)             # (dp, rp) of phase 37


def _k1() -> dict:
    from toyfhe_tpu_torch.ops import ntt_cuda
    return dict(ntt_cuda.launches)


def _k1_since(before: dict) -> dict:
    after = _k1()
    return {k: after[k] - before[k] for k in after}


def _uniform(shape, primes, seed):
    return np.random.default_rng(seed).integers(0, min(primes), shape)


def _counts_match(counts: dict, model: dict) -> bool:
    from toyfhe_tpu_torch.parallel import distributed as D
    return D.counter_matches_model(counts, model)


def sharded_step_case(mesh, dev, n_rp, n_dp) -> dict:
    """make_sharded_step at N = 2^13, 8 x 28-bit limbs, batch 4 over ``mesh``
    against the single-device step on the card (synthetic keys)."""
    import toyfhe_tpu_torch as T
    from toyfhe_tpu_torch.parallel import distributed as D, ops as pops, sharding as S

    ring = T.make_rns_ring(SHARD_N, SHARD_TOWER)
    L = ring.nlimbs
    km = _uniform((L, L, SHARD_N), ring.primes, 350)
    kd = _uniform((L, L, SHARD_N), ring.primes, 351)
    batch = _uniform((SHARD_B, 2, L, SHARD_N), ring.primes, 352)
    step, place = pops.make_sharded_step(mesh, ring.tables, km, kd)
    block = place(batch)
    mesh.comm.reset()
    k1 = _k1()
    out = step(block)
    sync(dev)
    launches, counts = _k1_since(k1), mesh.comm.snapshot()
    on_device = block.device == mesh.device == out.device
    got = S.unshard(out, pops.DATA_SPEC, mesh)
    want = pops.make_single_chip_step(ring.tables, torch.as_tensor(km, device=dev),
                                      torch.as_tensor(kd, device=dev))(
        torch.as_tensor(batch, device=dev))
    model = D.sharded_step_comm_model(SHARD_N, L, n_rp, SHARD_B // n_dp)
    return {"equal": bool(torch.equal(got, want)), "dropped_zero": bool((got[:, :, -1] == 0).all()),
            "counter_is_model": _counts_match(counts, model), "on_device": on_device,
            "k1": launches, "counts": counts}


def hybrid_sharded_case(mesh, dev, n_rp, fused_schedule) -> dict:
    """The hybrid step at the serving gadget (MNISTConfig()'s HybridRaised(2, 4))
    on its 6-limb level over rp ranks, against the single-device step."""
    from toyfhe_tpu_torch.parallel import distributed as D, ops as pops, sharding as S

    _, tower, dnum, k, _ = HYBRID_CONFIGS[1]
    params = hybrid_params(SHARD_N, tower, dnum, k)
    ek = synthetic_eval_key(params, 353, dev)
    ring = params.ring_cipher.drop_last()
    batch = _uniform((SHARD_B, 2, ring.nlimbs, SHARD_N), ring.primes, 354)
    step, place = pops.make_hybrid_sharded_step(mesh, params, ek, ct_ring=ring,
                                                fused_schedule=fused_schedule, dp=False)
    block = place(batch)
    mesh.comm.reset()
    k1 = _k1()
    out = step(block)
    sync(dev)
    launches, counts = _k1_since(k1), mesh.comm.snapshot()
    on_device = block.device == mesh.device == out.device
    got = S.unshard(out, (None, None, "rp", None), mesh)
    single, splace = pops.make_hybrid_sharded_step(None, params, ek, ct_ring=ring,
                                                   fused_schedule=fused_schedule)
    want = single(splace(batch))
    model = D.sharded_step_comm_model(SHARD_N, ring.nlimbs, n_rp, SHARD_B,
                                      ncomp=4 if fused_schedule else 2)
    return {"equal": bool(torch.equal(got, want)), "dropped_zero": bool((got[:, :, -1] == 0).all()),
            "counter_is_model": _counts_match(counts, model), "on_device": on_device,
            "k1": launches, "counts": counts}


def two_axis_case(mesh, dev, n_rp, n_cp) -> dict:
    """make_2axis_step at N = 2^13 over rp x cp against the single-device
    step on the card."""
    import toyfhe_tpu_torch as T
    from toyfhe_tpu_torch.ops import ntt_mxu as MX
    from toyfhe_tpu_torch.parallel import distributed as D, ops as pops, sharding as S

    ring = T.make_rns_ring(SHARD_N, SHARD_2AXIS_TOWER)
    L = ring.nlimbs
    km = _uniform((L, L, SHARD_N), ring.primes, 360)
    kd = _uniform((L, L, SHARD_N), ring.primes, 361)
    batch = _uniform((SHARD_2AXIS_B, 2, L, SHARD_N), ring.primes, 362)
    step, place, (_, out_nat) = pops.make_2axis_step(mesh, MX.MxuNttTables(ring.tables), km, kd,
                                                     n_cp=n_cp)
    block = place(batch)
    mesh.comm.reset()
    out = step(block)
    sync(dev)
    counts = mesh.comm.snapshot()
    on_device = block.device == mesh.device == out.device
    got = S.unshard(out, (None, None, "rp", "cp"), mesh)
    nat = torch.zeros_like(got)
    nat[..., torch.as_tensor(out_nat, device=got.device)] = got
    want = pops.make_single_chip_step(ring.tables, torch.as_tensor(km, device=dev),
                                      torch.as_tensor(kd, device=dev))(
        torch.as_tensor(batch, device=dev))
    model = D.step2axis_comm_model(SHARD_N, L, n_rp, n_cp, SHARD_2AXIS_B)
    return {"equal": bool(torch.equal(nat, want)), "counter_is_model": _counts_match(counts, model),
            "on_device": on_device, "counts": counts}


def sharded_pipeline_setup(dev, cfg):
    """Keys, BSGS keys, weights and images of phase 37, made alike in every
    process from fixed seeds."""
    from toyfhe_tpu_torch.models import mnist as M
    gen = torch.Generator(device=dev).manual_seed(SHARD_PIPE_SEED)
    setup = M.fhe_setup(cfg, gen)
    gks = M.keygen_matmul_bsgs(setup, gen)
    weights = M.init_params(cfg, SHARD_PIPE_SEED)
    imgs = np.random.default_rng(SHARD_PIPE_SEED).uniform(0.0, 1.0,
                                                          (cfg.batch, cfg.image, cfg.image))
    return setup, gks, weights, imgs


def pipeline_case(mesh, dev, workdir, cfg) -> dict:
    """The BSGS + dual-flow pipeline over ``mesh``: one batch with the counts
    at 0 (the logits ciphertext saved for the parent), then warm batches."""
    import torch.distributed as dist
    from toyfhe_tpu_torch.models import mnist as M

    setup, gks, weights, imgs = sharded_pipeline_setup(dev, cfg)
    run = M.build_inference_pipeline(setup, weights, gks, mesh=mesh)
    enc_gen = lambda: torch.Generator(device=dev).manual_seed(PIPE_ENC_SEED)
    run(imgs, enc_gen(), _return_ct=True)                        # build's first batch
    mesh.comm.reset()
    k1 = _k1()
    ct = run(imgs, enc_gen(), _return_ct=True)
    sync(dev)
    launches, counts = _k1_since(k1), mesh.comm.snapshot()
    np.savez(os.path.join(workdir, f"pipe_rank{dist.get_rank()}.npz"),
             c0=ct.cs[0].dual.cpu().numpy(), c1=ct.cs[1].dual.cpu().numpy())
    walls = []
    for _ in range(PIPE_REPS):
        sync(dev)
        t = time.perf_counter()
        run(imgs, enc_gen(), _return_ct=True)
        sync(dev)
        walls.append((time.perf_counter() - t) * 1e3)
    return {"k1": launches, "counts": counts, "walls_ms": walls,
            "on_device": ct.cs[0].dual.device == mesh.device}


def sharded_rank(workdir: str, device: str, cfg: dict) -> dict:
    """One gloo rank of phases 35-37 (every rank on ``device``): each case
    on the first ranks it needs, every rank building every mesh; ``cfg``
    the pipeline's MNISTConfig fields."""
    import torch.distributed as dist
    from toyfhe_tpu_torch.models import mnist as M
    from toyfhe_tpu_torch.parallel import sharding as S

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rep = {"rank": dist.get_rank()}
    mesh = S.make_mesh(4, 2, device=dev)
    rep["per_limb_dp2xrp4"] = sharded_step_case(mesh, dev, 4, 2)
    for n_rp in (2, 3):
        mesh = S.make_mesh(n_rp, 1, device=dev, ranks=range(n_rp))
        for name, fused in (("v1", False), ("fused_schedule", True)):
            if mesh.member:
                rep[f"hybrid_rp{n_rp}_{name}"] = hybrid_sharded_case(mesh, dev, n_rp, fused)
    mesh = S.Mesh(("rp", "cp"), (2, 2), device=dev, ranks=range(4))
    if mesh.member:
        rep["two_axis"] = two_axis_case(mesh, dev, 2, 2)
    n_dp, n_rp = SHARD_PIPE_MESH
    mesh = S.make_mesh(n_rp, n_dp, device=dev, ranks=range(n_dp * n_rp))
    if mesh.member:
        rep["pipeline"] = pipeline_case(mesh, dev, workdir, M.MNISTConfig(
            **dict(cfg, limb_bits=tuple(cfg["limb_bits"]))))
    return rep


def _site_line(counts: dict) -> str:
    return ", ".join(f"{k} {v['kind']} x{v['count']} {sum(v['bytes'])} B"
                     for k, v in counts.items())


def _require(rep: dict, what: str, cuda: bool):
    """Every check of a case's report true, and on the card K1 launched."""
    bad = [k for k in ("equal", "dropped_zero", "counter_is_model", "on_device")
           if k in rep and not rep[k]]
    if bad:
        raise AssertionError(f"{what}: {bad} failed: {json.dumps(rep)[:1500]}")
    if cuda and "k1" in rep and not (rep["k1"]["fwd"] and rep["k1"]["inv"]):
        raise AssertionError(f"{what}: K1 was not launched: {rep['k1']}")


def phase_sharded_one_rank(dev):
    """Phase 35, part 1: every sharded entry point over a mesh of one rank in
    this process (no process group), bit-equal to the single-device path."""
    from toyfhe_tpu_torch.models import mnist as M
    from toyfhe_tpu_torch.parallel import sharding as S

    log("== phase 35: the sharded steps on the card; first every sharded entry point over a "
        "mesh of one rank in this process")
    one = S.make_mesh(1, 1, device=dev)
    rows = {"per_limb": sharded_step_case(one, dev, 1, 1)}
    for name, fused in (("v1", False), ("fused_schedule", True)):
        rows[f"hybrid_{name}"] = hybrid_sharded_case(one, dev, 1, fused)
    rows["two_axis"] = two_axis_case(S.Mesh(("rp", "cp"), (1, 1), device=dev), dev, 1, 1)
    cfg = M.MNISTConfig(image=8, kernel=4, stride=4, channels=2, classes=4, ring_logn=6)
    setup, gks, weights, imgs = sharded_pipeline_setup(dev, cfg)
    gen = lambda: torch.Generator(device=dev).manual_seed(PIPE_ENC_SEED)
    want = M.build_inference_pipeline(setup, weights, gks)(imgs, gen(), _return_ct=True)
    got = M.build_inference_pipeline(setup, weights, gks, mesh=one)(imgs, gen(), _return_ct=True)
    rows["pipeline_tiny"] = {"equal": all(torch.equal(a.dual, b.dual)
                                          for a, b in zip(got.cs, want.cs)),
                             "on_device": got.cs[0].dual.device == one.device}
    for name, rep in rows.items():
        _require(rep, f"one-rank {name}", dev.type == "cuda")
        log(f"  {name}: bit-equal to the single-device path on {dev}"
            + (f", K1 {rep['k1']}" if "k1" in rep else "")
            + (f"; counter = model ({_site_line(rep['counts'])})" if "counts" in rep else ""))


def phase_sharded_ranks(dev, smi, cfg=None):
    """Phases 35 (part 2), 36 and 37: one spawn of gloo ranks sharing the
    card; the parent holds the pipeline's ciphertexts against its own."""
    import dataclasses
    import tempfile
    from toyfhe_tpu_torch.models import mnist as M
    from toyfhe_tpu_torch.parallel import launch

    cfg = M.MNISTConfig() if cfg is None else cfg
    n_dp, n_rp = SHARD_PIPE_MESH
    log(f"== phase 37 (its single-device side, in this process): MNISTConfig() with BSGS + dual "
        f"flow on keys from seed {SHARD_PIPE_SEED}")
    setup, gks, weights, imgs = sharded_pipeline_setup(dev, cfg)
    ct = M.build_inference_pipeline(setup, weights, gks)(
        imgs, torch.Generator(device=dev).manual_seed(PIPE_ENC_SEED), _return_ct=True)
    want = [x.dual.cpu().numpy() for x in ct.cs]
    logits = M.decrypt(setup.kp, ct).real.reshape(cfg.positions, cfg.batch)[:cfg.classes].T
    err = float(np.max(np.abs(logits - M.model_forward(cfg, weights, imgs))))
    del setup, gks
    torch.cuda.empty_cache()

    log(f"spawning {SHARD_WORLD} gloo ranks on {dev} (phases 35-37)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as work:
        reps = launch.run_ranks("chip_smoke:sharded_rank", SHARD_WORLD, work,
                                args={"device": str(dev), "cfg": dataclasses.asdict(cfg)},
                                timeout_s=600.0)
        pipes = {}
        for r in range(SHARD_PIPE_MESH[0] * SHARD_PIPE_MESH[1]):
            with np.load(os.path.join(work, f"pipe_rank{r}.npz")) as z:
                pipes[r] = dict(z)
    log(f"ranks done in {time.perf_counter() - t0:.1f} s (host clock, spawn to exit)")

    log(f"== phase 35 (part 2): make_sharded_step at N=2^13, {len(SHARD_TOWER)} x 28-bit limbs, "
        f"batch {SHARD_B}, over dp 2 x rp 4; the hybrid steps at the serving gadget's 6-limb "
        "level over rp 2 and rp 3")
    out = {"k1": {}}
    for rep in reps:
        for key in [k for k in rep if k.startswith(("per_limb", "hybrid_"))]:
            _require(rep[key], f"rank {rep['rank']} {key}", dev.type == "cuda")
            out["k1"].setdefault(key, {})[rep["rank"]] = rep[key]["k1"]
    for key, per_rank in out["k1"].items():
        c = reps[0][key]["counts"]
        log(f"  {key}: every rank bit-equal to the single-device step on {dev}, dropped limb "
            f"zeroed, counter = sharded_step_comm_model ({_site_line(c)} on rank 0); K1 per rank "
            + ", ".join(f"{r}: {v['fwd']}+{v['inv']}" for r, v in sorted(per_rank.items())))

    log("== phase 36: make_2axis_step at N=2^13 over rp 2 x cp 2")
    for rep in reps[:4]:
        _require(rep["two_axis"], f"rank {rep['rank']} two_axis", dev.type == "cuda")
    log(f"  every rank bit-equal to the single-device step; counter = step2axis_comm_model "
        f"({_site_line(reps[0]['two_axis']['counts'])} on rank 0)")

    log(f"== phase 37: the sharded MNIST pipeline at MNISTConfig() over dp {n_dp} x rp {n_rp} "
        f"gloo ranks on {dev}")
    walls = []
    for rep in reps[:n_dp * n_rp]:
        got = pipes[rep["rank"]]
        if not (np.array_equal(got["c0"], want[0]) and np.array_equal(got["c1"], want[1])):
            raise AssertionError(f"rank {rep['rank']}: sharded logits ciphertext differs")
        _require(rep["pipeline"], f"rank {rep['rank']} pipeline", dev.type == "cuda")
        walls.append(float(np.median(rep["pipeline"]["walls_ms"])))
        log(f"  rank {rep['rank']}: logits ciphertext bit-equal to the single-device pipeline; "
            f"K1 {rep['pipeline']['k1']['fwd']}+{rep['pipeline']['k1']['inv']}; collectives "
            f"{_site_line(rep['pipeline']['counts'])}; warm "
            f"{', '.join(f'{w:.1f}' for w in rep['pipeline']['walls_ms'])} ms/batch")
    if not err < 0.5:
        raise AssertionError(f"logit error {err} >= 0.5")
    log(f"  logits vs model_forward: max abs error {err:.3e} (limit 0.5); warm ms per batch, "
        f"median over ranks {float(np.median(walls)):.1f} [{smi}] (all ranks share one card: a "
        "correctness check, not a scaling figure)")
    out["pipeline"] = {r["rank"]: r["pipeline"] for r in reps[:n_dp * n_rp]}
    out["ms"] = float(np.median(walls))
    return out


def phase_multihost(dev):
    from toyfhe_tpu_torch.tools import dryrun

    log(f"== phase 38: dryrun_multihost(2) on {dev}: 2 hosts of 2 gloo ranks, dp across the "
        "hosts, rp inside each")
    t0 = time.perf_counter()
    reps = dryrun.dryrun_multihost(2, device=dev)
    for rep in reps:
        log(f"  rank {rep['rank']} host {rep['host']} {rep['coords']}: bit-equal to the "
            f"single-device step ({_site_line(rep['counts'])})")
    log(f"took {time.perf_counter() - t0:.1f} s (host clock)")
    return reps


# ---------------------------------------------------------------------------
# phase 39: the limb-sharded refresh
# ---------------------------------------------------------------------------

SHARD_BOOT_SEED = 39                 # keys of (a) and (b), made alike on every rank
SHARD_BOOT_WORLD = 4                 # (b) over rp 4; (c) on the first 2 ranks
SHARD_BOOT_FULL_RP = 2


def boot_small_material(dev, logn: int = BOOT_SMALL_LOGN):
    """(params, key pair, context, exhausted ciphertext, slots) of phase
    39 (a) and (b): the production recipe at N = 2^logn, made on ``dev``
    from one seed alike in every process."""
    import toyfhe_tpu_torch as T
    from toyfhe_tpu_torch.core import bootstrap as B
    from toyfhe_tpu_torch.models import mnist as M

    recipe = boot_recipe()
    depth, hw = recipe.pop("depth"), recipe.pop("hamming_weight")
    params, _ = M.make_bootstrapped_params(M.MNISTConfig(ring_logn=logn), depth,
                                           hamming_weight=hw, scale_limbs=recipe["scale_limbs"])
    gen = torch.Generator(device=dev).manual_seed(SHARD_BOOT_SEED)
    kp = T.keygen(params, gen)
    ctx = B.setup_bootstrap(gen, kp.priv, **recipe)
    vals = boot_vals(1 << (logn - 1), SHARD_BOOT_SEED)
    return params, kp, ctx, boot_exhausted(params, kp, vals, gen), vals


def held_mib(ctx) -> tuple:
    """(key MiB, plain-cache MiB) a context holds on this rank."""
    return (key_bytes(ctx.ek, ctx.gks, ctx.gk_conj) / 2 ** 20, cache_bytes(ctx) / 2 ** 20)


def sharded_refresh_case(mesh, ctx, c, want, kp, vals, dev, single_mib, c2=None,
                         want2=None) -> dict:
    """The refresh of ``c`` with ``ctx`` and ``c`` placed limb-wise on
    ``mesh``: cold, then one warm refresh with the counts at 0 (K1
    launches, collectives by site, the output gathered), then
    ``BOOT_REPS`` warm refreshes timed, and one more with the card
    synchronised around each collective and the time in its transport
    summed (waits for the other ranks included); the gathered output against the
    single device's ``want`` (and with ``c2`` the batch of two against
    ``want`` and ``want2``). ``single_mib``: the single device's (key,
    plain-cache) MiB, printed beside the rank's."""
    import toyfhe_tpu_torch as T
    from toyfhe_tpu_torch.core import bootstrap as B
    from toyfhe_tpu_torch.parallel import sharding as S

    sctx, sc = S.shard_limbwise(ctx, mesh), S.shard_limbwise(c, mesh)
    sync(dev)
    t0 = time.perf_counter()
    B.bootstrap(sctx, sc)
    sync(dev)
    cold_ms = (time.perf_counter() - t0) * 1e3
    reset_launches()
    mesh.comm.reset()
    out = S.gather_limbwise(B.bootstrap(sctx, sc))                     # the sharded path
    sync(dev)
    launches, counts = read_launches(), mesh.comm.snapshot()
    warm = []
    for _ in range(BOOT_REPS):
        sync(dev)
        t0 = time.perf_counter()
        B.bootstrap(sctx, sc)
        sync(dev)
        warm.append((time.perf_counter() - t0) * 1e3)
    comm_s, transport = [0.0], S._all_gather_single

    def timed_transport(buf, inp, group):
        sync(dev)
        t = time.perf_counter()
        transport(buf, inp, group=group)
        sync(dev)
        comm_s[0] += time.perf_counter() - t

    S._all_gather_single = timed_transport            # one more warm refresh, its transport timed
    try:
        sync(dev)
        t0 = time.perf_counter()
        B.bootstrap(sctx, sc)
        sync(dev)
        comm_run_ms = (time.perf_counter() - t0) * 1e3
    finally:
        S._all_gather_single = transport
    same = lambda a, w: all(np.array_equal(x, y) for x, y in zip(ct_numpy(a), w))
    rep = {"equal": same(out, want), "levels": out.ring.nlimbs,
           "comm_ms": comm_s[0] * 1e3, "comm_run_ms": comm_run_ms,
           "err": float(np.max(np.abs(T.decrypt(kp, out) - vals))),
           "held": list(sctx.ek.key.ring.held), "rows": sctx.ek.key.ring.nlimbs,
           "cold_ms": cold_ms, "warm_ms": warm,
           "k1": {k: launches[k] for k in ("fwd", "inv")}, "other_kernels": non_k1_launches(launches),
           "counts": {k: {"count": v["count"], "bytes": sum(v["bytes"])} for k, v in counts.items()},
           "mib": held_mib(sctx), "single_mib": single_mib,
           "on_device": out.cs[0].device == mesh.device}
    if c2 is not None:
        sb = S.shard_limbwise(T.ct_stack([c, c2]), mesh)
        outb = S.gather_limbwise(B.bootstrap_batched(sctx, sb))
        rep["batched_equal"] = same(T.ct_index(outb, 0), want) and same(T.ct_index(outb, 1), want2)
    return rep


def sharded_boot_rank(workdir: str, device: str, cfg: dict, single_mib: dict,
                      small_logn: int) -> dict:
    """One gloo rank of phase 39 (every rank on ``device``): (b) the
    N = 2^small_logn refresh over rp 4, then (c) phase 26's refresh at
    ``cfg`` (the MNISTConfig fields) over rp 2 on the first two ranks."""
    import torch.distributed as dist
    from toyfhe_tpu_torch.models import mnist as M
    from toyfhe_tpu_torch.parallel import sharding as S

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    with np.load(os.path.join(workdir, "want.npz")) as z:
        want = {k: z[k] for k in z.files}
    rep = {"rank": dist.get_rank()}
    mesh = S.make_mesh(SHARD_BOOT_WORLD, 1, device=dev)
    _, kp, ctx, c, vals = boot_small_material(dev, small_logn)
    rep["small"] = sharded_refresh_case(mesh, ctx, c, [want["small0"], want["small1"]], kp,
                                        vals, dev, single_mib["small"])
    del ctx
    mesh = S.make_mesh(SHARD_BOOT_FULL_RP, 1, device=dev, ranks=range(SHARD_BOOT_FULL_RP))
    if mesh.member:
        cfg = M.MNISTConfig(**dict(cfg, limb_bits=tuple(cfg["limb_bits"])))
        gen, setup, ctx = boot_full_keys(dev, cfg)
        h = 1 << (cfg.ring_logn - 1)
        vals = boot_vals(h, BOOT_FULL_SEED)
        c = boot_exhausted(setup.params, setup.kp, vals, gen)
        c2 = boot_exhausted(setup.params, setup.kp, boot_vals(h, BOOT_FULL_SEED + 100), gen)
        rep["full"] = sharded_refresh_case(mesh, ctx, c, [want["full0"], want["full1"]],
                                           setup.kp, vals, dev, single_mib["full"], c2,
                                           [want["full2_0"], want["full2_1"]])
    return rep


def _shard_boot_line(what: str, rep: dict) -> str:
    k, (kmib, cmib), (skmib, scmib) = rep["k1"], rep["mib"], rep["single_mib"]
    return (f"  {what} rank {rep['rank']} (key-tower rows {rep['held'][:3]}..., "
            f"{len(rep['held'])} of {rep['rows']}): {rep['levels']} limbs out, "
            f"error {rep['err']:.3e}; cold {rep['cold_ms']:.1f} ms, warm "
            f"{float(np.median(rep['warm_ms'])):.1f} ms (median of {len(rep['warm_ms'])}: "
            f"{', '.join(f'{w:.1f}' for w in rep['warm_ms'])}; in a further refresh of "
            f"{rep['comm_run_ms']:.1f} ms synchronised around each collective, "
            f"{rep['comm_ms']:.1f} ms in the all-gathers); K1 {k['fwd']} + {k['inv']} "
            f"launches a refresh; collectives " + ", ".join(
                f"{s} x{v['count']} {v['bytes'] / 2 ** 20:.2f} MiB" for s, v in rep["counts"].items())
            + f"; keys {kmib:.1f} MiB of the single device's {skmib:.1f}, plain cache "
            f"{cmib:.1f} MiB of {scmib:.1f}")


def _require_refresh(rep: dict, what: str, cuda: bool, levels: int = 0):
    bad = [k for k in ("equal", "on_device", "batched_equal") if k in rep and not rep[k]]
    if bad or rep["other_kernels"] or rep["levels"] < levels or not rep["err"] < 1e-3:
        raise AssertionError(f"{what}: {bad} failed, {rep['levels']} limbs, error {rep['err']}, "
                             f"other kernels {rep['other_kernels']}")
    if cuda and not (rep["k1"]["fwd"] and rep["k1"]["inv"]):
        raise AssertionError(f"{what}: K1 was not launched: {rep['k1']}")


def phase_boot_sharded(dev, smi, boot, cfg=None, small_logn: int = BOOT_SMALL_LOGN) -> dict:
    """Phase 39: the limb-sharded refresh. (a) A mesh of one rank in this
    process at N = 2^10; (b) 4 gloo ranks sharing the card at N = 2^10 over
    rp 4; (c) phase 26's full-width refresh over rp 2 on the first two of
    them, and its batch of two; each bit-equal to the single-device refresh
    on the card. Then ``tools.dryrun.dryrun_multichip(4)`` with its refresh
    flavour. ``boot`` is phase 26's report; ``cfg`` (default
    ``MNISTConfig()``) phase 26's configuration; ``small_logn`` the ring of
    (a) and (b)."""
    import dataclasses
    import tempfile
    import toyfhe_tpu_torch as T
    from toyfhe_tpu_torch.core import bootstrap as B
    from toyfhe_tpu_torch.models import mnist as M
    from toyfhe_tpu_torch.parallel import launch, sharding as S
    from toyfhe_tpu_torch.tools import dryrun

    cfg = M.MNISTConfig() if cfg is None else cfg
    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    log(f"== phase 39: the limb-sharded refresh (B.bootstrap(S.shard_limbwise(ctx, mesh), "
        f"S.shard_limbwise(c, mesh)), strided rows: rank r holds the key-tower rows = r mod rp)")
    _, kp, ctx, c, vals = boot_small_material(dev, small_logn)
    single = B.bootstrap(ctx, c)
    want_small = ct_numpy(single)
    log(f"(a) a mesh of one rank in this process, N=2^{small_logn} on the production tower "
        f"(keys from seed {SHARD_BOOT_SEED} on {dev})")
    small_mib = held_mib(ctx)
    one = sharded_refresh_case(S.make_mesh(1, 1, device=dev), ctx, c, want_small, kp, vals, dev,
                               small_mib)
    one["rank"] = 0
    _require_refresh(one, "one-rank refresh", cuda)
    log(_shard_boot_line("one-rank mesh", one) + " [bit-equal]")
    del ctx, single

    log(f"(b), (c): spawning {SHARD_BOOT_WORLD} gloo ranks on {dev}; (b) N=2^{small_logn} "
        f"over rp {SHARD_BOOT_WORLD}, (c) N=2^{cfg.ring_logn} ({boot_recipe()}) over rp "
        f"{SHARD_BOOT_FULL_RP} on ranks 0-{SHARD_BOOT_FULL_RP - 1}, phase 26's keys made again "
        f"from seed {BOOT_FULL_SEED}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_boot_ranks_") as work:
        np.savez(os.path.join(work, "want.npz"), small0=want_small[0], small1=want_small[1],
                 full0=boot["want"][0][0], full1=boot["want"][0][1],
                 full2_0=boot["want"][1][0], full2_1=boot["want"][1][1])
        reps = launch.run_ranks("chip_smoke:sharded_boot_rank", SHARD_BOOT_WORLD, work,
                                args={"device": str(dev), "cfg": dataclasses.asdict(cfg),
                                      "single_mib": {"small": small_mib,
                                                     "full": held_mib(boot["ctx"])},
                                      "small_logn": small_logn},
                                timeout_s=600.0)
    log(f"ranks done in {time.perf_counter() - t0:.1f} s (host clock, spawn to exit)")
    out = {"one": one, "small": {}, "full": {}}
    for rep in reps:
        rep["small"]["rank"] = rep["rank"]
        _require_refresh(rep["small"], f"rank {rep['rank']} N=2^{small_logn} rp "
                         f"{SHARD_BOOT_WORLD}", cuda)
        log(_shard_boot_line(f"(b) rp {SHARD_BOOT_WORLD}", rep["small"]) + " [bit-equal]")
        out["small"][rep["rank"]] = rep["small"]
    for rep in reps[:SHARD_BOOT_FULL_RP]:
        rep["full"]["rank"] = rep["rank"]
        _require_refresh(rep["full"], f"rank {rep['rank']} full width rp {SHARD_BOOT_FULL_RP}",
                         cuda, levels=13 if cfg == M.MNISTConfig() else 0)
        log(_shard_boot_line(f"(c) rp {SHARD_BOOT_FULL_RP}", rep["full"])
            + " [bit-equal to phase 26; bootstrap_batched on 2 == the singles]")
        out["full"][rep["rank"]] = rep["full"]
    log(f"single device (phase 26): cold {boot['cold_ms']:.1f} ms, warm {boot['warm_ms']:.1f} ms; "
        f"the ranks share one card and the host's cores, so their times are a correctness "
        f"record, not a scaling figure [{smi}]")

    t0 = time.perf_counter()
    reps = dryrun.dryrun_multichip(SHARD_BOOT_WORLD, device=dev)
    for rep in reps:
        r = rep["refresh"]
        log(f"  dryrun_multichip({SHARD_BOOT_WORLD}) rank {rep['rank']}: every flavour bit-equal; "
            f"refresh flavour (bootstrap_phase1, N=16, 8 + 4 limbs, rp {r['rp']}, rows "
            f"{r['held']}): {_site_line(r['counts'])}")
    log(f"dry run took {time.perf_counter() - t0:.1f} s; phase 39 took "
        f"{time.perf_counter() - t_phase:.1f} s (host clock)")
    return out


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
    parser = argparse.ArgumentParser(description="On-card smoke run of toyfhe_tpu_torch.")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the exact schemes' keys, slot vectors and encryptions")
    args = parser.parse_args()
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
    boot_small = phase_boot_card_vs_cpu(dev, smi)
    boot = phase_boot_full(dev, smi)
    bmn = phase_boot_mnist(dev, smi, boot)
    exact_err = phase_exact_k1_goldens(dev)
    tree = phase_bfv_tree(dev, smi, args.seed)
    bgv = phase_bgv_levels(dev, smi, args.seed)
    t0 = time.perf_counter()
    host = phase_host_oracle(dev, smi, args.seed)
    log(f"phase 31 took {time.perf_counter() - t0:.1f} s (host clock)")
    native = phase_native_decodes(dev, smi, dict(setup=pipe["setup"], imgs=pipe["imgs"],
                                                 layers=bsgs["layers"]), tree, bgv)
    ser = phase_serialization(dev, smi, pipe, bsgs)
    trained = phase_training(dev, smi, pipe, bsgs, args.seed)
    t0 = time.perf_counter()
    phase_sharded_one_rank(dev)
    sharded = phase_sharded_ranks(dev, smi)
    phase_multihost(dev)
    log(f"phases 35-38 took {time.perf_counter() - t0:.1f} s (host clock)")
    sboot = phase_boot_sharded(dev, smi, boot)

    # No single PyTorch call computes a modular transform, a modular
    # polynomial product or a key switch, so library_ms is null in every row.
    shape = "B*L=28, N=2^13"
    kernels = [
        {"name": f"k1_ntt_{k}", "route": "cuda", "source": "toyfhe_tpu_torch/csrc/ntt.cu",
         "replaces": f"toyfhe_tpu/ops/ntt_mxu_pallas.py:{line}",
         "launches": bmn["launches"][k],
         "launches_by_path": {"mnist_iterated": pipe["launches"][k],
                              "mnist_bsgs_dual_flow": bsgs["launches"][k],
                              "refresh_n2^10": boot_small["launches"][k],
                              "refresh_n2^13": boot["launches"][k],
                              "mnist_bootstrapped": bmn["launches"][k],
                              "bfv_tree_n2^13": tree["launches"][k],
                              "bgv_modraised_3_levels": bgv["modraised"]["launches"][k],
                              "bgv_hybrid_2_levels": bgv["hybrid"]["launches"][k],
                              "host_oracle_n2^13": host["launches"][k],
                              "mnist_bsgs_loaded_keys": ser["launches"][k],
                              "mnist_bsgs_trained_weights": trained["launches"][k],
                              **{f"sharded_{path}_rank{r}": v[k]
                                 for path, per_rank in sharded["k1"].items()
                                 for r, v in per_rank.items()},
                              **{f"mnist_sharded_dp2xrp2_rank{r}": v["k1"][k]
                                 for r, v in sharded["pipeline"].items()},
                              "refresh_n2^10_sharded_one_rank": sboot["one"]["k1"][k],
                              **{f"refresh_n2^10_sharded_rp4_rank{r}": v["k1"][k]
                                 for r, v in sboot["small"].items()},
                              **{f"refresh_n2^13_sharded_rp2_rank{r}": v["k1"][k]
                                 for r, v in sboot["full"].items()}},
         "max_abs_err": max(err[k], exact_err[k]),
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
        f"{kpath['decode_err']:.3e}, hoisted {hoist['decode_err']:.3e}; refresh at N=2^13 "
        f"{boot['warm_ms']:.1f} ms warm ({boot['cold_ms']:.1f} cold, {boot['batch_ms']:.1f} per "
        f"refresh in a batch of 2), {boot['levels']} limbs out at error {boot['err']:.3e}; "
        f"bootstrapped MNIST {bmn['ms']:.1f} ms per batch, depth_out {bmn['depth_out']}, logit "
        f"error {bmn['err']:.3e}, K1 {bmn['launches']['fwd']} + {bmn['launches']['inv']} "
        f"launches; BFV product tree at N=2^13 "
        f"{sum(lv['ms']['level'] for lv in tree['levels']):.2f} ms over its 4 levels, last "
        f"budget {tree['levels'][-1]['budget']:.1f} bits, K1 {tree['launches']['fwd']} + "
        f"{tree['launches']['inv']} launches; BGV "
        + ", ".join(f"{k} {len(v['rows'])} levels {sum(r['ms'] for r in v['rows']):.2f} ms, last "
                    f"budget {v['rows'][-1]['budget']:.1f} bits" for k, v in bgv.items())
        + f"; host engine at N=2^13 {host['host_s']:.1f} s, the card's square -> key switch -> "
        f"rescale {host['ms']['all']:.3f} ms, bit-equal; C++ CRT decodes exact "
        f"({', '.join('%s %.2f ms' % (k, v['native_ms']) for k, v in native.items())}); setup "
        f"files {ser['mib']:.1f} MiB, saved in {ser['save_ms']:.0f} ms, loaded in "
        f"{ser['load_ms']:.0f} ms, logits bit-equal on the loaded keys; training "
        f"{trained['train_s'] * 1e3 / TRAIN_STEPS:.2f} ms a step, held-out accuracy "
        f"{trained['acc']:.4f}, encrypted labels {trained['agree']}/{pipe['batch']}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
