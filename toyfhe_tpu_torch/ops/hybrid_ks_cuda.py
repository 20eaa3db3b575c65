"""Wrapper of the hand-written CUDA fused hybrid key switch
(``csrc/hybrid_ks.cu``).

Replaces the TPU kernel ``toyfhe_tpu/ops/pallas_hybrid_ks.py::
FusedHybridKS.__call__`` (K3, body ``_fused_kernel``). Its plain twin is
:func:`.hybrid_ks.fused_hybrid_ks_plain`, which it equals bit for bit.

One kernel, the cluster kernel, which :func:`launch` runs: one thread-block
cluster per (row, output limb) pair, each digit built in the
load pass and transformed by K1's register-radix DIT passes
(:func:`.ntt_cuda.schedule_plan`), the key products taken in the closing pass
into accumulators that live in registers across the digits. The cluster
either deals the digits out over its blocks (``scheme="digits"``) or splits
the polynomial over them (``scheme="poly"``); :func:`choose_cluster` picks.
:func:`hybrid_ks_schedule` is its schedule in plain torch, pass for pass and
index for index, for the CPU tests.

Built by ``nvcc`` from ``toyfhe_tpu_torch/csrc/hybrid_ks.cu`` at first use
(:mod:`.cuda_lib`). ``launches["k3"]`` counts the launches made through
:func:`launch`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from .cuda_lib import CI, VP, CudaLibrary
from .modmath import canonical_device
from .ntt_cuda import (BLOCK_CAP, LAZY_PRIME_LIMIT, MIN_CHOSEN_BLOCK_N, SPLIT_FROM_N, _bitrev,
                       _stages, check_n, kernel_tables, pack_plan, schedule_plan, swizzle,
                       u32_table)
from .ntt_pallas_cuda import _DifArith, _int64_tables, _lazy_flag, dit_local_passes

LIB = CudaLibrary("hybrid_ks", {
    "toyfhe_hybrid_ks_cluster": ([VP] * 11 + [CI] * 11 + [VP], CI),
    "toyfhe_hybrid_ks_cluster_attrs": ([CI] * 2 + [VP], CI),
})
launches = {"k3": 0}
CLUSTERS = (1, 2, 4)             # blocks per (row, limb) pair the cluster kernel takes
SCHEMES = ("digits", "poly")     # what the blocks of a cluster share
MIN_BLOCK_N = 8                  # fewest residues one block of a split polynomial holds
REG_ACC_MAX_N = 1 << 13          # blocks of more residues keep partial rows in memory
SMEM_PARTIALS_MAX_N = 1 << 14    # above it the partial rows live in device scratch
THREADS = 512                    # most threads a block runs


# ---------------------------------------------------------------------------
# the cluster kernel's launch plan (host side, shared with the schedule twin)
# ---------------------------------------------------------------------------

def legal_clusters(n: int, dnum: int, scheme: str = "digits") -> Tuple[int, ...]:
    """The cluster sizes the kernel takes at ring degree ``n`` with ``dnum``
    digit groups. ``"digits"``: every block gets a digit (G = 1 is the block
    that loops over all of them). ``"poly"``: every block keeps between
    ``MIN_BLOCK_N`` and ``REG_ACC_MAX_N`` residues of each digit, its
    accumulators in registers."""
    if scheme == "digits":
        return tuple(g for g in CLUSTERS if g <= dnum)
    if scheme == "poly":
        return tuple(c for c in CLUSTERS if c > 1 and MIN_BLOCK_N <= n // c <= REG_ACC_MAX_N)
    raise ValueError(f"unknown K3 cluster scheme {scheme!r}")


def choose_cluster(pairs: int, n: int, dnum: int, primes) -> Tuple[str, int, bool]:
    """``(scheme, blocks, lazy)`` for one launch of ``pairs`` (row, output
    limb) pairs, from the device times of every launch shape at N = 2^12 .. 2^15
    and 28 to 176 pairs (``tools/k3_experiments.py shapes``):

    * a launch that leaves SMs free spreads over them: the digits over the
      largest legal G with ``pairs * G`` within ``BLOCK_CAP`` blocks, or,
      where the polynomial can be split further than the digits dealt out
      (one digit group, or few pairs), the polynomial over the largest C that
      also keeps ``MIN_CHOSEN_BLOCK_N`` residues in a block;
    * a launch that fills the card by itself takes one block a pair below
      N = 2^13 and two from there on, each with half of the digits (where
      there is one digit group, the fewest blocks that split the polynomial).

    ``lazy`` needs every prime of the expanded tower below 2^30."""
    lazy = max(int(p) for p in primes) < LAZY_PRIME_LIMIT
    digits = max([g for g in legal_clusters(n, dnum) if pairs * g <= BLOCK_CAP] + [1])
    poly = max([c for c in legal_clusters(n, dnum, "poly")
                if pairs * c <= BLOCK_CAP and n // c >= MIN_CHOSEN_BLOCK_N] + [1])
    if digits > 1 and digits >= poly:
        return "digits", digits, lazy
    if poly > 1:
        return "poly", poly, lazy
    if n < SPLIT_FROM_N:
        return "digits", 1, lazy
    return ("digits", 2, lazy) if dnum >= 2 else ("poly", min(legal_clusters(n, dnum, "poly")), lazy)


def hybrid_ks_plan(logn: int, cluster: int, scheme: str = "digits") -> dict:
    """The cluster kernel's passes of one digit at N = 2^logn: ``local`` the
    in-place DIT passes over a block's own residues, low bits first, ``kf``
    the stages of the closing pass with the key products
    (:func:`.ntt_cuda.schedule_plan` for the blocks that share a polynomial:
    ``cluster`` under ``"poly"``, one under ``"digits"``)."""
    if scheme not in SCHEMES or cluster not in CLUSTERS:
        raise ValueError(f"no K3 plan for scheme {scheme!r}, cluster {cluster}")
    local, kf = schedule_plan(logn, cluster if scheme == "poly" else 1)
    return {"local": local, "kf": kf}


def block_shape(n: int, cluster: int, scheme: str = "digits") -> dict:
    """Threads, dynamic shared-memory bytes and barriers a digit of one
    block, as the C launcher sets them: two digit rows in turns up to 2^13
    residues a block (one above), and the two partial rows up to N = 2^14
    when the result goes through them."""
    per_block = n // cluster if scheme == "poly" else n
    rows = 2 if per_block <= REG_ACC_MAX_N else 1
    parts = per_block > REG_ACC_MAX_N or (scheme == "digits" and cluster > 1)
    words = rows * per_block + (2 * n if parts and n <= SMEM_PARTIALS_MAX_N else 0)
    local, _ = schedule_plan(n.bit_length() - 1, cluster if scheme == "poly" else 1)
    return {"threads": min(THREADS, max(32, per_block // 8)), "smem": 4 * words,
            "barriers": 1 + len(local) + (0 if rows == 2 else 1)}


def scratch_words(pairs: int, n: int, cluster: int, scheme: str) -> int:
    """32-bit words of device scratch one launch needs: the two partial rows
    of every block that holds a whole polynomial above N = 2^14 (0 when they
    fit shared memory, or the accumulators registers)."""
    if n <= SMEM_PARTIALS_MAX_N or scheme == "poly":
        return 0
    return pairs * cluster * 2 * n


# ---------------------------------------------------------------------------
# the schedule twin (plain torch, CPU tests)
# ---------------------------------------------------------------------------

def hybrid_ks_schedule(fks, y: torch.Tensor, cluster: int, lazy: Optional[bool] = None,
                       scheme: str = "digits"):
    """The cluster kernel's schedule on a CPU tensor ŷ int64 [..., lt, N]:
    returns ``((acc1, acc2), largest intermediate value)``.

    Follows ``csrc/hybrid_ks.cu`` index for index. Under ``"digits"`` block g
    of the cluster takes the digits g, g + G, ...; under ``"poly"`` every
    block takes every digit and block r holds the coefficients
    ``i = C v + bitrev(r)``. A digit's load pass forms the sum over its ct
    limbs, twists it and stores it to the swizzled word of ``bitrev(v)``; the
    local passes of :func:`hybrid_ks_plan` run in place; the closing pass
    gathers element e of base b from block ``(b + e 2^bf) >> log2(N / C)``,
    runs the last stages, multiplies by the two key rows and adds into the
    accumulators of its positions; the partial sums of the blocks that share
    the digits are added and reduced. ``lazy`` as the kernel's flag:
    ``None`` takes it whenever every prime is below 2^30."""
    tables = fks.exp_ring.tables
    n, logn, T = tables.n, tables.n.bit_length() - 1, fks.exp_ring.nlimbs
    if y.dim() < 2 or y.shape[-1] != n or y.shape[-2] != fks.lt:
        raise ValueError(f"expected [..., {fks.lt}, {n}], got {tuple(y.shape)}")
    if cluster not in legal_clusters(n, fks.dnum_t, scheme):
        raise ValueError(f"cluster size {cluster} is not legal for K3 ({scheme}) at N = {n} "
                         f"with {fks.dnum_t} digits")
    lazy = _lazy_flag(tables, lazy)
    plan = hybrid_ks_plan(logn, cluster, scheme)
    gshare, nblocks = (cluster, 1) if scheme == "digits" else (1, cluster)
    logc = nblocks.bit_length() - 1
    m, kf = logn - logc, plan["kf"]
    bf, msize = logn - kf, 1 << (logn - logc)
    (twist, tw), _ = _int64_tables(tables)
    ar = _DifArith(tables, lazy)
    d = fks.on("cpu")
    lead = tuple(y.shape[:-2])
    yb = y.reshape(-1, fks.lt, n)
    nb = yb.shape[0]

    v = np.arange(msize)
    dest = torch.as_tensor(swizzle(_bitrev(v, m), m))
    base = np.arange(1 << bf)
    q = base[:, None] + (np.arange(1 << kf) << bf)[None, :]                     # [T, 2^kf]
    at = torch.as_tensor(q)
    rank, where = torch.as_tensor(q >> m), torch.as_tensor(swizzle(q & (msize - 1), m))

    parts = torch.zeros((gshare, 2, nb, T, n), dtype=torch.int64)
    for g in range(gshare):
        for j in range(g, fks.dnum_t, gshare):
            lo, hi = fks.bounds[j]
            smem = torch.zeros((nb, T, nblocks, msize), dtype=torch.int64)
            for r in range(nblocks):
                i = torch.as_tensor(nblocks * v + int(_bitrev(np.array([r]), logc)[0]))
                dig = torch.zeros((nb, T, msize), dtype=torch.int64)
                for a in range(hi - lo):
                    term = ar.see(ar.mul(yb[:, lo + a][:, None, i], d["cst"][j, :, a, None][None]))
                    dig = ar.add(dig, term)
                smem[:, :, r, dest] = ar.see(ar.mul(dig, twist[:, i][None]))
            assert dit_local_passes(ar, smem, tw, m, 0, plan["local"], swizzled=True) == bf
            regs = _stages(ar, smem[:, :, rank, where][:, :, None], tw, bf, kf, base)[:, :, 0]
            for ch, name in enumerate(("kd", "km")):
                prod = ar.see(ar.mul(regs, d[name][j][:, at][None]))
                parts[g, ch][..., at] = ar.add(parts[g, ch][..., at], prod)
    outs = []
    for ch in range(2):
        acc = torch.zeros((nb, T, n), dtype=torch.int64)
        for g in range(gshare):
            acc = ar.add(acc, parts[g, ch])
        acc = ar.canonical(acc, 2) if lazy else acc
        outs.append(acc.reshape(lead + (T, n)))
    return (outs[0], outs[1]), ar.max_seen


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------

def _tables(fks, device) -> dict:
    """The kernel's operands besides ŷ on ``device``, uploaded once: the
    forward NTT tables of the expanded tower, the FBC constants, the
    pre-Montgomerized key rows as 32-bit words and the group bounds."""
    dev = canonical_device(device)
    key = ("cuda", dev)
    if key not in fks._dev:
        d = fks.on(dev)
        nt = kernel_tables(fks.exp_ring.tables, dev)
        fks._dev[key] = {
            "twist": nt["fwd"][0], "tw": nt["fwd"][1], "pn": nt["pn"],
            "cst": u32_table(fks.cst, dev),
            "km": d["km"].to(torch.int32).contiguous(),
            "kd": d["kd"].to(torch.int32).contiguous(),
            "bounds": torch.as_tensor(np.asarray(fks.bounds, dtype=np.int32), device=dev),
        }
    return fks._dev[key]


def cluster_args(fks, pairs: int, cluster: Optional[int] = None, scheme: Optional[str] = None,
                 lazy: Optional[bool] = None) -> tuple:
    """The C launcher's arguments after logn for one launch of the cluster
    kernel: (blocks that share the digits, blocks that share the polynomial,
    lazy, packed local passes, kf). ``cluster`` / ``scheme`` / ``lazy``
    override :func:`choose_cluster`."""
    n, primes = fks.exp_ring.n, fks.exp_ring.primes
    sch, g, lz = choose_cluster(pairs, n, fks.dnum_t, primes)
    if scheme is None:                     # a bare cluster size deals the digits out
        scheme = sch if cluster is None else "digits"
    if cluster is None:                    # a bare scheme takes the chooser's size or the smallest
        cluster = g if scheme == sch else min(legal_clusters(n, fks.dnum_t, scheme) or (0,))
    cluster = int(cluster)
    lazy = lz if lazy is None else bool(lazy)
    if cluster not in legal_clusters(n, fks.dnum_t, scheme):
        raise ValueError(f"cluster size {cluster} is not legal for K3 ({scheme}) at N = {n} "
                         f"with {fks.dnum_t} digits")
    if lazy and not lz:
        raise ValueError("lazy values need every prime below 2^30")
    plan = hybrid_ks_plan(n.bit_length() - 1, cluster, scheme)
    gshare, nblocks = (cluster, 1) if scheme == "digits" else (1, cluster)
    return gshare, nblocks, int(lazy), pack_plan(plan["local"]), plan["kf"]


def launch(fks, y: torch.Tensor, cluster: Optional[int] = None, scheme: Optional[str] = None,
           lazy: Optional[bool] = None):
    """(acc1, acc2) of ``fks`` for a contiguous int64[..., lt, N] ŷ CUDA
    tensor through the kernel. Raises on anything the kernel does not take.

    ``cluster`` / ``scheme`` / ``lazy`` override :func:`choose_cluster` (any
    legal cluster size of either scheme; ``lazy=False`` is legal for every
    tower, ``lazy=True`` only below 2^30)."""
    if y.device.type != "cuda":
        raise ValueError(f"the CUDA hybrid key switch takes CUDA tensors, got {y.device}")
    if y.dtype != torch.int64:
        raise TypeError(f"residues must be int64, got {y.dtype}")
    n, T = fks.exp_ring.n, fks.exp_ring.nlimbs
    if y.dim() < 2 or y.shape[-1] != n or y.shape[-2] != fks.lt:
        raise ValueError(f"expected [..., {fks.lt}, {n}], got {tuple(y.shape)}")
    check_n(n)
    if not y.is_contiguous():
        raise ValueError("the CUDA hybrid key switch needs a contiguous tensor")
    lead = tuple(y.shape[:-2])
    rows = y.numel() // (fks.lt * n)
    if rows * T * max(CLUSTERS) >= 1 << 31:
        raise ValueError(f"{rows} rows exceed one launch grid")
    lib = LIB.load()
    kt = _tables(fks, y.device)
    plan_key = ("launch", rows, cluster, scheme, lazy)
    if plan_key not in fks._dev:           # the launcher's arguments, worked out once
        tail = cluster_args(fks, rows * T, cluster, scheme, lazy)
        words = scratch_words(rows * T, n, tail[0], "digits" if tail[1] == 1 else "poly")
        fks._dev[plan_key] = (lib.toyfhe_hybrid_ks_cluster, tail, words)
    fn, tail, words = fks._dev[plan_key]
    if y.data_ptr() % 16:
        y = y.clone()                      # the kernel loads 16 bytes a thread
    out1 = torch.empty(lead + (T, n), dtype=torch.int64, device=y.device)
    out2 = torch.empty_like(out1)
    operands = (y.data_ptr(), out1.data_ptr(), out2.data_ptr(), kt["twist"].data_ptr(),
                kt["tw"].data_ptr(), kt["pn"].data_ptr(), kt["cst"].data_ptr(),
                kt["km"].data_ptr(), kt["kd"].data_ptr(), kt["bounds"].data_ptr())
    shape = (rows, fks.lt, T, fks.dnum_t, fks.alpha, n.bit_length() - 1)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        scratch = torch.empty(words, dtype=torch.int32, device=y.device)
        err = fn(*operands, scratch.data_ptr() if words else None, *shape, *tail, stream)
    LIB.check(err, "CUDA hybrid key switch")
    launches["k3"] += 1
    return out1, out2


def kernel_attrs(kf: int, lazy: bool) -> dict:
    """Registers a thread and static shared memory of one instantiation of
    the cluster kernel (``kf`` stages in the closing pass), as the CUDA
    runtime reports them (builds the library)."""
    buf = (ctypes.c_int * 2)()
    LIB.check(LIB.load().toyfhe_hybrid_ks_cluster_attrs(
        int(kf), int(lazy), ctypes.addressof(buf)), "K3 attributes")
    return {"registers": buf[0], "static_smem": buf[1]}
