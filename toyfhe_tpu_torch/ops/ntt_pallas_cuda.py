"""Wrappers of the hand-written CUDA bit-reversed forward NTT
(``csrc/ntt_bitrev.cu``) and fused polynomial product (``csrc/polymul.cu``).

:func:`launch` replaces the TPU kernel
``toyfhe_tpu/ops/ntt_pallas.py::ntt_pallas_bitrev`` (K5, body
``_fwd_kernel``); its plain twin is :func:`.ntt_pallas.ntt_bitrev_plain`.
:func:`launch_polymul` replaces ``polymul_pallas_raw`` of the same file
(K4, body ``_polymul_kernel``); its plain twin is
:func:`.ntt_pallas.polymul_plain`. Each equals its twin bit for bit.

One K5 kernel, the register-radix kernel, which :func:`launch` runs: one
polynomial over C independent blocks
(:func:`choose_bitrev_cluster`), the first DIF pass straight from device
memory with the cross-block stages in it, radix-8 passes in registers
(:func:`forward_plan`), lazy butterflies when every prime is below 2^30, a
last pass that stores canonical residues 16 bytes at a time.
:func:`bitrev_schedule` is its schedule in plain torch for the CPU tests.

One K4 kernel, the cluster-split register-radix kernel, which
:func:`launch_polymul` runs: one thread-block cluster of C blocks per
polynomial pair (:func:`choose_polymul_cluster`), both operands through
radix-8 DIF passes in registers, a middle pass that runs the last DIF
stages, the product and the first DIT stages without touching shared memory
in between, radix-8 DIT passes and a closing pass across the cluster
(:func:`polymul_plan`), lazy butterflies when every prime is below 2^30.
:func:`polymul_schedule` is its schedule in plain torch, pass for pass and
index for index, for the CPU tests.

Each source is built by ``nvcc`` at first use (:mod:`.cuda_lib`).
``launches["k5"]`` and ``polymul_launches["k4"]`` count the launches made
through :func:`launch` and :func:`launch_polymul`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .cuda_lib import CI, VP, CudaLibrary
from .ntt_cuda import (BLOCK_CAP, LAZY_PRIME_LIMIT, _Arith, _stages, check_n, host_tables,
                       kernel_tables, pack_plan, swizzle, u32_table)
from .ntt_pallas import _check_lrn

LIB = CudaLibrary("ntt_bitrev", {
    "toyfhe_ntt_bitrev_radix": ([VP] * 5 + [CI] * 8 + [VP], CI),
    "toyfhe_ntt_bitrev_radix_attrs": ([CI] * 2 + [VP], CI),
})
launches = {"k5": 0}
BITREV_CLUSTERS = (1, 2, 4)      # blocks per polynomial the K5 register-radix kernel takes
LIB_POLYMUL = CudaLibrary("polymul", {
    "toyfhe_polymul_cluster": ([VP] * 9 + [CI] * 9 + [VP], CI),
    "toyfhe_polymul_cluster_attrs": ([CI] * 2 + [VP], CI),
})
polymul_launches = {"k4": 0}
POLYMUL_CLUSTERS = (1, 2, 4)     # blocks per polynomial pair the cluster kernel takes
MIN_BLOCK_N = 8                  # fewest residues one block of a cluster holds
MAX_BLOCK_N = 1 << 14            # most: two rows of it fit a block's shared memory
MIN_CHOSEN_BLOCK_N = 2048        # the chooser splits no further than this
SPLIT_FROM_N = 1 << 14           # from here on a pair always gets two blocks
MIDDLE = 3                       # stage bits [0, 3) run in the fused middle pass


# ---------------------------------------------------------------------------
# the cluster kernel's launch plan (host side, shared with the schedule twin)
# ---------------------------------------------------------------------------

def _split(bits: int) -> Tuple[int, ...]:
    """``bits`` stage bits as ceil(bits / 3) passes of at most 3, smallest
    first."""
    if bits == 0:
        return ()
    npass = -(-bits // 3)
    return tuple(sorted(bits // npass + (1 if i < bits % npass else 0) for i in range(npass)))


def forward_plan(m: int) -> Tuple[int, Tuple[int, ...]]:
    """``(kl, local)``: the DIF passes over stage bits [3, m) of a row of
    2^m residues, read from the top. The load pass takes the top ``kl``
    stages on its way from device memory to shared memory (0: it only
    loads), ``local`` the in-place passes below it, top pass first. Stage
    bits [0, 3) are left to the caller's last pass."""
    if m < MIDDLE:
        raise ValueError(f"a row of 2^{m} residues is too short for the radix-8 last pass")
    sizes = _split(m - MIDDLE)
    return (sizes[0], sizes[1:]) if sizes else (0, ())


def legal_polymul_clusters(n: int) -> Tuple[int, ...]:
    """The cluster sizes the K4 cluster kernel takes at ring degree ``n``:
    a block keeps between ``MIN_BLOCK_N`` and ``MAX_BLOCK_N`` residues of
    each operand."""
    return tuple(c for c in POLYMUL_CLUSTERS if MIN_BLOCK_N <= n // c <= MAX_BLOCK_N)


def polymul_plan(logn: int, cluster: int) -> dict:
    """The K4 cluster kernel's passes at N = 2^logn with ``cluster`` blocks a
    polynomial pair, m = logn - log2 cluster:

    ``kl``, ``fwd``: the DIF passes over stage bits [3, m) (:func:`forward_plan`),
    after the top log2 cluster stages, which the load takes across the cluster;
    the fused middle over stage bits [0, 3);
    ``bwd``: the in-place DIT passes over stage bits [3, logn - kf), lowest first;
    ``kf``: the closing pass's stages, the log2 cluster cross-block ones among
    them.  A DIF plan is a DIT plan read from the top."""
    logc = cluster.bit_length() - 1
    if cluster not in POLYMUL_CLUSTERS or logn < 4 or logn - logc < MIDDLE:
        raise ValueError(f"no K4 plan for a cluster of {cluster} at N = 2^{logn}")
    kl, fwd = forward_plan(logn - logc)
    bits = logn - MIDDLE
    kf = max(logc, 1, bits - 3 * (-(-bits // 3) - 1))
    return {"kl": kl, "fwd": fwd, "bwd": _split(bits - kf), "kf": kf}


def plan_barriers(plan: dict) -> int:
    """Block or cluster barriers of one run of a plan before the closing
    pass: after the load pass, each DIF pass, the middle and each DIT pass."""
    return 2 + len(plan["fwd"]) + len(plan["bwd"])


def choose_polymul_cluster(polys: int, n: int, primes: Sequence[int]) -> Tuple[int, bool]:
    """``(C, lazy)`` for one launch of ``polys`` polynomial pairs of degree
    ``n``: the largest legal C that keeps ``polys * C`` within ``BLOCK_CAP``
    blocks and ``MIN_CHOSEN_BLOCK_N`` residues in a block, so that a small
    launch spreads over the card; a launch too large for that takes one
    block a pair, and two from ``SPLIT_FROM_N`` on (128 pairs of N = 2^14:
    two blocks of 64 KB, several to an SM, ran 5% faster than one of 128 KB,
    and N = 2^15 does not fit one block). ``lazy`` needs every prime below
    2^30."""
    lazy = max(int(p) for p in primes) < LAZY_PRIME_LIMIT
    legal = legal_polymul_clusters(n)
    floor = max(min(legal), 2 if n >= SPLIT_FROM_N else 1)
    fits = [c for c in legal if polys * c <= BLOCK_CAP and n // c >= MIN_CHOSEN_BLOCK_N]
    return max(fits + [floor]), lazy


def legal_bitrev_clusters(n: int) -> Tuple[int, ...]:
    """The block counts per polynomial the K5 register-radix kernel takes at
    ring degree ``n``: a block keeps at least ``MIN_BLOCK_N`` residues (one
    row of any N the port supports fits a block's shared memory)."""
    return tuple(c for c in BITREV_CLUSTERS if n // c >= MIN_BLOCK_N)


def choose_bitrev_cluster(polys: int, n: int, primes: Sequence[int]) -> Tuple[int, bool]:
    """``(C, lazy)`` for one K5 launch of ``polys`` polynomials of degree
    ``n``: the largest legal C that keeps ``polys * C`` within ``BLOCK_CAP``
    blocks and ``MIN_CHOSEN_BLOCK_N`` residues in a block, so that a small
    launch spreads over the card; one block a polynomial otherwise (each of
    the C blocks reads every residue of its polynomial, so a launch that
    fills the card by itself gains nothing from a split). ``lazy`` needs every
    prime below 2^30."""
    lazy = max(int(p) for p in primes) < LAZY_PRIME_LIMIT
    fits = [c for c in legal_bitrev_clusters(n)
            if polys * c <= BLOCK_CAP and n // c >= MIN_CHOSEN_BLOCK_N]
    return max(fits + [1]), lazy


def bitrev_plan(logn: int, cluster: int) -> dict:
    """The K5 register-radix kernel's passes at N = 2^logn with ``cluster``
    blocks a polynomial, m = logn - log2 cluster: the top log2 cluster stages
    in the load across the blocks, ``kl`` and ``fwd`` the DIF passes over stage
    bits [3, m) (:func:`forward_plan`), and the last pass over [0, 3)."""
    logc = cluster.bit_length() - 1
    if cluster not in BITREV_CLUSTERS or logn < 4 or logn - logc < MIDDLE:
        raise ValueError(f"no K5 plan for {cluster} blocks a polynomial at N = 2^{logn}")
    kl, fwd = forward_plan(logn - logc)
    return {"kl": kl, "fwd": fwd}


def bitrev_block_shape(n: int, cluster: int) -> dict:
    """Threads, dynamic shared-memory bytes and barriers of one block of the
    K5 register-radix kernel, as the C launcher sets them."""
    per_block = n // cluster
    plan = bitrev_plan(n.bit_length() - 1, cluster)
    return {"threads": min(512, max(32, per_block // 8)), "smem": 4 * per_block,
            "barriers": 1 + len(plan["fwd"])}


# ---------------------------------------------------------------------------
# the schedule twins' arithmetic and passes (plain torch, CPU tests)
# ---------------------------------------------------------------------------

class _DifArith(_Arith):
    """:class:`.ntt_cuda._Arith` with the forward side: DIF butterflies and
    sums in the working range, [0, 2p) when lazy and canonical otherwise."""

    def add(self, a, b):
        p = self.cols(a)[0]
        s = self.see(a + b)
        lim = 2 * p if self.lazy else p
        return torch.where(s >= lim, s - lim, s)

    def sub_mul(self, x, y, w):
        """(x - y)·w, the lower output of a DIF butterfly."""
        p = self.cols(x)[0]
        if not self.lazy:
            return self.mul(torch.remainder(x - y, p), w)
        return self.mul(self.see(x + 2 * p - y), w)

    def dif_butterfly(self, x, y, w):
        return self.add(x, y), self.sub_mul(x, y, w)


def _stages_dif(ar: _DifArith, regs, tw, b0: int, k: int, low: np.ndarray):
    """``k`` DIF stages on ``regs`` [B, L, G, T, 2^k], the mirror of
    :func:`.ntt_cuda._stages`: stages s = k-1 .. 0, the stage of half-length
    h = 2^(b0+s) pairing (e, e + 2^s) with ``tw[h + low + (e mod 2^s) * 2^b0]``."""
    stride, shape = 1 << b0, regs.shape
    for s in reversed(range(k)):
        lo = 1 << s
        idx = (stride << s) + low[:, None] + np.arange(lo)[None, :] * stride      # [T, lo]
        w = tw[:, torch.as_tensor(idx)][None, :, None, :, None, :]              # [1, L, 1, T, 1, lo]
        v = regs.reshape(shape[:-1] + (shape[-1] // (2 * lo), 2, lo))
        x, y = ar.dif_butterfly(v[..., 0, :], v[..., 1, :], w)
        regs = ar.see(torch.stack([x, y], dim=-2)).reshape(shape)
    return regs


def _pass_positions(m: int, b0: int, k: int):
    """``(low, pos)`` of an in-place radix-2^k pass over 2^m residues: item
    t holds positions ``pos[t, e] = low[t] + hi(t) 2^(b0+k) + e 2^b0``."""
    t = np.arange(1 << (m - k))
    low = t & ((1 << b0) - 1)
    return low, (low + ((t >> b0) << (b0 + k)))[:, None] + (np.arange(1 << k) << b0)[None, :]


def dif_local_passes(ar, rows, tw, m: int, top: int, local: Sequence[int]) -> int:
    """The in-place DIF passes ``local`` (top first) below stage bit ``top``
    on every row of ``rows`` ([..., 2^m] tensors, updated in place).
    Returns the stage bit reached."""
    b0 = top
    for k in local:
        b0 -= k
        low, pos = _pass_positions(m, b0, k)
        where = torch.as_tensor(pos)
        for row in rows:
            row[..., where] = _stages_dif(ar, row[..., where], tw, b0, k, low)
    return b0


def dit_local_passes(ar, row, tw, m: int, b0: int, local: Sequence[int],
                     swizzled: bool = False) -> int:
    """The in-place DIT passes ``local`` (lowest first) from stage bit ``b0``
    on the rows ``row`` [..., 2^m], position q at word q or, ``swizzled``, at
    :func:`.ntt_cuda.swizzle`'s word. Returns the stage bit reached."""
    for k in local:
        low, pos = _pass_positions(m, b0, k)
        where = torch.as_tensor(swizzle(pos, m) if swizzled else pos)
        row[..., where] = _stages(ar, row[..., where], tw, b0, k, low)
        b0 += k
    return b0


def closing_pass(ar, rows, tw, twist, logn: int, logc: int, kf: int):
    """The closing DIT pass over ``rows`` [B, L, C, words], block r keeping
    positions [r 2^m, (r+1) 2^m): element e of base b is position b + e 2^bf,
    read from block (b + e 2^bf) >> m; then the untwist and the canonical
    store. Returns [B, L, N]."""
    m, bf = logn - logc, logn - kf
    base = np.arange(1 << bf)
    q = base[:, None] + (np.arange(1 << kf) << bf)[None, :]                     # [T, 2^kf]
    rank, where = torch.as_tensor(q >> m), torch.as_tensor(q & ((1 << m) - 1))
    regs = _stages(ar, rows[:, :, rank, where][:, :, None], tw, bf, kf, base)
    regs = ar.mul(regs, twist[:, torch.as_tensor(q)][None, :, None])
    if ar.lazy:
        regs = ar.canonical(regs, 2)
    out = torch.empty(rows.shape[:2] + (1 << logn,), dtype=torch.int64)
    out[..., torch.as_tensor(q)] = regs[:, :, 0]
    return out


def _int64_tables(tables):
    fwd, inv, _ = host_tables(tables)
    return tuple(tuple(torch.as_tensor(a.astype(np.int64)) for a in pair) for pair in (fwd, inv))


def _lazy_flag(tables, lazy: Optional[bool]) -> bool:
    if lazy is None:
        return max(tables.primes) < LAZY_PRIME_LIMIT
    if lazy and max(tables.primes) >= LAZY_PRIME_LIMIT:
        raise ValueError("lazy butterflies need every prime below 2^30")
    return bool(lazy)


def _cross_load(ar, x, twist, tw, pos, m: int, logc: int, r: int):
    """Block ``r``'s values at positions ``pos`` [T, E] of its row after the
    twist and the top ``logc`` DIF stages: the residues pos + e 2^m of ``x``
    [R, L, N], twisted, and output ``r`` of their radix-2^logc butterfly."""
    v = []
    for e in range(1 << logc):
        i = torch.as_tensor(pos + (e << m))
        v.append(ar.see(ar.mul(x[..., i], twist[:, i][None])))
    for s in reversed(range(logc)):
        for e in range(1 << s):
            w = tw[:, torch.as_tensor((1 << (m + s)) + pos + (e << m))][None]
            x0, y0 = v[e], v[e + (1 << s)]
            v[e] = ar.see(ar.sub_mul(x0, y0, w) if (r >> s) & 1 else ar.add(x0, y0))
    return v[0]


def bitrev_schedule(pt, a: torch.Tensor, cluster: int, lazy: Optional[bool] = None):
    """The K5 register-radix kernel's schedule on a CPU tensor int64
    [L, R, N]: returns ``(transform, largest intermediate value)``.

    Follows ``csrc/ntt_bitrev.cu`` index for index: block r of the ``cluster``
    that share a polynomial reads, for each of its positions q, the residues
    q + e N/C, twists them and keeps output r of their radix-C DIF butterfly;
    runs the load pass's stages and the DIF passes of :func:`bitrev_plan` on
    its row; the last pass over stage bits [0, 3) reduces to canonical and
    stores the row as positions [r N/C, (r+1) N/C) of the bit-reversed
    output. ``lazy`` as the kernel's flag: ``None`` takes it whenever every
    prime is below 2^30."""
    _check_lrn(pt, a)
    tables, logn = pt.tables, pt.logn
    lazy = _lazy_flag(tables, lazy)
    if cluster not in legal_bitrev_clusters(pt.n):
        raise ValueError(f"{cluster} blocks a polynomial is not legal for K5 at N = {pt.n}")
    plan = bitrev_plan(logn, cluster)
    logc = cluster.bit_length() - 1
    m, kl = logn - logc, plan["kl"]
    (twist, tw), _ = _int64_tables(tables)
    ar = _DifArith(tables, lazy)
    x = a.transpose(0, 1)                                         # [R, L, N]
    row = torch.zeros(x.shape[:2] + (cluster, 1 << m), dtype=torch.int64)
    low, pos = _pass_positions(m, m - kl, kl)                     # low = t
    for r in range(cluster):
        regs = _cross_load(ar, x, twist, tw, pos, m, logc, r)
        row[:, :, r, torch.as_tensor(pos)] = _stages_dif(
            ar, regs[:, :, None], tw, m - kl, kl, low)[:, :, 0]
    assert dif_local_passes(ar, [row], tw, m, m - kl, plan["fwd"]) == MIDDLE
    low, pos = _pass_positions(m, 0, MIDDLE)
    where = torch.as_tensor(pos)
    last = _stages_dif(ar, row[..., where], tw, 0, MIDDLE, low)
    row[..., where] = ar.canonical(last, 2) if lazy else last
    out = row.reshape(x.shape)                                    # block r: [r N/C, (r+1) N/C)
    return out.transpose(0, 1).contiguous(), ar.max_seen


def polymul_schedule(pt, a: torch.Tensor, b: torch.Tensor, cluster: int,
                     lazy: Optional[bool] = None):
    """The K4 cluster kernel's schedule on CPU tensors int64 [L, R, N]:
    returns ``(product, largest intermediate value)``.

    Follows ``csrc/polymul.cu`` index for index: block r of the cluster
    reads, for each of its positions q, the residues q + e N/C of both
    operands, twists them and keeps output r of their radix-C DIF butterfly;
    runs the load pass's stages and the DIF passes of :func:`polymul_plan` on
    both rows; the middle pass (last DIF stages, product, first DIT
    stages) on 8 neighbouring positions; the DIT passes; and the closing
    pass across the cluster with the untwist. ``lazy`` as the kernel's
    flag: ``None`` takes it whenever every prime is below 2^30."""
    _check_lrn(pt, a)
    _check_lrn(pt, b)
    tables, n, logn = pt.tables, pt.n, pt.logn
    lazy = _lazy_flag(tables, lazy)
    plan = polymul_plan(logn, cluster)
    logc = cluster.bit_length() - 1
    m = logn - logc
    msize = 1 << m
    (twist, tw), (itwist, itw) = _int64_tables(tables)
    ar = _DifArith(tables, lazy)
    ops = [x.transpose(0, 1) for x in (a, b)]                     # [R, L, N]
    nrows, nl = ops[0].shape[:2]
    rows = [torch.zeros((nrows, nl, cluster, msize), dtype=torch.int64) for _ in ops]

    # load pass: twist, cross stages (output r of the radix-C butterfly), top kl stages
    kl = plan["kl"]
    low, pos = _pass_positions(m, m - kl, kl)                     # low = t
    for r in range(cluster):
        for x, row in zip(ops, rows):
            regs = _cross_load(ar, x, twist, tw, pos, m, logc, r)
            regs = _stages_dif(ar, regs[:, :, None], tw, m - kl, kl, low)
            row[:, :, r, torch.as_tensor(pos)] = regs[:, :, 0]
    b0 = dif_local_passes(ar, rows, tw, m, m - kl, plan["fwd"])
    assert b0 == MIDDLE

    # the fused middle over stage bits [0, 3)
    low, pos = _pass_positions(m, 0, MIDDLE)
    where = torch.as_tensor(pos)
    da, db = (_stages_dif(ar, row[..., where], tw, 0, MIDDLE, low) for row in rows)
    r2 = torch.as_tensor(np.asarray(tables.mp.r2, dtype=np.int64)).reshape(1, -1, 1, 1, 1)
    prod = ar.see(ar.mul(ar.see(ar.mul(da, r2)), db))
    sa = rows[0]
    sa[..., where] = _stages(ar, prod, itw, 0, MIDDLE, low)
    bf = dit_local_passes(ar, sa, itw, m, MIDDLE, plan["bwd"])
    assert bf == logn - plan["kf"]
    out = closing_pass(ar, sa, itw, itwist, logn, logc, plan["kf"])
    return out.transpose(0, 1).contiguous(), ar.max_seen


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------

def bitrev_args(pt, polys: int, cluster: Optional[int] = None,
                lazy: Optional[bool] = None) -> tuple:
    """The C launcher's arguments after the layout flag for one launch of the
    K5 register-radix kernel: (cluster, lazy, kl, packed DIF passes).
    ``cluster`` / ``lazy`` override :func:`choose_bitrev_cluster`."""
    c, lz = choose_bitrev_cluster(polys, pt.n, pt.primes)
    cluster = c if cluster is None else int(cluster)
    lazy = lz if lazy is None else bool(lazy)
    if cluster not in legal_bitrev_clusters(pt.n):
        raise ValueError(f"{cluster} blocks a polynomial is not legal for K5 at N = {pt.n}")
    if lazy and not lz:
        raise ValueError("lazy butterflies need every prime below 2^30")
    plan = bitrev_plan(pt.logn, cluster)
    return cluster, int(lazy), plan["kl"], pack_plan(plan["fwd"])


def launch(pt, a: torch.Tensor, cluster: Optional[int] = None, lazy: Optional[bool] = None,
           row_major: bool = False) -> torch.Tensor:
    """Bit-reversed forward NTT of a contiguous int64 [L, R, N] CUDA tensor
    (limb axis first) through the kernel. Raises on anything the kernel
    does not take.

    ``cluster`` / ``lazy`` override :func:`choose_bitrev_cluster` (any legal
    block count; ``lazy=False`` is legal for every tower, ``lazy=True`` only
    below 2^30), and ``row_major=True`` hands it the batch as [R, L, N]
    instead, each polynomial transformed where it lies."""
    if a.device.type != "cuda":
        raise ValueError(f"the CUDA bit-reversed NTT takes CUDA tensors, got {a.device}")
    if row_major:
        if a.dim() != 3 or a.shape[1] != pt.L or a.shape[-1] != pt.n:
            raise ValueError(f"expected [R, {pt.L}, {pt.n}], got {tuple(a.shape)}")
        if a.dtype != torch.int64:
            raise TypeError(f"residues must be int64, got {a.dtype}")
    else:
        _check_lrn(pt, a)
    check_n(pt.n)
    if not a.is_contiguous():
        raise ValueError("the CUDA bit-reversed NTT needs a contiguous tensor")
    rows = a.shape[0 if row_major else 1]
    if pt.L * rows * max(BITREV_CLUSTERS) >= 1 << 31:
        raise ValueError(f"{pt.L * rows} polynomials exceed one launch grid")
    tail = pt.tables.cached(("k5_args", rows, cluster, lazy),
                            lambda: bitrev_args(pt, pt.L * rows, cluster, lazy))
    if a.data_ptr() % 16:
        a = a.clone()                      # the kernel loads 16 bytes a thread
    lib = LIB.load()
    kt = kernel_tables(pt.tables, a.device)
    twist, tw = kt["fwd"]
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.toyfhe_ntt_bitrev_radix(a.data_ptr(), out.data_ptr(), twist.data_ptr(),
                                          tw.data_ptr(), kt["pn"].data_ptr(), pt.L, rows,
                                          pt.logn, int(row_major), *tail, stream)
    LIB.check(err, "CUDA bit-reversed NTT")
    launches["k5"] += 1
    return out


def bitrev_attrs(cluster: int, lazy: bool) -> dict:
    """Registers a thread and static shared memory of one instantiation of
    the K5 register-radix kernel, as the CUDA runtime reports them (builds
    the library)."""
    import ctypes
    buf = (ctypes.c_int * 2)()
    LIB.check(LIB.load().toyfhe_ntt_bitrev_radix_attrs(
        int(cluster), int(lazy), ctypes.addressof(buf)), "K5 attributes")
    return {"registers": buf[0], "static_smem": buf[1]}


def polymul_args(pt, polys: int, cluster: Optional[int] = None,
                 lazy: Optional[bool] = None) -> tuple:
    """The C launcher's arguments after logn for one launch of the K4 cluster
    kernel: (cluster, lazy, kl, packed DIF passes, packed DIT passes, kf).
    ``cluster`` / ``lazy`` override :func:`choose_polymul_cluster`."""
    c, lz = choose_polymul_cluster(polys, pt.n, pt.primes)
    cluster = c if cluster is None else int(cluster)
    lazy = lz if lazy is None else bool(lazy)
    if cluster not in legal_polymul_clusters(pt.n):
        raise ValueError(f"cluster size {cluster} is not legal for K4 at N = {pt.n}")
    if lazy and not lz:
        raise ValueError("lazy butterflies need every prime below 2^30")
    plan = polymul_plan(pt.logn, cluster)
    return (cluster, int(lazy), plan["kl"], pack_plan(plan["fwd"]), pack_plan(plan["bwd"]),
            plan["kf"])


def launch_polymul(pt, a: torch.Tensor, b: torch.Tensor, cluster: Optional[int] = None,
                   lazy: Optional[bool] = None) -> torch.Tensor:
    """Fused negacyclic product of contiguous primal int64 [L, R, N] CUDA
    tensors through the kernel, which takes every N the port supports and
    both kinds of tower. Raises on anything the kernel does not take.

    ``cluster`` / ``lazy`` override :func:`choose_polymul_cluster` (any legal
    cluster size; ``lazy=False`` is legal for every tower, ``lazy=True`` only
    below 2^30)."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"the CUDA fused product takes CUDA tensors on one device, "
                         f"got {a.device} and {b.device}")
    _check_lrn(pt, a)
    _check_lrn(pt, b)
    if a.shape != b.shape:
        raise ValueError(f"operand shapes differ: {tuple(a.shape)} and {tuple(b.shape)}")
    check_n(pt.n)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the CUDA fused product needs contiguous tensors")
    rows = a.shape[1]
    if pt.L * rows * max(POLYMUL_CLUSTERS) >= 1 << 31:
        raise ValueError(f"{pt.L * rows} polynomials exceed one launch grid")
    tail = pt.tables.cached(("k4_args", rows, cluster, lazy),
                            lambda: polymul_args(pt, pt.L * rows, cluster, lazy))
    lib = LIB_POLYMUL.load()
    kt = kernel_tables(pt.tables, a.device)
    twist, tw = kt["fwd"]
    itwist, itw = kt["inv"]
    r2 = pt.tables.cached(("cuda_r2", a.device), lambda: u32_table(pt.r2, a.device))
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.toyfhe_polymul_cluster(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                         twist.data_ptr(), tw.data_ptr(), itwist.data_ptr(),
                                         itw.data_ptr(), kt["pn"].data_ptr(), r2.data_ptr(),
                                         pt.L, rows, pt.logn, *tail, stream)
    LIB_POLYMUL.check(err, "CUDA fused product")
    polymul_launches["k4"] += 1
    return out


def polymul_attrs(cluster: int, lazy: bool) -> dict:
    """Registers a thread and static shared memory of one instantiation of
    the K4 cluster kernel, as the CUDA runtime reports them (builds the
    library)."""
    import ctypes
    buf = (ctypes.c_int * 2)()
    LIB_POLYMUL.check(LIB_POLYMUL.load().toyfhe_polymul_cluster_attrs(
        int(cluster), int(lazy), ctypes.addressof(buf)), "K4 attributes")
    return {"registers": buf[0], "static_smem": buf[1]}


def polymul_block_shape(n: int, cluster: int) -> dict:
    """Threads and dynamic shared-memory bytes of one block of the K4 cluster
    kernel, as the C launcher sets them: one radix-8 item a thread, at most
    512; two rows of the block's residues."""
    per_block = n // cluster
    return {"threads": min(512, max(32, per_block // 8)),
            "smem": 4 * 2 * per_block}
