"""Wrapper of the hand-written CUDA negacyclic NTT (``csrc/ntt.cu``).

Replaces the TPU kernel ``toyfhe_tpu/ops/ntt_mxu_pallas.py::_mxu_nat``
(K1): the natural-order forward and inverse transform of ``[..., L, N]``
residue tensors. Its plain twin is :func:`..ops.ntt.ntt_plain` /
:func:`..ops.ntt.intt_plain`, which it equals bit for bit.

One kernel, the cluster-split register-radix kernel: one thread-block
cluster of C blocks per polynomial (:func:`choose_cluster` picks C from the
launch), the stages grouped into radix-8 passes held in registers
(:func:`schedule_plan`), lazy [0, 4p) butterflies when every prime is below
2^30. :func:`launch` runs it; :func:`ntt_schedule` is its schedule in plain
torch, pass for pass and index for index, for the CPU tests.

The kernel is compiled by ``nvcc`` from ``toyfhe_tpu_torch/csrc/ntt.cu`` at
first use into ``toyfhe_tpu_torch/_build/`` (:mod:`.cuda_lib`) and loaded
with ``ctypes``. Nothing here imports or builds anything at module import.

``launches["fwd"]`` and ``launches["inv"]`` count the kernel launches made
through :func:`launch`; ``transforms`` counts the limb polynomials they
transformed (the transform census of a step).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .cuda_lib import CI, VP, CudaLibrary
from .modmath import canonical_device, mont_mul_raw

MIN_N, MAX_N = 16, 1 << 15
CLUSTERS = (1, 2, 4, 8)        # blocks per polynomial the cluster kernel takes
MIN_BLOCK_N = 8                # fewest residues one block of a cluster holds
BLOCK_CAP = 132                # blocks a launch aims at: one per SM of an H100
CHOSEN_CLUSTERS = (1, 2, 4)    # what the chooser picks from: 8 was never the fastest
MIN_CHOSEN_BLOCK_N = 2048      # the chooser splits no further than this
SPLIT_FROM_N = 8192            # from here on a polynomial always gets two blocks
LAZY_PRIME_LIMIT = 1 << 30     # below it 4p fits a 32-bit word
SWIZZLE_MIN_LOG = 10           # blocks of fewer residues store unswizzled
TW_SHARED = 512                # packed twiddles [0, 512) are copied to shared memory
_MASK32 = (1 << 32) - 1

LIB = CudaLibrary("ntt", {
    "toyfhe_ntt_cluster": ([VP] * 5 + [CI] * 8 + [VP], CI),
    "toyfhe_ntt_cluster_attrs": ([CI] * 3 + [VP], CI),
})
launches = {"fwd": 0, "inv": 0}
transforms = {"fwd": 0, "inv": 0}


def u32_table(a: np.ndarray, device) -> torch.Tensor:
    """uint32 host table → int32 tensor with the same bits on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)).to(device)


def kernel_tables(tables, device) -> dict:
    """Twist rows, packed stage twiddles and (p, ninv) pairs on ``device``,
    uploaded once per ring and device."""
    dev = canonical_device(device)

    def build_tables():
        fwd, inv, pn = host_tables(tables)
        return {"fwd": tuple(u32_table(a, dev) for a in fwd),
                "inv": tuple(u32_table(a, dev) for a in inv), "pn": u32_table(pn, dev)}

    return tables.cached(("cuda", dev), build_tables)


def host_tables(tables):
    """The kernels' tables as host uint32 arrays: ``(twist, packed stage
    twiddles)`` for the forward and for the inverse transform, and the
    interleaved ``(p, ninv)`` pairs. A packed row holds the stage of
    half-length h at offsets [h, 2h)."""
    def pack(stages):
        out = np.zeros((len(tables.primes), tables.n), dtype=np.uint32)
        for st in stages:
            h = st.shape[-1]
            out[:, h:2 * h] = st[:, 0, :]
        return out

    pn = np.concatenate([tables.mp.p, tables.mp.ninv], axis=1)       # [L, 2]
    return ((tables.psi_pow, pack(tables.stage_tw)),
            (tables.psi_ipow, pack(tables.stage_tw_inv)), pn)


def check_n(n: int) -> None:
    if not MIN_N <= n <= MAX_N:
        raise ValueError(f"the CUDA kernels support {MIN_N} <= N <= {MAX_N}, got {n}")


# ---------------------------------------------------------------------------
# the cluster kernel's launch plan (host side, shared with the schedule twin)
# ---------------------------------------------------------------------------

def legal_clusters(n: int) -> Tuple[int, ...]:
    """The cluster sizes the kernel takes at ring degree ``n``: every block
    keeps at least ``MIN_BLOCK_N`` residues."""
    return tuple(c for c in CLUSTERS if n // c >= MIN_BLOCK_N)


def choose_cluster(polys: int, n: int, primes: Sequence[int]) -> Tuple[int, bool]:
    """``(C, lazy)`` for one launch of ``polys`` polynomials of degree ``n``.

    C is the largest of ``CHOSEN_CLUSTERS`` that keeps ``polys * C`` within
    ``BLOCK_CAP`` blocks and ``MIN_CHOSEN_BLOCK_N`` residues in a block, so
    that a small launch spreads over the card. A launch too large for that
    keeps one block a polynomial up to N = 4096 and two from N = 8192 on:
    two blocks of N / 2 were faster than one of N at every launch size
    measured (8192 and 16384, 100 to 400 polynomials). ``lazy`` (values held
    in [0, 4p) between passes) needs every prime below 2^30."""
    lazy = max(int(p) for p in primes) < LAZY_PRIME_LIMIT
    floor = 2 if n >= SPLIT_FROM_N else 1
    fits = [c for c in CHOSEN_CLUSTERS
            if polys * c <= BLOCK_CAP and n // c >= MIN_CHOSEN_BLOCK_N]
    return max(fits + [floor]), lazy


def schedule_plan(logn: int, cluster: int, radix: int = 8) -> Tuple[Tuple[int, ...], int]:
    """``(local, kf)``: the stage bits of each in-place pass over a block's
    own residues, low bits first, and of the closing pass, which takes the
    top ``kf`` stages (the ``log2 cluster`` cross-block ones among them) and
    stores to device memory. ``ceil(logn / log2 radix)`` passes when the
    cluster allows it."""
    kmax, logc = radix.bit_length() - 1, cluster.bit_length() - 1
    if radix not in (2, 4, 8) or cluster not in CLUSTERS:
        raise ValueError(f"no schedule for radix {radix}, cluster {cluster}")
    if logn - logc < 3 or logn < 4:
        raise ValueError(f"a cluster of {cluster} cannot split N = 2^{logn}")
    npass = -(-logn // kmax)
    kf = max(logc, logn - kmax * (npass - 1), 1)
    bf = logn - kf
    nl = -(-bf // kmax)
    local = tuple(bf // nl + (1 if i < bf % nl else 0) for i in range(nl))
    return local, kf


def pack_plan(local: Sequence[int]) -> int:
    """The local passes as base-4 digits, first pass lowest, ended by 0."""
    return sum(k << (2 * i) for i, k in enumerate(local))


def swizzle(q: np.ndarray, m: int) -> np.ndarray:
    """Shared-memory word of position ``q`` in a block of 2^m residues: five
    high position bits (m-6 .. m-2, where the threads of a warp differ in the
    bit-reversed load) XORed into the bank bits, so that its 32 stores hit 32
    banks."""
    if m < SWIZZLE_MIN_LOG:
        return q
    return q ^ ((q >> max(5, m - 6)) & 31)


def _bitrev(v: np.ndarray, bits: int) -> np.ndarray:
    out = np.zeros_like(v)
    for b in range(bits):
        out |= ((v >> b) & 1) << (bits - 1 - b)
    return out


# ---------------------------------------------------------------------------
# the schedule twin (plain torch, CPU tests)
# ---------------------------------------------------------------------------

class _Arith:
    """The butterflies of one tower, lazy or fully reduced, as int64 torch
    ops on values shaped ``[B, L, ...]``."""

    def __init__(self, tables, lazy: bool):
        flat = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64)).reshape(-1)
        self.consts = flat(tables.mp.p), flat(tables.mp.ninv), flat(tables.mp.rinv)
        self.lazy = lazy
        self.max_seen = 0

    def cols(self, v):
        """(p, ninv, rinv) shaped to broadcast along axis 1 of ``v``."""
        return tuple(c.reshape((1, -1) + (1,) * (v.dim() - 2)) for c in self.consts)

    def see(self, v):
        self.max_seen = max(self.max_seen, int(v.max()))
        return v

    def mul(self, a, w):
        """REDC(a·w): below 2p, uncorrected, when lazy; canonical otherwise."""
        p, ninv, rinv = self.cols(a)
        if not self.lazy:
            return mont_mul_raw(a, w, p, rinv)
        x = a * w
        m = ((x & _MASK32) * ninv) & _MASK32
        return (x + m * p) >> 32

    def butterfly(self, x, y, w):
        t = self.mul(y, w)
        p = self.cols(x)[0]
        if not self.lazy:
            return torch.remainder(x + t, p), torch.remainder(x - t, p)
        x = torch.where(x >= 2 * p, x - 2 * p, x)
        return x + t, x - t + 2 * p

    def canonical(self, v, upto: int = 4):
        """[0, upto·p) → [0, p) by conditional subtractions (lazy values)."""
        p = self.cols(v)[0]
        if upto > 2:
            v = torch.where(v >= 2 * p, v - 2 * p, v)
        return torch.where(v >= p, v - p, v)


def _stages(ar: _Arith, regs, tw, b0: int, k: int, low: np.ndarray):
    """``k`` DIT stages on ``regs`` [B, L, G, T, 2^k], element e of item t at
    position ``low[t] + e * 2^b0`` (plus bits above the pass): the stage of
    half-length h = 2^(b0+s) pairs (e, e + 2^s) with the twiddle
    ``tw[h + low + (e mod 2^s) * 2^b0]``."""
    stride, shape = 1 << b0, regs.shape
    for s in range(k):
        lo = 1 << s
        idx = (stride << s) + low[:, None] + np.arange(lo)[None, :] * stride      # [T, lo]
        w = tw[:, torch.as_tensor(idx)][None, :, None, :, None, :]              # [1, L, 1, T, 1, lo]
        v = regs.reshape(shape[:-1] + (shape[-1] // (2 * lo), 2, lo))
        x, y = ar.butterfly(v[..., 0, :], v[..., 1, :], w)
        regs = ar.see(torch.stack([x, y], dim=-2)).reshape(shape)
    return regs


def ntt_schedule(tables, x: torch.Tensor, inverse: bool, cluster: int, radix: int = 8,
                 lazy: Optional[bool] = None):
    """The cluster kernel's schedule on a CPU tensor int64 [..., L, N]:
    returns ``(transform, largest intermediate value)``.

    Follows ``csrc/ntt.cu`` index for index: block r of the cluster loads the
    residues ``i = C v + bitrev(r)`` (twisted when forward) to the swizzled
    word of ``bitrev(v)``, runs the local passes of :func:`schedule_plan` in
    place, and the closing pass gathers element e of base b from block
    ``(b + e 2^bf) >> log2(N / C)``, runs the last stages and stores natural
    order, canonical (untwisted when inverse). ``lazy`` as the kernel's flag:
    ``None`` takes it whenever every prime is below 2^30."""
    n, logn = tables.n, tables.n.bit_length() - 1
    if lazy is None:
        lazy = max(tables.primes) < LAZY_PRIME_LIMIT
    if lazy and max(tables.primes) >= LAZY_PRIME_LIMIT:
        raise ValueError("lazy butterflies need every prime below 2^30")
    local, kf = schedule_plan(logn, cluster, radix)
    logc = cluster.bit_length() - 1
    m, bf = logn - logc, logn - kf
    msize = 1 << m
    fwd, inv, _ = host_tables(tables)
    twist, tw = (torch.as_tensor(a.astype(np.int64)) for a in (inv if inverse else fwd))
    ar = _Arith(tables, lazy)
    lead, nl = x.shape[:-2], x.shape[-2]
    xb = x.reshape(-1, nl, n)

    # load: block r takes i = C v + bitrev(r), position bitrev(v)
    smem = torch.zeros((xb.shape[0], nl, cluster, msize), dtype=torch.int64)
    v = np.arange(msize)
    dest = torch.as_tensor(swizzle(_bitrev(v, m), m))
    for r in range(cluster):
        i = torch.as_tensor(cluster * v + int(_bitrev(np.array([r]), logc)[0]))
        vals = xb[..., i]
        if not inverse:
            vals = ar.mul(vals, twist[:, i][None])
        smem[:, :, r, dest] = ar.see(vals)

    # local passes, in place
    b0 = 0
    for k in local:
        t = np.arange(msize >> k)
        low = t & ((1 << b0) - 1)
        pos = (low + ((t >> b0) << (b0 + k)))[:, None] + (np.arange(1 << k) << b0)[None, :]
        where = torch.as_tensor(swizzle(pos, m))
        smem[..., where] = _stages(ar, smem[..., where], tw, b0, k, low)
        b0 += k

    # closing pass: top kf stages across the cluster, then the store
    base = np.arange(1 << bf)
    q = base[:, None] + (np.arange(1 << kf) << bf)[None, :]                     # [T, 2^kf]
    rank, where = torch.as_tensor(q >> m), torch.as_tensor(swizzle(q & (msize - 1), m))
    regs = _stages(ar, smem[:, :, rank, where][:, :, None], tw, bf, kf, base)
    if inverse:
        regs = ar.mul(regs, twist[:, torch.as_tensor(q)][None, :, None])
        regs = ar.canonical(regs, 2) if lazy else regs
    elif lazy:
        regs = ar.canonical(regs)
    out = torch.empty_like(xb)
    out[..., torch.as_tensor(q)] = regs[:, :, 0]
    return out.reshape(lead + (nl, n)), ar.max_seen


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------

def _checked(tables, x: torch.Tensor) -> int:
    """Raise on anything the kernel does not take; the polynomial count."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA NTT takes CUDA tensors, got {x.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"residues must be int64, got {x.dtype}")
    n, nlimbs = tables.n, len(tables.primes)
    if x.dim() < 2 or x.shape[-1] != n or x.shape[-2] != nlimbs:
        raise ValueError(f"expected [..., {nlimbs}, {n}], got {tuple(x.shape)}")
    check_n(n)
    if not x.is_contiguous():
        raise ValueError("the CUDA NTT needs a contiguous tensor")
    polys = x.numel() // n
    if polys * max(CLUSTERS) >= 1 << 31:
        raise ValueError(f"{polys} polynomials exceed one launch grid")
    return polys


def cluster_args(tables, polys: int, inverse: bool, cluster: Optional[int] = None,
                 lazy: Optional[bool] = None) -> tuple:
    """The C launcher's arguments after the polynomial count for one launch
    of the cluster kernel: (nlimbs, logn, inverse, cluster, lazy, packed
    local passes, kf). ``cluster`` / ``lazy`` override :func:`choose_cluster`."""
    n, nlimbs = tables.n, len(tables.primes)
    c, lz = choose_cluster(polys, n, tables.primes)
    cluster = c if cluster is None else int(cluster)
    lazy = lz if lazy is None else bool(lazy)
    if cluster not in legal_clusters(n):
        raise ValueError(f"cluster size {cluster} is not legal at N = {n}")
    if lazy and not lz:
        raise ValueError("lazy butterflies need every prime below 2^30")
    logn = n.bit_length() - 1
    local, kf = schedule_plan(logn, cluster)
    return nlimbs, logn, int(inverse), cluster, int(lazy), pack_plan(local), kf


def launch(tables, x: torch.Tensor, inverse: bool, cluster: Optional[int] = None,
           lazy: Optional[bool] = None) -> torch.Tensor:
    """Forward (or inverse) NTT of a contiguous int64[..., L, N] CUDA tensor
    through the kernel, which takes every N the port supports and both kinds
    of tower. Raises on anything the kernel does not take. ``cluster`` /
    ``lazy`` override :func:`choose_cluster` (any legal cluster size;
    ``lazy=False`` is legal for every tower, ``lazy=True`` only below 2^30).

    The launch arguments after the output are worked out once per launch
    shape and device of a ring; the launch is checked and counted."""
    polys = _checked(tables, x)
    lib = LIB.load()
    which = "inv" if inverse else "fwd"

    def arguments():
        kt = kernel_tables(tables, x.device)
        twist, tw = kt[which]
        return (twist.data_ptr(), tw.data_ptr(), kt["pn"].data_ptr(), polys,
                *cluster_args(tables, polys, inverse, cluster, lazy))

    mid = tables.cached(("toyfhe_ntt_cluster", x.device, polys, which, cluster, lazy), arguments)
    if x.data_ptr() % 16:
        x = x.clone()                      # the kernel loads 16 bytes a thread
    out = torch.empty_like(x)
    if x.device.index == torch.cuda.current_device():
        err = lib.toyfhe_ntt_cluster(x.data_ptr(), out.data_ptr(), *mid,
                                     torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(x.device):
            err = lib.toyfhe_ntt_cluster(x.data_ptr(), out.data_ptr(), *mid,
                                         torch.cuda.current_stream().cuda_stream)
    LIB.check(err, "CUDA NTT")
    launches[which] += 1
    transforms[which] += polys
    return out


def kernel_attrs(kf: int, inverse: bool, lazy: bool) -> dict:
    """Registers a thread and static shared memory of one instantiation of
    the cluster kernel, as the CUDA runtime reports them (builds the library)."""
    import ctypes
    buf = (ctypes.c_int * 2)()
    LIB.check(LIB.load().toyfhe_ntt_cluster_attrs(kf, int(inverse), int(lazy),
                                                  ctypes.addressof(buf)), "NTT attributes")
    return {"registers": buf[0], "static_smem": buf[1]}


def block_shape(n: int, cluster: int) -> dict:
    """Threads and dynamic shared-memory bytes of one block, as the C
    launcher sets them: one radix-8 item a thread, at most 512."""
    per_block = n // cluster
    return {"threads": min(512, max(32, per_block // 8)),
            "smem": 4 * per_block + 4 * TW_SHARED}
