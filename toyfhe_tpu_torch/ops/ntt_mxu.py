"""The four-step negacyclic NTT over int8 digit matrices.

Port of ``toyfhe_tpu/ops/ntt_mxu.py``. Four-step decomposition,
N = n1·n2:

    j = j1·n2 + j2,  k = k1 + n1·k2
    A[k1, j2] = Σ_{j1} Xmat[j1, j2] · ω_{n1}^{j1·k1}        (matrix product)
    B[k1, j2] = A[k1, j2] · ω_N^{k1·j2}                      (twiddle)
    C[k2, k1] = Σ_{j2} B[k1, j2] · ω_{n2}^{j2·k2}            (matrix product)
    X[k1 + n1·k2] = C[k2, k1]  — flattening C is already natural order.

The two modular matrix products are exact integer products of **balanced
base-256 digits** (each in [−128, 127], an int8): the 16 digit×digit
products are summed into 7 shifted digit diagonals, which recombine with a
64-bit accumulation and two Montgomery reductions per element. Works for
primes < 2^30. The ψ-twist / untwist and the negacyclic semantics are those
of :mod:`.ntt`; outputs are canonical, natural order, bit-equal to the
radix-2 transform.

:class:`MxuNttTables` holds the reference's host tables as numpy (equal
array for array). The device functions are plain torch on any device: this
module is the plain form of the four-step transform, and the plain twin of
the CUDA kernel K2 (:mod:`.ntt_mxu_pallas`) is built from its pieces.
"""

from __future__ import annotations

import numpy as np
import torch

from .modmath import as_residues, canonical_device, mont_mul_raw
from .ntt import NttTables, _to_mont_np

N1 = 128           # the stage-1 edge the layout kernel assumes
_NDIG = 4
_OFF = 1 << 23
_MASK32 = (1 << 32) - 1


def lane_optimal_n1(n: int) -> int:
    """The reference's choice of stage-1 edge that puts 128 in the minor
    dimension (n2) below N = 2^14, and 128 from there on."""
    if n % 128 == 0 and n < 16384:
        return max(2, n // 128)
    return N1


def _build_mat(p: int, w: int, rows: int, cols: int) -> np.ndarray:
    """M[i, j] = w^{i·j} mod p as an object matrix (host, setup only)."""
    out = np.zeros((rows, cols), dtype=object)
    wr = 1
    for i in range(rows):
        v = 1
        for j in range(cols):
            out[i, j] = v
            v = v * wr % p
        wr = wr * w % p
    return out


def _balanced_digits_host(M: np.ndarray) -> np.ndarray:
    """object matrix -> int8[4, ...] balanced base-256 digits (values must
    be < 2^30 so four digits suffice)."""
    digs = []
    cur = M.astype(object)
    for _ in range(_NDIG):
        r = np.vectorize(lambda x: int(x) & 255)(cur).astype(np.int64)
        r = np.where(r >= 128, r - 256, r)
        cur = (cur - r) // 256
        digs.append(r.astype(np.int8))
    if not np.all(np.vectorize(int)(cur) == 0):
        raise ValueError("prime too large for 4 digits")
    return np.stack(digs, 0)


class MxuNttTables:
    """Digit-decomposed DFT matrices + twiddles for the four-step NTT.

    ``n1`` is the stage-1 edge (N = n1·n2), 128 by default. Host numpy,
    equal to the reference's arrays: ``w1/w1i/w2/w2i`` int8 digit matrices,
    ``tw/twi`` Montgomery twiddles, the 7-term recombination constants
    ``cs/corr/r1_mont/hi_mont`` and the paired-diagonal ones
    ``cs32/cs48/corr2`` with their validity flag ``paired_ok``."""

    def __init__(self, tables: NttTables, n1: int = None):
        n = tables.n
        if n1 is None:
            n1 = N1
        if not (n % n1 == 0 and n >= n1 and n1 <= 128):
            raise ValueError(f"no four-step split of N={n} with n1={n1}")
        for p in tables.primes:
            if p >= (1 << 30):
                raise ValueError("the four-step digit path requires primes < 2^30")
        n2 = n // n1
        self.n, self.n1, self.n2 = n, n1, n2
        self.primes = tables.primes
        self.mp = tables.mp
        L = len(tables.primes)
        self.psi_pow = tables.psi_pow          # (L, N) Montgomery
        self.psi_ipow = tables.psi_ipow

        self.w1 = np.zeros((L, _NDIG, n1, n1), dtype=np.int8)
        self.w1i = np.zeros((L, _NDIG, n1, n1), dtype=np.int8)
        self.w2 = np.zeros((L, _NDIG, n2, n2), dtype=np.int8)
        self.w2i = np.zeros((L, _NDIG, n2, n2), dtype=np.int8)
        self.tw = np.zeros((L, n1, n2), dtype=np.uint32)
        self.twi = np.zeros((L, n1, n2), dtype=np.uint32)
        for l, (p, psi) in enumerate(zip(tables.primes, tables.psis)):
            omega = psi * psi % p
            iomega = pow(omega, -1, p)
            self.w1[l] = _balanced_digits_host(_build_mat(p, pow(omega, n2, p), n1, n1))
            self.w1i[l] = _balanced_digits_host(_build_mat(p, pow(iomega, n2, p), n1, n1))
            self.w2[l] = _balanced_digits_host(_build_mat(p, pow(omega, n1, p), n2, n2))
            self.w2i[l] = _balanced_digits_host(_build_mat(p, pow(iomega, n1, p), n2, n2))
            self.tw[l] = _to_mont_np(_build_mat(p, omega, n1, n2), p)
            self.twi[l] = _to_mont_np(_build_mat(p, iomega, n1, n2), p)

        # digit-recombination constants (plain residues): c_s = 2^{8s} mod p
        cs = np.zeros((2 * _NDIG - 1, L, 1, 1), dtype=np.uint32)
        corr = np.zeros((L, 1, 1), dtype=np.uint32)
        r1m = np.zeros((L, 1, 1), dtype=np.uint32)
        him = np.zeros((L, 1, 1), dtype=np.uint32)
        for l, p in enumerate(tables.primes):
            tot = 0
            for s in range(2 * _NDIG - 1):
                cval = (1 << (8 * s)) % p
                cs[s, l] = cval
                tot += _OFF * cval
            corr[l] = tot % p
            r1m[l] = (1 << 32) % p             # mont_mul(lo, R mod p) = lo mod p
            him[l] = pow(2, 64, p)             # mont_mul(hi, R² mod p) = hi·2^32 mod p
        self.cs, self.corr = cs, corr
        self.r1_mont, self.hi_mont = r1m, him

        # paired-diagonal recombination constants: weights 2^{16t} for the
        # folded groups G'ₜ = G₂ₜ + 256·G₂ₜ₊₁ (t=0,1 are exact shifts;
        # t=2,3 need reduced constants), plus the 2^31-offset correction.
        cs32 = np.zeros((L, 1, 1), dtype=np.uint32)
        cs48 = np.zeros((L, 1, 1), dtype=np.uint32)
        corr2 = np.zeros((L, 1, 1), dtype=np.uint32)
        for l, p in enumerate(tables.primes):
            c32, c48 = pow(2, 32, p), pow(2, 48, p)
            cs32[l], cs48[l] = c32, c48
            corr2[l] = ((1 << 31) % p) * (1 + (1 << 16) + c32 + c48) % p
        self.cs32, self.cs48, self.corr2 = cs32, cs48, corr2
        self.paired_ok = all(
            self._paired_bound(w) < (1 << 31)
            for w in (self.w1, self.w1i, self.w2, self.w2i))
        self._dev: dict = {}

    @staticmethod
    def _paired_bound(w: np.ndarray) -> int:
        """Max possible |G'ₜ| = |G₂ₜ + 256·G₂ₜ₊₁| over the folded
        diagonal groups for digit matrix w: int8[L, 4, K, J] against
        worst-case x digits (|x| ≤ 128)."""
        colsum = np.abs(w.astype(np.int64)).sum(axis=2)      # (L, 4, J)
        smax = []
        for s in range(2 * _NDIG - 1):
            tot = sum(colsum[:, d] for d in range(_NDIG)
                      if 0 <= s - d < _NDIG)
            smax.append(int(tot.max()) * 128)
        return max(smax[2 * t] + 256 * smax[2 * t + 1] for t in range(3))

    def cached(self, key, build):
        """Memoize ``build()`` on this table object under ``key``."""
        if key not in self._dev:
            self._dev[key] = build()
        return self._dev[key]

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


class MxuRowView:
    """Row-sliced view of a full-tower :class:`MxuNttTables`: the tables of
    the sub-tower made of ``rows`` of the root. The small per-limb
    recombination constants are sliced eagerly; the big arrays (digit
    matrices, twiddles, ψ powers) stay on the root and are sliced at first
    use."""

    _BIG = ("w1", "w1i", "w2", "w2i", "tw", "twi", "psi_pow", "psi_ipow")

    def __init__(self, root: MxuNttTables, rows):
        self.root = root
        self.rows = tuple(int(r) for r in rows)
        idx = np.asarray(self.rows)
        self.n, self.n1, self.n2 = root.n, root.n1, root.n2
        self.primes = [root.primes[i] for i in self.rows]
        self.mp = root.mp.select(idx)
        self.cs = root.cs[:, idx]
        self.corr = root.corr[idx]
        self.r1_mont = root.r1_mont[idx]
        self.hi_mont = root.hi_mont[idx]
        self.cs32, self.cs48 = root.cs32[idx], root.cs48[idx]
        self.corr2 = root.corr2[idx]
        self.paired_ok = root.paired_ok    # subset bound ≤ root bound
        self._dev: dict = {}

    cached = MxuNttTables.cached

    def __getattr__(self, name):
        if name in MxuRowView._BIG:
            arr = getattr(self.root, name)[np.asarray(self.rows)]
            object.__setattr__(self, name, arr)
            return arr
        raise AttributeError(name)

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


# ---------------------------------------------------------------------------
# device functions (plain torch, any device)
# ---------------------------------------------------------------------------

def _balanced_digits_device(x: torch.Tensor) -> torch.Tensor:
    """int64[...] residues (< 2^30) -> int64[4, ...] balanced base-256
    digits, each in [−128, 127]."""
    digs = []
    cur = x
    for _ in range(_NDIG):
        r = cur & 255
        r = torch.where(r >= 128, r - 256, r)
        cur = (cur - r) >> 8
        digs.append(r)
    return torch.stack(digs, 0)


def digit_dot(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer einsum of two digit tensors. The product runs in
    float64: every digit is at most 128 in magnitude and at most 128 of
    them are summed, so each dot stays below 2^21 and is exact."""
    return torch.einsum(spec, a.to(torch.float64), b.to(torch.float64)).to(torch.int64)


def accumulate64(terms):
    """Σ of (value, constant) products as a (hi, lo) pair of 32-bit halves,
    carrying like the 64-bit accumulation of the kernels. Each value is a
    non-negative int64 below 2^32 and each constant below 2^30."""
    hi = lo = None
    for v, c in terms:
        prod = v * c                              # < 2^62
        h, l = prod >> 32, prod & _MASK32
        if hi is None:
            hi, lo = h, l
        else:
            nl = lo + l
            hi = hi + h + (nl >> 32)
            lo = nl & _MASK32
    return hi, lo


def reduce64(hi, lo, r1_mont, hi_mont, corr, p, rinv):
    """(hi·2^32 + lo − corr) mod p through the two Montgomery reductions of
    the kernels: REDC(lo·(R mod p)) + REDC(hi·(R² mod p)) − corr."""
    t1 = mont_mul_raw(lo, r1_mont, p, rinv)
    t2 = mont_mul_raw(hi, hi_mont, p, rinv)
    return torch.remainder(t1 + t2 - corr, p)


def _mod_matmul_c(digits_x, w_digits, cs, r1_mont, hi_mont, corr, mp3):
    """out[..., l, j, c] = Σ_k W[l, k, j]·X[..., l, k, c] mod p.

    digits_x: int64[4, ..., L, K, C]; w_digits: int64[L, 4, K, J]; the
    recombination constants int64 ``cs[7, L, 1, 1]`` and ``[L, 1, 1]``;
    ``mp3`` Montgomery constants shaped ``[L, 1, 1]`` on the operand's
    device. W is a symmetric Vandermonde matrix, so this is the DFT along
    the K axis."""
    groups = [None] * (2 * _NDIG - 1)
    for d in range(_NDIG):
        for e in range(_NDIG):
            P = digit_dot("lkj,...lkc->...ljc", w_digits[:, d], digits_x[e])
            s = d + e
            groups[s] = P if groups[s] is None else groups[s] + P
    hi, lo = accumulate64((groups[s] + _OFF, cs[s]) for s in range(2 * _NDIG - 1))
    return reduce64(hi, lo, r1_mont, hi_mont, corr, mp3.p, mp3.rinv)


def device_tables(mt, device) -> dict:
    """The tables of ``mt`` as int64 tensors on ``device``, uploaded once."""
    dev = canonical_device(device)

    def build():
        t = lambda a: as_residues(a, dev)
        mp = mt.mp.on(dev)
        return {
            "mp": mp, "mp3": mp.expand(),
            "w1": t(mt.w1), "w1i": t(mt.w1i), "w2": t(mt.w2), "w2i": t(mt.w2i),
            "tw": t(mt.tw), "twi": t(mt.twi),
            "psi_pow": t(mt.psi_pow), "psi_ipow": t(mt.psi_ipow),
            "cs": t(mt.cs), "corr": t(mt.corr),
            "r1_mont": t(mt.r1_mont), "hi_mont": t(mt.hi_mont),
            "cs32": t(mt.cs32), "cs48": t(mt.cs48), "corr2": t(mt.corr2),
        }

    return mt.cached(("plain", dev), build)


def _mod_matmul(d: dict, digits_x, w_digits):
    """See :func:`_mod_matmul_c`; constants taken from the device tables."""
    return _mod_matmul_c(digits_x, w_digits, d["cs"], d["r1_mont"], d["hi_mont"],
                         d["corr"], d["mp3"])


def _four_step(mt, x, w1: str, w2: str, twiddle: str, psi: str, pre: bool):
    d = device_tables(mt, x.device)
    mp, mp3 = d["mp"], d["mp3"]
    n, n2 = mt.n, mt.n2
    lead = x.shape[:-2]
    L = x.shape[-2]
    if pre:
        x = mont_mul_raw(x, d[psi], mp.p, mp.rinv)
    xm = x.reshape(lead + (L, mt.n1, n2))                    # Xmat[j1, j2]
    a = _mod_matmul(d, _balanced_digits_device(xm), d[w1])
    b = mont_mul_raw(a, d[twiddle], mp3.p, mp3.rinv)         # ⊙ ω^{k1·j2}
    bt = b.transpose(-1, -2)                                 # [..., L, j2, k1]
    c = _mod_matmul(d, _balanced_digits_device(bt), d[w2])
    out = c.reshape(lead + (L, n))                           # [k2, k1] → natural
    if not pre:
        out = mont_mul_raw(out, d[psi], mp.p, mp.rinv)
    return out


def ntt_mxu(mt, x: torch.Tensor) -> torch.Tensor:
    """Forward negacyclic NTT (natural order) of int64[..., L, N] — the
    four-step digit formulation."""
    return _four_step(mt, x, "w1", "w2", "tw", "psi_pow", pre=True)


def intt_mxu(mt, x: torch.Tensor) -> torch.Tensor:
    """Inverse negacyclic NTT (natural order) — the four-step digit
    formulation."""
    return _four_step(mt, x, "w1i", "w2i", "twi", "psi_ipow", pre=False)
