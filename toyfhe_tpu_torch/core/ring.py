"""Ring layer (L1): power-of-two negacyclic rings over RNS towers.

Port of ``toyfhe_tpu/core/ring.py``. A ring element is a residue tensor
``int64[..., L, N]`` (RNS limbs × coefficients); all tower metadata
(primes, ψ roots, Montgomery constants, twiddles) is host data in
:class:`RingContext`, uploaded to a device once per device on first use.
A :class:`RingElt` carries ``primal`` (coefficient domain) and/or ``dual``
(NTT domain) tensors; ``ensure_primal`` / ``ensure_dual`` return a new
element with the missing view computed. The device of an element is the
device of its tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import modmath, ntt as nttmod
from ..ops.modmath import MontParams
from ..utils import numtheory as nt

__all__ = ["RingContext", "RingElt", "make_ring", "make_rns_ring"]


class RingContext:
    """Static description of 𝔽q[x]/(x^N+1) with an RNS tower of primes.

    Identity-hashed; construct once per parameter set (use
    :func:`make_rns_ring` / ``select``/``drop_last`` for derived towers —
    they are cached on the root ring).
    """

    def __init__(self, n: int, primes: Sequence[int], psis: Optional[Sequence[int]] = None,
                 tables: Optional[nttmod.NttTables] = None):
        self.n = int(n)
        self.primes = [int(p) for p in primes]
        self.tables = tables if tables is not None else nttmod.NttTables(self.n, self.primes, psis)
        self.mp: MontParams = self.tables.mp
        self.psis = self.tables.psis
        self._children: dict = {}
        self._rescale_cache: dict = {}
        self._galois_cache: dict = {}
        # derived towers are cached on the ROOT ring by absolute limb
        # indices, so drop_last() of a derived tower is the same object
        self._root: "RingContext" = self
        self._root_indices = tuple(range(len(self.primes)))

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def __repr__(self):
        return f"RingContext(N={self.n}, L={self.nlimbs}, logq≈{self.log2q:.1f})"

    @property
    def nlimbs(self) -> int:
        return len(self.primes)

    @property
    def modulus(self) -> int:
        """Full composite modulus q = ∏ q_i as a Python int."""
        return math.prod(self.primes)

    @property
    def log2q(self) -> float:
        return sum(math.log2(p) for p in self.primes)

    # ---- derived towers (crtselect / drop_last) ----
    def select(self, which: Sequence[int]) -> "RingContext":
        key = tuple(self._root_indices[int(i)] for i in which)
        root = self._root
        if key == root._root_indices:
            return root
        if key not in root._children:
            child = RingContext(self.n, [root.primes[i] for i in key],
                                tables=root.tables.select(key))
            child._root = root
            child._root_indices = key
            root._children[key] = child
        return root._children[key]

    def drop_last(self) -> "RingContext":
        return self.select(range(self.nlimbs - 1))

    # ---- rescale constants (modswitch) ----
    def rescale_consts(self):
        """(q_last mod q_j, q_last^{-1} mod q_j in Montgomery form) for the
        surviving limbs j < L-1, as host uint32 ``[L-1, 1]`` arrays."""
        if "rescale" not in self._rescale_cache:
            qk = self.primes[-1]
            surv = self.primes[:-1]
            qk_mod = np.array([[qk % p] for p in surv], dtype=np.uint32)
            inv_m = np.array(
                [[pow(qk, -1, p) * (1 << 32) % p] for p in surv], dtype=np.uint64
            ).astype(np.uint32)
            self._rescale_cache["rescale"] = (qk_mod, inv_m)
        return self._rescale_cache["rescale"]

    def galois_tables(self, g: int):
        """(src, neg) gather tables of x(X) ↦ x(X^g), host numpy, cached."""
        g = int(g)
        if g not in self._galois_cache:
            self._galois_cache[g] = nttmod.galois_perm_tables(self.n, g)
        return self._galois_cache[g]

    # ---- host-side exact CRT (decode path) ----
    def to_bigint(self, primal: np.ndarray) -> list:
        """CRT-reconstruct [L, N] residues to Python ints in [0, q)."""
        q = self.modulus
        acc = [0] * primal.shape[-1]
        for l, p in enumerate(self.primes):
            qhat = q // p
            corr = nt.invmod(qhat, p)
            row = primal[l].astype(object)
            for j in range(primal.shape[-1]):
                acc[j] += (int(row[j]) * corr % p) * qhat
        return [a % q for a in acc]

    def from_bigint(self, values: Sequence[int]) -> np.ndarray:
        """Python ints → int64[L, N] residues."""
        out = np.zeros((self.nlimbs, len(values)), dtype=np.int64)
        for l, p in enumerate(self.primes):
            out[l] = np.array([int(v) % p for v in values], dtype=np.int64)
        return out

    def scalar_residues(self, value: int) -> np.ndarray:
        """Python int → per-limb residue column int64[L, 1]."""
        return np.array([[int(value) % p] for p in self.primes], dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class RingElt:
    """Element of a negacyclic RNS ring: int64[..., L, N] in one or both
    domains (reference ``RingElement`` lazy primal/dual pair)."""

    primal: Optional[torch.Tensor] = None
    dual: Optional[torch.Tensor] = None

    @property
    def shape(self):
        arr = self.primal if self.primal is not None else self.dual
        return arr.shape

    @property
    def device(self) -> torch.device:
        arr = self.primal if self.primal is not None else self.dual
        return arr.device


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def make_ring(n: int, primes: Sequence[int]) -> RingContext:
    return RingContext(n, primes)


def make_rns_ring(n: int, logqs: Sequence[int]) -> RingContext:
    """RNS ring from requested limb bit-sizes, with primes ≡ 1 (mod 2N)."""
    return RingContext(n, nt.ntt_prime_chain(n, logqs))


def zero(ring: RingContext, batch: Tuple[int, ...] = (), *, device) -> RingElt:
    return RingElt(primal=torch.zeros(tuple(batch) + (ring.nlimbs, ring.n),
                                      dtype=torch.int64, device=device))


def zero_like(ring: RingContext, x: RingElt) -> RingElt:
    arr = x.primal if x.primal is not None else x.dual
    z = torch.zeros_like(arr)
    return RingElt(primal=z, dual=z)


# ---------------------------------------------------------------------------
# domain management (lazy primal/dual)
# ---------------------------------------------------------------------------

def ensure_primal(ring: RingContext, x: RingElt) -> RingElt:
    if x.primal is not None:
        return x
    return RingElt(primal=nttmod.intt(ring.tables, x.dual), dual=x.dual)


def ensure_dual(ring: RingContext, x: RingElt) -> RingElt:
    if x.dual is not None:
        return x
    return RingElt(primal=x.primal, dual=nttmod.ntt(ring.tables, x.primal))


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

def add(ring: RingContext, a: RingElt, b: RingElt) -> RingElt:
    return _addsub(ring, a, b, modmath.add_mod)


def sub(ring: RingContext, a: RingElt, b: RingElt) -> RingElt:
    return _addsub(ring, a, b, modmath.sub_mod)


def _addsub(ring: RingContext, a: RingElt, b: RingElt, op) -> RingElt:
    mp = ring.mp
    primal = dual = None
    if a.primal is not None and b.primal is not None:
        primal = op(a.primal, b.primal, mp)
    if a.dual is not None and b.dual is not None:
        dual = op(a.dual, b.dual, mp)
    if primal is None and dual is None:
        # mixed domains: canonicalize through dual (ciphertext home domain)
        a2, b2 = ensure_dual(ring, a), ensure_dual(ring, b)
        dual = op(a2.dual, b2.dual, mp)
    return RingElt(primal=primal, dual=dual)


def neg(ring: RingContext, a: RingElt) -> RingElt:
    mp = ring.mp
    return RingElt(
        primal=None if a.primal is None else modmath.neg_mod(a.primal, mp),
        dual=None if a.dual is None else modmath.neg_mod(a.dual, mp))


def mul(ring: RingContext, a: RingElt, b: RingElt) -> RingElt:
    """Ring product: pointwise in the evaluation domain."""
    a2, b2 = ensure_dual(ring, a), ensure_dual(ring, b)
    return RingElt(dual=modmath.mul_mod(a2.dual, b2.dual, ring.mp))


def scalar_mul(ring: RingContext, s, a: RingElt) -> RingElt:
    """Multiply by a scalar given as per-limb residues [L, 1] (or an int,
    converted on the host). Linear: applies in whichever domains exist."""
    if isinstance(s, (int, np.integer)):
        s = ring.scalar_residues(int(s))
    s = torch.as_tensor(np.asarray(s, dtype=np.int64), device=a.device)
    mp = ring.mp
    return RingElt(
        primal=None if a.primal is None else modmath.mul_mod(a.primal, s, mp),
        dual=None if a.dual is None else modmath.mul_mod(a.dual, s, mp))


def apply_galois(ring: RingContext, a: RingElt, galois_element: int) -> RingElt:
    """x(X) ↦ x(X^g) — primal-domain permutation."""
    src, negm = ring.galois_tables(galois_element)
    a = ensure_primal(ring, a)
    return RingElt(primal=nttmod.apply_galois(ring.mp, a.primal, src, negm))


# ---------------------------------------------------------------------------
# RNS tower ops
# ---------------------------------------------------------------------------

def limb_select(ring: RingContext, a: RingElt, which: Sequence[int]) -> Tuple[RingContext, RingElt]:
    """crtselect: restrict to a sub-tower."""
    which = list(which)
    sub_ring = ring.select(which)

    def take(arr):
        if arr is None:
            return None
        return arr.index_select(-2, torch.tensor(which, device=arr.device))

    return sub_ring, RingElt(primal=take(a.primal), dual=take(a.dual))


def modswitch_drop(ring: RingContext, a: RingElt) -> Tuple[RingContext, RingElt]:
    """Drop the last limb without rescaling."""
    return limb_select(ring, a, range(ring.nlimbs - 1))


def rescale(ring: RingContext, a: RingElt) -> Tuple[RingContext, RingElt]:
    """Exact divide-and-round by the last prime: for surviving limb j,
    a'_j = q_k^{-1} · (a_j − [a_k]_{q_j}) mod q_j.

    Uses the raw (non-centered) representative of the dropped limb, as the
    reference does.
    """
    a = ensure_primal(ring, a)
    sub_ring = ring.drop_last()
    _, inv_m = ring.rescale_consts()
    mp = sub_ring.mp.on(a.device)
    last = a.primal[..., -1:, :]                      # [..., 1, N] residues mod q_k
    surv = a.primal[..., :-1, :]
    last_mod = modmath.umod(last, mp.p)               # raw [a_k] reduced mod q_j
    diff = modmath.sub_mod(surv, last_mod, mp)
    inv = torch.as_tensor(inv_m.astype(np.int64), device=a.device)
    return sub_ring, RingElt(primal=modmath.mont_mul(diff, inv, mp))


def rescale_dual(ring: RingContext, a: RingElt) -> Tuple[RingContext, RingElt]:
    """Dual-domain rescale, bit-identical to :func:`rescale` (the NTT is
    linear and exact: NTT(b) = a_dual·q_k^{-1} − NTT([a_k]·q_k^{-1})), paying
    an INTT of one row and an NTT of L−1 rows instead of a full-tower INTT
    and re-NTT."""
    if a.dual is None:
        raise ValueError("rescale_dual needs the dual form")
    sub_ring = ring.drop_last()
    _, inv_m = ring.rescale_consts()
    inv = torch.as_tensor(inv_m.astype(np.int64), device=a.device)
    last_ring = ring.select([ring.nlimbs - 1])
    last = nttmod.intt(last_ring.tables, a.dual[..., -1:, :])   # raw residues
    mp = sub_ring.mp.on(a.device)
    corr = modmath.mont_mul(modmath.umod(last, mp.p), inv, mp)
    corr_dual = nttmod.ntt(sub_ring.tables, corr)
    out = modmath.sub_mod(modmath.mont_mul(a.dual[..., :-1, :], inv, mp),
                          corr_dual, mp)
    return sub_ring, RingElt(dual=out)
