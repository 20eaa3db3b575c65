"""Ring layer (L1): power-of-two negacyclic rings over RNS towers.

Port of ``toyfhe_tpu/core/ring.py``. A ring element is a residue tensor
``int64[..., L, N]`` (RNS limbs × coefficients); all tower metadata
(primes, ψ roots, Montgomery constants, twiddles) is host data in
:class:`RingContext`, uploaded to a device once per device on first use.
A :class:`RingElt` carries ``primal`` (coefficient domain) and/or ``dual``
(NTT domain) tensors; ``ensure_primal`` / ``ensure_dual`` return a new
element with the missing view computed. The device of an element is the
device of its tensors.

Limb sharding: a :class:`ShardedRing` is one rank's view of a tower on an
'rp' mesh under the strided layout of ``parallel/sharding.py``. It keeps
the tower's identity (``n``, ``primes``, ``nlimbs``, ``modulus``,
``select``), so the scale algebra and the ``ring is`` checks of the engine
read as they do on one device, while its per-row data (``mp``, ``tables``,
``scalar_residues``, ``from_bigint``) are those of the rows the rank holds
(``local``), so every per-limb operation runs unchanged on the rank's rows.
The operations that cross limbs (:func:`rescale`, :func:`rescale_dual`)
issue one counted collective each through :func:`gather`.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import native as crt_native
from ..ops import modmath, ntt as nttmod
from ..ops.modmath import MontParams
from ..utils import graphs, metrics, numtheory as nt

__all__ = ["RingContext", "RingElt", "ShardedRing", "make_ring", "make_rns_ring",
           "shard_view"]


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
        self._native: Optional[crt_native.CrtNative] = None
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

    @property
    def local(self) -> "RingContext":
        """The tower of the rows this process holds: the tower itself (a
        :class:`ShardedRing` holds some of them)."""
        return self

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

    # ---- host CRT: the C++ library of the decodes, and the exact oracle ----
    def native(self) -> Optional[crt_native.CrtNative]:
        """The C++ CRT of this tower (built at first use, kept per tower),
        or ``None`` for a tower the library cannot hold: the callers then
        take the exact Python CRT (:meth:`centered_ints`). Raises if the
        library cannot be built."""
        if self._native is None:
            try:
                self._native = crt_native.CrtNative(self.primes)
            except crt_native.TowerRefused:
                self._native = False
        return self._native or None

    def centered_ints(self, primal: np.ndarray) -> list:
        """The centered representatives in (−q/2, q/2] of [L, N] residues,
        as exact Python ints: the decodes' path where :meth:`native` is
        ``None``."""
        q = self.modulus
        return [nt.centered(x, q) for x in self.to_bigint(primal)]

    def to_bigint(self, primal: np.ndarray) -> list:
        """CRT-reconstruct [L, N] residues to Python ints in [0, q),
        exactly (the oracle of :meth:`native`)."""
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
        return np.array([int(value) % p for p in self.primes], dtype=np.int64).reshape(-1, 1)


class ShardedRing(RingContext):
    """The rows of ``whole`` that one rank of ``mesh`` holds on ``axis``:
    those whose key-tower index is ≡ the rank's coordinate (mod the axis
    extent), ``held`` (positions in ``whole``, ascending; possibly none).

    Global, as ``whole``'s: ``n``, ``primes``, ``nlimbs``, ``modulus`` and
    :meth:`select` (whose result is again a view). Held: ``mp``, ``tables``,
    :meth:`scalar_residues` and :meth:`from_bigint`, those of ``local`` =
    ``whole.select(held)``. One view per (tower, mesh, axis)
    (:func:`shard_view`), so views compare by identity as towers do."""

    def __init__(self, whole: RingContext, mesh, axis: str):
        from ..parallel import sharding as S
        self.whole, self.mesh, self.axis = whole, mesh, axis
        self.n = whole.n
        self.primes = whole.primes
        self.psis = whole.psis
        self.held = S.strided_rows(whole._root_indices, mesh.shape[axis], mesh.index(axis))
        self._local = whole.select(self.held)
        self.tables = self._local.tables
        self.mp = self._local.mp
        self._index: dict = {}

    def __repr__(self):
        return (f"ShardedRing(N={self.n}, L={self.nlimbs}, held={self.held}, "
                f"{self.axis}={self.mesh.shape[self.axis]})")

    @property
    def local(self) -> RingContext:
        return self._local

    def select(self, which: Sequence[int]) -> "ShardedRing":
        return shard_view(self.whole.select(which), self.mesh, self.axis)

    def scalar_residues(self, value: int) -> np.ndarray:
        return self._local.scalar_residues(value)

    def from_bigint(self, values: Sequence[int]) -> np.ndarray:
        return self._local.from_bigint(values)

    def galois_tables(self, g: int):
        return self.whole.galois_tables(g)

    def native(self):
        raise NotImplementedError("decode a gathered ciphertext (rlwe.ct_gather)")

    def to_bigint(self, primal):
        raise NotImplementedError("CRT-reconstruct a gathered ciphertext (rlwe.ct_gather)")

    def index_of(self, positions: Sequence[int], device) -> torch.Tensor:
        """The held rows among ``positions`` (of ``whole``) as indices into
        this rank's tensors, an int64 tensor on ``device``, cached."""
        key = (tuple(positions), device)
        if key not in self._index:
            at = {q: i for i, q in enumerate(self.held)}
            self._index[key] = modmath.as_residues([at[q] for q in positions if q in at],
                                                   device)
        return self._index[key]


def shard_view(ring: RingContext, mesh, axis: str = "rp") -> ShardedRing:
    """The :class:`ShardedRing` of ``ring`` (a whole tower) on ``mesh``."""
    if isinstance(ring, ShardedRing):
        raise ValueError("the tower is sharded already")
    views = ring.__dict__.setdefault("_views", {})
    if (mesh, axis) not in views:
        views[(mesh, axis)] = ShardedRing(ring, mesh, axis)
    return views[(mesh, axis)]


def whole(ring: RingContext) -> RingContext:
    """The whole tower of a view (a whole tower itself)."""
    return ring.whole if isinstance(ring, ShardedRing) else ring


def like(ring: RingContext, other: RingContext) -> RingContext:
    """``other`` (a whole tower) sharded as ``ring`` is."""
    return shard_view(other, ring.mesh, ring.axis) if isinstance(ring, ShardedRing) else other


def held(ring: RingContext) -> Sequence[int]:
    """The positions of ``ring``'s rows this process holds, ascending."""
    return ring.held if isinstance(ring, ShardedRing) else range(ring.nlimbs)


def held_below(ring: RingContext, bound: int) -> int:
    """How many of the held rows lie below position ``bound``."""
    return bisect.bisect_left(held(ring), bound)


def held_rows(ring: RingContext, x):
    """This process's rows of ``x`` (a whole tower's ``[..., L, N]`` tensor,
    or a host array with the rows on axis 0 when ``x`` is not a tensor)."""
    if not isinstance(ring, ShardedRing):
        return x
    if not torch.is_tensor(x):
        return np.asarray(x)[ring.held]
    return x.index_select(-2, modmath.const(ring.held, x.device))


def gather(ring: RingContext, x: torch.Tensor, site: str) -> torch.Tensor:
    """The whole tower's ``[..., L, N]`` on every rank from each rank's held
    rows ``x``: one all-gather over the view's axis, counted at ``site``
    (a whole tower's ``x`` as it is)."""
    if not isinstance(ring, ShardedRing):
        return x
    from ..parallel import sharding as S
    return S.gather_strided(x, ring.whole._root_indices, ring.mesh, ring.axis, site)


def require_whole(ring: RingContext, what: str) -> None:
    """Raise ``NotImplementedError`` for ``what`` on a sharded tower: an
    operation with no sharded form is never computed whole on one rank."""
    if isinstance(ring, ShardedRing):
        raise NotImplementedError(f"{what} has no limb-sharded form")


_VIEWS = ("primal", "dual")


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


# the views held are the leaves, which ones are held is static (as in the
# reference): a missing view stays None
pytree.register_pytree_node(
    RingElt,
    lambda x: ([getattr(x, k) for k in _VIEWS if getattr(x, k) is not None],
               tuple(k for k in _VIEWS if getattr(x, k) is not None)),
    lambda ch, keys: RingElt(**dict(zip(keys, ch))))


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
    metrics.count("ntt_limb_transform", math.prod(x.dual.shape[:-1]))
    return RingElt(primal=nttmod.intt(ring.tables, x.dual), dual=x.dual)


def ensure_dual(ring: RingContext, x: RingElt) -> RingElt:
    if x.dual is not None:
        return x
    metrics.count("ntt_limb_transform", math.prod(x.primal.shape[:-1]))
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
    # the scalar is data (a user's value times the scale, say): uploaded per
    # call, and kept only while a graph that reads it is recorded
    s = (modmath.const if graphs.tracing() else modmath.as_residues)(s, a.device)
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
    """crtselect: restrict to a sub-tower. On a sharded tower each rank
    keeps the rows of ``which`` it holds: no row moves."""
    which = list(which)
    sub_ring = ring.select(which)

    def take(arr):
        if arr is None:
            return None
        if isinstance(ring, ShardedRing):
            return arr.index_select(-2, ring.index_of([which[q] for q in sub_ring.held],
                                                      arr.device))
        return arr.index_select(-2, modmath.const(which, arr.device))

    return sub_ring, RingElt(primal=take(a.primal), dual=take(a.dual))


def modswitch_drop(ring: RingContext, a: RingElt) -> Tuple[RingContext, RingElt]:
    """Drop the last limb without rescaling."""
    return limb_select(ring, a, range(ring.nlimbs - 1))


def _rescale_parts(ring: RingContext, device):
    """(the tower without its last limb, the tower of the last limb alone,
    how many held rows survive, q_last⁻¹ in Montgomery form on the held
    surviving rows as a tensor on ``device``). On a sharded tower the last
    limb's rank holds its row; the other ranks hold none."""
    _, inv_m = whole(ring).rescale_consts()
    nsurv = held_below(ring, ring.nlimbs - 1)
    inv = modmath.const(np.asarray(inv_m, dtype=np.int64)[list(held(ring))[:nsurv]], device)
    return ring.drop_last(), ring.select([ring.nlimbs - 1]), nsurv, inv


def rescale(ring: RingContext, a: RingElt) -> Tuple[RingContext, RingElt]:
    """Exact divide-and-round by the last prime: for surviving limb j,
    a'_j = q_k^{-1} · (a_j − [a_k]_{q_j}) mod q_j.

    Uses the raw (non-centered) representative of the dropped limb, as the
    reference does. On a sharded tower the dropped row reaches every rank
    in one all-gather (site ``rescale_broadcast``).
    """
    a = ensure_primal(ring, a)
    sub_ring, last_ring, nsurv, inv = _rescale_parts(ring, a.primal.device)
    mp = sub_ring.mp.on(a.device)
    last = gather(last_ring, a.primal[..., nsurv:, :],
                  "rescale_broadcast")                # [..., 1, N] residues mod q_k
    surv = a.primal[..., :nsurv, :]
    last_mod = modmath.umod(last, mp.p)               # raw [a_k] reduced mod q_j
    diff = modmath.sub_mod(surv, last_mod, mp)
    return sub_ring, RingElt(primal=modmath.mont_mul(diff, inv, mp))


def rescale_dual(ring: RingContext, a: RingElt) -> Tuple[RingContext, RingElt]:
    """Dual-domain rescale, bit-identical to :func:`rescale` (the NTT is
    linear and exact: NTT(b) = a_dual·q_k^{-1} − NTT([a_k]·q_k^{-1})), paying
    an INTT of one row and an NTT of L−1 rows instead of a full-tower INTT
    and re-NTT. On a sharded tower the last row's rank transforms it and
    one all-gather hands it to every rank (site ``rescale_broadcast``)."""
    if a.dual is None:
        raise ValueError("rescale_dual needs the dual form")
    sub_ring, last_ring, nsurv, inv = _rescale_parts(ring, a.device)
    last = nttmod.intt(last_ring.tables, a.dual[..., nsurv:, :])   # raw residues
    metrics.count("ntt_limb_transform", math.prod(last.shape[:-1]))
    last = gather(last_ring, last, "rescale_broadcast")
    mp = sub_ring.mp.on(a.device)
    corr = modmath.mont_mul(modmath.umod(last, mp.p), inv, mp)
    corr_dual = nttmod.ntt(sub_ring.tables, corr)
    metrics.count("ntt_limb_transform", math.prod(corr.shape[:-1]))
    out = modmath.sub_mod(modmath.mont_mul(a.dual[..., :nsurv, :], inv, mp),
                          corr_dual, mp)
    return sub_ring, RingElt(dual=out)


def rescale_adapted(ring: RingContext, a: RingElt, t: int) -> Tuple[RingContext, RingElt]:
    """BGV divide-and-round by the last prime: the correction d is chosen
    ≡ a mod q_k and ≡ 0 mod t (the plaintext modulus), so (a − d)/q_k keeps
    the noise ≡ 0 mod t and the low plaintext digits survive the division.
    d = r + q_k·v with r the centered last-limb residue and v ≡ −r·q_k⁻¹
    (mod t), centered; ‖d‖ ≤ q_k(t + 1)/2. The message is multiplied by
    q_k⁻¹ mod t (``bgv.BGVTag`` tracks it)."""
    require_whole(ring, "the BGV rescale")
    a = ensure_primal(ring, a)
    sub_ring = ring.drop_last()
    qk = ring.primes[-1]
    qk_mod, inv_m = ring.rescale_consts()
    t = int(t)
    if not (1 < t < (1 << 20)):
        raise ValueError("rescale_adapted needs a plaintext modulus < 2^20")
    dev = a.primal.device
    mp = sub_ring.mp
    r = modmath.centered(a.primal[..., -1:, :], ring.select([ring.nlimbs - 1]).mp)
    # v ≡ −r·q_k⁻¹ (mod t), centered in (−t/2, t/2]; r mod t and the
    # constant are below 2^20, so their product is exact in int64
    neg_inv = (t - pow(qk, -1, t) % t) % t
    vin = torch.remainder(torch.remainder(r, t) * neg_inv, t)
    v = torch.where(vin > t // 2, vin - t, vin)
    dj = modmath.add_mod(modmath.from_signed(r, mp),
                         modmath.mul_mod(modmath.const(qk_mod, dev),
                                         modmath.from_signed(v, mp), mp), mp)
    diff = modmath.sub_mod(a.primal[..., :-1, :], dj, mp)
    return sub_ring, RingElt(primal=modmath.mont_mul(diff, modmath.const(inv_m, dev), mp))
