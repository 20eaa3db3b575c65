"""Negacyclic number-theoretic transform over RNS towers (layer L2).

Port of ``toyfhe_tpu/ops/ntt.py``. Conventions (the reference's, bit for
bit):

  * forward:  dual[k] = a(ψ^{2k+1}) — ψ^i premultiply, then the DFT with
    ω = ψ², natural output order;
  * inverse:  DFT with ω^{-1}, then the n^{-1}·ψ^{-i} untwist.

All twiddles are stored in Montgomery form, so each butterfly costs one
Montgomery product.

:func:`ntt` / :func:`intt` dispatch on the tensor's device: a CUDA tensor
goes to the hand-written kernel (:mod:`.ntt_cuda`, which raises rather than
fall back), a CPU tensor to the plain radix-2 version :func:`ntt_plain` /
:func:`intt_plain`. The transform is fixed mathematically and every output
is canonical in [0, p), so the two agree bit for bit.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .modmath import MontParams, as_residues, canonical_device, const, mont_mul_raw

__all__ = ["NttTables", "ntt", "intt", "ntt_plain", "intt_plain",
           "galois_perm_tables", "apply_galois", "galois_dual_perm",
           "galois_dual_perm_dev", "naive_negacyclic_mul"]


def _bitrev_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _to_mont_np(x: np.ndarray, p: int) -> np.ndarray:
    return ((x.astype(object) * (1 << 32)) % p).astype(np.uint64).astype(np.uint32)


class NttTables:
    """Per-ring twiddle tables: host numpy ``uint32`` arrays equal to the
    reference's, uploaded to a device once by :meth:`on`.

    Identity-hashed: build once per ring and reuse.
    """

    def __init__(self, n: int, primes: Sequence[int], psis: Optional[Sequence[int]] = None):
        from ..utils import numtheory as nt

        if n < 2 or n & (n - 1):
            raise ValueError(f"power-of-two rings only, got N={n}")
        self.n = n
        self.primes = [int(p) for p in primes]
        self.mp = MontParams.make(self.primes)
        if psis is None:
            psis = [nt.minimal_primitive_root_of_unity(p, 2 * n) for p in self.primes]
        self.psis = [int(x) for x in psis]
        L = len(self.primes)
        self.bitrev = _bitrev_perm(n)

        # ψ^i premultiply / n^{-1}ψ^{-i} postmultiply tables, Montgomery form.
        psi_pow = np.zeros((L, n), dtype=np.uint32)
        psi_ipow = np.zeros((L, n), dtype=np.uint32)
        for l, (p, psi) in enumerate(zip(self.primes, self.psis)):
            ipsi = pow(psi, -1, p)
            ninv = pow(n, -1, p)
            pows = np.ones(n, dtype=object)
            ipows = np.ones(n, dtype=object)
            for i in range(1, n):
                pows[i] = pows[i - 1] * psi % p
                ipows[i] = ipows[i - 1] * ipsi % p
            psi_pow[l] = _to_mont_np(pows, p)
            psi_ipow[l] = _to_mont_np((ipows * ninv) % p, p)
        self.psi_pow = psi_pow
        self.psi_ipow = psi_ipow

        # Per-stage DFT twiddles ω^{j·N/len}, Montgomery form, shape (L,1,half).
        self.stage_tw: List[np.ndarray] = []
        self.stage_tw_inv: List[np.ndarray] = []
        ln = 2
        while ln <= n:
            half = ln // 2
            tw = np.zeros((L, 1, half), dtype=np.uint32)
            twi = np.zeros((L, 1, half), dtype=np.uint32)
            for l, (p, psi) in enumerate(zip(self.primes, self.psis)):
                omega = psi * psi % p
                w = pow(omega, n // ln, p)
                wi = pow(w, -1, p)
                ws = np.ones(half, dtype=object)
                wis = np.ones(half, dtype=object)
                for j in range(1, half):
                    ws[j] = ws[j - 1] * w % p
                    wis[j] = wis[j - 1] * wi % p
                tw[l, 0] = _to_mont_np(ws, p)
                twi[l, 0] = _to_mont_np(wis, p)
            self.stage_tw.append(tw)
            self.stage_tw_inv.append(twi)
            ln *= 2
        self._dev: dict = {}

    def select(self, rows: Sequence[int]) -> "NttTables":
        """The tables of the sub-tower made of ``rows`` (indices may repeat),
        sliced from these instead of recomputed: every table row depends
        only on its own prime and root."""
        idx = [int(r) for r in rows]
        sub = NttTables.__new__(NttTables)
        sub.n = self.n
        sub.primes = [self.primes[i] for i in idx]
        sub.mp = self.mp.select(idx)
        sub.psis = [self.psis[i] for i in idx]
        sub.bitrev = self.bitrev
        sub.psi_pow = self.psi_pow[idx]
        sub.psi_ipow = self.psi_ipow[idx]
        sub.stage_tw = [tw[idx] for tw in self.stage_tw]
        sub.stage_tw_inv = [tw[idx] for tw in self.stage_tw_inv]
        sub._dev = {}
        return sub

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def cached(self, key, build):
        """Memoize ``build()`` on this table object under ``key``."""
        if key not in self._dev:
            self._dev[key] = build()
        return self._dev[key]

    def on(self, device) -> dict:
        """The tables as ``int64`` tensors on ``device``, uploaded once:
        ``p``/``rinv`` ``[L, 1]``, ``psi_pow``/``psi_ipow`` ``[L, N]``,
        ``tw``/``twi`` tuples of ``[L, 1, half]`` per stage, ``bitrev``."""
        dev = canonical_device(device)

        def build():
            t = lambda a: as_residues(a, dev)
            mp = self.mp.on(dev)
            return {
                "p": mp.p, "rinv": mp.rinv,
                "psi_pow": t(self.psi_pow), "psi_ipow": t(self.psi_ipow),
                "tw": tuple(t(a) for a in self.stage_tw),
                "twi": tuple(t(a) for a in self.stage_tw_inv),
                "bitrev": t(self.bitrev),
            }

        return self.cached(("plain", dev), build)


def _dft_stages(x, tw_list, p, rinv, bitrev):
    """Radix-2 DIT stages: bit-reversed input → natural-order DFT output,
    every butterfly fully reduced to [0, p)."""
    n = x.shape[-1]
    lead = x.shape[:-1]           # (..., L)
    p3, rinv3 = p[..., None], rinv[..., None]
    x = x.index_select(-1, bitrev)
    ln = 2
    for s in range(n.bit_length() - 1):
        half = ln // 2
        xs = x.reshape(lead + (n // ln, ln))
        u = xs[..., :half]
        t = mont_mul_raw(xs[..., half:], tw_list[s], p3, rinv3)
        x = torch.remainder(torch.cat([u + t, u - t], dim=-1), p3)
        x = x.reshape(lead + (n,))
        ln *= 2
    return x


def ntt_plain(tables: NttTables, x: torch.Tensor) -> torch.Tensor:
    """Forward negacyclic NTT of int64[..., L, N], plain torch on any device
    (the kernel's twin and the CPU path)."""
    d = tables.on(x.device)
    x = mont_mul_raw(x, d["psi_pow"], d["p"], d["rinv"])
    return _dft_stages(x, d["tw"], d["p"], d["rinv"], d["bitrev"])


def intt_plain(tables: NttTables, x: torch.Tensor) -> torch.Tensor:
    """Inverse negacyclic NTT, plain torch on any device."""
    d = tables.on(x.device)
    x = _dft_stages(x, d["twi"], d["p"], d["rinv"], d["bitrev"])
    return mont_mul_raw(x, d["psi_ipow"], d["p"], d["rinv"])


def _dispatch(tables: NttTables, x: torch.Tensor, inverse: bool):
    if x.numel() == 0:              # a rank of a sharded tower holding none of its rows
        return torch.empty_like(x)
    if x.device.type == "cuda":
        from . import ntt_cuda
        return ntt_cuda.launch(tables, x.contiguous(), inverse)
    if x.device.type != "cpu":
        raise ValueError(f"no NTT for tensors on {x.device}")
    return intt_plain(tables, x) if inverse else ntt_plain(tables, x)


def ntt(tables: NttTables, x: torch.Tensor) -> torch.Tensor:
    """Forward negacyclic NTT of int64[..., L, N] (reference ``nntt``)."""
    return _dispatch(tables, x, False)


def intt(tables: NttTables, x: torch.Tensor) -> torch.Tensor:
    """Inverse negacyclic NTT (reference ``inntt``)."""
    return _dispatch(tables, x, True)


# ---------------------------------------------------------------------------
# Galois automorphisms x(X) ↦ x(X^g)
# ---------------------------------------------------------------------------

def galois_perm_tables(n: int, galois_element: int):
    """Gather indices + sign mask for x(X) ↦ x(X^g) on primal coefficients:
    coefficient i moves to (g·i mod N), negated when ⌊g·i/N⌋ is odd.
    Returned in gather form, ``out[j] = ±x[src[j]]`` (host numpy)."""
    g = int(galois_element)
    i = np.arange(n, dtype=np.int64)
    dest = (g * i) % n
    sign = ((g * i) // n) % 2
    src = np.zeros(n, dtype=np.int64)
    neg = np.zeros(n, dtype=bool)
    src[dest] = i
    neg[dest] = sign.astype(bool)
    return src, neg


def apply_galois(mp: MontParams, x: torch.Tensor, src, neg) -> torch.Tensor:
    """Apply a precomputed Galois permutation to int64[..., L, N] primal
    residues (``src`` / ``neg`` as host arrays, kept on the device by
    :func:`.modmath.const`, or tensors)."""
    if not torch.is_tensor(src):
        src, neg = const(src, x.device), const(neg, x.device, torch.bool)
    y = x.index_select(-1, src)
    return torch.where(neg, torch.remainder(-y, mp.on(x.device).p), y)


def galois_dual_perm(n: int, galois_element: int) -> np.ndarray:
    """x(X) ↦ x(X^g) as a dual-domain gather (no sign flips): the natural
    dual holds evaluations at ψ^{2k+1}, so ``out[k] = in[(((2k+1)·g mod
    2N) − 1)/2]``."""
    g = int(galois_element)
    k = np.arange(n, dtype=np.int64)
    return (((2 * k + 1) * g) % (2 * n) - 1) // 2


_DUAL_PERMS: dict = {}


def galois_dual_perm_dev(n: int, galois_element: int, device) -> torch.Tensor:
    """:func:`galois_dual_perm` as an int64 index tensor on ``device``,
    cached per (n, element, device): the hoisted rotation schedules gather
    with the same few permutations on every call."""
    key = (n, int(galois_element), canonical_device(device))
    if key not in _DUAL_PERMS:
        _DUAL_PERMS[key] = as_residues(galois_dual_perm(n, galois_element), key[2])
    return _DUAL_PERMS[key]


def naive_negacyclic_mul(a: np.ndarray, b: np.ndarray, p: int) -> np.ndarray:
    """O(n²) schoolbook negacyclic convolution over Python ints: the
    independent oracle of the transforms and of the fused product at
    small N."""
    n = len(a)
    out = [0] * n
    for i in range(n):
        ai = int(a[i])
        for j in range(n):
            k = i + j
            t = ai * int(b[j])
            if k < n:
                out[k] = (out[k] + t) % p
            else:
                out[k - n] = (out[k - n] - t) % p
    return np.array(out, dtype=np.int64)
