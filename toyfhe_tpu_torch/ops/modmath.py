"""Vectorized modular arithmetic on residue tensors — the scalar layer (L0).

Port of ``toyfhe_tpu/ops/modmath.py``. Residues are ``torch.int64`` tensors
holding values in [0, p) for limb primes p < 2^31, so the product of two
residues fits a native 64-bit integer and every op is its integer formula
followed by one exact floor reduction mod p. (The reference holds
``uint32`` and assembles REDC from 16-bit partial products because the TPU
VPU has no 32×32→64 multiply.) Each op returns the canonical residue, the
same value the reference returns, bit for bit.

All functions broadcast: coefficient tensors are shaped ``[..., L, N]`` and
per-limb constants ``[L, 1]``, so one call handles a whole RNS tower.
Montgomery form with R = 2^32 is kept for every precomputed constant
(twiddles, key-switch and rescale factors): :func:`mont_mul` by such a
constant is the plain product, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch


def canonical_device(device) -> torch.device:
    """``torch.device`` with the CUDA index filled in, so that "cuda" and
    "cuda:0" name one cache entry."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True)
class MontParams:
    """Per-limb Montgomery constants shaped ``[L, 1]``.

    :meth:`make` builds the host form (numpy ``uint32``; the first five
    fields equal the reference's arrays); :meth:`on` gives the same
    constants as ``int64`` tensors on a device, uploaded once per device.
    Every op below accepts either form and uses the constants on its
    operand's device.
    """

    p: Any          # the limb primes
    ninv: Any       # -p^{-1} mod 2^32 (the CUDA kernel's REDC constant)
    r2: Any         # R^2 mod p  (R = 2^32), in ordinary form
    r1: Any         # R mod p == to_mont(1)
    half: Any       # p // 2, for centered lifts
    rinv: Any       # R^{-1} mod p: mont_mul(a, b) = a·b·rinv mod p
    _dev: dict = dataclasses.field(default_factory=dict, compare=False,
                                   repr=False)

    @staticmethod
    def make(primes: Sequence[int]) -> "MontParams":
        ps = [int(p) for p in primes]
        for p in ps:
            if not (1 < p < (1 << 31)):
                raise ValueError(f"limb prime {p} out of range (need < 2^31)")
        col = lambda xs: np.asarray(xs, dtype=np.uint64).astype(np.uint32).reshape(-1, 1)
        R = 1 << 32
        return MontParams(
            p=col(ps),
            ninv=col([(-pow(p, -1, R)) % R for p in ps]),
            r2=col([R * R % p for p in ps]),
            r1=col([R % p for p in ps]),
            half=col([p // 2 for p in ps]),
            rinv=col([pow(R, -1, p) for p in ps]),
        )

    @property
    def nlimbs(self) -> int:
        return self.p.shape[0]

    def on(self, device) -> "MontParams":
        """The constants as ``int64`` tensors on ``device`` (cached)."""
        dev = canonical_device(device)
        if torch.is_tensor(self.p):
            if self.p.device == dev:
                return self
            raise ValueError("device constants move only from the host form")
        if dev not in self._dev:
            t = lambda a: const(a, dev)
            self._dev[dev] = MontParams(t(self.p), t(self.ninv), t(self.r2),
                                        t(self.r1), t(self.half), t(self.rinv))
        return self._dev[dev]

    def select(self, which) -> "MontParams":
        """Sub-tower restricted to the given limb indices (crtselect)."""
        idx = list(which)
        return MontParams(self.p[idx], self.ninv[idx], self.r2[idx],
                          self.r1[idx], self.half[idx], self.rinv[idx])

    def expand(self) -> "MontParams":
        """Constants reshaped ``[L, 1]`` → ``[L, 1, 1]`` to broadcast over
        one more trailing axis (the cross-base contractions of the hybrid
        gadget), in whichever form (host or device) they are held."""
        f = lambda a: a[:, :, None]
        return MontParams(f(self.p), f(self.ninv), f(self.r2), f(self.r1),
                          f(self.half), f(self.rinv))


def as_residues(a, device, dtype=torch.int64) -> torch.Tensor:
    """Host integer array (e.g. a ``uint32`` constant column) → ``int64``
    (or ``dtype``) tensor on ``device``: an upload, made anew at every call
    (:func:`const` keeps what it uploads)."""
    return torch.as_tensor(np.asarray(a, dtype=_NP_TYPES[dtype]), device=device)


_NP_TYPES = {torch.int64: np.int64, torch.int32: np.int32, torch.bool: np.bool_,
             torch.float32: np.float32}
_CONSTS: dict = {}


def const(a, device, dtype=torch.int64) -> torch.Tensor:
    """A host constant fixed by a ring or a plan (a table, a CRT column, an
    index list; never a value that comes with the data) as a tensor on
    ``device``, uploaded once per content, dtype and device and kept for the
    life of the process: a repeated call builds nothing from host data, so
    the code around it can be captured into a CUDA graph
    (:mod:`..utils.graphs`), whose replays read the kept tensor at its fixed
    address. Callers never write to the result. A miss inside a capture
    raises: the upload cannot be captured."""
    arr = np.ascontiguousarray(np.asarray(a, dtype=_NP_TYPES[dtype]))
    dev = canonical_device(device)
    key = (dev, arr.dtype.str, arr.shape, arr.tobytes())
    hit = _CONSTS.get(key)
    if hit is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"constant {arr.shape} not on {dev} before the capture: "
                               "run the function eagerly once first")
        hit = _CONSTS[key] = as_residues(arr, dev, dtype)
    return hit


def _dev(mp: MontParams, x: torch.Tensor) -> MontParams:
    return mp.on(x.device)


def mont_mul_raw(a, b, p, rinv):
    """a·b·R^{-1} mod p with the constants given as tensors — the value
    REDC(a·b) takes for inputs in [0, p)."""
    return torch.remainder(torch.remainder(a * b, p) * rinv, p)


def mont_mul(a, b, mp: MontParams):
    """Montgomery product a*b*R^{-1} mod p, inputs in [0, p).

    If ``b`` is stored in Montgomery form (b*R mod p) the result is the
    plain product a*b mod p — the convention used for all precomputed
    twiddles and scalars.
    """
    mp = _dev(mp, a)
    return mont_mul_raw(a, b, mp.p, mp.rinv)


def to_mont(a, mp: MontParams):
    mp = _dev(mp, a)
    return torch.remainder(a * mp.r1, mp.p)


def from_mont(a, mp: MontParams):
    """Montgomery form -> ordinary form (multiply by R^{-1})."""
    mp = _dev(mp, a)
    return torch.remainder(a * mp.rinv, mp.p)


def mul_mod(a, b, mp: MontParams):
    """Plain modular product of two ordinary-form tensors."""
    return torch.remainder(a * b, _dev(mp, a).p)


def add_mod(a, b, mp: MontParams):
    return torch.remainder(a + b, _dev(mp, a).p)


def sub_mod(a, b, mp: MontParams):
    return torch.remainder(a - b, _dev(mp, a).p)


def neg_mod(a, mp: MontParams):
    return torch.remainder(-a, _dev(mp, a).p)


def centered(a, mp: MontParams):
    """Centered representative in (-p/2, p/2] (SignedMod lift): values
    strictly above p // 2 map down by p."""
    mp = _dev(mp, a)
    return torch.where(a > mp.half, a - mp.p, a)


def from_signed(x, mp: MontParams):
    """Reduce signed values into [0, p) residues (floor semantics)."""
    return torch.remainder(x, _dev(mp, x).p)


def mod_sum(terms, mp: MontParams, axis: int):
    """Modular sum along ``axis`` (p broadcastable to the result).

    The reference tree-reduces with modular adds to stay inside uint32; the
    sum of canonical residues mod p is the same value in any order, and int64
    holds the plain sum of up to 2^32 residues."""
    return torch.remainder(terms.sum(dim=axis), _dev(mp, terms).p)


def umod(x, q):
    """x mod q against a broadcastable modulus tensor or int."""
    return torch.remainder(x, q)
