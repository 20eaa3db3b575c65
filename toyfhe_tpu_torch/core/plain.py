"""Plaintext spaces and the BFV/BGV encodings.

Port of ``toyfhe_tpu/core/plain.py``: the plaintext ring ℤp[x]/(x^N+1),
``ScalarEncoding``, the full coefficient vector and the NTT-based
``SlotEncoding`` (ToyFHE.jl ``src/encoding.jl``).

Plaintext polynomials are small host numpy arrays mod p. The slot transform
is a one-limb negacyclic NTT over 𝔽p through :mod:`..ops.ntt`, so it runs
where the caller says: the CUDA kernel on a CUDA device, the plain twin on
the CPU. The ring's tables are host data, uploaded once per device by the
NTT layer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops import ntt as nttmod
from ..utils import numtheory as nt


class PlainRing:
    """ℤp[x]/(x^N+1) plaintext ring.

    If p is prime and 2N | p−1, the ring supports N SIMD slots through its
    own negacyclic NTT.
    """

    def __init__(self, n: int, p: int):
        self.n = int(n)
        self.p = int(p)
        self.is_prime = nt.is_prime(self.p)
        self.has_slots = self.is_prime and (self.p - 1) % (2 * self.n) == 0 and self.p < (1 << 31)
        self._tables: Optional[nttmod.NttTables] = None

    @property
    def tables(self) -> nttmod.NttTables:
        if not self.has_slots:
            raise ValueError(f"p={self.p} does not support slot packing (need prime ≡ 1 mod 2N)")
        if self._tables is None:
            self._tables = nttmod.NttTables(self.n, [self.p])
        return self._tables

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def zero(self) -> "PlainPoly":
        return PlainPoly(self, np.zeros(self.n, dtype=np.int64))


@dataclasses.dataclass
class PlainPoly:
    """Plaintext polynomial: coefficients in [0, p), ``int64[..., N]`` (a
    leading axis holds several plaintexts)."""

    ring: PlainRing
    coeffs: np.ndarray

    def __post_init__(self):
        self.coeffs = np.mod(np.asarray(self.coeffs, dtype=np.int64), self.ring.p)

    def __getitem__(self, i):
        return int(self.coeffs[i])

    def __setitem__(self, i, v):
        self.coeffs[i] = int(v) % self.ring.p

    def centered(self) -> np.ndarray:
        c = self.coeffs.copy()
        c[c > self.ring.p // 2] -= self.ring.p
        return c

    def mul(self, other: "PlainPoly") -> "PlainPoly":
        """Host negacyclic product — the test oracle."""
        out = nttmod.naive_negacyclic_mul(self.coeffs, other.coeffs, self.ring.p)
        return PlainPoly(self.ring, out.astype(np.int64))


def scalar_encode(pring: PlainRing, value: int) -> PlainPoly:
    """ScalarEncoding: value in coefficient 0."""
    z = pring.zero()
    z[0] = value
    return z


def scalar_decode(plain: PlainPoly) -> int:
    return plain[0]


def coeff_encode(pring: PlainRing, coeffs) -> PlainPoly:
    """The full coefficient vector as the plaintext."""
    return PlainPoly(pring, np.asarray(coeffs, dtype=np.int64))


def _slot_transform(pring: PlainRing, vals: np.ndarray, inverse: bool, device) -> np.ndarray:
    x = torch.as_tensor(np.mod(np.asarray(vals, dtype=np.int64), pring.p)[..., None, :],
                        device=device)
    y = (nttmod.intt if inverse else nttmod.ntt)(pring.tables, x)
    return y[..., 0, :].cpu().numpy()


def slot_encode(pring: PlainRing, slots, *, device) -> PlainPoly:
    """SlotEncoding: the slot values are the dual (NTT-domain) coefficients
    of the plaintext polynomial, so encode is the inverse NTT over 𝔽p, run
    on ``device``. ``slots`` is ``[..., N]``."""
    return PlainPoly(pring, _slot_transform(pring, slots, True, device))


def slot_decode(plain: PlainPoly, *, device) -> np.ndarray:
    """Slot view of a plaintext: the forward NTT over 𝔽p, run on ``device``."""
    return _slot_transform(plain.ring, plain.coeffs, False, device)
