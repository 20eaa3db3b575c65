"""The DIF / DIT formulation of the negacyclic NTT: the bit-reversed
forward transform K5 and the fused polynomial product K4.

Port of ``toyfhe_tpu/ops/ntt_pallas.py``:

  * forward = ψ-twist + Gentleman–Sande DIF stages (natural input →
    bit-reversed output);
  * inverse = Cooley–Tukey DIT stages with inverse twiddles (bit-reversed
    input → natural output) + N⁻¹ψ⁻ⁱ untwist;
  * pointwise products between the two happen in bit-reversed order, so no
    bit-reversal permutation is ever applied.

:class:`PallasNttTables` holds the reference's full-length per-stage
twiddles as host numpy; :func:`dif_stages_plain` / :func:`dit_stages_plain`
are plain torch twins of the reference's ``_dif_stages`` / ``_dit_stages``
(its lane rolls and mask-select become a reshape into butterfly pairs).

:func:`ntt_pallas_bitrev` (K5) dispatches on the tensor's device: a CUDA
tensor goes to the hand-written kernel (:mod:`.ntt_pallas_cuda`,
``csrc/ntt_bitrev.cu``), which raises rather than fall back; a CPU tensor
goes to :func:`ntt_bitrev_plain`. :func:`ntt_bitrev_rows` is the same
transform of a row-major [..., L, N] batch, as the windowed key switch holds
it. :func:`polymul_pallas` /
:func:`polymul_pallas_raw` (K4, ``csrc/polymul.cu``) dispatch the same way,
with :func:`polymul_plain` as the twin. All return canonical residues and
agree bit for bit. The reference's ``rows_per_block`` is a TPU tiling
argument and has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from .modmath import as_residues, canonical_device, mont_mul_raw
from .ntt import NttTables


class PallasNttTables:
    """Per-limb full-length stage twiddles for the DIF/DIT formulation.

    fwd[l, s, i]: DIF stage s (len = N >> s): ω^{(i mod len − half)·N/len}
                  on second halves, 1 on first halves.
    inv[l, s, i]: DIT stage s (len = 2 << s): ω^{−(i mod half)·N/len} on
                  both halves.
    All Montgomery form, ``uint32 (L, logN, N)``, equal to the reference's
    arrays. They are tiled from the ring's radix-2 stage tables, which hold
    the same powers. ``tables`` keeps the :class:`NttTables` they came from
    (the CUDA kernel reads its packed form).
    """

    def __init__(self, tables: NttTables):
        n = tables.n
        logn = n.bit_length() - 1
        L = len(tables.primes)
        self.tables = tables
        self.n, self.logn, self.L = n, logn, L
        self.primes = tables.primes
        one = np.broadcast_to(tables.mp.r1, (L, n))          # to_mont(1)
        fwd = np.zeros((L, logn, n), dtype=np.uint32)
        inv = np.zeros((L, logn, n), dtype=np.uint32)
        for s in range(logn):
            half = (n >> s) // 2
            # stage_tw[k] holds ω^{j·N/len} for len = 2^{k+1}, j < len/2
            tw = tables.stage_tw[logn - 1 - s][:, 0, :]                  # (L, half)
            block = np.concatenate([one[:, :half], tw], axis=1)         # (L, len)
            fwd[:, s] = np.tile(block, (1, n // (2 * half)))
            twi = tables.stage_tw_inv[s][:, 0, :]                        # (L, 1 << s)
            inv[:, s] = np.tile(twi, (1, n // twi.shape[1]))
        self.fwd = fwd
        self.inv = inv
        self.psi_pow = tables.psi_pow[:, None, :]
        self.psi_ipow = tables.psi_ipow[:, None, :]
        self.p = tables.mp.p.reshape(-1).astype(np.uint32)          # (L,)
        self.ninv = tables.mp.ninv.reshape(-1).astype(np.uint32)
        self.r2 = tables.mp.r2.reshape(-1).astype(np.uint32)
        self._dev: dict = {}

    def on(self, device) -> dict:
        """The tables as ``int64`` tensors on ``device``, uploaded once:
        ``fwd`` / ``inv`` ``(L, logN, N)``, ``psi_pow`` / ``psi_ipow``
        ``(L, 1, N)``, and ``p`` / ``rinv`` / ``r2`` ``(L, 1, 1)``."""
        dev = canonical_device(device)
        if dev not in self._dev:
            mp = self.tables.mp
            col = lambda a: as_residues(np.asarray(a).reshape(-1, 1, 1), dev)
            self._dev[dev] = {
                "fwd": as_residues(self.fwd, dev), "inv": as_residues(self.inv, dev),
                "psi_pow": as_residues(self.psi_pow, dev),
                "psi_ipow": as_residues(self.psi_ipow, dev),
                "p": col(mp.p), "rinv": col(mp.rinv), "r2": col(mp.r2),
            }
        return self._dev[dev]


def _pairs(x: torch.Tensor, half: int):
    """View [..., N] as butterfly pairs [..., N/(2·half), 2, half]."""
    return x.reshape(x.shape[:-1] + (x.shape[-1] // (2 * half), 2, half))


def dif_stages_plain(x: torch.Tensor, fwd: torch.Tensor, p, rinv) -> torch.Tensor:
    """Gentleman–Sande stages over int64 [L, R, N] (natural → bit-reversed):
    a' = a + b, b' = (a − b)·w. ``fwd`` is ``(L, logN, N)``; ``p`` / ``rinv``
    broadcast as ``(L, 1, 1)``."""
    n = x.shape[-1]
    for s in range(n.bit_length() - 1):
        half = (n >> s) // 2
        xs = _pairs(x, half)
        u, v = xs[..., 0, :], xs[..., 1, :]
        w = _pairs(fwd[:, s][:, None, :], half)[..., 1, :]
        top = torch.remainder(u + v, p[..., None])
        bot = mont_mul_raw(torch.remainder(u - v, p[..., None]), w, p[..., None],
                           rinv[..., None])
        x = torch.stack([top, bot], dim=-2).reshape(x.shape)
    return x


def dit_stages_plain(x: torch.Tensor, inv: torch.Tensor, p, rinv) -> torch.Tensor:
    """Cooley–Tukey stages with inverse twiddles over int64 [L, R, N]
    (bit-reversed → natural): a' = a + w·b, b' = a − w·b."""
    n = x.shape[-1]
    for s in range(n.bit_length() - 1):
        half = 1 << s
        xs = _pairs(x, half)
        u, v = xs[..., 0, :], xs[..., 1, :]
        w = _pairs(inv[:, s][:, None, :], half)[..., 1, :]
        wv = mont_mul_raw(v, w, p[..., None], rinv[..., None])
        x = torch.remainder(torch.stack([u + wv, u - wv], dim=-2),
                            p[..., None, None]).reshape(x.shape)
    return x


def _check_lrn(pt: PallasNttTables, a: torch.Tensor) -> None:
    if a.dim() != 3 or a.shape[0] != pt.L or a.shape[-1] != pt.n:
        raise ValueError(f"expected [{pt.L}, R, {pt.n}], got {tuple(a.shape)}")
    if a.dtype != torch.int64:
        raise TypeError(f"residues must be int64, got {a.dtype}")


def ntt_bitrev_plain(pt: PallasNttTables, a: torch.Tensor) -> torch.Tensor:
    """K5's plain twin: forward negacyclic NTT of int64 [L, R, N] (limb
    axis first), output in bit-reversed order, on any device."""
    _check_lrn(pt, a)
    d = pt.on(a.device)
    x = mont_mul_raw(a, d["psi_pow"], d["p"], d["rinv"])
    return dif_stages_plain(x, d["fwd"], d["p"], d["rinv"])


def ntt_pallas_bitrev(pt: PallasNttTables, a: torch.Tensor) -> torch.Tensor:
    """Forward negacyclic NTT of int64 [L, R, N], bit-reversed output (K5):
    the CUDA kernel for a CUDA tensor, the plain twin for a CPU tensor."""
    if a.device.type == "cuda":
        from . import ntt_pallas_cuda
        return ntt_pallas_cuda.launch(pt, a.contiguous())
    if a.device.type != "cpu":
        raise ValueError(f"no bit-reversed NTT for tensors on {a.device}")
    return ntt_bitrev_plain(pt, a)


def ntt_bitrev_rows(pt: PallasNttTables, x: torch.Tensor) -> torch.Tensor:
    """:func:`ntt_pallas_bitrev` of a row-major int64 [..., L, N] tensor,
    result in the same layout: the CUDA kernel transforms each polynomial
    where it lies, with no limb-major copy on the way in or out; a CPU tensor
    goes through the plain twin."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no bit-reversed NTT for tensors on {x.device}")
    rows = x.reshape((-1,) + x.shape[-2:])
    if x.device.type == "cuda":
        from . import ntt_pallas_cuda
        out = ntt_pallas_cuda.launch(pt, rows.contiguous(), row_major=True)
    else:
        out = ntt_bitrev_plain(pt, rows.transpose(0, 1)).transpose(0, 1)
    return out.reshape(x.shape)


def polymul_plain(pt: PallasNttTables, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K4's plain twin: the negacyclic product of primal int64 [L, R, N]
    operands, on any device — ψ-twist and DIF of both, the pointwise
    ``mont(mont(da, R²), db)`` in bit-reversed order, DIT, and the N⁻¹ψ⁻ⁱ
    untwist."""
    _check_lrn(pt, a)
    _check_lrn(pt, b)
    if a.shape != b.shape:
        raise ValueError(f"operand shapes differ: {tuple(a.shape)} and {tuple(b.shape)}")
    d = pt.on(a.device)
    p, rinv = d["p"], d["rinv"]
    fwd = lambda x: dif_stages_plain(mont_mul_raw(x, d["psi_pow"], p, rinv), d["fwd"], p, rinv)
    da, db = fwd(a), fwd(b)
    prod = mont_mul_raw(mont_mul_raw(da, d["r2"], p, rinv), db, p, rinv)
    x = dit_stages_plain(prod, d["inv"], p, rinv)
    return mont_mul_raw(x, d["psi_ipow"], p, rinv)


def polymul_pallas_raw(pt: PallasNttTables, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fused negacyclic product of primal int64 [L, R, N] operands (K4),
    equal to ``intt(mul_mod(ntt(a), ntt(b)))`` per limb: the CUDA kernel for
    CUDA tensors, the plain twin for CPU tensors."""
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device} and {b.device}")
    if a.device.type == "cuda":
        from . import ntt_pallas_cuda
        return ntt_pallas_cuda.launch_polymul(pt, a.contiguous(), b.contiguous())
    if a.device.type != "cpu":
        raise ValueError(f"no fused product for tensors on {a.device}")
    return polymul_plain(pt, a, b)


polymul_pallas = polymul_pallas_raw   # the reference's jitted form of the same call
