"""The forward four-step NTT as one fused kernel, K2.

Port of ``toyfhe_tpu/ops/ntt_mxu_pallas.py::ntt_mxu_pallas``: the ψ-twist,
the two modular matrix products from int8 digit matrices, the twiddle
multiply between them and the digit recombination in one pass per
(limb, row), with nothing but the input and the output in device memory.

Layout contract (per limb): input ``x`` is the coefficient block reshaped
to (rows, 128, n2), ``psis`` the ψ-twist table in the same layout; the
output is Ĉ[row, k1, k2] — the caller transposes (k1, k2) → natural order.
Only n1 = 128 is taken.

``paired`` selects the recombination of the 7 digit diagonals: the
7-term form (7 products per element) or the paired-diagonal form (adjacent
diagonals folded into int32, 2 products and 2 shift-adds), which is valid
when ``mt.paired_ok`` and is the default then. Both give the canonical
residue, so they agree bit for bit.

:func:`ntt_mxu_pallas` dispatches on the tensor's device: a CUDA tensor
goes to the hand-written kernel (:mod:`.ntt_mxu_pallas_cuda`,
``csrc/ntt_mxu.cu``), which raises rather than fall back; a CPU tensor goes
to :func:`ntt_mxu_pallas_plain`, its plain twin.
"""

from __future__ import annotations

import torch

from .modmath import as_residues, mont_mul_raw
from .ntt_mxu import (N1, _NDIG, _OFF, _balanced_digits_device, accumulate64,
                      device_tables, digit_dot, reduce64)


def _combine(groups, d: dict):
    """Σ_s 2^{8s}·G_s mod p: offset each diagonal by 2^23, accumulate the 7
    products in 64 bits, two REDCs, subtract the offsets' sum."""
    hi, lo = accumulate64((groups[s] + _OFF, d["cs"][s][:, None])
                          for s in range(2 * _NDIG - 1))
    return _finish(hi, lo, d["corr"], d)


def _combine_paired(groups, d: dict):
    """Paired-diagonal recombination: G'ₜ = G₂ₜ + 256·G₂ₜ₊₁ with weights
    2^{16t}, each offset by 2^31; t = 0, 1 are exact shifts, t = 2, 3 take
    the reduced constants 2^32 and 2^48 mod p."""
    gp = [groups[0] + (groups[1] << 8), groups[2] + (groups[3] << 8),
          groups[4] + (groups[5] << 8), groups[6]]
    hp = [g + (1 << 31) for g in gp]
    one = torch.ones_like(d["cs32"])[:, None]
    hi, lo = accumulate64([(hp[0], one), (hp[1], one << 16),
                           (hp[2], d["cs32"][:, None]), (hp[3], d["cs48"][:, None])])
    return _finish(hi, lo, d["corr2"], d)


def _finish(hi, lo, corr, d: dict):
    mp3 = d["mp3"]
    col = lambda a: a[:, None]                       # [L, 1, 1] → [L, 1, 1, 1]
    return reduce64(hi, lo, col(d["r1_mont"]), col(d["hi_mont"]), col(corr),
                    col(mp3.p), col(mp3.rinv))


def _resolve_paired(mt, paired) -> bool:
    if paired is None:
        return bool(mt.paired_ok)
    if paired and not mt.paired_ok:
        raise ValueError("these digit matrices exceed the int32 bound of the "
                         "paired recombination (mt.paired_ok is False)")
    return bool(paired)


def _check_x(mt, x: torch.Tensor, psis: torch.Tensor) -> None:
    if getattr(mt, "n1", N1) != N1:
        raise ValueError(f"the layout kernel assumes n1 = {N1}, got {mt.n1}")
    L = len(mt.primes)
    if x.dim() != 4 or x.shape[0] != L or tuple(x.shape[2:]) != (N1, mt.n2):
        raise ValueError(f"expected [{L}, R, {N1}, {mt.n2}], got {tuple(x.shape)}")
    if tuple(psis.shape) != (L, N1, mt.n2):
        raise ValueError(f"expected psis [{L}, {N1}, {mt.n2}], got {tuple(psis.shape)}")
    if x.dtype != torch.int64 or psis.dtype != torch.int64:
        raise TypeError(f"residues must be int64, got {x.dtype} and {psis.dtype}")


def ntt_mxu_pallas_plain(mt, x: torch.Tensor, psis: torch.Tensor,
                         paired: bool = None) -> torch.Tensor:
    """K2's plain twin, on any device: the kernel's arithmetic in exact
    int64 torch ops — digits, the 16 digit dots per stage summed into 7
    diagonals, and the chosen recombination. Output in (k1, k2) order."""
    paired = _resolve_paired(mt, paired)
    _check_x(mt, x, psis)
    d = device_tables(mt, x.device)
    mp3 = d["mp3"]
    p, rinv = mp3.p[:, None], mp3.rinv[:, None]
    comb = _combine_paired if paired else _combine

    def groups_of(spec, wd, xd):
        groups = [None] * (2 * _NDIG - 1)
        for a in range(_NDIG):
            for e in range(_NDIG):
                P = digit_dot(spec, wd[:, a], xd[e])
                groups[a + e] = P if groups[a + e] is None else groups[a + e] + P
        return groups

    xt = mont_mul_raw(x, psis[:, None], p, rinv)             # ψ-twist [L, R, j1, j2]
    # stage 1: A[k1, j2] = Σ_{j1} W1[j1, k1]·X[j1, j2]
    a = comb(groups_of("lkj,lrkc->lrjc", d["w1"], _balanced_digits_device(xt)), d)
    b = mont_mul_raw(a, d["tw"][:, None], p, rinv)           # ⊙ ω^{k1·j2}
    # stage 2: C[k1, k2] = Σ_{j2} B[k1, j2]·W2[j2, k2]
    return comb(groups_of("lkj,lrck->lrcj", d["w2"], _balanced_digits_device(b)), d)


def ntt_mxu_pallas(mt, x: torch.Tensor, psis: torch.Tensor,
                   paired: bool = None) -> torch.Tensor:
    """Forward four-step NTT (K2). ``x``: int64 [L, R, 128, n2]; ``psis``:
    int64 [L, 128, n2], the ψ-twist table in the same layout. Returns
    Ĉ[L, R, k1, k2]; the natural dual is ``swapaxes(-1, -2).reshape(N)``.
    ``paired=None`` takes the paired recombination whenever
    ``mt.paired_ok``."""
    paired = _resolve_paired(mt, paired)
    if x.device.type == "cuda":
        from . import ntt_mxu_pallas_cuda
        return ntt_mxu_pallas_cuda.launch(mt, x.contiguous(), psis.contiguous(), paired)
    if x.device.type != "cpu":
        raise ValueError(f"no four-step NTT for tensors on {x.device}")
    return ntt_mxu_pallas_plain(mt, x, psis, paired)


def psi_table(mt, device) -> torch.Tensor:
    """``mt.psi_pow`` as int64 [L, 128, n2] on ``device``, uploaded once."""
    return mt.cached(("psis", torch.device(device)), lambda: as_residues(
        mt.psi_pow.reshape(len(mt.primes), N1, mt.n2), device))


def ntt_mxu_pallas_natural(mt, x: torch.Tensor) -> torch.Tensor:
    """Convenience wrapper: natural-order int64 [L, R, N] in and out."""
    L, R, n = x.shape
    c = ntt_mxu_pallas(mt, x.reshape(L, R, N1, mt.n2), psi_table(mt, x.device))
    return c.transpose(-1, -2).reshape(L, R, n)
