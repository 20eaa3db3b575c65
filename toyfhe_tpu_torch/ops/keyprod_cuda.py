"""The key products of the hybrid key switch, and their hand-written CUDA
kernel (``csrc/keyprod.cu``).

For digit duals d_j (j < dnum) over the held rows t of the expanded tower,
a key's mask and masked rows km_j, kd_j, and an optional Galois dual
permutation π (``ntt.galois_dual_perm_dev``)::

    acc1[.., t, n] = acc1_in + Σ_j kd_j[t, n] · d_j[.., t, π(n)]  mod p_t
    acc2[.., t, n] = acc2_in + Σ_j km_j[t, n] · d_j[.., t, π(n)]  mod p_t

returned as one int64 tensor [2, .., T, N] (acc1, acc2), ready for the
stacked ModDown. Every key switch the cells run calls :func:`key_products`:
the engine's (``core/rlwe.py``: ``_keyswitch_hybrid`` and the hoisted
rotations of ``rotate_many`` / ``rotate_sum``, π folded in), the compiled
layers' (``parallel/layers.py::_key_products``) and the fused square step's
(``parallel/ops.py::make_hybrid_fused_step``). A CUDA tensor goes to the
kernel, which raises rather than fall back; a CPU tensor goes to
:func:`key_products_plain`, the torch formula those call sites ran before
the kernel. The two agree bit for bit.

The kernel replaces no Pallas kernel: the reference leaves this step to XLA
(``toyfhe_tpu/core/rlwe.py``, ``_keyswitch_hybrid``). Built by ``nvcc`` at
first use (:mod:`.cuda_lib`); ``launches["key_products"]`` counts its
launches.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import modmath
from .cuda_lib import CI, VP, CudaLibrary
from .modmath import MontParams, const

LIB = CudaLibrary("keyprod", {"toyfhe_keyprod": ([VP] * 7 + [CI] * 5 + [VP], CI)})
launches = {"key_products": 0}


def _check(digits: torch.Tensor, masks: torch.Tensor, maskeds: torch.Tensor,
           mp: MontParams, digits_inner: bool, perm, acc) -> tuple:
    """The leading shape of ``digits``; raises on what neither path takes."""
    for name, t in (("digits", digits), ("masks", masks), ("maskeds", maskeds)):
        if t.dtype != torch.int64:
            raise TypeError(f"{name} must be int64, got {t.dtype}")
    if masks.dim() != 3 or maskeds.shape != masks.shape:
        raise ValueError(f"key rows must be [dnum, T, N] alike, got {tuple(masks.shape)} "
                         f"and {tuple(maskeds.shape)}")
    dnum, nt, n = masks.shape
    axis = digits.dim() - 3 if digits_inner else 0
    if digits.dim() < 3 or digits.shape[axis] != dnum or tuple(digits.shape[-2:]) != (nt, n):
        raise ValueError(f"digits {tuple(digits.shape)} do not match keys {tuple(masks.shape)}"
                         f" ({'inner' if digits_inner else 'outer'} digit axis)")
    if mp.nlimbs != nt:
        raise ValueError(f"{mp.nlimbs} primes for {nt} rows")
    lead = tuple(digits.shape[:axis] + digits.shape[axis + 1:-2])
    if perm is not None and (perm.dtype != torch.int64 or tuple(perm.shape) != (n,)):
        raise ValueError(f"perm must be int64 [{n}], got {perm.dtype} {tuple(perm.shape)}")
    if acc is not None and (acc.dtype != torch.int64 or tuple(acc.shape) != (2,) + lead + (nt, n)):
        raise ValueError(f"acc must be int64 {(2,) + lead + (nt, n)}, got {tuple(acc.shape)}")
    return lead


def key_products(digits: torch.Tensor, masks: torch.Tensor, maskeds: torch.Tensor,
                 mp: MontParams, digits_inner: bool = False, perm: torch.Tensor = None,
                 acc: torch.Tensor = None) -> torch.Tensor:
    """int64 [2, .., T, N]: (Σ_j maskeds_j·d_j, Σ_j masks_j·d_j) mod p_t of
    the digits ``digits`` int64 [dnum, .., T, N] ([.., dnum, T, N] with
    ``digits_inner``) and key rows int64 [dnum, T, N] (``mp``: the T rows'
    primes, host form), each digit read at ``perm`` (int64 [N]) when given.
    With ``acc`` (int64 [2, .., T, N]) the sums are added into it in place
    and ``acc`` is returned."""
    _check(digits, masks, maskeds, mp, digits_inner, perm, acc)
    if digits.device.type == "cuda":
        return launch(digits.contiguous(), masks, maskeds, mp, digits_inner, perm, acc)
    if digits.device.type != "cpu":
        raise ValueError(f"no key products for tensors on {digits.device}")
    return key_products_plain(digits, masks, maskeds, mp, digits_inner, perm, acc)


def key_products_plain(digits: torch.Tensor, masks: torch.Tensor, maskeds: torch.Tensor,
                       mp: MontParams, digits_inner: bool = False, perm: torch.Tensor = None,
                       acc: torch.Tensor = None) -> torch.Tensor:
    """The kernel's plain torch twin, on any device: the permuted digits'
    broadcast products with each key component and their modular sums over
    the digit axis."""
    if perm is not None:
        digits = digits.index_select(-1, perm)
    if not digits_inner:
        shp = masks.shape[:1] + (1,) * (digits.dim() - 3) + masks.shape[1:]
        masks, maskeds = masks.reshape(shp), maskeds.reshape(shp)
    axis = -3 if digits_inner else 0
    acc1 = modmath.mod_sum(modmath.mul_mod(maskeds, digits, mp), mp, axis=axis)
    acc2 = modmath.mod_sum(modmath.mul_mod(masks, digits, mp), mp, axis=axis)
    out = torch.stack([acc1, acc2])
    if acc is None:
        return out
    return acc.copy_(modmath.add_mod(acc, out, mp))


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------

def _table(mp: MontParams, device) -> torch.Tensor:
    """Each row's (p, -p⁻¹ mod 2^32, 2^64 mod p) as int32 words on
    ``device``, uploaded once (:func:`.modmath.const`)."""
    if torch.is_tensor(mp.p):
        raise ValueError("the key-product kernel takes the primes in host form")
    tab = np.ascontiguousarray(np.concatenate([mp.p, mp.ninv, mp.r2], axis=1), dtype=np.uint32)
    return const(tab.view(np.int32), device, torch.int32)


def launch(digits: torch.Tensor, masks: torch.Tensor, maskeds: torch.Tensor, mp: MontParams,
           digits_inner: bool = False, perm: torch.Tensor = None,
           acc: torch.Tensor = None) -> torch.Tensor:
    """:func:`key_products` of contiguous int64 CUDA tensors through the
    kernel. Raises on anything the kernel does not take."""
    from .ntt_cuda import check_n
    lead = _check(digits, masks, maskeds, mp, digits_inner, perm, acc)
    operands = [("digits", digits), ("masks", masks), ("maskeds", maskeds)]
    operands += [("perm", perm)] if perm is not None else []
    operands += [("acc", acc)] if acc is not None else []
    for name, t in operands:
        if t.device != digits.device:
            raise ValueError(f"{name} on {t.device}, digits on {digits.device}")
        if not t.is_contiguous():
            raise ValueError(f"the CUDA key products need a contiguous {name}")
    if digits.device.type != "cuda":
        raise ValueError(f"the CUDA key products take CUDA tensors, got {digits.device}")
    dnum, nt, n = masks.shape
    check_n(n)
    rows = math.prod(lead)
    out = acc if acc is not None else torch.empty((2,) + lead + (nt, n), dtype=torch.int64,
                                                  device=digits.device)
    if out.numel():
        lib = LIB.load()
        tab = _table(mp, digits.device)
        with torch.cuda.device(digits.device):
            stream = torch.cuda.current_stream(digits.device).cuda_stream
            err = lib.toyfhe_keyprod(digits.data_ptr(), masks.data_ptr(), maskeds.data_ptr(),
                                     None if perm is None else perm.data_ptr(),
                                     None if acc is None else acc.data_ptr(), out.data_ptr(),
                                     tab.data_ptr(), rows, nt, dnum, n.bit_length() - 1,
                                     int(digits_inner), stream)
        LIB.check(err, "CUDA key products")
        launches["key_products"] += 1
    return out
