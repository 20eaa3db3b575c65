"""Wrapper of the hand-written CUDA fused hybrid key switch
(``csrc/hybrid_ks.cu``).

Replaces the TPU kernel ``toyfhe_tpu/ops/pallas_hybrid_ks.py::
FusedHybridKS.__call__`` (K3, body ``_fused_kernel``). Its plain twin is
:func:`.hybrid_ks.fused_hybrid_ks_plain`, which it equals bit for bit.

Built by ``nvcc`` from ``toyfhe_tpu_torch/csrc/hybrid_ks.cu`` at first use
(:mod:`.cuda_lib`). ``launches["k3"]`` counts the launches made through
:func:`launch`.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_lib import CI, VP, CudaLibrary
from .modmath import canonical_device
from .ntt_cuda import u32_table, check_n, kernel_tables

LIB = CudaLibrary("hybrid_ks", {"toyfhe_hybrid_ks": ([VP] * 10 + [CI] * 6 + [VP], CI)})
launches = {"k3": 0}


def _tables(fks, device) -> dict:
    """The kernel's operands besides ŷ on ``device``, uploaded once: the
    forward NTT tables of the expanded tower, the FBC constants, the
    pre-Montgomerized key rows as 32-bit words and the group bounds."""
    dev = canonical_device(device)
    key = ("cuda", dev)
    if key not in fks._dev:
        d = fks.on(dev)
        nt = kernel_tables(fks.exp_ring.tables, dev)
        fks._dev[key] = {
            "twist": nt["fwd"][0], "tw": nt["fwd"][1], "pn": nt["pn"],
            "cst": u32_table(fks.cst, dev),
            "km": d["km"].to(torch.int32).contiguous(),
            "kd": d["kd"].to(torch.int32).contiguous(),
            "bounds": torch.as_tensor(np.asarray(fks.bounds, dtype=np.int32), device=dev),
        }
    return fks._dev[key]


def launch(fks, y: torch.Tensor):
    """(acc1, acc2) of ``fks`` for a contiguous int64[..., lt, N] ŷ CUDA
    tensor through the kernel. Raises on anything the kernel does not take."""
    if y.device.type != "cuda":
        raise ValueError(f"the CUDA hybrid key switch takes CUDA tensors, got {y.device}")
    if y.dtype != torch.int64:
        raise TypeError(f"residues must be int64, got {y.dtype}")
    n, T = fks.exp_ring.n, fks.exp_ring.nlimbs
    if y.dim() < 2 or y.shape[-1] != n or y.shape[-2] != fks.lt:
        raise ValueError(f"expected [..., {fks.lt}, {n}], got {tuple(y.shape)}")
    check_n(n)
    if not y.is_contiguous():
        raise ValueError("the CUDA hybrid key switch needs a contiguous tensor")
    lead = tuple(y.shape[:-2])
    rows = y.numel() // (fks.lt * n)
    if rows * T >= 1 << 31:
        raise ValueError(f"{rows} rows exceed one launch grid")
    lib = LIB.load()
    kt = _tables(fks, y.device)
    out1 = torch.empty(lead + (T, n), dtype=torch.int64, device=y.device)
    out2 = torch.empty_like(out1)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.toyfhe_hybrid_ks(
            y.data_ptr(), out1.data_ptr(), out2.data_ptr(), kt["twist"].data_ptr(),
            kt["tw"].data_ptr(), kt["pn"].data_ptr(), kt["cst"].data_ptr(),
            kt["km"].data_ptr(), kt["kd"].data_ptr(), kt["bounds"].data_ptr(),
            rows, fks.lt, T, fks.dnum_t, fks.alpha, n.bit_length() - 1, stream)
    LIB.check(err, "CUDA hybrid key switch")
    launches["k3"] += 1
    return out1, out2
