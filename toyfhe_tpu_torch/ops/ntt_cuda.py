"""Wrapper of the hand-written CUDA negacyclic NTT (``csrc/ntt.cu``).

Replaces the TPU kernel ``toyfhe_tpu/ops/ntt_mxu_pallas.py::_mxu_nat``
(K1): the natural-order forward and inverse transform of ``[..., L, N]``
residue tensors. Its plain twin is :func:`..ops.ntt.ntt_plain` /
:func:`..ops.ntt.intt_plain`, which it equals bit for bit.

The kernel is compiled by ``nvcc`` from ``toyfhe_tpu_torch/csrc/ntt.cu`` at
first use into ``toyfhe_tpu_torch/_build/`` (:mod:`.cuda_lib`) and loaded
with ``ctypes``. Nothing here imports or builds anything at module import.

``launches["fwd"]`` and ``launches["inv"]`` count the kernel launches made
through :func:`launch`; ``transforms`` counts the limb polynomials they
transformed (the transform census of a step).
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_lib import CI, VP, CudaLibrary
from .modmath import canonical_device

MIN_N, MAX_N = 16, 1 << 15

LIB = CudaLibrary("ntt", {"toyfhe_ntt": ([VP] * 5 + [CI] * 4 + [VP], CI)})
launches = {"fwd": 0, "inv": 0}
transforms = {"fwd": 0, "inv": 0}


def u32_table(a: np.ndarray, device) -> torch.Tensor:
    """uint32 host table → int32 tensor with the same bits on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)).to(device)


def kernel_tables(tables, device) -> dict:
    """Twist rows, packed stage twiddles and (p, ninv) pairs on ``device``,
    uploaded once per ring and device."""
    dev = canonical_device(device)

    def pack(stages):
        out = np.zeros((len(tables.primes), tables.n), dtype=np.uint32)
        for st in stages:
            h = st.shape[-1]
            out[:, h:2 * h] = st[:, 0, :]
        return out

    def build_tables():
        pn = np.concatenate([tables.mp.p, tables.mp.ninv], axis=1)   # [L, 2]
        return {
            "fwd": (u32_table(tables.psi_pow, dev), u32_table(pack(tables.stage_tw), dev)),
            "inv": (u32_table(tables.psi_ipow, dev), u32_table(pack(tables.stage_tw_inv), dev)),
            "pn": u32_table(pn, dev),
        }

    return tables.cached(("cuda", dev), build_tables)


def check_n(n: int) -> None:
    if not MIN_N <= n <= MAX_N:
        raise ValueError(f"the CUDA kernels support {MIN_N} <= N <= {MAX_N}, got {n}")


def launch(tables, x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Forward (or inverse) NTT of a contiguous int64[..., L, N] CUDA tensor
    through the kernel. Raises on anything the kernel does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA NTT takes CUDA tensors, got {x.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"residues must be int64, got {x.dtype}")
    n, nlimbs = tables.n, len(tables.primes)
    if x.dim() < 2 or x.shape[-1] != n or x.shape[-2] != nlimbs:
        raise ValueError(f"expected [..., {nlimbs}, {n}], got {tuple(x.shape)}")
    check_n(n)
    if not x.is_contiguous():
        raise ValueError("the CUDA NTT needs a contiguous tensor")
    polys = x.numel() // n
    if polys >= 1 << 31:
        raise ValueError(f"{polys} polynomials exceed one launch grid")
    lib = LIB.load()
    kt = kernel_tables(tables, x.device)
    which = "inv" if inverse else "fwd"
    twist, tw = kt[which]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.toyfhe_ntt(x.data_ptr(), out.data_ptr(), twist.data_ptr(),
                             tw.data_ptr(), kt["pn"].data_ptr(), polys, nlimbs,
                             n.bit_length() - 1, int(inverse), stream)
    LIB.check(err, "CUDA NTT")
    launches[which] += 1
    transforms[which] += polys
    return out
