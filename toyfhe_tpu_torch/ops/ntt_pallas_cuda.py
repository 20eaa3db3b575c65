"""Wrapper of the hand-written CUDA bit-reversed forward NTT
(``csrc/ntt_bitrev.cu``).

Replaces the TPU kernel ``toyfhe_tpu/ops/ntt_pallas.py::ntt_pallas_bitrev``
(K5, body ``_fwd_kernel``). Its plain twin is
:func:`.ntt_pallas.ntt_bitrev_plain`, which it equals bit for bit.

Built by ``nvcc`` from ``toyfhe_tpu_torch/csrc/ntt_bitrev.cu`` at first use
(:mod:`.cuda_lib`). ``launches["k5"]`` counts the launches made through
:func:`launch`.
"""

from __future__ import annotations

import torch

from .cuda_lib import CI, VP, CudaLibrary
from .ntt_cuda import check_n, kernel_tables
from .ntt_pallas import _check_lrn

LIB = CudaLibrary("ntt_bitrev", {"toyfhe_ntt_bitrev": ([VP] * 5 + [CI] * 3 + [VP], CI)})
launches = {"k5": 0}


def launch(pt, a: torch.Tensor) -> torch.Tensor:
    """Bit-reversed forward NTT of a contiguous int64 [L, R, N] CUDA tensor
    (limb axis first) through the kernel. Raises on anything the kernel
    does not take."""
    if a.device.type != "cuda":
        raise ValueError(f"the CUDA bit-reversed NTT takes CUDA tensors, got {a.device}")
    _check_lrn(pt, a)
    check_n(pt.n)
    if not a.is_contiguous():
        raise ValueError("the CUDA bit-reversed NTT needs a contiguous tensor")
    rows = a.shape[1]
    if pt.L * rows >= 1 << 31:
        raise ValueError(f"{pt.L * rows} polynomials exceed one launch grid")
    lib = LIB.load()
    kt = kernel_tables(pt.tables, a.device)
    twist, tw = kt["fwd"]
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.toyfhe_ntt_bitrev(a.data_ptr(), out.data_ptr(), twist.data_ptr(),
                                    tw.data_ptr(), kt["pn"].data_ptr(), pt.L, rows,
                                    pt.logn, stream)
    LIB.check(err, "CUDA bit-reversed NTT")
    launches["k5"] += 1
    return out
