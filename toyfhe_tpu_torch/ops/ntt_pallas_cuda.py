"""Wrappers of the hand-written CUDA bit-reversed forward NTT
(``csrc/ntt_bitrev.cu``) and fused polynomial product (``csrc/polymul.cu``).

:func:`launch` replaces the TPU kernel
``toyfhe_tpu/ops/ntt_pallas.py::ntt_pallas_bitrev`` (K5, body
``_fwd_kernel``); its plain twin is :func:`.ntt_pallas.ntt_bitrev_plain`.
:func:`launch_polymul` replaces ``polymul_pallas_raw`` of the same file
(K4, body ``_polymul_kernel``); its plain twin is
:func:`.ntt_pallas.polymul_plain`. Each equals its twin bit for bit.

Each source is built by ``nvcc`` at first use (:mod:`.cuda_lib`).
``launches["k5"]`` and ``polymul_launches["k4"]`` count the launches made
through :func:`launch` and :func:`launch_polymul`.
"""

from __future__ import annotations

import torch

from .cuda_lib import CI, VP, CudaLibrary
from .ntt_cuda import check_n, kernel_tables, u32_table
from .ntt_pallas import _check_lrn

LIB = CudaLibrary("ntt_bitrev", {"toyfhe_ntt_bitrev": ([VP] * 5 + [CI] * 3 + [VP], CI)})
launches = {"k5": 0}
LIB_POLYMUL = CudaLibrary("polymul", {"toyfhe_polymul": ([VP] * 9 + [CI] * 4 + [VP], CI)})
polymul_launches = {"k4": 0}
PARK_ABOVE = 1 << 14   # two rows of N words fit one block's shared memory up to here


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


def launch_polymul(pt, a: torch.Tensor, b: torch.Tensor, park: bool = None) -> torch.Tensor:
    """Fused negacyclic product of contiguous primal int64 [L, R, N] CUDA
    tensors through the kernel. ``park`` keeps one row in shared memory and
    parks the first transform in the output row; by default only above
    N = 2^14, where two rows do not fit. Raises on anything the kernel does
    not take."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"the CUDA fused product takes CUDA tensors on one device, "
                         f"got {a.device} and {b.device}")
    _check_lrn(pt, a)
    _check_lrn(pt, b)
    if a.shape != b.shape:
        raise ValueError(f"operand shapes differ: {tuple(a.shape)} and {tuple(b.shape)}")
    check_n(pt.n)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the CUDA fused product needs contiguous tensors")
    if park is None:
        park = pt.n > PARK_ABOVE
    elif not park and pt.n > PARK_ABOVE:
        raise ValueError(f"two rows of N={pt.n} do not fit in shared memory: park=True only")
    rows = a.shape[1]
    if pt.L * rows >= 1 << 31:
        raise ValueError(f"{pt.L * rows} polynomials exceed one launch grid")
    lib = LIB_POLYMUL.load()
    kt = kernel_tables(pt.tables, a.device)
    twist, tw = kt["fwd"]
    itwist, itw = kt["inv"]
    r2 = pt.tables.cached(("cuda_r2", a.device), lambda: u32_table(pt.r2, a.device))
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.toyfhe_polymul(a.data_ptr(), b.data_ptr(), out.data_ptr(), twist.data_ptr(),
                                 tw.data_ptr(), itwist.data_ptr(), itw.data_ptr(),
                                 kt["pn"].data_ptr(), r2.data_ptr(), pt.L, rows, pt.logn,
                                 int(bool(park)), stream)
    LIB_POLYMUL.check(err, "CUDA fused product")
    polymul_launches["k4"] += 1
    return out
