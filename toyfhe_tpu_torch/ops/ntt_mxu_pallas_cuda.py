"""Wrapper of the hand-written CUDA four-step NTT (``csrc/ntt_mxu.cu``).

Replaces the TPU kernel ``toyfhe_tpu/ops/ntt_mxu_pallas.py::ntt_mxu_pallas``
(K2, body ``_fwd_kernel``). Its plain twin is
:func:`.ntt_mxu_pallas.ntt_mxu_pallas_plain`, which it equals bit for bit in
both recombination modes.

Built by ``nvcc`` from ``toyfhe_tpu_torch/csrc/ntt_mxu.cu`` at first use
(:mod:`.cuda_lib`). ``launches["k2"]`` counts the launches made through
:func:`launch`.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_lib import CI, VP, CudaLibrary
from .modmath import canonical_device
from .ntt_cuda import u32_table
from .ntt_mxu import _NDIG
from .ntt_mxu_pallas import _check_x

MAX_N2 = 128       # two sets of digit planes must fit one block's shared memory

LIB = CudaLibrary("ntt_mxu", {"toyfhe_ntt_mxu": ([VP] * 7 + [CI] * 5 + [VP], CI)})
launches = {"k2": 0}


def contraction_pad(n2: int) -> int:
    """Stage 2's contraction length rounded up to whole 4-byte dot words."""
    return max(4, -(-n2 // 4) * 4)


def kernel_tables(mt, device) -> dict:
    """The digit matrices as int8, the twiddles and the per-limb constant
    rows on ``device``, uploaded once per table object and device. ``w1`` /
    ``w2`` are stored with the output index as the row (they are symmetric)
    and stage 2's contraction index zero-padded to whole dot words."""
    dev = canonical_device(device)

    def build():
        L, n2 = len(mt.primes), mt.n2
        w2 = np.zeros((L, _NDIG, n2, contraction_pad(n2)), dtype=np.int8)
        w2[..., :n2] = np.asarray(mt.w2).transpose(0, 1, 3, 2)
        w1 = np.ascontiguousarray(np.asarray(mt.w1).transpose(0, 1, 3, 2))
        sc = np.zeros((L, 16), dtype=np.uint32)
        flat = lambda a: np.asarray(a).reshape(L)
        for i, a in enumerate((mt.mp.p, mt.mp.ninv, mt.corr, mt.r1_mont, mt.hi_mont,
                               mt.cs32, mt.cs48, mt.corr2)):
            sc[:, i] = flat(a)
        sc[:, 8:8 + 2 * _NDIG - 1] = np.asarray(mt.cs).reshape(2 * _NDIG - 1, L).T
        return {"w1": torch.from_numpy(w1).to(dev), "w2": torch.from_numpy(w2).to(dev),
                "tw": u32_table(mt.tw, dev), "sc": u32_table(sc, dev)}

    return mt.cached(("cuda", dev), build)


def launch(mt, x: torch.Tensor, psis: torch.Tensor, paired: bool) -> torch.Tensor:
    """Forward four-step NTT of a contiguous int64 [L, R, 128, n2] CUDA
    tensor through the kernel; ``psis`` int64 [L, 128, n2] on the same
    device. Raises on anything the kernel does not take."""
    if x.device.type != "cuda" or psis.device != x.device:
        raise ValueError(f"the CUDA four-step NTT takes CUDA tensors on one device, "
                         f"got {x.device} and {psis.device}")
    _check_x(mt, x, psis)
    n2 = mt.n2
    if not 1 <= n2 <= MAX_N2 or n2 & (n2 - 1):
        raise ValueError(f"the CUDA four-step NTT supports N = 128·n2 with n2 a power "
                         f"of two up to {MAX_N2}, got n2 = {n2}")
    if paired and not mt.paired_ok:
        raise ValueError("the paired recombination needs mt.paired_ok")
    if not (x.is_contiguous() and psis.is_contiguous()):
        raise ValueError("the CUDA four-step NTT needs contiguous tensors")
    L, rows = x.shape[0], x.shape[1]
    if rows > 65535:
        raise ValueError(f"{rows} rows exceed one launch grid")
    lib = LIB.load()
    kt = kernel_tables(mt, x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.toyfhe_ntt_mxu(x.data_ptr(), psis.data_ptr(), out.data_ptr(),
                                 kt["w1"].data_ptr(), kt["w2"].data_ptr(),
                                 kt["tw"].data_ptr(), kt["sc"].data_ptr(), L, rows, n2,
                                 contraction_pad(n2), int(bool(paired)), stream)
    LIB.check(err, "CUDA four-step NTT")
    launches["k2"] += 1
    return out
