"""Wrapper of the hand-written CUDA fused windowed key switch
(``csrc/keyswitch.cu``).

Replaces the TPU kernel ``toyfhe_tpu/ops/pallas_keyswitch.py::
FusedKeyswitch._call`` (K6, body ``_ks_kernel``). Its plain twin is
:func:`.pallas_keyswitch.fused_keyswitch_plain`, which it equals bit for
bit.

Built by ``nvcc`` from ``toyfhe_tpu_torch/csrc/keyswitch.cu`` at first use
(:mod:`.cuda_lib`). ``launches["k6"]`` counts the launches made through
:func:`launch`.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_lib import CI, VP, CudaLibrary
from .modmath import canonical_device
from .ntt_cuda import check_n, kernel_tables, u32_table

LIB = CudaLibrary("keyswitch", {
    "toyfhe_keyswitch": ([VP] * 12 + [CI] * 5 + [VP], CI),
    "toyfhe_keyswitch_scratch_bytes": ([CI] * 3, ctypes.c_longlong),
})
launches = {"k6": 0}


def _tables(fk, device) -> dict:
    """The kernel's operands besides c2 and c1e on ``device``, uploaded
    once: the forward and inverse tables of the expanded tower, the
    ``(p, ninv, r2)`` rows and the bit-reversed key rows as 32-bit words."""
    dev = canonical_device(device)
    key = ("cuda", dev)
    if key not in fk._dev:
        nt = kernel_tables(fk.pt.tables, dev)
        keys = fk.keys_on(dev)
        fk._dev[key] = {
            "fwd": nt["fwd"], "inv": nt["inv"],
            "pnr": u32_table(fk._pn[:, 0, :], dev),
            "masks": keys["masks"].to(torch.int32).contiguous(),
            "maskeds": keys["maskeds"].to(torch.int32).contiguous(),
        }
    return fk._dev[key]


def launch(fk, c2p: torch.Tensor, c1e: torch.Tensor):
    """(out1, out2) of ``fk`` for contiguous int64 CUDA tensors c2 primal
    [..., Lc, N] and c1e bit-reversed dual [..., Lc + 1, N] through the
    kernel. Raises on anything the kernel does not take."""
    if c2p.device.type != "cuda" or c1e.device.type != "cuda":
        raise ValueError(f"the CUDA fused key switch takes CUDA tensors, got "
                         f"{c2p.device} / {c1e.device}")
    fk.check(c2p, c1e)
    check_n(fk.n)
    if not (c2p.is_contiguous() and c1e.is_contiguous()):
        raise ValueError("the CUDA fused key switch needs contiguous tensors")
    Le = fk.Lc + 1
    rows = c2p.numel() // (fk.Lc * fk.n)
    if rows * Le >= 1 << 31:
        raise ValueError(f"{rows} rows exceed one launch grid")
    lib = LIB.load()
    kt = _tables(fk, c2p.device)
    out1 = torch.empty(c1e.shape, dtype=torch.int64, device=c2p.device)
    out2 = torch.empty_like(out1)
    nbytes = lib.toyfhe_keyswitch_scratch_bytes(rows, fk.Lc, fk.logn)
    scratch = torch.empty(nbytes // 4, dtype=torch.int32, device=c2p.device)
    (psi, fwd_tw), (ipsi, inv_tw) = kt["fwd"], kt["inv"]
    with torch.cuda.device(c2p.device):
        stream = torch.cuda.current_stream(c2p.device).cuda_stream
        err = lib.toyfhe_keyswitch(
            c2p.data_ptr(), c1e.data_ptr(), out1.data_ptr(), out2.data_ptr(),
            psi.data_ptr(), fwd_tw.data_ptr(), ipsi.data_ptr(), inv_tw.data_ptr(),
            kt["pnr"].data_ptr(), kt["masks"].data_ptr(), kt["maskeds"].data_ptr(),
            scratch.data_ptr() if nbytes else None, rows, fk.Lc, fk.window, fk.kpl,
            fk.logn, stream)
    LIB.check(err, "CUDA fused key switch")
    launches["k6"] += 1
    return out1, out2
