"""Wrapper of the hand-written CUDA negacyclic NTT (``csrc/ntt.cu``).

Replaces the TPU kernel ``toyfhe_tpu/ops/ntt_mxu_pallas.py::_mxu_nat``
(K1): the natural-order forward and inverse transform of ``[..., L, N]``
residue tensors. Its plain twin is :func:`..ops.ntt.ntt_plain` /
:func:`..ops.ntt.intt_plain`, which it equals bit for bit.

The kernel is compiled by ``nvcc`` from ``toyfhe_tpu_torch/csrc/ntt.cu`` at
first use into ``toyfhe_tpu_torch/_build/`` (rebuilt when the source is
newer) and loaded with ``ctypes``. Nothing here imports or builds anything
at module import.

``launches["fwd"]`` and ``launches["inv"]`` count the kernel launches made
through :func:`launch`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from .modmath import canonical_device

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ntt.cu"
BUILD_DIR = _PKG / "_build"
LIBRARY = BUILD_DIR / "libtoyfhe_ntt.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MIN_N, MAX_N = 16, 1 << 15

launches = {"fwd": 0, "inv": 0}
build_info: dict = {}
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA NTT kernel cannot be built")
    return found


def build() -> Path:
    """Compile ``csrc/ntt.cu`` into the shared library unless it is current.

    Records the compiler command, its output (``-Xptxas -v`` register and
    shared-memory report) and the build time in :data:`build_info`."""
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("log", "up to date")
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIBRARY.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, LIBRARY)
    build_info.update(cmd=" ".join(cmd), log=res.stdout + res.stderr,
                      seconds=time.perf_counter() - t0)
    return LIBRARY


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.toyfhe_ntt.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
        lib.toyfhe_ntt.restype = ci
        lib.toyfhe_cuda_error_string.argtypes = [ci]
        lib.toyfhe_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _u32(a: np.ndarray, device) -> torch.Tensor:
    """uint32 host table → int32 tensor with the same bits on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)).to(device)


def _kernel_tables(tables, device) -> dict:
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
            "fwd": (_u32(tables.psi_pow, dev), _u32(pack(tables.stage_tw), dev)),
            "inv": (_u32(tables.psi_ipow, dev), _u32(pack(tables.stage_tw_inv), dev)),
            "pn": _u32(pn, dev),
        }

    return tables.cached(("cuda", dev), build_tables)


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
    if not MIN_N <= n <= MAX_N:
        raise ValueError(f"the CUDA NTT supports {MIN_N} <= N <= {MAX_N}, got {n}")
    if not x.is_contiguous():
        raise ValueError("the CUDA NTT needs a contiguous tensor")
    polys = x.numel() // n
    if polys >= 1 << 31:
        raise ValueError(f"{polys} polynomials exceed one launch grid")
    lib = _load()
    kt = _kernel_tables(tables, x.device)
    which = "inv" if inverse else "fwd"
    twist, tw = kt[which]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.toyfhe_ntt(x.data_ptr(), out.data_ptr(), twist.data_ptr(),
                             tw.data_ptr(), kt["pn"].data_ptr(), polys, nlimbs,
                             n.bit_length() - 1, int(inverse), stream)
    if err != 0:
        msg = lib.toyfhe_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA NTT launch failed: {msg} ({err})")
    launches[which] += 1
    return out
