"""Wrapper of the hand-written CUDA four-step NTT (``csrc/ntt_mxu.cu``).

Replaces the TPU kernel ``toyfhe_tpu/ops/ntt_mxu_pallas.py::ntt_mxu_pallas``
(K2, body ``_fwd_kernel``). Its plain twin is
:func:`.ntt_mxu_pallas.ntt_mxu_pallas_plain`, which it equals bit for bit in
both recombination modes.

The kernel runs the two digit matrix products as ``mma.sync m16n8k32`` on
the int8 tensor cores. This module lays the operands out as the kernel's
fragment loads read them (:func:`w_planes`, :func:`stage1_planes`,
:func:`stage2_planes`: one row per output index, the contraction index
contiguous, every row padded by ``ROW_PAD`` bytes) and holds a numpy
emulation of one warp's walk over a 16 × 16 tile (:func:`tile_groups`, from
the fragment layout of ``mma``) and of the whole kernel
(:func:`ntt_mxu_fragments`), for the CPU tests.

Built by ``nvcc`` from ``toyfhe_tpu_torch/csrc/ntt_mxu.cu`` at first use
(:mod:`.cuda_lib`). ``launches["k2"]`` counts the launches made through
:func:`launch`.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_lib import CI, VP, CudaLibrary
from .modmath import canonical_device, mont_mul_raw
from .ntt_cuda import BLOCK_CAP, u32_table
from .ntt_mxu import _NDIG, N1, _balanced_digits_device, device_tables
from .ntt_mxu_pallas import _check_x, _combine, _combine_paired

MAX_N2 = 128       # W1 and two sets of digit planes must fit one block's shared memory
ROW_PAD = 16       # bytes added to every operand row: a fragment load hits 32 banks
TILE = 16          # a warp's output tile is TILE x TILE
K_STEP = 32        # contraction depth of one mma

LIB = CudaLibrary("ntt_mxu", {"toyfhe_ntt_mxu": ([VP] * 7 + [CI] * 7 + [VP], CI),
                              "toyfhe_ntt_mxu_attrs": ([CI, VP], CI)})
launches = {"k2": 0}


def contraction_pad(n2: int) -> int:
    """Stage 2's contraction length rounded up to whole mma steps."""
    return max(K_STEP, -(-n2 // K_STEP) * K_STEP)


def output_pad(n2: int) -> int:
    """The n2-long output dimension rounded up to whole warp tiles."""
    return max(TILE, -(-n2 // TILE) * TILE)


def rows_per_block(nlimbs: int, rows: int) -> int:
    """Rows of one limb a block walks over: the fewest that keep the launch
    within ``BLOCK_CAP`` blocks."""
    return max(1, -(-nlimbs * rows // BLOCK_CAP))


def w_planes(w: np.ndarray, out_rows: int, depth: int) -> np.ndarray:
    """Digit matrix ``w`` int8 [L, 4, K, J] (contraction index first) as the
    kernel's operand: int8 [L, 4, out_rows, depth + ROW_PAD], row = output
    index J, the contraction index contiguous, zero beyond K and J."""
    L, nd, k, j = w.shape
    out = np.zeros((L, nd, out_rows, depth + ROW_PAD), dtype=np.int8)
    out[:, :, :j, :k] = np.asarray(w).transpose(0, 1, 3, 2)
    return out


def stage1_planes(xt: np.ndarray, n2: int) -> np.ndarray:
    """Digits int8 [4, 128, n2] of the twisted block X[j1, j2] as stage 1's
    B operand: [4, output_pad(n2), 128 + ROW_PAD], row j2, j1 contiguous."""
    out = np.zeros((_NDIG, output_pad(n2), N1 + ROW_PAD), dtype=np.int8)
    out[:, :n2, :N1] = xt.transpose(0, 2, 1)
    return out


def stage2_planes(b: np.ndarray, n2: int) -> np.ndarray:
    """Digits int8 [4, 128, n2] of B[k1, j2] as stage 2's A operand:
    [4, 128, contraction_pad(n2) + ROW_PAD], row k1, j2 contiguous."""
    out = np.zeros((_NDIG, N1, contraction_pad(n2) + ROW_PAD), dtype=np.int8)
    out[:, :, :n2] = b
    return out


# ---------------------------------------------------------------------------
# numpy emulation of the warp tile (CPU tests)
# ---------------------------------------------------------------------------

_LANE = np.arange(32)
_G, _TIG = _LANE >> 2, _LANE & 3
_BYTE = np.arange(4)


def a_fragment(plane: np.ndarray, row0: int, k0: int) -> np.ndarray:
    """The A fragment of mma m16n8k32 as each lane loads it from a plane
    [rows, bytes]: [32 lanes, 4 registers, 4 bytes]; register i is the word
    at (row0 + g + 8 (i & 1), k0 + 4 tig + 16 (i >> 1))."""
    rows = row0 + _G[:, None] + np.array([0, 8, 0, 8])[None, :]
    cols = k0 + 4 * _TIG[:, None] + np.array([0, 0, 16, 16])[None, :]
    return plane[rows[..., None], cols[..., None] + _BYTE]


def b_fragment(plane: np.ndarray, row0: int, k0: int) -> np.ndarray:
    """The B fragment: [32 lanes, 2 registers, 4 bytes]; register i is the
    word at (row0 + g, k0 + 4 tig + 16 i)."""
    rows = np.broadcast_to((row0 + _G)[:, None], (32, 2))
    cols = k0 + 4 * _TIG[:, None] + np.array([0, 16])[None, :]
    return plane[rows[..., None], cols[..., None] + _BYTE]


def mma_m16n8k32(c: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`` on per-lane
    registers: c [32, 4] += A (16 × 32) · B (32 × 8) with the PTX fragment
    layouts (g = lane / 4, tig = lane % 4): a_i holds A[g + 8 (i & 1),
    4 tig + 16 (i >> 1) + 0..3], b_i holds B[4 tig + 16 i + 0..3, g], c_i
    holds D[g + 8 (i >> 1), 2 tig + (i & 1)]."""
    A = np.zeros((16, 32), dtype=np.int64)
    B = np.zeros((32, 8), dtype=np.int64)
    for i in range(4):
        A[(_G + 8 * (i & 1))[:, None], 4 * _TIG[:, None] + 16 * (i >> 1) + _BYTE] = a[:, i]
    for i in range(2):
        B[4 * _TIG[:, None] + 16 * i + _BYTE, _G[:, None]] = b[:, i]
    D = A @ B
    out = c.copy()
    for i in range(4):
        out[:, i] += D[_G + 8 * (i >> 1), 2 * _TIG + (i & 1)]
    return out


def tile_groups(a_planes: np.ndarray, b_planes: np.ndarray, m0: int, n0: int,
                depth: int) -> np.ndarray:
    """One warp's 16 × 16 tile as the kernel walks it: the 7 diagonal groups
    int64 [7, 16, 16] of Σ_k A[m0 + r, k] · B[n0 + c, k] over ``depth``
    contraction bytes, 16 (d, e) products into accumulator d + e for each
    8-column half and each 32-deep step."""
    acc = np.zeros((2, 2 * _NDIG - 1, 32, 4), dtype=np.int64)
    for k0 in range(0, depth, K_STEP):
        bf = [[b_fragment(b_planes[e], n0 + 8 * h, k0) for h in range(2)] for e in range(_NDIG)]
        for d in range(_NDIG):
            af = a_fragment(a_planes[d], m0, k0)
            for e in range(_NDIG):
                for h in range(2):
                    acc[h, d + e] = mma_m16n8k32(acc[h, d + e], af, bf[e][h])
    out = np.zeros((2 * _NDIG - 1, TILE, TILE), dtype=np.int64)
    for h in range(2):
        for i in range(4):
            out[:, _G + 8 * (i >> 1), 8 * h + 2 * _TIG + (i & 1)] = acc[h, :, :, i]
    return out


def stage_groups(a_planes: np.ndarray, b_planes: np.ndarray, out_cols: int,
                 depth: int) -> np.ndarray:
    """All tiles of one stage: groups int64 [7, 128, out_cols]."""
    out = np.zeros((2 * _NDIG - 1, N1, out_cols), dtype=np.int64)
    for m0 in range(0, N1, TILE):
        for n0 in range(0, out_cols, TILE):
            out[:, m0:m0 + TILE, n0:n0 + TILE] = tile_groups(a_planes, b_planes, m0, n0, depth)
    return out


def ntt_mxu_fragments(mt, x: torch.Tensor, psis: torch.Tensor, paired: bool) -> torch.Tensor:
    """The kernel's data flow on CPU tensors, operand layouts and fragment
    walk included: twist, stage-1 planes, tiles against W1, recombination,
    twiddle, stage-2 planes, tiles against W2, recombination. Output in
    (k1, k2) order, as :func:`.ntt_mxu_pallas.ntt_mxu_pallas_plain`."""
    _check_x(mt, x, psis)
    L, rows, n2 = x.shape[0], x.shape[1], mt.n2
    d = device_tables(mt, x.device)
    mp3 = d["mp3"]
    p, rinv = mp3.p[:, None], mp3.rinv[:, None]
    comb = _combine_paired if paired else _combine
    w1 = w_planes(np.asarray(mt.w1), N1, N1)
    w2 = w_planes(np.asarray(mt.w2), output_pad(n2), contraction_pad(n2))

    def stage(values, planes_of, operands):
        dig = _balanced_digits_device(values).numpy().astype(np.int8)      # [4, L, R, 128, n2]
        groups = np.zeros((2 * _NDIG - 1, L, rows, N1, n2), dtype=np.int64)
        for l in range(L):
            for r in range(rows):
                a, b = operands(l, planes_of(dig[:, l, r], n2))
                groups[:, l, r] = stage_groups(a, b, output_pad(n2), a.shape[-1] - ROW_PAD)[..., :n2]
        return comb([torch.from_numpy(g) for g in groups], d)

    xt = mont_mul_raw(x, psis[:, None], p, rinv)
    a = stage(xt, stage1_planes, lambda l, planes: (w1[l], planes))
    b = mont_mul_raw(a, d["tw"][:, None], p, rinv)
    return stage(b, stage2_planes, lambda l, planes: (planes, w2[l]))


# ---------------------------------------------------------------------------
# the launch
# ---------------------------------------------------------------------------

def kernel_tables(mt, device) -> dict:
    """The digit matrices as the kernel's int8 operands, the twiddles and
    the per-limb constant rows on ``device``, uploaded once per table object
    and device."""
    dev = canonical_device(device)

    def build():
        L, n2 = len(mt.primes), mt.n2
        w1 = w_planes(np.asarray(mt.w1), N1, N1)
        w2 = w_planes(np.asarray(mt.w2), output_pad(n2), contraction_pad(n2))
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
    rpb = rows_per_block(L, rows)
    if -(-rows // rpb) > 65535:
        raise ValueError(f"{rows} rows exceed one launch grid")
    lib = LIB.load()
    kt = kernel_tables(mt, x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.toyfhe_ntt_mxu(x.data_ptr(), psis.data_ptr(), out.data_ptr(),
                                 kt["w1"].data_ptr(), kt["w2"].data_ptr(),
                                 kt["tw"].data_ptr(), kt["sc"].data_ptr(), L, rows, n2,
                                 output_pad(n2), contraction_pad(n2), rpb,
                                 int(bool(paired)), stream)
    LIB.check(err, "CUDA four-step NTT")
    launches["k2"] += 1
    return out


def kernel_registers(paired: bool) -> int:
    """Registers a thread of the kernel of one recombination, as the CUDA
    runtime reports them (builds the library)."""
    import ctypes
    buf = (ctypes.c_int * 1)()
    LIB.check(LIB.load().toyfhe_ntt_mxu_attrs(int(bool(paired)), ctypes.addressof(buf)),
              "four-step NTT attributes")
    return buf[0]


def block_smem(n2: int) -> int:
    """Dynamic shared-memory bytes of one block, as the C launcher sets them:
    W1's planes, the stage-1 data planes (W2's after stage 1) and the stage-2
    data planes."""
    return _NDIG * ((N1 + output_pad(n2)) * (N1 + ROW_PAD)
                    + N1 * (contraction_pad(n2) + ROW_PAD))
