"""The fast base conversion (ModUp) of the dnum-grouped hybrid key switch,
and its hand-written CUDA kernel (``csrc/fbc.cu``).

For each digit group j = [lo, hi) of the ciphertext tower and each target
row t of the expanded tower Q_t ∪ P::

    D_j[t] = Σ_{a ∈ [lo, hi)} ŷ_a · [Q_j / q_a]_{p_t}  mod p_t,
    ŷ_a    = x_a · [(Q_j / q_a)⁻¹]_{q_a}              mod q_a.

Both decompositions of the port call :func:`fbc`: the engine's
(``core/hybrid.py::HybridRaised.hybrid_decompose`` and its dual) and the
compiled layers' (``parallel/layers.py::_hybrid_digits``). A CUDA tensor
goes to the kernel, which raises rather than fall back; a CPU tensor goes to
:func:`fbc_plain`, the torch formula both call sites ran before the kernel.
The two agree bit for bit. :func:`fbc_schedule` is the kernel's arithmetic in
plain torch (chunks of ``MAX_A`` rows, lazy Montgomery products, the 64-bit
sum and its one reduction), for the CPU tests.

The kernel replaces no Pallas kernel: the reference leaves this step to XLA
(``toyfhe_tpu/core/hybrid.py:148``). Built by ``nvcc`` at first use
(:mod:`.cuda_lib`); ``launches["fbc"]`` counts its launches.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from . import modmath
from .cuda_lib import CI, VP, CudaLibrary
from .modmath import MontParams, const

LIB = CudaLibrary("fbc", {"toyfhe_fbc": ([VP] * 3 + [CI] * 9 + [VP], CI)})
launches = {"fbc": 0}
MAX_A = 8                  # ciphertext rows of a digit the kernel holds in registers at once
_MASK32 = (1 << 32) - 1


@dataclasses.dataclass(frozen=True, eq=False)
class FbcPlan:
    """The host tables of one decomposition: a ciphertext tower of ``lt``
    limbs into the target rows a process holds (all of Q_t ∪ P on one
    device, a rank's rows on a limb-sharded tower).

    ``bounds``: each group's ciphertext rows [lo, hi); ``skip``: each group's
    own rows among the held targets (a digit equals x there); ``inv`` uint32
    [lt, 1] the ŷ premultipliers and ``cst`` uint32 [dnum, T, alpha] the
    conversion constants [Q_j/q_a]_{p_t}, both in Montgomery form (``cst``
    zero-padded past a short group); ``ct_mp`` / ``tgt_mp`` the ciphertext
    tower's and the held targets' Montgomery constants."""

    bounds: Tuple[Tuple[int, int], ...]
    skip: Tuple[Tuple[int, int], ...]
    inv: np.ndarray
    cst: np.ndarray
    ct_mp: MontParams
    tgt_mp: MontParams
    _dev: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def lt(self) -> int:
        return self.inv.shape[0]

    @property
    def dnum(self) -> int:
        return len(self.bounds)

    @property
    def nt(self) -> int:
        return self.cst.shape[1]

    @property
    def alpha(self) -> int:
        return self.cst.shape[2]

    def out_rows(self, j: int) -> int:
        """Target rows of digit ``j`` outside its own group."""
        return self.nt - (self.skip[j][1] - self.skip[j][0])


def make_plan(groups, ct_mp: MontParams, tgt_mp: MontParams, held: Sequence[int]) -> FbcPlan:
    """A plan from ``HybridRaised._tables(lt)[1]``'s groups (each ((lo, hi),
    inv [a, 1], consts [T, a, 1])), restricted to the target rows ``held``
    (ascending; ``tgt_mp`` holds their primes)."""
    held = list(held)
    alpha = max(hi - lo for (lo, hi), _, _ in groups)
    cst = np.zeros((len(groups), len(held), alpha), dtype=np.uint32)
    for j, ((lo, hi), _, consts) in enumerate(groups):
        cst[j, :, :hi - lo] = np.asarray(consts)[held, :, 0]
    return FbcPlan(
        bounds=tuple((lo, hi) for (lo, hi), _, _ in groups),
        skip=tuple((bisect.bisect_left(held, lo), bisect.bisect_left(held, hi))
                   for (lo, hi), _, _ in groups),
        inv=np.concatenate([np.asarray(inv, dtype=np.uint32) for _, inv, _ in groups]),
        cst=cst, ct_mp=ct_mp, tgt_mp=tgt_mp)


def _check(plan: FbcPlan, x: torch.Tensor) -> None:
    if x.dtype != torch.int64:
        raise TypeError(f"residues must be int64, got {x.dtype}")
    if x.dim() < 2 or x.shape[-2] != plan.lt:
        raise ValueError(f"expected [..., {plan.lt}, N], got {tuple(x.shape)}")


def fbc(plan: FbcPlan, x: torch.Tensor, premultiplied: bool = False,
        digits_inner: bool = False, out_of_group: bool = False):
    """The digits of ``x`` int64 [..., lt, N] (primal residues, or ŷ when
    ``premultiplied``): int64 [dnum, ..., T, N], or [..., dnum, T, N] with
    ``digits_inner``; with ``out_of_group`` a list of each digit's rows
    outside its own group, [..., T - w_j, N]."""
    _check(plan, x)
    if x.device.type == "cuda":
        return launch(plan, x.contiguous(), premultiplied, digits_inner, out_of_group)
    if x.device.type != "cpu":
        raise ValueError(f"no fast base conversion for tensors on {x.device}")
    return fbc_plain(plan, x, premultiplied, digits_inner, out_of_group)


def fbc_plain(plan: FbcPlan, x: torch.Tensor, premultiplied: bool = False,
              digits_inner: bool = False, out_of_group: bool = False):
    """The kernel's plain torch twin, on any device: per group the broadcast
    Montgomery product [..., T, a, N] and its modular sum over a."""
    dev = x.device
    y = x if premultiplied else modmath.mont_mul(x, const(plan.inv, dev), plan.ct_mp)
    mp = plan.tgt_mp
    mp3 = mp.expand()
    cst = const(plan.cst, dev)
    digs = []
    for j, (lo, hi) in enumerate(plan.bounds):
        prod = modmath.mont_mul(y[..., None, lo:hi, :], cst[j, :, :hi - lo, None], mp3)
        digs.append(modmath.mod_sum(prod, mp, axis=-2))
    if out_of_group:
        return [torch.cat([d[..., :slo, :], d[..., shi:, :]], dim=-2)
                for d, (slo, shi) in zip(digs, plan.skip)]
    return torch.stack(digs, dim=-3 if digits_inner else 0)


# ---------------------------------------------------------------------------
# the schedule twin (plain torch, CPU tests)
# ---------------------------------------------------------------------------

def _redc(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor, ninv: torch.Tensor):
    """REDC(a·b) = ⌊(a·b + m·p) / 2^32⌋ with m = a·b·ninv mod 2^32, without
    the closing correction, for a, b, p < 2^31: the sum under 2^64 is split
    at bit 32 so that int64 holds every piece."""
    x = a * b                                          # < 2^62
    m = ((x & _MASK32) * ninv) & _MASK32               # the low word survives wrapping
    mp = m * p                                         # < 2^63
    return (x >> 32) + (mp >> 32) + (((x & _MASK32) + (mp & _MASK32)) >> 32)


def fbc_schedule(plan: FbcPlan, x: torch.Tensor, premultiplied: bool = False):
    """The kernel's arithmetic on a CPU tensor: returns the digits int64
    [dnum, ..., T, N] and ``{"redc": largest uncorrected product, "sum":
    largest 64-bit sum before its reduction}``, each against the targets'
    largest prime (``"p"``).

    As ``csrc/fbc.cu``: ŷ by a corrected REDC (canonical), then per target
    and per chunk of ``MAX_A`` ciphertext rows the uncorrected REDC values
    summed (the stored partial added from the second chunk on) and reduced
    by conditional subtractions of 8p, 4p, 2p and p."""
    _check(plan, x)
    col = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64))
    y = x
    if not premultiplied:
        q, qn = col(plan.ct_mp.p), col(plan.ct_mp.ninv)
        y = _redc(x, col(plan.inv), q, qn)
        y = torch.where(y >= q, y - q, y)
    p, pn = col(plan.tgt_mp.p)[:, :, None], col(plan.tgt_mp.ninv)[:, :, None]   # [T, 1, 1]
    cst = col(plan.cst)
    seen = {"redc": 0, "sum": 0, "p": int(plan.tgt_mp.p.max())}
    digs = []
    for j, (lo, hi) in enumerate(plan.bounds):
        acc = None
        for a0 in range(lo, hi, MAX_A):
            w = min(MAX_A, hi - a0)
            c = cst[j, :, a0 - lo:a0 - lo + w, None]                          # [T, w, 1]
            terms = _redc(y[..., None, a0:a0 + w, :], c, p, pn)               # [..., T, w, N]
            s = terms.sum(dim=-2) + (0 if acc is None else acc)
            seen["redc"] = max(seen["redc"], int(terms.max()))
            seen["sum"] = max(seen["sum"], int(s.max()))
            pt = p[:, 0]
            for k in (8, 4, 2, 1):
                s = torch.where(s >= k * pt, s - k * pt, s)
            acc = s
        digs.append(acc)
    return torch.stack(digs, dim=0), seen


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------

def _table(plan: FbcPlan, device) -> torch.Tensor:
    """The kernel's constants as one int32 tensor on ``device`` (uploaded
    once through :func:`.modmath.const`): ct (q, ninv) pairs, target (p,
    ninv) pairs, the premultipliers, the constants, the bounds."""
    dev = modmath.canonical_device(device)
    if dev not in plan._dev:
        plan._dev[dev] = _upload(plan, dev)
    return plan._dev[dev]


def _upload(plan: FbcPlan, device) -> torch.Tensor:
    u32 = lambda a: np.ascontiguousarray(a, dtype=np.uint32).reshape(-1)
    bounds = np.array([[lo, hi, slo, shi] for (lo, hi), (slo, shi) in zip(plan.bounds, plan.skip)],
                      dtype=np.uint32)
    tab = np.concatenate([u32(np.concatenate([plan.ct_mp.p, plan.ct_mp.ninv], axis=1)),
                          u32(np.concatenate([plan.tgt_mp.p, plan.tgt_mp.ninv], axis=1)),
                          u32(plan.inv), u32(plan.cst), u32(bounds)])
    return const(tab.view(np.int32), device, torch.int32)


def launch(plan: FbcPlan, x: torch.Tensor, premultiplied: bool = False,
           digits_inner: bool = False, out_of_group: bool = False):
    """:func:`fbc` of a contiguous int64 CUDA tensor through the kernel.
    Raises on anything the kernel does not take."""
    from .ntt_cuda import check_n
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA fast base conversion takes CUDA tensors, got {x.device}")
    _check(plan, x)
    if not x.is_contiguous():
        raise ValueError("the CUDA fast base conversion needs a contiguous tensor")
    if digits_inner and out_of_group:
        raise ValueError("out-of-group rows come digits first")
    n = x.shape[-1]
    check_n(n)
    lead = tuple(x.shape[:-2])
    rows = math.prod(lead)
    lib = LIB.load()
    tab = _table(plan, x.device)
    if x.data_ptr() % 16:
        x = x.clone()                      # the kernel loads 16 bytes a thread
    if out_of_group:
        sizes = [rows * plan.out_rows(j) * n for j in range(plan.dnum)]
        out = torch.empty(sum(sizes), dtype=torch.int64, device=x.device)
    elif digits_inner:
        out = torch.empty(lead + (plan.dnum, plan.nt, n), dtype=torch.int64, device=x.device)
    else:
        out = torch.empty((plan.dnum,) + lead + (plan.nt, n), dtype=torch.int64, device=x.device)
    if out.numel():
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.toyfhe_fbc(x.data_ptr(), out.data_ptr(), tab.data_ptr(), rows, plan.lt,
                                 plan.nt, plan.dnum, plan.alpha, n.bit_length() - 1,
                                 int(not premultiplied), int(digits_inner), int(out_of_group),
                                 stream)
        LIB.check(err, "CUDA fast base conversion")
        launches["fbc"] += 1
    if not out_of_group:
        return out
    views, at = [], 0
    for j, size in enumerate(sizes):
        views.append(out[at:at + size].view(lead + (plan.out_rows(j), n)))
        at += size
    return views
