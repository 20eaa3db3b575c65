"""Wrapper of the hand-written CUDA fused windowed key switch
(``csrc/keyswitch.cu``).

Replaces the TPU kernel ``toyfhe_tpu/ops/pallas_keyswitch.py::
FusedKeyswitch._call`` (K6, body ``_ks_kernel``). Its plain twin is
:func:`.pallas_keyswitch.fused_keyswitch_plain`, which it equals bit for
bit.

One kernel, the cluster kernel, which :func:`launch` runs: one thread-block
cluster of G blocks per (row, output limb) pair
(:func:`choose_cluster`), the digits dealt out over the blocks, each digit
built, twisted and transformed by register-radix DIF passes with the key
products in the last pass, the partial sums reduced across the cluster and
the two inverse transforms run side by side on the two halves of the
cluster (:func:`keyswitch_plan`). :func:`keyswitch_schedule` is its
schedule in plain torch, pass for pass and index for index, for the CPU
tests.

Built by ``nvcc`` from ``toyfhe_tpu_torch/csrc/keyswitch.cu`` at first use
(:mod:`.cuda_lib`). ``launches["k6"]`` counts the launches made through
:func:`launch`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from .cuda_lib import CI, VP, CudaLibrary
from .modmath import canonical_device
from .ntt_cuda import BLOCK_CAP, LAZY_PRIME_LIMIT, check_n, kernel_tables, pack_plan
from .ntt_cuda import schedule_plan, u32_table
from .ntt_pallas_cuda import (MIDDLE, _DifArith, _int64_tables, _lazy_flag,
                              _pass_positions, _stages_dif, closing_pass, dif_local_passes,
                              dit_local_passes, forward_plan)

LIB = CudaLibrary("keyswitch", {
    "toyfhe_keyswitch_cluster": ([VP] * 12 + [CI] * 11 + [VP], CI),
    "toyfhe_keyswitch_cluster_scratch_bytes": ([CI] * 4, ctypes.c_longlong),
    "toyfhe_keyswitch_cluster_attrs": ([CI] * 2 + [VP], CI),
})
launches = {"k6": 0}
CLUSTERS = (1, 2, 4, 8)          # blocks per (row, limb) pair the cluster kernel takes
MIN_BLOCK_N = 8                  # fewest positions one block of a half reduces
SMEM_PARTIALS_MAX_N = 1 << 14    # above it the partial rows live in device scratch
THREADS = 512                    # most threads a block runs


# ---------------------------------------------------------------------------
# the cluster kernel's launch plan (host side, shared with the schedule twin)
# ---------------------------------------------------------------------------

def half(cluster: int) -> int:
    """Blocks that share one inverse transform: half the cluster, at least 1."""
    return max(1, cluster // 2)


def legal_clusters(n: int, ndig: int) -> Tuple[int, ...]:
    """The cluster sizes the kernel takes at ring degree ``n`` with ``ndig``
    digits: every block gets a digit, and every block of a half reduces at
    least ``MIN_BLOCK_N`` positions."""
    return tuple(g for g in CLUSTERS if g <= ndig and n // half(g) >= MIN_BLOCK_N)


def choose_cluster(pairs: int, n: int, ndig: int, primes) -> Tuple[int, bool]:
    """``(G, lazy)`` for one launch of ``pairs`` (row, output limb) pairs: the
    largest legal G that keeps ``pairs * G`` within ``BLOCK_CAP`` blocks, so
    that a small launch spreads its digits over the card; one block a pair
    when the launch fills the card by itself. ``lazy`` needs every prime
    below 2^30."""
    lazy = max(int(p) for p in primes) < LAZY_PRIME_LIMIT
    fits = [g for g in legal_clusters(n, ndig) if pairs * g <= BLOCK_CAP]
    return max(fits + [1]), lazy


def keyswitch_plan(logn: int, cluster: int) -> dict:
    """The cluster kernel's passes at N = 2^logn: ``kl``, ``fwd`` the DIF
    passes of one digit over stage bits [3, logn) (:func:`.ntt_pallas_cuda.
    forward_plan`), the last pass with the key products over [0, 3); ``bwd``,
    ``kf`` the DIT passes and the closing pass of one inverse transform split
    over half the cluster (:func:`.ntt_cuda.schedule_plan`)."""
    if cluster not in CLUSTERS or logn < 4:
        raise ValueError(f"no K6 plan for a cluster of {cluster} at N = 2^{logn}")
    kl, fwd = forward_plan(logn)
    bwd, kf = schedule_plan(logn, half(cluster))
    return {"kl": kl, "fwd": fwd, "bwd": bwd, "kf": kf}


def acc_items(n: int) -> int:
    """Items of 8 positions whose accumulators a thread keeps in registers
    (0: the accumulators live in the block's partial rows)."""
    per = -(-(n // 8) // THREADS)
    return per if per <= 2 else 0


def block_shape(n: int) -> dict:
    """Threads and dynamic shared-memory bytes of one block, as the C
    launcher sets them: the digit row, and the two partial rows up to
    N = 2^14."""
    rows = 3 if n <= SMEM_PARTIALS_MAX_N else 1
    return {"threads": min(THREADS, max(32, n // 8)),
            "smem": 4 * rows * n}


# ---------------------------------------------------------------------------
# the schedule twin (plain torch, CPU tests)
# ---------------------------------------------------------------------------

def keyswitch_schedule(fk, c2p: torch.Tensor, c1e: torch.Tensor, cluster: int,
                       lazy: Optional[bool] = None):
    """The cluster kernel's schedule on CPU tensors (c2 primal int64
    [..., Lc, N], c1e bit-reversed dual [..., Lc + 1, N]): returns
    ``((out1, out2), largest intermediate value)``.

    Follows ``csrc/keyswitch.cu`` index for index: block g of the cluster
    takes the digits g, g + G, ...; builds each from c2's limb, twists it and
    runs the DIF passes of :func:`keyswitch_plan` on a row; in the
    last pass multiplies 8 neighbouring positions by the two key rows and
    adds into its partial rows; then block j of each half of the cluster
    sums the G partials of its positions (plus c1e on channel 1), runs the
    DIT passes, and the closing pass runs across the half with the untwist.
    ``lazy`` as the kernel's flag: ``None`` takes it whenever every prime is
    below 2^30."""
    fk.check(c2p, c1e)
    tables, n, logn = fk.pt.tables, fk.n, fk.logn
    if cluster not in legal_clusters(n, fk.ndig):
        raise ValueError(f"cluster size {cluster} is not legal for K6 at N = {n}")
    lazy = _lazy_flag(tables, lazy)
    plan = keyswitch_plan(logn, cluster)
    (psi, tw), (ipsi, itw) = _int64_tables(tables)
    ar = _DifArith(tables, lazy)
    lead, le = tuple(c2p.shape[:-2]), fk.Lc + 1
    c2b, c1b = c2p.reshape(-1, fk.Lc, n), c1e.reshape(-1, le, n)
    nb = c2b.shape[0]
    keys = fk.keys_on("cpu")
    r2 = torch.as_tensor(fk.pt.r2.astype(np.int64)).reshape(1, -1, 1, 1, 1)
    mask = (1 << fk.window) - 1
    kl = plan["kl"]
    low_l, pos_l = _pass_positions(logn, logn - kl, kl)
    low_m, pos_m = _pass_positions(logn, 0, MIDDLE)
    at_m = torch.as_tensor(pos_m)

    parts = torch.zeros((cluster, 2, nb, le, n), dtype=torch.int64)
    for g in range(cluster):
        for d in range(g, fk.ndig, cluster):
            dig = (c2b[:, d // fk.kpl] >> (fk.window * (d % fk.kpl))) & mask       # [B, N]
            regs = ar.see(ar.mul(dig[:, None, torch.as_tensor(pos_l)],
                                 psi[:, torch.as_tensor(pos_l)][None]))
            row = torch.zeros((nb, le, 1, n), dtype=torch.int64)
            row[..., torch.as_tensor(pos_l)] = _stages_dif(
                ar, regs[:, :, None], tw, logn - kl, kl, low_l)
            assert dif_local_passes(ar, [row], tw, logn, logn - kl, plan["fwd"]) == MIDDLE
            v = _stages_dif(ar, row[..., at_m], tw, 0, MIDDLE, low_m)
            x = ar.see(ar.mul(v, r2))                                              # Montgomery form
            for ch, name in enumerate(("maskeds", "masks")):
                key = keys[name][:, d][:, at_m][None, :, None]                     # [1, Le, 1, T, 8]
                acc = parts[g, ch][:, :, None][..., at_m]
                parts[g, ch][..., at_m] = ar.add(acc, ar.see(ar.mul(x, key)))[:, :, 0]

    nh = half(cluster)
    logh = nh.bit_length() - 1
    m = logn - logh
    q = np.arange(1 << m)
    outs = []
    for ch in range(2):
        srow = torch.zeros((nb, le, nh, 1 << m), dtype=torch.int64)
        for sub in range(nh):
            at = (sub << m) + q
            v = c1b[..., torch.as_tensor(at)] if ch == 0 else torch.zeros((nb, le, 1 << m),
                                                                           dtype=torch.int64)
            for b in range(cluster):
                v = ar.add(v, parts[b, ch][..., torch.as_tensor(at)])
            srow[:, :, sub, torch.as_tensor(q)] = v
        assert dit_local_passes(ar, srow, itw, m, 0, plan["bwd"]) == logn - plan["kf"]
        out = closing_pass(ar, srow, itw, ipsi, logn, logh, plan["kf"])
        outs.append(out.reshape(lead + (le, n)))
    return (outs[0], outs[1]), ar.max_seen


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------

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


def cluster_args(fk, pairs: int, cluster: Optional[int] = None,
                 lazy: Optional[bool] = None) -> tuple:
    """The C launcher's arguments after logn for one launch of the cluster
    kernel: (cluster, lazy, kl, packed DIF passes, packed DIT passes, kf).
    ``cluster`` / ``lazy`` override :func:`choose_cluster`."""
    g, lz = choose_cluster(pairs, fk.n, fk.ndig, fk.pt.primes)
    cluster = g if cluster is None else int(cluster)
    lazy = lz if lazy is None else bool(lazy)
    if cluster not in legal_clusters(fk.n, fk.ndig):
        raise ValueError(f"cluster size {cluster} is not legal for K6 at N = {fk.n} with "
                         f"{fk.ndig} digits")
    if lazy and not lz:
        raise ValueError("lazy butterflies need every prime below 2^30")
    plan = keyswitch_plan(fk.logn, cluster)
    return (cluster, int(lazy), plan["kl"], pack_plan(plan["fwd"]), pack_plan(plan["bwd"]),
            plan["kf"])


def launch(fk, c2p: torch.Tensor, c1e: torch.Tensor, cluster: Optional[int] = None,
           lazy: Optional[bool] = None):
    """(out1, out2) of ``fk`` for contiguous int64 CUDA tensors c2 primal
    [..., Lc, N] and c1e bit-reversed dual [..., Lc + 1, N] through the
    kernel. Raises on anything the kernel does not take.

    ``cluster`` / ``lazy`` override :func:`choose_cluster` (any legal cluster
    size; ``lazy=False`` is legal for every tower, ``lazy=True`` only below
    2^30)."""
    if c2p.device.type != "cuda" or c1e.device.type != "cuda":
        raise ValueError(f"the CUDA fused key switch takes CUDA tensors, got "
                         f"{c2p.device} / {c1e.device}")
    fk.check(c2p, c1e)
    check_n(fk.n)
    if not (c2p.is_contiguous() and c1e.is_contiguous()):
        raise ValueError("the CUDA fused key switch needs contiguous tensors")
    Le = fk.Lc + 1
    rows = c2p.numel() // (fk.Lc * fk.n)
    if rows * Le * max(CLUSTERS) >= 1 << 31:
        raise ValueError(f"{rows} rows exceed one launch grid")
    lib = LIB.load()
    kt = _tables(fk, c2p.device)
    plan_key = ("launch", rows, cluster, lazy)
    if plan_key not in fk._dev:            # the launcher's arguments, worked out once
        tail = cluster_args(fk, rows * Le, cluster, lazy)
        nbytes = lib.toyfhe_keyswitch_cluster_scratch_bytes(rows, fk.Lc, fk.logn, tail[0])
        fk._dev[plan_key] = (tail, nbytes)
    tail, nbytes = fk._dev[plan_key]
    out1 = torch.empty(c1e.shape, dtype=torch.int64, device=c2p.device)
    out2 = torch.empty_like(out1)
    scratch = torch.empty(nbytes // 4, dtype=torch.int32, device=c2p.device)
    (psi, fwd_tw), (ipsi, inv_tw) = kt["fwd"], kt["inv"]
    with torch.cuda.device(c2p.device):
        stream = torch.cuda.current_stream(c2p.device).cuda_stream
        err = lib.toyfhe_keyswitch_cluster(
            c2p.data_ptr(), c1e.data_ptr(), out1.data_ptr(), out2.data_ptr(), psi.data_ptr(),
            fwd_tw.data_ptr(), ipsi.data_ptr(), inv_tw.data_ptr(), kt["pnr"].data_ptr(),
            kt["masks"].data_ptr(), kt["maskeds"].data_ptr(),
            scratch.data_ptr() if nbytes else None, rows, fk.Lc, fk.window, fk.kpl, fk.logn,
            *tail, stream)
    LIB.check(err, "CUDA fused key switch")
    launches["k6"] += 1
    return out1, out2


def kernel_attrs(n: int, lazy: bool) -> dict:
    """Registers a thread and static shared memory of the instantiation of
    the cluster kernel that runs ring degree ``n``, as the CUDA runtime
    reports them (builds the library)."""
    buf = (ctypes.c_int * 2)()
    LIB.check(LIB.load().toyfhe_keyswitch_cluster_attrs(
        n.bit_length() - 1, int(lazy), ctypes.addressof(buf)), "K6 attributes")
    return {"registers": buf[0], "static_smem": buf[1]}
