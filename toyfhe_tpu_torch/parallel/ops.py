"""The CKKS step: homomorphic square → relinearize → rescale.

Port of ``toyfhe_tpu/parallel/ops.py`` on a batch of NTT-domain
ciphertexts: the per-limb RNS gadget (``_square_relin_rescale_local``;
``make_single_chip_step``, and ``make_sharded_step`` over a ('dp', 'rp')
mesh), the dnum-grouped hybrid gadget (``make_hybrid_sharded_step``: on one
device, optionally through the fused key switch K3, or over a mesh; the
fused schedule ``make_hybrid_fused_step`` and its sharded form), and the
('dp', 'rp', 'cp') step ``make_2axis_step``. Shapes stay static: the
rescale zeroes the dropped limb instead of removing it, so the output has
the input's shape ``[B, 2, L, N]``.

Over a mesh (:mod:`.sharding`) each rank runs the body on its block: the
limbs of its 'rp' coordinate, the batch rows of its 'dp' coordinate, and
with 'cp' its coefficient block. Cross-limb data moves at the reference's
two sites, each one all-gather over 'rp': the key switch's digit share
and the rescale's dropped-limb row. The raising primes of the hybrid
gadget are replicated on every rank, so its P-division needs no
collective. A rank transforms its limbs with their own tables
(``NttTables.select``), cut once when the step is built.

On one device each builder returns its step compiled, as the reference's
``jax.jit``: :func:`..utils.graphs.jit` replays a CUDA graph of the step on
CUDA inputs (and runs it eagerly on CPU inputs); ``eager=True`` returns the
plain step. The steps over a mesh stay eager: gloo collectives cannot be
captured.

The transforms go through :func:`..ops.ntt.ntt` / :func:`..ops.ntt.intt`:
the CUDA kernel K1 for CUDA tensors, the plain radix-2 version for CPU
tensors (the coefficient-sharded four-step is plain torch on the digit
products of :mod:`..ops.ntt_mxu`). Each hybrid step's digit decomposition
goes through :func:`..ops.fbc_cuda.fbc` with a plan over the target rows it
holds (the CUDA kernel for CUDA tensors); the fused schedule's key
products go through :func:`..ops.keyprod_cuda.key_products`, while the
per-limb and the sharded steps keep their torch product and sum. Everything
else is elementwise modular arithmetic in plain torch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.hybrid import _mont_col
from ..core.rlwe import _hybrid_key_stack
from ..ops import fbc_cuda, keyprod_cuda, modmath, ntt as nttmod
from ..ops.modmath import MontParams
from ..utils import graphs
from . import sharding as S
from .sharding import Mesh

DATA_SPEC = ("dp", None, "rp", None)       # [B, 2, L, N] ciphertext batches


def full_table_pytree(tables: nttmod.NttTables, device) -> dict:
    """The ring's constants as a plain dict of ``int64`` tensors on
    ``device``: the NTT tables of :meth:`NttTables.on` plus the remaining
    Montgomery constants."""
    d = dict(tables.on(device))
    mp = tables.mp.on(device)
    d.update(ninv=mp.ninv, r2=mp.r2, r1=mp.r1, half=mp.half)
    return d


def _mp_full(tabs: dict) -> MontParams:
    return MontParams(p=tabs["p"], ninv=tabs["ninv"], r2=tabs["r2"],
                      r1=tabs["r1"], half=tabs["half"], rinv=tabs["rinv"])


def _zero_dropped(res: torch.Tensor, mesh) -> torch.Tensor:
    """Zero the global last limb row, which the last shard along 'rp' holds
    as its last local row."""
    if mesh is None or mesh.index("rp") == mesh.shape["rp"] - 1:
        res[..., -1, :] = 0
    return res


def _global_last(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global last limb row of x [..., L_loc, N]: on a mesh, one
    all-gather over 'rp' of each rank's last local row (the rescale's site)."""
    last = x[..., -1:, :]
    if mesh is None:
        return last
    return S.all_gather(last, mesh, "rp", -2, "rescale_broadcast")[..., -1:, :]


def _square_relin_rescale_local(c, key_masks, key_maskeds, rescale_inv, tabs,
                                tables, mesh: Mesh = None):
    """Square → relinearize → rescale on ciphertext duals.

    With ``mesh`` this is a rank's body over the 'rp' limb axis;
    without, the single-device step (the collectives are identities).
    Per-rank shapes:
      c:            int64[B, 2, L_loc, N]   ciphertext duals
      key_masks:    int64[L, L_loc, N]      relin key mask duals (digit-major)
      key_maskeds:  int64[L, L_loc, N]
      rescale_inv:  int64[L_loc, 1]         (q_last^{-1} mod q_j, Montgomery; 0 for the last limb)
      tabs:         :func:`full_table_pytree` of the local limbs on c's device
      tables:       the local limbs' :class:`NttTables`, which route the transforms
    Returns int64[B, 2, L_loc, N] rescaled ciphertext duals with the dropped
    limb zeroed.
    """
    fwd = lambda v: nttmod.ntt(tables, v)
    inv = lambda v: nttmod.intt(tables, v)
    mp = _mp_full(tabs)
    c1, c2 = c[:, 0], c[:, 1]
    # --- homomorphic square: tensor product ---
    d1 = modmath.mul_mod(c1, c1, mp)
    mid = modmath.mul_mod(c1, c2, mp)
    d2 = modmath.add_mod(mid, mid, mp)
    d3 = modmath.mul_mod(c2, c2, mp)

    # --- relinearize d3 back onto (d1, d2) ---
    lifts = modmath.centered(inv(d3), mp)                   # signed [B, L_loc, N]
    if mesh is not None:                                    # every limb's lift, everywhere
        lifts = S.all_gather(lifts, mesh, "rp", 1, "keyswitch_digit_share")
    digs = fwd(modmath.from_signed(lifts[..., :, None, :], mp))   # [B, L, L_loc, N]
    acc1 = modmath.mod_sum(modmath.mul_mod(digs, key_maskeds, mp), mp, axis=-3)
    acc2 = modmath.mod_sum(modmath.mul_mod(digs, key_masks, mp), mp, axis=-3)
    r1 = modmath.add_mod(d1, acc1, mp)
    r2 = modmath.add_mod(d2, acc2, mp)
    outp = inv(torch.stack([r1, r2], dim=1))                # [B, 2, L_loc, N]

    # --- rescale by the global last limb, static shapes ---
    last_mod = modmath.umod(_global_last(outp, mesh), mp.p)
    res = modmath.mont_mul(modmath.sub_mod(outp, last_mod, mp), rescale_inv, mp)
    return fwd(_zero_dropped(res, mesh))


def rescale_inverses(primes) -> np.ndarray:
    """q_last^{-1} mod q_j in Montgomery form per limb, 0 for the last."""
    qk = primes[-1]
    return np.array([[pow(qk, -1, p) * (1 << 32) % p if p != qk else 0]
                     for p in primes], dtype=np.int64)


def _compiled(step, eager: bool, name: str):
    return step if eager else graphs.jit(step, name=name)


def make_single_chip_step(tables: nttmod.NttTables, key_masks: torch.Tensor,
                          key_maskeds: torch.Tensor, eager: bool = False):
    """The square→relin→rescale step on the keys' device, compiled unless
    ``eager``.

    ``key_masks`` / ``key_maskeds`` are the relinearization key stacks
    int64[L, L, N] (dual domain, digit-major). Returns ``step(c)`` on
    int64[B, 2, L, N] ciphertext duals on the same device.
    """
    device = key_masks.device
    if key_maskeds.device != device:
        raise ValueError("key stacks on different devices")
    tabs = full_table_pytree(tables, device)
    rescale_inv = modmath.as_residues(rescale_inverses(tables.primes), device)

    def step(c: torch.Tensor) -> torch.Tensor:
        return _square_relin_rescale_local(c, key_masks, key_maskeds,
                                           rescale_inv, tabs, tables)

    return _compiled(step, eager, "single_chip_step")


def make_sharded_step(mesh: Mesh, tables: nttmod.NttTables, key_masks, key_maskeds):
    """The square→relin→rescale step over a ('dp', 'rp') mesh: batch rows on
    'dp', limbs on 'rp'.

    ``key_masks`` / ``key_maskeds``: the global relinearization key stacks
    [L, L, N] (tensors or host arrays). Returns ``(step, place)``:
    ``place(x)`` cuts this rank's block of a global batch [B, 2, L, N]
    (:data:`DATA_SPEC`) onto ``mesh.device``, ``step(block)`` returns the
    rank's block of the result; :func:`.sharding.unshard` with
    :data:`DATA_SPEC` assembles the global tensor. The rank's tables and
    key blocks are cut here, once."""
    device = mesh.device
    local = tables.select(S.limb_rows(len(tables.primes), mesh))
    tabs = full_table_pytree(local, device)
    km = S.shard(key_masks, (None, "rp", None), mesh)
    kd = S.shard(key_maskeds, (None, "rp", None), mesh)
    rescale_inv = S.shard(rescale_inverses(tables.primes), ("rp", None), mesh)

    def step(c: torch.Tensor) -> torch.Tensor:
        return _square_relin_rescale_local(c, km, kd, rescale_inv, tabs, local, mesh)

    return step, lambda x: S.shard(x, DATA_SPEC, mesh)


def _square_relin_rescale_2axis(c, key_masks, key_maskeds, rescale_inv, ctabs, mesh: Mesh):
    """A rank's body of square → relinearize → rescale with the limbs on
    'rp' and the coefficients on 'cp' (the four-step layout).

    Per-rank shapes (C_r limb shards × C_c coefficient shards):
      c:           int64[B, 2, L/C_r, N/C_c]  ciphertext duals in the
                   four-step output layout (``coeff_shard_layout``'s out_nat)
      key_*:       int64[L, L/C_r, N/C_c]     key duals, same layout
      rescale_inv: int64[L/C_r, 1]
      ctabs:       the rank's block of ``mxu_table_pytree``
    Collectives a step: one all-to-all over 'cp' per four-step transform
    (two inverse, two forward) and the 1-axis step's two all-gathers over
    'rp' at 1/C_c the row length."""
    mpl = S._mp_local(ctabs)
    c1, c2 = c[:, 0], c[:, 1]
    # --- homomorphic square, pointwise local ---
    d1 = modmath.mul_mod(c1, c1, mpl)
    mid = modmath.mul_mod(c1, c2, mpl)
    d2 = modmath.add_mod(mid, mid, mpl)
    d3 = modmath.mul_mod(c2, c2, mpl)

    # --- relinearize d3 onto (d1, d2) ---
    d3p = S.mxu2_intt_local(d3, ctabs, mesh, "cp", "ntt_d3_exchange")
    lifts = S.all_gather(modmath.centered(d3p, mpl), mesh, "rp", 1,
                         "keyswitch_digit_share")           # [B, L, N_loc]
    digs = S.mxu2_ntt_local(modmath.from_signed(lifts[..., :, None, :], mpl), ctabs, mesh,
                            "cp", "ntt_digit_exchange")      # [B, L, L_loc, N_loc]
    acc1 = modmath.mod_sum(modmath.mul_mod(digs, key_maskeds, mpl), mpl, axis=-3)
    acc2 = modmath.mod_sum(modmath.mul_mod(digs, key_masks, mpl), mpl, axis=-3)
    out = torch.stack([modmath.add_mod(d1, acc1, mpl), modmath.add_mod(d2, acc2, mpl)], dim=1)

    # --- rescale by the global last limb ---
    outp = S.mxu2_intt_local(out, ctabs, mesh, "cp", "ntt_out_exchange")
    last_mod = modmath.umod(_global_last(outp, mesh), mpl.p)
    res = modmath.mont_mul(modmath.sub_mod(outp, last_mod, mpl), rescale_inv, mpl)
    return S.mxu2_ntt_local(_zero_dropped(res, mesh), ctabs, mesh, "cp", "ntt_result_exchange")


def make_2axis_step(mesh: Mesh, mxu_tables, key_masks, key_maskeds, n_cp: int,
                    dp: bool = False):
    """The ('rp' × 'cp') sharded square→relin→rescale step; with ``dp`` the
    mesh also has a 'dp' axis and the batch is sharded over it.

    ``key_masks`` / ``key_maskeds``: the global [L, L, N] duals in natural
    order (re-laid here into the four-step output layout). Returns
    ``(step, place, (in_src, out_nat))``: ``place(x)`` cuts this rank's
    block of a natural-order batch [B, 2, L, N] in the output layout,
    ``step`` maps blocks to blocks, and :func:`.sharding.unshard` with the
    same spec gives the global batch in the output layout (``out_nat``
    maps it back to natural order)."""
    if mesh.shape.get("cp") != n_cp:
        raise ValueError(f"n_cp={n_cp} on a mesh of {mesh.shape}")
    mt = mxu_tables
    ctabs = S.shard_tree(S.mxu_table_pytree(mt, n_cp, "cpu"), S.mxu_table_specs(), mesh)
    in_src, out_nat = S.coeff_shard_layout(mt.n, mt.n2, n_cp)
    relay = lambda x: (x.cpu() if torch.is_tensor(x) else modmath.as_residues(x, "cpu"))[
        ..., torch.as_tensor(out_nat)]
    key_spec = (None, "rp", "cp")
    km = S.shard(relay(key_masks), key_spec, mesh)
    kd = S.shard(relay(key_maskeds), key_spec, mesh)
    rescale_inv = S.shard(rescale_inverses(mt.primes), ("rp", None), mesh)
    data_spec = ("dp" if dp else None, None, "rp", "cp")

    def step(c: torch.Tensor) -> torch.Tensor:
        return _square_relin_rescale_2axis(c, km, kd, rescale_inv, ctabs, mesh)

    def place(x):
        """This rank's block of natural-dual-order cts [B, 2, L, N]."""
        return S.shard(relay(x), data_spec, mesh)

    return step, place, (in_src, out_nat)


# ---------------------------------------------------------------------------
# the hybrid (dnum-gadget) step
# ---------------------------------------------------------------------------

def _concat_tabs(a: dict, b: dict) -> dict:
    """Concatenate two :func:`full_table_pytree` dicts along the limb axis
    (ct tower ++ raising primes)."""
    out = {k: torch.cat([a[k], b[k]], 0)
           for k in ("p", "ninv", "psi_pow", "psi_ipow", "r2", "r1", "half", "rinv")}
    out["tw"] = tuple(torch.cat([x, y], 0) for x, y in zip(a["tw"], b["tw"]))
    out["twi"] = tuple(torch.cat([x, y], 0) for x, y in zip(a["twi"], b["twi"]))
    out["bitrev"] = a["bitrev"]
    return out


def _rem_mp(tabs: dict, stabs: dict, sp_keep: int) -> MontParams:
    """MontParams over the ct limbs ++ the first ``sp_keep`` specials."""
    if not sp_keep:
        return _mp_full(tabs)
    cat = lambda k: torch.cat([tabs[k], stabs[k][:sp_keep]], 0)
    return MontParams(p=cat("p"), ninv=cat("ninv"), r2=cat("r2"), r1=cat("r1"),
                      half=cat("half"), rinv=cat("rinv"))


def _square_relin_rescale_hybrid(c, km, kd, yinv, plan, rinv_rows, rescale_inv, mps, tables,
                                 fks=None, mesh: Mesh = None):
    """Square → hybrid (dnum-grouped) relinearize → rescale on ct duals.

    The reference body. The reference splits every operand into ct rows and
    replicated special rows; here they come joined over the expanded tower
    T = L_loc + k (the rank's ct limbs, then the k specials every rank
    holds), and the constant sets the reference concatenates in its body
    (:func:`_concat_tabs`, :func:`_rem_mp`) are made once by the builder.
    With ``mesh`` it is a rank's body over the 'rp' limb axis: one
    all-gather shares the ŷ residues, every rank contracts its own target
    rows, and the final rescale gathers the dropped limb's row.

      c:           int64[B, 2, L_loc, N]   ciphertext duals
      km / kd:     int64[ndig, T, N]   key mask / masked duals
      yinv:        int64[L_loc, 1]     ŷ premultipliers (Montgomery), the
                                       rank's rows of ``plan.inv``
      plan:        the :class:`..ops.fbc_cuda.FbcPlan` of the ct tower into
                   the T target rows
      rinv_rows[s]: int64[T-1-s, 1]    p_drop^{-1} at contraction step s
      rescale_inv: int64[L_loc, 1]     final data-prime rescale (0 last)
      mps:         MontParams: "ct", "exp" (expanded), "rem" (per s)
      tables:      (ct NttTables, expanded NttTables): routes the transforms
      fks:         a :class:`..ops.hybrid_ks.FusedHybridKS` replaces the
                   digit pipeline (FBC → NTT → key contraction) with K3
                   (one device only)
    Returns int64[B, 2, L_loc, N] rescaled duals with the dropped limb zeroed.
    """
    ct_tables, exp_tables = tables
    mp, mpe = mps["ct"], mps["exp"]
    c1, c2 = c[:, 0], c[:, 1]
    # --- homomorphic square ---
    d1 = modmath.mul_mod(c1, c1, mp)
    mid = modmath.mul_mod(c1, c2, mp)
    d2 = modmath.add_mod(mid, mid, mp)
    d3 = modmath.mul_mod(c2, c2, mp)

    # --- hybrid relinearize d3 onto (d1, d2) ---
    y = modmath.mont_mul(nttmod.intt(ct_tables, d3), yinv, mp)   # [B, L_loc, N]
    if mesh is not None:                                    # every group's ŷ, everywhere
        y = S.all_gather(y, mesh, "rp", 1, "keyswitch_digit_share")
    if fks is not None:
        acc1, acc2 = fks(y)
    else:
        digs = nttmod.ntt(exp_tables, fbc_cuda.fbc(plan, y, premultiplied=True,
                                                   digits_inner=True))   # [B, ndig, T, N]
        acc1 = modmath.mod_sum(modmath.mul_mod(digs, kd, mpe), mpe, axis=-3)
        acc2 = modmath.mod_sum(modmath.mul_mod(digs, km, mpe), mpe, axis=-3)

    # --- contract: divide the accumulator by P (k rescales) ---
    a = nttmod.intt(exp_tables, torch.stack([acc1, acc2], dim=1))  # [B, 2, T, N]
    for mp_rem, inv_row in zip(mps["rem"], rinv_rows):
        last = modmath.umod(a[..., -1:, :], mp_rem.p)
        a = modmath.mont_mul(modmath.sub_mod(a[..., :-1, :], last, mp_rem),
                             inv_row, mp_rem)
    out = modmath.add_mod(nttmod.intt(ct_tables, torch.stack([d1, d2], dim=1)), a, mp)

    # --- final rescale by the last data limb, static shapes ---
    last_mod = modmath.umod(_global_last(out, mesh), mp.p)
    res = modmath.mont_mul(modmath.sub_mod(out, last_mod, mp), rescale_inv, mp)
    return nttmod.ntt(ct_tables, _zero_dropped(res, mesh))


def _placer(device):
    """place(x): residues (array or tensor) as an int64 tensor on ``device``."""
    def place(x):
        if torch.is_tensor(x):
            return x.to(device=device, dtype=torch.int64)
        return modmath.as_residues(x, device)
    return place


def make_hybrid_sharded_step(mesh, params, ek, fused: bool = False,
                             fused_schedule: bool = False, ct_ring=None, dp: bool = True,
                             eager: bool = False):
    """The square→relin→rescale step for a HybridRaised parameter set, on
    the device of the eval key ``ek`` (an EvalMultKey), or over ``mesh``.

    Returns (step, place): step(c[B, 2, Lc, N] duals) → same shape, dropped
    limb zeroed; place(x) puts an array on the step's device (over a mesh:
    cuts this rank's block, limbs on 'rp' and, with ``dp``, the batch on
    'dp'; the step then maps blocks to blocks and
    :func:`.sharding.unshard` with the same spec assembles them).
    ``fused=True`` runs the digit pipeline through the fused key switch K3
    (:class:`..ops.hybrid_ks.FusedHybridKS`) on one device; over a mesh it
    is ignored, as in the reference, whose K3 runs only without one.
    ``fused_schedule=True`` runs the fused transform schedule
    (:func:`make_hybrid_fused_step` on one device). ``ct_ring`` (default:
    the full ct tower) runs the step on a shortened tower, as the MNIST
    square layers do — an addition of the port, so that every flavour runs
    at those levels. On one device the step is compiled unless ``eager``."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a sharding.Mesh or None, got {type(mesh).__name__}")
    if fused_schedule:
        if mesh is None:
            return make_hybrid_fused_step(params, ek, ct_ring, eager=eager)
        return _make_hybrid_fused_sharded_step(mesh, params, ek, ct_ring, dp)

    ct_ring = ct_ring if ct_ring is not None else params.ring_cipher
    Lc, k = ct_ring.nlimbs, params.num_special
    exp_ring, eng_groups = params._tables(Lc)
    km, kd = _hybrid_key_stack(params, ek.key, exp_ring, len(eng_groups))
    device = km.device if mesh is None else mesh.device
    rows = list(range(Lc)) if mesh is None else S.limb_rows(Lc, mesh)
    sp = list(range(Lc, Lc + k))
    erows = rows + sp                                       # the rank's expanded rows
    col = lambda a, which: modmath.as_residues(np.asarray(a)[which], device)

    plan = fbc_cuda.make_plan(eng_groups, ct_ring.mp, exp_ring.select(erows).mp, erows)
    yinv = col(plan.inv, rows)
    if mesh is not None:
        km, kd = km[:, erows].to(device), kd[:, erows].to(device)

    # contraction step s drops the last remaining prime of the expanded
    # tower: its inverse mod the ct primes ++ the surviving specials
    rinv_rows = []
    cur = list(exp_ring.primes)
    for s in range(k):
        drop, cur = cur[-1], cur[:-1]
        rinv_rows.append(col(_mont_col([pow(drop, -1, p) for p in cur], cur),
                             rows + sp[:k - s - 1]))
    qk = ct_ring.primes[-1]
    rescale_inv = col(_mont_col([pow(qk, -1, p) if p != qk else 0
                                 for p in ct_ring.primes], ct_ring.primes), rows)

    loc_ring = ct_ring if mesh is None else ct_ring.select(rows)
    sp_ring = exp_ring.select(sp)
    tabs = full_table_pytree(loc_ring.tables, device)
    stabs = full_table_pytree(sp_ring.tables, device)
    mpe = _mp_full(_concat_tabs(tabs, stabs))
    mps = {"ct": _mp_full(tabs), "exp": mpe,
           "rem": tuple(_rem_mp(tabs, stabs, k - s - 1) for s in range(k))}
    fks = None
    if fused and mesh is None:
        from ..ops.hybrid_ks import FusedHybridKS
        fks = FusedHybridKS(params, ek, lt=Lc)
    tables = (loc_ring.tables, (exp_ring if mesh is None else exp_ring.select(erows)).tables)

    def step(c: torch.Tensor) -> torch.Tensor:
        return _square_relin_rescale_hybrid(c, km, kd, yinv, plan, rinv_rows, rescale_inv, mps,
                                            tables, fks, mesh)

    if mesh is None:
        return _compiled(step, eager, "hybrid_step_fused_k3" if fused else "hybrid_step"), \
            _placer(device)
    return step, _mesh_placer(mesh, dp)


def _mesh_placer(mesh: Mesh, dp: bool):
    spec = DATA_SPEC if dp else (None,) + DATA_SPEC[1:]
    return lambda x: S.shard(x, spec, mesh)


def _make_hybrid_fused_sharded_step(mesh: Mesh, params, ek, ct_ring, dp: bool):
    """The fused transform schedule over a mesh: the reference's
    ``_square_relin_rescale_hybrid_fused`` as a rank's body, bit-identical
    to :func:`make_hybrid_fused_step`.

    Per rank: each local ct row is transformed for the ndig − 1 digits that
    do not own it (the owning digit's row is d3's own dual row); the
    replicated special accumulator rows alone are inverse-transformed and
    their P-division unrolled into lifts l_1..l_k; l_0 comes from a one-row
    inverse transform of the global last data row (one all-gather, the
    rescale's site); every correction folds into one transform of the local
    rows. The owning digit of each local row (``g_idx``) and the others
    (``dig_idx``) differ per rank and are cut here."""
    ct_ring = ct_ring if ct_ring is not None else params.ring_cipher
    Lc, k = ct_ring.nlimbs, params.num_special
    exp_ring, eng_groups = params._tables(Lc)
    ndig = len(eng_groups)
    device = mesh.device
    rows = S.limb_rows(Lc, mesh)
    sp = list(range(Lc, Lc + k))
    col = lambda a, which=None: modmath.as_residues(
        np.asarray(a) if which is None else np.asarray(a)[which], device)
    km, kd = _hybrid_key_stack(params, ek.key, exp_ring, ndig)
    km, kd = km[:, rows + sp].to(device), kd[:, rows + sp].to(device)

    plan = fbc_cuda.make_plan(eng_groups, ct_ring.mp, exp_ring.select(rows + sp).mp, rows + sp)
    yinv = col(plan.inv, rows)
    g_idx = np.zeros(Lc, np.int64)
    for j, (lo, hi) in enumerate(plan.bounds):
        g_idx[lo:hi] = j
    g_loc = g_idx[rows]
    # [1, ndig-1, L_loc, 1] the non-owning digits of each local row, ascending
    dig_idx = torch.as_tensor(np.stack([[j for j in range(ndig) if j != g] for g in g_loc], 1)
                              .reshape(1, ndig - 1, len(rows), 1), device=device)
    jj = np.arange(ndig)[:, None]
    back_idx = torch.as_tensor(np.clip(jj - (jj > g_loc[None]), 0, max(ndig - 2, 0))
                               .reshape(1, ndig, len(rows), 1), device=device)
    own = torch.as_tensor((jj == g_loc[None]).reshape(1, ndig, len(rows), 1), device=device)

    spp = exp_ring.primes[Lc:]
    ctp = ct_ring.primes
    qL = ctp[-1]
    P = params.P
    cols = lambda f: col(_mont_col([f(p) if p != qL else 0 for p in ctp], ctp), rows)
    A = cols(lambda p: pow((P * qL) % p, -1, p))
    Bw = cols(lambda p: pow(qL % p, -1, p))
    prods = [math.prod(spp[: k - s]) for s in range(k)]
    W = tuple(cols(lambda p, pr=pr: pow((pr * qL) % p, -1, p)) for pr in prods)
    pinv_L = col(_mont_col([pow(P % qL, -1, qL)], [qL]))
    wL = tuple(col(_mont_col([pow(pr % qL, -1, qL)], [qL])) for pr in prods)
    dinvs = tuple(col(_mont_col([pow(spp[k - s] % p, -1, p) for p in spp[: k - s]],
                                spp[: k - s])) for s in range(1, k))

    loc_ring = ct_ring.select(rows)
    sp_ring = exp_ring.select(sp)
    last_ring = ct_ring.select([Lc - 1])
    mp = loc_ring.mp.on(device)
    mp_e = exp_ring.select(rows + sp).mp.on(device)
    mp_last = last_ring.mp.on(device)
    mp_first = {m: sp_ring.mp.select(range(m)).on(device) for m in range(1, k)}
    L_loc = len(rows)

    def step(c: torch.Tensor) -> torch.Tensor:
        c1, c2 = c[:, 0], c[:, 1]
        # --- homomorphic square ---
        d1 = modmath.mul_mod(c1, c1, mp)
        mid = modmath.mul_mod(c1, c2, mp)
        d2 = modmath.add_mod(mid, mid, mp)
        d3 = modmath.mul_mod(c2, c2, mp)

        # --- digit decomposition: local INTT + premultiply, one all-gather ---
        y = modmath.mont_mul(nttmod.intt(loc_ring.tables, d3), yinv, mp)
        y = S.all_gather(y, mesh, "rp", 1, "keyswitch_digit_share")     # [B, Lc, N]

        # --- FBC onto the local target rows (ct rows + replicated specials) ---
        digits = fbc_cuda.fbc(plan, y, premultiplied=True, digits_inner=True)
        fbc_ct, fbc_sp = digits[..., :L_loc, :], digits[..., L_loc:, :]   # [B, ndig, ., N]

        # --- in-group reuse: transform only the non-owning digits of each row ---
        B, n = c.shape[0], c.shape[-1]
        if ndig == 1:
            digs_ct = d3[:, None]
        else:
            sel = torch.gather(fbc_ct, 1, dig_idx.expand(B, ndig - 1, L_loc, n))
            tf = nttmod.ntt(loc_ring.tables, sel)           # [B, ndig-1, L_loc, N]
            back = torch.gather(tf, 1, back_idx.expand(B, ndig, L_loc, n))
            digs_ct = torch.where(own, d3[:, None], back)
        digs = torch.cat([digs_ct, nttmod.ntt(sp_ring.tables, fbc_sp)], dim=-2)

        # --- key contraction over the local target rows ---
        acc1 = modmath.mod_sum(modmath.mul_mod(digs, kd, mp_e), mp_e, axis=-3)
        acc2 = modmath.mod_sum(modmath.mul_mod(digs, km, mp_e), mp_e, axis=-3)
        acc = torch.stack([acc1, acc2], dim=1)              # [B, 2, L_loc + k, N]
        d12 = torch.stack([d1, d2], dim=1)                  # [B, 2, L_loc, N]

        # --- ModDown lifts from the replicated special rows only ---
        spr = nttmod.intt(sp_ring.tables, acc[..., L_loc:, :])   # [B, 2, k, N]
        lifts = []
        for s in range(k):
            l = spr[..., -1:, :]
            lifts.append(l)
            spr = spr[..., :-1, :]
            if spr.shape[-2]:
                mp_rem = mp_first[spr.shape[-2]]
                spr = modmath.mont_mul(modmath.sub_mod(spr, modmath.umod(l, mp_rem.p), mp_rem),
                                       dinvs[s], mp_rem)

        # --- l_0: raw residue of (acc/P + d) mod q_L from the global last row ---
        last_loc = torch.cat([acc[..., L_loc - 1:L_loc, :], d12[..., -1:, :]], dim=1)
        last_p = nttmod.intt(last_ring.tables, _global_last(last_loc, mesh))   # [B, 4, 1, N]
        accL, dL = last_p[:, :2], last_p[:, 2:]
        bL = modmath.mont_mul(accL, pinv_L, mp_last)
        for s in range(k):
            bL = modmath.sub_mod(bL, modmath.mont_mul(modmath.umod(lifts[s], mp_last.p),
                                                      wL[s], mp_last), mp_last)
        l0 = modmath.add_mod(bL, dL, mp_last)               # [B, 2, 1, N]

        # --- one combined-correction transform over the local rows ---
        D = modmath.mont_mul(modmath.umod(l0, mp.p), Bw, mp)
        for s in range(k):
            D = modmath.add_mod(D, modmath.mont_mul(modmath.umod(lifts[s], mp.p), W[s], mp), mp)
        Dd = nttmod.ntt(loc_ring.tables, D)                 # [B, 2, L_loc, N]
        out = modmath.sub_mod(modmath.add_mod(modmath.mont_mul(acc[..., :L_loc, :], A, mp),
                                              modmath.mont_mul(d12, Bw, mp), mp), Dd, mp)
        return _zero_dropped(out, mesh)

    return step, _mesh_placer(mesh, dp)


def make_hybrid_fused_step(params, ek, ct_ring=None, merge_calls: bool = True,
                           eager: bool = False):
    """Single-device square → hybrid relinearize → rescale with the fused
    transform schedule — bit-identical to :func:`make_hybrid_sharded_step`
    and to the engine, with fewer limb transforms:

      * in-group digit rows reuse d3's own dual rows (D_j ≡ d3 mod q_i for
        i in group j);
      * the P-division runs in the dual domain: only the k special
        accumulator rows are inverse-transformed, the sequential rescales
        unroll into lifts l_1..l_k on those rows, and all corrections plus
        the final data-limb rescale fold into one ct-tower NTT —
        final ≡ acc·(P·q_L)⁻¹ + d·q_L⁻¹ − NTT(Σ_s l_s·w_s·q_L⁻¹ +
        l_0·q_L⁻¹), with l_0 the raw residue of (acc/P + d) mod q_L from a
        single-row INTT;
      * d1, d2 never leave the dual domain.

    ``merge_calls=True`` computes the FBC only for the out-of-group rows,
    transforms every group's digit rows in one call and merges the special
    and last-data-row inverse transforms into one call (derived towers with
    repeated primes). Returns (step, place) as
    :func:`make_hybrid_sharded_step`, the step compiled unless ``eager``.
    """
    ct_ring = ct_ring if ct_ring is not None else params.ring_cipher
    L, k = ct_ring.nlimbs, params.num_special
    exp_ring, eng_groups = params._tables(L)
    T = exp_ring.nlimbs
    sp_ring = exp_ring.select(range(L, T))
    last_ring = ct_ring.select([L - 1])
    surv_ring = ct_ring.select(range(L - 1))

    km, kd = _hybrid_key_stack(params, ek.key, exp_ring, len(eng_groups))  # [ndig, T, N]
    device = km.device
    col = lambda a: modmath.as_residues(a, device)

    # --- the FBC's plan + each group's out-of-group transform tables ---
    plan = fbc_cuda.make_plan(eng_groups, ct_ring.mp, exp_ring.mp, range(T))
    bounds = plan.bounds
    grp_out, all_out, seg = [], [], []
    for (lo, hi) in bounds:
        oidx = list(range(lo)) + list(range(hi, T))
        grp_out.append(exp_ring.select(oidx).tables)
        seg.append((len(all_out), len(oidx)))
        all_out += oidx
    # merged-call schedule: every group's out-of-group digit rows ride one
    # transform call (rows repeat across groups) and the k-special +
    # last-data-row inverse transforms merge
    cat_tabs = exp_ring.select(tuple(all_out)).tables
    mix_tabs = exp_ring.select(tuple(range(L, T)) * 2 + (L - 1,) * 4).tables

    # --- fold constants (Montgomery columns) ---
    spp = sp_ring.primes
    qL = ct_ring.primes[-1]
    surv = surv_ring.primes
    P = params.P
    A = col(_mont_col([pow((P * qL) % p, -1, p) for p in surv], surv))
    Bw = col(_mont_col([pow(qL % p, -1, p) for p in surv], surv))
    prods = [math.prod(spp[: k - s]) for s in range(k)]
    W = tuple(col(_mont_col([pow((pr * qL) % p, -1, p) for p in surv], surv))
              for pr in prods)
    pinv_L = col(_mont_col([pow(P % qL, -1, qL)], [qL]))
    wL = tuple(col(_mont_col([pow(pr % qL, -1, qL)], [qL])) for pr in prods)
    dinvs = tuple(col(_mont_col([pow(spp[k - s] % p, -1, p) for p in spp[: k - s]],
                                spp[: k - s]))
                  for s in range(1, k))

    mp_ct = ct_ring.mp.on(device)
    mp_sp = sp_ring.mp
    mp_rems = {m: mp_sp.select(range(m)).on(device) for m in range(1, k)}
    mp_last = last_ring.mp.on(device)
    mp_surv = surv_ring.mp.on(device)

    def step(c: torch.Tensor) -> torch.Tensor:
        c1, c2 = c[:, 0], c[:, 1]
        # --- homomorphic square ---
        d1 = modmath.mul_mod(c1, c1, mp_ct)
        mid = modmath.mul_mod(c1, c2, mp_ct)
        d2 = modmath.add_mod(mid, mid, mp_ct)
        d3 = modmath.mul_mod(c2, c2, mp_ct)

        # --- digits: FBC + NTT of out-of-group rows, d3 rows in-group ---
        d3p = nttmod.intt(ct_ring.tables, d3)               # [B, L, N]
        outs = fbc_cuda.fbc(plan, d3p, out_of_group=True)   # [B, T - w_j, N] each
        if merge_calls:
            res_all = nttmod.ntt(cat_tabs, torch.cat(outs, dim=-2))
            outs = [res_all[..., off:off + ln, :] for off, ln in seg]
        else:
            outs = [nttmod.ntt(otabs, o) for otabs, o in zip(grp_out, outs)]
        digs = [torch.cat([res[..., :lo, :], d3[..., lo:hi, :], res[..., lo:, :]], dim=-2)
                for (lo, hi), res in zip(bounds, outs)]
        digs = torch.stack(digs, dim=-3)                    # [B, ndig, T, N]
        acc = keyprod_cuda.key_products(digs, km, kd, exp_ring.mp,
                                        digits_inner=True).movedim(0, 1)   # [B, 2, T, N]
        d12 = torch.stack([d1, d2], dim=1)                  # [B, 2, L, N]

        # --- fused ModDown lifts from the special rows only ---
        B = acc.shape[0]
        if merge_calls:
            # one INTT over [sp rows]×2 comps + the last data row ×4
            mix_in = torch.cat([acc[..., L:, :].reshape(B, 2 * k, -1),
                                acc[..., L - 1:L, :].reshape(B, 2, -1),
                                d12[..., L - 1:L, :].reshape(B, 2, -1)], dim=-2)
            mix_p = nttmod.intt(mix_tabs, mix_in)
            sp = mix_p[..., : 2 * k, :].reshape(B, 2, k, -1)
            last_p = mix_p[..., 2 * k:, :][..., :, None, :]  # [B, 4, 1, N]
        else:
            sp = nttmod.intt(sp_ring.tables, acc[..., L:, :])  # [B, 2, k, N]
            last_in = torch.cat([acc[..., L - 1:L, :], d12[..., L - 1:L, :]], dim=1)
            last_p = nttmod.intt(last_ring.tables, last_in)  # [B, 4, 1, N]
        lifts = []
        for s in range(k):
            l = sp[..., -1:, :]
            lifts.append(l)
            sp = sp[..., :-1, :]
            if sp.shape[-2]:
                mp_rem = mp_rems[sp.shape[-2]]
                sp = modmath.mont_mul(
                    modmath.sub_mod(sp, modmath.umod(l, mp_rem.p), mp_rem),
                    dinvs[s], mp_rem)

        # --- l_0: raw residue of (acc/P + d) mod q_L ---
        accL, dL = last_p[:, :2], last_p[:, 2:]
        bL = modmath.mont_mul(accL, pinv_L, mp_last)
        for s in range(k):
            bL = modmath.sub_mod(
                bL, modmath.mont_mul(modmath.umod(lifts[s], mp_last.p), wL[s],
                                     mp_last), mp_last)
        l0 = modmath.add_mod(bL, dL, mp_last)               # [B, 2, 1, N]

        # --- one combined-correction NTT over the surviving rows ---
        D = modmath.mont_mul(modmath.umod(l0, mp_surv.p), Bw, mp_surv)
        for s in range(k):
            D = modmath.add_mod(
                D, modmath.mont_mul(modmath.umod(lifts[s], mp_surv.p), W[s], mp_surv),
                mp_surv)
        Dd = nttmod.ntt(surv_ring.tables, D)                # [B, 2, L-1, N]

        out = modmath.sub_mod(
            modmath.add_mod(modmath.mont_mul(acc[..., : L - 1, :], A, mp_surv),
                            modmath.mont_mul(d12[..., : L - 1, :], Bw, mp_surv),
                            mp_surv),
            Dd, mp_surv)
        zero = torch.zeros(out.shape[:-2] + (1, out.shape[-1]), dtype=out.dtype,
                           device=out.device)
        return torch.cat([out, zero], dim=-2)

    return _compiled(step, eager, "hybrid_fused_step"), _placer(device)
