"""The single-device CKKS step: homomorphic square → relinearize → rescale.

Port of the single-chip flavours of ``toyfhe_tpu/parallel/ops.py`` on a
batch of NTT-domain ciphertexts: the per-limb RNS gadget
(``_square_relin_rescale_local`` with ``axis_name=None`` and
``make_single_chip_step``) and the dnum-grouped hybrid gadget
(``make_hybrid_sharded_step(None, ...)``, optionally through the fused key
switch K3, and the fused-schedule ``make_hybrid_fused_step``). Shapes stay
static: the rescale zeroes the dropped limb instead of removing it, so the
output has the input's shape ``[B, 2, L, N]``.

The transforms go through :func:`..ops.ntt.ntt` / :func:`..ops.ntt.intt`:
the CUDA kernel for CUDA tensors, the plain radix-2 version for CPU tensors.
Everything else is elementwise modular arithmetic in plain torch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.hybrid import _mont_col
from ..core.rlwe import _hybrid_key_stack
from ..ops import modmath, ntt as nttmod
from ..ops.modmath import MontParams


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


def _square_relin_rescale_local(c, key_masks, key_maskeds, rescale_inv, tabs,
                                tables):
    """Square → relinearize → rescale on ciphertext duals.

    Shapes:
      c:            int64[B, 2, L, N]   ciphertext duals
      key_masks:    int64[L, L, N]      relin key mask duals (digit-major)
      key_maskeds:  int64[L, L, N]
      rescale_inv:  int64[L, 1]         (q_last^{-1} mod q_j, Montgomery; 0 for the last limb)
      tabs:         :func:`full_table_pytree` on c's device
      tables:       the ring's :class:`NttTables`, which routes the transforms
    Returns int64[B, 2, L, N] rescaled ciphertext duals with the dropped
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
    lifts = modmath.centered(inv(d3), mp)                   # signed [B, L, N]
    digs = fwd(modmath.from_signed(lifts[..., :, None, :], mp))   # [B, L, L, N]
    acc1 = modmath.mod_sum(modmath.mul_mod(digs, key_maskeds, mp), mp, axis=-3)
    acc2 = modmath.mod_sum(modmath.mul_mod(digs, key_masks, mp), mp, axis=-3)
    r1 = modmath.add_mod(d1, acc1, mp)
    r2 = modmath.add_mod(d2, acc2, mp)
    outp = inv(torch.stack([r1, r2], dim=1))                # [B, 2, L, N]

    # --- rescale by the last limb, static shapes ---
    last_mod = modmath.umod(outp[..., -1:, :], mp.p)
    res = modmath.mont_mul(modmath.sub_mod(outp, last_mod, mp), rescale_inv, mp)
    res[..., -1, :] = 0                                     # the dropped limb
    return fwd(res)


def rescale_inverses(primes) -> np.ndarray:
    """q_last^{-1} mod q_j in Montgomery form per limb, 0 for the last."""
    qk = primes[-1]
    return np.array([[pow(qk, -1, p) * (1 << 32) % p if p != qk else 0]
                     for p in primes], dtype=np.int64)


def make_single_chip_step(tables: nttmod.NttTables, key_masks: torch.Tensor,
                          key_maskeds: torch.Tensor):
    """The square→relin→rescale step on the keys' device.

    ``key_masks`` / ``key_maskeds`` are the relinearization key stacks
    int64[L, L, N] (dual domain, digit-major). Returns ``step(c)`` on
    int64[B, 2, L, N] ciphertext duals on the same device.
    """
    device = key_masks.device
    if key_maskeds.device != device:
        raise ValueError("key stacks on different devices")
    tabs = full_table_pytree(tables, device)
    rescale_inv = torch.as_tensor(rescale_inverses(tables.primes), device=device)

    def step(c: torch.Tensor) -> torch.Tensor:
        return _square_relin_rescale_local(c, key_masks, key_maskeds,
                                           rescale_inv, tabs, tables)

    return step


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


def _square_relin_rescale_hybrid(c, km, kd, yinv, gconsts, rinv_rows,
                                 rescale_inv, mps, bounds, tables, fks=None):
    """Square → hybrid (dnum-grouped) relinearize → rescale on ct duals.

    Single-device form of the reference body with ``axis_name=None``. The
    reference splits every operand into ct rows and replicated special rows
    for residue sharding; here they come joined over the expanded tower
    T = L + k, and the constant sets the reference concatenates in its body
    (:func:`_concat_tabs`, :func:`_rem_mp`) are made once by the builder.

      c:           int64[B, 2, L, N]   ciphertext duals
      km / kd:     int64[ndig, T, N]   key mask / masked duals
      yinv:        int64[L, 1]         ŷ premultipliers (Montgomery)
      gconsts[j]:  int64[T, a_j, 1]    FBC constants Q_j/q_i mod the target
      rinv_rows[s]: int64[T-1-s, 1]    p_drop^{-1} at contraction step s
      rescale_inv: int64[L, 1]         final data-prime rescale (0 last)
      mps:         MontParams: "ct", "exp", "exp3" (expanded), "rem" (per s)
      tables:      (ct NttTables, expanded NttTables): routes the transforms
      fks:         a :class:`..ops.hybrid_ks.FusedHybridKS` replaces the
                   digit pipeline (FBC → NTT → key contraction) with K3
    Returns int64[B, 2, L, N] rescaled duals with the dropped limb zeroed.
    """
    ct_tables, exp_tables = tables
    mp, mpe, mpe3 = mps["ct"], mps["exp"], mps["exp3"]
    c1, c2 = c[:, 0], c[:, 1]
    # --- homomorphic square ---
    d1 = modmath.mul_mod(c1, c1, mp)
    mid = modmath.mul_mod(c1, c2, mp)
    d2 = modmath.add_mod(mid, mid, mp)
    d3 = modmath.mul_mod(c2, c2, mp)

    # --- hybrid relinearize d3 onto (d1, d2) ---
    y = modmath.mont_mul(nttmod.intt(ct_tables, d3), yinv, mp)   # [B, L, N]
    if fks is not None:
        acc1, acc2 = fks(y)
    else:
        digs = []
        for (lo, hi), cj in zip(bounds, gconsts):
            prod = modmath.mont_mul(y[..., None, lo:hi, :], cj, mpe3)
            digs.append(modmath.mod_sum(prod, mpe, axis=-2))
        digs = nttmod.ntt(exp_tables, torch.stack(digs, dim=-3))  # [B, ndig, T, N]
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
    last_mod = modmath.umod(out[..., -1:, :], mp.p)
    res = modmath.mont_mul(modmath.sub_mod(out, last_mod, mp), rescale_inv, mp)
    res[..., -1, :] = 0                                     # the dropped limb
    return nttmod.ntt(ct_tables, res)


def _placer(device):
    """place(x): residues (array or tensor) as an int64 tensor on ``device``."""
    def place(x):
        if torch.is_tensor(x):
            return x.to(device=device, dtype=torch.int64)
        return modmath.as_residues(x, device)
    return place


def make_hybrid_sharded_step(mesh, params, ek, fused: bool = False,
                             fused_schedule: bool = False, ct_ring=None):
    """The square→relin→rescale step for a HybridRaised parameter set on
    the device of the eval key ``ek`` (an EvalMultKey).

    Returns (step, place): step(c[B, 2, Lc, N] duals) → same shape, dropped
    limb zeroed; place(x) puts an array on the step's device. Only the
    single-device flavour exists: ``mesh`` must be None. ``fused=True``
    runs the digit pipeline through the fused key switch K3
    (:class:`..ops.hybrid_ks.FusedHybridKS`); ``fused_schedule=True``
    returns :func:`make_hybrid_fused_step`.
    ``ct_ring`` (default: the full ct tower) runs the step on a shortened
    tower, as the MNIST square layers do — an addition of the port, so that
    every flavour runs at those levels."""
    if mesh is not None:
        raise NotImplementedError("sharded hybrid steps are not ported; pass mesh=None")
    if fused_schedule:
        return make_hybrid_fused_step(params, ek, ct_ring)

    ct_ring = ct_ring if ct_ring is not None else params.ring_cipher
    Lc, k = ct_ring.nlimbs, params.num_special
    exp_ring, eng_groups = params._tables(Lc)
    km, kd = _hybrid_key_stack(params, ek.key, exp_ring, len(eng_groups), 0)
    device = km.device
    col = lambda a: modmath.as_residues(a, device)

    bounds = tuple(g[0] for g in eng_groups)
    yinv = col(np.concatenate([g[1] for g in eng_groups], 0))
    gconsts = tuple(col(g[2]) for g in eng_groups)

    # contraction step s drops the last remaining prime of the expanded
    # tower: its inverse mod the ct primes ++ the surviving specials
    rinv_rows = []
    cur = list(exp_ring.primes)
    for s in range(k):
        drop, cur = cur[-1], cur[:-1]
        rinv_rows.append(col(_mont_col([pow(drop, -1, p) for p in cur], cur)))
    qk = ct_ring.primes[-1]
    rescale_inv = col(_mont_col([pow(qk, -1, p) if p != qk else 0
                                 for p in ct_ring.primes], ct_ring.primes))

    sp_ring = params.params.ring_cipher.select(list(range(params.L, params.L + k)))
    tabs = full_table_pytree(ct_ring.tables, device)
    stabs = full_table_pytree(sp_ring.tables, device)
    mpe = _mp_full(_concat_tabs(tabs, stabs))
    mps = {"ct": _mp_full(tabs), "exp": mpe, "exp3": mpe.expand(),
           "rem": tuple(_rem_mp(tabs, stabs, k - s - 1) for s in range(k))}
    fks = None
    if fused:
        from ..ops.hybrid_ks import FusedHybridKS
        fks = FusedHybridKS(params, ek, lt=Lc)
    tables = (ct_ring.tables, exp_ring.tables)

    def step(c: torch.Tensor) -> torch.Tensor:
        return _square_relin_rescale_hybrid(c, km, kd, yinv, gconsts, rinv_rows,
                                            rescale_inv, mps, bounds, tables, fks)

    return step, _placer(device)


def make_hybrid_fused_step(params, ek, ct_ring=None, merge_calls: bool = True):
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
    :func:`make_hybrid_sharded_step`.
    """
    ct_ring = ct_ring if ct_ring is not None else params.ring_cipher
    L, k = ct_ring.nlimbs, params.num_special
    exp_ring, eng_groups = params._tables(L)
    T = exp_ring.nlimbs
    sp_ring = exp_ring.select(range(L, T))
    last_ring = ct_ring.select([L - 1])
    surv_ring = ct_ring.select(range(L - 1))

    km, kd = _hybrid_key_stack(params, ek.key, exp_ring, len(eng_groups), 0)  # [ndig, T, N]
    device = km.device
    col = lambda a: modmath.as_residues(a, device)

    # --- FBC constants + per-group out-of-group transform tables ---
    bounds = tuple(g[0] for g in eng_groups)
    yinv = col(np.concatenate([g[1] for g in eng_groups], 0))
    gconsts = tuple(col(g[2]) for g in eng_groups)
    mp_exp = exp_ring.mp.on(device)
    mp_exp3 = mp_exp.expand()
    grp_out = []
    for (lo, hi) in bounds:
        out_idx = list(range(lo)) + list(range(hi, T))
        grp_out.append((torch.tensor(out_idx, device=device),
                        exp_ring.select(out_idx).tables))

    # merged-call schedule: the FBC computes only the out-of-group rows,
    # every group's digit rows ride one transform call (rows repeat across
    # groups) and the k-special + last-data-row inverse transforms merge
    grp_fbc, all_out, seg = [], [], []
    for (lo, hi), g in zip(bounds, eng_groups):
        oidx = list(range(lo)) + list(range(hi, T))
        seg.append((len(all_out), len(oidx)))
        all_out += oidx
        mp_o = exp_ring.mp.select(oidx).on(device)
        grp_fbc.append((col(np.asarray(g[2])[np.asarray(oidx)]), mp_o, mp_o.expand()))
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
        y = modmath.mont_mul(d3p, yinv, mp_ct)
        digs = []
        if merge_calls:
            mfbc = []
            for (lo, hi), (cj_o, mp_o, mp_o3) in zip(bounds, grp_fbc):
                prod = modmath.mont_mul(y[..., None, lo:hi, :], cj_o, mp_o3)
                mfbc.append(modmath.mod_sum(prod, mp_o, axis=-2))
            res_all = nttmod.ntt(cat_tabs, torch.cat(mfbc, dim=-2))
            for (lo, hi), (off, ln) in zip(bounds, seg):
                res = res_all[..., off:off + ln, :]
                digs.append(torch.cat([res[..., :lo, :], d3[..., lo:hi, :],
                                       res[..., lo:, :]], dim=-2))
        else:
            for (lo, hi), cj, (oidx, otabs) in zip(bounds, gconsts, grp_out):
                prod = modmath.mont_mul(y[..., None, lo:hi, :], cj, mp_exp3)
                dj = modmath.mod_sum(prod, mp_exp, axis=-2)  # [B, T, N]
                res = nttmod.ntt(otabs, dj.index_select(-2, oidx))
                digs.append(torch.cat([res[..., :lo, :], d3[..., lo:hi, :],
                                       res[..., lo:, :]], dim=-2))
        digs = torch.stack(digs, dim=-3)                    # [B, ndig, T, N]
        acc1 = modmath.mod_sum(modmath.mul_mod(digs, kd, mp_exp), mp_exp, axis=-3)
        acc2 = modmath.mod_sum(modmath.mul_mod(digs, km, mp_exp), mp_exp, axis=-3)
        acc = torch.stack([acc1, acc2], dim=1)              # [B, 2, T, N]
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

    return step, _placer(device)
