"""The compiled encrypted layers — the serving path.

Port of ``toyfhe_tpu/parallel/layers.py``. Each layer is an ``nn.Module``
whose key and constant tensors are registered buffers on the key's device.
The reference's ``jax.jit`` of each layer becomes :func:`..utils.graphs.jit`:
on CUDA inputs a layer replays a CUDA graph of its forward, captured at its
first call; ``eager=True`` keeps it eager, and on CPU inputs it runs eagerly.
Its ``lax.fori_loop`` is a Python loop. Every transform goes through
:func:`..ops.ntt.ntt` / :func:`..ops.ntt.intt`: the CUDA kernel K1 for CUDA
tensors, the plain radix-2 twin for CPU tensors.

  * :class:`RotateMatmulLayer` — the rotation-based diagonal matmul: d−1
    Galois rotations, each with a special-prime (ModulusRaised) or
    dnum-grouped (HybridRaised) key switch, and diagonal plaintext
    multiplies;
  * :class:`SquareRelinLayer` — ct² → relinearize → rescale;
  * :class:`ConvLayer`, :class:`BiasRescaleLayer`, :class:`DualRescale` —
    the plaintext-weight layers and the rescales between them;
  * :class:`BatchEncryptor` — batched public-key encryption;
  * :class:`MeshPlacement` — where the sharded pipeline's tensors live on a
    ('dp', 'rp') mesh; :class:`ConvLayer` takes it to run on a rank's
    block and complete its grid sum over 'dp'.

All arithmetic is exact modular integer arithmetic, so every layer is
bit-identical to the reference's on the same inputs. Where the reference
transforms two tensors one after the other, the port stacks them into one
transform call (the same values, half the launches).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core import ring as R
from ..core.ring import RingContext
from ..ops import fbc_cuda, keyprod_cuda, modmath, ntt as nttmod
from ..ops.modmath import MontParams, as_residues
from ..utils import graphs
from . import sharding as S


def _mont_col(vals, ps) -> np.ndarray:
    """Column of constants in Montgomery form wrt per-row primes ps."""
    return np.array([[int(v) * (1 << 32) % p] for v, p in zip(vals, ps)],
                    dtype=np.uint64).astype(np.uint32)


def _ntt_t(x: torch.Tensor, ring: RingContext) -> torch.Tensor:
    """Forward transform over ``ring``'s tower (K1 on a CUDA tensor)."""
    return nttmod.ntt(ring.tables, x)


def _intt_t(x: torch.Tensor, ring: RingContext) -> torch.Tensor:
    return nttmod.intt(ring.tables, x)


def _rescale_last(x: torch.Tensor, mp: MontParams, inv: torch.Tensor) -> torch.Tensor:
    """Exact divide-and-round of primal x [..., L+1, N] by its last limb's
    prime: (x_j − [x_last]_{q_j})·inv_j over the first L limbs, with the raw
    residue of the last limb (``mp`` / ``inv`` over the L survivors)."""
    mpd = mp.on(x.device)
    last = modmath.umod(x[..., -1:, :], mpd.p)
    return modmath.mont_mul(modmath.sub_mod(x[..., :-1, :], last, mpd), inv, mpd)


# ---------------------------------------------------------------------------
# key arrays
# ---------------------------------------------------------------------------

class ModRaiseKeyArrays(nn.Module):
    """Device-ready key-switch data for a ModulusRaised key at one tower
    level: the key duals downswitched to [ct limbs..., special]
    ``(ndig, Le, N)``, ps mod q_j and ps⁻¹ mod q_j (Montgomery) ``(Lc, 1)``."""

    def __init__(self, masks, maskeds, ps_res, inv_ps_mont, exp_ring: RingContext,
                 ct_ring: RingContext, window: int = 0, k_per_limb: int = 1):
        super().__init__()
        self.register_buffer("masks", masks)
        self.register_buffer("maskeds", maskeds)
        self.register_buffer("ps_res", ps_res)
        self.register_buffer("inv_ps_mont", inv_ps_mont)
        self.exp_ring, self.ct_ring = exp_ring, ct_ring
        self.window, self.k_per_limb = int(window), int(k_per_limb)
        if self.window:
            self.register_buffer("shifts", torch.arange(
                self.k_per_limb, dtype=torch.int64, device=masks.device)[:, None, None]
                * self.window)


def build_modraise_key_arrays(params, ksk, ct_ring=None) -> ModRaiseKeyArrays:
    """Stack an engine KeySwitchKey under ModulusRaised params, downswitched
    to [ct limbs..., special]; ``ct_ring`` selects the tower level (default:
    the full ct ring)."""
    from ..core.rlwe import _gadget_shape

    full = params.params.ring_cipher
    ct_ring = ct_ring if ct_ring is not None else params.ring_cipher
    Lc = ct_ring.nlimbs
    window = params.relin_window
    kpl = _gadget_shape(params.ring_cipher, window)[0] if window else 1
    which = list(range(Lc)) + [full.nlimbs - 1]
    exp_ring = full.select(which)
    masks, maskeds = [], []
    for comp in ksk.key[:Lc * kpl]:
        _, m = R.limb_select(full, R.ensure_dual(full, comp.mask), which)
        _, md = R.limb_select(full, R.ensure_dual(full, comp.masked), which)
        masks.append(m.dual)
        maskeds.append(md.dual)
    dev = masks[0].device
    ps = full.primes[-1]
    ps_res = np.array([[ps % p] for p in ct_ring.primes], dtype=np.int64)
    inv_ps = _mont_col([pow(ps, -1, p) for p in ct_ring.primes], ct_ring.primes)
    return ModRaiseKeyArrays(torch.stack(masks, 0), torch.stack(maskeds, 0),
                             as_residues(ps_res, dev), as_residues(inv_ps, dev),
                             exp_ring, ct_ring, window, kpl)


class HybridKeyArrays(nn.Module):
    """Device-ready key-switch data for a dnum-grouped HybridRaised key:
    digit j is the group-j residue fast-base-converted into the Q_t ∪ P
    tower (``fbc``, the engine's :meth:`HybridRaised.fbc_plan`); contraction
    is ``num_special`` rescales. Buffers: the key duals ``(ndig, Le, N)``,
    P mod q_j ``P_res`` (Lc, 1) and per contraction step the dropped prime's
    inverses ``resc{s}``."""

    def __init__(self, params, ksk, ct_ring: RingContext):
        super().__init__()
        exp_ring, eng_groups = params._tables(ct_ring.nlimbs)
        key_ring = params.ring_key
        which = params.hybrid_key_limbs(exp_ring)
        masks, maskeds = [], []
        for comp in ksk.key[:len(eng_groups)]:
            _, m = R.limb_select(key_ring, R.ensure_dual(key_ring, comp.mask), which)
            _, md = R.limb_select(key_ring, R.ensure_dual(key_ring, comp.masked), which)
            masks.append(m.dual)
            maskeds.append(md.dual)
        dev = masks[0].device
        self.register_buffer("masks", torch.stack(masks, 0))
        self.register_buffer("maskeds", torch.stack(maskeds, 0))
        self.exp_ring, self.ct_ring = exp_ring, ct_ring
        self.fbc = params.fbc_plan(ct_ring)
        self.register_buffer("P_res", as_residues(
            np.array([[params.P % p] for p in ct_ring.primes], dtype=np.int64), dev))
        self.resc_mp = []
        cur = list(exp_ring.primes)
        for s in range(params.num_special):
            drop, cur = cur[-1], cur[:-1]
            self.register_buffer(f"resc{s}", as_residues(
                _mont_col([pow(drop, -1, p) for p in cur], cur), dev))
            self.resc_mp.append(MontParams.make(cur))


def build_hybrid_key_arrays(params, ksk, ct_ring=None) -> HybridKeyArrays:
    """Stack an engine KeySwitchKey under HybridRaised params; reuses the
    engine's per-tower FBC tables."""
    return HybridKeyArrays(params, ksk, ct_ring if ct_ring is not None
                           else params.ring_cipher)


def build_key_arrays(params, ksk, ct_ring=None):
    """Dispatch on the key-switch modifier: HybridRaised → grouped FBC
    digits; ModulusRaised → per-limb / windowed digits + one special."""
    if getattr(params, "hybrid_decompose", None) is not None:
        return build_hybrid_key_arrays(params, ksk, ct_ring)
    return build_modraise_key_arrays(params, ksk, ct_ring)


# ---------------------------------------------------------------------------
# the hybrid key switch
# ---------------------------------------------------------------------------

def _hybrid_digits(ka: HybridKeyArrays, xp: torch.Tensor) -> torch.Tensor:
    """Digit duals (..., ndig, Le, N): group residues fast-base-converted
    into the expanded tower (the CUDA kernel on the card), then K1."""
    return _ntt_t(fbc_cuda.fbc(ka.fbc, xp, digits_inner=True), ka.exp_ring)


def _rescale_chain(x: torch.Tensor, ka: HybridKeyArrays) -> torch.Tensor:
    """num_special exact rounding rescales (divide by P limb by limb)."""
    for s, mp_rem in enumerate(ka.resc_mp):
        x = _rescale_last(x, mp_rem, getattr(ka, f"resc{s}"))
    return x


def _contract(ka, acc: torch.Tensor, rescale):
    """Inverse-transform both accumulators ``acc`` [2, ..., Le, N] in one
    call and rescale them."""
    out = rescale(_intt_t(acc, ka.exp_ring))
    return out[0], out[1]


def _key_products(ka, ddual: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``acc`` [2, ..., Le, N] plus the key products of the digit duals
    ``ddual`` (..., ndig, Le, N), in place (the kernel on the card)."""
    return keyprod_cuda.key_products(ddual, ka.masks, ka.maskeds, ka.exp_ring.mp,
                                     digits_inner=True, acc=acc)


def _scaled_start(ka, scale: torch.Tensor, e1: torch.Tensor, e2=None) -> torch.Tensor:
    """The accumulators' start [2, ..., Le, N]: the ct-tower duals ``e1``
    (and ``e2``, else zero) times ``scale``, with zero special rows."""
    mp_ct = ka.ct_ring.mp
    e1 = modmath.mul_mod(e1, scale, mp_ct)
    e2 = torch.zeros_like(e1) if e2 is None else modmath.mul_mod(e2, scale, mp_ct)
    e = torch.stack([e1, e2])
    k = ka.exp_ring.nlimbs - ka.ct_ring.nlimbs
    return torch.cat([e, e.new_zeros(e.shape[:-2] + (k, e.shape[-1]))], -2)


def _special_zeros(x: torch.Tensor, ka) -> torch.Tensor:
    k = ka.exp_ring.nlimbs - ka.ct_ring.nlimbs
    return torch.zeros(x.shape[:-2] + (k, x.shape[-1]), dtype=x.dtype, device=x.device)


def _hybrid_keyswitch(ka: HybridKeyArrays, c1p, c2p):
    """Hybrid key switch of a 2-component primal ciphertext. c1 is folded
    through the accumulator pre-scaled by P — bit-identical to the engine's
    contract-then-add since P ≡ 0 mod every special prime, so each rescale
    step sees exactly the accumulator's residue."""
    start = _scaled_start(ka, ka.P_res, _ntt_t(c1p, ka.ct_ring))
    return _contract(ka, _key_products(ka, _hybrid_digits(ka, c2p), start),
                     lambda x: _rescale_chain(x, ka))


def _hybrid_keyswitch_pair(ka: HybridKeyArrays, d1_dual, d2_dual, d3p):
    """Hybrid key switch for a 3-component ct (relinearization): digits from
    d3 primal; d1 / d2 dual folded through the P-scaled channel."""
    start = _scaled_start(ka, ka.P_res, d1_dual, d2_dual)
    return _contract(ka, _key_products(ka, _hybrid_digits(ka, d3p), start),
                     lambda x: _rescale_chain(x, ka))


def _keyswitch_2(ka, c1p, c2p):
    if isinstance(ka, HybridKeyArrays):
        return _hybrid_keyswitch(ka, c1p, c2p)
    return _modraise_keyswitch(ka, c1p, c2p)


def _keyswitch_pair(ka, d1_dual, d2_dual, d3p):
    if isinstance(ka, HybridKeyArrays):
        return _hybrid_keyswitch_pair(ka, d1_dual, d2_dual, d3p)
    return _modraise_keyswitch_pair(ka, d1_dual, d2_dual, d3p)


# ---------------------------------------------------------------------------
# the special-prime (ModulusRaised) key switch
# ---------------------------------------------------------------------------

def _gadget_digits(ka: ModRaiseKeyArrays, xp: torch.Tensor) -> torch.Tensor:
    """Digit duals (..., ndig, Le, N) for the unified gadget
    (``rlwe.gadget_decompose`` semantics, vectorized): centered RNS digits
    at window 0, raw base-2^w digits of each residue at window w."""
    Lc, n = xp.shape[-2], xp.shape[-1]
    Le = Lc + 1
    if ka.window == 0:
        lifts = modmath.centered(xp, ka.ct_ring.mp)
        digs = modmath.from_signed(
            lifts[..., :, None, :].expand(lifts.shape[:-2] + (Lc, Le, n)),
            ka.exp_ring.mp)
    else:
        K = ka.k_per_limb
        d = (xp[..., :, None, None, :] >> ka.shifts) & ((1 << ka.window) - 1)
        digs = d.expand(xp.shape[:-2] + (Lc, K, Le, n)).reshape(
            xp.shape[:-2] + (Lc * K, Le, n))
    return _ntt_t(digs, ka.exp_ring)


def _ps_rescale(ka: ModRaiseKeyArrays):
    return lambda x: _rescale_last(x, ka.ct_ring.mp, ka.inv_ps_mont)


def _modraise_keyswitch(ka: ModRaiseKeyArrays, c1p, c2p):
    """Special-prime key switch of a 2-component primal ciphertext whose
    second component is being switched (``rlwe.keyswitch`` with the
    ModulusRaised expand / contract hooks). Returns primal (Lc, N)
    components. :class:`..ops.pallas_keyswitch.FusedKeyswitch` (K6) fuses
    everything here before the final rescale."""
    # expand c1 by ps and adjoin the zero special limb (in the dual domain
    # — scalar multiply and zero limb are domain-independent)
    start = _scaled_start(ka, ka.ps_res, _ntt_t(c1p, ka.ct_ring))
    return _contract(ka, _key_products(ka, _gadget_digits(ka, c2p), start), _ps_rescale(ka))


def build_fused_keyswitch(ka: ModRaiseKeyArrays):
    """The fused key switch K6 (:class:`..ops.pallas_keyswitch.FusedKeyswitch`)
    for a windowed key at ``ka``'s tower level."""
    from ..ops.pallas_keyswitch import FusedKeyswitch
    return FusedKeyswitch(ka.exp_ring.tables, ka.masks, ka.maskeds, ka.window,
                          ka.k_per_limb, ka.ct_ring.nlimbs)


def _modraise_keyswitch_fused(ka: ModRaiseKeyArrays, fk, c1p, c2p):
    """:func:`_modraise_keyswitch` through the fused kernels, bit-identical:
    c1·ps with its zero special row transformed to the bit-reversed dual by
    K5, the digits, key products and inverse transforms by K6 (``fk``, from
    :func:`build_fused_keyswitch`), then the special-prime rescale. No layer
    calls it, as in the reference."""
    from ..ops.ntt_pallas import ntt_bitrev_rows

    c1x = torch.cat([modmath.mul_mod(c1p, ka.ps_res, ka.ct_ring.mp),
                     _special_zeros(c1p, ka)], -2)                   # [..., Le, N]
    out1, out2 = fk(c2p, ntt_bitrev_rows(fk.pt, c1x))
    rescale = _ps_rescale(ka)
    return rescale(out1), rescale(out2)


def _modraise_keyswitch_pair(ka: ModRaiseKeyArrays, d1_dual, d2_dual, d3p):
    """Key switch for a 3-component ct (d1, d2, d3): digits from d3, d1 / d2
    already dual in the ct ring. Returns primal ct-ring components."""
    start = _scaled_start(ka, ka.ps_res, d1_dual, d2_dual)
    return _contract(ka, _key_products(ka, _gadget_digits(ka, d3p), start), _ps_rescale(ka))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class _Compiled(nn.Module):
    """A layer whose forward is compiled, as the reference's
    ``jax.jit(self._build())``: on CUDA inputs :meth:`forward` replays a
    CUDA graph of :meth:`compute` (:func:`..utils.graphs.jit`), on CPU
    inputs it runs it eagerly; ``eager=True`` runs it eagerly on the card
    too. Moving the layer (``.to``) drops its graphs."""

    def __init__(self, eager: bool = False):
        super().__init__()
        self.eager = bool(eager)
        self._compiled = None

    def forward(self, *args):
        if self.eager:
            return self.compute(*args)
        if self._compiled is None:
            self._compiled = graphs.jit(self.compute, name=type(self).__name__)
        return self._compiled(*args)

    def _apply(self, fn, *args, **kwargs):
        self._compiled = None
        return super()._apply(fn, *args, **kwargs)


class _RescaleBy(_Compiled):
    """Holds the rescale-by-the-last-prime constants of ``ct_ring``."""

    def __init__(self, ct_ring: RingContext, device, eager: bool = False):
        super().__init__(eager)
        qk = ct_ring.primes[-1]
        sub = ct_ring.drop_last()
        self.ct_ring, self.sub_ring = ct_ring, sub
        self.register_buffer("inv_q_mont", as_residues(
            _mont_col([pow(qk, -1, p) for p in sub.primes], sub.primes), device))

    def rescale(self, xp: torch.Tensor) -> torch.Tensor:
        return _rescale_last(xp, self.sub_ring.mp, self.inv_q_mont)


class RotateMatmulLayer(_Compiled):
    """Rotation-based diagonal matmul: d−1 Galois rotations with key
    switches and diagonal plaintext multiplies.

    ``forward(c1p, c2p, diag_dual)``: primal (..., Lc, N) components and
    ``diag_dual`` int64[d, Lc, N] — each diagonal pre-encoded at the input
    scale and NTT'd. The output ciphertext is dual-domain at scale².
    """

    def __init__(self, params, gk, galois_element: int, d: int, ct_ring=None,
                 eager: bool = False):
        super().__init__(eager)
        self.ka = build_key_arrays(params, gk.key, ct_ring)
        src, neg = self.ka.ct_ring.galois_tables(galois_element)
        dev = self.ka.masks.device
        self.register_buffer("src", torch.as_tensor(src, device=dev))
        self.register_buffer("neg", torch.as_tensor(neg, device=dev))
        self.d = int(d)

    def galois(self, x: torch.Tensor) -> torch.Tensor:
        return nttmod.apply_galois(self.ka.ct_ring.mp, x, self.src, self.neg)

    def compute(self, c1p, c2p, diag_dual):
        ka = self.ka
        mp = ka.ct_ring.mp
        cd = _ntt_t(torch.stack([c1p, c2p], 0), ka.ct_ring)
        res = modmath.mul_mod(cd, diag_dual[0], mp)
        r1p, r2p = c1p, c2p
        for k in range(1, self.d):
            o1, o2 = _keyswitch_2(ka, self.galois(r1p), self.galois(r2p))
            od = _ntt_t(torch.stack([o1, o2], 0), ka.ct_ring)
            res = modmath.add_mod(res, modmath.mul_mod(od, diag_dual[k], mp), mp)
            r1p, r2p = o1, o2
        return res[0], res[1]


class SquareRelinLayer(_RescaleBy):
    """ct² → relinearize → rescale by the last data prime. Input primal
    (..., Lc, N) components; output primal at the dropped tower
    (..., Lc−1, N) with scale²/q_last."""

    def __init__(self, params, ek, ct_ring=None, eager: bool = False):
        ka = build_key_arrays(params, ek.key, ct_ring)
        super().__init__(ka.ct_ring, ka.masks.device, eager)
        self.ka = ka

    def compute(self, c1p, c2p):
        ka = self.ka
        mp = ka.ct_ring.mp
        cd = _ntt_t(torch.stack([c1p, c2p], 0), ka.ct_ring)
        c1d, c2d = cd[0], cd[1]
        d1 = modmath.mul_mod(c1d, c1d, mp)
        mid = modmath.mul_mod(c1d, c2d, mp)
        d2 = modmath.add_mod(mid, mid, mp)
        d3 = modmath.mul_mod(c2d, c2d, mp)
        d3p = _intt_t(d3, ka.ct_ring)
        # relinearize (d1, d2) += keyswitch(d3); d2 rides the mask channel
        o1, o2 = _keyswitch_pair(ka, d1, d2, d3p)
        return self.rescale(o1), self.rescale(o2)


class DualRescale(nn.Module):
    """Dual-domain rescale by the last data prime (the layer-level twin of
    ``ring.rescale_dual``): bit-identical to the primal rescale, paying an
    INTT of one row and an NTT of L−1 rows instead of a full-tower INTT and
    the next layer's re-NTT. ``forward``: int64[..., L, N] dual →
    int64[..., L−1, N] dual. Its constant is made on the CPU;
    ``.to(device)`` moves it."""

    def __init__(self, ct_ring: RingContext):
        super().__init__()
        qk = ct_ring.primes[-1]
        sub = ct_ring.drop_last()
        self.ct_ring, self.sub_ring = ct_ring, sub
        self.last_ring = ct_ring.select([ct_ring.nlimbs - 1])
        self.register_buffer("inv_q_mont", as_residues(
            _mont_col([pow(qk, -1, p) for p in sub.primes], sub.primes), "cpu"))

    def forward(self, x_dual):
        lastp = _intt_t(x_dual[..., -1:, :], self.last_ring)       # raw residues
        mp_sub = self.sub_ring.mp.on(x_dual.device)
        corr = modmath.mont_mul(modmath.umod(lastp, mp_sub.p), self.inv_q_mont, mp_sub)
        corr_dual = _ntt_t(corr, self.sub_ring)
        return modmath.sub_mod(
            modmath.mont_mul(x_dual[..., :-1, :], self.inv_q_mont, mp_sub),
            corr_dual, mp_sub)


class ConvLayer(_RescaleBy):
    """Encrypted convolution: per output channel, Σ over the k×k ciphertext
    grid of plain-scalar multiplies, plus bias, plus the rescale.

    ``forward(cts_dual (G, 2, Lc, N), w_res (C, G, Lc, 1), bias_dual
    (C, Lc, N))`` → (C, 2, Lc−1, N) at scale²/q_last: primal, or dual when
    ``dual_out``. Its constants are made on the CPU; ``.to(device)`` moves
    them."""

    def __init__(self, params, ct_ring=None, channels: int = 4,
                 dual_out: bool = False, eager: bool = False):
        ct = ct_ring if ct_ring is not None else params.ring_cipher
        super().__init__(ct, "cpu", eager)
        self.channels = channels
        self.dual_out = dual_out
        self.dual_rescale = DualRescale(ct) if dual_out else None

    def compute(self, cts_dual, w_res, bias_dual, place: "MeshPlacement" = None):
        """With ``place``: ``cts_dual`` is this rank's block of the grid
        (its grid rows on 'dp', its limb rows on 'rp' where the level
        divides it) and the weights and biases are whole; the grid sum is
        completed over 'dp', and the rank's block of the output (its
        channels, its limb rows) returned."""
        L, G = self.ct_ring.nlimbs, w_res.shape[1]
        rows = place.rows(L) if place is not None else slice(None)
        if place is not None:
            w_res = w_res[:, place.batch(G)][..., rows, :]
        mp = self.ct_ring.mp.select(range(L)[rows])
        acc = None
        for g in range(cts_dual.shape[0]):
            term = modmath.mul_mod(cts_dual[g][None], w_res[:, g][:, None], mp)
            acc = term if acc is None else modmath.add_mod(acc, term, mp)
        if place is not None:
            acc = place.gather_rows(place.dp_sum(acc, G, mp, "conv_grid_sum"), L)
        mp = self.ct_ring.mp
        acc = torch.stack([modmath.add_mod(acc[:, 0], bias_dual, mp), acc[:, 1]], 1)
        if self.dual_rescale is not None:          # dual-domain boundary
            out = self.dual_rescale(acc)
        else:
            out = self.rescale(_intt_t(acc, self.ct_ring))
        if place is not None:
            out = place.cut_rows(out[place.batch(out.shape[0])], L - 1)
        return out


class BiasRescaleLayer(_RescaleBy):
    """Bias add (dual) + rescale, after a matmul layer. ``forward(c1d, c2d,
    bias_dual)`` → the two components at the dropped tower, primal (or dual
    when ``dual_out``). Its constants are made on the CPU; ``.to(device)``
    moves them."""

    def __init__(self, ct_ring: RingContext, dual_out: bool = False, eager: bool = False):
        super().__init__(ct_ring, "cpu", eager)
        self.dual_rescale = DualRescale(ct_ring) if dual_out else None

    def compute(self, c1d, c2d, bias_dual):
        c1d = modmath.add_mod(c1d, bias_dual, self.ct_ring.mp)
        stack = torch.stack([c1d, c2d], 0)
        if self.dual_rescale is not None:          # dual-domain boundary
            out = self.dual_rescale(stack)
        else:
            out = self.rescale(_intt_t(stack, self.ct_ring))
        return out[0], out[1]


class MeshPlacement:
    """Where a serving-pipeline tensor lives on a ('dp', 'rp') mesh
    (:class:`.sharding.Mesh`), by the reference's rule: a grid, channel or
    batch axis on 'dp' where 'dp' divides its extent, the limb axis on 'rp'
    where 'rp' divides the level, whole elsewhere. Two consecutive levels
    are never both divisible, so a rescale's input and output are never
    both cut: a layer whose level is cut and whose result is not gathers
    its rows (one all-gather over 'rp') before it rescales."""

    def __init__(self, mesh: S.Mesh):
        self.mesh = mesh
        self.n_dp, self.n_rp = mesh.shape["dp"], mesh.shape["rp"]

    def limbs_cut(self, L: int) -> bool:
        return self.n_rp > 1 and L % self.n_rp == 0

    def rows(self, L: int) -> slice:
        """This rank's limb rows of a level-L tensor."""
        if not self.limbs_cut(L):
            return slice(None)
        step = L // self.n_rp
        lo = self.mesh.index("rp") * step
        return slice(lo, lo + step)

    def cut_rows(self, x: torch.Tensor, L: int) -> torch.Tensor:
        return x[..., self.rows(L), :]

    def gather_rows(self, x: torch.Tensor, L: int) -> torch.Tensor:
        """The whole level-L tensor from this rank's rows."""
        if not self.limbs_cut(L):
            return x
        return S.all_gather(x, self.mesh, "rp", -2, "level_gather")

    def dp_cut(self, extent: int) -> bool:
        return self.n_dp > 1 and extent % self.n_dp == 0

    def batch(self, extent: int) -> slice:
        """This rank's block of a leading axis of ``extent``."""
        if not self.dp_cut(extent):
            return slice(None)
        step = extent // self.n_dp
        lo = self.mesh.index("dp") * step
        return slice(lo, lo + step)

    def dp_sum(self, x: torch.Tensor, extent: int, mp, site: str) -> torch.Tensor:
        """A modular sum over this rank's block of an axis of ``extent``,
        completed over 'dp' where that axis is cut (exact, in any order)."""
        if not self.dp_cut(extent):
            return x
        return S.all_sum(x, self.mesh, "dp", mp, site)


class BatchEncryptor(_Compiled):
    """Batched CKKS public-key encryption under raising params: sample at the
    full tower, drop the raising limbs, add the plaintexts.
    ``forward(pts_primal (B, Lc, N), gen)`` → ct duals (B, 2, Lc, N) on the
    public key's device, sampled from the ``torch.Generator`` ``gen``.

    Per ciphertext: u, e1, e2 rounded from N(0, σ²) float32 samples (one
    coefficient vector each, broadcast over the limbs), c1 = b·u + e1 + m,
    c2 = a·u + e2. Only the kept ciphertext limbs are transformed: every
    limb's NTT depends on that limb alone, so this equals transforming the
    full tower and dropping the raising rows."""

    def __init__(self, params, pub, sigma: float = 3.2, eager: bool = False):
        super().__init__(eager)
        full = params.params.ring_cipher
        ct = params.ring_cipher
        if full.primes[:ct.nlimbs] != ct.primes:
            raise ValueError("the ciphertext tower must be a prefix of the key tower")
        self.full, self.ct_ring = full, ct
        self.sigma = float(sigma)
        lc = ct.nlimbs
        self.register_buffer("mask_d", R.ensure_dual(full, pub.key.mask).dual[:lc])
        self.register_buffer("masked_d", R.ensure_dual(full, pub.key.masked).dual[:lc])

    def sample(self, gen: torch.Generator, batch: int) -> torch.Tensor:
        """Rounded Gaussian integers int64[batch, 3, 1, N] (u, e1, e2)."""
        n = self.ct_ring.n
        g = torch.randn((batch, 3, 1, n), generator=gen, dtype=torch.float32,
                        device=self.mask_d.device) * self.sigma
        return torch.round(g).to(torch.int64)

    def compute(self, pts_primal, gen: torch.Generator):
        ct = self.ct_ring
        mp = ct.mp
        B, lc, n = pts_primal.shape
        ints = self.sample(gen, B).expand(B, 3, lc, n)
        d = _ntt_t(modmath.from_signed(ints, mp), ct)          # (B, 3, Lc, N)
        u, e1, e2 = d[:, 0], d[:, 1], d[:, 2]
        c1 = modmath.add_mod(modmath.mul_mod(self.masked_d, u, mp), e1, mp)
        c2 = modmath.add_mod(modmath.mul_mod(self.mask_d, u, mp), e2, mp)
        c1 = modmath.add_mod(c1, _ntt_t(pts_primal, ct), mp)
        return torch.stack([c1, c2], 1)
