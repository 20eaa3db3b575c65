"""Encrypted ResNet-20 on CIFAR-10: He et al.'s 6n+2 network under
bootstrapped CKKS, as Lee et al. (ICML 2022) run it — convolutions over
channel-packed ciphertexts, a composite-polynomial ReLU and a refresh
before every conv but the first.

The plain model is :mod:`.resnet_plain`; the configuration is a dict
(``fhebench/configs/resnet20-cifar10.json``, ``model`` and ``recipe``).

**Slot layout.** A stage's activations are channel-major ``[C, H, W]``:
as many channels a ciphertext as its N/2 slots hold (4 of 32×32, 16 of
16×16, 64 of 8×8 at N = 2^13), so 4, 2 and 1 ciphertexts at 16, 32 and 64
channels; the [3, 32, 32] input is one. Channel j lies at a channel slot of
a ciphertext given by the stage's :class:`Layout` — a fixed permutation of
the plain order, chosen so that the stride-2 repack needs few rotations.

**Every linear layer is one** :class:`SlotMap`:
``out_h = Σ_g rot_g(Σ_{s,b} rot_b(in_s) ⊙ W[h, g, s, b])`` — baby
rotations of the inputs, hoisted (``rlwe.rotate_many``), plaintext
products summed by giant step, the giant rotations under one lazy ModDown
(``rlwe.rotate_sum``), split into inner and outer steps to keep the key set
small. A 3×3 conv takes its taps as baby steps and its channel offsets
(multiples of H·W) as giant steps, the zero padding folded into the weight
vectors; a stride-2 conv writes its outputs at the even pixels of a layout
of the input's size, and a second map (one plaintext level, 0/1 vectors)
moves them to the next stage's layout: the column shift as a baby step,
the row and channel shifts as giant steps. Batch norm is folded into each
conv's weights and bias, the CIFAR-10 channel mean and deviation into the
first conv's weights and a per-pixel bias (exact at the padded border).
Average pooling and the FC layer are one map onto the classes' slots and a
rotate-and-sum over each class's H·W slots.

**Scales and levels.** Values are carried in units of the configuration's
``bound`` B, so every ReLU input lies in [−1, 1]: B is folded into the
weights. The image is encrypted at 2^52, as a refresh leaves its output;
a conv multiplies a 2^52 ciphertext by weights at 2^26 and rescales two
limbs, a stride-2 conv one, so that its repack's rotations also act at
2^52; the ReLU runs at about 2^26 a limb. The slots are complex, and the
sign polynomial, steep near 0, grows an imaginary part off the real axis
until the ReLU diverges: a rotation's key switch adds noise of about 2^10
whatever the scale (2^−16 of a slot at 2^26, nothing at 2^52), and each
refresh's output is projected on its real part (:func:`real_part`).
The ReLU is ``u·(1 + s(u))/2`` with ``s`` the composite sign polynomial,
each component by ``bootstrap.eval_chebyshev`` (Paterson–Stockmeyer) on
the input as it is. Its output is aligned to the refresh's base (two
limbs at 2^52) and refreshed by ``bootstrap``'s three phases on the
batch of the stage's ciphertexts, SlotToCoeff's output projected on its
real part. A block refreshes its input and the
input of its second conv; the shortcut is aligned to the conv's output
(``ckks_encoding.ct_to``), or repacked with it at a stride.

Every stage after the host encode is a replayed CUDA graph
(``utils.graphs.jit``) in one pool, named for the stage clock by kind:
``encrypt``, ``conv`` (each conv with its bias and rescale, and each
stride-2 repack), ``relu`` (with the alignment to the refresh's base),
``modraise_c2s``, ``evalmod``, ``s2c``, ``shortcut``, ``pool_fc``. A
layer encodes its weight vectors at the level of its input the first time
it runs — one ``ckks_encode_batch`` a layer, in the first request, which
set-up serves.

Counters (``utils.metrics.count``, per request): ``resnet.refresh_ciphertexts``,
``resnet.conv_rotations`` (the key-switched rotations of the conv stages)
and ``resnet.relu_ct_mults`` (ciphertext products in the ReLUs).
"""

from __future__ import annotations

import dataclasses
import math
import types
from fractions import Fraction
from typing import Optional

import numpy as np
import torch

from ..core import bootstrap as B
from ..core import ckks_encoding as CE
from ..core import ring as R
from ..core import rlwe
from ..core.ckks_encoding import CKKSTag
from ..core.ring import RingElt
from ..core.rlwe import CipherText
from ..ops import modmath
from ..parallel import layers as JL
from ..utils import graphs, metrics
from ..utils.metrics import span
from . import mnist as M

WEIGHT_SCALE = Fraction(2) ** 26      # every weight, mask and FC vector
BASE_SCALE = Fraction(2) ** 52        # the refresh's input and output scale
BASE_LIMBS = 2                        # the refresh's input tower
TERM_CHUNK = 128                      # plaintext products formed at once


# ---------------------------------------------------------------------------
# slot layouts
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Layout:
    """Channel-major activations of ``side``×``side`` pixels: ``cpc``
    channel slots a ciphertext, ``n_ct`` ciphertexts, channel j at
    ``where[j]`` = (ciphertext, channel slot). Slot of (channel slot c,
    pixel y, x): c·side² + y·side + x."""
    side: int
    cpc: int
    n_ct: int
    where: tuple

    @property
    def hw(self) -> int:
        return self.side * self.side

    @property
    def slots(self) -> int:
        return self.cpc * self.hw


def plain_layout(side: int, channels: int, slots: int) -> Layout:
    """Channel j at ciphertext j // cpc, slot j % cpc."""
    if side * side > slots:
        raise ValueError(f"a {side}×{side} channel does not fit {slots} slots")
    cpc = slots // (side * side)
    return Layout(side, cpc, -(-channels // cpc),
                  tuple((j // cpc, j % cpc) for j in range(channels)))


def strided_layout(lin: Layout, cout: int) -> Layout:
    """Where a stride-2 conv from ``lin`` writes its ``cout`` = 2·C_in
    outputs (at the even pixels, ``lin``'s size): channel j < C_in where
    ``lin`` holds channel j, channel C_in + j in the ciphertext
    ``lin.n_ct`` further on, same slot."""
    cin = len(lin.where)
    if cout != 2 * cin:
        raise ValueError("a stride-2 conv doubles the channels")
    where = lin.where + tuple((s + lin.n_ct, c) for s, c in lin.where)
    return Layout(lin.side, lin.cpc, 2 * lin.n_ct, where)


def repacked_layout(lfull: Layout) -> Layout:
    """The next stage's layout: half the side, four times the channel
    slots; the channel at (s, c) of ``lfull`` moves to ciphertext s // 4,
    slot 4c + s % 4 (so a ciphertext's move is one shift a row of pixels
    plus a column shift: see :func:`repack_plan`)."""
    if lfull.side % 2:
        raise ValueError("a stride-2 repack needs an even side")
    where = tuple((s // 4, 4 * c + s % 4) for s, c in lfull.where)
    return Layout(lfull.side // 2, 4 * lfull.cpc, max(s for s, _ in where) + 1, where)


def stage_layouts(model: dict, slots: int) -> list:
    """[input, stage 1, stage 2, …] layouts."""
    side = model["image"]
    out = [plain_layout(side, model["in_channels"], slots),
           plain_layout(side, model["widths"][0], slots)]
    for i in range(1, len(model["widths"])):
        out.append(repacked_layout(strided_layout(out[-1], model["widths"][i])))
    return out


# ---------------------------------------------------------------------------
# plans: what a SlotMap computes, in numpy
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Plan:
    """``out_h = Σ_g rot_g(Σ_{s,b} rot_b(in_s) ⊙ vecs[k])`` over the terms
    k = (h, g, s, b) (``hgsb`` [K, 4]); giant g is ``giants[g]`` = (outer,
    inner) shifts, its rotation the inner then the outer one; ``bias``
    [n_out, slots] or None. rot_k(v)[j] = v[j + k]."""
    n_in: int
    n_out: int
    babies: list
    giants: list
    hgsb: np.ndarray
    vecs: np.ndarray
    bias: Optional[np.ndarray] = None


def channel_giants(cpc: int, hw: int) -> list:
    """The giant steps of the channel offsets d·hw, d < cpc, as (outer,
    inner) = ((d − d mod m)·hw, (d mod m)·hw), m = ⌈√cpc⌉: 2(m − 1) keys in
    place of cpc − 1."""
    m = math.isqrt(cpc - 1) + 1 if cpc > 1 else 1
    return [((d // m) * m * hw, (d % m) * hw) for d in range(cpc)]


TAPS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def _plan_from_dense(dense: np.ndarray, n_out: int, n_in: int, babies, giants, bias) -> Plan:
    """Plan of the nonzero vectors of dense [n_out, G, n_in, nb, slots]."""
    nz = np.argwhere(np.any(dense != 0, axis=-1))
    return Plan(n_in, n_out, list(babies), list(giants), nz.astype(np.int64),
                dense[tuple(nz.T)], bias)


def conv_plan(w: np.ndarray, bias: np.ndarray, lin: Layout, lout: Layout,
              stride: int = 1) -> Plan:
    """A 3×3 conv, padding 1, from ``lin`` to ``lout`` (same side): ``w``
    [C_out, C_in, 3, 3], ``bias`` [C_out] or [C_out, side, side] (added at
    every output pixel). ``stride`` 2: outputs at the even pixels only."""
    side, hw, cpc = lin.side, lin.hw, lin.cpc
    if (lout.side, lout.cpc) != (side, cpc):
        raise ValueError("a conv plan keeps the side and channel slots")
    cout, cin = w.shape[:2]
    y, x = np.divmod(np.arange(hw), side)
    keep = ((y % stride == 0) & (x % stride == 0)).astype(np.float64)
    h_o = np.array([lout.where[o][0] for o in range(cout)])
    c_o = np.array([lout.where[o][1] for o in range(cout)])
    s_i = np.array([lin.where[i][0] for i in range(cin)])
    c_i = np.array([lin.where[i][1] for i in range(cin)])
    d = (c_i[None, :] - c_o[:, None]) % cpc                            # [cout, cin]
    dense = np.zeros((lout.n_ct, cpc, lin.n_ct, len(TAPS), cpc, hw))
    for t, (dy, dx) in enumerate(TAPS):
        valid = keep * ((y + dy >= 0) & (y + dy < side) & (x + dx >= 0) & (x + dx < side))
        dense[h_o[:, None], d, s_i[None, :], t, c_i[None, :], :] = (
            w[:, :, dy + 1, dx + 1][:, :, None] * valid)
    b = np.zeros((lout.n_ct, cpc, hw))
    bias = np.asarray(bias, dtype=np.float64)
    b[h_o, c_o, :] = (bias.reshape(cout, hw) if bias.ndim == 3 else bias[:, None]) * keep
    babies = [dy * side + dx for dy, dx in TAPS]
    return _plan_from_dense(dense.reshape(lout.n_ct, cpc, lin.n_ct, len(TAPS), -1),
                            lout.n_ct, lin.n_ct, babies, channel_giants(cpc, hw),
                            b.reshape(lout.n_ct, -1))


def repack_plan(lsrc: Layout, lnext: Layout, channels: int) -> Plan:
    """The stride-2 repack of the first ``channels`` channels of ``lsrc``
    (their even pixels) to ``lnext`` (:func:`repacked_layout` of ``lsrc``'s
    strided layout): element (c, 2y', 2x') of source ciphertext s goes to
    slot (4c + k)·hw/4 + y'·side/2 + x', k = s mod 4 — a shift of
    1.5·side·y' + x' − k·hw/4: baby x', giant (outer −k·hw/4, inner
    1.5·side·y'). One 0/1 vector a (source, y', x')."""
    side, hw = lsrc.side, lsrc.hw
    half = side // 2
    vecs: dict = {}
    for j in range(channels):
        s, c = lsrc.where[j]
        h, c2 = lnext.where[j]
        k = s % 4
        if (h, c2) != (s // 4, 4 * c + k):
            raise ValueError("the target layout is not the repack of the source's")
        for yy in range(half):
            for xx in range(half):
                key = (h, k * half + yy, s, xx)
                if key not in vecs:
                    vecs[key] = np.zeros(lsrc.slots)
                vecs[key][c * hw + 2 * yy * side + xx] = 1.0
    keys = sorted(vecs)
    giants = [(-k * hw // 4, 3 * side * yy // 2) for k in range(4) for yy in range(half)]
    return Plan(lsrc.n_ct, max(k[0] for k in keys) + 1, list(range(half)), giants,
                np.array(keys, dtype=np.int64), np.stack([vecs[k] for k in keys]), None)


def fc_plan(w: np.ndarray, lin: Layout) -> Plan:
    """Average pool and the FC layer up to the rotate-and-sum: logit k
    gathers Σ_o w[k, o]·x[o, p] at slot k·hw + p (``w`` [classes, C] holds
    the 1/hw); one output ciphertext."""
    hw, cpc = lin.hw, lin.cpc
    classes, cin = w.shape
    if classes > cpc:
        raise ValueError("the classes' slots must fit one ciphertext")
    dense = np.zeros((1, cpc, lin.n_ct, 1, cpc, hw))
    for o in range(cin):
        s, c = lin.where[o]
        for k in range(classes):
            dense[0, (c - k) % cpc, s, 0, c, :] = w[k, o]
    return _plan_from_dense(dense.reshape(1, cpc, lin.n_ct, 1, -1), 1, lin.n_ct, [0],
                            channel_giants(cpc, hw), None)


def pool_steps(hw: int) -> list:
    """Rotate-and-sum shifts that gather hw consecutive slots into the
    first: hw/2, hw/4, …, 1."""
    out, k = [], hw // 2
    while k:
        out.append(k)
        k //= 2
    return out


def apply_plan(plan: Plan, ins: np.ndarray) -> np.ndarray:
    """The plan on slot vectors in the clear: ins [n_in, slots] → [n_out,
    slots] (the bias included)."""
    out = np.zeros((plan.n_out, ins.shape[1]))
    for (h, g, s, b), v in zip(plan.hgsb, plan.vecs):
        out[h] += np.roll(np.roll(ins[s], -plan.babies[b]) * v, -sum(plan.giants[g]))
    return out if plan.bias is None else out + plan.bias


# ---------------------------------------------------------------------------
# the model's plans, from the weights
# ---------------------------------------------------------------------------

def _bn_fold(params: dict, name: str, eps: float):
    a = params[f"{name}.gamma"] / np.sqrt(params[f"{name}.var"] + eps)
    return a, params[f"{name}.beta"] - a * params[f"{name}.mean"]


def stem_weights(model: dict, params: dict):
    """The first conv with its batch norm, the input normalisation and
    1/B folded in: (w [C, 3, 3, 3], bias [C, side, side]). Zero padding
    pads the normalised image, so the normalisation's shift leaves out the
    taps that fall outside the image: a bias a pixel."""
    a, b = _bn_fold(params, "stem", model["bn_eps"])
    mean, std = np.asarray(model["mean"]), np.asarray(model["std"])
    bound = model["bound"]
    w = params["stem.w"] * a[:, None, None, None] / std[None, :, None, None]
    side = model["image"]
    inside = np.zeros((3, 3, side, side))
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            inside[dy + 1, dx + 1, max(0, -dy):side - max(0, dy),
                   max(0, -dx):side - max(0, dx)] = 1.0
    shift = np.einsum("oitu,i,tuyx->oyx", w, mean, inside)
    return w / bound, (b[:, None, None] - shift) / bound


def conv_weights(model: dict, params: dict, name: str):
    """A conv with its batch norm folded in, in units of B: (w, bias)."""
    a, b = _bn_fold(params, name, model["bn_eps"])
    return params[f"{name}.w"] * a[:, None, None, None], b / model["bound"]


def rotation_shifts(model: dict, slots: int) -> list:
    """Every rotation the pipeline makes, as shifts mod ``slots``, sorted."""
    lays = stage_layouts(model, slots)
    shifts = set()
    for lay in lays[1:]:
        shifts |= {dy * lay.side + dx for dy, dx in TAPS}
        shifts |= {v for g in channel_giants(lay.cpc, lay.hw) for v in g}
    for i in range(1, len(lays) - 1):
        side, hw = lays[i].side, lays[i].hw
        half = side // 2
        shifts |= set(range(half))
        shifts |= {-k * hw // 4 for k in range(4)} | {3 * side * y // 2 for y in range(half)}
    shifts |= set(pool_steps(lays[-1].hw))
    return sorted({s % slots for s in shifts} - {0})


def galois_element(n: int, shift: int) -> int:
    """The Galois element of rot_shift (rot_k(v)[j] = v[j + k])."""
    return rlwe.galois_element_for_steps(n, -(shift % (n // 2)))


# ---------------------------------------------------------------------------
# the encrypted layers
# ---------------------------------------------------------------------------

class SlotMap:
    """A :class:`Plan` on ciphertexts: a batch of ``n_in`` ciphertexts
    (components [n_in, L, N]) in, ``n_out`` out, rescaled ``rescales``
    limbs. The vectors are encoded in the input's tower the first time a
    tower is seen (one ``ckks_encode_batch``), at :func:`weight_scale`; the
    bias at the product's scale. ``counter`` names the process counter its
    rotations add to."""

    def __init__(self, plan: Plan, gks, rescales: int, counter: Optional[str] = None):
        self.plan, self.gks, self.rescales, self.counter = plan, gks, rescales, counter
        self._enc: dict = {}
        used = {int(g) for g in plan.hgsb[:, 1]}
        self.giants = sorted(used)
        self.outers = sorted({plan.giants[g][0] for g in self.giants})

    def rotations(self) -> int:
        """Key-switched rotations a call makes, per ciphertext: the distinct
        nonzero baby shifts of each input, the nonzero inner shifts of the
        used giants and the nonzero outer shifts, of each output."""
        p, slots = self.plan, self.plan.vecs.shape[1]
        babies = len({b % slots for b in p.babies} - {0})
        inner = sum(1 for g in self.giants if p.giants[g][1] % slots)
        outer = sum(1 for o in self.outers if o % slots)
        return p.n_in * babies + p.n_out * (inner + outer)

    def _encoded(self, ring, scale: Fraction, device):
        key = (ring, scale, device)
        if key not in self._enc:
            p = self.plan
            ws = weight_scale(scale)
            w = R.ensure_dual(ring, RingElt(primal=CE.ckks_encode_batch(
                ring, p.vecs, ws, device))).dual                         # [K, L, N]
            bias = None
            if p.bias is not None:
                bias = _encode_at(ring, p.bias, scale * ws, device)
            slot = {g: i for i, g in enumerate(self.giants)}
            rows = np.array([slot[g] for g in p.hgsb[:, 1]]) * p.n_out + p.hgsb[:, 0]
            idx = torch.as_tensor(np.stack([rows, p.hgsb[:, 2], p.hgsb[:, 3]], 1),
                                  device=device)                   # (acc row, s, b)
            self._enc[key] = (w, bias, idx)
        return self._enc[key]

    def __call__(self, ct: CipherText) -> CipherText:
        p, ring, n = self.plan, ct.ring, ct.ring.n
        scale = Fraction(ct.enc.scale)
        dev = ct.cs[0].device
        w, bias, idx = self._encoded(ring, scale, dev)
        mp = ring.mp
        rot = [b for b in p.babies if b % (n // 2)]
        hoisted = rlwe.rotate_many(self.gks, ct, [galois_element(n, b) for b in rot]) if rot else {}
        babies = [ct if b % (n // 2) == 0 else hoisted[galois_element(n, b)] for b in p.babies]
        stack = torch.stack([torch.stack([R.ensure_dual(ring, x).dual for x in c.cs], 1)
                             for c in babies], 0)                     # [nb, n_in, 2, L, N]
        acc = torch.zeros((len(self.giants) * p.n_out, 2) + stack.shape[-2:],
                          dtype=torch.int64, device=dev)
        for lo in range(0, w.shape[0], TERM_CHUNK):
            k = idx[lo:lo + TERM_CHUNK]
            prod = modmath.mul_mod(w[lo:lo + TERM_CHUNK, None], stack[k[:, 2], k[:, 1]], mp)
            acc.index_add_(0, k[:, 0], prod)
        acc = modmath.umod(acc, mp.on(dev).p).reshape(len(self.giants), p.n_out, 2,
                                                      *stack.shape[-2:])
        tag = CKKSTag(scale * weight_scale(scale))
        outer_terms = []
        for o in self.outers:
            terms = []
            for i, g in enumerate(self.giants):
                if p.giants[g][0] != o:
                    continue
                inner = p.giants[g][1] % (n // 2)
                t = CipherText(ct.params, (RingElt(dual=acc[i, :, 0]), RingElt(dual=acc[i, :, 1])),
                               ring, enc=tag)
                terms.append((galois_element(n, inner) if inner else None, t))
            o_mod = o % (n // 2)
            outer_terms.append((galois_element(n, o_mod) if o_mod else None,
                                rlwe.rotate_sum(self.gks, terms)))
        out = rlwe.rotate_sum(self.gks, outer_terms)
        if bias is not None:
            out = rlwe.ct_add_ring(out, RingElt(dual=bias))
        if self.counter:
            metrics.count(self.counter, self.rotations())
        for _ in range(self.rescales):
            out = rlwe.ct_rescale(out)
        return out


def weight_scale(scale: Fraction) -> Fraction:
    """The scale a layer's vectors are encoded at for an input at ``scale``:
    2^78 / scale for a power of two above 2^52 (a refreshed input, whose
    real part doubled its scale), so that its product lands at 2^78 as the
    image's does; else :data:`WEIGHT_SCALE`."""
    if scale > BASE_SCALE and scale.denominator == 1 and scale.numerator & (scale.numerator - 1) == 0:
        return BASE_SCALE * WEIGHT_SCALE / scale
    return WEIGHT_SCALE


def real_part(gk_conj, ct: CipherText) -> CipherText:
    """The slots' real part: ct + conj(ct), its scale tag doubled (exact,
    no level). A refresh's output carries its error in the imaginary parts
    too; left there, the convs gather it and the sign polynomial, steep
    near 0, grows it off the real axis until the ReLU diverges. Taken at a
    refresh's 2^52, the conjugation's key switch adds nothing visible."""
    return CE.retag(rlwe.ct_add(ct, B.conjugate(gk_conj, ct)), 2 * Fraction(ct.enc.scale))


def _encode_at(ring, vecs: np.ndarray, scale: Fraction, device) -> torch.Tensor:
    """Slot vectors [G, N/2] at ``scale``, dual. A power of two above
    2^26 is encoded at 2^26 and multiplied by the rest, exactly, in the
    residues (the big-integer encode of every coefficient avoided; the
    rounding is then at 2^26)."""
    if scale.denominator == 1 and scale.numerator & (scale.numerator - 1) == 0 \
            and scale > WEIGHT_SCALE:
        rest = int(scale / WEIGHT_SCALE)
        pe = CE.ckks_encode_batch(ring, vecs, WEIGHT_SCALE, device)
        col = modmath.const([[rest % p] for p in ring.primes], device)
        pe = modmath.mul_mod(pe, col, ring.mp)
    else:
        pe = CE.ckks_encode_batch(ring, vecs, scale, device)
    return R.ensure_dual(ring, RingElt(primal=pe)).dual


def steady_scale(ring, levels: int = 8) -> Fraction:
    """The scale at which a chain of squarings, each rescaled by one limb
    of ``ring`` from the top, keeps its scale: s·2^e with e = Σⱼ δⱼ/2^(j+1),
    δⱼ = log₂(pⱼ / 2^26) for the j-th limb consumed. At N = 2^13 the limbs
    sit up to 0.09 bit off 2^26 (balanced in pairs for the refresh), and
    s' = s²/p doubles a scale's offset at every level: from 2^26 itself a
    component of degree 27 loses several bits, two in a row collapse."""
    primes = ring.primes[::-1][:levels]
    e = sum(math.log2(p / 2.0 ** 26) / 2 ** (j + 1) for j, p in enumerate(primes))
    return Fraction(round(2.0 ** (26 + e)))


def app_relu(ek, u: CipherText, comps, store: dict) -> CipherText:
    """``u·(1 + s(u))/2`` on a batch of ciphertexts holding u ∈ [−1, 1]:
    the first component of s by ``eval_chebyshev`` on u as it is, each later
    one on its input set to the steady scale of the limbs it will spend
    (one level), one limb a level; the 1/2 on u's spare levels. Counts its
    ciphertext products (``resnet.relu_ct_mults``, per ciphertext)."""
    before = metrics.counters["enc_mul"]
    with CE.encode_cache(store):
        s = B.eval_chebyshev(ek, u, comps[0], 1.0, scale_limbs=1, prescaled=True)
        for c in comps[1:]:
            pin = steady_scale(s.ring.drop_last()) * s.ring.primes[-1] / s.enc.scale
            s = rlwe.ct_rescale(CE.mul_plain_scalar_at(s, 1.0, pin))
            s = B.eval_chebyshev(ek, s, c, 1.0, scale_limbs=1, prescaled=True)
        half = rlwe.ct_rescale(CE.mul_plain_scalar_at(u, 0.5, u.ring.primes[-1]))
        nl = min(half.ring.nlimbs, s.ring.nlimbs)
        prod = rlwe.keyswitch(ek, rlwe.ct_mul(CE.ct_drop_to(half, nl), CE.ct_drop_to(s, nl)))
        prod = rlwe.ct_rescale(prod)
        out = rlwe.ct_add(prod, CE.ct_to(half, prod.ring.nlimbs, prod.enc.scale))
    metrics.count("resnet.relu_ct_mults", (metrics.counters["enc_mul"] - before) * _batch(u))
    return out


def identity_shortcut(h: CipherText, x: CipherText) -> CipherText:
    """h + x, the block input x aligned to h's tower and scale."""
    return rlwe.ct_add(h, CE.ct_to(x, h.ring.nlimbs, h.enc.scale))


def _batch(ct: CipherText) -> int:
    """Ciphertexts in a batch (leading axes)."""
    x = ct.cs[0].primal if ct.cs[0].primal is not None else ct.cs[0].dual
    return math.prod(x.shape[:-2])


def _add_first(a: CipherText, b: CipherText) -> CipherText:
    """a + b on the first len(b) ciphertexts of the batch a."""
    nb, ring = _batch(b), a.ring
    if nb == _batch(a):
        return rlwe.ct_add(a, b)
    cs = []
    for x, y in zip(a.cs, b.cs):
        xd, yd = R.ensure_dual(ring, x).dual, R.ensure_dual(ring, y).dual
        cs.append(RingElt(dual=torch.cat([modmath.add_mod(xd[:nb], yd, ring.mp), xd[nb:]], 0)))
    a.enc.combine_add(b.enc)
    return CipherText(a.params, tuple(cs), ring, enc=a.enc)


# ---------------------------------------------------------------------------
# set-up and the pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ResNetSetup:
    model: dict
    params: object
    kp: rlwe.KeyPair
    gks: rlwe.GaloisKeys
    shifts: list


def fhe_setup_resnet(model: dict, recipe: dict, gen: torch.Generator):
    """Keys on the generator's device: the composite tower of ``recipe``
    (``bootstrap.make_boot_ring``, ``HybridRaised``, a sparse secret, as
    the bootstrapped MNIST pipeline builds it), the key pair, one Galois key
    for each rotation of :func:`rotation_shifts`, and the refresh's context
    (``bootstrap.setup_bootstrap``: its rotation, conjugation and
    relinearization keys). Returns (setup, boot_ctx)."""
    r = dict(recipe)
    depth, h = r.pop("depth"), r.pop("hamming_weight")
    params, _ = M.make_bootstrapped_params(types.SimpleNamespace(ring_logn=model["ring_logn"]),
                                           depth, hamming_weight=h,
                                           scale_limbs=int(r["scale_limbs"]))
    kp = rlwe.keygen(params, gen)
    n = params.ring_cipher.n
    shifts = rotation_shifts(model, n // 2)
    gks = rlwe.GaloisKeys([rlwe.keygen_galois(gen, kp.priv, galois_element=galois_element(n, s))
                           for s in shifts])
    return ResNetSetup(model, params, kp, gks, shifts), B.setup_bootstrap(gen, kp.priv, **r)


def build_resnet_pipeline(setup: ResNetSetup, boot_ctx, weights: dict):
    """The encrypted ResNet on ``setup``'s keys (see the module docstring);
    returns ``run(images [1, C, H, W], gen, layer_times=None) -> logits
    [classes, 1]``, with ``run.encode(images)`` (the host encode),
    ``run.forward(pts, gen)`` (the stages to the logits ciphertext),
    ``run.decrypt(ct)``, ``run.pool`` (the graphs' pool) and ``run.layers``
    (every :class:`SlotMap` by name). ``layer_times`` (a dict) collects each stage
    kind's milliseconds on the host clock, the device synchronised between
    stages. Under a running ``torch.profiler`` a call is a ``toyfhe.run``
    span holding ``toyfhe.encode``, ``toyfhe.forward`` (a
    ``toyfhe.stage.<kind>`` a stage) and ``toyfhe.decrypt``."""
    model, params = setup.model, setup.params
    device = setup.kp.pub.key.mask.device
    ring0 = params.ring_cipher
    n = ring0.n
    slots = n // 2
    lays = stage_layouts(model, slots)
    ek = boot_ctx.ek
    pool = graphs.Pool()
    stage = lambda fn, name: graphs.jit(fn, pool=pool, name=name)
    store: dict = {}
    comps = [np.asarray(c, dtype=np.float64) for c in model["relu"]["coeffs"]]

    # ---- the layers ----
    layers = {}
    w, b = stem_weights(model, weights)
    conv = "resnet.conv_rotations"
    layers["stem"] = SlotMap(conv_plan(w, b, lays[0], lays[1]), setup.gks, 2, conv)
    blocks = []
    lin = lays[1]
    for i, width in enumerate(model["widths"]):
        for j in range(model["blocks_per_stage"]):
            name = f"s{i}.b{j}"
            down = i > 0 and j == 0
            w1, b1 = conv_weights(model, weights, name + ".conv1")
            if down:
                lfull = strided_layout(lin, width)
                lout = lays[i + 1]
                # one limb: the repack's rotations then act at 2^52 too
                layers[name + ".conv1"] = SlotMap(conv_plan(w1, b1, lin, lfull, 2), setup.gks,
                                                  1, conv)
                layers[name + ".repack"] = SlotMap(repack_plan(lfull, lout, width), setup.gks,
                                                   2, conv)
                layers[name + ".shortcut"] = SlotMap(repack_plan(lin, lout, len(lin.where)),
                                                     setup.gks, 2)
            else:
                lout = lin
                layers[name + ".conv1"] = SlotMap(conv_plan(w1, b1, lin, lout), setup.gks,
                                                  2, conv)
            w2, b2 = conv_weights(model, weights, name + ".conv2")
            layers[name + ".conv2"] = SlotMap(conv_plan(w2, b2, lout, lout), setup.gks, 2, conv)
            blocks.append((name, down))
            lin = lout
    hw = lin.hw
    # not rescaled: the rotate-and-sum then also acts at about 2^52
    layers["fc"] = SlotMap(fc_plan(weights["fc.w"] * model["bound"] / hw, lin), setup.gks, 0)
    fc_bias = np.zeros((1, slots))
    fc_bias[0, np.arange(model["classes"]) * hw] = weights["fc.b"]
    top = BASE_LIMBS + 1 + _segment_limbs(model)                  # the stem's tower

    # ---- the stages ----
    enc = JL.BatchEncryptor(params, setup.kp.pub, sigma=3.2, eager=True)

    def encrypt(pts, gen):
        x = enc(pts, gen)                                         # (n_ct, 2, L0, N) dual
        ct = CipherText(params, (RingElt(dual=x[:, 0]), RingElt(dual=x[:, 1])), ring0,
                        enc=CKKSTag(BASE_SCALE))
        return CE.ct_drop_to(ct, min(top, ring0.nlimbs))

    def relu_to_base(u):
        return CE.ct_to(app_relu(ek, u, comps, store), BASE_LIMBS, BASE_SCALE)

    def strided_shortcut(repack):
        return lambda h, x: _add_first(h, repack(x))

    def phase1(ct):
        metrics.count("resnet.refresh_ciphertexts", _batch(ct))
        return B.bootstrap_phase1(boot_ctx, ct)

    lazy_bias: dict = {}

    def pool_fc(u):
        z = layers["fc"](u)
        for k in pool_steps(hw):
            z = rlwe.ct_add(z, rlwe.rotate(setup.gks.for_element(galois_element(n, k)), z))
        key = (z.ring, Fraction(z.enc.scale))
        if key not in lazy_bias:
            lazy_bias[key] = _encode_at(z.ring, fc_bias, key[1], z.cs[0].device)
        return rlwe.ct_index(rlwe.ct_add_ring(z, RingElt(dual=lazy_bias[key])), 0)

    st = {"encrypt": stage(encrypt, "encrypt"),
          "relu": stage(relu_to_base, "relu"),
          "relu_last": stage(lambda u: app_relu(ek, u, comps, store), "relu"),
          "phase1": stage(phase1, "modraise_c2s"),
          "phase2": stage(lambda lo, hi: B.bootstrap_phase2(boot_ctx, lo, hi), "evalmod"),
          "phase3": stage(lambda ev, f, pin: real_part(
              boot_ctx.gk_conj, B.bootstrap_phase3(boot_ctx, ev, f, pin)), "s2c"),
          "pool_fc": stage(pool_fc, "pool_fc")}
    for name, layer in layers.items():
        if name.endswith(".shortcut"):
            st[name] = stage(strided_shortcut(layer), "shortcut")
        elif name != "fc":
            st[name] = stage(layer, "conv")
    st["identity"] = stage(identity_shortcut, "shortcut")

    def encode(images) -> torch.Tensor:
        """The host encode of one image [1, C, H, W]: each input
        ciphertext's slot vector at 2^52, primal [n_ct, L0, N]."""
        with span("toyfhe.encode"):
            with span("toyfhe.encode.preprocess"):
                img = np.asarray(images, dtype=np.float64).reshape(-1, model["image"] ** 2)
                vecs = np.zeros((lays[0].n_ct, slots))
                for j, (s, c) in enumerate(lays[0].where):
                    vecs[s, c * lays[0].hw:(c + 1) * lays[0].hw] = img[j]
            return CE.ckks_encode_batch(ring0, vecs, BASE_SCALE, device)

    def forward(pts, gen, clock):
        def refresh(ct):
            lo, hi = st["phase1"](ct)
            clock("modraise_c2s")
            ev = st["phase2"](lo, hi)
            clock("evalmod")
            out = st["phase3"](ev, *B._phase3_statics(boot_ctx, ct))
            clock("s2c")
            return out

        def conv(name, ct):
            out = st[name](ct)
            clock("conv")
            return out

        def relu_refresh(ct):
            out = st["relu"](ct)
            clock("relu")
            return refresh(out)

        with span("toyfhe.forward"):
            x = st["encrypt"](pts, gen)
            clock("encrypt")
            x = conv("stem", x)
            for k, (name, down) in enumerate(blocks):
                x = relu_refresh(x)                              # the block's input
                h = conv(name + ".conv1", x)
                if down:
                    h = conv(name + ".repack", h)
                h = relu_refresh(h)
                h = conv(name + ".conv2", h)
                h = st[name + ".shortcut" if down else "identity"](h, x)
                clock("shortcut")
                x = h
            x = st["relu_last"](x)
            clock("relu")
            out = st["pool_fc"](x)
            clock("pool_fc")
            return out

    def decrypt(ct) -> np.ndarray:
        dec = rlwe.decrypt(setup.kp, ct).real
        return dec[np.arange(model["classes"]) * hw][:, None]

    def run(images, gen, layer_times: Optional[dict] = None):
        with span("toyfhe.run"):
            clock = M._LayerClock(device, layer_times)
            pts = encode(images)
            clock("encode")
            out = forward(pts, gen, clock)
            logits = decrypt(out)
            clock("decrypt")
            return logits

    run.encode = encode
    run.forward = lambda pts, gen: forward(pts, gen, M._LayerClock(device, None))
    run.decrypt = decrypt
    run.pool = pool
    run.layers = layers
    return run


def _segment_limbs(model: dict) -> int:
    """Limbs a segment from the stem's input to the refresh's base takes
    above the base's two plus the exhaust's one: the stem conv's two and
    the ReLU's (one a level: each component's Paterson–Stockmeyer depth
    plus its coefficients' level, one to set each later component's scale,
    then the product)."""
    degrees = model["relu"]["degrees"]
    relu = sum(math.ceil(math.log2(d + 1)) + 1 for d in degrees) + len(degrees)
    return 2 + relu
