"""Encrypted-MNIST serving: the x²-CNN evaluated homomorphically under CKKS.

Port of the serving subset of ``toyfhe_tpu/models/mnist.py``: a small CNN
with x² activations (conv → square → dense → square → dense) run through
the compiled layers of :mod:`..parallel.layers`:

  * ``public_preprocess`` — batch → k×k grid of patch-position slot vectors,
    each ciphertext holding (batch × positions) slots;
  * conv = plain-scalar multiplies and adds over the grid + bias + rescale;
  * square = ct·ct → relinearize → rescale;
  * dense = rotation-based diagonal matmul: d−1 Galois rotations by
    ``batch`` slots with one key, or, with the keys of
    :func:`keygen_matmul_bsgs`, the baby-step / giant-step schedule with
    hoisted baby rotations (``rlwe.rotate_many``) and one lazy ModDown per
    layer (``rlwe.rotate_sum``);
  * the final rectangular matmul by zero-padding.

With BSGS keys under the hybrid gadget the pipeline runs dual flow by
default — the production serving configuration: layer boundaries carry
dual-domain ciphertexts, conv and bias rescale in the dual domain and both
squares run the fused transform schedule
(``parallel.ops.make_hybrid_fused_step``), bit-identical to the primal flow.

Weights are drawn from a numpy seed (``init_params``; training is not
ported) or carried across from the reference (``utils.interop.mnist_params``).
``model_forward`` is the plaintext pass in numpy, the check of the
encrypted one.
"""

from __future__ import annotations

import dataclasses
import math
import time
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import ring as R
from ..core.ckks import CKKSParams
from ..core import bootstrap as B
from ..core import rlwe
from ..core.ckks_encoding import CKKSTag, ckks_encode, mul_plain_vector
from ..core.hybrid import HybridRaised
from ..core.modraise import ModulusRaised
from ..core.ring import RingElt, make_rns_ring
from ..core.rlwe import (CipherText, EvalMultKey, GaloisKey, KeyPair, UsageError, ct_add,
                         decrypt, keygen, keygen_eval_mult, keygen_galois, rotate)
from ..ops import modmath
from ..parallel import layers as JL
from ..parallel import ops as pops


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MNISTConfig:
    image: int = 28          # image side
    kernel: int = 7          # conv kernel side
    stride: int = 3
    channels: int = 4
    classes: int = 10
    ring_logn: int = 13      # CKKS ring: N = 2^logn, slots = N/2
    # 28-bit ciphertext primes at scale 2^28, then ``num_special`` 29-bit
    # raising primes (P ≈ 2^116 ≥ α·Q_group, the hybrid digit bound)
    limb_bits: Tuple[int, ...] = (28,) * 7 + (29,) * 4
    scale_log2: int = 28
    # key-switch gadget: "hybrid" (dnum-grouped digits) or "modraise" (one
    # special prime, per-limb digits)
    gadget: str = "hybrid"
    dnum: int = 2
    num_special: int = 4

    @property
    def positions(self) -> int:            # conv output positions per image
        side = (self.image - self.kernel) // self.stride + 1
        return side * side

    @property
    def grid(self) -> int:
        return self.kernel

    @property
    def batch(self) -> int:
        # slots = batch * positions
        return (1 << self.ring_logn) // 2 // self.positions

    @property
    def features(self) -> int:
        return self.channels * self.positions


def init_params(cfg: MNISTConfig, seed: int) -> dict:
    """Untrained weights with the reference's distributions, from a numpy
    seed (float64 arrays)."""
    rng = np.random.default_rng(seed)
    d, f = cfg.positions, cfg.features
    return {
        "conv_w": rng.normal(size=(cfg.kernel, cfg.kernel, cfg.channels)) * 0.2,
        "conv_b": np.zeros(cfg.channels),
        "w1": rng.normal(size=(d, f)) * (1.0 / np.sqrt(f)),
        "b1": np.zeros(d),
        "w2": rng.normal(size=(cfg.classes, d)) * (1.0 / np.sqrt(d)),
        "b2": np.zeros(cfg.classes),
    }


def _patches(cfg: MNISTConfig, batch: np.ndarray) -> np.ndarray:
    """[B, H, W] -> [B, positions, kernel*kernel] stride-cropped patches."""
    side = (cfg.image - cfg.kernel) // cfg.stride + 1
    rows = [batch[:, i * cfg.stride: i * cfg.stride + cfg.kernel,
                  j * cfg.stride: j * cfg.stride + cfg.kernel].reshape(batch.shape[0], -1)
            for i in range(side) for j in range(side)]
    return np.stack(rows, axis=1)


def model_forward(cfg: MNISTConfig, params, batch) -> np.ndarray:
    """Plaintext forward pass in float64 numpy, structured exactly like the
    encrypted one: logits [B, classes]."""
    pt = _patches(cfg, np.asarray(batch, dtype=np.float64))
    w = np.asarray(params["conv_w"]).reshape(-1, cfg.channels)
    conv = np.einsum("bpk,kc->bpc", pt, w) + np.asarray(params["conv_b"])
    sq1 = conv ** 2
    # feature layout: channel-major blocks of positions
    feats = np.concatenate([sq1[:, :, c] for c in range(cfg.channels)], axis=1)
    fq1 = feats @ np.asarray(params["w1"]).T + np.asarray(params["b1"])
    sq2 = fq1 ** 2
    return sq2 @ np.asarray(params["w2"]).T + np.asarray(params["b2"])


# ---------------------------------------------------------------------------
# keys and level accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FHESetup:
    cfg: MNISTConfig
    params: object           # HybridRaised or ModulusRaised
    kp: KeyPair
    ek: EvalMultKey
    gk: GaloisKey
    scale: Fraction


# Rescale levels the circuit consumes: conv, square1, dense1, square2.
# dense2 decodes un-rescaled at scale², so the surviving tower must still
# cover 2·|logit|·scale².
PIPELINE_RESCALES = 4


def audit_pipeline_depth(cfg: MNISTConfig, params, scale: Fraction,
                         value_margin_bits: int = 10) -> None:
    """Raise when the ciphertext tower (after the gadget takes its raising
    primes) is too short for the pipeline's rescales plus the final-scale
    decode range."""
    ring = params.ring_cipher                 # ct tower, specials removed
    L = ring.nlimbs
    k = getattr(params, "num_special", 1)
    if L <= PIPELINE_RESCALES:
        raise UsageError(
            f"MNIST pipeline needs {PIPELINE_RESCALES} rescales but the ct "
            f"tower has only L={L} data limbs (full tower "
            f"{len(cfg.limb_bits)} limbs minus {k} raising primes). "
            f"Add data limbs or reduce num_special.")
    surviving = math.prod(ring.primes[:L - PIPELINE_RESCALES])
    need = scale * scale * (1 << value_margin_bits)
    if surviving < need:
        raise UsageError(
            f"MNIST pipeline depth check failed: after {PIPELINE_RESCALES} "
            f"rescales the surviving modulus is 2^{math.log2(surviving):.1f} but "
            f"the final decode needs ≥ 2^{float(math.log2(need)):.1f} "
            f"(scale² · 2^{value_margin_bits} margin). The ct tower is "
            f"L={L} data limbs after {k} raising primes. "
            f"Full tower bits: {cfg.limb_bits}.")


def make_params(cfg: MNISTConfig):
    """The configuration's raising parameters over a fresh ring."""
    ring = make_rns_ring(1 << cfg.ring_logn, cfg.limb_bits)
    if cfg.gadget == "hybrid":
        return HybridRaised(CKKSParams(ring, 0, 3.2), cfg.dnum, cfg.num_special)
    return ModulusRaised(CKKSParams(ring, 0, 3.2))


def fhe_setup(cfg: MNISTConfig, gen: torch.Generator, audit_depth: bool = True) -> FHESetup:
    """Keys on the generator's device: key pair, relinearization key and the
    Galois key of a ``batch``-slot rotation."""
    params = make_params(cfg)
    scale = Fraction(2) ** cfg.scale_log2
    if audit_depth:
        audit_pipeline_depth(cfg, params, scale)
    kp = keygen(params, gen)
    ek = keygen_eval_mult(gen, kp.priv)
    gk = keygen_galois(gen, kp.priv, steps=cfg.batch)
    return FHESetup(cfg, params, kp, ek, gk, scale)


def public_preprocess(cfg: MNISTConfig, batch: np.ndarray) -> np.ndarray:
    """[B, H, W] -> [k, k] grid of slot vectors of length B·positions,
    images fastest."""
    b = np.asarray(batch)
    side = (cfg.image - cfg.kernel) // cfg.stride + 1
    out = np.zeros((cfg.kernel, cfg.kernel, cfg.batch * cfg.positions))
    for i in range(cfg.kernel):
        for j in range(cfg.kernel):
            # value of pixel (i, j) within each patch, for every (image, pos)
            vals = np.stack(
                [b[:, pi * cfg.stride + i, pj * cfg.stride + j]
                 for pi in range(side) for pj in range(side)], axis=1)
            out[i, j] = vals.T.reshape(-1)             # images fastest
    return out


def _rep_inner(vec, inner):
    return np.repeat(np.asarray(vec), inner)


# ---------------------------------------------------------------------------
# eager dense layers on engine ciphertexts
# ---------------------------------------------------------------------------

def encrypted_matmul(setup: FHESetup, weights: np.ndarray, x: CipherText) -> CipherText:
    """Rotation-based diagonal matmul: d rotations by ``batch`` slots with
    the setup's one key, diagonal weights repeated ``inner = batch``."""
    d = weights.shape[1]
    result = mul_plain_vector(x, _rep_inner(np.diag(weights), setup.cfg.batch))
    rotated = x
    for k in range(1, d):
        rotated = rotate(setup.gk, rotated)
        diag = np.diag(np.roll(weights, k, axis=1))
        result = ct_add(result, mul_plain_vector(rotated, _rep_inner(diag, setup.cfg.batch)))
    return result


def bsgs_steps(cfg: MNISTConfig, d: Optional[int] = None):
    """(baby, giant) rotation steps in slots of the BSGS matmul over d
    diagonals: b·batch for b < bs and g·bs·batch for g < gs."""
    d = d if d is not None else cfg.positions
    bs, gs = B.bsgs_split(d)
    return ([b * cfg.batch for b in range(1, bs)],
            [g * bs * cfg.batch for g in range(1, gs)])


def keygen_matmul_bsgs(setup: FHESetup, gen: torch.Generator, d: Optional[int] = None):
    """Galois keys for :func:`encrypted_matmul_bsgs`: baby steps b·batch
    slots (b < bs) and giant steps g·bs·batch (g < gs) — O(√d) keys instead
    of the single iterated step-``batch`` key."""
    baby, giant = bsgs_steps(setup.cfg, d)
    return rlwe.keygen_galois_set(gen, setup.kp.priv, sorted(set(baby) | set(giant)))


def encrypted_matmul_bsgs(setup: FHESetup, gks, weights: np.ndarray, x: CipherText):
    """BSGS rotation matmul with hoisting and lazy ModDown:

      * baby rotations share one gadget decomposition + digit NTT
        (``rlwe.rotate_many``);
      * giant-step key switches accumulate in the raised tower and pay one
        contraction for the whole matrix (``rlwe.rotate_sum``);
      * d diagonal multiplies in all, but only bs + gs − 2 ≈ 2√d distinct
        key switches (against d − 1 sequential ones).

    Same diagonals and rotations as :func:`encrypted_matmul`, a different,
    lower-noise key-switch schedule. ``gks`` from
    :func:`keygen_matmul_bsgs`."""
    terms = _bsgs_matmul_terms(setup, gks, weights, x)
    if not terms:
        return _zero_product(x)
    return rlwe.rotate_sum(gks, terms)


def _bsgs_matmul_terms(setup: FHESetup, gks, weights: np.ndarray, x: CipherText,
                       inner: Optional[int] = None):
    """The giant-step term list [(galois_element | None, inner_sum)] of the
    BSGS matmul — exposed so several matmuls feeding one sum can merge
    their terms and pay a single rotate_sum contraction. ``inner`` is the
    slot repeat factor (defaults to the config batch). Every diagonal is
    encoded here, at each call; the serving pipeline encodes them once
    instead (:class:`_BsgsDense`)."""
    d = weights.shape[1]
    inner = setup.cfg.batch if inner is None else inner
    n = x.ring.n
    bs, gs = B.bsgs_split(d)
    els_b = {b: rlwe.galois_element_for_steps(n, b * inner) for b in range(1, bs)}
    hoisted = rlwe.rotate_many(gks, x, sorted(set(els_b.values())))
    baby_ct = {0: x, **{b: hoisted[e] for b, e in els_b.items()}}
    terms = []
    for g in range(gs):
        acc = None
        for b in range(bs):
            k = g * bs + b
            if k >= d:
                break
            diag = np.diag(np.roll(weights, k, axis=1))
            if not np.any(diag):
                continue
            vec = _rep_inner(np.roll(diag, -g * bs), inner)
            term = mul_plain_vector(baby_ct[b], vec)
            acc = term if acc is None else ct_add(acc, term)
        if acc is None:
            continue
        el = rlwe.galois_element_for_steps(n, g * bs * inner) if g else None
        terms.append((el, acc))
    return terms


def _zero_product(x: CipherText) -> CipherText:
    """A scale²-tagged zero ciphertext — what an all-zero-weight matmul
    returns."""
    return mul_plain_vector(x, np.zeros(x.ring.n // 2))


def _merge_bsgs_terms(term_lists):
    """Merge several matmuls' term lists by Galois element (inner sums add
    ciphertext-wise) so rotate_sum decomposes each element once."""
    by_el = {}
    for terms in term_lists:
        for el, ct in terms:
            by_el[el] = ct if el not in by_el else ct_add(by_el[el], ct)
    return list(by_el.items())


class _BsgsDense:
    """A dense layer on the BSGS schedule with its diagonals encoded once:
    Σ over ``blocks`` (one [d, d] weight block per input ciphertext) of the
    BSGS matmuls, merged by giant step, as ``_merge_bsgs_terms`` over
    ``_bsgs_matmul_terms`` computes it and bit-equal to that.

    The input ciphertexts ride one batched ciphertext (components
    [C, L, N]): one ``rotate_many`` hoists the baby rotations of all of
    them, one multiply-and-sum forms every giant step's inner sum from the
    stacked diagonals [G, bs, C, L, N], and one ``rotate_sum`` finishes. A
    zero diagonal is a zero row of the stack (its product adds nothing); a
    giant step whose diagonals are all zero is left out when the stack is
    built."""

    def __init__(self, params, ring, scale: Fraction, blocks, inner: int, device):
        self.params, self.ring, self.scale = params, ring, Fraction(scale)
        d = blocks[0].shape[1]
        n = ring.n
        bs, gs = B.bsgs_split(d)
        self.baby_els = [rlwe.galois_element_for_steps(n, b * inner) for b in range(1, bs)]
        zero = torch.zeros((ring.nlimbs, n), dtype=torch.int64, device=device)
        self.giant_els, stacks = [], []
        for g in range(gs):
            rows, nonzero = [], False
            for b in range(bs):
                k = g * bs + b
                per_block = []
                for blk in blocks:
                    diag = np.diag(np.roll(blk, k, axis=1)) if k < d else np.zeros(d)
                    if np.any(diag):
                        vec = _rep_inner(np.roll(diag, -g * bs), inner)
                        per_block.append(R.ensure_dual(ring, ckks_encode(
                            ring, vec.astype(complex), self.scale, device)).dual)
                        nonzero = True
                    else:
                        per_block.append(zero)
                rows.append(torch.stack(per_block, 0))
            if nonzero:
                self.giant_els.append(
                    rlwe.galois_element_for_steps(n, g * bs * inner) if g else None)
                stacks.append(torch.stack(rows, 0))
        self.diags = torch.stack(stacks, 0) if stacks else None      # [G, bs, C, L, N]

    def __call__(self, gks, c1: torch.Tensor, c2: torch.Tensor, dual: bool):
        """Components [C, L, N] (dual or primal) → the layer's output
        components (L, N), dual, at scale²."""
        ring, mp = self.ring, self.ring.mp
        if self.diags is None:                      # all-zero weights
            zero = torch.zeros_like(c1[0])
            return zero, zero
        mk = (lambda x: RingElt(dual=x)) if dual else (lambda x: RingElt(primal=x))
        ct = CipherText(self.params, (mk(c1), mk(c2)), ring, enc=CKKSTag(self.scale))
        hoisted = rlwe.rotate_many(gks, ct, sorted(set(self.baby_els)))
        babies = [ct] + [hoisted[e] for e in self.baby_els]
        stack = torch.stack([torch.stack([R.ensure_dual(ring, x).dual for x in c.cs], 0)
                             for c in babies], 0)                    # [bs, 2, C, L, N]
        prod = modmath.mul_mod(self.diags[:, :, None], stack[None], mp)
        inner = modmath.umod(prod.sum(dim=(1, 3)), mp.on(prod.device).p)   # [G, 2, L, N]
        tag = CKKSTag(self.scale * self.scale)
        terms = [(el, CipherText(self.params, (RingElt(dual=inner[i, 0]),
                                               RingElt(dual=inner[i, 1])), ring, enc=tag))
                 for i, el in enumerate(self.giant_els)]
        out = rlwe.rotate_sum(gks, terms)
        return R.ensure_dual(ring, out.cs[0]).dual, R.ensure_dual(ring, out.cs[1]).dual



# ---------------------------------------------------------------------------
# the serving pipeline
# ---------------------------------------------------------------------------

class _LayerClock:
    """Host-clock time of each pipeline stage, the device synchronised at
    each mark; does nothing when ``times`` is None."""

    def __init__(self, device: torch.device, times: Optional[dict]):
        self.device, self.times = device, times
        self.t = self._now() if times is not None else 0.0

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def __call__(self, name: str) -> None:
        if self.times is None:
            return
        now = self._now()
        self.times[name] = self.times.get(name, 0.0) + (now - self.t) * 1e3
        self.t = now


def build_inference_pipeline(setup: FHESetup, model_params, gks_bsgs=None,
                             dual_flow=None, mesh=None):
    """Build the serving pipeline once (layers, weight and diagonal
    encodings, on the keys' device) and return ``run(batch, gen) ->
    logits [classes, B]``.

    With ``gks_bsgs`` (from :func:`keygen_matmul_bsgs`, on the same device)
    the dense layers run the hoisted BSGS schedule instead of the
    d−1-key-switch rotation loop, with every diagonal encoded here, once.

    ``dual_flow``: layer boundaries carry dual-domain ciphertexts end to
    end — conv and bias layers rescale in the dual domain and both square
    layers run the fused transform schedule
    (``parallel.ops.make_hybrid_fused_step``). Bit-identical to the primal
    flow. Default (None): on for HybridRaised params with BSGS dense keys —
    the production serving configuration.

    ``run`` takes ``_return_ct=True`` to return the logits ciphertext
    undecrypted, and ``layer_times`` (a dict) to collect each stage's
    milliseconds on the host clock, the device synchronised between
    stages. The sharded pipeline (``mesh``) is not ported."""
    hybrid = getattr(setup.params, "hybrid_decompose", None) is not None
    if dual_flow is None:
        dual_flow = hybrid and gks_bsgs is not None
    if dual_flow and (not hybrid or gks_bsgs is None):
        raise ValueError("dual_flow requires HybridRaised params and "
                         "BSGS dense keys (gks_bsgs)")
    if mesh is not None:
        raise NotImplementedError("the sharded pipeline is not ported "
                                  "(ROADMAP.md queue 1, item 14: sharded paths)")
    cfg = setup.cfg
    params = setup.params
    device = setup.kp.pub.key.mask.device
    ring0 = params.ring_cipher
    n = ring0.n
    s0 = setup.scale

    def encode_dual(ring, slots, scale):
        return R.ensure_dual(ring, ckks_encode(ring, np.asarray(slots, dtype=complex),
                                               scale, device)).dual

    enc = JL.BatchEncryptor(params, setup.kp.pub, sigma=3.2)

    # ---- conv + bias + rescale ----
    w = np.asarray(model_params["conv_w"])
    bconv = np.asarray(model_params["conv_b"])
    q0 = ring0.modulus
    wq = np.zeros((cfg.channels, cfg.kernel * cfg.kernel, ring0.nlimbs, 1), dtype=np.int64)
    for c in range(cfg.channels):
        for g in range(cfg.kernel * cfg.kernel):
            m = round(float(w.reshape(-1, cfg.channels)[g, c]) * float(s0)) % q0
            wq[c, g] = ring0.scalar_residues(m)
    wq = torch.as_tensor(wq, device=device)
    s_conv = s0 * s0
    bias_dual = torch.stack([encode_dual(ring0, np.full(n // 2, float(bconv[c])), s_conv)
                             for c in range(cfg.channels)], 0)
    conv = JL.ConvLayer(params, ring0, cfg.channels, dual_out=dual_flow).to(device)
    ring1 = ring0.drop_last()
    s1 = s_conv / ring0.primes[-1]

    # ---- square 1 ----
    if dual_flow:
        sq1_fused, _ = pops.make_hybrid_fused_step(params, setup.ek, ring1)
    else:
        sq1 = JL.SquareRelinLayer(params, setup.ek, ring1)
    ring2 = ring1.drop_last()
    s2 = s1 * s1 / ring1.primes[-1]

    # ---- dense1: per-channel rotation matmuls, accumulated ----
    w1 = np.asarray(model_params["w1"])
    d = cfg.positions
    blocks1 = [w1[:, ci * d:(ci + 1) * d] for ci in range(cfg.channels)]
    if gks_bsgs is None:
        # iterated-rotation layer: d pre-encoded diagonals per channel
        mat1 = JL.RotateMatmulLayer(params, setup.gk, setup.gk.galois_element, d, ring2)
        diags1 = [torch.stack([
            encode_dual(ring2, _rep_inner(np.diag(np.roll(blk, k, axis=1)), cfg.batch), s2)
            for k in range(d)], 0) for blk in blocks1]
    else:
        dense1_bsgs = _BsgsDense(params, ring2, s2, blocks1, cfg.batch, device)
    s_fq1 = s2 * s2
    b1_dual = encode_dual(ring2, _rep_inner(np.asarray(model_params["b1"]), cfg.batch), s_fq1)
    br = JL.BiasRescaleLayer(ring2, dual_out=dual_flow).to(device)
    ring3 = ring2.drop_last()
    s3 = s_fq1 / ring2.primes[-1]

    # ---- square 2 ----
    if dual_flow:
        sq2_fused, _ = pops.make_hybrid_fused_step(params, setup.ek, ring3)
    else:
        sq2 = JL.SquareRelinLayer(params, setup.ek, ring3)
    ring4 = ring3.drop_last()
    s4 = s3 * s3 / ring3.primes[-1]

    # ---- dense2 (rectangular, zero-padded) ----
    w2 = np.asarray(model_params["w2"])
    wpad = np.vstack([w2, np.zeros((d - w2.shape[0], d))])
    if gks_bsgs is None:
        mat2 = JL.RotateMatmulLayer(params, setup.gk, setup.gk.galois_element, d, ring4)
        diag2 = torch.stack([
            encode_dual(ring4, _rep_inner(np.diag(np.roll(wpad, k, axis=1)), cfg.batch), s4)
            for k in range(d)], 0)
    else:
        dense2_bsgs = _BsgsDense(params, ring4, s4, [wpad], cfg.batch, device)
    s5 = s4 * s4
    b2pad = np.concatenate([np.asarray(model_params["b2"]), np.zeros(d - cfg.classes)])
    b2_dual = encode_dual(ring4, _rep_inner(b2pad, cfg.batch), s5)
    mp2, mp4 = ring2.mp, ring4.mp

    def run(batch: np.ndarray, gen: torch.Generator, _return_ct: bool = False,
            layer_times: Optional[dict] = None):
        clock = _LayerClock(device, layer_times)
        # ---- per request: encode the inputs + batched encryption ----
        I = public_preprocess(cfg, batch)
        pts = torch.stack([ckks_encode(ring0, I[i, j].astype(complex), s0, device).primal
                           for i in range(cfg.kernel) for j in range(cfg.kernel)], 0)
        clock("encode")
        cts = enc(pts, gen)                                # (G, 2, L0, N) dual
        clock("encrypt")
        conv_out = conv(cts, wq, bias_dual)                # (C, 2, L1, N)
        clock("conv")
        if dual_flow:
            # conv_out is dual; the fused square keeps the tower shape with
            # the dropped limb zeroed: slice to ring2's rows
            sq1_out = sq1_fused(conv_out)[..., :ring2.nlimbs, :]
            o1, o2 = sq1_out[:, 0], sq1_out[:, 1]          # (C, L2, N) dual
        else:
            o1, o2 = sq1(conv_out[:, 0], conv_out[:, 1])   # (C, L2, N) primal
        clock("square1")
        if gks_bsgs is not None:
            fq1_1, fq1_2 = dense1_bsgs(gks_bsgs, o1, o2, dual_flow)   # dual at s2²
        else:
            fq1_1 = fq1_2 = None
            for ci in range(cfg.channels):
                r1, r2 = mat1(o1[ci], o2[ci], diags1[ci])  # dual at s2²
                fq1_1 = r1 if fq1_1 is None else modmath.add_mod(fq1_1, r1, mp2)
                fq1_2 = r2 if fq1_2 is None else modmath.add_mod(fq1_2, r2, mp2)
        clock("dense1")
        f1p, f2p = br(fq1_1, fq1_2, b1_dual)               # (L3, N)
        clock("bias_rescale")
        if dual_flow:
            sq2_out = sq2_fused(torch.stack([f1p, f2p], 0)[None])[0][..., :ring4.nlimbs, :]
            g1, g2 = sq2_out[0], sq2_out[1]                # (L4, N) dual
        else:
            g1, g2 = sq2(f1p, f2p)
        clock("square2")
        if gks_bsgs is not None:
            r1, r2 = dense2_bsgs(gks_bsgs, g1[None], g2[None], dual_flow)  # dual at s4²
        else:
            r1, r2 = mat2(g1, g2, diag2)                   # dual at s4²
        r1 = modmath.add_mod(r1, b2_dual, mp4)
        clock("dense2")
        out = CipherText(params, (RingElt(dual=r1), RingElt(dual=r2)), ring4,
                         enc=CKKSTag(Fraction(s5)))
        if _return_ct:
            return out
        dec = decrypt(setup.kp, out).real
        clock("decrypt")
        mat = dec.reshape(cfg.positions, cfg.batch)
        return mat[:cfg.classes, :]

    return run


def encrypted_inference_fast(setup: FHESetup, model_params, batch: np.ndarray,
                             gen: torch.Generator, gks_bsgs=None, dual_flow=None,
                             mesh=None):
    """Encrypted forward pass through the compiled layers: the decrypted
    logits matrix [classes, B]. The built pipeline is cached on ``setup``
    so repeat calls serve at the warm rate."""
    pipe = getattr(setup, "_pipeline", None)
    prev = getattr(setup, "_pipeline_key", None)
    if (pipe is None or prev is None or prev[0] is not model_params
            or prev[1] is not gks_bsgs or prev[2:] != (dual_flow, mesh)):
        pipe = build_inference_pipeline(setup, model_params, gks_bsgs,
                                        dual_flow=dual_flow, mesh=mesh)
        setup._pipeline = pipe
        setup._pipeline_key = (model_params, gks_bsgs, dual_flow, mesh)
    return pipe(batch, gen)
