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

Beside the serving pipeline: the eager forward pass on engine ciphertexts
(:func:`encrypted_inference`, the cross-check of the compiled one), and the
depth-unlimited bootstrapped pipeline — conv → square → dense 1 → square →
exhaust → bootstrap → dense 2 — eager (:func:`encrypted_inference_bootstrapped`)
and on the compiled layers at each tower level
(:func:`build_bootstrapped_pipeline`), with the keys and the
``core.bootstrap.BootstrapContext`` of :func:`fhe_setup_bootstrapped`.

Weights are drawn from a numpy seed (``init_params``), trained on the
device (:func:`train`: the same forward pass as a float32 ``nn.Module``,
torch Adam with the reference's optax schedule, clipping, label smoothing
and augmentation pool, on real digits where the host has them, else on
synthetic ones) or carried across from the reference
(``utils.interop.mnist_params``). ``model_forward`` is the plaintext pass in
numpy, the check of the encrypted one.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import ring as R
from ..core.ckks import CKKSParams
from ..core import bootstrap as B
from ..core import ckks_encoding as CE
from ..core import rlwe
from ..core.ckks_encoding import CKKSTag, ckks_encode, make_plaintext, mul_plain_vector
from ..core.hybrid import HybridRaised
from ..core.modraise import ModulusRaised
from ..core.ring import RingElt, make_rns_ring
from ..core.rlwe import (CipherText, EvalMultKey, GaloisKey, KeyPair, UsageError, ct_add,
                         ct_mul, ct_rescale, decrypt, encrypt, keygen, keygen_eval_mult,
                         keygen_galois, keyswitch, rotate)
from ..ops import modmath
from ..parallel import layers as JL
from ..parallel import ops as pops
from ..parallel.sharding import Mesh
from ..utils import graphs
from ..utils.metrics import span


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
# plaintext training (train.jl's role)
# ---------------------------------------------------------------------------

class PlainCNN(torch.nn.Module):
    """The x²-CNN as a float32 ``nn.Module`` with autograd: the computation of
    :func:`model_forward` (patches, conv, square, channel-major features,
    dense, square, dense), on the device of the parameters."""

    def __init__(self, cfg: MNISTConfig, params, device):
        super().__init__()
        self.cfg = cfg
        for name in ("conv_w", "conv_b", "w1", "b1", "w2", "b2"):
            value = torch.as_tensor(np.asarray(params[name], dtype=np.float32), device=device)
            setattr(self, name, torch.nn.Parameter(value.clone()))

    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        cfg, b = self.cfg, batch.shape[0]
        pt = batch.unfold(1, cfg.kernel, cfg.stride).unfold(2, cfg.kernel, cfg.stride)
        pt = pt.reshape(b, cfg.positions, cfg.kernel * cfg.kernel)          # [B, P, k*k]
        conv = torch.einsum("bpk,kc->bpc", pt, self.conv_w.reshape(-1, cfg.channels)) + self.conv_b
        feats = (conv ** 2).permute(0, 2, 1).reshape(b, cfg.features)     # channel-major
        sq2 = (feats @ self.w1.T + self.b1) ** 2
        return sq2 @ self.w2.T + self.b2

    def params(self) -> dict:
        """The weights as float32 numpy arrays (the encrypted pipeline's
        ``model_params``)."""
        return {name: p.detach().cpu().numpy() for name, p in self.named_parameters()}


def warmup_cosine(lr: float, steps: int):
    """optax's ``warmup_cosine_decay_schedule(0, lr, max(50, steps // 20),
    steps, 0.05·lr)`` as a function of the update count: linear warmup from
    0, then cosine decay to 0.05·lr, in float32 with optax's order of
    operations. As in optax, update k (from 0) takes the value at count k, so
    the first update has lr = 0."""
    f32 = np.float32
    warm = max(50, steps // 20)
    decay = steps - warm
    if decay <= 0:
        raise ValueError(f"the cosine decay needs steps > {warm}, got {steps}")
    alpha = (lr * 0.05) / lr

    def schedule(count: int) -> float:
        if count < warm:
            frac = f32(1) - f32(min(max(count, 0), warm)) / f32(warm)
            return float(f32(0.0 - lr) * frac + f32(lr))
        t = f32(min(count - warm, decay))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t / f32(decay)))
        return float(f32(lr) * (f32(1 - alpha) * cosine + f32(alpha)))
    return schedule


def clip_by_global_norm_(params, max_norm: float = 1.0) -> torch.Tensor:
    """optax's ``clip_by_global_norm``: every gradient scaled by
    max_norm / ‖g‖ when the global norm ‖g‖ ≥ max_norm, untouched below it
    (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm). Returns the
    norm."""
    grads = [p.grad for p in params]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def train_step(model: PlainCNN, opt: torch.optim.Optimizer, batch: torch.Tensor,
               labels: torch.Tensor, lr: float, clip: bool, smoothing: float) -> torch.Tensor:
    """One update: softmax cross-entropy (label smoothing ``smoothing``:
    targets onehot·(1−s) + s/C), optionally clipped to global norm 1, then
    Adam at ``lr``. Returns the loss (a device scalar: reading it waits for
    the device)."""
    opt.zero_grad(set_to_none=False)
    loss = torch.nn.functional.cross_entropy(model(batch), labels, label_smoothing=smoothing)
    loss.backward()
    if clip:
        clip_by_global_norm_(list(model.parameters()))
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    return loss.detach()


def synthetic_dataset(cfg: MNISTConfig, gen: torch.Generator, n: int):
    """Class-patterned images + noise (the dataset stand-in), drawn from
    ``gen`` on its device: (imgs float32 [n, H, W], labels int64 [n])."""
    dev = gen.device
    labels = torch.randint(0, cfg.classes, (n,), generator=gen, device=dev)
    protos = torch.randn((cfg.classes, cfg.image, cfg.image), generator=gen, device=dev)
    noise = torch.randn((n, cfg.image, cfg.image), generator=gen, device=dev)
    return protos[labels] + 0.3 * noise, labels


_MNIST_CANDIDATES = (
    "{root}/train-images-idx3-ubyte.gz", "{root}/train-images.idx3-ubyte",
    "{root}/MNIST/raw/train-images-idx3-ubyte.gz",
    "{root}/mnist.npz",
)


def load_mnist_local(root: str = None):
    """(imgs float32 [N, 28, 28] in [0, 1], labels int64 [N]) from a local
    MNIST copy (idx / idx.gz or Keras-style mnist.npz), or None when there is
    none. Looks under ``root``, ``$MNIST_PATH``, ``~/.cache/mnist`` and
    ``./data``; nothing is downloaded."""
    import gzip
    import os
    import struct

    roots = [r for r in (root, os.environ.get("MNIST_PATH"),
                         os.path.expanduser("~/.cache/mnist"), "data") if r]
    for rt in roots:
        for pat in _MNIST_CANDIDATES:
            path = pat.format(root=rt)
            if not os.path.exists(path):
                continue
            if path.endswith(".npz"):
                with np.load(path) as z:
                    return (z["x_train"].astype(np.float32) / 255.0,
                            z["y_train"].astype(np.int64))
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rb") as f:
                magic, n, h, w = struct.unpack(">IIII", f.read(16))
                if magic != 2051:
                    raise ValueError(f"{path}: not an idx3 image file")
                imgs = np.frombuffer(f.read(n * h * w), dtype=np.uint8)
            lbl_path = path.replace("images-idx3", "labels-idx1") \
                           .replace("images.idx3", "labels.idx1")
            with opener(lbl_path, "rb") as f:
                magic, n2 = struct.unpack(">II", f.read(8))
                if magic != 2049 or n2 != n:
                    raise ValueError(f"{lbl_path}: not the labels of {path}")
                labels = np.frombuffer(f.read(n), dtype=np.uint8)
            return (imgs.reshape(n, h, w).astype(np.float32) / 255.0,
                    labels.astype(np.int64))
    return None


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] float32 weights of a bilinear (triangle-kernel) resize
    with half-pixel centres, normalised over the input pixels in reach, as
    ``jax.image.resize(..., "bilinear")`` builds them."""
    inv_scale = np.float32(n_in) / np.float32(n_out)
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).T.astype(np.float32)


def resize_bilinear(imgs: np.ndarray, size: int) -> np.ndarray:
    """[N, h, w] float32 images resampled to [N, size, size] bilinearly."""
    wh = _resize_weights(imgs.shape[1], size)
    ww = _resize_weights(imgs.shape[2], size)
    return np.einsum("yh,nhw,xw->nyx", wh, imgs.astype(np.float32), ww).astype(np.float32)


def load_real_digits(cfg: MNISTConfig):
    """Real handwritten digits at cfg.image: a local MNIST copy
    (:func:`load_mnist_local`, 28×28 only), else the UCI handwritten-digit
    scans bundled with scikit-learn (1797 8×8 images, resampled bilinearly
    to cfg.image; classes ≥ cfg.classes dropped). None when neither exists
    (the reference's rule: then :func:`train` uses the synthetic set)."""
    if cfg.image == 28:
        local = load_mnist_local()
        if local is not None:
            return local
    try:
        from sklearn.datasets import load_digits
    except ImportError:
        return None
    d = load_digits()
    imgs = d.images.astype(np.float32) / 16.0          # [N, 8, 8] in [0, 1]
    labels = d.target.astype(np.int64)
    if cfg.classes < 10:
        keep = labels < cfg.classes
        imgs, labels = imgs[keep], labels[keep]
    if cfg.image != 8:
        imgs = resize_bilinear(imgs, cfg.image)
    return imgs, labels


def augmentation_pool(cfg: MNISTConfig, imgs: np.ndarray, labels: np.ndarray):
    """The host-side augmentation pool of long training runs: the images,
    four small-angle rotations (±5°, ±10°) and four elastic distortions
    (Simard et al.: smoothed random displacement fields from
    ``np.random.default_rng(7)``), with their labels; the images alone
    when scipy is absent."""
    try:
        from scipy.ndimage import gaussian_filter, map_coordinates
        from scipy.ndimage import rotate as _rot
    except ImportError:
        return imgs, labels
    base_i, base_l = np.asarray(imgs), np.asarray(labels)
    pools_i, pools_l = [base_i], [base_l]
    for ang in (-10.0, -5.0, 5.0, 10.0):
        pools_i.append(_rot(base_i, ang, axes=(1, 2), reshape=False, order=1, mode="constant"))
        pools_l.append(base_l)
    rng_el = np.random.default_rng(7)
    yy, xx = np.meshgrid(np.arange(cfg.image), np.arange(cfg.image), indexing="ij")
    sigma_el, alpha_el = cfg.image / 7.0, cfg.image / 4.0
    for _ in range(4):
        dy = gaussian_filter(rng_el.uniform(-1, 1, base_i.shape[1:]), sigma_el,
                             mode="constant") * alpha_el
        dx = gaussian_filter(rng_el.uniform(-1, 1, base_i.shape[1:]), sigma_el,
                             mode="constant") * alpha_el
        warped = np.stack([map_coordinates(im, [yy + dy, xx + dx], order=1, mode="constant")
                           for im in base_i], 0)
        pools_i.append(warped.astype(np.float32))
        pools_l.append(base_l)
    return np.concatenate(pools_i, 0), np.concatenate(pools_l, 0)


def _shift(imgs: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """Each image rolled by (dy, dx) pixels (``jnp.roll`` on both axes)."""
    h, w = imgs.shape[1:]
    rows = (torch.arange(h, device=imgs.device) - dy[:, None]) % h            # [B, H]
    cols = (torch.arange(w, device=imgs.device) - dx[:, None]) % w            # [B, W]
    return imgs[torch.arange(imgs.shape[0], device=imgs.device)[:, None, None],
                rows[:, :, None], cols[:, None, :]]


def train(cfg: MNISTConfig, gen: torch.Generator, steps: int = 300, lr: float = 1e-3,
          data=None, *, device):
    """Train the x²-CNN (train.jl's role) on ``device`` with
    ``torch.optim.Adam`` (optax's β = (0.9, 0.999), ε = 1e-8); returns
    (params as float32 numpy arrays, held-out accuracy).

    ``data`` — (imgs [N, H, W], labels [N]); by default real digits
    (:func:`load_real_digits`), else 512 synthetic images from ``gen``.
    Weights start from :func:`init_params` at a seed drawn from ``gen``. The
    first 2048 samples are used, 80 / 20 into training and held-out sets when
    there are 256 or more. Runs of 300 steps or more take the warmup-cosine
    schedule and global-norm clipping, and, with 256 or more training
    images, minibatches of 256 from the augmentation pool, each image rolled
    by up to cfg.image // 8 pixels, with label smoothing 0.05; shorter runs
    take full-batch Adam at ``lr``. Minibatch indices and shifts are drawn
    from ``gen``."""
    seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen, device=gen.device))
    model = PlainCNN(cfg, init_params(cfg, seed), device)
    if data is None:
        data = load_real_digits(cfg)
    if data is None:
        data = synthetic_dataset(cfg, gen, 512)
    imgs = torch.as_tensor(data[0]).cpu().numpy().astype(np.float32)[:2048]
    labels = torch.as_tensor(data[1]).cpu().numpy().astype(np.int64)[:2048]
    n = len(labels)
    ntr = (n * 4) // 5 if n >= 256 else n
    held_out = ntr < n
    test_imgs, test_labels = (imgs[ntr:], labels[ntr:]) if held_out else (imgs, labels)
    imgs, labels = imgs[:ntr], labels[:ntr]

    long_run = steps >= 300
    augment = long_run and ntr >= 256
    if augment:
        imgs, labels = augmentation_pool(cfg, imgs, labels)
    schedule = warmup_cosine(lr, steps) if long_run else (lambda count: lr)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    x = torch.as_tensor(imgs, device=device)
    y = torch.as_tensor(labels, device=device)
    nb = min(256, len(labels))
    sh = max(1, cfg.image // 8)
    for count in range(steps):
        if augment:
            idx = torch.randint(0, len(labels), (nb,), generator=gen, device=gen.device)
            dy = torch.randint(-sh, sh + 1, (nb,), generator=gen, device=gen.device)
            dx = torch.randint(-sh, sh + 1, (nb,), generator=gen, device=gen.device)
            idx, dy, dx = idx.to(device), dy.to(device), dx.to(device)
            mb, ml = _shift(x[idx], dy, dx), y[idx]
        else:
            mb, ml = x, y
        train_step(model, opt, mb, ml, schedule(count), clip=long_run,
                   smoothing=0.05 if augment else 0.0)
    with torch.no_grad():
        pred = model(torch.as_tensor(test_imgs, device=device)).argmax(-1).cpu().numpy()
    return model.params(), float((pred == test_labels).mean())


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


@functools.lru_cache(maxsize=None)
def _grid_pixels(image: int, kernel: int, stride: int) -> tuple:
    """(rows, columns), each [k, k, positions]: where pixel (i, j) of each
    patch position p = pi·side + pj lies in the image, built once per
    shape, read-only."""
    side = (image - kernel) // stride + 1
    i, j, pi, pj = np.indices((kernel, kernel, side, side))
    out = tuple((p * stride + q).reshape(kernel, kernel, side * side)
                for p, q in ((pi, i), (pj, j)))
    for x in out:
        x.setflags(write=False)
    return out


def public_preprocess(cfg: MNISTConfig, batch: np.ndarray) -> np.ndarray:
    """[B, H, W] -> [k, k] grid of slot vectors of length B·positions,
    images fastest: one gather of the batch through the grid's pixel
    tables."""
    rows, cols = _grid_pixels(cfg.image, cfg.kernel, cfg.stride)
    vals = np.asarray(batch, dtype=np.float64)[:, rows, cols]         # [B, k, k, P]
    return np.moveaxis(vals, 0, -1).reshape(cfg.kernel, cfg.kernel, cfg.batch * cfg.positions)


def _rep_inner(vec, inner):
    return np.repeat(np.asarray(vec), inner)


def _encode_dual(ring, slots, scale, device) -> torch.Tensor:
    """A slot vector encoded at ``scale`` on ``device``, in the dual domain."""
    return R.ensure_dual(ring, ckks_encode(ring, np.asarray(slots, dtype=complex),
                                           scale, device)).dual


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


def naive_rectangular_matmul(setup: FHESetup, weights: np.ndarray, x: CipherText) -> CipherText:
    """Zero-pad a short-fat matrix to square, then the diagonal matmul."""
    r, c = weights.shape
    if r > c:
        raise ValueError(f"expected rows <= columns, got {weights.shape}")
    if r < c:
        weights = np.vstack([weights, np.zeros((c - r, c))])
    return encrypted_matmul(setup, weights, x)


def _eager_to_square2(setup: FHESetup, model_params, batch: np.ndarray,
                      gen: torch.Generator, gks_bsgs=None) -> CipherText:
    """The eager pass up to the second square: encrypt the k×k grid (one
    ciphertext after another from ``gen``), conv + bias + rescale, square +
    relinearize + rescale, dense 1 (iterated, or BSGS with ``gks_bsgs``, the
    channels' giant steps merged into one lazy ModDown) + bias + rescale,
    square."""
    cfg = setup.cfg
    ring = setup.params.ring_cipher
    I = public_preprocess(cfg, batch)
    C = {(i, j): encrypt(setup.kp, make_plaintext(ring, I[i, j], setup.scale), gen)
         for i in range(cfg.kernel) for j in range(cfg.kernel)}

    w = np.asarray(model_params["conv_w"])
    bconv = np.asarray(model_params["conv_b"])
    conved = []
    for c in range(cfg.channels):
        acc = None
        for i in range(cfg.kernel):
            for j in range(cfg.kernel):
                term = CE.mul_plain_scalar(C[(i, j)], float(w[i, j, c]))
                acc = term if acc is None else ct_add(acc, term)
        conved.append(ct_rescale(CE.add_plain(acc, float(bconv[c]))))

    sqed1 = [ct_rescale(keyswitch(setup.ek, ct_mul(x, x))) for x in conved]

    w1 = np.asarray(model_params["w1"])
    d = cfg.positions
    blocks = [w1[:, ci * d:(ci + 1) * d] for ci in range(cfg.channels)]
    if gks_bsgs is not None:
        fq1 = rlwe.rotate_sum(gks_bsgs, _merge_bsgs_terms(
            [_bsgs_matmul_terms(setup, gks_bsgs, blk, x) for blk, x in zip(blocks, sqed1)]))
    else:
        fq1 = None
        for blk, x in zip(blocks, sqed1):
            part = encrypted_matmul(setup, blk, x)
            fq1 = part if fq1 is None else ct_add(fq1, part)
    fq1 = ct_rescale(CE.add_plain(fq1, _rep_inner(np.asarray(model_params["b1"]), cfg.batch)))
    return ct_rescale(keyswitch(setup.ek, ct_mul(fq1, fq1)))


def _decrypt_logits(setup: FHESetup, out: CipherText) -> np.ndarray:
    cfg = setup.cfg
    dec = decrypt(setup.kp, out).real
    # rows = positions (the class index in the first ``classes``), cols = images
    return dec.reshape(cfg.positions, cfg.batch)[:cfg.classes, :]


def _bias2(cfg: MNISTConfig, model_params) -> np.ndarray:
    b2pad = np.concatenate([np.asarray(model_params["b2"]),
                            np.zeros(cfg.positions - cfg.classes)])
    return _rep_inner(b2pad, cfg.batch)


def encrypted_inference(setup: FHESetup, model_params, batch: np.ndarray,
                        gen: torch.Generator, gks_bsgs=None) -> np.ndarray:
    """The whole encrypted forward pass, eager on engine ciphertexts: the
    decrypted logits [classes, B]. With ``gks_bsgs`` (from
    :func:`keygen_matmul_bsgs`) the dense layers run the hoisted BSGS
    schedule. The cross-check of :func:`build_inference_pipeline`."""
    sqed2 = _eager_to_square2(setup, model_params, batch, gen, gks_bsgs)
    w2 = np.asarray(model_params["w2"])
    if gks_bsgs is not None:
        d = setup.cfg.positions
        wpad = np.vstack([w2, np.zeros((d - w2.shape[0], d))])
        out = encrypted_matmul_bsgs(setup, gks_bsgs, wpad, sqed2)
    else:
        out = naive_rectangular_matmul(setup, w2, sqed2)
    return _decrypt_logits(setup, CE.add_plain(out, _bias2(setup.cfg, model_params)))


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

    def __call__(self, gks, c1: torch.Tensor, c2: torch.Tensor, dual: bool,
                 place: Optional[JL.MeshPlacement] = None):
        """Components [C, L, N] (dual or primal) → the layer's output
        components (L, N), dual, at scale². With ``place``, ``c1`` / ``c2``
        are this rank's block of the C input ciphertexts: the giant steps'
        inner sums over them are completed over 'dp' before the giant
        rotations."""
        ring, mp = self.ring, self.ring.mp
        if self.diags is None:                      # all-zero weights
            zero = torch.zeros_like(c1[0])
            return zero, zero
        diags = self.diags
        if place is not None:
            diags = diags[:, :, place.batch(diags.shape[2])]
        mk = (lambda x: RingElt(dual=x)) if dual else (lambda x: RingElt(primal=x))
        ct = CipherText(self.params, (mk(c1), mk(c2)), ring, enc=CKKSTag(self.scale))
        hoisted = rlwe.rotate_many(gks, ct, sorted(set(self.baby_els)))
        babies = [ct] + [hoisted[e] for e in self.baby_els]
        stack = torch.stack([torch.stack([R.ensure_dual(ring, x).dual for x in c.cs], 0)
                             for c in babies], 0)                    # [bs, 2, C, L, N]
        prod = modmath.mul_mod(diags[:, :, None], stack[None], mp)
        inner = modmath.umod(prod.sum(dim=(1, 3)), mp.on(prod.device).p)   # [G, 2, L, N]
        if place is not None:
            inner = place.dp_sum(inner, self.diags.shape[2], mp, "dense_channel_sum")
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


def _stager(compiled: bool, pool):
    """``stage(fn, name)``: ``fn`` compiled into ``pool`` (one CUDA graph a
    pipeline stage, captured at its first call on the card) or, when not
    ``compiled``, ``fn`` itself."""
    if not compiled:
        return lambda fn, name: fn
    return lambda fn, name: graphs.jit(fn, pool=pool, name=name)


def _pick(eager: bool):
    """How a runner calls a stage: as built, or, for the eager twin of a
    compiled pipeline, the function under its graph."""
    if not eager:
        return lambda st: st
    return lambda st: st.fn if isinstance(st, graphs.Compiled) else st


def build_inference_pipeline(setup: FHESetup, model_params, gks_bsgs=None,
                             dual_flow=None, mesh=None, eager: bool = False):
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
    stages.

    Each stage after the host encode — encrypt, conv, square 1, dense 1
    (with BSGS keys, the reference's ``jax.jit(_dense1_bsgs)``), bias +
    rescale, square 2, dense 2 — is compiled as the reference jits it
    (:func:`..utils.graphs.jit`: on the card a CUDA graph a stage,
    captured at the first batch, all in one memory pool, ``run.pool``);
    ``eager=True`` runs them eagerly. ``run.encode(batch)`` is the host
    encode and ``run.forward(pts, gen)`` the stages from the encryption to
    the logits ciphertext; ``run.eager`` is the same pipeline (the same
    layers and constants) with every stage eager, as ``run`` is. Under a
    running ``torch.profiler`` a call of ``run`` is a ``toyfhe.run`` span
    holding ``toyfhe.encode``, ``toyfhe.forward`` (a ``toyfhe.stage.<name>``
    a stage) and ``toyfhe.decrypt`` (:func:`..utils.metrics.span`).

    ``mesh`` (a ('dp', 'rp') :class:`..parallel.sharding.Mesh` whose
    device holds the keys): the sharded pipeline, run by every rank of the
    mesh with the same arguments (``gen`` seeded alike on every rank). The
    grid and channel axes go on 'dp' and the limbs on 'rp' where the mesh
    divides them (:class:`..parallel.layers.MeshPlacement`); keys are
    whole on every rank. The reference gets its collectives from GSPMD;
    here each layer issues its own: the conv's grid sum and the dense
    layers' channel sums over 'dp', and at a level 'rp' divides the
    square layer runs the sharded hybrid step (its digit share and
    dropped-row sites) and gathers its result's rows. The dense layers'
    rotations run on whole rows. Every sum is a modular sum, exact in any
    order, so the logits are bit-equal to the single-device pipeline's,
    on every rank; it runs eagerly (its collectives cannot be captured)."""
    hybrid = getattr(setup.params, "hybrid_decompose", None) is not None
    if dual_flow is None:
        dual_flow = hybrid and gks_bsgs is not None
    if dual_flow and (not hybrid or gks_bsgs is None):
        raise ValueError("dual_flow requires HybridRaised params and "
                         "BSGS dense keys (gks_bsgs)")
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a sharding.Mesh or None, got {type(mesh).__name__}")
    cfg = setup.cfg
    params = setup.params
    device = setup.kp.pub.key.mask.device
    place = None
    if mesh is not None:
        if modmath.canonical_device(device) != mesh.device:
            raise ValueError(f"the keys are on {device}, the mesh's rank on {mesh.device}")
        place = JL.MeshPlacement(mesh)
    ring0 = params.ring_cipher
    n = ring0.n
    s0 = setup.scale

    encode_dual = lambda ring, slots, scale: _encode_dual(ring, slots, scale, device)
    pool = graphs.Pool()
    stage = _stager(not eager and mesh is None, pool)

    enc = JL.BatchEncryptor(params, setup.kp.pub, sigma=3.2, eager=True)

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
    conv = JL.ConvLayer(params, ring0, cfg.channels, dual_out=dual_flow,
                        eager=True).to(device)
    ring1 = ring0.drop_last()
    s1 = s_conv / ring0.primes[-1]

    def square_layer(ring):
        """square → relinearize → rescale at ``ring``'s level, on stacked
        components (B, 2, L, N) in the flow's domain → (B, 2, L − 1, N)."""
        L = ring.nlimbs
        if place is not None and place.limbs_cut(L) and hybrid:
            step, _ = pops.make_hybrid_sharded_step(mesh, params, setup.ek, ct_ring=ring,
                                                    fused_schedule=dual_flow, dp=False)
            local = ring.select(range(L)[place.rows(L)])
            sub = ring.drop_last()

            def sharded(x):                        # the rank's limb rows in, all rows out
                d = x if dual_flow else JL._ntt_t(x, local)
                out = place.gather_rows(step(d), L)[..., :L - 1, :]
                return out if dual_flow else JL._intt_t(out, sub)
            return sharded
        if dual_flow:
            fn = pops.make_hybrid_fused_step(params, setup.ek, ring, eager=True)[0]
            whole = lambda x: fn(x)[..., :L - 1, :]
        else:
            layer = JL.SquareRelinLayer(params, setup.ek, ring, eager=True)
            whole = lambda x: torch.stack(layer(x[:, 0], x[:, 1]), 1)
        if place is None:
            return whole
        return lambda x: whole(place.gather_rows(x, L))

    # ---- square 1 ----
    sq1 = stage(square_layer(ring1), "square1")
    ring2 = ring1.drop_last()
    s2 = s1 * s1 / ring1.primes[-1]

    # ---- dense1: per-channel rotation matmuls, accumulated ----
    w1 = np.asarray(model_params["w1"])
    d = cfg.positions
    blocks1 = [w1[:, ci * d:(ci + 1) * d] for ci in range(cfg.channels)]
    if gks_bsgs is None:
        # iterated-rotation layer: d pre-encoded diagonals per channel
        mat1 = JL.RotateMatmulLayer(params, setup.gk, setup.gk.galois_element, d, ring2,
                                    eager=True)
        diags1 = [torch.stack([
            encode_dual(ring2, _rep_inner(np.diag(np.roll(blk, k, axis=1)), cfg.batch), s2)
            for k in range(d)], 0) for blk in blocks1]
    else:
        dense1_bsgs = _BsgsDense(params, ring2, s2, blocks1, cfg.batch, device)
    s_fq1 = s2 * s2
    b1_dual = encode_dual(ring2, _rep_inner(np.asarray(model_params["b1"]), cfg.batch), s_fq1)
    br = JL.BiasRescaleLayer(ring2, dual_out=dual_flow, eager=True).to(device)
    ring3 = ring2.drop_last()
    s3 = s_fq1 / ring2.primes[-1]

    # ---- square 2 ----
    sq2 = stage(square_layer(ring3), "square2")
    ring4 = ring3.drop_last()
    s4 = s3 * s3 / ring3.primes[-1]

    # ---- dense2 (rectangular, zero-padded) ----
    w2 = np.asarray(model_params["w2"])
    wpad = np.vstack([w2, np.zeros((d - w2.shape[0], d))])
    if gks_bsgs is None:
        mat2 = JL.RotateMatmulLayer(params, setup.gk, setup.gk.galois_element, d, ring4,
                                    eager=True)
        diag2 = torch.stack([
            encode_dual(ring4, _rep_inner(np.diag(np.roll(wpad, k, axis=1)), cfg.batch), s4)
            for k in range(d)], 0)
    else:
        dense2_bsgs = _BsgsDense(params, ring4, s4, [wpad], cfg.batch, device)
    s5 = s4 * s4
    b2pad = np.concatenate([np.asarray(model_params["b2"]), np.zeros(d - cfg.classes)])
    b2_dual = encode_dual(ring4, _rep_inner(b2pad, cfg.batch), s5)
    mp2, mp4 = ring2.mp, ring4.mp

    def dense1(o1, o2):
        if gks_bsgs is not None:
            return dense1_bsgs(gks_bsgs, o1, o2, dual_flow, place)   # dual at s2²
        chans = range(cfg.channels)
        if place is not None:
            chans = chans[place.batch(cfg.channels)]
        fq1_1 = fq1_2 = None
        for i, ci in enumerate(chans):
            r1, r2 = mat1(o1[i], o2[i], diags1[ci])    # dual at s2²
            fq1_1 = r1 if fq1_1 is None else modmath.add_mod(fq1_1, r1, mp2)
            fq1_2 = r2 if fq1_2 is None else modmath.add_mod(fq1_2, r2, mp2)
        if place is not None:
            fq1_1, fq1_2 = place.dp_sum(torch.stack([fq1_1, fq1_2]), cfg.channels, mp2,
                                        "dense_channel_sum")
        return fq1_1, fq1_2

    def dense2(g1, g2):
        if gks_bsgs is not None:
            r1, r2 = dense2_bsgs(gks_bsgs, g1[None], g2[None], dual_flow)  # dual at s4²
        else:
            r1, r2 = mat2(g1, g2, diag2)                   # dual at s4²
        return modmath.add_mod(r1, b2_dual, mp4), r2

    if place is None:
        conv_stage = lambda cts: conv(cts, wq, bias_dual)  # (C, 2, L1, N)
    else:                                                  # the rank's block of the grid
        conv_stage = lambda cts: conv(cts[place.batch(cts.shape[0])][
            ..., place.rows(ring0.nlimbs), :], wq, bias_dual, place)
    encrypt_stage = stage(enc, "encrypt")
    conv_stage = stage(conv_stage, "conv")
    dense1 = stage(dense1, "dense1")
    bias_rescale = stage(lambda a, b: br(a, b, b1_dual), "bias_rescale")
    dense2 = stage(dense2, "dense2")

    def encode(batch: np.ndarray) -> torch.Tensor:
        """The host encode of a batch: the k×k grid's slot vectors as primal
        plaintexts [G, L0, N] on the keys' device."""
        with span("toyfhe.encode"):
            with span("toyfhe.encode.preprocess"):
                I = public_preprocess(cfg, batch)
            return CE.ckks_encode_batch(ring0, I.reshape(cfg.grid ** 2, -1), s0, device)

    def forward(pts: torch.Tensor, gen: torch.Generator, clock, S) -> CipherText:
        with span("toyfhe.forward"):
            cts = S(encrypt_stage)(pts, gen)                   # (G, 2, L0, N) dual
            clock("encrypt")
            conv_out = S(conv_stage)(cts)                      # its channels and L1 rows
            clock("conv")
            o = S(sq1)(conv_out)                               # (C, 2, L2, N), dual or primal
            clock("square1")
            fq1_1, fq1_2 = S(dense1)(o[:, 0], o[:, 1])         # dual at s2²
            clock("dense1")
            f1p, f2p = S(bias_rescale)(fq1_1, fq1_2)           # (L3, N)
            clock("bias_rescale")
            sq2_in = torch.stack([f1p, f2p], 0)[None]
            if place is not None:
                sq2_in = place.cut_rows(sq2_in, ring3.nlimbs)
            g = S(sq2)(sq2_in)[0]                              # (2, L4, N)
            clock("square2")
            r1, r2 = S(dense2)(g[0], g[1])                     # dual at s4², with the bias
            clock("dense2")
            return CipherText(params, (RingElt(dual=r1), RingElt(dual=r2)), ring4,
                              enc=CKKSTag(Fraction(s5)))

    def runner(S):
        def run(batch: np.ndarray, gen: torch.Generator, _return_ct: bool = False,
                layer_times: Optional[dict] = None):
            with span("toyfhe.run"):
                clock = _LayerClock(device, layer_times)
                # ---- per request: encode the inputs, then the compiled stages ----
                pts = encode(batch)
                clock("encode")
                out = forward(pts, gen, clock, S)
                if _return_ct:
                    return out
                dec = decrypt(setup.kp, out).real
                clock("decrypt")
                mat = dec.reshape(cfg.positions, cfg.batch)
                return mat[:cfg.classes, :]

        run.encode = encode
        run.forward = lambda pts, gen: forward(pts, gen, _LayerClock(device, None), S)
        run.pool = pool
        return run

    run = runner(_pick(False))
    run.eager = runner(_pick(True))
    return run


def encrypted_inference_fast(setup: FHESetup, model_params, batch: np.ndarray,
                             gen: torch.Generator, gks_bsgs=None, dual_flow=None,
                             mesh=None, eager: bool = False):
    """Encrypted forward pass through the compiled layers: the decrypted
    logits matrix [classes, B]. The built pipeline is cached on ``setup``
    so repeat calls serve at the warm rate (its stages replay their CUDA
    graphs on the card; ``eager=True`` builds it eager)."""
    pipe = getattr(setup, "_pipeline", None)
    prev = getattr(setup, "_pipeline_key", None)
    if (pipe is None or prev is None or prev[0] is not model_params
            or prev[1] is not gks_bsgs or prev[2:] != (dual_flow, mesh, eager)):
        pipe = build_inference_pipeline(setup, model_params, gks_bsgs,
                                        dual_flow=dual_flow, mesh=mesh, eager=eager)
        setup._pipeline = pipe
        setup._pipeline_key = (model_params, gks_bsgs, dual_flow, mesh, eager)
    return pipe(batch, gen)


# ---------------------------------------------------------------------------
# the bootstrapped (depth-unlimited) pipeline
# ---------------------------------------------------------------------------

# The production bootstrapped configuration: a depth-46 composite tower
# (2 × 29-bit base, balanced 26-bit level pairs, 7 raising primes; 55 limbs
# at N = 2^13), the factored radix-16 transforms, a degree-24 cosine seed
# with two double-angle squarings and the arcsine correction, a sparse
# secret of weight 4; the message divided by 32 before the refresh.
BOOTSTRAPPED_RECIPE = dict(depth=46, K=5.0, deg=24, scale_limbs=2, radix=16, arcsin=True,
                           double_angle=2, hamming_weight=4)
BOOTSTRAPPED_PRESCALE = 32.0


def make_bootstrapped_params(cfg: MNISTConfig, depth: int = 12, limb_bits: int = 28,
                             hamming_weight: int = 4, scale_limbs: int = 1):
    """(params, scale log2) of :func:`fhe_setup_bootstrapped` over a fresh
    ring, with a sparse ternary secret of ``hamming_weight``.

    ``scale_limbs`` = 2, the composite recipe: ``bootstrap.make_boot_ring``
    (2 × 29-bit base, ``depth`` balanced 26-bit level limbs, k 29-bit
    raising primes) under ``HybridRaised`` with dnum = ⌊(depth+2)/5⌋ and
    k = ⌈(depth+2)/dnum⌉ + 1; the pipeline runs at scale 2^26 a level and
    the refresh at 2^52 across limb pairs. Otherwise ``depth`` limbs of
    ``limb_bits`` under ``ModulusRaised``."""
    if scale_limbs == 2:
        dnum = max(1, (depth + 2) // 5)
        k = -(-(depth + 2) // dnum) + 1
        ring = B.make_boot_ring(1 << cfg.ring_logn, L=depth, num_special=k)
        return HybridRaised(CKKSParams(ring, 0, 3.2, secret="sparse",
                                       hamming_weight=hamming_weight), dnum, k), 26
    ring = make_rns_ring(1 << cfg.ring_logn, (limb_bits,) * depth)
    return ModulusRaised(CKKSParams(ring, 0, 3.2, secret="sparse",
                                    hamming_weight=hamming_weight)), None


def fhe_setup_bootstrapped(cfg: MNISTConfig, gen: torch.Generator, depth: int = 12,
                           limb_bits: int = 28, scale_log2: int = 28,
                           hamming_weight: int = 4, **boot_kwargs):
    """Keys for depth-unlimited inference, on the generator's device: a deep
    tower (:func:`make_bootstrapped_params`), the key pair, relinearization
    key and Galois key of a ``batch``-slot rotation, and the
    ``BootstrapContext`` of ``bootstrap.setup_bootstrap(**boot_kwargs)`` for
    the same secret. Returns (setup, boot_ctx)."""
    params, composite_log2 = make_bootstrapped_params(
        cfg, depth, limb_bits, hamming_weight, int(boot_kwargs.get("scale_limbs", 1)))
    if composite_log2 is not None:
        scale_log2 = composite_log2
    kp = keygen(params, gen)
    ek = keygen_eval_mult(gen, kp.priv)
    gk = keygen_galois(gen, kp.priv, steps=cfg.batch)
    setup = FHESetup(cfg, params, kp, ek, gk, Fraction(2) ** scale_log2)
    return setup, B.setup_bootstrap(gen, kp.priv, **boot_kwargs)


def _exhaust(boot_ctx, ct: CipherText, prescale: float) -> CipherText:
    """Divide by ``prescale`` (EvalMod wants |m| ≲ 1; the factor is folded
    back into dense 2) and drop to the refresh's base tower: under composite
    scaling aligned exactly to (scale_limbs limbs, the context's base scale,
    2^(26·scale_limbs) when it has none)."""
    sl = boot_ctx.scale_limbs
    ex = ct_rescale(CE.mul_plain_scalar(ct, 1.0 / prescale))
    if sl > 1:
        comp = (Fraction(boot_ctx.base_scale) if boot_ctx.base_scale is not None
                else Fraction(2) ** (26 * sl))
        return CE.ct_to(ex, sl, comp)
    return CE.ct_drop_to(ex, sl)


def encrypted_inference_bootstrapped(setup: FHESetup, boot_ctx, model_params,
                                     batch: np.ndarray, gen: torch.Generator,
                                     prescale: float = 4.0):
    """The depth-unlimited forward pass, eager:

        conv → square → dense 1 → square → exhaust → bootstrap → dense 2

    After the second square the ciphertext is divided by ``prescale`` and
    exhausted to the base tower, refreshed without the secret key
    (``bootstrap.bootstrap``), and dense 2 runs at the regained depth with
    ``prescale`` folded into its weights. Returns the decrypted logits
    [classes, B] and the refreshed tower's depth."""
    cfg = setup.cfg
    exhausted = _exhaust(boot_ctx, _eager_to_square2(setup, model_params, batch, gen),
                         prescale)
    refreshed = B.bootstrap(boot_ctx, exhausted)
    out = naive_rectangular_matmul(setup, np.asarray(model_params["w2"]) * prescale, refreshed)
    out = CE.add_plain(out, _bias2(cfg, model_params))
    return _decrypt_logits(setup, out), refreshed.ring.nlimbs


def build_bootstrapped_pipeline(setup: FHESetup, boot_ctx, model_params,
                                prescale: float = 4.0, eager: bool = False):
    """The bootstrapped pipeline on the compiled layers, each at its tower
    level — conv → square → dense 1 → square → exhaust → bootstrap → dense 2 —
    built once (layers, weights and the dense-1 diagonals encoded on the
    keys' device). The dense layers iterate rotations with the setup's one
    Galois key: at deep towers a BSGS key set would cost gigabytes. Dense 2
    is built lazily at the refreshed tower and scale, which the first refresh
    makes known; the refresh is ``bootstrap.bootstrap``'s three phases.

    Returns ``run(batch, gen, layer_times=None) -> (logits [classes, B],
    depth_out)``; ``layer_times`` (a dict) collects each stage's milliseconds
    on the host clock, the device synchronised between stages, the refresh
    as ``modraise_c2s``, ``evalmod`` and ``s2c``. ``run.exhaust(ct)`` and
    ``run.dense2(refreshed)`` are the two stages around the refresh.

    Each stage after the host encode is compiled as the reference jits it
    (:func:`..utils.graphs.jit`, one CUDA graph a stage on the card, all in
    one memory pool, ``run.pool``): the layers, the exhaust
    (``jax.jit(_exhaust)``), the refresh as its three phases (ModRaise +
    CoeffToSlot, EvalMod, SlotToCoeff: the reference's phased form, so that
    the stage clock keeps them apart), dense 2. ``eager=True`` runs them
    eagerly. ``run.encode(batch)`` is the host encode and
    ``run.forward(pts, gen)`` the stages from the encryption to the
    logits ciphertext; ``run.eager`` is the same pipeline with every
    stage eager, as ``run`` is. Its spans are those of
    :func:`build_inference_pipeline`'s ``run``."""
    cfg = setup.cfg
    params = setup.params
    device = setup.kp.pub.key.mask.device
    ring0 = params.ring_cipher
    n = ring0.n
    s0 = setup.scale
    d = cfg.positions

    encode_dual = lambda ring, slots, scale: _encode_dual(ring, slots, scale, device)
    pool = graphs.Pool()
    stage = _stager(not eager, pool)

    enc = JL.BatchEncryptor(params, setup.kp.pub, sigma=3.2, eager=True)

    # ---- conv + bias + rescale at the full deep tower ----
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
    conv = JL.ConvLayer(params, ring0, cfg.channels, eager=True).to(device)
    ring1 = ring0.drop_last()
    s1 = s_conv / ring0.primes[-1]

    # ---- square 1 ----
    sq1 = JL.SquareRelinLayer(params, setup.ek, ring1, eager=True)
    ring2 = ring1.drop_last()
    s2 = s1 * s1 / ring1.primes[-1]

    # ---- dense 1: iterated-rotation diagonal matmul per channel ----
    w1 = np.asarray(model_params["w1"])
    mat1 = JL.RotateMatmulLayer(params, setup.gk, setup.gk.galois_element, d, ring2,
                                eager=True)
    diags1 = [torch.stack([
        encode_dual(ring2, _rep_inner(np.diag(np.roll(w1[:, ci * d:(ci + 1) * d], k, axis=1)),
                                      cfg.batch), s2)
        for k in range(d)], 0) for ci in range(cfg.channels)]
    s_fq1 = s2 * s2
    b1_dual = encode_dual(ring2, _rep_inner(np.asarray(model_params["b1"]), cfg.batch), s_fq1)
    br = JL.BiasRescaleLayer(ring2, eager=True).to(device)
    ring3 = ring2.drop_last()
    s3 = s_fq1 / ring2.primes[-1]

    # ---- square 2 ----
    sq2 = JL.SquareRelinLayer(params, setup.ek, ring3, eager=True)
    ring4 = ring3.drop_last()
    s4 = s3 * s3 / ring3.primes[-1]

    # ---- dense 2 at the regained tower (built on the first refresh) ----
    w2 = np.asarray(model_params["w2"]) * prescale
    wpad2 = np.vstack([w2, np.zeros((d - w2.shape[0], d))])
    bias2 = _bias2(cfg, model_params)
    lazy2 = {}

    def dense2(refreshed: CipherText) -> CipherText:
        ringr, sr = refreshed.ring, Fraction(refreshed.enc.scale)
        if lazy2.get("key") != (ringr, sr):
            lazy2["key"] = (ringr, sr)
            lazy2["mat"] = JL.RotateMatmulLayer(params, setup.gk, setup.gk.galois_element,
                                                d, ringr, eager=True)
            lazy2["diag"] = torch.stack([
                encode_dual(ringr, _rep_inner(np.diag(np.roll(wpad2, k, axis=1)), cfg.batch), sr)
                for k in range(d)], 0)
            lazy2["b2"] = encode_dual(ringr, bias2, sr * sr)
        c1p = R.ensure_primal(ringr, refreshed.cs[0]).primal
        c2p = R.ensure_primal(ringr, refreshed.cs[1]).primal
        r1, r2 = lazy2["mat"](c1p, c2p, lazy2["diag"])
        r1 = modmath.add_mod(r1, lazy2["b2"], ringr.mp)
        return CipherText(params, (RingElt(dual=r1), RingElt(dual=r2)), ringr,
                          enc=CKKSTag(sr * sr))

    def dense1(o1, o2):
        fq1_1 = fq1_2 = None
        for ci in range(cfg.channels):
            r1, r2 = mat1(o1[ci], o2[ci], diags1[ci])      # dual at s2²
            fq1_1 = r1 if fq1_1 is None else modmath.add_mod(fq1_1, r1, ring2.mp)
            fq1_2 = r2 if fq1_2 is None else modmath.add_mod(fq1_2, r2, ring2.mp)
        return fq1_1, fq1_2

    def to_exhausted(g1, g2):
        ct4 = CipherText(params, (RingElt(primal=g1), RingElt(primal=g2)), ring4,
                         enc=CKKSTag(s4))
        return _exhaust(boot_ctx, ct4, prescale)

    encrypt_stage = stage(enc, "encrypt")
    conv_stage = stage(lambda cts: conv(cts, wq, bias_dual), "conv")
    sq1_stage = stage(sq1, "square1")
    dense1 = stage(dense1, "dense1")
    bias_rescale = stage(lambda a, b: br(a, b, b1_dual), "bias_rescale")
    sq2_stage = stage(sq2, "square2")
    exhaust = stage(to_exhausted, "exhaust")
    phase1 = stage(lambda ct: B.bootstrap_phase1(boot_ctx, ct), "modraise_c2s")
    phase2 = stage(lambda lo, hi: B.bootstrap_phase2(boot_ctx, lo, hi), "evalmod")
    phase3 = stage(lambda ev, factor, pin: B.bootstrap_phase3(boot_ctx, ev, factor, pin),
                   "s2c")
    dense2_stage = stage(dense2, "dense2")

    def refresh(ct: CipherText, clock, S) -> CipherText:
        lo, hi = S(phase1)(ct)
        clock("modraise_c2s")
        ev = S(phase2)(lo, hi)
        clock("evalmod")
        out = S(phase3)(ev, *B._phase3_statics(boot_ctx, ct))
        clock("s2c")
        return out

    def encode(batch: np.ndarray) -> torch.Tensor:
        """The host encode of a batch (as :func:`build_inference_pipeline`'s)."""
        with span("toyfhe.encode"):
            with span("toyfhe.encode.preprocess"):
                I = public_preprocess(cfg, batch)
            return CE.ckks_encode_batch(ring0, I.reshape(cfg.grid ** 2, -1), s0, device)

    def forward(pts: torch.Tensor, gen: torch.Generator, clock, S) -> CipherText:
        with span("toyfhe.forward"):
            cts = S(encrypt_stage)(pts, gen)                   # (G, 2, L0, N) dual
            clock("encrypt")
            conv_out = S(conv_stage)(cts)                      # (C, 2, L1, N) primal
            clock("conv")
            o1, o2 = S(sq1_stage)(conv_out[:, 0], conv_out[:, 1])  # (C, L2, N) primal
            clock("square1")
            fq1_1, fq1_2 = S(dense1)(o1, o2)                   # dual at s2²
            clock("dense1")
            f1p, f2p = S(bias_rescale)(fq1_1, fq1_2)           # (L3, N) primal
            clock("bias_rescale")
            g1, g2 = S(sq2_stage)(f1p, f2p)                    # (L4, N) primal
            clock("square2")
            exhausted = S(exhaust)(g1, g2)
            clock("exhaust")
            refreshed = refresh(exhausted, clock, S)
            out = S(dense2_stage)(refreshed)
            clock("dense2")
            return out

    def runner(S):
        def run(batch: np.ndarray, gen: torch.Generator, layer_times: Optional[dict] = None):
            with span("toyfhe.run"):
                clock = _LayerClock(device, layer_times)
                pts = encode(batch)
                clock("encode")
                out = forward(pts, gen, clock, S)
                logits = _decrypt_logits(setup, out)
                clock("decrypt")
                return logits, out.ring.nlimbs

        run.exhaust = lambda ct: _exhaust(boot_ctx, ct, prescale)
        run.dense2 = dense2
        run.encode = encode
        run.forward = lambda pts, gen: forward(pts, gen, _LayerClock(device, None), S)
        run.pool = pool
        return run

    run = runner(_pick(False))
    run.eager = runner(_pick(True))
    return run
