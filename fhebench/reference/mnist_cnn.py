"""The plain reference of the encrypted-MNIST cells: the x²-CNN in numpy.

conv (k×k kernel, stride s, C channels) + bias → square → channel-major
features → dense (positions × features) + bias → square → dense (classes ×
positions) + bias, in float64, on [B, H, W] images. This is the forward pass
of ToyFHE.jl's ``examples/encrypted_mnist`` model as the port serves it
(``models/mnist.py::model_forward``), written out again here; it imports
nothing of the port and takes nothing the port made.

``init_params`` draws the weights with the model's distributions (conv
N(0, 0.2²), dense layers N(0, 1/fan_in), zero biases). The benchmark hands
the same arrays to the port and to :func:`forward`.

``forward(..., bits=11)`` is the same pass with every operand and every
layer's result rounded to 11 significant bits, float16's precision (without
its range): its gap from the exact pass is the unit the judge reads the
program's gaps in. The control of the comparison (``fhebench/control.py``)
is this pass computed in a lower precision: :func:`forward_lowp`, in torch.
"""

from __future__ import annotations

import numpy as np
import torch

FP8 = ("float8_e4m3fn", "float8_e5m2")


def conv_side(model: dict) -> int:
    return (model["image"] - model["kernel"]) // model["stride"] + 1


def positions(model: dict) -> int:
    return conv_side(model) ** 2


def request_shape(model: dict):
    """(images a request carries, the shape of one image): the N/2 slots
    hold one value per image and conv position, so N/2 // positions images
    of side × side grayscale pixels."""
    side = model["image"]
    return (1 << model["ring_logn"]) // 2 // positions(model), (side, side)


def init_params(model: dict, rng: np.random.Generator) -> dict:
    """Untrained weights (float64) with the model's distributions."""
    k, c = model["kernel"], model["channels"]
    d = positions(model)
    f = c * d
    return {
        "conv_w": rng.normal(size=(k, k, c)) * 0.2,
        "conv_b": np.zeros(c),
        "w1": rng.normal(size=(d, f)) * (1.0 / np.sqrt(f)),
        "b1": np.zeros(d),
        "w2": rng.normal(size=(model["classes"], d)) * (1.0 / np.sqrt(d)),
        "b2": np.zeros(model["classes"]),
    }


def patches(model: dict, images: np.ndarray) -> np.ndarray:
    """[B, H, W] → [B, positions, k·k] stride-cropped patches, row-major."""
    k, s = model["kernel"], model["stride"]
    side = conv_side(model)
    rows = [images[:, i * s: i * s + k, j * s: j * s + k].reshape(images.shape[0], -1)
            for i in range(side) for j in range(side)]
    return np.stack(rows, axis=1)


def round_bits(a, bits: int) -> np.ndarray:
    """``a`` in float64, each value rounded (half to even) to ``bits``
    significant bits."""
    m, e = np.frexp(np.asarray(a, dtype=np.float64))
    return np.ldexp(np.round(m * (1 << bits)) / (1 << bits), e)


def forward(model: dict, params: dict, images: np.ndarray, bits=None) -> np.ndarray:
    """Logits [B, classes] of the x²-CNN in float64; with ``bits``, every
    operand and every result rounded to that many significant bits."""
    t = ((lambda a: np.asarray(a, dtype=np.float64)) if bits is None
         else (lambda a: round_bits(a, bits)))
    c = model["channels"]
    pt = t(patches(model, t(images)))
    conv = t(t(np.einsum("bpk,kc->bpc", pt, t(params["conv_w"]).reshape(-1, c)))
             + t(params["conv_b"]))
    sq1 = t(conv * conv)
    feats = np.concatenate([sq1[:, :, ch] for ch in range(c)], axis=1)
    fq1 = t(t(feats @ t(params["w1"]).T) + t(params["b1"]))
    sq2 = t(fq1 * fq1)
    return t(t(sq2 @ t(params["w2"]).T) + t(params["b2"]))


def forward_lowp(model: dict, params: dict, images: np.ndarray, dtype, device) -> np.ndarray:
    """The same pass with every operand and result in the torch ``dtype``:
    logits [B, classes] as float64. The float8 types have no general
    arithmetic: each operand and each op's result is rounded to them, the
    op itself computed in float32."""
    fp8 = str(dtype).split(".")[-1] in FP8
    work = torch.float32 if fp8 else dtype
    q = (lambda x: x.to(dtype).to(work)) if fp8 else (lambda x: x)
    t = lambda a: q(torch.as_tensor(np.asarray(a, dtype=np.float64)).to(device=device,
                                                                         dtype=work))
    c = model["channels"]
    pt = t(patches(model, np.asarray(images, dtype=np.float64)))
    conv = q(q(torch.einsum("bpk,kc->bpc", pt, t(params["conv_w"]).reshape(-1, c)))
             + t(params["conv_b"]))
    sq1 = q(conv * conv)
    feats = torch.cat([sq1[:, :, ch] for ch in range(c)], dim=1)
    fq1 = q(q(feats @ t(params["w1"]).T) + t(params["b1"]))
    sq2 = q(fq1 * fq1)
    out = q(q(sq2 @ t(params["w2"]).T) + t(params["b2"]))
    return out.to(torch.float64).cpu().numpy()
