"""The plain reference of the ResNet-20 cell: ResNet-20 on CIFAR-10 with
the approximate ReLU of the encrypted model, in float64 torch.

He et al. 2016, §4.2 (the 6n+2 network, option-A shortcuts, batch norm
after every conv, global average pooling, one FC layer) with every ReLU
replaced by Lee et al.'s (ICML 2022) ``AppReLU(x) = x·(1 + s(x/B))/2``: ``s``
the composite polynomial of the configuration (``relu.coeffs``, Chebyshev
coefficients on [−1, 1], first applied first), ``B`` its ``bound``. The
input is normalised by the CIFAR-10 channel mean and standard deviation
first; batch norm runs on its running statistics.

Written out again here from the paper; it imports nothing of the port and
takes nothing the port made. ``init_params`` draws the weights (untrained:
convs He-normal in fan-out mode, batch norms and the FC layer from the
seed) in the same order and with the same distributions as the port's
plain model, so both are handed the same arrays.

``forward(..., bits=11)`` rounds every operand and every result to 11
significant bits (float16's precision, without its range): each conv's
weights and output, each batch norm, each polynomial component of every
ReLU and its product, the shortcut sums, the pool and the FC layer.
``forward_lowp`` is the same pass computed in a lower torch precision, the
control of the comparison. TF32 is off.
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FP8 = ("float8_e4m3fn", "float8_e5m2")


def request_shape(model: dict):
    """One colour image a request."""
    side = model["image"]
    return 1, (model["in_channels"], side, side)


def convs(model: dict) -> list:
    """(name, in, out, stride) of each conv in the order of the pass."""
    out, cin = [("stem", model["in_channels"], model["widths"][0], 1)], model["widths"][0]
    for i, width in enumerate(model["widths"]):
        for j in range(model["blocks_per_stage"]):
            out += [(f"s{i}.b{j}.conv1", cin, width, 2 if i and not j else 1),
                    (f"s{i}.b{j}.conv2", width, width, 1)]
            cin = width
    return out


def init_params(model: dict, rng: np.random.Generator) -> dict:
    """Per conv: ``.w`` N(0, 2/(out·9)) [out, in, 3, 3], ``.gamma``
    U(0.5, 1), ``.beta`` N(0, 0.01), ``.mean`` N(0, 0.01), ``.var``
    U(0.5, 1.5); then ``fc.w`` N(0, 1/width) and ``fc.b`` N(0, 0.01)."""
    params = {}
    for name, cin, cout, _ in convs(model):
        params[name + ".w"] = rng.normal(size=(cout, cin, 3, 3)) * np.sqrt(2.0 / (9 * cout))
        params[name + ".gamma"] = rng.uniform(0.5, 1.0, cout)
        params[name + ".beta"] = 0.1 * rng.normal(size=cout)
        params[name + ".mean"] = 0.1 * rng.normal(size=cout)
        params[name + ".var"] = rng.uniform(0.5, 1.5, cout)
    width = model["widths"][-1]
    params["fc.w"] = rng.normal(size=(model["classes"], width)) / np.sqrt(width)
    params["fc.b"] = 0.1 * rng.normal(size=model["classes"])
    return params


def round_bits(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Each float64 value rounded (half to even) to ``bits`` significant bits."""
    m, e = torch.frexp(x)
    return torch.ldexp(torch.round(m * (1 << bits)) / (1 << bits), e.to(x.dtype))


def _pass(model: dict, params: dict, images: torch.Tensor, t, q, cast) -> torch.Tensor:
    """The network with ``t`` applied to every parameter (the operand
    rounding), ``q`` to every result, arithmetic in ``images``' dtype
    (``cast`` brings a float64 array to it)."""
    P = lambda name: t(cast(params[name]))
    col = lambda v: v[:, None, None]
    relu = model["relu"]
    inv_b = t(cast(np.float64(1.0 / model["bound"])))

    def sign(u):
        for c in relu["coeffs"]:
            c = t(cast(np.asarray(c)))
            b1 = b2 = torch.zeros_like(u)
            for a in reversed(c[1:]):
                b1, b2 = q(q(q(2 * u) * b1 - b2) + a), b1
            u = q(q(u * b1 - b2) + c[0])
        return u

    def app_relu(x):
        return q(q(x * q(1 + sign(q(x * inv_b)))) / 2)

    def conv_bn(x, name, stride):
        y = q(torch.nn.functional.conv2d(x, P(name + ".w"), stride=stride, padding=1))
        scale = q(P(name + ".gamma") / q(torch.sqrt(P(name + ".var") + model["bn_eps"])))
        return q(q(q(y - col(P(name + ".mean"))) * col(scale)) + col(P(name + ".beta")))

    mean, std = t(cast(np.asarray(model["mean"]))), t(cast(np.asarray(model["std"])))
    x = q(q(t(images) - col(mean)) / col(std))
    layers = convs(model)
    x = app_relu(conv_bn(x, "stem", 1))
    for k in range(1, len(layers), 2):
        (first, _, cout, stride), (second, _, _, _) = layers[k], layers[k + 1]
        h = conv_bn(app_relu(conv_bn(x, first, stride)), second, 1)
        short = x[:, :, ::stride, ::stride]
        short = torch.nn.functional.pad(short, (0, 0, 0, 0, 0, cout - short.shape[1]))
        x = app_relu(q(h + short))
    pooled = q(x.mean(dim=(2, 3)))
    return q(q(pooled @ P("fc.w").T) + P("fc.b"))


def forward(model: dict, params: dict, images, bits=None) -> np.ndarray:
    """Logits [B, classes] in float64 of images [B, C, H, W]; with ``bits``
    every operand and result rounded to that many significant bits."""
    r = (lambda x: x) if bits is None else (lambda x: round_bits(x, bits))
    cast = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))
    with torch.no_grad():
        out = _pass(model, params, cast(images), r, r, cast)
    return out.numpy()


def forward_lowp(model: dict, params: dict, images, dtype, device) -> np.ndarray:
    """The same pass with every operand and result in the torch ``dtype``:
    logits [B, classes] as float64. The float8 types have no general
    arithmetic: each operand and each op's result is rounded to them, the
    op itself computed in float32."""
    fp8 = str(dtype).split(".")[-1] in FP8
    work = torch.float32 if fp8 else dtype
    q = (lambda x: x.to(dtype).to(work)) if fp8 else (lambda x: x)
    cast = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64)).to(device=device,
                                                                          dtype=work)
    with torch.no_grad():
        out = _pass(model, params, cast(images), q, q, cast)
    return out.to(torch.float64).cpu().numpy()
