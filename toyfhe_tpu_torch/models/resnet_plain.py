"""ResNet-20 on CIFAR-10 in plain PyTorch, float64: the plain reference of
the encrypted pipeline of :mod:`.resnet`.

He et al., "Deep Residual Learning for Image Recognition", CVPR 2016,
§4.2: the 6n+2 network for 32×32 images — a 3×3 conv to 16 channels, three
stages of n basic blocks (two 3×3 convs each, batch norm after every conv)
at 16, 32 and 64 channels and 32×32, 16×16 and 8×8, stride 2 in the first
conv of stages 2 and 3, option-A shortcuts (identity; at a stride, every
other pixel and the new channels zero), global average pooling and a
64→10 fully connected layer. n = 3 is ResNet-20.

Departures from He et al., each that of the encrypted model (Lee et al.,
ICML 2022) or of a benchmark without training:

* ReLU is ``AppReLU(x) = x·(1 + s(x/B))/2``, ``s`` the composite
  polynomial whose Chebyshev coefficients the configuration holds
  (``relu.coeffs``, fitted by :mod:`.sign_fit`) and ``B`` the
  configuration's ``bound`` on what enters any ReLU;
* the weights are untrained: convolutions He-normal in fan-out mode (as
  torchvision initialises them), the batch norms' scale, shift and running
  statistics and the FC layer drawn from the seed (:func:`init_params`);
* batch norm is explicit here, with its running statistics (inference
  mode); the encrypted pipeline folds it into the conv weights and biases,
  and folds the CIFAR-10 channel mean and standard deviation into the
  first conv — this file does neither.

It imports torch and numpy alone, nothing of the port, and turns TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def conv_specs(model: dict) -> list:
    """[(name, in channels, out channels, stride)] of every conv, in the
    order the forward pass runs them (and :func:`init_params` draws them)."""
    widths = model["widths"]
    specs = [("stem", model["in_channels"], widths[0], 1)]
    cin = widths[0]
    for i, w in enumerate(widths):
        for j in range(model["blocks_per_stage"]):
            stride = 2 if (i > 0 and j == 0) else 1
            specs.append((f"s{i}.b{j}.conv1", cin, w, stride))
            specs.append((f"s{i}.b{j}.conv2", w, w, 1))
            cin = w
    return specs


def init_params(model: dict, rng: np.random.Generator) -> dict:
    """Untrained weights in float64: per conv its weight [out, in, 3, 3]
    (He normal, fan-out) and its batch norm (``.gamma`` U(0.5, 1),
    ``.beta`` N(0, 0.1²), ``.mean`` N(0, 0.1²), ``.var`` U(0.5, 1.5)),
    then ``fc.w`` [classes, 64] N(0, 1/64) and ``fc.b`` N(0, 0.1²)."""
    p = {}
    for name, cin, cout, _ in conv_specs(model):
        p[f"{name}.w"] = rng.normal(size=(cout, cin, 3, 3)) * np.sqrt(2.0 / (cout * 9))
        p[f"{name}.gamma"] = rng.uniform(0.5, 1.0, cout)
        p[f"{name}.beta"] = rng.normal(size=cout) * 0.1
        p[f"{name}.mean"] = rng.normal(size=cout) * 0.1
        p[f"{name}.var"] = rng.uniform(0.5, 1.5, cout)
    width = model["widths"][-1]
    p["fc.w"] = rng.normal(size=(model["classes"], width)) / np.sqrt(width)
    p["fc.b"] = rng.normal(size=model["classes"]) * 0.1
    return p


def sign_poly(u: torch.Tensor, comps) -> torch.Tensor:
    """s(u): each component's Chebyshev series by Clenshaw's recurrence."""
    for c in comps:
        b1 = torch.zeros_like(u)
        b2 = torch.zeros_like(u)
        for a in reversed(c[1:]):
            b1, b2 = 2 * u * b1 - b2 + a, b1
        u = u * b1 - b2 + c[0]
    return u


def app_relu(x: torch.Tensor, model: dict) -> torch.Tensor:
    relu = model["relu"]
    return x * (1 + sign_poly(x / model["bound"], relu["coeffs"])) / 2


def _bn(x: torch.Tensor, params: dict, name: str, eps: float) -> torch.Tensor:
    g = lambda k: torch.as_tensor(params[f"{name}.{k}"], dtype=x.dtype)[:, None, None]
    return (x - g("mean")) / torch.sqrt(g("var") + eps) * g("gamma") + g("beta")


def _conv(x: torch.Tensor, params: dict, name: str, stride: int) -> torch.Tensor:
    w = torch.as_tensor(params[f"{name}.w"], dtype=x.dtype)
    return torch.nn.functional.conv2d(x, w, stride=stride, padding=1)


def _shortcut(x: torch.Tensor, cout: int, stride: int) -> torch.Tensor:
    """Option A: identity; at a stride, every other pixel, the new channels
    zero."""
    if stride == 1 and x.shape[1] == cout:
        return x
    x = x[:, :, ::stride, ::stride]
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, cout - x.shape[1]))


def forward_torch(model: dict, params: dict, images: torch.Tensor, relu=None) -> torch.Tensor:
    """Logits [B, classes] of images [B, C, H, W] in [0, 1], in the
    tensor's dtype; ``relu(x, model)`` replaces :func:`app_relu`."""
    app_relu = relu or globals()["app_relu"]
    eps = model["bn_eps"]
    mean = torch.as_tensor(model["mean"], dtype=images.dtype)[:, None, None]
    std = torch.as_tensor(model["std"], dtype=images.dtype)[:, None, None]
    x = (images - mean) / std
    specs = conv_specs(model)
    x = app_relu(_bn(_conv(x, params, "stem", 1), params, "stem", eps), model)
    for k in range(1, len(specs), 2):
        (n1, _, cout, stride), (n2, _, _, _) = specs[k], specs[k + 1]
        h = app_relu(_bn(_conv(x, params, n1, stride), params, n1, eps), model)
        h = _bn(_conv(h, params, n2, 1), params, n2, eps)
        x = app_relu(h + _shortcut(x, cout, stride), model)
    pooled = x.mean(dim=(2, 3))
    w = torch.as_tensor(params["fc.w"], dtype=images.dtype)
    return pooled @ w.T + torch.as_tensor(params["fc.b"], dtype=images.dtype)


def forward(model: dict, params: dict, images) -> np.ndarray:
    """Logits [B, classes] in float64 of images [B, C, H, W] in [0, 1]."""
    x = torch.as_tensor(np.asarray(images, dtype=np.float64))
    with torch.no_grad():
        return forward_torch(model, params, x).numpy()


def relu_inputs_max(model: dict, params: dict, images) -> float:
    """The largest |x| that enters any ReLU over ``images``, every ReLU
    exact: the sweep that sets the configuration's ``bound``."""
    worst = [0.0]

    def relu(x, _model):
        worst[0] = max(worst[0], float(x.abs().max()))
        return torch.relu(x)

    with torch.no_grad():
        forward_torch(model, params, torch.as_tensor(np.asarray(images, dtype=np.float64)),
                      relu)
    return worst[0]


def bound_sweep(model: dict, images: int = 256) -> float:
    """The configuration's ``bound``: 1.25 times the largest |x| entering any
    ReLU over ``images`` seeded images, image k with the weights of seed k
    (``numpy.random.default_rng([k, 1])``, as a run draws them) and pixels
    uniform in [0, 1] from ``default_rng([k, 2])``."""
    worst = 0.0
    side, c = model["image"], model["in_channels"]
    for k in range(images):
        params = init_params(model, np.random.default_rng([k, 1]))
        img = np.random.default_rng([k, 2]).uniform(0.0, 1.0, (1, c, side, side))
        worst = max(worst, relu_inputs_max(model, params, img))
    return 1.25 * worst
