"""The composite sign polynomial of the approximate ReLU, fitted in numpy.

    python -m toyfhe_tpu_torch.models.sign_fit [--degrees 15 15 27] [--alpha 13]

prints the components' Chebyshev coefficients as JSON, the numbers a
configuration file holds under ``relu.coeffs``.

``AppReLU(x) = x·(1 + s(x))/2`` with ``s = p_k ∘ … ∘ p_1`` odd polynomials
approximating sign(x) on [−1, −2^−α] ∪ [2^−α, 1] (Lee et al., "Minimax
approximation of sign function by composite polynomial", 2021, and their
ResNet-20 of ICML 2022 at α = 13 and degrees 15, 15, 27). Each component
is fitted in turn on the image of the ones before it, by Lawson's
iteratively reweighted least squares (which converges to the minimax fit on
the grid), in the Chebyshev basis on [−1, 1] with odd terms only. The error
each fit minimises is the ReLU's: |s(x) − 1| weighted by x over the grid of
the original input, since |AppReLU(x) − ReLU(x)| = |x|·|s(x) − sgn(x)|/2. A
plain minimax fit of each component to 1 spreads its error evenly, up to
|x| = 1, and leaves the composite's ReLU error near 2^−2; the weighted fit
brings it to about 2^−α. Every component but the last is divided by its
largest magnitude on [−1, 1], so that the next one's input stays in
[−1, 1], where the Chebyshev basis is bounded.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
from numpy.polynomial import chebyshev as C

LAWSON_STEPS = 600
GRID_POINTS = 4000


def _odd_basis(x: np.ndarray, degree: int) -> np.ndarray:
    return np.stack([C.chebval(x, np.eye(degree + 1)[k]) for k in range(1, degree + 1, 2)], 1)


def _lawson(basis: np.ndarray, weight: np.ndarray) -> np.ndarray:
    """Coefficients minimising max weight·|basis·c − 1| on the grid."""
    w = np.full(len(weight), 1.0 / len(weight))
    best_err, best = np.inf, None
    ones = np.ones(len(weight))
    for _ in range(LAWSON_STEPS):
        sw = np.sqrt(w)
        c, *_ = np.linalg.lstsq(basis * sw[:, None], sw, rcond=None)
        err = np.abs(basis @ c - ones) * weight
        if err.max() < best_err:
            best_err, best = err.max(), c
        w = w * err
        w /= w.sum()
    return best


def fit_composite_sign(degrees=(15, 15, 27), alpha: int = 13) -> list:
    """The components' Chebyshev coefficients (lists of floats, odd
    entries only nonzero), first applied first."""
    eps = 2.0 ** -alpha
    x = np.unique(np.concatenate([np.geomspace(eps, 1.0, GRID_POINTS),
                                  np.linspace(eps, 1.0, GRID_POINTS)]))
    y, comps = x, []
    for i, d in enumerate(degrees):
        if d % 2 == 0:
            raise ValueError(f"a sign component has odd degree, not {d}")
        coeffs = np.zeros(d + 1)
        coeffs[1::2] = _lawson(_odd_basis(y, d), x)
        if i < len(degrees) - 1:
            coeffs /= np.abs(C.chebval(np.linspace(-1.0, 1.0, 100001), coeffs)).max()
        comps.append(coeffs)
        y = C.chebval(y, coeffs)
    return [[float(v) for v in c] for c in comps]


def sign_approx(x: np.ndarray, comps) -> np.ndarray:
    """s(x) in float64."""
    s = np.asarray(x, dtype=np.float64)
    for c in comps:
        s = C.chebval(s, np.asarray(c, dtype=np.float64))
    return s


def relu_error(comps, points: int = 200001) -> float:
    """max over x ∈ [−1, 1] of |AppReLU(x) − ReLU(x)|."""
    x = np.concatenate([np.linspace(-1.0, 1.0, points), np.geomspace(1e-9, 1.0, points)])
    return float(np.max(np.abs(x * (1 + sign_approx(x, comps)) / 2 - np.maximum(x, 0))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--degrees", type=int, nargs="+", default=[15, 15, 27])
    ap.add_argument("--alpha", type=int, default=13)
    args = ap.parse_args(argv)
    comps = fit_composite_sign(tuple(args.degrees), args.alpha)
    print(json.dumps({"degrees": args.degrees, "alpha": args.alpha, "coeffs": comps,
                      "relu_error_log2": float(np.log2(relu_error(comps)))}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
