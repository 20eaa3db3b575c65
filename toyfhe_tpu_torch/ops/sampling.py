"""Ring element sampling driven by an explicit ``torch.Generator``.

Port of ``toyfhe_tpu/ops/sampling.py``. Every sampler draws from the
generator it is given and returns tensors on that generator's device, so a
keygen or encryption is reproducible from the generator's seed. (The
streams differ from ``jax.random``'s; only the distributions match.)

Distributions:
  * uniform over the full tower — an independent uniform residue per limb;
  * discrete gaussian (rounded normal) — one integer per coefficient,
    embedded into every limb, optionally scaled by ``shift``;
  * sparse ternary — exactly ``h`` nonzero ±1 coefficients;
  * zero.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import modmath


def uniform(gen: torch.Generator, mp: modmath.MontParams, n: int,
            batch: Tuple[int, ...] = ()):
    """Uniform residues int64[batch..., L, N] — one independent draw per limb."""
    cols = [torch.randint(0, int(p), batch + (1, n), generator=gen,
                          device=gen.device, dtype=torch.int64)
            for p in mp.p.ravel().tolist()]
    return torch.cat(cols, dim=-2)


def discrete_gaussian(gen: torch.Generator, mp: modmath.MontParams, n: int,
                      sigma: float, batch: Tuple[int, ...] = (), shift: int = 1):
    """Rounded discrete gaussian, optionally scaled by ``shift``; the same
    signed integer reduced into every limb of the tower."""
    g = torch.randn(batch + (1, n), generator=gen, device=gen.device,
                    dtype=torch.float32) * sigma
    ints = torch.round(g).to(torch.int64) * int(shift)
    return modmath.from_signed(ints.expand(batch + (mp.nlimbs, n)), mp)


def zero(mp: modmath.MontParams, n: int, batch: Tuple[int, ...] = (), *, device):
    return torch.zeros(batch + (mp.nlimbs, n), dtype=torch.int64, device=device)


def sparse_ternary(gen: torch.Generator, mp: modmath.MontParams, n: int, h: int,
                   batch: Tuple[int, ...] = ()):
    """Sparse ternary secret: exactly ``h`` nonzero ±1 coefficients at
    uniform positions."""
    nb = 1
    for b in batch:
        nb *= b
    outs = []
    for _ in range(nb):
        perm = torch.randperm(n, generator=gen, device=gen.device)
        signs = torch.randint(0, 2, (n,), generator=gen, device=gen.device,
                              dtype=torch.int64) * 2 - 1
        outs.append(torch.where(perm < h, signs, 0))
    ints = torch.stack(outs).reshape(batch + (1, n))
    return modmath.from_signed(ints.expand(batch + (mp.nlimbs, n)), mp)
