"""CKKS bootstrapping — so far only the baby-step / giant-step split that
the BSGS dense layers of the encrypted-MNIST pipeline share with it.

Port of ``toyfhe_tpu/core/bootstrap.py::bsgs_split``; the linear
transforms, the sine evaluation and the bootstrap itself are not ported.
"""

from __future__ import annotations

import math


def bsgs_split(d: int):
    """(baby steps, giant steps) for d diagonals: bs = ⌊√d⌋, gs = ⌈d / bs⌉."""
    bs = max(1, int(math.isqrt(d)))
    gs = (d + bs - 1) // bs
    return bs, gs
