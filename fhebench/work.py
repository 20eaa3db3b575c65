"""The yardstick's arithmetic: bytes, peaks and kernel names, from a
configuration file alone.

Frozen here so that a later change to the program cannot move it:

* the H100's published HBM3 rate (NVIDIA's data sheet, SXM part);
* ``ntt_bytes``: the least device traffic of a batched limb transform, each
  residue read once and written once at 4 bytes (every prime is below
  2^31, so no implementation needs more);
* the kernel-name groups of a device trace (K1 and the elementwise passes);
* ``floor_bytes``: the least bytes one request of an encrypted-MNIST
  configuration has to move at least once — the inputs the window hands
  the program, the evaluation keys at the level of their largest use, the
  encoded weights and diagonals at their levels and the returned logits —
  at 4 bytes a residue. Its time at the HBM rate is the floor of ``mfu``.
  The int64 modular products have no published H100 peak, so no compute
  floor is counted. Another pipeline's floor is its own file,
  ``floors/<system>.py``, found by the configuration's ``system``.
"""

from __future__ import annotations

import math
from pathlib import Path

HERE = Path(__file__).resolve().parent

H100_HBM_BYTES_PER_S = 3.35e12      # NVIDIA H100 SXM data sheet: 3.35 TB/s
RESIDUE_BYTES = 4                   # residues of primes below 2^31
FLOAT_BYTES = 4                     # an image pixel or a returned logit

K1_KERNELS = ("ntt_cluster_kernel", "ntt_radix2_kernel")

GROUPS = (("ntt_cluster_kernel", "K1 transforms"), ("ntt_radix2_kernel", "K1 transforms"),
          ("elementwise", "elementwise"),
          ("reduce", "reductions"), ("index", "gathers"), ("gather", "gathers"),
          ("Cat", "concatenations"), ("cat", "concatenations"), ("copy", "copies"))


def group_of(name: str) -> str:
    for needle, label in GROUPS:
        if needle in name:
            return label
    return "other"


def is_k1(name: str) -> bool:
    return any(k in name for k in K1_KERNELS)


def ntt_bytes(n: int, nlimbs: int, batch: int = 1) -> int:
    """Least device-memory traffic of a batched limb transform: read and
    write each 32-bit residue once."""
    return 2 * batch * nlimbs * n * RESIDUE_BYTES


def seconds_at_hbm(nbytes: float) -> float:
    return nbytes / H100_HBM_BYTES_PER_S


# ---------------------------------------------------------------------------
# shapes of the encrypted-MNIST configurations
# ---------------------------------------------------------------------------

def bsgs_split(d: int):
    """(baby, giant) counts of a BSGS matmul over d diagonals."""
    bs = max(1, math.isqrt(d))
    return bs, (d + bs - 1) // bs


def model_shape(model: dict):
    """(positions d, images a request, grid cells k²)."""
    side = (model["image"] - model["kernel"]) // model["stride"] + 1
    d = side * side
    n = 1 << model["ring_logn"]
    return d, n // 2 // d, model["kernel"] ** 2


class Tower:
    """A hybrid key-switching tower: ``data`` ciphertext limbs, ``special``
    raising limbs, the data limbs cut into ``dnum`` digits."""

    def __init__(self, n: int, data: int, special: int, dnum: int):
        self.n, self.data, self.special, self.dnum = n, data, special, dnum
        self.alpha = -(-data // dnum)

    def poly(self, limbs: int) -> int:
        return limbs * self.n * RESIDUE_BYTES

    def key(self, level: int) -> int:
        """One hybrid key switching a ciphertext of ``level`` data limbs: two
        components of each digit's key over the level's limbs and the
        raising limbs."""
        digits = -(-level // self.alpha)
        return 2 * digits * self.poly(level + self.special)


def _keys(uses) -> int:
    """Bytes of keys, each counted once at its largest use: uses is
    [(key name, bytes at that use)]."""
    most: dict = {}
    for name, nbytes in uses:
        most[name] = max(most.get(name, 0), nbytes)
    return sum(most.values())


def floor_bytes(config: dict, encoded_inputs: bool) -> int:
    """Least bytes one request of ``config`` moves (``encoded_inputs``: the
    window hands the program the encoded grid, not the images). A system
    other than the two below takes ``floor_bytes(config, encoded_inputs)``
    of ``<HERE>/floors/<system>.py``; with no such file it raises."""
    if config["system"] not in ("mnist_bsgs", "mnist_boot"):
        path = HERE / "floors" / f"{config['system']}.py"
        if not path.is_file():
            raise ValueError(f"no byte floor for system {config['system']!r}: {path} is missing")
        from .harness import load_module          # harness imports this module
        return load_module("floors", config["system"], HERE).floor_bytes(config, encoded_inputs)
    model = config["model"]
    d, batch, grid = model_shape(model)
    n = 1 << model["ring_logn"]
    c = model["channels"]
    if config["system"] == "mnist_bsgs":
        t = Tower(n, len(model["limb_bits"]) - model["num_special"], model["num_special"],
                  model["dnum"])
        L = t.data
        bs, gs = bsgs_split(d)
        rotations = [("baby", b) for b in range(1, bs)] + [("giant", g) for g in range(1, gs)]
        keys = ([("relin", t.key(L - 1)), ("relin", t.key(L - 3)), ("public", 2 * t.poly(L))]
                + [(r, t.key(L - 2)) for r in rotations]           # dense 1
                + [(r, t.key(L - 4)) for r in rotations])          # dense 2
        plain = (c * t.poly(L)                                     # conv biases
                 + c * d * t.poly(L - 2) + t.poly(L - 2)           # dense 1 diagonals, bias
                 + d * t.poly(L - 4) + t.poly(L - 4)               # dense 2 diagonals, bias
                 + t.poly(L - 4))                                  # the secret key's rows
        inputs = grid * t.poly(L) if encoded_inputs else batch * model["image"] ** 2 * FLOAT_BYTES
    elif config["system"] == "mnist_boot":
        r = config["recipe"]
        depth = r["depth"]
        dnum = max(1, (depth + 2) // 5)
        special = -(-(depth + 2) // dnum) + 1
        sl = r["scale_limbs"]
        t = Tower(n, depth + sl, special, dnum)
        L = t.data
        keys = [("relin", t.key(L - 1)), ("relin", t.key(L - 3)), ("public", 2 * t.poly(L)),
                ("pipeline rotation", t.key(L - 2)), ("pipeline rotation", t.key(sl))]
        plain = (c * t.poly(L) + c * d * t.poly(L - 2) + t.poly(L - 2)
                 + d * t.poly(sl) + t.poly(sl) + t.poly(sl))
        # the refresh: its conjugation key and CoeffToSlot at their levels
        # (ModRaise lifts to the whole data tower; each level spends sl
        # limbs); EvalMod's key and SlotToCoeff at the base tower, a lower
        # bound (their levels follow the EvalMod plan)
        keys += [("conjugation", t.key(L)), ("refresh relin", t.key(sl))]
        for i, offsets in enumerate(sfft_level_offsets(n // 2, r["radix"])):
            level = L - sl * i
            keys += [(("refresh rotation", s), t.key(level))
                     for s in bsgs_rotation_steps(offsets, n // 2)]
            plain += 4 * len(offsets) * t.poly(level)              # [c, c̄, c, c̄] chains
        for offsets in reversed(sfft_level_offsets(n // 2, r["radix"])):
            keys += [(("refresh rotation", s), t.key(sl))
                     for s in bsgs_rotation_steps(offsets, n // 2)]
            plain += 2 * len(offsets) * t.poly(sl)                 # [lo, hi] chains
        inputs = grid * t.poly(L) if encoded_inputs else batch * model["image"] ** 2 * FLOAT_BYTES
    logits = model["classes"] * batch * FLOAT_BYTES
    return inputs + _keys(keys) + plain + logits


# ---------------------------------------------------------------------------
# the factored CoeffToSlot / SlotToCoeff: which diagonals and rotations
# ---------------------------------------------------------------------------

def sfft_level_offsets(d: int, radix: int) -> list:
    """Diagonal offsets of each merged level of the radix-``radix`` special
    FFT over d slots, in CoeffToSlot's order: the butterfly factor of size
    t has offsets {0, ±t/2}; a level merges log2(radix) factors, so its
    offsets are their sums; CoeffToSlot applies the transposes (offsets
    negated), last level first."""
    per = max(1, radix.bit_length() - 1)
    sizes = []
    t = 2
    while t <= d:
        sizes.append(t)
        t *= 2
    levels = []
    for i in range(0, len(sizes), per):
        offs = {0}
        for t in sizes[i:i + per]:
            offs = {(o + e) % d for o in offs for e in (0, t // 2, -(t // 2))}
        levels.append(sorted(offs))
    return [sorted({(-o) % d for o in lv}) for lv in reversed(levels)]


def bsgs_rotation_steps(offsets, d: int) -> set:
    """The rotation steps (mod d, without 0) of a BSGS application of the
    given diagonal offsets, grouped by their gap as the program's plan
    groups them."""
    cen = [o if o <= d // 2 else o - d for o in sorted({o % d for o in offsets})]
    gap = 0
    for u in cen:
        gap = math.gcd(gap, u)
    gap = gap or 1
    us = sorted(u // gap for u in cen)
    bs = max(1, math.isqrt(len(us)))
    steps = set()
    for u in us:
        b = u % bs
        steps |= {((u - b) * gap) % d, (b * gap) % d}
    return steps - {0}
