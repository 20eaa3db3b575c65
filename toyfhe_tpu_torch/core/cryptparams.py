"""Standard crypto parameters: the HomomorphicEncryption.org security table.

Port of ``toyfhe_tpu/core/cryptparams.py``. The HEStd v1.1 table is carried
over verbatim (it is a published standard). The PALISADE default rings are
re-planned as RNS towers of <2^31 NTT-friendly primes with the same total
modulus bit-length, built lazily.
"""

from __future__ import annotations

import enum
import math
from typing import Dict, Tuple

from .ring import RingContext, make_rns_ring


class StdDistribution(enum.Enum):
    HEStd_uniform = 0
    HEStd_error = 1
    HEStd_ternary = 2


class StdSecurity(enum.IntEnum):
    HEStd_128_classic = 1
    HEStd_192_classic = 2
    HEStd_256_classic = 3


HEStd_uniform = StdDistribution.HEStd_uniform
HEStd_error = StdDistribution.HEStd_error
HEStd_ternary = StdDistribution.HEStd_ternary
HEStd_128_classic = StdSecurity.HEStd_128_classic
HEStd_192_classic = StdSecurity.HEStd_192_classic
HEStd_256_classic = StdSecurity.HEStd_256_classic

# Table from the HomomorphicEncryption.org standard v1.1.
_STD_N = [1024, 2048, 4096, 8192, 16384, 32768]
_STD_PARAMS = {
    HEStd_uniform: {
        1024: (29, 21, 16), 2048: (56, 39, 31), 4096: (111, 77, 60),
        8192: (220, 154, 120), 16384: (440, 307, 239), 32768: (880, 612, 478)},
    HEStd_error: {
        1024: (29, 21, 16), 2048: (56, 39, 31), 4096: (111, 77, 60),
        8192: (220, 154, 120), 16384: (440, 307, 239), 32768: (883, 613, 478)},
    HEStd_ternary: {
        1024: (27, 19, 14), 2048: (54, 37, 29), 4096: (109, 75, 58),
        8192: (218, 152, 118), 16384: (438, 305, 237), 32768: (881, 611, 476)},
}


def std_ring_dim(dist_type: StdDistribution, min_sec_level: StdSecurity,
                 cur_log_q: float) -> int:
    """Smallest standard N whose security budget covers log2(q)
    (cryptparams.jl:76-78)."""
    for n in _STD_N:
        if _STD_PARAMS[dist_type][n][int(min_sec_level) - 1] >= cur_log_q:
            return n
    raise ValueError(f"log2(q)={cur_log_q} exceeds the standard table")


# PALISADE BGV default rings (cryptparams.jl:20-26): m -> (N, total q bits).
# Re-planned onto RNS towers with matching modulus size.
_PALISADE_SHAPES: Dict[int, Tuple[int, Tuple[int, ...]]] = {
    16: (8, (27, 13)),           # ≈ 2^40 (1099511627873)
    1024: (512, (20,)),          # ≈ 2^19.0 (525313)
    2048: (1024, (18, 17)),      # ≈ 2^35 (34359724033)
    4096: (2048, (30, 30)),      # ≈ 2^60 (1152921504606830593)
}

_palisade_cache: Dict[int, RingContext] = {}


def palisade_ring(m: int) -> RingContext:
    """Ring matching PALISADE's default for cyclotomic index m."""
    if m not in _palisade_cache:
        n, logqs = _PALISADE_SHAPES[m]
        _palisade_cache[m] = make_rns_ring(n, logqs)
    return _palisade_cache[m]


def estimate_security(n: int, log_q: float,
                      dist: StdDistribution = HEStd_ternary) -> int:
    """Highest HEStd v1.1 classic security level (128/192/256 bits)
    whose modulus budget covers log2(q) at ring dimension n; 0 when
    below 128-bit (or n below the standard table). Between table rows
    the next LOWER n's budget is used — conservative, since the budget
    grows with n. Generalizes the reference's one-way std_ring_dim
    lookup (ToyFHE.jl cryptparams.jl:76-78) into an audit direction."""
    fit = 0
    for tn in _STD_N:
        if tn <= n:
            fit = tn
    if fit == 0:
        return 0
    row = _STD_PARAMS[dist][fit]
    for level, idx in ((256, 2), (192, 1), (128, 0)):
        if row[idx] >= log_q:
            return level
    return 0


def security_level(params) -> int:
    """HEStd classic security of a parameter set, from the KEY tower
    (keys live at the full Q·P modulus — the security-relevant size;
    raising primes count). Sparse ternary secrets are rated with the
    ternary table — the standard has no sparse column, so treat the
    result as an upper bound for small hamming weights."""
    ring = params.ring_key
    dist = HEStd_ternary
    base = params
    while hasattr(base, "params"):
        base = base.params
    if getattr(base, "secret", None) == "gaussian":
        dist = HEStd_error
    return estimate_security(ring.n, math.log2(ring.modulus), dist)
