"""Special-FFT factorization of the CKKS encoding matrix (host side).

Port of ``toyfhe_tpu/core/sfft.py``, the same float64 numpy. The
CoeffToSlot / SlotToCoeff phases of bootstrapping apply the CKKS decode
matrix U[j,k] = ω^{g_j·k} (ω = e^{−2πi/2N}, g_j = 3^{j+1} mod 2N — the slot
ordering of ``ckks_encoding.zmstar_indices``). Dense application needs
d = N/2 diagonals per matrix — gigabytes of plaintext constants at
production N. This module factors the d×d core

    V[j,k] = ω^{g_j·k},   j,k < d

into log₂(d) two/three-diagonal butterfly stages (radix-mergeable):

    V = B_d · B_{d/2} · ⋯ · B_2 · P_bitrev

via the radix-2 split k → (2k', 2k'+1): with A = V'·c_even, B = V'·c_odd
(V' the same structure one level down, rows 3^{j+1} mod N),

    v_j       = A_j + ω^{g_j}·B_j
    v_{j+d/2} = A_j − ω^{g_j}·B_j ,

because 3^{d/2} ≡ N+1 (mod 2N) makes even columns repeat with period d/2 in
j and ω^{g_j·N} = −1 flips the odd ones. The bit-reversal P is never applied
homomorphically: EvalMod is pointwise, so CoeffToSlot drops its trailing Pᵀ
and SlotToCoeff starts from the already-permuted slots — the permutations
cancel exactly (see :mod:`.bootstrap`).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "butterfly_stage", "merge_diags", "dense_from_diags", "transpose_diags",
    "conj_diags", "scale_diags", "mul_onediag", "bitrev_perm", "sfft_stages",
    "halfshift_diag", "SfftPlan", "bsgs_split_offsets",
]


# ---------------------------------------------------------------------------
# diagonal-form matrix algebra (offset k ↦ coeff vector c_k[j];
# M[j, (j+k) % d] = c_k[j], matching linear_transform's convention
# M·x = Σ_k c_k ⊙ rot_k(x))
# ---------------------------------------------------------------------------

def dense_from_diags(diags: dict, d: int) -> np.ndarray:
    M = np.zeros((d, d), dtype=np.complex128)
    j = np.arange(d)
    for k, c in diags.items():
        M[j, (j + k) % d] = c
    return M


def merge_diags(a: dict, b: dict, d: int) -> dict:
    """Diagonals of A·B (A applied after B):
    A·B·x = Σ_p c_p ⊙ rot_p(Σ_q e_q ⊙ rot_q x)
          = Σ_{p,q} (c_p ⊙ rot_p(e_q)) ⊙ rot_{p+q}(x)."""
    out: dict = {}
    for p, cp in a.items():
        for q, eq in b.items():
            k = (p + q) % d
            v = cp * np.roll(eq, -p)
            out[k] = out.get(k, 0) + v
    return {k: v for k, v in out.items() if np.any(np.abs(v) > 1e-14)}


def transpose_diags(diags: dict, d: int) -> dict:
    """(Mᵀ) diagonals: cᵀ_k[j] = c_{−k}[(j+k) % d]."""
    return {(-k) % d: np.roll(c, -((-k) % d)) for k, c in diags.items()}


def conj_diags(diags: dict) -> dict:
    return {k: np.conj(c) for k, c in diags.items()}


def scale_diags(diags: dict, s: complex) -> dict:
    return {k: c * s for k, c in diags.items()}


def mul_onediag(diags: dict, vec: np.ndarray) -> dict:
    """diags·diag(vec) — fold a pure diagonal into the first-applied factor
    of a chain: (M·D)x = Σ_k c_k ⊙ rot_k(vec ⊙ x)."""
    return {k: c * np.roll(vec, -k) for k, c in diags.items()}


# ---------------------------------------------------------------------------
# the butterfly stages
# ---------------------------------------------------------------------------

def _twiddles(t: int) -> np.ndarray:
    """ω_t^{g_j}, j < t, with ω_t = e^{−2πi/4t} and g_j = 3^{j+1} mod 4t — the
    level-t instance of the decode root and ordering. For t ≥ 4 the upper
    half is the negated lower half (3^{t/2} ≡ 2t+1 mod 4t); t = 2 is the
    exception (3¹ = 3 ≠ 5 mod 8), so all t rows stay explicit."""
    m = 4 * t
    g = np.empty(t, dtype=np.int64)
    x = 1
    for j in range(t):
        x = x * 3 % m
        g[j] = x
    return np.exp(-2j * np.pi * g / m)


def butterfly_stage(d: int, t: int) -> dict:
    """Diagonals (global size d) of I_{d/t} ⊗ Bfly_t, where for every local
    row j < t (A, B the two half-size sub-transform outputs):
        out_j = A_{j mod t/2} + ω_t^{g_j} · B_{j mod t/2},
    i.e. out_j = x_j + tw_j·x_{j+t/2} on the low half and
    out_j = x_{j−t/2} + tw_j·x_j on the high half."""
    tw = _twiddles(t)
    half = t // 2
    jm = np.arange(d) % t
    lo = jm < half
    tw_j = tw[jm]
    c0 = np.where(lo, 1.0 + 0j, tw_j)
    cp = np.where(lo, tw_j, 0j)
    cm = np.where(lo, 0j, 1.0 + 0j)
    diags = {0: c0, half % d: cp}
    if (-half) % d != half % d:
        diags[(-half) % d] = cm
    else:                                    # t == d: ±d/2 coincide
        diags[half % d] = cp + cm
    return diags


def bitrev_perm(d: int) -> np.ndarray:
    """perm[j] = bit-reversal of j over log2(d) bits (self-inverse)."""
    bits = d.bit_length() - 1
    out = np.zeros(d, dtype=np.int64)
    for j in range(d):
        out[j] = int(format(j, f"0{bits}b")[::-1], 2) if bits else 0
    return out


def halfshift_diag(n: int) -> np.ndarray:
    """diag(ω^{g_j·N/2}): U[:, d:] = diag · U[:, :d] — the W = D·V link
    between the high-coefficient block and the core."""
    d = n // 2
    m = 2 * n
    g = np.empty(d, dtype=np.int64)
    x = 1
    for j in range(d):
        x = x * 3 % m
        g[j] = x
    return np.exp(-2j * np.pi * (g * (n // 2) % m) / m)


def sfft_stages(d: int) -> list:
    """Butterfly factors of V·P_bitrev, in application order (first applied
    first): [B_2, B_4, …, B_d]."""
    t = 2
    out = []
    while t <= d:
        out.append(butterfly_stage(d, t))
        t *= 2
    return out


def _group(stages: list, d: int, radix: int) -> list:
    """Merge runs of log2(radix) butterfly factors into single matrices
    (application order preserved). Later factors multiply on the left."""
    r = max(1, radix.bit_length() - 1)
    out = []
    for i in range(0, len(stages), r):
        run = stages[i:i + r]
        acc = run[0]
        for nxt in run[1:]:
            acc = merge_diags(nxt, acc, d)
        out.append(acc)
    return out


# ---------------------------------------------------------------------------
# the bootstrap plan: merged chains for CoeffToSlot / SlotToCoeff
# ---------------------------------------------------------------------------

class SfftPlan:
    """Factored linear phases for one ring size.

    ``c2s_chains``: 4 chains (lists of diag-dicts, application order)
    computing P·lo and P·hi from (ct, conj(ct)):
        P·lo = chains[0](ct) + chains[1](ct̄)
        P·hi = chains[2](ct) + chains[3](ct̄)
    ``s2c_chains``: 2 chains: out = chains[0](P·lo′) + chains[1](P·hi′).
    All four C2S chains share their rotation structure level by level
    (identical offsets), as do the two S2C chains — so the homomorphic
    application batches them into one stacked ciphertext per phase."""

    def __init__(self, n: int, radix: int = 4):
        d = n // 2
        self.n, self.d, self.radix = n, d, radix
        stages = sfft_stages(d)
        levels = _group(stages, d, radix)          # V·P = L_s ⋯ L_1
        self.nlevels = len(levels)

        # --- SlotToCoeff: V = (L_s ⋯ L_1)·P ; W = D·V -------------------
        dd = halfshift_diag(n)
        s2c_lo = list(levels)                       # applied L_1 … L_s
        s2c_hi = list(levels[:-1]) + [merge_diags(
            {0: dd}, levels[-1], d)]                # fold D into the last
        self.s2c_chains = [s2c_lo, s2c_hi]

        # --- CoeffToSlot: lo = (1/n)(conj(V)ᵀ v + Vᵀ v̄) ----------------
        # Vᵀ = Pᵀ·L_1ᵀ⋯L_sᵀ → apply L_sᵀ first, drop the trailing Pᵀ.
        # (W)ᵀ = Vᵀ·D → fold D into the first-applied factor L_sᵀ·D.
        tls = [transpose_diags(lv, d) for lv in levels]    # L_1ᵀ … L_sᵀ
        inv_n = 1.0 / n
        first = scale_diags(tls[-1], inv_n)                # L_sᵀ/n
        first_hi = mul_onediag(first, dd)                  # (L_sᵀ/n)·D
        rest = tls[-2::-1]                                 # L_{s−1}ᵀ … L_1ᵀ
        chain_v_t = lambda f: [f] + list(rest)
        self.c2s_chains = [
            [conj_diags(x) for x in chain_v_t(first)],     # conj(V)ᵀ/n on v
            chain_v_t(first),                              # Vᵀ/n on v̄
            [conj_diags(x) for x in chain_v_t(first_hi)],  # conj(W)ᵀ/n on v
            chain_v_t(first_hi),                           # Wᵀ/n on v̄
        ]
        self.perm = bitrev_perm(d)

    def rotation_steps(self) -> set:
        """All slot-rotation steps any chain level uses (for keygen) —
        exactly the babies and giants of :func:`bsgs_split_offsets`."""
        steps = set()
        for chains in (self.c2s_chains, self.s2c_chains):
            for chain in chains:
                for level in chain:
                    for g, items in bsgs_split_offsets(level.keys(), self.d).items():
                        steps.add(g % self.d)
                        steps |= {b % self.d for b, _ in items}
        return steps - {0}


def bsgs_split_offsets(offsets, d: int) -> dict:
    """Group diagonal offsets for baby-step / giant-step application:
    returns {giant_step: [(baby_step, offset mod d), ...]} with
    offset ≡ giant + baby. Offsets are centered and divided by their gcd
    ("gap") first, so butterfly levels whose offsets are sparse multiples
    of a stride get √k rotations, not √d."""
    offs = sorted({int(o) % d for o in offsets})
    cen = [o if o <= d // 2 else o - d for o in offs]
    gap = 0
    for u in cen:
        gap = math.gcd(gap, u)
    gap = gap or 1
    us = sorted(u // gap for u in cen)
    bs = max(1, math.isqrt(len(us)))
    groups: dict = {}
    for u in us:
        b = u % bs
        groups.setdefault((u - b) * gap, []).append((b * gap, (u * gap) % d))
    return groups
