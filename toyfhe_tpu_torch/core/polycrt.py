"""PolyCRT plaintext encoding over general cyclotomic rings.

Port of ``toyfhe_tpu/core/polycrt.py``, which rebuilds ToyFHE.jl's
``src/polycrtencoding.jl``: SIMD slots from the factorization of Φm(x)
over 𝔽p (or ℤ/p^k via Hensel lifting), with explicit field isomorphisms into
one canonical 𝔽_{p^d} so every slot is an element of the same field
(``ExplicitIsomorphisms``, polycrtencoding.jl:7-86).

All of this is host-side setup-time machinery (the FLINT/Hecke role, SURVEY
§2.8): factorization, Hensel lifting and the isomorphism tables are
computed once per parameter set with exact Python integers.

Slot values are canonical-field elements given as coefficient lists in
the generator β (a root of the first factor), or plain integers.
"""

from __future__ import annotations

from typing import List, Sequence, Union

from . import generic_ring as G

SlotValue = Union[int, Sequence[int]]


class PolyCRTContext:
    def __init__(self, m: int, p: int, k: int = 1, seed: int = 0):
        self.m = int(m)
        self.p = int(p)
        self.k = int(k)
        self.q = self.p ** self.k
        phi_zz = G.cyclotomic_poly(self.m)
        self.phi = G.poly_mod_q(phi_zz, self.q)
        # factor over F_p, then Hensel-lift the factorization to p^k
        base_factors = G.factor_squarefree_fp(G.poly_mod_q(phi_zz, self.p),
                                              self.p, seed)
        self.factors = (G.hensel_lift_factors(self.phi, base_factors, self.p, self.k)
                        if self.k > 1 else base_factors)
        self.nslots = len(self.factors)
        self.d = len(self.factors[0]) - 1
        self.canonical = self.factors[0]
        # isomorphism tables: ρ_i = image of β in ℤ/p^k[x]/f_i (a root of
        # the canonical factor mod f_i), τ_i = image of x back in the
        # canonical field (a root of f_i with τ_i(ρ_i) ≡ x mod f_i).
        self.rho = [self._lift_root(self.canonical, fi) for fi in self.factors]
        self.tau = []
        for i, fi in enumerate(self.factors):
            for t in self._all_roots(fi, self.canonical):
                img = G.poly_eval(t, self.rho[i], fi, self.q)
                if G._trim(G.poly_sub(img, [0, 1], self.q)) == []:
                    self.tau.append(t)
                    break
            else:
                raise RuntimeError("no consistent inverse isomorphism root")
        # CRT recombination: T_i = [ (Φ/f_i)^{-1} mod f_i ] · (Φ/f_i)
        self.crt_terms = []
        for fi in self.factors:
            cof = self._divexact_modq(self.phi, fi)
            inv = self._inv_mod_factor(G.poly_rem(cof, fi, self.q), fi)
            self.crt_terms.append(G.poly_rem(
                G._poly_mul_int(inv, cof), self.phi, self.q))

    # ---- root finding (brute force mod p, Hensel lift to p^k) ----
    def _roots_mod_p(self, f: List[int], mod: List[int]) -> List[List[int]]:
        """All roots of f in 𝔽p[x]/mod, by enumerating the (small) field."""
        p, d = self.p, len(mod) - 1
        roots = []
        for idx in range(p ** d):
            cand, t = [], idx
            for _ in range(d):
                cand.append(t % p)
                t //= p
            if G._trim(G.poly_eval(G.poly_mod_q(f, p), cand, G.poly_mod_q(mod, p), p)) == []:
                roots.append(cand)
        return roots

    def _lift_root(self, f: List[int], mod: List[int]) -> List[int]:
        root = self._roots_mod_p(f, mod)[0]
        return self._hensel_root(f, root, mod)

    def _all_roots(self, f: List[int], mod: List[int]) -> List[List[int]]:
        return [self._hensel_root(f, r, mod) for r in self._roots_mod_p(f, mod)]

    def _hensel_root(self, f: List[int], root: List[int], mod: List[int]) -> List[int]:
        """Newton-lift a simple root of f from mod p to mod p^k inside
        ℤ/p^k[x]/mod (the Hecke lifting role, polycrtencoding.jl:34-60)."""
        q = self.q
        fq = G.poly_mod_q(f, q)
        fprime = [(i * c) % q for i, c in enumerate(fq)][1:]
        r = list(root)
        for _ in range(max(1, self.k.bit_length() + 1)):
            val = G.poly_eval(fq, r, mod, q)
            dval = G.poly_eval(fprime, r, mod, q)
            inv = self._inv_mod_factor(dval, mod)
            r = G.poly_sub(r, G.poly_rem(G._poly_mul_int(val, inv), mod, q), q)
        assert G._trim(G.poly_eval(fq, r, mod, q)) == []
        return r

    def _inv_mod_factor(self, a: List[int], mod: List[int]) -> List[int]:
        """Inverse of a in ℤ/p^k[x]/mod via 𝔽p xgcd + Newton lifting."""
        p, q = self.p, self.q
        s, _ = G._poly_xgcd_fp(a, mod, p)
        inv = G.poly_mod_q(s, q)
        # Newton: inv <- inv·(2 − a·inv), doubling precision in p-adic digits
        for _ in range(max(1, self.k.bit_length() + 1)):
            e = G.poly_rem(G._poly_mul_int(a, inv), mod, q)
            two_minus = G.poly_sub([2], e, q)
            inv = G.poly_rem(G._poly_mul_int(inv, two_minus), mod, q)
        return inv

    # ---- encode / decode (polycrtencoding.jl:102-137) ----
    def _slot_poly(self, v: SlotValue) -> List[int]:
        if isinstance(v, (int,)):
            return [int(v) % self.q]
        return [int(x) % self.q for x in v]

    def encode(self, slots: Sequence[SlotValue]) -> List[int]:
        """Slot values (canonical-field elements) → plaintext polynomial
        coefficients mod (p^k, Φm)."""
        assert len(slots) <= self.nslots
        out = [0] * (len(self.phi) - 1)
        for i, v in enumerate(slots):
            sp = self._slot_poly(v)
            residue = G.poly_eval(sp, self.rho[i], self.factors[i], self.q)
            term = G.poly_rem(G._poly_mul_int(residue, self.crt_terms[i]),
                              self.phi, self.q)
            out = G.poly_add(out, term, self.q)
        return out

    def decode(self, coeffs: Sequence[int]) -> List[List[int]]:
        """Plaintext polynomial → slot values in the canonical field."""
        coeffs = G.poly_mod_q(list(coeffs), self.q)
        slots = []
        for i, fi in enumerate(self.factors):
            residue = G.poly_rem(coeffs, fi, self.q)
            val = G.poly_eval(residue, self.tau[i], self.canonical, self.q)
            val = val + [0] * (self.d - len(val))
            slots.append([x % self.q for x in val])
        return slots

    # ---- slot rotation (the ℤm*/⟨p⟩ Galois action on slots) ----
    #
    # σ_g: x ↦ x^g permutes the factors of Φm: the factor whose roots are
    # the coset j·⟨p⟩ maps to the one containing j·g. Integer slot values
    # are Frobenius-fixed, so σ_g acts on them as a pure permutation —
    # the general-cyclotomic analogue of the power-of-two slot rotation
    # (reference gets it from the ring-generic rotate, rlwe_she.jl:355-360
    # over nemo.jl rings; the slot-level view is new here).

    def galois_slot_permutation(self, g: int) -> List[int]:
        """π with decode(σ_g a)[i] = decode(a)[π[i]] for integer slots,
        measured by probing with distinct constants."""
        from .host_engine import galois_generic
        ring = G.GenericRing(self.m, self.q)
        vals = list(range(2, 2 + self.nslots))
        assert vals[-1] < self.q
        dec = self.decode(galois_generic(ring, self.encode(vals), g))
        perm = []
        for s in dec:
            assert all(x == 0 for x in s[1:]), \
                "σ_g does not act integrally on slots"
            perm.append(vals.index(s[0]))
        return perm

    def rotation_generator(self):
        """(g, order): a galois element whose slot action is one
        nslots-cycle, and the slot ordering in which σ_g is a cyclic
        shift: decode(σ_g a)[order[i]] = decode(a)[order[(i+1) % ns]]."""
        import math as _math
        for g in range(2, self.m):
            if _math.gcd(g, self.m) != 1:
                continue
            perm = self.galois_slot_permutation(g)
            # follow the cycle from slot 0
            order = [0]
            while len(order) < self.nslots:
                nxt = perm[order[-1]]
                if nxt in order:
                    break
                order.append(nxt)
            if len(order) == self.nslots and perm[order[-1]] == 0:
                return g, order
        raise RuntimeError("no full-cycle galois element found "
                           "(is ℤm*/⟨p⟩ cyclic?)")

    def _divexact_modq(self, a: List[int], b: List[int]) -> List[int]:
        """Exact division of polynomials over ℤ/p^k (b monic)."""
        a = [x % self.q for x in a]
        out = [0] * (len(a) - len(b) + 1)
        for i in range(len(out) - 1, -1, -1):
            c = a[i + len(b) - 1] % self.q
            out[i] = c
            for j, bj in enumerate(b):
                a[i + j] = (a[i + j] - c * bj) % self.q
        assert all(x % self.q == 0 for x in a[:len(b) - 1])
        return out
