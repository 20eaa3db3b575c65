"""toyfhe_tpu_torch DIF/DIT transforms (K5) and the fused windowed key
switch (K6) against the reference.

``PallasNttTables`` equal to the reference's arrays; K5's plain twin
bit-equal to ``ntt_pallas_bitrev`` in the Pallas interpreter; K6's plain
twin bit-equal to the reference's ``FusedKeyswitch`` in the interpreter
(the fixture of tests/test_layers.py's fused-keyswitch test) and, after the
special-prime rescale, to the port's ``_modraise_keyswitch`` at more shapes;
and, on a CUDA device, both hand-written kernels bit-equal to their twins.

The reference is imported inside the ``ref`` fixture, so the ``cuda`` tests
run on a host that has torch but no jax (``pytest --noconftest -m cuda``).
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import toyfhe_tpu_torch as T
from toyfhe_tpu_torch.ops import modmath as tmm
from toyfhe_tpu_torch.ops import ntt as tntt
from toyfhe_tpu_torch.ops import ntt_pallas as tnp
from toyfhe_tpu_torch.ops import ntt_pallas_cuda, pallas_keyswitch as tpks
from toyfhe_tpu_torch.ops import pallas_keyswitch_cuda
from toyfhe_tpu_torch.parallel import layers as TL
from toyfhe_tpu_torch.utils import interop as I
from toyfhe_tpu_torch.utils import numtheory as nt

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp

    import toyfhe_tpu as F
    return jax, jnp, F


def lrn_residues(primes, rows, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, p, (rows, n)) for p in primes]).astype(np.uint32)


# ---------------------------------------------------------------------------
# K5: the DIF transform
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, tower", [(16, (30,)), (256, (29, 28)), (1024, (28,) * 3),
                                      (8192, (28, 29))])
def test_pallas_tables_match_reference(ref, n, tower):
    from toyfhe_tpu.ops import ntt as ref_ntt
    from toyfhe_tpu.ops import ntt_pallas as ref_np
    primes = nt.ntt_prime_chain(n, tower)
    want = ref_np.PallasNttTables(ref_ntt.NttTables(n, primes))
    got = tnp.PallasNttTables(tntt.NttTables(n, primes))
    for name in ("fwd", "inv", "psi_pow", "psi_ipow", "p", "ninv", "r2"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert (got.n, got.logn, got.L) == (want.n, want.logn, want.L)


def test_k5_plain_matches_pallas_interpret(ref):
    """K5's plain twin against ``ntt_pallas_bitrev(pt, a, 8, True)`` at the
    fixture of tests/test_ntt_pallas.py (N = 256, two limbs, 8 rows), and
    the natural-order transform read through the bit reversal."""
    _, jnp, _ = ref
    from toyfhe_tpu.ops import ntt as ref_ntt
    from toyfhe_tpu.ops import ntt_pallas as ref_np
    n = 256
    primes = nt.ntt_prime_chain(n, (29, 28))
    a = lrn_residues(primes, 8, n, 0)
    want = np.asarray(ref_np.ntt_pallas_bitrev(ref_np.PallasNttTables(
        ref_ntt.NttTables(n, primes)), jnp.asarray(a), 8, True))
    tables = tntt.NttTables(n, primes)
    pt = tnp.PallasNttTables(tables)
    got = tnp.ntt_pallas_bitrev(pt, I.tensor(a, "cpu"))
    np.testing.assert_array_equal(I.to_numpy(got), want)
    nat = tntt.ntt(tables, I.tensor(a, "cpu").transpose(0, 1)).transpose(0, 1)
    assert torch.equal(got, nat[..., torch.as_tensor(tables.bitrev)])


@pytest.mark.parametrize("n, tower, rows", [(16, (30,), 1), (64, (29, 28, 28), 3),
                                            (512, (28,) * 2, 5)])
def test_dif_dit_round_trip(n, tower, rows):
    """The DIT twin inverts the DIF twin: DIT(DIF(ψ·x))·N⁻¹ψ⁻ⁱ = x."""
    pt = tnp.PallasNttTables(tntt.NttTables(n, nt.ntt_prime_chain(n, tower)))
    x = I.tensor(lrn_residues(pt.primes, rows, n, n), "cpu")
    d = pt.on("cpu")
    back = tnp.dit_stages_plain(tnp.ntt_bitrev_plain(pt, x), d["inv"], d["p"], d["rinv"])
    assert torch.equal(tmm.mont_mul_raw(back, d["psi_ipow"], d["p"], d["rinv"]), x)


def test_k5_guards():
    pt = tnp.PallasNttTables(tntt.NttTables(32, nt.ntt_prime_chain(32, (30, 29))))
    before = dict(ntt_pallas_cuda.launches)
    x = torch.zeros(2, 3, 32, dtype=torch.int64)
    with pytest.raises(ValueError):
        ntt_pallas_cuda.launch(pt, x)                      # a CPU tensor
    with pytest.raises(ValueError):
        tnp.ntt_pallas_bitrev(pt, x.to("meta"))
    with pytest.raises(ValueError):
        tnp.ntt_pallas_bitrev(pt, torch.zeros(3, 2, 32, dtype=torch.int64))
    with pytest.raises(TypeError):
        tnp.ntt_pallas_bitrev(pt, x.to(torch.int32))
    assert not tnp.ntt_pallas_bitrev(pt, x).any()
    assert ntt_pallas_cuda.launches == before


# ---------------------------------------------------------------------------
# K6: the fused windowed key switch
# ---------------------------------------------------------------------------

def test_k6_plain_matches_pallas_interpret(ref):
    """K6's plain twin against the reference's ``FusedKeyswitch`` in the
    Pallas interpreter, on the reference's keys and ciphertext at the
    fixture of tests/test_layers.py's fused-keyswitch test (N = 64,
    window 8, tower (29, 28, 28 | 29)); and the rescaled outputs equal
    both packages' ``_modraise_keyswitch``."""
    jax, jnp, F = ref
    from toyfhe_tpu.core import ring as rr
    from toyfhe_tpu.ops import pallas_keyswitch as RPKS
    from toyfhe_tpu.parallel import layers as RL
    n = 64
    tower = (29, 28, 28, 29)
    params = F.ModulusRaised(F.CKKSParams(F.make_rns_ring(n, tower), 8, 3.2))
    tparams = T.ModulusRaised(T.CKKSParams(T.make_rns_ring(n, tower), 8, 3.2))
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    kp = F.keygen(params, ks[0])
    gk = F.keygen_galois(ks[1], kp.priv, steps=1)
    c = F.encrypt(kp, F.make_plaintext(params.ring_cipher, np.linspace(0.5, 2.0, n // 2),
                                       Fraction(2) ** 27), ks[2])
    ka = RL.build_modraise_key_arrays(params, gk.key)
    ct_ring = ka.ct_ring
    g = F.apply_galois_ct(c, gk.galois_element)
    c1p, c2p = (np.asarray(rr.ensure_primal(ct_ring, x).primal) for x in g.cs)
    fk = RPKS.FusedKeyswitch(ka.exp_ring.tables, np.asarray(ka.masks), np.asarray(ka.maskeds),
                             ka.window, ka.k_per_limb, ct_ring.nlimbs)
    from toyfhe_tpu.ops import modmath as ref_mm
    from toyfhe_tpu.ops import ntt as ref_ntt
    from toyfhe_tpu.parallel.ops import _mp_full
    c1d = np.asarray(ref_ntt.ntt(ct_ring.tables, ref_mm.mul_mod(
        jnp.asarray(c1p), ka.ps_res, _mp_full(ka.tabs_ct))))
    c1e = np.concatenate([c1d, np.zeros((1, n), np.uint32)], 0)[:, fk.brev]
    want = fk(jnp.asarray(c2p), jnp.asarray(c1e), interpret=True)

    kr = params.ring_key
    dual = lambda x: np.asarray(rr.ensure_dual(kr, x).dual)
    tgk = I.galois_key(tparams, gk.galois_element, [dual(k.mask) for k in gk.key.key],
                       [dual(k.masked) for k in gk.key.key], device="cpu")
    tka = TL.build_modraise_key_arrays(tparams, tgk.key)
    tfk = TL.build_fused_keyswitch(tka)
    np.testing.assert_array_equal(I.to_numpy(tfk.masks), np.asarray(fk.masks))
    np.testing.assert_array_equal(tfk._pn, fk._pn)
    got = tfk(I.tensor(c2p, "cpu"), I.tensor(c1e, "cpu"))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(I.to_numpy(a), np.asarray(b))
    ks_got = TL._modraise_keyswitch_fused(tka, tfk, I.tensor(c1p, "cpu"), I.tensor(c2p, "cpu"))
    ks_want = RL._modraise_keyswitch(ka, jnp.asarray(c1p), jnp.asarray(c2p))
    for a, b in zip(ks_got, ks_want):
        np.testing.assert_array_equal(I.to_numpy(a), np.asarray(b))


K6_CASES = [  # (N, tower incl. special, window, lead)
    (32, (30, 29, 28, 29), 8, ()),
    (64, (28,) * 5 + (29,), 8, (2,)),
    (128, (29, 28, 30), 5, ()),
    (32, (28, 28, 29), 3, (2, 3)),
]


@pytest.mark.parametrize("n, tower, window, lead", K6_CASES)
def test_k6_plain_matches_modraise_keyswitch(n, tower, window, lead):
    """K6's plain twin + the special-prime rescale equals the port's
    ``_modraise_keyswitch`` on port-made Galois keys, at both levels."""
    tparams = T.ModulusRaised(T.CKKSParams(T.make_rns_ring(n, tower), window, 3.2))
    gen = torch.Generator().manual_seed(n + window)
    kp = T.keygen(tparams, gen)
    gk = T.keygen_galois(gen, kp.priv, steps=1)
    full = tparams.ring_cipher
    for lc in (full.nlimbs, full.nlimbs - 1):
        ring = full.select(range(lc))
        ka = TL.build_modraise_key_arrays(tparams, gk.key, ring)
        fk = TL.build_fused_keyswitch(ka)
        rng = np.random.default_rng(lc)
        c1p, c2p = (I.tensor(np.stack([rng.integers(0, p, lead + (n,)) for p in ring.primes],
                                      axis=-2), "cpu") for _ in range(2))
        got = TL._modraise_keyswitch_fused(ka, fk, c1p, c2p)
        want = TL._modraise_keyswitch(ka, c1p, c2p)
        assert got[0].shape == lead + (lc, n)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_make_eval_key_with_key_params(ref, monkeypatch):
    """``make_eval_key(gen, old, new, key_params=...)`` for a parameter pair
    whose windows differ (the secret under window 0, the key under window
    8): the key carries ``key_params``, has its number of components and is
    built on its gadget factors, while the key ring, the ps-lift of the old
    key and the noise stay those of ``new.params`` -- as in the reference.
    With the masks and the noise forced to shared tensors every component is
    bit-equal to the reference's."""
    jax, jnp, F = ref
    from toyfhe_tpu.core import ring as rr
    from toyfhe_tpu.core import rlwe as ref_rlwe
    from toyfhe_tpu_torch.core import rlwe as trlwe
    n, tower = 32, (29, 28, 28, 29)
    made = {}
    for pkg in (F, T):
        ring = pkg.make_rns_ring(n, tower)
        made[pkg] = (pkg.ModulusRaised(pkg.CKKSParams(ring, 0, 3.2)),
                     pkg.ModulusRaised(pkg.CKKSParams(ring, 8, 3.2)))
    (params, kparams), (tparams, tkparams) = made[F], made[T]
    assert params.relin_window != kparams.relin_window
    kp = F.keygen(params, jax.random.PRNGKey(4))
    secret = np.asarray(rr.ensure_primal(params.ring_key, kp.priv.secret).primal)
    tpriv = I.priv_key(tparams, secret, device="cpu")

    primes = params.ring_key.primes
    ncomp = len(ref_rlwe.gadget_factors(kparams.ring_cipher, 8))
    rng = np.random.default_rng(5)
    masks = [np.stack([rng.integers(0, p, n) for p in primes]) for _ in range(ncomp)]
    noises = [np.stack([e % p for p in primes]) for e in rng.integers(-8, 9, (ncomp, n))]
    feeds = {name: iter(vals) for name, vals in (("rm", masks), ("tm", masks), ("rn", noises),
                                                 ("tn", noises))}
    monkeypatch.setattr(ref_rlwe.sampling, "uniform",
                        lambda *a, **k: jnp.asarray(next(feeds["rm"]).astype(np.uint32)))
    monkeypatch.setattr(trlwe.sampling, "uniform", lambda *a, **k: I.tensor(next(feeds["tm"]), "cpu"))
    monkeypatch.setattr(params, "noise", lambda *a, **k: F.RingElt(
        primal=jnp.asarray(next(feeds["rn"]).astype(np.uint32))), raising=False)
    monkeypatch.setattr(tparams, "noise", lambda *a, **k: T.RingElt(
        primal=I.tensor(next(feeds["tn"]), "cpu")), raising=False)

    want = F.make_eval_key(jax.random.PRNGKey(6), kp.priv.secret, kp.priv, key_params=kparams)
    got = T.make_eval_key(torch.Generator().manual_seed(6), tpriv.secret, tpriv,
                          key_params=tkparams)
    assert want.params is kparams and got.params is tkparams
    assert got.ring is tparams.ring_key and got.ring.primes == want.ring.primes
    assert len(got.key) == len(want.key) == ncomp == 3 * 4      # Lc limbs x ceil(29 / 8) digits
    assert trlwe.gadget_factors(tkparams.ring_cipher, tkparams.relin_window) == \
        ref_rlwe.gadget_factors(kparams.ring_cipher, kparams.relin_window)
    for a, b in zip(got.key, want.key):
        for name in ("mask", "masked"):
            np.testing.assert_array_equal(
                I.to_numpy(T.ringops.ensure_primal(got.ring, getattr(a, name)).primal),
                np.asarray(rr.ensure_primal(want.ring, getattr(b, name)).primal))
    # without key_params the key follows new.params: one component a limb
    monkeypatch.undo()
    own = T.make_eval_key(torch.Generator().manual_seed(6), tpriv.secret, tpriv)
    assert own.params is tparams and len(own.key) == 3


def test_k6_guards():
    tparams = T.ModulusRaised(T.CKKSParams(T.make_rns_ring(32, (30, 29, 29)), 8, 3.2))
    gen = torch.Generator().manual_seed(0)
    gk = T.keygen_galois(gen, T.keygen(tparams, gen).priv, steps=1)
    ka = TL.build_modraise_key_arrays(tparams, gk.key)
    with pytest.raises(AssertionError):
        tpks.FusedKeyswitch(ka.exp_ring.tables, ka.masks, ka.maskeds, 0, 1, 2)
    with pytest.raises(ValueError):
        tpks.FusedKeyswitch(ka.exp_ring.tables, ka.masks[:-1], ka.maskeds, 8, 4, 2)
    fk = TL.build_fused_keyswitch(ka)
    c2 = torch.zeros(2, 32, dtype=torch.int64)
    c1e = torch.zeros(3, 32, dtype=torch.int64)
    before = dict(pallas_keyswitch_cuda.launches)
    with pytest.raises(ValueError):
        pallas_keyswitch_cuda.launch(fk, c2, c1e)          # CPU tensors
    with pytest.raises(ValueError):
        fk(c2.to("meta"), c1e.to("meta"))
    with pytest.raises(ValueError):
        fk(c2, c1e[:2])
    with pytest.raises(TypeError):
        fk(c2.to(torch.int32), c1e)
    out1, out2 = fk(c2, c1e)
    assert out1.shape == (3, 32) and not out1.any() and not out2.any()
    assert pallas_keyswitch_cuda.launches == before


# ---------------------------------------------------------------------------
# the kernels on a CUDA device
# ---------------------------------------------------------------------------

def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n, tower, rows", [(256, (29, 28), 8), (8192, (28,) * 7, 4),
                                            (16384, (28,) * 8, 1)])
def test_cuda_k5_matches_plain(n, tower, rows):
    dev = cuda_device()
    pt = tnp.PallasNttTables(tntt.NttTables(n, nt.ntt_prime_chain(n, tower)))
    a = I.tensor(lrn_residues(pt.primes, rows, n, rows), dev)
    before = ntt_pallas_cuda.launches["k5"]
    got = tnp.ntt_pallas_bitrev(pt, a)
    torch.cuda.synchronize()
    assert ntt_pallas_cuda.launches["k5"] == before + 1
    assert torch.equal(got, tnp.ntt_bitrev_plain(pt, a))


@pytest.mark.cuda
@pytest.mark.parametrize("n, tower, window, lead", K6_CASES + [(8192, (28,) * 7 + (29,), 8, ()),
                                                               (32768, (28, 28, 29), 8, ())])
def test_cuda_k6_matches_plain(n, tower, window, lead):
    dev = cuda_device()
    tparams = T.ModulusRaised(T.CKKSParams(T.make_rns_ring(n, tower), window, 3.2))
    ring = tparams.ring_cipher
    gen = torch.Generator(device=dev).manual_seed(1)
    gk = T.keygen_galois(gen, T.keygen(tparams, gen).priv, steps=1)
    ka = TL.build_modraise_key_arrays(tparams, gk.key)
    fk = TL.build_fused_keyswitch(ka)
    rng = np.random.default_rng(2)
    c2 = I.tensor(np.stack([rng.integers(0, p, lead + (n,)) for p in ring.primes], -2), dev)
    c1e = I.tensor(np.stack([rng.integers(0, p, lead + (n,)) for p in ka.exp_ring.primes], -2),
                   dev)
    before = pallas_keyswitch_cuda.launches["k6"]
    got = fk(c2, c1e)
    torch.cuda.synchronize()
    assert pallas_keyswitch_cuda.launches["k6"] == before + 1
    want = tpks.fused_keyswitch_plain(fk, c2, c1e)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(TL._modraise_keyswitch_fused(ka, fk, c2[..., :, :], c2)[0],
                       TL._modraise_keyswitch(ka, c2, c2)[0])
