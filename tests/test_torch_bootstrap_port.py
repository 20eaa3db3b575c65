"""The port's refresh alone, at the reference's own bounds.

The reference's slow bootstrap tests (tests/test_bootstrap.py) at their
sizes, on the port with keys from its own generator: the dense refresh on a
deep windowed tower, the factored refresh under the special-prime and the
hybrid gadgets with the arcsine and double-angle EvalMod, N = 128 with two
butterfly levels a phase, the composite-scale refresh at N = 64 (≥ 15 limbs
out at error < 1e-4), the batched refresh, Paterson–Stockmeyer at degree 46
and Horner. And a warm refresh encodes nothing on the host.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import toyfhe_tpu_torch as T
from toyfhe_tpu_torch.core import bootstrap as TB
from toyfhe_tpu_torch.core import ckks_encoding as TCE
from toyfhe_tpu_torch.utils import numtheory as nt

torch.set_num_threads(1)


def _vals(h, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, h) + 1j * rng.uniform(-1, 1, h)) * 0.7


def _exhausted(params, kp, vals, scale, gen, limbs=1):
    c = T.encrypt(kp, T.make_plaintext(params.ring_cipher, vals, scale), gen)
    return TCE.ct_drop_to(c, limbs)


def _sparse(ring, h=4):
    return T.CKKSParams(ring, 0, 3.2, secret="sparse", hamming_weight=h)


@pytest.fixture(scope="module")
def deep():
    ring = T.make_rns_ring(32, (30,) * 17)
    params = T.CKKSParams(ring, 4, 3.2, secret="sparse", hamming_weight=4)
    gen = torch.Generator().manual_seed(5)
    kp = T.keygen(params, gen)
    return params, kp, TB.setup_bootstrap(gen, kp.priv, K=5.0, deg=46), gen


def test_sparse_ternary_secret(deep):
    params, kp, _, _ = deep
    ring = params.ring_cipher
    prim = T.ringops.ensure_primal(ring, kp.priv.secret).primal.numpy()
    vals = np.array([nt.centered(x, ring.modulus) for x in ring.to_bigint(prim)])
    assert np.count_nonzero(vals) == 4 and set(np.unique(vals)) <= {-1, 0, 1}


def test_full_bootstrap_dense(deep):
    params, kp, ctx, gen = deep
    vals = _vals(16, 3)
    out = TB.bootstrap(ctx, _exhausted(params, kp, vals, Fraction(2) ** 23, gen))
    assert out.ring.nlimbs >= 5
    np.testing.assert_allclose(T.decrypt(kp, out), vals, atol=3e-2)


def test_eval_chebyshev_degree_46(deep):
    params, kp, ctx, gen = deep
    xs = np.random.default_rng(11).uniform(-4.5, 4.5, 16)
    c = T.encrypt(kp, T.make_plaintext(params.ring_cipher, xs + 0j, Fraction(2) ** 30), gen)
    out = TB.eval_chebyshev(ctx.ek, c, ctx.cheb, ctx.K)
    expect = np.polynomial.chebyshev.chebval(xs / ctx.K, ctx.cheb)
    np.testing.assert_allclose(T.decrypt(kp, out).real, expect, atol=1e-4)
    assert out.ring.nlimbs >= 9


def test_eval_poly_horner():
    ring = T.make_rns_ring(32, (30, 26, 26, 26, 26, 26))
    params = T.CKKSParams(ring, 4, 3.2)
    gen = torch.Generator().manual_seed(9)
    kp = T.keygen(params, gen)
    ek = T.keygen_eval_mult(gen, kp.priv)
    xs = np.random.default_rng(3).uniform(-1, 1, 16)
    c = T.encrypt(kp, T.make_plaintext(ring, xs, Fraction(2) ** 26), gen)
    got = T.decrypt(kp, TB.eval_poly(ek, c, [0.0, 1.0, 0.0, -1 / 6, 0.0, 1 / 120])).real
    np.testing.assert_allclose(got, xs - xs ** 3 / 6 + xs ** 5 / 120, atol=2e-3)


@pytest.fixture(scope="module")
def deep_mr():
    ring = T.make_rns_ring(32, (30,) * 21)
    params = T.ModulusRaised(_sparse(ring))
    gen = torch.Generator().manual_seed(5)
    kp = T.keygen(params, gen)
    ctx = TB.setup_bootstrap(gen, kp.priv, K=5.0, deg=46, radix=16, arcsin=True)
    return params, kp, ctx, gen


@pytest.mark.parametrize("deg,double_angle", [(46, 0), (24, 2)])
def test_factored_bootstrap_modraise(deep_mr, deg, double_angle):
    params, kp, ctx0, gen = deep_mr
    assert len(ctx0.gks.keys) <= 8
    ctx = TB.BootstrapContext(ek=ctx0.ek, gks=ctx0.gks, gk_conj=ctx0.gk_conj, K=5.0,
                              deg=deg, plan=ctx0.plan, arcsin=True, double_angle=double_angle)
    vals = _vals(16, 3)
    out = TB.bootstrap(ctx, _exhausted(params, kp, vals, Fraction(2) ** 27, gen))
    assert out.ring.nlimbs >= 6
    np.testing.assert_allclose(T.decrypt(kp, out), vals, atol=5e-4)


def test_batched_bootstrap(deep_mr):
    params, kp, ctx0, gen = deep_mr
    ctx = TB.BootstrapContext(ek=ctx0.ek, gks=ctx0.gks, gk_conj=ctx0.gk_conj, K=5.0, deg=24,
                              plan=ctx0.plan, arcsin=True, double_angle=2)
    vals = [_vals(16, 11 + i) for i in range(2)]
    cts = [_exhausted(params, kp, v, Fraction(2) ** 27, gen) for v in vals]
    out = TB.bootstrap_batched(ctx, T.ct_stack(cts))
    assert out.ring.nlimbs >= 6
    for i in range(2):
        got = T.ct_index(out, i)
        np.testing.assert_allclose(T.decrypt(kp, got), vals[i], atol=5e-4)
        single = TB.bootstrap(ctx, cts[i])
        for a, b in zip(got.cs, single.cs):
            assert torch.equal(T.ringops.ensure_dual(out.ring, a).dual,
                               T.ringops.ensure_dual(out.ring, b).dual)


def test_hybrid_bootstrap():
    ring = T.make_rns_ring(32, (30,) * 25)
    params = T.HybridRaised(_sparse(ring), 5, 5)
    gen = torch.Generator().manual_seed(5)
    kp = T.keygen(params, gen)
    ctx = TB.setup_bootstrap(gen, kp.priv, K=5.0, deg=24, radix=16, arcsin=True, double_angle=2)
    vals = _vals(16, 3)
    out = TB.bootstrap(ctx, _exhausted(params, kp, vals, Fraction(2) ** 27, gen))
    assert out.ring.nlimbs >= 6
    np.testing.assert_allclose(T.decrypt(kp, out), vals, atol=5e-4)


def test_bootstrap_n128():
    ring = T.make_rns_ring(128, (30,) * 23)
    params = T.ModulusRaised(_sparse(ring, 8))
    gen = torch.Generator().manual_seed(13)
    kp = T.keygen(params, gen)
    ctx = TB.setup_bootstrap(gen, kp.priv, K=6.0, deg=30, radix=16, arcsin=True, double_angle=2)
    assert ctx.plan.nlevels == 2
    vals = _vals(64, 3)
    out = TB.bootstrap(ctx, _exhausted(params, kp, vals, Fraction(2) ** 27, gen))
    assert out.ring.nlimbs >= 5
    np.testing.assert_allclose(T.decrypt(kp, out), vals, atol=2e-3)


def test_composite_scale_bootstrap(monkeypatch):
    """scale_limbs = 2 at N = 64: 2 × 29-bit base, 46 26-bit level limbs,
    29-bit raising primes under the hybrid gadget; the FBC ModRaise, the
    pinned level scales and the two-limb rescales end to end. A second
    refresh encodes nothing and gives the same ciphertext."""
    L, dnum = 46, 10
    k = -(-L // dnum) + 1
    ring = T.make_rns_ring(64, (29, 29) + (26,) * L + (29,) * k)
    params = T.HybridRaised(_sparse(ring), dnum, k)
    gen = torch.Generator().manual_seed(5)
    kp = T.keygen(params, gen)
    ctx = TB.setup_bootstrap(gen, kp.priv, K=5.0, deg=24, radix=16, arcsin=True,
                             double_angle=2, scale_limbs=2)
    vals = _vals(32, 3)
    c = _exhausted(params, kp, vals, Fraction(2) ** 52, gen, limbs=2)
    out = TB.bootstrap(ctx, c)
    assert out.ring.nlimbs >= 15
    np.testing.assert_allclose(T.decrypt(kp, out), vals, atol=1e-4)
    calls = []
    real = TCE.ckks_encode
    monkeypatch.setattr(TCE, "ckks_encode", lambda *a: calls.append(1) or real(*a))
    again = TB.bootstrap(ctx, c)
    assert not calls
    for a, b in zip(out.cs, again.cs):
        assert torch.equal(T.ringops.ensure_dual(out.ring, a).dual,
                           T.ringops.ensure_dual(out.ring, b).dual)


def test_to_device_copies():
    """``interop.to_device`` copies keys, ciphertexts and contexts (here to
    the CPU itself): equal tensors, a fresh encode store."""
    from toyfhe_tpu_torch.utils import interop as I

    ring = T.make_rns_ring(32, (30,) * 12)
    params = T.HybridRaised(_sparse(ring), 4, 4)
    gen = torch.Generator().manual_seed(2)
    kp = T.keygen(params, gen)
    ctx = TB.setup_bootstrap(gen, kp.priv, K=5.0, deg=8, radix=16)
    ctx.plain_cache["x"] = 1
    c = _exhausted(params, kp, _vals(16, 1), Fraction(2) ** 27, gen)
    ctx2, c2, kp2 = (I.to_device(x, "cpu") for x in (ctx, c, kp))
    assert ctx2.plain_cache == {} and ctx2.plan is ctx.plan and ctx2.deg == ctx.deg
    assert torch.equal(ctx2.gks.keys[3].key.key[1].mask.primal, ctx.gks.keys[3].key.key[1].mask.primal)
    assert torch.equal(c2.cs[1].dual, c.cs[1].dual) and c2.enc == c.enc
    assert torch.equal(kp2.priv.secret.primal, kp.priv.secret.primal)
    with pytest.raises(TypeError):
        I.to_device(object(), "cpu")


@pytest.mark.cuda
def test_cuda_refresh_equals_cpu():
    """The composite-scale refresh (N = 64, 2 + 46 + 6 limbs) on the card,
    every transform a K1 launch, bit-equal to the same refresh on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from toyfhe_tpu_torch.ops import ntt_cuda
    from toyfhe_tpu_torch.utils import interop as I

    L, dnum = 46, 10
    k = -(-L // dnum) + 1
    ring = T.make_rns_ring(64, (29, 29) + (26,) * L + (29,) * k)
    params = T.HybridRaised(_sparse(ring), dnum, k)
    gen = torch.Generator().manual_seed(5)
    kp = T.keygen(params, gen)
    ctx = TB.setup_bootstrap(gen, kp.priv, K=5.0, deg=24, radix=16, arcsin=True,
                             double_angle=2, scale_limbs=2)
    vals = _vals(32, 3)
    c = _exhausted(params, kp, vals, Fraction(2) ** 52, gen, limbs=2)
    want = TB.bootstrap(ctx, c)
    dev = torch.device("cuda", 0)
    before = dict(ntt_cuda.launches)
    got = TB.bootstrap(I.to_device(ctx, dev), I.to_device(c, dev))
    torch.cuda.synchronize()
    assert ntt_cuda.launches["fwd"] > before["fwd"] and ntt_cuda.launches["inv"] > before["inv"]
    assert got.ring is want.ring and got.enc == want.enc
    for a, b in zip(got.cs, want.cs):
        assert torch.equal(T.ringops.ensure_dual(got.ring, a).dual.cpu(),
                           T.ringops.ensure_dual(want.ring, b).dual)
    np.testing.assert_allclose(T.decrypt(kp, want), vals, atol=1e-4)


@pytest.mark.parametrize("argv,limbs", [(["5", "16", "4", "0", "1", "1.5", "1"], 5),
                                        (["5", "4", "4", "4", "2", "1.5", "2"], 13)])
def test_bench_bootstrap_tool(capsys, argv, limbs):
    """``tools.bench_bootstrap`` at the reference bench's recipes, cut to
    N = 32 on the CPU: its JSON line reports the refresh it ran."""
    import json

    from toyfhe_tpu_torch.tools import bench_bootstrap

    assert bench_bootstrap.main(argv + ["--device", "cpu", "--reps", "1"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["batch"] == int(argv[4]) and rec["deg"] == int(2 * np.pi * 4.0) + 22
    assert rec["limbs_out"] >= limbs and rec["max_abs_err"] < 5e-3
    assert set(rec["phases_ms"]) == {"modraise_c2s", "evalmod", "s2c"}
