"""toyfhe_tpu_torch's compiled front-end (``utils.graphs.jit``) against the
reference's ``jax.jit``, on the CPU.

Mirrors tests/test_jit_api.py (N=64, tower (30, 29, 29), keys from
PRNGKey(11)): square → relinearize → rescale, rotate and encrypt, each
through the reference's ``jax.jit`` and the port's ``graphs.jit`` on the
same shared tensors (the reference's keys and ciphertext carried across,
the encryption's u, e₁, e₂ from a numpy seed), bit-equal duals. Then the
pytree registration of every engine type (leaves exactly the tensors,
metadata carried), and capture-readiness: after one warm-up call, a
second call of every compiled path — (a) the single-device step, (b) the
hybrid steps, (c) the layers, (d) both MNIST serving schedules, (e) the
refresh and the bootstrapped pipeline — builds no tensor from host data and
reads none back, which is what a CUDA graph capture needs. On the CPU
``graphs.jit`` runs its function eagerly; the ``cuda`` tests hold replays
against eager calls on the card and skip here. The reference is imported
inside the ``ref`` fixture, so that the ``cuda`` tests run on a machine
without jax.
"""

import collections
import contextlib
import functools
import traceback
from fractions import Fraction

import types

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import toyfhe_tpu_torch as T
from toyfhe_tpu_torch.core import bootstrap as TB
from toyfhe_tpu_torch.core import ckks_encoding as TCE
from toyfhe_tpu_torch.core import rlwe as trlwe
from toyfhe_tpu_torch.models import mnist as TM
from toyfhe_tpu_torch.ops import modmath
from toyfhe_tpu_torch.parallel import layers as TL
from toyfhe_tpu_torch.parallel import ops as pops
from toyfhe_tpu_torch.utils import graphs
from toyfhe_tpu_torch.utils import interop as I

from .test_torch_hybrid import hybrid_params, synthetic_keys

torch.set_num_threads(1)

N = 64
SCALE = Fraction(2) ** 40


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp

    import toyfhe_tpu as F
    from toyfhe_tpu.core import ring as ringops
    return types.SimpleNamespace(jax=jax, jnp=jnp, F=F, ringops=ringops)


@pytest.fixture(scope="module")
def setup(ref):
    """tests/test_jit_api.py's fixture, and the port's copy of it."""
    jax, F, ringops = ref.jax, ref.F, ref.ringops
    ring = F.make_rns_ring(N, (30, 29, 29))
    params = F.CKKSParams(ring, 0, 3.2)
    ks = jax.random.split(jax.random.PRNGKey(11), 4)
    kp = F.keygen(params, ks[0])
    ek = F.keygen_eval_mult(ks[1], kp.priv)
    gk = F.keygen_galois(ks[2], kp.priv, steps=1)
    vals = np.linspace(0.1, 1.0, N // 2)
    c = F.encrypt(kp, F.make_plaintext(ring, vals, SCALE), ks[3])

    tring = T.make_rns_ring(N, (30, 29, 29))
    tparams = T.CKKSParams(tring, 0, 3.2)
    prim = lambda x: np.asarray(ringops.ensure_primal(ring, x).primal)
    dual = lambda r, x: np.asarray(ringops.ensure_dual(r, x).dual)
    stacks = lambda k: ([dual(k.key.ring, c_.mask) for c_ in k.key.key],
                        [dual(k.key.ring, c_.masked) for c_ in k.key.key])
    tkp = T.KeyPair(I.priv_key(tparams, prim(kp.priv.secret), device="cpu"),
                    I.pub_key(tparams, prim(kp.pub.key.mask), prim(kp.pub.key.masked),
                              device="cpu"))
    tek = I.eval_mult_key(tparams, *stacks(ek), device="cpu")
    tgk = I.galois_key(tparams, gk.galois_element, *stacks(gk), device="cpu")
    tc = I.ciphertext(tparams, tring, [dual(ring, x) for x in c.cs], SCALE, device="cpu")
    return dict(ring=ring, params=params, kp=kp, ek=ek, gk=gk, c=c, vals=vals, tring=tring,
                tparams=tparams, tkp=tkp, tek=tek, tgk=tgk, tc=tc)


def _assert_same(ref, want, got):
    assert got.ring.primes == list(want.ring.primes) and got.enc.scale == want.enc.scale
    for x, y in zip(want.cs, got.cs):
        np.testing.assert_array_equal(I.elt_to_numpy(got.ring, y),
                                      np.asarray(ref.ringops.ensure_dual(want.ring, x).dual))


def test_jit_square_relin_rescale(ref, setup):
    """tests/test_jit_api.py:38 — the compiled pipeline of both packages,
    bit-equal, decrypting to the squares."""
    F = ref.F
    want = ref.jax.jit(lambda ek, c: F.ct_rescale(F.keyswitch(ek, F.ct_mul(c, c))))(
        setup["ek"], setup["c"])
    step = graphs.jit(lambda ek, c: T.ct_rescale(T.keyswitch(ek, T.ct_mul(c, c))))
    got = step(setup["tek"], setup["tc"])
    _assert_same(ref, want, got)
    np.testing.assert_allclose(T.decrypt(setup["tkp"], got).real, setup["vals"] ** 2, atol=2e-4)


def test_jit_rotate(ref, setup):
    """tests/test_jit_api.py:53."""
    want = ref.jax.jit(ref.F.rotate)(setup["gk"], setup["c"])
    _assert_same(ref, want, graphs.jit(T.rotate)(setup["tgk"], setup["tc"]))


def test_jit_encrypt(ref, setup):
    """tests/test_jit_api.py:61 — encrypt compiled over the public key with
    the plaintext closed over, its u, e₁, e₂ shared from a numpy seed."""
    jax, F = ref.jax, ref.F
    rng = np.random.default_rng(61)
    u, e1, e2 = (np.rint(rng.normal(0, 3.2, N)).astype(np.int64) for _ in range(3))
    ring, params = setup["ring"], setup["params"]
    embed = lambda x, r: ref.jnp.asarray(
        np.stack([np.mod(x, p) for p in r.primes]).astype(np.uint32))

    def ref_encrypt(pub):
        queue = [e1, e2]
        params.secret_sampler = lambda key, r, batch=(): F.RingElt(primal=embed(u, r))
        params.noise = lambda key, r, batch=(): F.RingElt(primal=embed(queue.pop(0), r))
        try:
            return F.encrypt(pub, F.make_plaintext(ring, setup["vals"], SCALE),
                             jax.random.PRNGKey(5))
        finally:
            del params.secret_sampler, params.noise

    want = jax.jit(ref_encrypt)(setup["kp"].pub)
    pt = T.make_plaintext(setup["tring"], setup["vals"], SCALE)
    got = graphs.jit(lambda pub: I.encrypt_with_noise(pub, pt, u, e1, e2, device="cpu"))(
        setup["tkp"].pub)
    _assert_same(ref, want, got)


# ---------------------------------------------------------------------------
# the pytrees
# ---------------------------------------------------------------------------

def _elt(x):
    return [t for t in (x.primal, x.dual) if t is not None]


def _comp(k):
    return _elt(k.mask) + _elt(k.masked)


@pytest.fixture(scope="module")
def trees(setup):
    """One object of every registered type, with its tensors in the
    reference's leaf order and its static metadata."""
    tkp, tek, tgk, tc = setup["tkp"], setup["tek"], setup["tgk"], setup["tc"]
    gen = torch.Generator().manual_seed(32)
    ring = T.make_rns_ring(32, (30, 29, 29))
    kp32 = T.keygen(T.CKKSParams(ring, 0, 3.2), gen)
    ctx = TB.setup_bootstrap(gen, kp32.priv, K=3.0, deg=8)
    ctx.plain_cache["probe"] = 1
    primal_only = T.RingElt(primal=tc.cs[0].dual.clone())
    gks = T.GaloisKeys([tgk])
    keys = lambda k: [t for c in k.key for t in _comp(c)]
    return {
        "RingElt": (tc.cs[0], _elt(tc.cs[0]), {}),
        "RingElt_primal_only": (primal_only, _elt(primal_only), {}),
        "PrivKey": (tkp.priv, _elt(tkp.priv.secret), {"params": tkp.priv.params}),
        "KeyComponent": (tkp.pub.key, _comp(tkp.pub.key), {}),
        "PubKey": (tkp.pub, _comp(tkp.pub.key), {"params": tkp.pub.params}),
        "KeySwitchKey": (tek.key, keys(tek.key), {"params": tek.key.params, "ring": tek.key.ring}),
        "EvalMultKey": (tek, keys(tek.key), {}),
        "GaloisKey": (tgk, keys(tgk.key), {"galois_element": tgk.galois_element}),
        "GaloisKeys": (gks, keys(tgk.key), {}),
        "KeyPair": (tkp, _elt(tkp.priv.secret) + _comp(tkp.pub.key), {}),
        "CipherText": (tc, [t for x in tc.cs for t in _elt(x)],
                       {"params": tc.params, "ring": tc.ring, "enc": tc.enc}),
        "BootstrapContext": (ctx, keys(ctx.ek.key) + [t for k in ctx.gks.keys for t in keys(k.key)]
                             + keys(ctx.gk_conj.key),
                             {"K": 3.0, "deg": 8, "plan": ctx.plan, "arcsin": False,
                              "double_angle": 0, "scale_limbs": 1, "base_scale": None,
                              "plain_cache": ctx.plain_cache}),
    }


TREE_NAMES = ("RingElt", "RingElt_primal_only", "PrivKey", "KeyComponent", "PubKey",
              "KeySwitchKey", "EvalMultKey", "GaloisKey", "GaloisKeys", "KeyPair", "CipherText",
              "BootstrapContext")


@pytest.mark.parametrize("name", TREE_NAMES)
def test_pytree_round_trip(trees, name):
    obj, tensors, static = trees[name]
    leaves, spec = pytree.tree_flatten(obj)
    assert len(leaves) == len(tensors) and all(a is b for a, b in zip(leaves, tensors))
    back = pytree.tree_unflatten(leaves, spec)
    assert type(back) is type(obj) and back is not obj
    assert all(a is b for a, b in zip(pytree.tree_leaves(back), tensors))
    for field, want in static.items():
        got = getattr(back, field)
        assert got is want if not isinstance(want, (int, float, Fraction)) else got == want
    if isinstance(obj, T.RingElt):
        assert (back.primal is None) == (obj.primal is None)
        assert (back.dual is None) == (obj.dual is None)
    # equal metadata gives equal tree structures: one graph per structure
    assert pytree.tree_flatten(back)[1] == spec


# ---------------------------------------------------------------------------
# capture-readiness: no upload and no read-back on a second call
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def host_traffic():
    """Count, by call site in the port, every tensor built from host data
    (the port's upload helper ``modmath.as_residues`` and ``torch.tensor`` /
    ``as_tensor`` / ``from_numpy``) and every read back (``Tensor.cpu``,
    ``item``, ``tolist``, ``numpy`` and the conversions to a Python bool,
    int or float)."""
    hits = collections.Counter()
    saved = []

    def patch(owner, name):
        orig = getattr(owner, name)

        @functools.wraps(orig)
        def counted(*a, **k):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if "toyfhe_tpu_torch" in f.filename]
            if frames:
                hits[(name, frames[-1].filename.rsplit("toyfhe_tpu_torch", 1)[-1],
                      frames[-1].lineno)] += 1
            return orig(*a, **k)

        saved.append((owner, name, orig))
        setattr(owner, name, counted)

    for name in ("tensor", "as_tensor", "from_numpy"):
        patch(torch, name)
    patch(modmath, "as_residues")
    for name in ("cpu", "item", "tolist", "numpy", "__bool__", "__int__", "__float__"):
        patch(torch.Tensor, name)
    try:
        yield hits
    finally:
        for owner, name, orig in reversed(saved):
            setattr(owner, name, orig)


def _second_call_traffic(fn):
    """Both calls run as a warm-up and a capture run them (``graphs.trace``)."""
    with graphs.trace():
        fn()
        with host_traffic() as hits:
            fn()
    return dict(hits)


def _uniform(primes, lead, n, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(np.stack([rng.integers(0, p, tuple(lead) + (n,)) for p in primes],
                                    -2))


def _path_step():
    ring = T.make_rns_ring(N, (30, 29, 29, 28))
    km, kd = (_uniform(ring.primes, (ring.nlimbs,), N, s) for s in (1, 2))
    x = _uniform(ring.primes, (2, 2), N, 3)
    step = pops.make_single_chip_step(ring.tables, km, kd)
    return {"a_single_chip_step": lambda: step(x)}


def _path_hybrid():
    _, params = hybrid_params(T, N, 6, 2, 3)
    ek = I.eval_mult_key(params, *synthetic_keys(params, 3), device="cpu")
    x = _uniform(params.ring_cipher.primes, (2, 2), N, 4)
    out = {}
    for name, kw in (("v1", {}), ("fused_k3", dict(fused=True)),
                     ("fused_schedule", dict(fused_schedule=True))):
        step = pops.make_hybrid_sharded_step(None, params, ek, **kw)[0]
        out[f"b_{name}"] = functools.partial(step, x)
    return out


MNIST_TINY = dict(image=8, kernel=4, stride=4, channels=2, classes=4, ring_logn=6)
MNIST_SMALL = dict(image=14, kernel=5, stride=3, channels=2, classes=4, ring_logn=9,
                   limb_bits=(30, 30, 28, 28, 28, 28, 28) + (30,) * 3, scale_log2=28,
                   gadget="hybrid", dnum=3, num_special=3)


def _path_layers():
    cfg = TM.MNISTConfig(**MNIST_TINY)
    gen = torch.Generator().manual_seed(5)
    setup = TM.fhe_setup(cfg, gen)
    sp = setup.params
    r0 = sp.ring_cipher
    r1 = r0.drop_last()
    r2 = r1.drop_last()
    pts = _uniform(r0.primes, (3,), N, 6)
    enc = TL.BatchEncryptor(sp, setup.kp.pub)
    cts = enc(pts, gen)
    conv = TL.ConvLayer(sp, r0, cfg.channels)
    wq, bias = _uniform(r0.primes, (2, 3), 1, 7), _uniform(r0.primes, (2,), N, 8)
    sq = TL.SquareRelinLayer(sp, setup.ek, r1)
    co = conv(cts, wq, bias)
    o1, o2 = sq(co[:, 0], co[:, 1])
    mat = TL.RotateMatmulLayer(sp, setup.gk, setup.gk.galois_element, 4, r2)
    br = TL.BiasRescaleLayer(r2)
    diag = _uniform(r2.primes, (4,), N, 9)
    return {"c_encrypt": lambda: enc(pts, gen), "c_conv": lambda: conv(cts, wq, bias),
            "c_square": lambda: sq(co[:, 0], co[:, 1]),
            "c_rotate_matmul": lambda: mat(o1[0], o2[0], diag),
            "c_bias_rescale": lambda: br(o1[0], o2[0], diag[0])}


def _path_pipelines():
    cfg = TM.MNISTConfig(**MNIST_SMALL)
    gen = torch.Generator().manual_seed(1)
    setup = TM.fhe_setup(cfg, gen)
    weights = TM.init_params(cfg, 3)
    imgs = np.random.default_rng(4).uniform(0.0, 1.0, (cfg.batch, cfg.image, cfg.image))
    out = {}
    for name, gks in (("iterated", None), ("bsgs_dual_flow", TM.keygen_matmul_bsgs(setup, gen))):
        run = TM.build_inference_pipeline(setup, weights, gks)
        pts = run.encode(imgs)
        out[f"d_{name}"] = functools.partial(run.forward, pts, gen)
    return out


def _path_refresh():
    cfg = TM.MNISTConfig(**MNIST_TINY)
    gen = torch.Generator().manual_seed(1)
    setup, ctx = TM.fhe_setup_bootstrapped(cfg, gen, **TM.BOOTSTRAPPED_RECIPE)
    vals = np.random.default_rng(2).uniform(-0.7, 0.7, N // 2)
    c = trlwe.encrypt(setup.kp, T.make_plaintext(setup.params.ring_cipher, vals,
                                                 Fraction(2) ** 52), gen)
    c = TCE.ct_drop_to(c, 2)
    refresh = graphs.jit(functools.partial(TB.bootstrap, ctx))
    weights = TM.init_params(cfg, 2)
    imgs = np.random.default_rng(3).uniform(0.0, 1.0, (cfg.batch, cfg.image, cfg.image))
    run = TM.build_bootstrapped_pipeline(setup, ctx, weights,
                                         prescale=TM.BOOTSTRAPPED_PRESCALE)
    pts = run.encode(imgs)
    return {"e_refresh": lambda: refresh(c),
            "e_bootstrapped_pipeline": functools.partial(run.forward, pts, gen)}


PATHS = {"a": _path_step, "b": _path_hybrid, "c": _path_layers, "d": _path_pipelines,
         "e": _path_refresh}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_second_call_moves_no_host_data(path):
    """Every compiled path of (a)–(e): after one warm-up call, a second call
    uploads nothing and reads nothing back (what capture needs)."""
    calls = PATHS[path]()
    traffic = {name: _second_call_traffic(fn) for name, fn in calls.items()}
    assert traffic == {name: {} for name in calls}


def test_scalar_mul_keeps_its_scalar_only_while_traced():
    """A scalar is data: an eager ``scalar_mul`` uploads it for the call and
    keeps nothing, so distinct scalars do not pile up on the device; while a
    graph is recorded it is kept (a replay reads it), once per value."""
    ring = T.make_rns_ring(N, (30, 29, 29))
    a = T.RingElt(primal=_uniform(ring.primes, (), N, 11))
    kept = len(modmath._CONSTS)
    outs = [T.ringops.scalar_mul(ring, 1000 + k, a).primal for k in range(5)]
    assert len(modmath._CONSTS) == kept
    with graphs.trace():
        traced = [T.ringops.scalar_mul(ring, 1000 + k, a).primal for k in range(5)]
        T.ringops.scalar_mul(ring, 1000, a)
    assert len(modmath._CONSTS) == kept + 5
    assert all(torch.equal(x, y) for x, y in zip(outs, traced))


def test_jit_runs_eagerly_on_the_cpu():
    """On CPU inputs the compiled function is the function: it runs every
    call and captures nothing."""
    calls = []

    def fn(x, k):
        calls.append(k)
        return x * k

    f = graphs.jit(fn)
    x = torch.arange(4)
    assert torch.equal(f(x, 3), x * 3) and torch.equal(f(x, 3), x * 3)
    assert calls == [3, 3] and f.pool.captures == [] and f.pool.mib() == 0.0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_step_replay_matches_eager():
    """The compiled step replays bit-equal to the eager step, counts the same
    launches, holds them as kernel nodes, and keeps an earlier result
    intact."""
    from toyfhe_tpu_torch.ops import ntt_cuda
    dev = _card()
    ring = T.make_rns_ring(4096, (30, 29, 29, 28))
    km, kd = (_uniform(ring.primes, (ring.nlimbs,), 4096, s).to(dev) for s in (1, 2))
    x1, x2 = (_uniform(ring.primes, (4, 2), 4096, s).to(dev) for s in (3, 4))
    eager = pops.make_single_chip_step(ring.tables, km, kd, eager=True)
    step = pops.make_single_chip_step(ring.tables, km, kd)
    step(x1)
    before = dict(ntt_cuda.launches)
    got1 = step(x1)
    kept = got1.clone()
    got2 = step(x2)
    torch.cuda.synchronize()
    assert {k: ntt_cuda.launches[k] - before[k] for k in before} == {"fwd": 4, "inv": 4}
    assert torch.equal(got1, eager(x1)) and torch.equal(got2, eager(x2))
    assert torch.equal(got1, kept) and len(step.pool.captures) == 1
    # what a replay launches, read from the captured graph's kernel nodes
    names = step.pool.graphs[0].kernel_names()
    assert sum("ntt_cluster_kernel" in k for k in names) == 4
    assert step.pool.graphs[0].replays == 3


@pytest.mark.cuda
def test_cuda_encryptor_draws_fresh_noise():
    """Two replays on one generator differ; a replay on a fresh generator
    equals the eager call on the same seed and advances the generator as
    far; every generator of the card shares the one graph."""
    dev = _card()
    cfg = TM.MNISTConfig(**MNIST_TINY)
    seeded = lambda s: torch.Generator(device=dev).manual_seed(s)
    setup = TM.fhe_setup(cfg, seeded(5))
    pts = _uniform(setup.params.ring_cipher.primes, (3,), N, 6).to(dev)
    enc = TL.BatchEncryptor(setup.params, setup.kp.pub)
    eager = TL.BatchEncryptor(setup.params, setup.kp.pub, eager=True)
    for seed in (9, 10):
        g_c, g_e = seeded(seed), seeded(seed)
        a, b = enc(pts, g_c), enc(pts, g_c)
        assert not torch.equal(a, b)
        assert torch.equal(a, eager(pts, g_e)) and torch.equal(b, eager(pts, g_e))
        assert torch.equal(g_c.get_state(), g_e.get_state())
    assert len(enc._compiled.pool.captures) == 1


@pytest.mark.cuda
def test_cuda_pipeline_fresh_generators_share_one_capture():
    """The compiled pipeline called with fresh generators on one seed: each
    call bit-equal to the eager call on that seed, one capture a stage, and
    the pool no larger after the second generator than after the first."""
    dev = _card()
    cfg = TM.MNISTConfig(**MNIST_TINY)
    seeded = lambda s: torch.Generator(device=dev).manual_seed(s)
    setup = TM.fhe_setup(cfg, seeded(1))
    weights = TM.init_params(cfg, 3)
    imgs = np.random.default_rng(4).uniform(0.0, 1.0, (cfg.batch, cfg.image, cfg.image))
    run = TM.build_inference_pipeline(setup, weights)
    pts = run.encode(imgs)
    want = run.eager.forward(pts, seeded(7))
    got = run.forward(pts, seeded(7))
    ncap, mib = len(run.pool.captures), run.pool.mib()
    again = run.forward(pts, seeded(7))
    torch.cuda.synchronize()
    for x in (got, again):
        assert all(torch.equal(a.dual, b.dual) for a, b in zip(x.cs, want.cs))
    assert len(run.pool.captures) == ncap and run.pool.mib() == mib


@pytest.mark.cuda
def test_cuda_mesh_argument_is_refused():
    """A sharded path stays eager: a mesh among the arguments raises."""
    from toyfhe_tpu_torch.parallel import sharding as S
    dev = _card()
    mesh = S.Mesh(("rp",), (1,), device=dev)
    f = graphs.jit(lambda x, m: x + 1)
    with pytest.raises(graphs.CaptureError):
        f(torch.zeros(4, device=dev), mesh)


@pytest.mark.cuda
def test_cuda_nested_jit_runs_inline():
    """A compiled function called while another is captured runs inside the
    outer graph, as a nested ``jax.jit`` does: one capture, one pool."""
    dev = _card()
    inner = graphs.jit(lambda x: x * 3)
    outer = graphs.jit(lambda x: inner(x) + 1)
    x = torch.arange(8, device=dev)
    assert torch.equal(outer(x), x * 3 + 1) and torch.equal(outer(x + 1), (x + 1) * 3 + 1)
    assert len(outer.pool.captures) == 1 and inner.pool.captures == []
