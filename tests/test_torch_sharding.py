"""toyfhe_tpu_torch's sharded steps and transforms against the reference's
on its 8-device CPU mesh.

The reference runs each case on its virtual mesh in this process; the port
runs the same case on 8 spawned gloo ranks on the CPU, one spawn for the
module (``tests/torch_rank_cases.py``), given the reference's keys and
ciphertexts. Cases mirror tests/test_parallel.py (the per-limb step over
dp 2 × rp 4, the hybrid steps with their groups straddling 2-limb shards
and over 3 shards, in both schedules, the decrypt, the limb-sharded
tables, the lazy transform), tests/test_coeff_sharding.py (forward,
round trip and galois at every shard count) and
tests/test_keyswitch_2axis.py ((2, 2) here, (2, 4) and (4, 2) slow as
there). Every result is bit-equal.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import toyfhe_tpu as F
import toyfhe_tpu_torch as T
from toyfhe_tpu.core import ring as ringops
from toyfhe_tpu.ops import ntt as ref_ntt
from toyfhe_tpu.ops import ntt_mxu as ref_mxu
from toyfhe_tpu.parallel import ops as ref_ops
from toyfhe_tpu.parallel import sharding as RS
from toyfhe_tpu.utils import numtheory as nt
from toyfhe_tpu_torch.parallel import distributed as D
from toyfhe_tpu_torch.parallel import sharding as S
from toyfhe_tpu_torch.utils import interop as I

from . import torch_rank_cases as RC

torch.set_num_threads(1)

CP_N, CP_BITS = 1024, (29, 28)
GALOIS = [(2, 3), (4, 3), (8, 3 ** 5), (4, 2 * 1024 - 1)]
CASES = (["step_2x4", "hybrid_v1_rp2dp4", "hybrid_fused_rp2dp4", "hybrid_v1_rp3",
          "hybrid_fused_rp3", "ntt_tables", "coeff_fwd_2", "coeff_fwd_4", "coeff_fwd_8",
          "coeff_rt_2", "coeff_rt_4", "step2axis_2x2"]
         + [f"coeff_galois_{c}_{g}" for c, g in GALOIS])


def _ct_duals(ring, c):
    return np.stack([np.asarray(ringops.ensure_dual(ring, x).dual) for x in c.cs], 0)


def _key_stacks(ring, ek):
    dual = lambda x: np.asarray(ringops.ensure_dual(ring, x).dual)
    return (np.stack([dual(kc.mask) for kc in ek.key.key]),
            np.stack([dual(kc.masked) for kc in ek.key.key]))


def per_limb_fixture():
    """tests/test_parallel.py's setup: N=64, (30, 29, 29, 28), batch 2."""
    N, B = 64, 2
    bits = (30, 29, 29, 28)
    ring = F.make_rns_ring(N, bits)
    params = F.CKKSParams(ring, 0, 3.2)
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    kp = F.keygen(params, ks[0])
    ek = F.keygen_eval_mult(ks[1], kp.priv)
    vals = np.linspace(0.1, 1.0, N // 2)
    scale = Fraction(2) ** 45
    cts = [F.encrypt(kp, F.make_plaintext(ring, vals * (i + 1), scale), k)
           for i, k in enumerate(jax.random.split(ks[2], B))]
    masks, maskeds = _key_stacks(ring, ek)
    seq = [F.ct_rescale(F.keyswitch(ek, F.ct_mul(c, c))) for c in cts]
    return dict(ring=ring, kp=kp, vals=vals, scale=scale, bits=bits, n=N, masks=masks,
                maskeds=maskeds, batch=np.stack([_ct_duals(ring, c) for c in cts]),
                seq=np.stack([_ct_duals(s.ring, s) for s in seq]))


def hybrid_fixture():
    """tests/test_parallel.py's hybrid setup: N=64, (28,)*6 + (30, 30),
    dnum 3, two raising primes, batch 4."""
    N, B = 64, 4
    bits = (28,) * 6 + (30, 30)
    ring = F.make_rns_ring(N, bits)
    params = F.HybridRaised(F.CKKSParams(ring, 0, 3.2), dnum=3, num_special=2)
    ks = jax.random.split(jax.random.PRNGKey(1), 3)
    kp = F.keygen(params, ks[0])
    ek = F.keygen_eval_mult(ks[1], kp.priv)
    vals = np.linspace(0.1, 1.0, N // 2)
    scale = Fraction(2) ** 26
    cts = [F.encrypt(kp, F.make_plaintext(params.ring_cipher, vals * (i + 1), scale), k)
           for i, k in enumerate(jax.random.split(ks[2], B))]
    masks, maskeds = _key_stacks(params.ring_key, ek)
    seq = [F.ct_rescale(F.keyswitch(ek, F.ct_mul(c, c))) for c in cts]
    batch = np.stack([_ct_duals(params.ring_cipher, c) for c in cts])
    mesh = RS.make_mesh(n_rp=2, n_dp=4)
    ref_outs = {}
    for fused in (False, True):
        step, place = ref_ops.make_hybrid_sharded_step(mesh, params, ek, fused_schedule=fused)
        ref_outs[fused] = np.asarray(step(place(jnp.asarray(batch))))
    return dict(params=params, n=N, bits=bits, ek_masks=masks, ek_maskeds=maskeds, batch=batch,
                seq=np.stack([_ct_duals(s.ring, s) for s in seq]), ref=ref_outs)


def two_axis_fixture():
    """tests/test_keyswitch_2axis.py's setup: N=1024, (29, 29, 28, 28),
    batch 2, and the reference's single-chip step's output."""
    N, B = 1024, 2
    bits = (29, 29, 28, 28)
    ring = F.make_rns_ring(N, bits)
    params = F.CKKSParams(ring, 0, 3.2)
    ks = jax.random.split(jax.random.PRNGKey(7), 3)
    kp = F.keygen(params, ks[0])
    ek = F.keygen_eval_mult(ks[1], kp.priv)
    vals = np.linspace(0.05, 0.9, N // 2)
    scale = Fraction(2) ** 45
    cts = [F.encrypt(kp, F.make_plaintext(ring, vals * (i + 1), scale), k)
           for i, k in enumerate(jax.random.split(ks[2], B))]
    duals = np.stack([_ct_duals(ring, c) for c in cts])
    masks, maskeds = _key_stacks(ring, ek)
    single = ref_ops.make_single_chip_step(ring.tables, jnp.asarray(masks), jnp.asarray(maskeds))
    return dict(n=N, bits=bits, batch=duals, masks=masks, maskeds=maskeds,
                expect=np.asarray(single(jnp.asarray(duals))), ring=ring)


def _inputs(lim, hyb, s2a):
    rng = np.random.default_rng(0)
    ntt_x = rng.integers(0, 2 ** 28, (len(lim["bits"]), lim["n"])).astype(np.int64)
    cp_t = ref_ntt.NttTables(CP_N, nt.ntt_prime_chain(CP_N, CP_BITS))
    cp_x = np.stack([np.random.default_rng(1).integers(0, p, CP_N) for p in cp_t.primes])
    out = dict(ntt_x=ntt_x, cp_x=cp_x, cp_n=CP_N, cp_bits=np.asarray(CP_BITS))
    for name, fx in (("lim", lim), ("hyb", hyb), ("s2a", s2a)):
        out[f"{name}_n"], out[f"{name}_bits"] = fx["n"], np.asarray(fx["bits"])
        out[f"{name}_batch"] = fx["batch"]
    for name, fx in (("lim", lim), ("s2a", s2a)):
        out[f"{name}_masks"], out[f"{name}_maskeds"] = fx["masks"], fx["maskeds"]
    out.update(hyb_dnum=3, hyb_k=2, hyb_ek_masks=hyb["ek_masks"], hyb_ek_maskeds=hyb["ek_maskeds"])
    return out, cp_t


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    lim, hyb, s2a = per_limb_fixture(), hybrid_fixture(), two_axis_fixture()
    inputs, cp_t = _inputs(lim, hyb, s2a)
    arrays, infos = RC.spawn(tmp_path_factory.mktemp("sharding"), inputs, CASES)
    return dict(lim=lim, hyb=hyb, s2a=s2a, inputs=inputs, cp_t=cp_t, arrays=arrays, infos=infos)


@pytest.fixture(scope="module")
def ranks_slow(tmp_path_factory):
    s2a = two_axis_fixture()
    inputs = {f"s2a_{k}": (np.asarray(v) if k == "bits" else v) for k, v in s2a.items()
              if k in ("n", "bits", "batch", "masks", "maskeds")}
    cases = ["step2axis_2x4", "step2axis_4x2"]
    arrays, _ = RC.spawn(tmp_path_factory.mktemp("sharding_slow"), inputs, cases)
    return dict(s2a=s2a, arrays=arrays)


def test_sharded_step_matches_sequential(ranks):
    lim, out = ranks["lim"], ranks["arrays"]["step_2x4"]["out"]
    L = len(lim["bits"])
    np.testing.assert_array_equal(out[:, :, :L - 1], lim["seq"])
    assert np.all(out[:, :, -1] == 0)                     # dropped limb zeroed
    coords = [info["step_2x4"]["coords"] for info in ranks["infos"]]
    assert coords == [{"dp": r // 4, "rp": r % 4} for r in range(8)]


@pytest.mark.parametrize("case", ["hybrid_v1_rp2dp4", "hybrid_fused_rp2dp4"])
def test_hybrid_sharded_step_matches_sequential(ranks, case):
    """rp 2 × dp 4: the size-2 limb groups straddle 2-limb shards; equal to
    the eager engine and to the reference's sharded step."""
    hyb, out = ranks["hyb"], ranks["arrays"][case]["out"]
    np.testing.assert_array_equal(out[:, :, :5], hyb["seq"])
    assert np.all(out[:, :, -1] == 0)
    np.testing.assert_array_equal(out, hyb["ref"]["fused" in case])


@pytest.mark.parametrize("case", ["hybrid_v1_rp3", "hybrid_fused_rp3"])
def test_hybrid_sharded_step_3shards(ranks, case):
    """rp 3: shards own 2 limbs as the dnum=3 groups do."""
    hyb, out = ranks["hyb"], ranks["arrays"][case]["out"]
    np.testing.assert_array_equal(out[:, :, :5], hyb["seq"])
    assert np.all(out[:, :, -1] == 0)


def test_hybrid_single_device_under_a_one_rank_mesh(ranks):
    """A mesh of one rank in this process (no process group): both
    schedules equal the single-device step; fused=True is ignored there."""
    hyb = ranks["hyb"]
    tring = T.make_rns_ring(hyb["n"], hyb["bits"])
    tparams = T.HybridRaised(T.CKKSParams(tring, 0, 3.2), 3, 2)
    tek = I.eval_mult_key(tparams, hyb["ek_masks"], hyb["ek_maskeds"], device="cpu")
    mesh = S.make_mesh(1, 1, device="cpu")
    for kw in ({}, {"fused_schedule": True}, {"fused": True}):
        step, place = T.parallel.ops.make_hybrid_sharded_step(mesh, tparams, tek, **kw)
        np.testing.assert_array_equal(I.to_numpy(step(place(hyb["batch"])))[:, :, :5], hyb["seq"])


def test_sharded_step_decrypts(ranks):
    lim, out = ranks["lim"], ranks["arrays"]["step_2x4"]["out"]
    ring = lim["ring"]
    tring = T.make_rns_ring(lim["n"], lim["bits"])
    tparams = T.CKKSParams(tring, 0, 3.2)
    secret = np.asarray(ringops.ensure_primal(ring, lim["kp"].priv.secret).primal)
    tkey = I.priv_key(tparams, secret, device="cpu")
    new_scale = lim["scale"] ** 2 / ring.primes[-1]
    for i in range(out.shape[0]):
        c = I.ciphertext(tparams, tring.drop_last(), out[i][:, :3], new_scale, device="cpu")
        np.testing.assert_allclose(T.decrypt(tkey, c).real, (lim["vals"] * (i + 1)) ** 2,
                                   atol=2e-4)


def test_ntt_tables_shard(ranks):
    """Limb-sharded tables and transforms equal the single-device NTT."""
    lim, got = ranks["lim"], ranks["arrays"]["ntt_tables"]
    x = ranks["inputs"]["ntt_x"]
    ring = F.make_rns_ring(lim["n"], lim["bits"])
    np.testing.assert_array_equal(got["out"], np.asarray(
        ref_ntt.ntt(ring.tables, jnp.asarray(x.astype(np.uint32)))))
    np.testing.assert_array_equal(got["back"], x)
    assert all(info["ntt_tables"]["tables_equal"] for info in ranks["infos"])


def test_ntt_p_lazy_bitexact():
    """The lazy flag of the limb-sharded transform changes no value; a tower
    at or past 2^30 refuses it."""
    from toyfhe_tpu.parallel import sharding as ref_S
    ring, tring = F.make_rns_ring(128, (28, 27)), T.make_rns_ring(128, (28, 27))
    tabs = S.ntt_table_pytree(tring.tables, "cpu")
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(0, p, 128) for p in ring.primes])
    a = I.to_numpy(S.ntt_p(torch.as_tensor(x), tabs, lazy=True))
    np.testing.assert_array_equal(a, I.to_numpy(S.ntt_p(torch.as_tensor(x), tabs)))
    rtabs = ref_S.ntt_table_pytree(ring.tables)
    np.testing.assert_array_equal(a, np.asarray(ref_S.ntt_p(jnp.asarray(x.astype(np.uint32)),
                                                            rtabs, lazy=True)))
    ia = I.to_numpy(S.intt_p(torch.as_tensor(x), tabs, lazy=True))
    np.testing.assert_array_equal(ia, np.asarray(ref_ntt.intt(ring.tables,
                                                              jnp.asarray(x.astype(np.uint32)))))
    wide = S.ntt_table_pytree(T.make_rns_ring(128, (30, 30)).tables, "cpu")
    with pytest.raises(ValueError):
        S.ntt_p(torch.zeros(2, 128, dtype=torch.int64), wide, lazy=True)


def _ref_cp(body, nshards, x):
    mesh = Mesh(np.asarray(jax.devices()[:nshards]), ("cp",))
    f = shard_map(body, mesh=mesh, in_specs=P(None, "cp"), out_specs=P(None, "cp"),
                  check_vma=False)
    return np.asarray(jax.jit(f)(jnp.asarray(x.astype(np.uint32))))


@pytest.mark.parametrize("nshards", [2, 4, 8])
def test_coeff_sharded_forward(ranks, nshards):
    t = ranks["cp_t"]
    mt = ref_mxu.MxuNttTables(t)
    x = ranks["inputs"]["cp_x"]
    in_src, out_nat = RS.coeff_shard_layout(CP_N, mt.n2, nshards)
    tin, tout = S.coeff_shard_layout(CP_N, mt.n2, nshards)
    assert np.array_equal(tin, in_src) and np.array_equal(tout, out_nat)
    got = ranks["arrays"][f"coeff_fwd_{nshards}"]["out"]
    np.testing.assert_array_equal(got, _ref_cp(RS.coeff_sharded_ntt_fn(mt, nshards), nshards,
                                               x[:, in_src]))
    nat = np.zeros_like(got)
    nat[:, out_nat] = got
    np.testing.assert_array_equal(nat, np.asarray(ref_ntt.ntt(t, jnp.asarray(
        x.astype(np.uint32)))))
    # one all-to-all of the rank's whole block, as the model says
    model = D.coeff_ntt_comm_model(CP_N, len(CP_BITS), nshards)
    for info in ranks["infos"][:nshards]:
        assert D.counter_matches_model(info[f"coeff_fwd_{nshards}"]["counts"], model)


@pytest.mark.parametrize("nshards", [2, 4])
def test_coeff_sharded_roundtrip(ranks, nshards):
    t = ranks["cp_t"]
    mt = ref_mxu.MxuNttTables(t)
    x = ranks["inputs"]["cp_x"]
    in_src, out_nat = RS.coeff_shard_layout(CP_N, mt.n2, nshards)
    got = ranks["arrays"][f"coeff_rt_{nshards}"]
    np.testing.assert_array_equal(got["back"], x[:, in_src])
    dual_nat = np.zeros_like(x)
    dual_nat[:, out_nat] = got["dual"]
    np.testing.assert_array_equal(np.asarray(ref_ntt.intt(t, jnp.asarray(
        dual_nat.astype(np.uint32)))), x)


@pytest.mark.parametrize("nshards,element", GALOIS)
def test_coeff_sharded_galois(ranks, nshards, element):
    t = ranks["cp_t"]
    mt = ref_mxu.MxuNttTables(t)
    x = ranks["inputs"]["cp_x"]
    src, neg = ref_ntt.galois_perm_tables(CP_N, element)
    expect = np.asarray(ref_ntt.apply_galois(t.mp, jnp.asarray(x.astype(np.uint32)), src, neg))
    in_src, _ = RS.coeff_shard_layout(CP_N, mt.n2, nshards)
    got = ranks["arrays"][f"coeff_galois_{nshards}_{element}"]["out"]
    np.testing.assert_array_equal(got, expect[:, in_src])
    plan, ref_plan = (S.coeff_sharded_galois_plan(CP_N, mt.n2, nshards, element),
                      RS.coeff_sharded_galois_plan(CP_N, mt.n2, nshards, element))
    for a, b in zip(plan, ref_plan):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_rp,n_cp", [
    pytest.param(2, 4, marks=pytest.mark.slow),
    pytest.param(4, 2, marks=pytest.mark.slow),
    (2, 2),
])
def test_2axis_step_matches_single_chip(request, n_rp, n_cp):
    fx = request.getfixturevalue("ranks_slow" if (n_rp, n_cp) != (2, 2) else "ranks")
    got = fx["arrays"][f"step2axis_{n_rp}x{n_cp}"]["out"]
    np.testing.assert_array_equal(got, fx["s2a"]["expect"])


def test_mxu_table_pytree_checks_the_factorization():
    """The docstring comes first and the check raises (the reference's
    ``assert`` before its docstring is not copied)."""
    assert S.mxu_table_pytree.__doc__.startswith("Four-step constants")

    class Wide:
        n1 = 64
    with pytest.raises(ValueError):
        S.mxu_table_pytree(Wide(), 2, "cpu")
