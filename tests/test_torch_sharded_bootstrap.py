"""The limb-sharded CKKS refresh of toyfhe_tpu_torch on spawned gloo ranks.

The reference places keys and ciphertext limb-wise
(``parallel.sharding.shard_limbwise``) and lets GSPMD partition
``jax.jit(bootstrap)``; the port's engine runs the same call on each rank
of an 'rp' mesh, on the rows of the strided layout the rank holds:

    B.bootstrap(S.shard_limbwise(ctx, mesh), S.shard_limbwise(c, mesh))

The reference makes the keys and exhausted ciphertexts; they are carried
across as numpy. The configuration is that of
test_torch_bootstrap_parity.py (N = 32, sixteen 30-bit limbs, 12 + 4
raising, dnum 4, the radix-16 factored transforms), which holds the port's
single-device refresh equal to ``jax.jit(bootstrap)`` bit for bit, so
bit-equality to the single-device refresh here carries to the reference.
One spawn of 4 ranks runs every case (``tests/torch_rank_cases.py``):

  * the whole refresh over rp 2, 3 and 4 (3 leaves the blocks uneven at
    every level), ``bootstrap_batched`` on two ciphertexts over rp 3,
    ``bootstrap_phase1`` at the dry run's N = 16, 8 + 4 limbs, over rp 4,
    and the composite ``scale_limbs = 2`` recipe of
    test_torch_bootstrap_composite.py over rp 2: every residue, the tower
    and the exact scale tag;
  * the engine operations alone over rp 2 and 3: ``keyswitch``,
    ``rotate`` (and the conjugation), ``rotate_many``, ``rotate_sum``,
    ``ct_mul`` + relinearize + rescale, ``ct_rescale``,
    ``ct_modswitch_drop``;
  * the collective counter against what ``utils.metrics`` and
    ``rlwe.hoist_counts`` of the same call predict;
  * each rank's key and plain-cache rows: its strided share, at most
    ⌈rows/rp⌉ of each tensor, the ranks together exactly the single
    device's bytes;
  * a multi-rank mesh on the windowed and per-limb gadgets raises.

The slow test mirrors tests/test_bootstrap.py's sharded refresh (N = 64,
rp 4) against the reference's own GSPMD run on its 4-device CPU mesh.
"""

from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

import toyfhe_tpu as F
from toyfhe_tpu.core import bootstrap as RB
from toyfhe_tpu.core import ckks_encoding as RCE
from toyfhe_tpu.core import ring as rr
from toyfhe_tpu_torch.core import bootstrap as TB
from toyfhe_tpu_torch.core import rlwe as TL
from toyfhe_tpu_torch.parallel import sharding as S
from toyfhe_tpu_torch.utils import metrics

from . import torch_rank_cases as RC
from .test_torch_bootstrap import key_stacks
from .test_torch_ckks_surface import ct_duals

torch.set_num_threads(1)

PAR = dict(n=32, bits=(30,) * 16, dnum=4, k=4, seed=5, K=5.0, deg=8, radix=16)
DRY = dict(n=16, bits=(30,) * 12, dnum=4, k=4, seed=5, K=5.0, deg=8, radix=0)
# the composite recipe of test_torch_bootstrap_composite.py, 34 levels deep
# (the least depth that holds its whole refresh at N = 32: 5 limbs out) and
# dnum 6, so that a digit group is 6 limbs as in mnist.BOOTSTRAPPED_RECIPE
CMP = dict(n=32, depth=34, dnum=6, k=7, seed=31, K=5.0, deg=24, radix=4, arcsin=True,
           double_angle=2, sl=2)
REFRESH_RP = (2, 3, 4)
OPS_RP = (2, 3)
CASES = ([f"boot_refresh_rp{r}" for r in REFRESH_RP] + ["boot_batched_rp3", "boot_phase1_rp4",
         "boot_composite_rp2"] + [f"boot_ops_rp{r}" for r in OPS_RP] + ["boot_windowed_rp2"])


def _ref_setup(cfg):
    """The reference's params, context and two exhausted ciphertexts."""
    if "depth" in cfg:
        ring = RB.make_boot_ring(cfg["n"], cfg["depth"], cfg["k"])
    else:
        ring = F.make_rns_ring(cfg["n"], cfg["bits"])
    params = F.HybridRaised(F.CKKSParams(ring, 0, 3.2, secret="sparse", hamming_weight=4),
                            dnum=cfg["dnum"], num_special=cfg["k"])
    ks = jax.random.split(jax.random.PRNGKey(cfg["seed"]), 4)
    kp = F.keygen(params, ks[0])
    sl = cfg.get("sl", 1)
    ctx = RB.setup_bootstrap(ks[1], kp.priv, K=cfg["K"], deg=cfg["deg"], radix=cfg["radix"],
                             arcsin=cfg.get("arcsin", False),
                             double_angle=cfg.get("double_angle", 0), scale_limbs=sl)
    rng = np.random.default_rng(cfg["seed"])
    h = cfg["n"] // 2
    scale = Fraction(2) ** (52 if sl == 2 else 27)
    cts = []
    for i in range(2):
        vals = (rng.uniform(-1, 1, h) + 1j * rng.uniform(-1, 1, h)) * 0.7
        c = F.encrypt(kp, F.make_plaintext(params.ring_cipher, vals, scale),
                      jax.random.fold_in(ks[2], i))
        cts.append(RCE.ct_drop_to(c, sl))
    return params, kp, ctx, cts


def export(prefix, params, ctx, cts) -> dict:
    """The inputs ``torch_rank_cases.boot_setup`` rebuilds the port's
    context and ciphertexts from."""
    kr = params.ring_key
    gst = [key_stacks(kr, k.key) for k in ctx.gks.keys]
    out = dict(n=kr.n, primes=np.asarray(kr.primes, dtype=np.int64), dnum=params.dnum,
               k=params.num_special, K=ctx.K, deg=ctx.deg,
               radix=0 if ctx.plan is None else ctx.plan.radix, arcsin=ctx.arcsin,
               double_angle=ctx.double_angle, sl=ctx.scale_limbs, cts=len(cts),
               gk_el=np.asarray([k.galois_element for k in ctx.gks.keys]),
               gk_masks=np.stack([np.stack(m) for m, _ in gst]),
               gk_maskeds=np.stack([np.stack(md) for _, md in gst]),
               conj_el=ctx.gk_conj.galois_element)
    out["ek_masks"], out["ek_maskeds"] = map(np.stack, key_stacks(kr, ctx.ek.key))
    out["conj_masks"], out["conj_maskeds"] = map(np.stack, key_stacks(kr, ctx.gk_conj.key))
    for i, c in enumerate(cts):
        out[f"ct{i}_duals"], out[f"ct{i}_nl"] = ct_duals(c), c.ring.nlimbs
        out[f"ct{i}_scale"] = str(c.enc.scale)
    return {f"{prefix}_{k}": np.asarray(v) for k, v in out.items()}


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def key_bytes(ctx) -> int:
    keys = [ctx.ek.key, ctx.gk_conj.key] + [g.key for g in ctx.gks.keys]
    return _bytes(t for k in keys for c in k.key for e in (c.mask, c.masked)
                  for t in (e.primal, e.dual))


def cache_bytes(ctx) -> int:
    return _bytes(t for e in ctx.plain_cache.values() for t in (e.primal, e.dual))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    par_params, par_kp, par_ctx, par_cts = _ref_setup(PAR)
    x = F.encrypt(par_kp, F.make_plaintext(par_params.ring_cipher, np.full(PAR["n"] // 2, 0.3),
                                           Fraction(2) ** 27), jax.random.PRNGKey(7))
    inputs = export("par", par_params, par_ctx, par_cts + [x])   # x: the engine ops' input
    for prefix, cfg in (("dry", DRY), ("cmp", CMP)):
        params, _, ctx, cts = _ref_setup(cfg)
        inputs.update(export(prefix, params, ctx, cts))
    arrays, infos = RC.spawn(tmp_path_factory.mktemp("sharded_boot"), inputs, CASES, world=4,
                             timeout_s=300.0)
    return dict(inputs=inputs, arrays=arrays, infos=infos)


def single(inp, prefix):
    """The port's single-device context and ciphertexts of ``prefix``."""
    return RC.boot_setup(inp, prefix)


def _assert_ct(got: np.ndarray, want) -> None:
    np.testing.assert_array_equal(got, RC._ct_arrays(want))


def _infos(ranks, case):
    return [i[case] for i in ranks["infos"] if i[case]]


@pytest.mark.parametrize("rp", REFRESH_RP)
def test_sharded_refresh_bit_equal(ranks, rp):
    """The whole refresh over rp ranks: every residue, the tower and the
    exact scale tag of the single-device refresh, on every rank."""
    _, ctx, cts = single(ranks["inputs"], "par")
    want = TB.bootstrap(ctx, cts[0])
    _assert_ct(ranks["arrays"][f"boot_refresh_rp{rp}"]["out"], want)
    infos = _infos(ranks, f"boot_refresh_rp{rp}")
    assert len(infos) == rp
    for info in infos:
        assert Fraction(info["scale"]["out"]) == want.enc.scale
        assert info["nlimbs"]["out"] == want.ring.nlimbs
    assert sorted(q for i in infos for q in i["held"]) == list(range(want.ring.nlimbs))


def test_sharded_batched_refresh(ranks):
    """``bootstrap_batched`` on two ciphertexts over rp 3 equals the two
    single-device refreshes."""
    _, ctx, cts = single(ranks["inputs"], "par")
    singles = [RC._ct_arrays(TB.bootstrap(ctx, c)) for c in cts[:2]]
    np.testing.assert_array_equal(ranks["arrays"]["boot_batched_rp3"]["out"],
                                  np.stack(singles, axis=1))


def test_sharded_phase1_dry_run_shape(ranks):
    """``bootstrap_phase1`` at the reference dry run's N = 16 on 8 + 4
    limbs over rp 4 (a rank holds no row of the one-limb input): both
    CoeffToSlot halves."""
    _, ctx, cts = single(ranks["inputs"], "dry")
    lo, hi = TB.bootstrap_phase1(ctx, cts[0])
    got = ranks["arrays"]["boot_phase1_rp4"]
    _assert_ct(got["lo"], lo)
    _assert_ct(got["hi"], hi)


def test_sharded_composite_recipe(ranks):
    """The production recipe's two-limb scale algebra (``scale_limbs`` =
    2, double angle, arcsine, radix 4) over rp 2: the whole refresh."""
    _, ctx, cts = single(ranks["inputs"], "cmp")
    want = TB.bootstrap(ctx, cts[0])
    _assert_ct(ranks["arrays"]["boot_composite_rp2"]["out"], want)
    for info in _infos(ranks, "boot_composite_rp2"):
        assert Fraction(info["scale"]["out"]) == want.enc.scale


@pytest.mark.parametrize("rp", OPS_RP)
def test_sharded_engine_ops(ranks, rp):
    """Each engine operation on a limb-sharded full-tower ciphertext equals
    the single-device operation."""
    _, ctx, cts = single(ranks["inputs"], "par")
    want = RC.engine_ops(ctx, cts[-1])
    got = ranks["arrays"][f"boot_ops_rp{rp}"]
    assert sorted(got) == sorted(want)
    for name, c in want.items():
        _assert_ct(got[name], c)


@pytest.mark.parametrize("case", [f"boot_refresh_rp{r}" for r in REFRESH_RP]
                         + ["boot_batched_rp3", "boot_phase1_rp4", "boot_composite_rp2"]
                         + [f"boot_ops_rp{r}" for r in OPS_RP])
def test_collectives_as_counted(ranks, case):
    """Each rank issued one digit share and one ModDown exchange per key
    switch (the hoisted schedules: one digit share per decomposition, one
    exchange per rotation of ``rotate_many`` and per ``rotate_sum``), one
    rescale_broadcast per rescale and the gathers of the ModRaise input and
    of the output; all-gathers, no other site."""
    for info in _infos(ranks, case):
        counts = {k: n for k, (kind, n) in info["counts"].items()}
        assert all(kind == "all-gather" for kind, _ in info["counts"].values())
        assert counts == {k: n for k, n in info["predicted"].items() if n}, info
        assert counts["keyswitch_digit_share"] > 0 and counts["rescale_broadcast"] > 0


@pytest.mark.parametrize("rp", REFRESH_RP)
def test_rank_holds_its_share(ranks, rp):
    """Each key and plain-cache tensor holds the rank's strided rows, at
    most ⌈rows/rp⌉; the ranks together hold each key row and each cached
    row exactly once (the single device's bytes)."""
    _, ctx, cts = single(ranks["inputs"], "par")
    TB.bootstrap(ctx, cts[0])
    infos = _infos(ranks, f"boot_refresh_rp{rp}")
    assert all(i["rows_ok"] for i in infos)
    assert sum(i["key_bytes"] for i in infos) == key_bytes(ctx)
    assert sum(i["cache_bytes"] for i in infos) == cache_bytes(ctx)
    assert all(i["cache_entries"] == len(ctx.plain_cache) for i in infos)
    worst = -(-16 // rp) / 16
    assert max(i["key_bytes"] for i in infos) <= worst * key_bytes(ctx)


def test_windowed_gadget_refused_on_mesh(ranks):
    """A multi-rank mesh on the windowed (w = 4) and per-limb (w = 0) RNS
    gadgets: key switch, rotation and hoisted rotations raise
    ``NotImplementedError``."""
    for info in _infos(ranks, "boot_windowed_rp2"):
        assert info["raised"] and all(info["raised"].values()), info


def test_one_rank_mesh_in_process(ranks):
    """A mesh of one rank in this process (no process group): the refresh
    bit-equal, every collective an identity that is still counted."""
    _, ctx, cts = single(ranks["inputs"], "par")
    want = TB.bootstrap(ctx, cts[0])
    mesh = S.make_mesh(1, 1, device="cpu")
    sctx, sc = S.shard_limbwise(ctx, mesh), S.shard_limbwise(cts[0], mesh)
    RC._reset_counts(mesh)
    with RC.CallCounts() as calls:
        out = TB.bootstrap(sctx, sc)
    got = S.gather_limbwise(out)
    assert got.ring is want.ring and got.enc == want.enc
    _assert_ct(RC._ct_arrays(got), want)
    counts = {k: v["count"] for k, v in mesh.comm.snapshot().items()}
    assert counts == {k: n for k, n in RC.predicted(calls, 2).items() if n}
    assert metrics.snapshot()["keyswitch"] > TL.hoist_counts["key_product_calls"] > 0
    assert calls.many > 0 and calls.sums > 0


def test_shard_limbwise_walks_engine_objects(ranks):
    """The strided rows of a tower and of an expanded tower Q_5 ∪ P; a
    placed context's keys on views of the key tower and its plain cache
    empty; a bare ring element and a tower placed twice refused."""
    _, ctx, cts = single(ranks["inputs"], "par")
    ring = ctx.ek.key.ring
    assert S.strided_rows(ring._root_indices, 3, 1) == [1, 4, 7, 10, 13]
    sub = ring.select(list(range(5)) + [12, 13, 14, 15])     # Q_5 ∪ P
    assert S.strided_rows(sub._root_indices, 3, 0) == [0, 3, 5, 8]
    mesh = S.make_mesh(1, 1, device="cpu")
    sctx = S.shard_limbwise(ctx, mesh)
    assert sctx.plain_cache == {} and sctx.ek.key.ring.whole is ring
    assert sctx.gks.keys[0].galois_element == ctx.gks.keys[0].galois_element
    with pytest.raises(TypeError):
        S.shard_limbwise(cts[0].cs[0], mesh)
    with pytest.raises(ValueError):
        S.shard_limbwise(S.shard_limbwise(cts[0], mesh), mesh)


@pytest.mark.slow
def test_sharded_refresh_against_reference_gspmd(tmp_path):
    """tests/test_bootstrap.py's sharded refresh (N = 64, sixteen 30-bit
    limbs, rp 4): the reference's ``jax.jit(bootstrap)`` over its 4-device
    CPU mesh and the port's 4 ranks on the same keys, bit-equal."""
    from toyfhe_tpu.parallel import sharding as RS

    cfg = dict(PAR, n=64)
    params, _, ctx, cts = _ref_setup(cfg)
    mesh = RS.make_mesh(n_rp=4, devices=jax.devices()[:4])
    ref = jax.jit(RB.bootstrap)(RS.shard_limbwise(ctx, mesh), RS.shard_limbwise(cts[0], mesh))
    inputs = export("par", params, ctx, cts)
    arrays, _ = RC.spawn(tmp_path, inputs, ["boot_refresh_rp4"], world=4, timeout_s=600.0)
    want = np.stack([np.asarray(rr.ensure_dual(ref.ring, x).dual) for x in ref.cs])
    np.testing.assert_array_equal(arrays["boot_refresh_rp4"]["out"], want)
