"""The rank side of the sharded tests: run by spawned gloo ranks
(``toyfhe_tpu_torch.parallel.launch``), importing torch and the port only.

The pytest process writes the inputs, made with the reference, to
``inputs.npz`` in the run's directory and names the cases to run; every
rank runs every case in order (each builds its mesh with all the world's
ranks, members or not), rank 0 writes each case's global result to
``<case>.npz`` and every rank returns its collective counts and checks.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import toyfhe_tpu_torch as T
from toyfhe_tpu_torch.ops import fbc_cuda
from toyfhe_tpu_torch.ops import ntt_mxu as MX
from toyfhe_tpu_torch.parallel import distributed as D
from toyfhe_tpu_torch.parallel import ops as pops
from toyfhe_tpu_torch.parallel import sharding as S
from toyfhe_tpu_torch.utils import interop as I

DEV = "cpu"


def _bits(a):
    return tuple(int(b) for b in a)


def _per_limb_step(inp, prefix, mesh, spec=pops.DATA_SPEC):
    """make_sharded_step on ``prefix``'s ring, keys and batch: the global
    result and this rank's counts of the step alone."""
    n, bits = int(inp[f"{prefix}_n"]), _bits(inp[f"{prefix}_bits"])
    ring = T.make_rns_ring(n, bits)
    step, place = pops.make_sharded_step(mesh, ring.tables, inp[f"{prefix}_masks"],
                                         inp[f"{prefix}_maskeds"])
    block = place(inp[f"{prefix}_batch"])
    mesh.comm.reset()
    out = step(block)
    counts = mesh.comm.snapshot()
    assert out.device == mesh.device
    return S.unshard(out, spec, mesh), counts


def case_step_2x4(inp):
    mesh = S.make_mesh(4, 2, device=DEV)
    out, counts = _per_limb_step(inp, "lim", mesh)
    return {"out": out}, {"counts": counts, "coords": mesh.coords}


def _hybrid(inp, n_rp, n_dp, fused_schedule):
    ranks = list(range(n_rp * n_dp))
    mesh = S.make_mesh(n_rp, n_dp, device=DEV, ranks=ranks)
    if not mesh.member:
        return None, {}
    ring = T.make_rns_ring(int(inp["hyb_n"]), _bits(inp["hyb_bits"]))
    params = T.HybridRaised(T.CKKSParams(ring, 0, 3.2), int(inp["hyb_dnum"]), int(inp["hyb_k"]))
    ek = I.eval_mult_key(params, inp["hyb_ek_masks"], inp["hyb_ek_maskeds"], device=DEV)
    step, place = pops.make_hybrid_sharded_step(mesh, params, ek, fused_schedule=fused_schedule,
                                                dp=n_dp > 1)
    spec = pops.DATA_SPEC if n_dp > 1 else (None, None, "rp", None)
    mesh.comm.reset()
    out = step(place(inp["hyb_batch"]))
    counts = mesh.comm.snapshot()
    return {"out": S.unshard(out, spec, mesh)}, {"counts": counts}


def case_hybrid_v1_rp2dp4(inp):
    return _hybrid(inp, 2, 4, False)


def case_hybrid_fused_rp2dp4(inp):
    return _hybrid(inp, 2, 4, True)


def case_hybrid_v1_rp3(inp):
    return _hybrid(inp, 3, 1, False)


def case_hybrid_fused_rp3(inp):
    return _hybrid(inp, 3, 1, True)


def case_hybrid_fbc_calls_rp2(inp):
    """The v1 and the fused-schedule hybrid steps over rp 2 on the ``fbc_``
    fixture, and the calls of ``fbc_cuda.fbc`` each step made on this rank."""
    mesh = S.make_mesh(2, 1, device=DEV, ranks=[0, 1])
    if not mesh.member:
        return None, {}
    ring = T.make_rns_ring(int(inp["fbc_n"]), _bits(inp["fbc_bits"]))
    params = T.HybridRaised(T.CKKSParams(ring, 0, 3.2), int(inp["fbc_dnum"]), int(inp["fbc_k"]))
    ek = I.eval_mult_key(params, inp["fbc_masks"], inp["fbc_maskeds"], device=DEV)
    real, calls = fbc_cuda.fbc, [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    arrays, info = {}, {}
    fbc_cuda.fbc = counted
    try:
        for name, fused in (("v1", False), ("fused", True)):
            step, place = pops.make_hybrid_sharded_step(mesh, params, ek, fused_schedule=fused,
                                                        dp=False)
            block = place(inp["fbc_batch"])
            calls[0] = 0
            out = step(block)
            info[name] = calls[0]
            arrays[name] = S.unshard(out, (None, None, "rp", None), mesh)
    finally:
        fbc_cuda.fbc = real
    return arrays, info


def case_ntt_tables(inp):
    mesh = S.make_mesh(4, 2, device=DEV)
    ring = T.make_rns_ring(int(inp["lim_n"]), _bits(inp["lim_bits"]))
    tabs = S.ntt_table_pytree(ring.tables, DEV, mesh)
    full = S.ntt_table_pytree(ring.tables, DEV)
    cut = S.shard_tree({k: v for k, v in full.items() if k != "tables"}, S.table_specs(), mesh)
    same = all(torch.equal(a, b) for k in cut
               for a, b in zip(*(((t[k],) if torch.is_tensor(t[k]) else t[k])
                                 for t in (cut, tabs))))
    x = S.shard(inp["ntt_x"], ("rp", None), mesh)
    out = S.unshard(S.ntt_p(x, tabs), ("rp", None), mesh)
    back = S.unshard(S.intt_p(S.shard(out, ("rp", None), mesh), tabs), ("rp", None), mesh)
    return {"out": out, "back": back}, {"tables_equal": bool(same)}


def _cp_mesh(nshards):
    return S.Mesh(("cp",), (nshards,), device=DEV, ranks=list(range(nshards)))


def _mxu_tables(inp):
    return MX.MxuNttTables(T.make_rns_ring(int(inp["cp_n"]), _bits(inp["cp_bits"])).tables)


def _coeff_forward(inp, nshards):
    mesh = _cp_mesh(nshards)
    if not mesh.member:
        return None, {}
    mt = _mxu_tables(inp)
    in_src, _ = S.coeff_shard_layout(mt.n, mt.n2, nshards)
    body = S.coeff_sharded_ntt_fn(mt, nshards, mesh=mesh)
    mesh.comm.reset()
    y = body(S.shard(inp["cp_x"][:, in_src], (None, "cp"), mesh))
    counts = mesh.comm.snapshot()
    return {"out": S.unshard(y, (None, "cp"), mesh)}, {"counts": counts}


def _coeff_roundtrip(inp, nshards):
    mesh = _cp_mesh(nshards)
    if not mesh.member:
        return None, {}
    mt = _mxu_tables(inp)
    in_src, _ = S.coeff_shard_layout(mt.n, mt.n2, nshards)
    fwd = S.coeff_sharded_ntt_fn(mt, nshards, mesh=mesh)
    inv = S.coeff_sharded_intt_fn(mt, nshards, mesh=mesh)
    dual = fwd(S.shard(inp["cp_x"][:, in_src], (None, "cp"), mesh))
    back = inv(dual)
    return {"dual": S.unshard(dual, (None, "cp"), mesh),
            "back": S.unshard(back, (None, "cp"), mesh)}, {}


def _coeff_galois(inp, nshards, element):
    mesh = _cp_mesh(nshards)
    if not mesh.member:
        return None, {}
    mt = _mxu_tables(inp)
    in_src, _ = S.coeff_shard_layout(mt.n, mt.n2, nshards)
    body = S.coeff_sharded_galois_fn(mt, nshards, element, mesh=mesh)
    y = body(S.shard(inp["cp_x"][:, in_src], (None, "cp"), mesh))
    return {"out": S.unshard(y, (None, "cp"), mesh)}, {}


def _step_2axis(inp, prefix, n_dp, n_rp, n_cp):
    names, shape = (("dp", "rp", "cp"), (n_dp, n_rp, n_cp)) if n_dp > 1 else \
        (("rp", "cp"), (n_rp, n_cp))
    mesh = S.Mesh(names, shape, device=DEV, ranks=list(range(n_dp * n_rp * n_cp)))
    if not mesh.member:
        return None, {}
    ring = T.make_rns_ring(int(inp[f"{prefix}_n"]), _bits(inp[f"{prefix}_bits"]))
    step, place, (_, out_nat) = pops.make_2axis_step(
        mesh, MX.MxuNttTables(ring.tables), inp[f"{prefix}_masks"], inp[f"{prefix}_maskeds"],
        n_cp=n_cp, dp=n_dp > 1)
    block = place(inp[f"{prefix}_batch"])
    mesh.comm.reset()
    out = step(block)
    counts = mesh.comm.snapshot()
    g = S.unshard(out, ("dp" if n_dp > 1 else None, None, "rp", "cp"), mesh)
    nat = torch.zeros_like(g)
    nat[..., torch.as_tensor(out_nat)] = g
    return {"out": nat}, {"counts": counts}


def case_counter_step(inp):
    mesh = S.make_mesh(4, 2, device=DEV)
    out, counts = _per_limb_step(inp, "cnt", mesh)
    return {"out": out}, {"counts": counts}


def case_counter_2axis(inp):
    return _step_2axis(inp, "c2a", 2, 2, 2)


def case_hybrid_mesh(inp):
    mesh = D.make_hybrid_mesh(4, 2, device=DEV)
    info = {"axes": list(mesh.axis_names), "shape": [mesh.shape[a] for a in mesh.axis_names],
            "coords": mesh.coords}
    for n_rp, n_dp, per_host in ((64, 2, None), (4, 2, 2)):
        if per_host is not None:
            os.environ["LOCAL_WORLD_SIZE"] = str(per_host)
        try:
            D.make_hybrid_mesh(n_rp, n_dp, device=DEV)
            info[f"raised_{n_rp}_{per_host}"] = False
        except ValueError:
            info[f"raised_{n_rp}_{per_host}"] = True
        finally:
            os.environ.pop("LOCAL_WORLD_SIZE", None)
    return None, info


def _pipeline(inp, prefix, bsgs=True, dual_flow=None):
    from toyfhe_tpu_torch.models import mnist as TM
    from toyfhe_tpu_torch.parallel import layers as TL

    cfg = TM.MNISTConfig(**{k: str(v) if v.dtype.kind == "U" else
                            (tuple(int(b) for b in v) if v.ndim else int(v))
                            for k, v in _fields(inp, f"{prefix}_cfg_").items()})
    setup = I.fhe_setup_from_numpy(cfg, **{k: (int(v) if k == "gk_element" else v)
                                           for k, v in _fields(inp, f"{prefix}_key_").items()},
                                   device=DEV)
    els = [int(e) for e in inp[f"{prefix}_gks_elements"]]
    gks = I.galois_keys(setup.params, els, inp[f"{prefix}_gks_masks"],
                        inp[f"{prefix}_gks_maskeds"], device=DEV) if bsgs else None
    params = {k: inp[f"{prefix}_param_{k}"] for k in I.MNIST_PARAM_NAMES}
    imgs = inp[f"{prefix}_imgs"]
    grid = torch.as_tensor(inp[f"{prefix}_grid"])
    TL.BatchEncryptor = lambda *a, **k: (lambda pts, gen: grid.clone())
    mesh = S.make_mesh(int(inp[f"{prefix}_rp"]), int(inp[f"{prefix}_dp"]), device=DEV)
    mesh.comm.reset()
    ct = TM.build_inference_pipeline(setup, params, gks, dual_flow, mesh=mesh)(
        imgs, torch.Generator(), _return_ct=True)
    counts = mesh.comm.snapshot()
    single = TM.build_inference_pipeline(setup, params, gks, dual_flow)(
        imgs, torch.Generator(), _return_ct=True)
    same = all(torch.equal(a.dual, b.dual) for a, b in zip(ct.cs, single.cs))
    logits = T.decrypt(setup.kp, ct).real.reshape(cfg.positions, cfg.batch)[:cfg.classes]
    return ({"c0": ct.cs[0].dual, "c1": ct.cs[1].dual, "logits": logits},
            {"counts": counts, "equal_single": bool(same)})


def _fields(inp, prefix):
    return {k[len(prefix):]: inp[k] for k in inp.files if k.startswith(prefix)}


def case_pipeline_tiny(inp):
    return _pipeline(inp, "pt")


def case_pipeline_tiny_iterated(inp):
    return _pipeline(inp, "pt", bsgs=False)


def case_pipeline_tiny_primal(inp):
    return _pipeline(inp, "pt", dual_flow=False)


def case_pipeline_49(inp):
    return _pipeline(inp, "p49")


# ---------------------------------------------------------------------------
# the limb-sharded refresh (tests/test_torch_sharded_bootstrap.py)
# ---------------------------------------------------------------------------

def _frac(a):
    from fractions import Fraction
    return Fraction(str(a))


def boot_setup(inp, prefix, device=DEV):
    """The port's params, ``BootstrapContext`` and ciphertexts of
    ``prefix`` from the exported key stacks (every tower on the key
    tower's primes)."""
    from toyfhe_tpu_torch.core import ring as R
    g = lambda k: inp[f"{prefix}_{k}"]
    ring = R.make_ring(int(g("n")), [int(p) for p in g("primes")])
    params = T.HybridRaised(T.CKKSParams(ring, 0, 3.2, secret="sparse", hamming_weight=4),
                            int(g("dnum")), int(g("k")))
    radix = int(g("radix"))
    ctx = I.bootstrap_context(
        params, g("ek_masks"), g("ek_maskeds"), [int(e) for e in g("gk_el")], list(g("gk_masks")),
        list(g("gk_maskeds")), int(g("conj_el")), g("conj_masks"), g("conj_maskeds"),
        K=float(g("K")), deg=int(g("deg")), plan=(int(g("n")), radix) if radix else None,
        arcsin=bool(g("arcsin")), double_angle=int(g("double_angle")),
        scale_limbs=int(g("sl")), device=device)
    cts = [I.ciphertext(params, params.ring_cipher.select(range(int(g(f"ct{i}_nl")))),
                        g(f"ct{i}_duals"), _frac(g(f"ct{i}_scale")), device=device)
           for i in range(int(g("cts")))]
    return params, ctx, cts


class CallCounts:
    """While active, count the rotations ``rlwe.rotate_many`` makes and the
    calls of ``rlwe.rotate_sum``: one ModDown contraction each."""

    def __enter__(self):
        from toyfhe_tpu_torch.core import rlwe
        self.rlwe, self.orig = rlwe, (rlwe.rotate_many, rlwe.rotate_sum)
        self.many = self.sums = 0
        many, sums = self.orig

        def counted_many(gks, c, elements):
            self.many += len(list(elements))
            return many(gks, c, elements)

        def counted_sum(gks, terms):
            self.sums += 1
            return sums(gks, terms)

        rlwe.rotate_many, rlwe.rotate_sum = counted_many, counted_sum
        return self

    def __exit__(self, *exc):
        self.rlwe.rotate_many, self.rlwe.rotate_sum = self.orig


def _reset_counts(mesh):
    from toyfhe_tpu_torch.core import rlwe
    from toyfhe_tpu_torch.utils import metrics
    metrics.reset()
    for k in rlwe.hoist_counts:
        rlwe.hoist_counts[k] = 0
    mesh.comm.reset()


def predicted(calls: CallCounts, gathers: int) -> dict:
    """The collectives the counters of the same call predict: per unhoisted
    hybrid key switch one digit share and one ModDown exchange; per hoisted
    decomposition one digit share; per rotation of ``rotate_many`` and per
    ``rotate_sum`` one ModDown exchange (site ``rescale_broadcast``); per
    rescale one ``rescale_broadcast``; ``gathers`` level_gathers."""
    from toyfhe_tpu_torch.core import rlwe
    from toyfhe_tpu_torch.utils import metrics
    m, h = metrics.snapshot(), rlwe.hoist_counts
    unhoisted = m.get("keyswitch", 0) - h["key_product_calls"]
    return {"keyswitch_digit_share": unhoisted + h["decompose_calls"],
            "rescale_broadcast": unhoisted + calls.many + calls.sums + m.get("rescale", 0),
            "level_gather": gathers}


def _rows_held(sctx, rp) -> dict:
    """Each key and plain-cache tensor of this rank holds exactly its
    strided rows, at most ⌈rows/rp⌉ of its tower; their bytes."""
    from toyfhe_tpu_torch.core import ring as R
    ok, kb, cb = True, 0, 0
    for k in [sctx.ek.key, sctx.gk_conj.key] + [g.key for g in sctx.gks.keys]:
        for comp in k.key:
            for e in (comp.mask, comp.masked):
                for t in (e.primal, e.dual):
                    if t is not None:
                        ok &= t.shape[-2] == len(k.ring.held) <= -(-k.ring.nlimbs // rp)
                        kb += t.numel() * t.element_size()
    for key, e in sctx.plain_cache.items():
        ring = next(x for x in key if isinstance(x, R.RingContext))
        for t in (e.primal, e.dual):
            if t is not None:
                ok &= t.shape[-2] == len(ring.held) <= -(-ring.nlimbs // rp)
                cb += t.numel() * t.element_size()
    return {"rows_ok": bool(ok), "key_bytes": kb, "cache_bytes": cb,
            "cache_entries": len(sctx.plain_cache)}


def _ct_arrays(c):
    return I.ciphertext_to_numpy(c).astype(np.int64)


def _refresh(inp, prefix, rp, which="single"):
    from toyfhe_tpu_torch.core import bootstrap as B
    from toyfhe_tpu_torch.parallel import sharding as S
    mesh = S.make_mesh(rp, 1, device=DEV, ranks=range(rp))
    if not mesh.member:
        return None, {}
    _, ctx, cts = boot_setup(inp, prefix)
    sctx = S.shard_limbwise(ctx, mesh)
    scts = [S.shard_limbwise(c, mesh) for c in cts]
    _reset_counts(mesh)
    with CallCounts() as calls:
        if which == "single":
            out = {"out": B.bootstrap(sctx, scts[0])}
        elif which == "batched":
            out = {"out": B.bootstrap_batched(sctx, T.ct_stack(scts[:2]))}
        else:
            lo, hi = B.bootstrap_phase1(sctx, scts[0])
            out = {"lo": lo, "hi": hi}
    whole = {k: S.gather_limbwise(v) for k, v in out.items()}
    info = {"counts": {k: [v["kind"], v["count"]] for k, v in mesh.comm.snapshot().items()},
            "predicted": predicted(calls, 1 + len(out)),
            "held": list(out[next(iter(out))].ring.held),
            "scale": {k: str(v.enc.scale) for k, v in whole.items()},
            "nlimbs": {k: v.ring.nlimbs for k, v in whole.items()}, **_rows_held(sctx, rp)}
    return {k: _ct_arrays(v) for k, v in whole.items()}, info


def _engine_ops(inp, rp):
    """keyswitch, rotate, rotate_many, rotate_sum, ct_mul + relinearize,
    ct_rescale and ct_modswitch_drop on a full-tower ciphertext."""
    from toyfhe_tpu_torch.parallel import sharding as S
    mesh = S.make_mesh(rp, 1, device=DEV, ranks=range(rp))
    if not mesh.member:
        return None, {}
    _, ctx, cts = boot_setup(inp, "par")
    x = cts[-1]
    sctx, sx = S.shard_limbwise(ctx, mesh), S.shard_limbwise(x, mesh)
    _reset_counts(mesh)
    with CallCounts() as calls:
        out = engine_ops(sctx, sx)
    info = {"counts": {k: [v["kind"], v["count"]] for k, v in mesh.comm.snapshot().items()},
            "predicted": predicted(calls, 0)}
    return {k: _ct_arrays(S.gather_limbwise(v)) for k, v in out.items()}, info


def engine_ops(ctx, x) -> dict:
    """The engine operations the sharded tests hold, on ``ctx``'s keys."""
    from toyfhe_tpu_torch.core import rlwe
    gks = ctx.gks
    els = [k.galois_element for k in gks.keys]
    sq = T.ct_mul(x, x)
    many = rlwe.rotate_many(gks, x, els[:3])
    return {"keyswitch": T.keyswitch(ctx.ek, sq), "rotate": T.rotate(gks.keys[0], x),
            "conjugate": T.rotate(ctx.gk_conj, x),
            **{f"rotate_many_{e}": many[e] for e in els[:3]},
            "rotate_sum": rlwe.rotate_sum(gks, [(None, x), (els[0], x), (els[1], x)]),
            "mul_relin": T.ct_rescale(T.keyswitch(ctx.ek, sq)),
            "rescale": T.ct_rescale(x), "drop": T.ct_modswitch_drop(x)}


def case_boot_windowed_rp2(inp):
    """A multi-rank mesh on the windowed and per-limb gadgets raises."""
    from toyfhe_tpu_torch.parallel import sharding as S
    mesh = S.make_mesh(2, 1, device=DEV, ranks=range(2))
    if not mesh.member:
        return None, {}
    raised = {}
    for window in (4, 0):
        params = T.CKKSParams(T.make_rns_ring(32, (30, 26, 26, 26)), window, 3.2)
        gen = torch.Generator().manual_seed(3)
        kp = T.keygen(params, gen)
        ek, gk = T.keygen_eval_mult(gen, kp.priv), T.keygen_galois(gen, kp.priv, steps=1)
        c = T.encrypt(kp, T.make_plaintext(params.ring_cipher, np.ones(16) * 0.5, 2 ** 26), gen)
        sc, sek, sgk = (S.shard_limbwise(v, mesh) for v in (c, ek, gk))
        for name, fn in (("keyswitch", lambda: T.keyswitch(sek, T.ct_mul(sc, sc))),
                         ("rotate", lambda: T.rotate(sgk, sc)),
                         ("rotate_many", lambda: T.rotate_many(T.GaloisKeys([sgk]), sc,
                                                               [sgk.galois_element]))):
            try:
                fn()
                raised[f"{name}_w{window}"] = False
            except NotImplementedError:
                raised[f"{name}_w{window}"] = True
    return None, {"raised": raised}


for _r in (2, 3, 4):
    globals()[f"case_boot_refresh_rp{_r}"] = (lambda r: lambda inp: _refresh(inp, "par", r))(_r)
for _r in (2, 3):
    globals()[f"case_boot_ops_rp{_r}"] = (lambda r: lambda inp: _engine_ops(inp, r))(_r)


def case_boot_batched_rp3(inp):
    return _refresh(inp, "par", 3, "batched")


def case_boot_phase1_rp4(inp):
    return _refresh(inp, "dry", 4, "phase1")


def case_boot_composite_rp2(inp):
    return _refresh(inp, "cmp", 2)


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}
for _c in (2, 4, 8):
    CASES[f"coeff_fwd_{_c}"] = (lambda c: lambda inp: _coeff_forward(inp, c))(_c)
for _c in (2, 4):
    CASES[f"coeff_rt_{_c}"] = (lambda c: lambda inp: _coeff_roundtrip(inp, c))(_c)
for _c, _g in ((2, 3), (4, 3), (8, 3 ** 5), (4, 2 * 1024 - 1)):
    CASES[f"coeff_galois_{_c}_{_g}"] = (lambda c, g: lambda inp: _coeff_galois(inp, c, g))(_c, _g)
for _r, _c in ((2, 2), (2, 4), (4, 2)):
    CASES[f"step2axis_{_r}x{_c}"] = (lambda r, c: lambda inp: _step_2axis(inp, "s2a", 1, r, c))(
        _r, _c)


class _Arrays(dict):
    """An ``.npz`` file read whole, with the ``files`` of ``np.load``'s."""

    def __init__(self, z):
        super().__init__((k, z[k]) for k in z.files)
        self.files = list(z.files)


def _read(path) -> dict:
    with np.load(path) as z:
        return dict(z)


def run_cases(workdir: str, cases) -> dict:
    """Every named case on this rank; rank 0 keeps each case's arrays."""
    with np.load(Path(workdir) / "inputs.npz") as z:
        inp = _Arrays(z)
    info = {}
    for name in cases:
        arrays, info[name] = CASES[name](inp)
        if dist.get_rank() == 0 and arrays is not None:
            np.savez(Path(workdir) / f"{name}.npz",
                     **{k: I.to_numpy(v) if torch.is_tensor(v) else np.asarray(v)
                        for k, v in arrays.items()})
    return info


def spawn(workdir, inputs: dict, cases, world: int = 8, timeout_s: float = 600.0):
    """Write ``inputs``, run ``cases`` on ``world`` gloo ranks on the CPU;
    (rank 0's arrays by case, every rank's info by case)."""
    from toyfhe_tpu_torch.parallel import launch

    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    np.savez(work / "inputs.npz", **inputs)
    infos = launch.run_ranks("tests.torch_rank_cases:run_cases", world, work,
                             args={"cases": list(cases)}, timeout_s=timeout_s,
                             collective_timeout_s=timeout_s)
    arrays = {c: _read(work / f"{c}.npz") for c in cases if (work / f"{c}.npz").exists()}
    return arrays, [{c: info[c] for c in cases} for info in infos]
