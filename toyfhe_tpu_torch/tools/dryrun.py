"""Dry runs of the sharded paths on spawned ranks.

    python -m toyfhe_tpu_torch.tools.dryrun multichip N [--device cpu|cuda]
    python -m toyfhe_tpu_torch.tools.dryrun multihost [HOSTS [RANKS_PER_HOST]] [--device ...]

``dryrun_multichip(n)`` runs N ranks (the reference's N devices) and, at
tiny shapes, every sharded flavour over a ('dp', 'rp') mesh — the per-limb
step, the hybrid step in both schedules, the sharded MNIST pipeline — and
the ('dp', 'rp', 'cp') step when 4 divides N; each is held bit-equal to
the single-device step, which every rank computes too; and the refresh
flavour: ``bootstrap_phase1`` (ModRaise → CoeffToSlot) at N = 16 on 8 + 4
limbs with keys and ciphertext placed limb-wise over rp 4 (all ranks when
fewer), bit-equal to the single-device phase. ``dryrun_multihost(h, r)``
runs h "hosts" of r
ranks each (``LOCAL_WORLD_SIZE`` = r), 'dp' across the hosts and 'rp'
inside each, and holds the per-limb step bit-equal to the single-device
step.

Every rank runs on ``device``: several ranks share one GPU through gloo.
The parent builds the kernels first. Each call returns every rank's
report and raises if a rank fails or disagrees.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch

DRY_N = 32            # the reference's dry-run ring
LIMBS_PER_SHARD = 2


def _synthetic(shape, primes, seed):
    return np.random.default_rng(seed).integers(0, min(primes), shape)


def _k1_launches():
    from ..ops import ntt_cuda
    return dict(ntt_cuda.launches)


def _per_limb(mesh, n_rp, n_dp, seed, device):
    """The per-limb step over ``mesh``, bit-equal to the single-device step."""
    from .. import make_rns_ring
    from ..parallel import ops as pops
    from ..parallel import sharding as S

    L = n_rp * LIMBS_PER_SHARD
    ring = make_rns_ring(DRY_N, (28,) * L)
    km = _synthetic((L, L, DRY_N), ring.primes, seed)
    kd = _synthetic((L, L, DRY_N), ring.primes, seed + 1)
    batch = _synthetic((2 * n_dp, 2, L, DRY_N), ring.primes, seed + 2)
    step, place = pops.make_sharded_step(mesh, ring.tables, km, kd)
    mesh.comm.reset()
    out = step(place(batch))
    counts = mesh.comm.snapshot()
    got = S.unshard(out, pops.DATA_SPEC, mesh)
    single = pops.make_single_chip_step(ring.tables, torch.as_tensor(km, device=device),
                                        torch.as_tensor(kd, device=device))
    want = single(torch.as_tensor(batch, device=device))
    ok = bool(torch.equal(got, want)) and bool((got[:, :, -1] == 0).all())
    return {"ok": ok and bool(got[:, :, :L - 1].any()), "L": L, "shape": list(got.shape),
            "counts": counts}


def _hybrid(mesh, n_rp, n_dp, device):
    """The hybrid step, v1 and the fused schedule, over ``mesh``."""
    from .. import CKKSParams, HybridRaised, make_rns_ring
    from ..parallel import ops as pops
    from ..parallel import sharding as S
    from ..utils import interop as I

    L = n_rp * LIMBS_PER_SHARD
    ring = make_rns_ring(DRY_N, (28,) * L + (30, 30))
    params = HybridRaised(CKKSParams(ring, 0, 3.2), max(1, L // 2), 2)
    kr = params.ring_key
    shape = (params.dnum, kr.nlimbs, DRY_N)
    ek = I.eval_mult_key(params, _synthetic(shape, kr.primes, 11), _synthetic(shape, kr.primes, 12),
                         device=device)
    batch = _synthetic((2 * n_dp, 2, L, DRY_N), params.ring_cipher.primes, 13)
    single, splace = pops.make_hybrid_sharded_step(None, params, ek)
    want = single(splace(batch))
    out = {}
    for name, fused in (("v1", False), ("fused_schedule", True)):
        step, place = pops.make_hybrid_sharded_step(mesh, params, ek, fused_schedule=fused)
        got = S.unshard(step(place(batch)), pops.DATA_SPEC, mesh)
        out[name] = bool(torch.equal(got, want))
    return {"ok": all(out.values()), "dnum": params.dnum, **out}


def _pipeline(mesh, device):
    """The sharded MNIST pipeline at a tiny geometry: its logits ciphertext
    bit-equal to the single-device pipeline's on the same keys."""
    from ..models import mnist as M

    cfg = M.MNISTConfig(image=8, kernel=4, stride=4, channels=2, classes=4, ring_logn=6)
    setup = M.fhe_setup(cfg, torch.Generator(device).manual_seed(2))
    gks = M.keygen_matmul_bsgs(setup, torch.Generator(device).manual_seed(9))
    params = M.init_params(cfg, 3)
    imgs = np.random.default_rng(4).uniform(0.0, 1.0, (cfg.batch, cfg.image, cfg.image))
    run = lambda **kw: M.build_inference_pipeline(setup, params, gks, **kw)(
        imgs, torch.Generator(device).manual_seed(6), _return_ct=True)
    ref = run()
    mesh.comm.reset()
    got = run(mesh=mesh)
    counts = mesh.comm.snapshot()
    ok = all(torch.equal(a.dual, b.dual) for a, b in zip(got.cs, ref.cs))
    return {"ok": ok, "cts": cfg.kernel * cfg.kernel, "counts": counts}


def _three_axis(n, device):
    """The dp × rp × cp step (rp × cp when 8 does not divide n)."""
    from .. import make_rns_ring
    from ..ops import ntt_mxu as MX
    from ..parallel import ops as pops
    from ..parallel import sharding as S

    n_dp = 2 if n % 8 == 0 else 1
    n_rp, n_cp = 2, n // (2 * n_dp)
    L = n_rp * LIMBS_PER_SHARD
    nr = 128 * 2 * n_cp
    ring = make_rns_ring(nr, (28,) * L)
    km = _synthetic((L, L, nr), ring.primes, 21)
    kd = _synthetic((L, L, nr), ring.primes, 22)
    batch = _synthetic((2 * n_dp, 2, L, nr), ring.primes, 23)
    mesh = S.Mesh(("dp", "rp", "cp"), (n_dp, n_rp, n_cp), device=device)
    step, place, (_, out_nat) = pops.make_2axis_step(mesh, MX.MxuNttTables(ring.tables), km, kd,
                                                     n_cp=n_cp, dp=n_dp > 1)
    got = S.unshard(step(place(batch)), ("dp" if n_dp > 1 else None, None, "rp", "cp"), mesh)
    nat = torch.zeros_like(got)
    nat[..., torch.as_tensor(out_nat, device=got.device)] = got
    want = pops.make_single_chip_step(ring.tables, torch.as_tensor(km, device=device),
                                      torch.as_tensor(kd, device=device))(
        torch.as_tensor(batch, device=device))
    return {"ok": bool(torch.equal(nat, want)), "mesh": [n_dp, n_rp, n_cp], "N": nr, "L": L}


REFRESH_N = 16          # the reference dry run's refresh: N = 16, 8 + 4 limbs of 30 bits
REFRESH_SEED = 5


def _refresh(n: int, device) -> dict:
    """``bootstrap_phase1`` with keys and ciphertext placed limb-wise over
    rp 4 (the first ``n`` ranks when fewer): both halves bit-equal to the
    single-device phase. The keys come from one seed, alike on every rank."""
    from fractions import Fraction
    from .. import CKKSParams, HybridRaised, encrypt, keygen, make_plaintext, make_rns_ring
    from ..core import bootstrap as B, ckks_encoding as CE, ring as R
    from ..parallel import sharding as S

    rp = min(4, n)
    mesh = S.make_mesh(rp, 1, device=device, ranks=range(rp))
    if not mesh.member:
        return {"ok": True, "member": False}
    ring = make_rns_ring(REFRESH_N, (30,) * 12)
    params = HybridRaised(CKKSParams(ring, 0, 3.2, secret="sparse", hamming_weight=4), 4, 4)
    gen = torch.Generator(device).manual_seed(REFRESH_SEED)
    kp = keygen(params, gen)
    ctx = B.setup_bootstrap(gen, kp.priv, K=5.0, deg=8)
    rng = np.random.default_rng(REFRESH_SEED)
    vals = (rng.uniform(-1, 1, REFRESH_N // 2) + 1j * rng.uniform(-1, 1, REFRESH_N // 2)) * 0.7
    c = CE.ct_drop_to(encrypt(kp, make_plaintext(params.ring_cipher, vals, Fraction(2) ** 27),
                              gen), 1)
    want = B.bootstrap_phase1(ctx, c)
    mesh.comm.reset()
    got = S.gather_limbwise(B.bootstrap_phase1(S.shard_limbwise(ctx, mesh),
                                               S.shard_limbwise(c, mesh)))
    counts = mesh.comm.snapshot()
    dual = lambda c: [R.ensure_dual(c.ring, x).dual for x in c.cs]
    ok = all(a.ring is b.ring and a.enc == b.enc
             and all(torch.equal(x, y) for x, y in zip(dual(a), dual(b)))
             for a, b in zip(got, want))
    return {"ok": ok, "member": True, "rp": rp, "limbs": ring.nlimbs,
            "held": list(R.shard_view(params.ring_cipher, mesh).held), "counts": counts}


def multichip_rank(workdir: str, n: int, device: str) -> dict:
    """One rank of :func:`dryrun_multichip`."""
    import torch.distributed as dist
    from ..parallel import sharding as S

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
    n_dp = 2 if n % 2 == 0 and n > 2 else 1
    n_rp = n // n_dp
    mesh = S.make_mesh(n_rp, n_dp, device=device)
    k1 = _k1_launches()
    report = {"rank": dist.get_rank(), "mesh": [n_dp, n_rp],
              "per_limb": _per_limb(mesh, n_rp, n_dp, 0, device),
              "hybrid": _hybrid(mesh, n_rp, n_dp, device),
              "pipeline": _pipeline(mesh, device),
              "refresh": _refresh(n, device)}
    if n % 4 == 0:
        report["three_axis"] = _three_axis(n, device)
    after = _k1_launches()
    report["k1_launches"] = {k: after[k] - k1[k] for k in after}
    return report


def multihost_rank(workdir: str, hosts: int, per_host: int, device: str) -> dict:
    """One rank of :func:`dryrun_multihost`."""
    import torch.distributed as dist
    from ..parallel import distributed as D

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
    mesh = D.make_hybrid_mesh(n_rp=per_host, n_dp=hosts, device=device)
    host = dist.get_rank() // per_host
    rp_line = [mesh.ranks[mesh.coords["dp"] * per_host + j] for j in range(per_host)]
    report = _per_limb(mesh, per_host, hosts, 3, device)
    report.update(rank=dist.get_rank(), host=host, coords=mesh.coords,
                  rp_in_one_host=len({r // per_host for r in rp_line}) == 1)
    report["ok"] = report["ok"] and report["rp_in_one_host"]
    return report


def _run(target: str, world: int, args: dict, device: str, env=None) -> list:
    from ..parallel import launch

    launch.prebuild(torch.device(device).type == "cuda")
    with tempfile.TemporaryDirectory(prefix="toyfhe_dryrun_") as work:
        reports = launch.run_ranks(target, world, work, args=dict(args, device=device),
                                   timeout_s=900.0, env=env)
    return reports


def _check(reports: list, keys) -> None:
    for rep in reports:
        bad = [k for k in keys if k in rep and not rep[k]["ok"]]
        if bad:
            raise AssertionError(f"rank {rep['rank']}: {bad} disagree with the single device: "
                                 f"{json.dumps(rep)[:2000]}")


def dryrun_multichip(n_devices: int, *, device) -> list:
    """Every sharded flavour over ``n_devices`` ranks on ``device``; the
    ranks' reports (each flavour's ``ok``, collective counts, K1 launches)."""
    reports = _run("toyfhe_tpu_torch.tools.dryrun:multichip_rank", n_devices,
                   {"n": n_devices}, str(device))
    _check(reports, ("per_limb", "hybrid", "pipeline", "three_axis", "refresh"))
    return reports


def dryrun_multihost(n_hosts: int = 2, ranks_per_host: int = 2, *, device) -> list:
    """The per-limb step with 'dp' across ``n_hosts`` hosts of
    ``ranks_per_host`` ranks and 'rp' inside each, bit-equal to the
    single-device step on every rank; the ranks' reports."""
    reports = _run("toyfhe_tpu_torch.tools.dryrun:multihost_rank", n_hosts * ranks_per_host,
                   {"hosts": n_hosts, "per_host": ranks_per_host}, str(device),
                   env={"LOCAL_WORLD_SIZE": str(ranks_per_host)})
    bad = [r for r in reports if not r["ok"]]
    if bad:
        raise AssertionError(f"multihost dry run disagrees: {json.dumps(bad)[:2000]}")
    return reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", choices=("multichip", "multihost"))
    ap.add_argument("sizes", type=int, nargs="*")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    if a.which == "multichip":
        reports = dryrun_multichip(*(a.sizes or [8]), device=a.device)
    else:
        reports = dryrun_multihost(*(a.sizes or [2, 2]), device=a.device)
    for rep in reports:
        print(json.dumps(rep))
    print(f"dryrun_{a.which} OK on {a.device}: {len(reports)} ranks, bit-equal, "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
