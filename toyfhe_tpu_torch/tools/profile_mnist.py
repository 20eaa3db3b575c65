"""Where one encrypted-MNIST batch spends its time on the card.

    python3 -m toyfhe_tpu_torch.tools.profile_mnist [--schedule iterated|bsgs|both|bootstrapped]
                                                    [--compiled]

Builds the serving pipeline at ``MNISTConfig()`` with seeded random weights
and images, warms it up, and runs one batch under ``torch.profiler``. For
each schedule (the iterated rotation loop, the BSGS dense layers with the
dual flow, or the bootstrapped pipeline of ``mnist.BOOTSTRAPPED_RECIPE``)
it prints the batch's wall time without the profiler, the profiled window,
the number of device kernels, the device-busy time and its share of the
unprofiled batch, and the kernels grouped by name; for the bootstrapped
pipeline, the same for one refresh alone. The pipelines run eagerly;
``--compiled`` runs their compiled stages (one CUDA graph a stage,
replayed) and the refresh as one compiled ``bootstrap``. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict

import numpy as np
import torch

GROUPS = (("ntt_cluster_kernel", "K1 transforms"), ("elementwise", "elementwise"),
          ("reduce", "reductions"), ("index", "gathers"), ("gather", "gathers"),
          ("Cat", "concatenations"), ("cat", "concatenations"), ("copy", "copies"))


def group_of(name: str) -> str:
    for needle, label in GROUPS:
        if needle in name:
            return label
    return "other"


def profile_batch(run, imgs, gen, device) -> dict:
    """One warm batch under the profiler: kernels, device time by group."""
    from torch.profiler import ProfilerActivity, profile

    run(imgs, gen)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    run(imgs, gen)
    torch.cuda.synchronize(device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(imgs, gen)
        torch.cuda.synchronize(device)
        window_ms = (time.perf_counter() - t0) * 1e3
    count, busy_us = 0, 0.0
    by_group = defaultdict(lambda: [0, 0.0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = ev.device_time
            count += 1
            busy_us += us
            g = by_group[group_of(ev.name)]
            g[0] += 1
            g[1] += us
    return {"wall_ms": wall_ms, "window_ms": window_ms, "kernels": count,
            "busy_ms": busy_us / 1e3,
            "groups": {k: (c, us / 1e3) for k, (c, us) in by_group.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--schedule", choices=("iterated", "bsgs", "both", "bootstrapped"),
                    default="both")
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--compiled", action="store_true",
                    help="replay the pipelines' CUDA graphs instead of running them eagerly")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_mnist: no CUDA device available")
    from ..models import mnist as M

    device = torch.device("cuda", 0)
    cfg = M.MNISTConfig()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    weights = M.init_params(cfg, args.seed)
    imgs = np.random.default_rng(args.seed).uniform(0.0, 1.0, (cfg.batch, cfg.image, cfg.image))
    print(f"device={torch.cuda.get_device_name(device)} N=2^{cfg.ring_logn} "
          f"batch={cfg.batch} {'compiled' if args.compiled else 'eager'}", flush=True)
    eager = not args.compiled
    if args.schedule == "bootstrapped":
        import functools

        from ..core import bootstrap as B
        from ..utils import graphs
        setup, ctx = M.fhe_setup_bootstrapped(cfg, gen, **M.BOOTSTRAPPED_RECIPE)
        run = M.build_bootstrapped_pipeline(setup, ctx, weights,
                                            prescale=M.BOOTSTRAPPED_PRESCALE, eager=eager)
        report("bootstrapped batch", profile_batch(run, imgs, gen, device))
        vals = np.random.default_rng(args.seed).uniform(-0.7, 0.7, cfg.positions * cfg.batch)
        c = encrypt_exhausted(setup, vals, gen)
        refresh = functools.partial(B.bootstrap, ctx)
        refresh = refresh if eager else graphs.jit(refresh)
        report("one refresh", profile_batch(lambda *_: refresh(c), None, None, device))
        return 0
    setup = M.fhe_setup(cfg, gen)
    for schedule in (("iterated", "bsgs") if args.schedule == "both" else (args.schedule,)):
        gks = M.keygen_matmul_bsgs(setup, gen) if schedule == "bsgs" else None
        run = M.build_inference_pipeline(setup, weights, gks_bsgs=gks, eager=eager)
        report(schedule, profile_batch(run, imgs, gen, device))
    return 0


def encrypt_exhausted(setup, vals, gen):
    """An encryption of ``vals`` at the composite base scale 2^52, exhausted
    to the two base limbs: a refresh's input."""
    from fractions import Fraction

    from ..core import ckks_encoding as CE
    from ..core import rlwe
    ring = setup.params.ring_cipher
    c = rlwe.encrypt(setup.kp, CE.make_plaintext(ring, vals, Fraction(2) ** 52), gen)
    return CE.ct_drop_to(c, 2)


def report(what: str, res: dict) -> None:
    print(f"{what}: {res['wall_ms']:.1f} ms unprofiled, {res['window_ms']:.1f} ms "
          f"profiled; {res['kernels']} device kernels, device busy {res['busy_ms']:.2f} ms "
          f"= {100 * res['busy_ms'] / res['wall_ms']:.1f}% of the unprofiled run "
          f"(idle {100 - 100 * res['busy_ms'] / res['wall_ms']:.1f}%)", flush=True)
    for name, (c, ms) in sorted(res["groups"].items(), key=lambda kv: -kv[1][1]):
        print(f"  {name:<16} {c:6d} kernels {ms:9.2f} ms", flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
