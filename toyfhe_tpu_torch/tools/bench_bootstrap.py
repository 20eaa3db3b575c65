"""One CKKS refresh on the card at a recipe of the reference's bootstrap bench.

    python3 -m toyfhe_tpu_torch.tools.bench_bootstrap [logN] [radix] [h] [dnum]
                                                      [batch] [kmargin] [sl]
        (defaults: 11 16 8 0 1 1.5 1; --reps R, --seed S, --device cuda|cpu)

The parameters are derived as ``tools/bench_bootstrap.py`` derives them:
K = (1 + h)/2 + kmargin, a direct-sine EvalMod of degree ⌊2πK⌋ + 22 with the
arcsine correction, the factored transforms of ``radix``; sl = 1 is 24
level limbs of 29 bits at scale 2^27, sl = 2 the composite tower
``bootstrap.make_boot_ring(N, 46, k)`` at scale 2^52; dnum = 0 the
``ModulusRaised`` gadget with one raising prime, dnum > 0 ``HybridRaised``
with ⌈L/dnum⌉ + 1 raising primes. Keys and data come from ``--seed`` on
the device. Prints the card's name and power limit, the setup time, the
cold refresh (which encodes the transform diagonals), the warm refresh
(median of ``--reps``) with its three phases, the limbs regained and the
largest error against the input; ``batch`` > 1 refreshes that many
ciphertexts in one ``bootstrap_batched`` call and reports milliseconds per
refresh. The last line is one JSON object with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from fractions import Fraction

import numpy as np
import torch


def make_params(n: int, h: int, dnum: int, sl: int):
    """(params, scale, base limbs) of the reference bench's recipe."""
    from .. import CKKSParams, HybridRaised, ModulusRaised, make_rns_ring
    from ..core import bootstrap as B

    L = 24 if sl == 1 else 46
    lct = L + 2 if sl == 2 else L
    k = (-(-lct // dnum) + 1) if dnum else 1
    if sl == 2:
        ring = B.make_boot_ring(n, L=L, num_special=k)
    else:
        ring = make_rns_ring(n, (29,) * (L + 1) + ((29,) * k if dnum else ()))
    base = CKKSParams(ring, 0, 3.2, secret="sparse", hamming_weight=h)
    params = HybridRaised(base, dnum, k) if dnum else ModulusRaised(base)
    return params, (Fraction(2) ** 52 if sl == 2 else Fraction(2) ** 27), (2 if sl == 2 else 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for name, kind, default in (("logn", int, 11), ("radix", int, 16), ("h", int, 8),
                                ("dnum", int, 0), ("batch", int, 1), ("kmargin", float, 1.5),
                                ("sl", int, 1)):
        ap.add_argument(name, type=kind, nargs="?", default=default)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_bootstrap: no CUDA device available")
    from .. import ct_index, ct_stack, decrypt, encrypt, keygen
    from ..core import bootstrap as B
    from ..core import ckks_encoding as CE

    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    card = "cpu"
    if device.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[device.index or 0]
    print(f"card: {card}", flush=True)
    n, nb = 1 << args.logn, max(args.batch, 1)
    K = (1 + args.h) / 2 + args.kmargin
    deg = int(2 * np.pi * K) + 22
    params, scale, base_limbs = make_params(n, args.h, args.dnum, args.sl)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    kp = keygen(params, gen)
    ctx = B.setup_bootstrap(gen, kp.priv, K=K, deg=deg, radix=args.radix, arcsin=True,
                            scale_limbs=args.sl)
    sync()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed)
    vals = [(rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)) * 0.7
            for _ in range(nb)]
    cts = [CE.ct_drop_to(encrypt(kp, CE.make_plaintext(params.ring_cipher, v, scale), gen),
                         base_limbs) for v in vals]
    c = cts[0] if nb == 1 else ct_stack(cts)
    print(f"N=2^{args.logn} radix={args.radix} h={args.h} K={K} deg={deg} sl={args.sl} "
          f"limbs={params.params.ring_cipher.nlimbs} dnum={args.dnum} batch={nb} "
          f"rotkeys={len(ctx.gks.keys)} setup {setup_s:.2f} s on {device}", flush=True)

    t0 = time.perf_counter()
    out = B.bootstrap_batched(ctx, c)
    sync()
    cold_ms = (time.perf_counter() - t0) * 1e3
    walls, phases = [], []
    for _ in range(args.reps):
        marks = [time.perf_counter()]
        lo, hi = B.bootstrap_phase1(ctx, c)
        sync()
        marks.append(time.perf_counter())
        ev = B.bootstrap_phase2(ctx, lo, hi)
        sync()
        marks.append(time.perf_counter())
        B.bootstrap_phase3(ctx, ev, *B._phase3_statics(ctx, c))
        sync()
        marks.append(time.perf_counter())
        phases.append([(b - a) * 1e3 for a, b in zip(marks, marks[1:])])
        walls.append((marks[-1] - marks[0]) * 1e3)
    outs = [out] if nb == 1 else [ct_index(out, i) for i in range(nb)]
    err = max(float(np.max(np.abs(decrypt(kp, o) - v))) for o, v in zip(outs, vals))
    warm = float(np.median(walls))
    split = {name: float(np.median([p[i] for p in phases]))
             for i, name in enumerate(("modraise_c2s", "evalmod", "s2c"))}
    print(f"cold {cold_ms:.1f} ms; warm {warm:.1f} ms (median of {args.reps}: "
          f"{', '.join(f'{w:.1f}' for w in walls)}), {warm / nb:.1f} ms per refresh; phases "
          + ", ".join(f"{k} {v:.1f}" for k, v in split.items()), flush=True)
    print(f"{out.ring.nlimbs} limbs out, max abs error {err:.3e}", flush=True)
    print(json.dumps({"card": card, "logn": args.logn, "radix": args.radix, "h": args.h, "dnum": args.dnum,
                      "batch": nb, "K": K, "deg": deg, "sl": args.sl, "setup_s": setup_s,
                      "cold_ms": cold_ms, "warm_ms": warm, "ms_per_refresh": warm / nb,
                      "phases_ms": split, "limbs_out": out.ring.nlimbs, "max_abs_err": err}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
