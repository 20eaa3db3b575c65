"""The measurements behind the design of the fused hybrid key switch K3
(``csrc/hybrid_ks.cu``) and its launch chooser.

    python3 -m toyfhe_tpu_torch.tools.k3_experiments [shapes] [plans] [patches]

Needs a CUDA device. Every number is the device time of one launch in ms:
its share of a captured CUDA graph of 100 launches, replayed
(:func:`.bench_kernels.graph_ms`). Every timed variant is first held
bit-equal to the plain twin, except the knock-outs, which compute something
else on purpose.

``shapes``: every legal launch shape of the cluster kernel (the digits over
1, 2, 4 blocks; the polynomial over 2, 4) at the gadgets, ring degrees and batch sizes of :data:`SHAPES`. It is what
``hybrid_ks_cuda.choose_cluster`` is fitted to.

``plans``: other pass plans than ``ntt_cuda.schedule_plan``'s at N = 2^13.

``patches``: variants of the kernel's source (:data:`PATCHES`), built beside
the original and timed in turns with it at the serving shape: other batch
shapes of the load pass, and knock-outs that leave a part of a digit's work
out, to see what that part costs.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import cuda_lib, hybrid_ks
from ..ops import hybrid_ks_cuda as k3c
from .bench_kernels import graph_ms

# (tower bits, dnum, num_special, ct limbs): the encrypted-MNIST serving
# gadget and the dnum = 4 gadget of the reference's benchmark
MNIST_GADGET = ((28,) * 7 + (29,) * 4, 2, 4, 7)
DNUM4_GADGET = ((28,) * 7 + (29,) * 3, 4, 3, 7)
# (label, gadget, N, rows, ct limbs or None for the gadget's own)
SHAPES = (
    ("serving, R=4", MNIST_GADGET, 1 << 13, 4, None),
    ("dnum=4 gadget, R=4", DNUM4_GADGET, 1 << 13, 4, None),
    ("serving, R=16", MNIST_GADGET, 1 << 13, 16, None),
    ("serving cut to 3 ct limbs (one digit group), R=4", MNIST_GADGET, 1 << 13, 4, 3),
    ("serving at N=2^12, R=4", MNIST_GADGET, 1 << 12, 4, None),
    ("serving at N=2^12, R=16", MNIST_GADGET, 1 << 12, 16, None),
    ("serving at N=2^14, R=4", MNIST_GADGET, 1 << 14, 4, None),
    ("serving at N=2^14, R=16", MNIST_GADGET, 1 << 14, 16, None),
    ("serving at N=2^15, R=4", MNIST_GADGET, 1 << 15, 4, None),
)
PLANS = (((2, 2, 3, 3), 3), ((3, 3, 2, 2), 3), ((2, 3, 3, 3), 2), ((3, 3, 3, 2), 2))

_LOAD_U, _LOAD_A = "constexpr int kLoadU = 4;", "constexpr int kLoadA = 2;"
_Y_LOAD = "const longlong2 t = *reinterpret_cast<const longlong2*>(ya + i0);"
_KD_LOAD = "const uint2 d = __ldg(reinterpret_cast<const uint2*>(kdr + pos));"
_KM_LOAD = "const uint2 w = __ldg(reinterpret_cast<const uint2*>(kmr + pos));"
_PASSES = "for (int pl = k.plan; pl; pl >>= 2) {\n      const int kk"
_CLOSING = "if (i < per && pair < npairs) item(2 * pair, acc1[it], acc2[it]);"
_LIMBS = "for (int a0 = 0; a0 < width; a0 += kLoadA) {"
# name -> ((text of csrc/hybrid_ks.cu, its replacement), ...). k.dnum > 100
# is never true: it keeps the compiler from dropping what is left.
PATCHES = {
    "load 1 x 1": ((_LOAD_U, "constexpr int kLoadU = 1;"), (_LOAD_A, "constexpr int kLoadA = 1;")),
    "load 1 x 4": ((_LOAD_U, "constexpr int kLoadU = 1;"), (_LOAD_A, "constexpr int kLoadA = 4;")),
    "load 2 x 4": ((_LOAD_U, "constexpr int kLoadU = 2;"), (_LOAD_A, "constexpr int kLoadA = 4;")),
    "load 8 x 1": ((_LOAD_U, "constexpr int kLoadU = 8;"), (_LOAD_A, "constexpr int kLoadA = 1;")),
    "load 8 x 4": ((_LOAD_U, "constexpr int kLoadU = 8;"), (_LOAD_A, "constexpr int kLoadA = 4;")),
    "no y loads": ((_Y_LOAD, "const longlong2 t = make_longlong2(i0 + aa, u);"),),
    "one limb a digit": ((_LIMBS, "for (int a0 = 0; a0 < 1; a0 += kLoadA) {"),),
    "no in-place passes": ((_PASSES, _PASSES.replace("pl = k.plan", "pl = k.dnum > 100 ? k.plan : 0")),),
    "no closing pass": ((_CLOSING, _CLOSING.replace("pair < npairs", "pair < npairs && k.dnum > 100")),),
    "no key loads": ((_KD_LOAD, "const uint2 d = make_uint2(pos, 3);"),
                     (_KM_LOAD, "const uint2 w = make_uint2(5, pos);")),
}
KNOCK_OUTS = ("no y loads", "one limb a digit", "no in-place passes", "no closing pass",
              "no key loads")


def patched_source(name: str) -> str:
    """``csrc/hybrid_ks.cu`` with the replacements of ``PATCHES[name]``;
    raises if a text to replace is no longer in the source."""
    text = k3c.LIB.source.read_text()
    for old, new in PATCHES[name]:
        if old not in text:
            raise ValueError(f"patch {name!r}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def patched_library(name: str) -> cuda_lib.CudaLibrary:
    """The library of one patched source, written into the build directory."""
    stem = "hybrid_ks_" + "".join(c if c.isalnum() else "_" for c in name)
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source = cuda_lib.BUILD_DIR / f"{stem}.cu"
    source.write_text(patched_source(name))
    functions = {k: v for k, v in k3c.LIB.functions.items() if k != "toyfhe_cuda_error_string"}
    return cuda_lib.CudaLibrary(stem, functions, source=source)


def fixture(gadget, n: int, rows: int, lt, device, seed: int = 3):
    """A FusedHybridKS of ``gadget`` at ring degree ``n`` with uniform key
    duals from a numpy seed, and ŷ for ``rows`` rows."""
    import toyfhe_tpu_torch as T
    from ..utils import interop as I

    tower, dnum, k, lt0 = gadget
    lt = lt0 if lt is None else lt
    params = T.HybridRaised(T.CKKSParams(T.make_rns_ring(n, tower), 0, 3.2), dnum, k)
    key_ring = params.ring_key
    rng = np.random.default_rng(seed)
    shape, lim = (params.dnum, key_ring.nlimbs, key_ring.n), min(key_ring.primes)
    ek = I.eval_mult_key(params, rng.integers(0, lim, shape), rng.integers(0, lim, shape),
                         device=device)
    fks = hybrid_ks.FusedHybridKS(params, ek, lt=lt)
    y = I.tensor(np.stack([rng.integers(0, p, (rows, n)) for p in fks.ct_ring.primes], -2), device)
    return fks, y


def forget_launch_plans(fks) -> None:
    """Drop the launch arguments ``hybrid_ks_cuda.launch`` cached on ``fks``
    (they hold the library's functions and the pass plan)."""
    fks._dev = {k: v for k, v in fks._dev.items() if not (isinstance(k, tuple) and k[0] == "launch")}


def variant_ms(fks, y, variants=None, want=None) -> dict:
    """Device ms of each ``(scheme, cluster)`` of ``variants`` (default:
    every legal one), each first held bit-equal to ``want`` where that is
    given."""
    n, dnum = fks.exp_ring.n, fks.dnum_t
    if variants is None:
        variants = [(s, g) for s in k3c.SCHEMES for g in k3c.legal_clusters(n, dnum, s)]
    out = {}
    for scheme, g in variants:
        fn = lambda scheme=scheme, g=g: k3c.launch(fks, y, cluster=g, scheme=scheme)
        if want is not None:
            got = fn()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"K3 {scheme} {g} differs from the plain twin")
        out[f"{scheme} {g}"] = graph_ms(fn, 100)
    return out


def show(label: str, row: dict) -> None:
    print(f"{label}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)


def run_shapes(device) -> None:
    for label, gadget, n, rows, lt in SHAPES:
        fks, y = fixture(gadget, n, rows, lt, device)
        chosen = k3c.choose_cluster(rows * fks.exp_ring.nlimbs, n, fks.dnum_t, fks.exp_ring.primes)
        row = variant_ms(fks, y, want=hybrid_ks.fused_hybrid_ks_plain(fks, y))
        show(f"{label} (T={fks.exp_ring.nlimbs}, dnum_t={fks.dnum_t}; chooser: {chosen[0]} "
             f"{chosen[1]})", row)


def run_plans(device) -> None:
    planner = k3c.schedule_plan
    variants = [("digits", 1), ("digits", 2)]
    try:
        for label, gadget, n, rows, lt in SHAPES[:3]:
            fks, y = fixture(gadget, n, rows, lt, device)
            want = hybrid_ks.fused_hybrid_ks_plain(fks, y)
            for turn in range(2):
                for plan in (None,) + PLANS:
                    k3c.schedule_plan = lambda logn, c, plan=plan: (
                        plan if plan and c == 1 and logn == 13 else planner(logn, c))
                    forget_launch_plans(fks)
                    show(f"{label}, plan {plan or planner(13, 1)}", variant_ms(fks, y, variants, want))
    finally:
        k3c.schedule_plan = planner


def run_patches(device, names=tuple(PATCHES)) -> None:
    original = k3c.LIB
    libs = {"as committed": original, **{name: patched_library(name) for name in names}}
    cuda_lib.build_all(list(libs.values()))
    for name, lib in libs.items():
        spills = [ln.strip() for ln in lib.build_info.get("log", "").splitlines()
                  if "spill" in ln and " 0 bytes spill stores" not in ln]
        print(f"{name}: nvcc {lib.build_info.get('seconds', 0.0):.1f} s, spills {spills}")
    variants = [("digits", 1), ("digits", 2), ("poly", 2)]
    try:
        for label, gadget, n, rows, lt in SHAPES[:3]:
            fks, y = fixture(gadget, n, rows, lt, device)
            want = hybrid_ks.fused_hybrid_ks_plain(fks, y)
            order = list(libs) + list(libs)[::-1]                # in turns: there and back
            for name in order:
                k3c.LIB = libs[name]
                forget_launch_plans(fks)
                show(f"{label}, {name}",
                     variant_ms(fks, y, variants, None if name in KNOCK_OUTS else want))
    finally:
        k3c.LIB = original


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    runs = {"shapes": run_shapes, "plans": run_plans, "patches": run_patches}
    ap.add_argument("what", nargs="*", help=f"any of {', '.join(runs)} (default: all)")
    args = ap.parse_args(argv)
    unknown = [w for w in args.what if w not in runs]
    if unknown:
        ap.error(f"unknown experiment {unknown[0]!r}")
    if not torch.cuda.is_available():
        raise SystemExit("k3_experiments: no CUDA device available")
    device = torch.device("cuda", 0)
    import subprocess
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for what in args.what or list(runs):
        print(f"== {what}: device ms of one launch (graph replay of 100)", flush=True)
        runs[what](device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
