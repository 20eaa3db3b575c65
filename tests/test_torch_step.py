"""toyfhe_tpu_torch square → relinearize → rescale step against the
reference's ``make_single_chip_step``: on ``__graft_entry__``'s synthetic
operands, and on real reference keys, where it also decrypts to the
squares. Plus: importing the port leaves jax unloaded."""

import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import toyfhe_tpu as F
import toyfhe_tpu_torch as T
from toyfhe_tpu.core import ring as ref_ring
from toyfhe_tpu.parallel import ops as ref_ops
from toyfhe_tpu_torch.parallel import ops as pops
from toyfhe_tpu_torch.utils import interop as I

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def test_step_matches_reference_entry_operands():
    """Synthetic operands made as ``__graft_entry__.entry()`` makes them, at
    N=256, L=4, B=2."""
    n, L, B = 256, 4, 2
    tower = (30, 29, 29, 28)
    ring, tring = F.make_rns_ring(n, tower), T.make_rns_ring(n, tower)
    rng = np.random.default_rng(0)
    lim = min(ring.primes)
    masks = rng.integers(0, lim, (L, L, n)).astype(np.uint32)
    maskeds = rng.integers(0, lim, (L, L, n)).astype(np.uint32)
    batch = rng.integers(0, lim, (B, 2, L, n)).astype(np.uint32)
    want = np.asarray(ref_ops.make_single_chip_step(
        ring.tables, jnp.asarray(masks), jnp.asarray(maskeds))(jnp.asarray(batch)))
    step = pops.make_single_chip_step(tring.tables, I.tensor(masks, "cpu"), I.tensor(maskeds, "cpu"))
    got = step(I.tensor(batch, "cpu"))
    assert got.shape == (B, 2, L, n)
    np.testing.assert_array_equal(I.to_numpy(got), want)


@pytest.fixture(scope="module")
def setup():
    """The reference's real-key fixture (tests/test_parallel.py): N=64, L=4,
    B=2, keys from PRNGKey(0), values vals·(i+1) at scale 2^45."""
    N, B = 64, 2
    ring = F.make_rns_ring(N, (30, 29, 29, 28))
    params = F.CKKSParams(ring, 0, 3.2)
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    kp = F.keygen(params, ks[0])
    ek = F.keygen_eval_mult(ks[1], kp.priv)
    vals = np.linspace(0.1, 1.0, N // 2)
    scale = Fraction(2) ** 45
    cts = [F.encrypt(kp, F.make_plaintext(ring, vals * (i + 1), scale), k)
           for i, k in enumerate(jax.random.split(ks[2], B))]
    dual = lambda x: np.asarray(ref_ring.ensure_dual(ring, x).dual)
    masks = np.stack([dual(kc.mask) for kc in ek.key.key])
    maskeds = np.stack([dual(kc.masked) for kc in ek.key.key])
    batch = np.stack([np.stack([dual(x) for x in c.cs]) for c in cts])
    want = np.asarray(ref_ops.make_single_chip_step(
        ring.tables, jnp.asarray(masks), jnp.asarray(maskeds))(jnp.asarray(batch)))

    tring = T.make_rns_ring(N, (30, 29, 29, 28))
    tparams = T.CKKSParams(tring, 0, 3.2)
    tkp = I.priv_key(tparams, np.asarray(kp.priv.secret.primal), device="cpu")
    tek = I.eval_mult_key(tparams, masks, maskeds, device="cpu")
    step = pops.make_single_chip_step(tring.tables, I.tensor(masks, "cpu"), I.tensor(maskeds, "cpu"))
    got = step(I.tensor(batch, "cpu"))
    return dict(tring=tring, tparams=tparams, tkp=tkp, tek=tek, batch=batch,
                want=want, got=got, vals=vals, scale=scale)


def test_step_matches_reference_real_keys(setup):
    np.testing.assert_array_equal(I.to_numpy(setup["got"]), setup["want"])
    assert not setup["got"][:, :, -1].any()              # dropped limb zeroed


def test_step_matches_sequential_engine(setup):
    """The step equals ct_rescale(keyswitch(ek, ct_mul(c, c))) of the port's
    own engine on the surviving limbs."""
    tring, tparams, got = setup["tring"], setup["tparams"], setup["got"]
    L = tring.nlimbs
    for i, duals in enumerate(setup["batch"]):
        c = I.ciphertext(tparams, tring, duals, setup["scale"], device="cpu")
        seq = T.ct_rescale(T.keyswitch(setup["tek"], T.ct_mul(c, c)))
        np.testing.assert_array_equal(I.ciphertext_to_numpy(seq),
                                      I.to_numpy(got[i, :, :L - 1]))


def test_step_decrypts(setup):
    """Decoded squares within 2e-4 — the tolerance of the reference's
    test_sharded_step_decrypts (rescale rounding and relinearization noise
    at scale 2^90/q_last ≈ 2^62 are far below it)."""
    tring, got = setup["tring"], setup["got"]
    sub = tring.drop_last()
    new_scale = setup["scale"] ** 2 / tring.primes[-1]
    for i in range(got.shape[0]):
        cs = tuple(T.RingElt(dual=got[i, j, :tring.nlimbs - 1]) for j in range(2))
        c = T.CipherText(setup["tparams"], cs, sub, enc=T.CKKSTag(new_scale))
        np.testing.assert_allclose(T.decrypt(setup["tkp"], c).real,
                                   (setup["vals"] * (i + 1)) ** 2, atol=2e-4)


def test_port_import_leaves_jax_out():
    code = ("import sys, toyfhe_tpu_torch, toyfhe_tpu_torch.parallel.ops, "
            "toyfhe_tpu_torch.ops.ntt_cuda, toyfhe_tpu_torch.core.hybrid, "
            "toyfhe_tpu_torch.ops.hybrid_ks, toyfhe_tpu_torch.ops.hybrid_ks_cuda, "
            "toyfhe_tpu_torch.ops.cuda_lib, toyfhe_tpu_torch.core.modraise, "
            "toyfhe_tpu_torch.ops.ntt_pallas, toyfhe_tpu_torch.ops.ntt_pallas_cuda, "
            "toyfhe_tpu_torch.ops.pallas_keyswitch, "
            "toyfhe_tpu_torch.ops.pallas_keyswitch_cuda, "
            "toyfhe_tpu_torch.parallel.layers, toyfhe_tpu_torch.models.mnist, "
            "toyfhe_tpu_torch.ops.ntt_mxu, toyfhe_tpu_torch.ops.ntt_mxu_pallas, "
            "toyfhe_tpu_torch.ops.ntt_mxu_pallas_cuda, toyfhe_tpu_torch.core.bootstrap, "
            "toyfhe_tpu_torch.core.sfft, toyfhe_tpu_torch.core.ckks_encoding, "
            "toyfhe_tpu_torch.utils.interop, toyfhe_tpu_torch.utils.numtheory, "
            "toyfhe_tpu_torch.tools.bench_kernels, toyfhe_tpu_torch.tools.profile_mnist, "
            "toyfhe_tpu_torch.tools.bench_bootstrap, toyfhe_tpu_torch.core.bfv, "
            "toyfhe_tpu_torch.core.behz, toyfhe_tpu_torch.core.bgv, toyfhe_tpu_torch.core.plain, "
            "toyfhe_tpu_torch.core.noise, toyfhe_tpu_torch.core.planner, "
            "toyfhe_tpu_torch.core.cryptparams, toyfhe_tpu_torch.core.insecure, "
            "toyfhe_tpu_torch.native, toyfhe_tpu_torch.core.generic_ring, "
            "toyfhe_tpu_torch.core.polycrt, toyfhe_tpu_torch.core.host_engine, "
            "toyfhe_tpu_torch.core.refparams, toyfhe_tpu_torch.core.golden, "
            "toyfhe_tpu_torch.utils.serialization, toyfhe_tpu_torch.utils.metrics, "
            "toyfhe_tpu_torch.parallel.sharding, toyfhe_tpu_torch.parallel.distributed, "
            "toyfhe_tpu_torch.parallel.launch, toyfhe_tpu_torch.tools.dryrun, chip_smoke; "
            "from toyfhe_tpu_torch.core import bootstrap as B; "
            "from toyfhe_tpu_torch.models import mnist as M; "
            "assert callable(B.bootstrap_batched) and callable(M.build_bootstrapped_pipeline); "
            "assert callable(toyfhe_tpu_torch.bfv_params) and callable(chip_smoke.phase_bfv_tree); "
            "assert callable(M.train) and callable(M.synthetic_dataset) and callable(M.load_mnist_local); "
            "assert toyfhe_tpu_torch.serialization.load_keypair and toyfhe_tpu_torch.metrics.snapshot; "
            "assert toyfhe_tpu_torch.core.golden.SCENARIOS['bfv_uint8']; "
            "assert callable(toyfhe_tpu_torch.parallel.ops.make_2axis_step); "
            "assert callable(chip_smoke.phase_sharded_ranks); "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'toyfhe_tpu')]; "
            "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_public_function_defaults_to_the_cpu():
    """An entry point of the port runs where its caller says: no public
    function or method has a ``device`` parameter that defaults to a CPU
    device."""
    import importlib
    import inspect
    import pkgutil

    import toyfhe_tpu_torch

    def is_cpu(default):
        if default is inspect.Parameter.empty or default is None:
            return False
        try:
            return torch.device(default).type == "cpu"
        except (TypeError, RuntimeError):
            return False

    def functions(mod):
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
                continue
            if inspect.isfunction(obj):
                yield name, obj
            elif inspect.isclass(obj):
                for mname, meth in vars(obj).items():
                    fn = getattr(meth, "__func__", meth)
                    if inspect.isfunction(fn) and (not mname.startswith("_") or mname == "__init__"):
                        yield f"{name}.{mname}", fn

    seen, bad, names = 0, [], set()
    for info in pkgutil.walk_packages(toyfhe_tpu_torch.__path__, "toyfhe_tpu_torch."):
        mod = importlib.import_module(info.name)
        for name, fn in functions(mod):
            seen += 1
            names.add(f"{info.name.split('.')[-1]}.{name}")
            for pname, prm in inspect.signature(fn).parameters.items():
                if pname == "device" and is_cpu(prm.default):
                    bad.append(f"{info.name}.{name}")
    assert seen > 200 and not bad, bad
    # the walk reaches the cluster kernels' host side and the key_params entry point
    assert {"ntt_pallas_cuda.launch_polymul", "ntt_pallas_cuda.polymul_schedule",
            "ntt_pallas_cuda.choose_polymul_cluster", "ntt_pallas_cuda.polymul_plan",
            "pallas_keyswitch_cuda.launch", "pallas_keyswitch_cuda.keyswitch_schedule",
            "pallas_keyswitch_cuda.choose_cluster", "pallas_keyswitch_cuda.keyswitch_plan",
            "rlwe.make_eval_key", "bfv.BFVParams.encode", "behz.BFVMulContext.smmrq_convert",
            "bgv.BGVParams.encode", "plain.slot_encode", "plain.slot_decode",
            "noise.bgv_noise_budget", "planner.plan_ckks_tower", "cryptparams.security_level",
            "insecure.InsecureDebug.noise", "interop.encrypt_with_noise",
            "serialization.load_ciphertext", "serialization.load_keypair",
            "serialization.load_keyswitch_key", "serialization.load_eval_mult_key",
            "serialization.load_galois_key", "mnist.train", "mnist.synthetic_dataset",
            "mnist.PlainCNN.__init__", "mnist.train_step", "mnist.load_real_digits",
            "golden.run_ckks_bootstrap", "golden.run_all", "host_engine.keyswitch",
            "generic_ring.GenericRing.mul", "polycrt.PolyCRTContext.encode",
            "refparams.bfv_reference_paramgen", "native.CrtNative.decode_bfv",
            "metrics.span", "ring.RingContext.native"} <= names
