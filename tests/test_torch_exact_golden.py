"""toyfhe_tpu_torch alone against the exact-scheme golden vectors, on the CPU.

``tests/golden/reference_vectors.json`` records what the reference's exact
host engine decodes in the scenarios ``bfv_triv``, ``bfv_keyswitch``,
``bfv_crt``, ``bfv_simd`` and ``bgv_triv``. BFV and BGV decode exactly, so
the port with its own keys must decode every recorded vector: each scenario
runs through ``chip_smoke.exact_golden_vectors`` (the code phase 28 runs on
the card) and is held to the record here. ``bfv_triv`` and ``bfv_crt`` are
``slow``, as the reference's own tests of them are.

The ``cuda`` tests hold the BFV multiply → relinearize → multiply chain and
two BGV levels under both raising modifiers on the card against the CPU.
This file imports no JAX, so they run on a machine without it.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke as C
import toyfhe_tpu_torch as T
from toyfhe_tpu_torch.utils import interop as I

torch.set_num_threads(1)

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden", "reference_vectors.json")
SEED = 20260820


def vec_matches(rec: dict, xs) -> bool:
    xs = [int(x) for x in xs]
    if "full" in rec:
        return rec["full"] == xs
    return (rec["len"] == len(xs) and rec["prefix"] == xs[:64]
            and hashlib.sha256(repr(xs).encode()).hexdigest() == rec["sha256"])


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN_PATH) as f:
        data = json.load(f)
    assert data["seed"] == SEED == C.GOLDEN_SEED
    return data["scenarios"]


CHECKED = {"bfv_triv": {"dec", "dec_sq", "vec_dec", "vec_sq", "plain/vec"},
           "bfv_keyswitch": {"dec_sq", "dec_keyswitched", "dec_mul_after_switch",
                             "vec_sq_switched", "plain/vec"},
           "bfv_simd": {"slots_mul", "vec_slots_sq", "plain/slots"},
           "bgv_triv": {"dec", "dec_sq", "vec_sq", "plain/vec"},
           "bfv_crt": {"dec", "dec_sq0", "dec_sq_sound", "vec_sq", "plain/vec"}}


@pytest.mark.parametrize("name", [
    pytest.param("bfv_triv", marks=pytest.mark.slow),
    "bfv_keyswitch",
    "bfv_simd",
    "bgv_triv",
    pytest.param("bfv_crt", marks=pytest.mark.slow),
])
def test_port_exact_golden(golden, name):
    g = golden[name]
    n, vecs = C.exact_golden_vectors(name, "cpu")
    assert n == g["params"]["n"], "parameter generation diverged from the recorded N"
    assert set(vecs) == CHECKED[name]
    for key, xs in vecs.items():
        group, _, k = key.rpartition("/")
        rec = g["plain" if group else "checks"][k]
        if isinstance(rec, int):
            assert rec == xs, key
        else:
            assert vec_matches(rec, xs), f"{name}.{key} diverged from the golden vector"


@pytest.mark.cuda
def test_cuda_bfv_chain_equals_cpu():
    """encrypt → ct_mul → keyswitch → ct_mul on the card, bit-equal to the
    CPU on the same keys and ciphertexts, every transform through K1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from toyfhe_tpu_torch.ops import ntt_cuda

    dev = torch.device("cuda", 0)
    params = T.BFVParams(T.make_rns_ring(1024, (29, 28, 28)), None, T.PlainRing(1024, 12289),
                         0, 3.2)
    gen = torch.Generator().manual_seed(9)
    kp = T.keygen(params, gen)
    ek = T.keygen_eval_mult(gen, kp.priv)
    slots = np.random.default_rng(9).integers(0, 12289, 1024)
    c = T.encrypt(kp, T.slot_encode(params.plaintext_space(), slots, device="cpu"), gen)
    run = lambda k, x: T.ct_mul(T.keyswitch(k, T.ct_mul(x, x)), x)
    want = run(ek, c)
    before = dict(ntt_cuda.launches)
    got = run(I.to_device(ek, dev), I.to_device(c, dev))
    torch.cuda.synchronize()
    assert ntt_cuda.launches["fwd"] > before["fwd"] and ntt_cuda.launches["inv"] > before["inv"]
    np.testing.assert_array_equal(I.ciphertext_to_numpy(got, "primal"),
                                  I.ciphertext_to_numpy(want, "primal"))
    dec = T.slot_decode(T.decrypt(I.to_device(kp, dev), got), device=dev)
    np.testing.assert_array_equal(dec, slots ** 3 % 12289)


@pytest.mark.cuda
def test_cuda_bgv_levels_equal_cpu():
    """square → key switch → rescale twice on the card under both raising
    modifiers (on phase 30's tower), bit-equal to the CPU on the same keys
    and ciphertext."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    for twrap in (T.ModulusRaised, lambda p: T.HybridRaised(p, 3, 2)):
        params = twrap(T.BGVParams(T.make_rns_ring(1024, C.BGV_TOWER), 12289, 3.2))
        gen = torch.Generator().manual_seed(2)
        kp = T.keygen(params, gen)
        ek = T.keygen_eval_mult(gen, kp.priv)
        slots = np.random.default_rng(2).integers(0, 12289, 1024)
        c = T.encrypt(kp, T.slot_encode(params.plaintext_space(), slots, device="cpu"), gen)
        cc, ek_d = I.to_device(c, dev), I.to_device(ek, dev)
        for _ in range(2):
            c = T.ct_rescale(T.keyswitch(ek, T.ct_mul(c, c)))
            cc = T.ct_rescale(T.keyswitch(ek_d, T.ct_mul(cc, cc)))
            np.testing.assert_array_equal(I.ciphertext_to_numpy(cc, "primal"),
                                          I.ciphertext_to_numpy(c, "primal"))
        dec = T.slot_decode(T.decrypt(I.to_device(kp, dev), cc), device=dev)
        np.testing.assert_array_equal(dec, slots ** 4 % 12289)
