"""toyfhe_tpu_torch's op counters against the reference's, on the CPU.

After the same eager calls — ``ct_mul``, ``keyswitch``, ``rotate``,
``rotate_many``, ``rotate_sum`` and ``ct_rescale`` — under the per-limb RNS
gadget, the windowed gadget, ``ModulusRaised`` and ``HybridRaised``, the
port's ``metrics.snapshot()`` equals the reference's: the same key switches,
rotations, rescales, tensor products and limb transforms. Counters depend on
shapes and control flow only, so each package runs on its own keys; the
ciphertext is carried across with the domains it holds in the reference.
The port transforms a key's components once and keeps the stacks on the key
(the reference transforms them at every use), so each call gets key objects
that hold no stacks yet; a second use of a key counts its transforms fewer.
Also the counters' own calls, the roofline helpers and the profiler trace.
"""

import json
from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

import toyfhe_tpu as F
from toyfhe_tpu.utils import metrics as ref_metrics
import toyfhe_tpu_torch as T
from toyfhe_tpu_torch.utils import metrics

torch.set_num_threads(1)

N = 32
TOWER = (28,) * 4 + (30, 30)
CONFIGS = {
    "rns": (lambda F_, r: F_.CKKSParams(r, 0, 3.2)),
    "window": (lambda F_, r: F_.CKKSParams(r, 4, 3.2)),
    "modraised": (lambda F_, r: F_.ModulusRaised(F_.CKKSParams(r, 0, 3.2))),
    "hybrid": (lambda F_, r: F_.HybridRaised(F_.CKKSParams(r, 0, 3.2), 2, 2)),
}


def carry_elt(x):
    """A reference ring element with the same domains, as the port's."""
    t = lambda a: None if a is None else torch.as_tensor(np.asarray(a).astype(np.int64))
    return T.RingElt(primal=t(x.primal), dual=t(x.dual))


def fresh_ksk(P, ksk):
    return P.KeySwitchKey(ksk.params, ksk.key, ksk.ring)


def fresh_gks(P, gks):
    return P.GaloisKeys([P.GaloisKey(k.galois_element, fresh_ksk(P, k.key)) for k in gks.keys])


def run_calls(P, ek, gks, c):
    """The same eager calls in either package, each on key objects that hold
    no stacks yet; returns the counter snapshot."""
    M = ref_metrics if P is F else metrics
    M.reset()
    sq = P.ct_mul(c, c)
    P.keyswitch(P.EvalMultKey(fresh_ksk(P, ek.key)), sq)
    P.rotate(fresh_gks(P, gks), c, steps=1)
    P.ct_rescale(c)
    elements = [P.galois_element_for_steps(N, s) for s in (1, 2)]
    P.rotate_many(fresh_gks(P, gks), c, elements)
    P.rotate_sum(fresh_gks(P, gks), [(elements[0], c), (elements[1], c), (None, c)])
    return M.snapshot()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_counters_equal_the_reference(name):
    make = CONFIGS[name]
    params = make(F, F.make_rns_ring(N, TOWER))
    ks = jax.random.split(jax.random.PRNGKey(3), 4)
    kp = F.keygen(params, ks[0])
    ek = F.keygen_eval_mult(ks[1], kp.priv)
    gks = F.keygen_galois_set(ks[2], kp.priv, [1, 2])
    vals = np.linspace(0.1, 0.9, N // 2)
    c = F.encrypt(kp, F.make_plaintext(params.ring_cipher, vals, Fraction(2) ** 26), ks[3])
    want = run_calls(F, ek, gks, c)

    tparams = make(T, T.make_rns_ring(N, TOWER))
    gen = torch.Generator().manual_seed(3)
    tkp = T.keygen(tparams, gen)
    tek = T.keygen_eval_mult(gen, tkp.priv)
    tgks = T.keygen_galois_set(gen, tkp.priv, [1, 2])
    tc = T.CipherText(tparams, tuple(carry_elt(x) for x in c.cs),
                      tparams.ring_cipher.select(range(c.ring.nlimbs)), enc=T.CKKSTag(c.enc.scale))
    got = run_calls(T, tek, tgks, tc)
    assert got == want
    assert got["keyswitch"] == 6 and got["rotate"] == 5 and got["rescale"] == 1
    assert got["enc_mul"] == 1

    # a key used again: its stacks are kept, so its components held in the
    # coefficient domain are not transformed again
    gk = fresh_gks(T, tgks)
    counts = []
    for _ in range(2):
        metrics.reset()
        T.rotate(gk, tc, steps=1)
        counts.append(metrics.snapshot()["ntt_limb_transform"])
    ksk = gk.for_steps(N, 1).key
    primal = sum((kc.mask.dual is None) + (kc.masked.dual is None) for kc in ksk.key)
    assert primal > 0 and counts[0] - counts[1] == primal * ksk.ring.nlimbs


def test_timers_and_reset():
    """The synchronising timer is gone (spans on the profiler's clock took
    its place); ``count`` adds up, ``snapshot`` is a copy, ``reset`` clears."""
    assert not hasattr(metrics, "timed") and not hasattr(metrics, "timers")
    metrics.reset()
    metrics.count("x", 3)
    metrics.count("x")
    metrics.count("y", 2)
    snap = metrics.snapshot()
    assert snap == {"x": 4, "y": 2}
    metrics.count("x")
    assert snap == {"x": 4, "y": 2} and metrics.snapshot()["x"] == 5
    metrics.reset()
    assert metrics.snapshot() == {} and snap == {"x": 4, "y": 2}


def test_rooflines_match_the_reference_bytes():
    for args in ((1 << 13, 7), (1 << 14, 8, 2)):
        assert metrics.ntt_bytes(*args) == ref_metrics.ntt_bytes(*args)
        assert metrics.keyswitch_bytes(*args) == ref_metrics.keyswitch_bytes(*args)
    nbytes = metrics.ntt_bytes(1 << 13, 7, 4)
    # the default rate is the H100's 3.35 TB/s, not the reference's TPU figure
    assert metrics.seconds_at_roofline(nbytes) == nbytes / 3.35e12
    assert metrics.seconds_at_roofline(nbytes, 819.0) == ref_metrics.seconds_at_roofline(nbytes)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with metrics.profile_trace(str(tmp_path)):
        torch.ones(64).sum()
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)
