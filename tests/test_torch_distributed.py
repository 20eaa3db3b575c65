"""toyfhe_tpu_torch multi-process runs against tests/test_distributed.py.

The host-aware mesh and the single-process no-op start-up; the collective
counter of the per-limb step (dp 2 × rp 4) and of the dp × rp × cp step
(2 × 2 × 2) equal to the communication model, which equals the
reference's (the reference checks the model against its compiled HLO;
the port's ranks count what they send, on 8 spawned gloo ranks); the
scaling curves equal to the reference's over a grid of arguments; the
two-host dry run, bit-equal to the single-device step; and the four-rank
multichip dry run with its refresh flavour (the limb-sharded
``bootstrap_phase1`` of __graft_entry__.py's dry run), bit-equal.
"""

import itertools

import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__ as GE
from toyfhe_tpu.parallel import distributed as RD
from toyfhe_tpu.parallel import ops as ref_ops
from toyfhe_tpu_torch.parallel import distributed as D
from toyfhe_tpu_torch.tools import dryrun

from . import torch_rank_cases as RC

torch.set_num_threads(1)

N_STEP, L_STEP, B_STEP = 32, 8, 4           # dp 2 × rp 4, two limbs a shard
N_2A, L_2A, B_2A = 128 * 2 * 2, 4, 4         # dp 2 × rp 2 × cp 2


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ring, masks, maskeds, cts = GE._build(n_ring=N_STEP, logqs=(28,) * L_STEP, batch=B_STEP)
    ring2, masks2, maskeds2, cts2 = GE._build(n_ring=N_2A, logqs=(28,) * L_2A, batch=B_2A)
    inputs = dict(cnt_n=N_STEP, cnt_bits=np.asarray((28,) * L_STEP), cnt_masks=_np(masks),
                  cnt_maskeds=_np(maskeds), cnt_batch=_np(cts),
                  c2a_n=N_2A, c2a_bits=np.asarray((28,) * L_2A), c2a_masks=_np(masks2),
                  c2a_maskeds=_np(maskeds2), c2a_batch=_np(cts2))
    arrays, infos = RC.spawn(tmp_path_factory.mktemp("distributed"), inputs,
                             ["counter_step", "counter_2axis", "hybrid_mesh"])
    want = np.asarray(ref_ops.make_single_chip_step(ring.tables, masks, maskeds)(cts))
    want2 = np.asarray(ref_ops.make_single_chip_step(ring2.tables, masks2, maskeds2)(cts2))
    return dict(arrays=arrays, infos=infos, want=want, want2=want2)


def test_make_hybrid_mesh_single_process():
    """One process: a mesh of one rank; a larger one needs more ranks."""
    mesh = D.make_hybrid_mesh(n_rp=1, n_dp=1, device="cpu")
    assert mesh.axis_names == ("dp", "rp") and mesh.shape == {"dp": 1, "rp": 1}
    assert mesh.coords == {"dp": 0, "rp": 0}
    with pytest.raises(ValueError):
        D.make_hybrid_mesh(n_rp=4, n_dp=2, device="cpu")


def test_make_hybrid_mesh_across_ranks(ranks):
    """Eight ranks: the (2, 4) mesh in row-major order; rp = 64 is too big,
    and an rp block across two hosts of 2 ranks is refused."""
    for r, info in enumerate(ranks["infos"]):
        got = info["hybrid_mesh"]
        assert got["axes"] == ["dp", "rp"] and got["shape"] == [2, 4]
        assert got["coords"] == {"dp": r // 4, "rp": r % 4}
        assert got["raised_64_None"] and got["raised_4_2"]


def test_init_distributed_single_process_noop():
    D.init_distributed()
    assert not dist.is_initialized()


def test_counter_matches_comm_model(ranks):
    """The per-limb step: one all-gather of the digit lifts and one of the
    rescale rows per rank, with the predicted payloads; bit-equal to the
    reference's single-chip step."""
    model = D.sharded_step_comm_model(n=N_STEP, L=L_STEP, n_rp=4, batch_per_dev=B_STEP // 2)
    assert model["keyswitch_digit_share"].bytes_per_shard == (B_STEP // 2) * 2 * N_STEP * 4
    assert model["rescale_broadcast"].bytes_per_shard == (B_STEP // 2) * 2 * N_STEP * 4
    for info in ranks["infos"]:
        assert D.counter_matches_model(info["counter_step"]["counts"], model), info
    np.testing.assert_array_equal(ranks["arrays"]["counter_step"]["out"], ranks["want"])


def test_counter_matches_comm_model_2axis(ranks):
    """The dp × rp × cp step: four all-to-alls over 'cp' (one per four-step
    transform) and the two 'rp' all-gathers, with the predicted payloads;
    bit-equal to the reference's single-chip step."""
    model = D.step2axis_comm_model(n=N_2A, L=L_2A, n_rp=2, n_cp=2, batch_per_dev=B_2A // 2)
    assert sum(s.count for s in model.values() if s.kind == "all-to-all") == 4
    for info in ranks["infos"]:
        assert D.counter_matches_model(info["counter_2axis"]["counts"], model), info
    np.testing.assert_array_equal(ranks["arrays"]["counter_2axis"]["out"], ranks["want2"])


def _sites(model):
    return {k: (s.name, s.kind, s.count, s.bytes_per_shard, s.total_bytes)
            for k, s in model.items()}


def test_comm_models_equal_the_reference():
    for n, L, r, b, nc in itertools.product((32, 8192), (4, 7, 8), (1, 2, 4), (1, 3), (2, 4)):
        assert _sites(D.sharded_step_comm_model(n, L, r, b, nc)) == \
            _sites(RD.sharded_step_comm_model(n, L, r, b, nc))
        for c, t in itertools.product((2, 4), (1, 3)):
            assert _sites(D.coeff_ntt_comm_model(n, L, c, b, 4, t)) == \
                _sites(RD.coeff_ntt_comm_model(n, L, c, b, 4, t))
            for nd in (None, 2):
                assert _sites(D.step2axis_comm_model(n, L, r, c, b, nd, nc)) == \
                    _sites(RD.step2axis_comm_model(n, L, r, c, b, nd, nc))


def test_predicted_scaling_curve():
    """The reference's published curve and anti-pattern, and the port's
    curves equal to the reference's over a grid of arguments."""
    hosts = [1, 2, 4, 8, 16]
    curve = D.predicted_scaling_curve(hosts=hosts, chips_per_host=4, n=1 << 13, L=8,
                                      batch_per_chip=4, t_step_chip_s=0.58e-3, n_cp=1)
    assert all(e > 0.95 for _, e in curve), curve
    assert all(abs(e - curve[0][1]) < 1e-9 for _, e in curve[1:])
    anti = D.predicted_scaling_curve(hosts=hosts, chips_per_host=4, n=1 << 13, L=8,
                                     batch_per_chip=4, t_step_chip_s=0.58e-3, n_cp=1,
                                     dp_across_hosts=False)
    assert anti[-1][1] < curve[-1][1]
    for cph, L, cp, across in itertools.product((4, 8), (7, 8), (1, 2), (True, False)):
        kw = dict(hosts=hosts, chips_per_host=cph, n=1 << 13, L=L, batch_per_chip=2,
                  t_step_chip_s=1e-3, n_cp=cp, dp_across_hosts=across)
        assert D.predicted_scaling_curve(**kw) == RD.predicted_scaling_curve(**kw)
        pk = dict(hosts=hosts, chips_per_host=cph, n=1 << 13, L=L, n_keyswitches=30,
                  t_pipeline_chip_s=0.2, dp_across_hosts=across)
        assert D.pipeline_scaling_curve(**pk) == RD.pipeline_scaling_curve(**pk)


def test_dryrun_multihost_2proc():
    """Two hosts of two ranks: the batch axis crosses hosts, 'rp' stays in
    each; every rank's step bit-equal to the single-device step."""
    reports = dryrun.dryrun_multihost(2, 2, device="cpu")
    assert len(reports) == 4 and all(r["ok"] and r["rp_in_one_host"] for r in reports)
    assert sorted(r["host"] for r in reports) == [0, 0, 1, 1]


def test_dryrun_multichip_refresh():
    """Four ranks: every flavour of the multichip dry run, with the refresh
    flavour (the reference dry run's ``bootstrap_phase1`` at N = 16 on
    8 + 4 limbs, keys and ciphertext placed limb-wise over rp 4) bit-equal
    to the single-device phase on every rank; each rank holds its strided
    rows of the 8-limb tower and gathered the ModRaise input and both
    halves."""
    reports = dryrun.dryrun_multichip(4, device="cpu")
    assert len(reports) == 4
    for r, rep in enumerate(reports):
        ref = rep["refresh"]
        assert ref["ok"] and ref["member"] and ref["rp"] == 4 and ref["limbs"] == 12
        assert ref["held"] == [r, r + 4]
        assert ref["counts"]["level_gather"]["count"] == 3
        assert set(ref["counts"]) == {"level_gather", "keyswitch_digit_share",
                                      "rescale_broadcast"}
        assert all(rep[k]["ok"] for k in ("per_limb", "hybrid", "pipeline", "three_axis"))
