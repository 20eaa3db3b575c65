"""The frozen byte counts of ``fhebench/work.py``."""

import pytest

from fhebench import harness, work

ROOT = harness.ROOT
N = 1 << 13
R = 4 * N                      # bytes of one limb polynomial at 4 bytes a residue


def config(name):
    return harness.load_json(ROOT / f"fhebench/configs/{name}.json")


def test_ntt_bytes_reads_and_writes_each_residue_once():
    assert work.ntt_bytes(N, 28) == 2 * 28 * N * 4
    assert work.ntt_bytes(N, 7, batch=3) == 3 * work.ntt_bytes(N, 7)


def test_bsgs_floor_counted_by_hand():
    # 7 data limbs + 4 raising limbs, 2 digits of 4 limbs; 64 positions,
    # 4 channels, a 7×7 grid, 64 images of 28×28, 10 classes
    key = lambda level: 2 * -(-level // 4) * (level + 4) * R
    keys = key(6) + 2 * 7 * R + 14 * key(5)          # relin at 6 limbs, public key, 7+7 rotations
    plain = 4 * 7 * R + 4 * 64 * 5 * R + 5 * R + 64 * 3 * R + 3 * R + 3 * R
    logits = 10 * 64 * 4
    images = 64 * 28 * 28 * 4
    grid = 49 * 7 * R
    cfg = config("mnist-bsgs")
    assert work.floor_bytes(cfg, False) == images + keys + plain + logits
    assert work.floor_bytes(cfg, True) == grid + keys + plain + logits
    assert work.floor_bytes(cfg, False) == pytest.approx(68.0e6, rel=1e-3)


def test_boot_floor_is_dominated_by_the_deep_layers():
    cfg = config("mnist-boot")
    b = work.floor_bytes(cfg, False)
    dense1 = 4 * 64 * 46 * R                 # 256 diagonals at 46 of 48 data limbs
    assert dense1 < b < 4e9
    assert work.floor_bytes(cfg, True) - b == 49 * 48 * R - 64 * 28 * 28 * 4
    with pytest.raises(ValueError):
        work.floor_bytes({**cfg, "system": "other"}, False)


@pytest.mark.parametrize("n,radix", [(64, 4), (256, 16), (1024, 16), (1 << 13, 16)])
def test_sfft_offsets_and_rotations_match_the_programs_plan(n, radix):
    """The offsets counted from the butterfly sizes are the diagonals the
    program's factored CoeffToSlot keeps (none cancels), and the rotation
    steps its keys cover."""
    from toyfhe_tpu_torch.core import sfft
    plan = sfft.SfftPlan(n, radix)
    d = n // 2
    got = work.sfft_level_offsets(d, radix)
    for i, offsets in enumerate(got):
        for chain in plan.c2s_chains:
            assert sorted(chain[i]) == offsets
    steps = set()
    for offsets in got:
        steps |= work.bsgs_rotation_steps(offsets, d)
    assert steps == plan.rotation_steps()
