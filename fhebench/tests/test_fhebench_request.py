"""A request's inputs come from the reference's ``request_shape``: for the
accepted configurations, at their full and their tiny sizes, the shape and
every draw are bit-equal to the rule the harness held before, the conv
geometry of 28×28 grayscale MNIST, written out here."""

import json

import numpy as np
import pytest

from fhebench import harness
from fhebench.client import Requests, images

CONFIGS = ["mnist-bsgs", "mnist-boot"]
SEEDS = [3, 2**31 + 5, 3 * 2**40 + 17]
INDEXES = [0, 9, (1 << 40) + 1]          # the last one a warm-up request's


def old_rule(model, mix, seed, index):
    """The batch and images a request carried, from the model's conv shape."""
    side = model["image"]
    positions = ((model["image"] - model["kernel"]) // model["stride"] + 1) ** 2
    batch = (1 << model["ring_logn"]) // 2 // positions
    rng = np.random.default_rng([seed, 2, index])
    return (batch, (side, side)), rng.uniform(mix["pixel_low"], mix["pixel_high"],
                                              (batch, side, side))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("size", ["full", "tiny"])
@pytest.mark.parametrize("name", CONFIGS)
def test_requests_are_drawn_as_before(tiny, name, size, seed):
    here = harness.HERE if size == "full" else tiny
    config = json.loads((here / "configs" / f"{name}.json").read_text())
    model = config["model"]
    request = harness.load_module("reference", config["reference"], here).request_shape(model)
    for mix_name in ("closed-e2e", "closed-server"):
        mix = json.loads((here / "traffic" / f"{mix_name}.json").read_text())
        pool = Requests(mix, request, seed)
        for index in INDEXES:
            shape, want = old_rule(model, mix, seed, index)
            assert request == shape
            assert np.array_equal(images(mix, request, seed, index), want)
            _, pooled = old_rule(model, mix, seed, index % mix["pool_batches"]
                                 if mix["pool_batches"] else index)
            assert np.array_equal(pool.batch(index), pooled)
    assert request == ((64, (28, 28)) if size == "full" else (8, (8, 8)))
