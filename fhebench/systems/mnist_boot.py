"""Depth-unlimited encrypted MNIST: the bootstrapped pipeline of the
production recipe, a CKKS refresh between the second square and dense 2,
every stage a replayed CUDA graph
(``models/mnist.py::build_bootstrapped_pipeline``)."""

from __future__ import annotations

import torch

from toyfhe_tpu_torch.models import mnist as M

from . import mnist_bsgs


class System(mnist_bsgs.System):
    def __init__(self, config: dict, weights: dict, gen: torch.Generator):
        self.cfg = mnist_bsgs.mnist_config(config["model"])
        self.setup, ctx = M.fhe_setup_bootstrapped(self.cfg, gen, **config["recipe"])
        self.pipe = M.build_bootstrapped_pipeline(self.setup, ctx, weights,
                                                  prescale=config["prescale"])
        self.batch = self.cfg.batch

    def run(self, images, gen, layer_times=None):
        """Raw images [B, H, W] → logits [classes, B] (the pipeline also
        returns the refreshed tower's depth)."""
        return self.pipe(images, gen, layer_times=layer_times)[0]
