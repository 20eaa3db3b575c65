"""Encrypted ResNet-20 on CIFAR-10 under bootstrapped CKKS: channel-packed
rotation convolutions, the composite-polynomial ReLU and a refresh before
every conv but the first, every stage a replayed CUDA graph
(``models/resnet.py::build_resnet_pipeline``)."""

from __future__ import annotations

import torch

from toyfhe_tpu_torch.models import resnet as RN


class System:
    """Keys from ``gen`` on its device, the pipeline built on them."""

    def __init__(self, config: dict, weights: dict, gen: torch.Generator):
        self.setup, ctx = RN.fhe_setup_resnet(config["model"], config["recipe"], gen)
        self.pipe = RN.build_resnet_pipeline(self.setup, ctx, weights)

    def run(self, images, gen, layer_times=None):
        """One image [1, C, H, W] → logits [classes, 1]."""
        return self.pipe(images, gen, layer_times=layer_times)

    def encode(self, images):
        return self.pipe.encode(images)

    def forward(self, pts, gen):
        return self.pipe.forward(pts, gen)

    def decrypt(self, ct):
        return self.pipe.decrypt(ct)
