"""The production serving path of encrypted MNIST: BSGS dense layers with
their 14 Galois keys and the dual flow, every stage a replayed CUDA graph
(``models/mnist.py::build_inference_pipeline``)."""

from __future__ import annotations

import torch

from toyfhe_tpu_torch.models import mnist as M


def mnist_config(model: dict) -> M.MNISTConfig:
    keys = ("image", "kernel", "stride", "channels", "classes", "ring_logn", "limb_bits",
            "scale_log2", "gadget", "dnum", "num_special")
    got = {k: model[k] for k in keys if k in model}
    if "limb_bits" in got:
        got["limb_bits"] = tuple(got["limb_bits"])
    return M.MNISTConfig(**got)


class System:
    """Keys from ``gen`` on its device, the pipeline built on them."""

    def __init__(self, config: dict, weights: dict, gen: torch.Generator):
        self.cfg = mnist_config(config["model"])
        self.setup = M.fhe_setup(self.cfg, gen)
        gks = M.keygen_matmul_bsgs(self.setup, gen)
        self.pipe = M.build_inference_pipeline(self.setup, weights, gks_bsgs=gks)
        self.batch = self.cfg.batch

    def run(self, images, gen, layer_times=None):
        """Raw images [B, H, W] → logits [classes, B]."""
        return self.pipe(images, gen, layer_times=layer_times)

    def encode(self, images):
        return self.pipe.encode(images)

    def forward(self, pts, gen):
        return self.pipe.forward(pts, gen)

    def decrypt(self, ct):
        return M._decrypt_logits(self.setup, ct)
