"""The one traffic generator: a closed loop of one client, driven by a mix
file of parameters (``fhebench/traffic/<mix>.json``).

Parameters of a mix:

* ``pixel_low``, ``pixel_high`` — each pixel uniform in [low, high), drawn
  from the seed and the request's index;
* ``pool_batches`` — 0: fresh images every request; k: k batches made in
  set-up and cycled;
* ``encode_in_request`` — true: a request is the program's whole call from
  raw images to logits (``run``), the host encode included; false: the
  pool is encoded in set-up (clients that encode their own inputs) and a
  request is the stages from the encryption to the logits ciphertext
  (``forward``), then ``decrypt``.

A request carries the batch the configuration serves (its slots over its
positions) of images of the configuration's side.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import work
from .trace import REQUEST_SPAN

KEYS = ("pixel_low", "pixel_high", "pool_batches", "encode_in_request")


def check_mix(mix: dict) -> None:
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise ValueError(f"the mix lacks {missing}")


def images(mix: dict, model: dict, seed: int, index: int) -> np.ndarray:
    """The batch of request ``index`` (or of pool entry ``index``)."""
    side, b = model["image"], work.model_shape(model)[1]
    rng = np.random.default_rng([seed, 2, index])
    return rng.uniform(mix["pixel_low"], mix["pixel_high"], (b, side, side))


class Requests:
    """The images each request of a mix carries, from the seed."""

    def __init__(self, mix: dict, model: dict, seed: int):
        check_mix(mix)
        self.mix, self.model, self.seed = mix, model, seed
        self.pool = [images(mix, model, seed, i) for i in range(mix["pool_batches"])]

    def batch(self, index: int) -> np.ndarray:
        """The images request ``index`` carries."""
        return self.pool[index % len(self.pool)] if self.pool else images(
            self.mix, self.model, self.seed, index)


class Client(Requests):
    """One closed-loop client of ``system`` (see the module's docstring)."""

    def __init__(self, system, mix: dict, model: dict, seed: int, gen: torch.Generator,
                 device):
        super().__init__(mix, model, seed)
        self.system, self.gen, self.device = system, gen, device
        self.encoded = None
        if not mix["encode_in_request"]:
            if not self.pool:
                raise ValueError("a mix that encodes in set-up needs a pool")
            self.encoded = [system.encode(x) for x in self.pool]

    def _sync(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def request(self, index: int, imgs, stages=None):
        """One request; logits [classes, B]. ``stages`` (a dict) collects
        each stage's milliseconds, the device synchronised between them."""
        with torch.profiler.record_function(REQUEST_SPAN):
            if self.encoded is None:
                return self.system.run(imgs, self.gen, layer_times=stages)
            pts = self.encoded[index % len(self.encoded)]
            if stages is None:
                return self.system.decrypt(self.system.forward(pts, self.gen))
            t0 = self._sync()
            ct = self.system.forward(pts, self.gen)
            t1 = self._sync()
            logits = self.system.decrypt(ct)
            t2 = time.perf_counter()
            stages["forward"] = (t1 - t0) * 1e3
            stages["decrypt"] = (t2 - t1) * 1e3
            return logits
