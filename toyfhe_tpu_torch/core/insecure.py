"""Zero-noise debug modifier.

Port of ``toyfhe_tpu/core/insecure.py`` (ToyFHE.jl ``src/insecuredebug.jl``):
the noise distribution becomes the zero sampler, so algorithmic faults can
be told apart from an exhausted noise budget. INSECURE by construction.
"""

from __future__ import annotations

from ..ops import sampling
from .ring import RingContext, RingElt
from .rlwe import PassthroughParams


class InsecureDebug(PassthroughParams):
    def scheme_name(self):
        return "Insecure " + self.params.scheme_name()

    def noise(self, gen, ring: RingContext, batch=()):
        return RingElt(primal=sampling.zero(ring.mp, ring.n, batch, device=gen.device))
