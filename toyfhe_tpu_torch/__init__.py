"""toyfhe_tpu_torch — the PyTorch / CUDA port of toyfhe_tpu.

The CKKS square → relinearize → rescale slice: RNS residue tensors
``int64[..., L, N]`` with Montgomery constants (R = 2^32), the negacyclic
NTT as a hand-written CUDA kernel for Hopper (``csrc/ntt.cu``) with a plain
radix-2 torch twin on the CPU, the ring / RLWE / CKKS engine with real
keys, the dnum-grouped hybrid key switch (``core/hybrid.py``, with its fused
digit pipeline as a second CUDA kernel, ``csrc/hybrid_ks.cu``), and the
single-device steps of both gadgets. Public names follow the reference
package; this package imports torch and never jax.

Layer map: ops/ = modular arithmetic, NTT and sampling; core/ = ring,
RLWE engine and CKKS; parallel/ = the step; utils/ = host number theory
and numpy interop.
"""

from .core.ring import RingContext, RingElt, make_ring, make_rns_ring
from .core import ring as ringops
from .core.rlwe import (SchemeParams, PassthroughParams, PrivKey, PubKey,
                        KeyComponent, KeyPair, KeySwitchKey, EvalMultKey,
                        CipherText, UsageError, keygen, encrypt, encrypt_zero,
                        decrypt, decrypt_raw, ct_add, ct_mul, keyswitch,
                        make_eval_key, keygen_eval_mult, ct_rescale,
                        ct_modswitch_drop)
from .core.ckks import CKKSParams
from .core.hybrid import HybridRaised
from .core.ckks_encoding import (CKKSPlaintext, CKKSTag, make_plaintext,
                                 ckks_encode, ckks_decode)
from .utils import interop

__version__ = "0.1.0"
