"""toyfhe_tpu_torch — the PyTorch / CUDA port of toyfhe_tpu.

RNS residue tensors ``int64[..., L, N]`` with Montgomery constants
(R = 2^32), the negacyclic NTT as a hand-written CUDA kernel for Hopper
(``csrc/ntt.cu``) with a plain radix-2 torch twin on the CPU, the ring /
RLWE / CKKS engine with real keys, rotations (one key, key sets, the
hoisted ``rotate_many`` / ``rotate_sum`` schedules), the special-prime
(``core/modraise.py``) and dnum-grouped hybrid (``core/hybrid.py``) key
switches, the single-device square → relinearize → rescale steps, the
compiled encrypted layers (``parallel/layers.py``) and the encrypted-MNIST
serving pipeline (``models/mnist.py``: the iterated schedule and the BSGS +
dual-flow serving configuration). The fused kernels beside the plain
paths: the four-step digit transform K2 (``csrc/ntt_mxu.cu``), the hybrid
key switch K3 (``csrc/hybrid_ks.cu``), the fused polynomial product K4
(``csrc/polymul.cu``), the bit-reversed DIF transform K5
(``csrc/ntt_bitrev.cu``) and the fused windowed key switch K6
(``csrc/keyswitch.cu``); ``tools/bench_kernels.py`` is their A/B entry
point. Public names follow the reference package; this package imports
torch and never jax.

Layer map: ops/ = modular arithmetic, NTTs, sampling and the fused
kernels; core/ = ring, RLWE engine, CKKS and the key-switch modifiers;
parallel/ = the steps and the layers; models/ = encrypted MNIST; tools/ =
command-line tools; utils/ = host number theory and numpy interop.
"""

from .core.ring import RingContext, RingElt, make_ring, make_rns_ring
from .core import ring as ringops
from .core.rlwe import (SchemeParams, PassthroughParams, PrivKey, PubKey,
                        KeyComponent, KeyPair, KeySwitchKey, EvalMultKey,
                        GaloisKey, GaloisKeys, CipherText, UsageError, keygen, encrypt,
                        encrypt_zero, decrypt, decrypt_raw, ct_add, ct_mul,
                        keyswitch, make_eval_key, keygen_eval_mult, ct_rescale,
                        ct_modswitch_drop, galois_element_for_steps,
                        keygen_galois, keygen_galois_set, apply_galois_ct, rotate,
                        rotate_many, rotate_sum)
from .core.ckks import CKKSParams
from .core.hybrid import HybridRaised
from .core.modraise import ModulusRaised
from .core.ckks_encoding import (CKKSPlaintext, CKKSTag, make_plaintext,
                                 ckks_encode, ckks_decode, mul_plain_vector,
                                 mul_plain_vector_at)
from .utils import interop

__version__ = "0.1.0"
