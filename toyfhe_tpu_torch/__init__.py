"""toyfhe_tpu_torch — the PyTorch / CUDA port of toyfhe_tpu.

RNS residue tensors ``int64[..., L, N]`` with Montgomery constants
(R = 2^32), the negacyclic NTT as a hand-written CUDA kernel for Hopper
(``csrc/ntt.cu``) with a plain radix-2 torch twin on the CPU, the ring /
RLWE / CKKS engine with real keys, rotations (one key, key sets, the
hoisted ``rotate_many`` / ``rotate_sum`` schedules), the special-prime
(``core/modraise.py``) and dnum-grouped hybrid (``core/hybrid.py``) key
switches, the single-device square → relinearize → rescale steps, the
compiled encrypted layers (``parallel/layers.py``), CKKS bootstrapping
(``core/bootstrap.py`` on the special-FFT factorization of ``core/sfft.py``)
and encrypted MNIST (``models/mnist.py``: the serving pipeline on the
iterated schedule and the BSGS + dual-flow serving configuration, the eager
pass, and the bootstrapped pipeline), and the exact schemes: BFV with the
BEHZ multiply (``core/bfv.py``, ``core/behz.py``), leveled BGV
(``core/bgv.py``), plaintext slots (``core/plain.py``), the noise meters and
estimator (``core/noise.py``) and the parameter planner and security table
(``core/planner.py``, ``core/cryptparams.py``); on the host, the exact RLWE
engine over Python integers (``core/host_engine.py``, with general cyclotomic
rings in ``core/generic_ring.py``, PolyCRT slots in ``core/polycrt.py``, the
reference-literal parameters in ``core/refparams.py`` and the golden-vector
scenarios in ``core/golden.py``), the C++ CRT of the decodes
(``native/fhe_host.cpp``, built with g++ at first use), key and ciphertext
files (``utils/serialization.py``), op counters (``utils/metrics.py``) and
plaintext training of the MNIST model (``models/mnist.py``). The reference's
``jax.jit`` becomes ``utils/graphs.py``: the engine's types are torch
pytrees, and the steps, layers, pipeline stages and the refresh replay
CUDA graphs on the card. The fused kernels beside the plain
paths: the four-step digit transform K2 (``csrc/ntt_mxu.cu``), the hybrid
key switch K3 (``csrc/hybrid_ks.cu``), the fused polynomial product K4
(``csrc/polymul.cu``), the bit-reversed DIF transform K5
(``csrc/ntt_bitrev.cu``) and the fused windowed key switch K6
(``csrc/keyswitch.cu``); ``tools/bench_kernels.py`` is their A/B entry
point. Public names follow the reference package; this package imports
torch and never jax.

Layer map: ops/ = modular arithmetic, NTTs, sampling and the fused
kernels; core/ = ring, RLWE engine, the schemes and the key-switch modifiers;
parallel/ = the steps and the layers; models/ = encrypted MNIST and its
training; native/ = the C++ host CRT; tools/ = command-line tools; utils/ =
host number theory, numpy interop, serialization, metrics and the CUDA-graph
front-end.
"""

from .core.ring import RingContext, RingElt, make_ring, make_rns_ring
from .core import ring as ringops
from .core.rlwe import (SchemeParams, PassthroughParams, PrivKey, PubKey,
                        KeyComponent, KeyPair, KeySwitchKey, EvalMultKey,
                        GaloisKey, GaloisKeys, CipherText, UsageError, keygen, encrypt,
                        encrypt_zero, decrypt, decrypt_raw, ct_add, ct_sub, ct_add_ring,
                        ct_mul, ct_stack, ct_index, modswitch,
                        keyswitch, make_eval_key, keygen_eval_mult, ct_rescale,
                        ct_modswitch_drop, galois_element_for_steps,
                        keygen_galois, keygen_galois_set, apply_galois_ct, rotate,
                        rotate_many, rotate_sum)
from .core.ckks import CKKSParams
from .core.hybrid import HybridRaised
from .core.modraise import ModulusRaised
from .core.ckks_encoding import (CKKSPlaintext, CKKSTag, make_plaintext,
                                 ckks_encode, ckks_decode, mul_plain_vector,
                                 mul_plain_vector_at, mul_plain_vectors, mul_plain_scalar,
                                 mul_plain_scalar_at, add_plain)
from .core.plain import (PlainRing, PlainPoly, scalar_encode, scalar_decode,
                         coeff_encode, slot_encode, slot_decode)
from .core.bfv import BFVParams, bfv_params, invariant_noise_budget
from .core.bgv import BGVParams, BGVTag
from .core.insecure import InsecureDebug
from .core.noise import bgv_noise_budget, ckks_precision, ckks_scale_bits
from .core.planner import plan_ckks_tower, plan_ckks_ring
from .core.cryptparams import estimate_security, security_level
from .core import cryptparams
from .utils import interop, metrics, serialization

__version__ = "0.1.0"
