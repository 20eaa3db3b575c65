"""The C++ CRT of the host decode paths, bound with ctypes.

Port of ``toyfhe_tpu/native``: ``fhe_host.cpp`` (this package's own copy,
the same C ABI) reconstructs RNS residues through the CRT for the BFV, BGV
and CKKS decodes and the BFV noise meter. ``g++ -O3 -shared -fPIC``
compiles it at first use into ``toyfhe_tpu_torch/_build/libtoyfhe_fhe_host.so``
(a temporary file renamed into place; rebuilt when the source is newer).

Unlike the reference, which returns ``None`` and falls back to its Python
CRT when the build fails, a failed build raises with the compiler's
message: the decodes round as this library does, and a silent fallback
would change their last bits. A tower the library cannot hold (more than
64 primes, or a modulus too wide for it) raises :class:`TowerRefused`,
and there ``RingContext.native`` answers ``None`` and the decodes take
the exact Python CRT, as the reference's do. ``RingContext.to_bigint``
stays the exact oracle the tests hold the library against. Nothing here
runs at import.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fhe_host.cpp"
LIBRARY = Path(__file__).resolve().parent.parent / "_build" / "libtoyfhe_fhe_host.so"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]
MAX_LIMBS = 64           # CrtCtx holds 64 primes
MAX_WORDS = 30           # a Big holds 32 words; fhe_crt_init refuses a modulus of 30 or more

_U64P = ctypes.POINTER(ctypes.c_uint64)
_FUNCTIONS = {
    "fhe_crt_ctx_size": ([], ctypes.c_size_t),
    "fhe_crt_init": ([ctypes.c_void_p, _U64P, ctypes.c_int], ctypes.c_int),
    "fhe_decode_centered_mod": ([ctypes.c_void_p, _U64P, ctypes.c_int, ctypes.c_uint64,
                                 ctypes.POINTER(ctypes.c_int64)], None),
    "fhe_decode_bfv": ([ctypes.c_void_p, _U64P, ctypes.c_int, _U64P, ctypes.c_int,
                        ctypes.c_uint64, ctypes.POINTER(ctypes.c_int64)], None),
    "fhe_decode_centered_double": ([ctypes.c_void_p, _U64P, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_double)], None),
    "fhe_noise_worst": ([ctypes.c_void_p, _U64P, ctypes.c_int, _U64P, ctypes.c_int],
                        ctypes.c_double),
}

_lock = threading.Lock()
_lib = None


def build(source: Path = None, library: Path = None) -> Path:
    """Compile ``source`` (default ``fhe_host.cpp``) into ``library`` unless
    it is up to date; raise ``RuntimeError`` with the compiler's output if
    the build fails."""
    source = SOURCE if source is None else Path(source)
    library = LIBRARY if library is None else Path(library)
    if library.exists() and library.stat().st_mtime >= source.stat().st_mtime:
        return library
    library.parent.mkdir(parents=True, exist_ok=True)
    tmp = library.with_name(f"{library.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(source)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"the host CRT library cannot be built ({' '.join(cmd)}): {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {source.name} ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, library)
    return library


def get_lib():
    """The loaded library, built first if needed (raises if it cannot be)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _FUNCTIONS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def _words(x: int) -> np.ndarray:
    """A non-negative integer as little-endian 64-bit words."""
    if x < 0:
        raise ValueError("Δ must be non-negative")
    w = []
    while x:
        w.append(x & 0xFFFFFFFFFFFFFFFF)
        x >>= 64
    if len(w) > MAX_WORDS:
        raise ValueError(f"Δ has {len(w)} words; the library holds {MAX_WORDS}")
    return np.asarray(w or [0], dtype=np.uint64)


class TowerRefused(ValueError):
    """The library cannot hold this tower: more than :data:`MAX_LIMBS`
    primes, or a modulus of more words than its fixed-size arithmetic
    holds. ``RingContext.native`` answers ``None`` for such a tower and
    the decodes take the exact Python CRT."""


class CrtNative:
    """The CRT context of one tower (``RingContext.native`` keeps one per
    tower). Every method takes residues ``[L, N]`` in the tower's limb
    order. A tower the library cannot hold raises :class:`TowerRefused`;
    a library that cannot be built raises ``RuntimeError``."""

    def __init__(self, primes):
        primes = [int(p) for p in primes]
        if not 0 < len(primes) <= MAX_LIMBS or min(primes) < 2 or max(primes) >= 1 << 63:
            raise TowerRefused(f"a tower of 1 to {MAX_LIMBS} primes below 2^63, got {primes}")
        self.lib = get_lib()
        self.L = len(primes)
        self.ctx = ctypes.create_string_buffer(self.lib.fhe_crt_ctx_size())
        self._primes = np.asarray(primes, dtype=np.uint64)
        rc = self.lib.fhe_crt_init(self.ctx, self._primes.ctypes.data_as(_U64P), self.L)
        if rc <= 0:
            raise TowerRefused(f"fhe_crt_init refused the tower: {rc}")

    def _res64(self, residues) -> np.ndarray:
        r = np.ascontiguousarray(residues, dtype=np.uint64)
        if r.ndim != 2 or r.shape[0] != self.L:
            raise ValueError(f"residues [{self.L}, N] expected, got {r.shape}")
        return r

    def decode_centered_mod(self, residues, p: int) -> np.ndarray:
        """centered(CRT(x)) mod p for each coefficient, int64 [N]."""
        r = self._res64(residues)
        out = np.zeros(r.shape[1], dtype=np.int64)
        self.lib.fhe_decode_centered_mod(self.ctx, r.ctypes.data_as(_U64P), r.shape[1], p,
                                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return out

    def decode_bfv(self, residues, delta: int, p: int) -> np.ndarray:
        """round(centered(CRT(x)) / Δ) mod p, ties away from zero, int64 [N]."""
        r = self._res64(residues)
        dw = _words(int(delta))
        out = np.zeros(r.shape[1], dtype=np.int64)
        self.lib.fhe_decode_bfv(self.ctx, r.ctypes.data_as(_U64P), r.shape[1],
                                dw.ctypes.data_as(_U64P), len(dw), p,
                                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return out

    def decode_centered_double(self, residues) -> np.ndarray:
        """centered(CRT(x)) as a double, folded word by word (each step
        rounds), float64 [N]."""
        r = self._res64(residues)
        out = np.zeros(r.shape[1], dtype=np.float64)
        self.lib.fhe_decode_centered_double(self.ctx, r.ctypes.data_as(_U64P), r.shape[1],
                                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return out

    def noise_worst(self, residues, delta: int) -> float:
        """The largest distance of CRT(x) from the Δ lattice, at least 1, as
        a double (the distance is a difference of doubles, so it rounds near
        the lattice's midpoints)."""
        r = self._res64(residues)
        dw = _words(int(delta))
        return float(self.lib.fhe_noise_worst(self.ctx, r.ctypes.data_as(_U64P), r.shape[1],
                                              dw.ctypes.data_as(_U64P), len(dw)))
