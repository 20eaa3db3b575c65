"""Build and load the port's hand-written CUDA kernels.

Each ``toyfhe_tpu_torch/csrc/<stem>.cu`` is one shared library with a plain
C interface: ``nvcc`` compiles it at first use into
``toyfhe_tpu_torch/_build/libtoyfhe_<stem>.so`` (rebuilt when the source or
a ``csrc/*.cuh`` header is newer) and ``ctypes`` loads it. Every library
also exports ``toyfhe_cuda_error_string`` (``csrc/common.cuh``).
:func:`build_all` starts one ``nvcc`` per stale library, all at once.
Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC)]

VP, CI = ctypes.c_void_p, ctypes.c_int


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


class CudaLibrary:
    """One ``csrc/<stem>.cu`` source and the functions it exports, each
    given as ``name: (argtypes, restype)``. ``source`` names another file to
    compile under that stem (an experiment's variant of a kernel, which
    includes the ``csrc`` headers like the original)."""

    def __init__(self, stem: str, functions: Dict[str, Tuple[Sequence, object]],
                 source: Path = None):
        self.source = CSRC / f"{stem}.cu" if source is None else Path(source)
        self.library = BUILD_DIR / f"libtoyfhe_{stem}.so"
        self.functions = dict(functions)
        self.functions["toyfhe_cuda_error_string"] = ([CI], ctypes.c_char_p)
        self.build_info: dict = {}
        self._lib = None

    def stale(self) -> bool:
        if not self.library.exists():
            return True
        newest = max(p.stat().st_mtime for p in [self.source, *CSRC.glob("*.cuh")])
        return self.library.stat().st_mtime < newest

    def _start(self) -> Tuple[subprocess.Popen, Path]:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{self.library.name}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        self.build_info.update(cmd=" ".join(cmd), started=time.perf_counter())
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        return proc, tmp

    def _finish(self, proc: subprocess.Popen, tmp: Path) -> None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({proc.returncode}):\n{log}")
        os.replace(tmp, self.library)
        self.build_info.update(log=log, seconds=time.perf_counter()
                               - self.build_info.pop("started"))

    def load(self):
        """The loaded library, built first if needed."""
        if self._lib is None:
            build_all([self])
            lib = ctypes.CDLL(str(self.library))
            for name, (argtypes, restype) in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            self._lib = lib
        return self._lib

    def spill_bytes(self, needle: str):
        """Bytes of register spill stores ``ptxas -v`` reported for the
        kernel whose mangled name contains ``needle``, from this process's
        build log; ``None`` when the library was not built by this process
        or holds no such kernel."""
        lines = self.build_info.get("log", "").splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and needle in line:
                for follow in lines[i + 1:i + 4]:
                    if "spill stores" in follow:
                        return int(follow.split("bytes stack frame,")[1].split("bytes spill")[0])
        return None

    def check(self, err: int, what: str) -> None:
        """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
        if err != 0:
            msg = self.load().toyfhe_cuda_error_string(err).decode()
            raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def build_all(libs: Iterable[CudaLibrary]) -> None:
    """Compile every stale library of ``libs``, one ``nvcc`` each, started
    together; raise if any fails."""
    procs = []
    for lib in libs:
        if lib.stale():
            procs.append((lib, *lib._start()))
        else:
            lib.build_info.setdefault("seconds", 0.0)
            lib.build_info.setdefault("log", "up to date")
    errors = []
    for lib, proc, tmp in procs:
        try:
            lib._finish(proc, tmp)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
