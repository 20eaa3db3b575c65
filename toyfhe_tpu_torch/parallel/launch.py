"""Spawn the ranks of a sharded run as processes, and the rank's side.

:func:`run_ranks` starts ``world`` processes of ``python -m
toyfhe_tpu_torch.parallel.launch``, one rank each, which meet through a
``FileStore`` in the run's own directory (no fixed port, so runs side by
side never collide), call one target function and write its JSON-able
result. The parent waits with a deadline and kills every rank when one
fails or the deadline passes: a dead rank would leave its peers blocked in
a collective. Each rank uses one CPU thread.

The ranks import torch and this package only; a target is named
``"module:function"`` and called with the run's arguments (a JSON dict).
Build the CUDA kernels and the C++ CRT in the parent first
(:func:`prebuild`): the ranks then only load them.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

from .distributed import init_distributed
from .sharding import DEFAULT_TIMEOUT_S

_REPO = Path(__file__).resolve().parents[2]


def prebuild(cuda: bool) -> None:
    """Build every library a rank may load: the C++ CRT, and with ``cuda``
    the six CUDA kernels (one ``nvcc`` each, started together)."""
    from .. import native
    native.get_lib()
    if cuda:
        from ..ops import (cuda_lib, hybrid_ks_cuda, ntt_cuda, ntt_mxu_pallas_cuda,
                           ntt_pallas_cuda, pallas_keyswitch_cuda)
        cuda_lib.build_all([ntt_cuda.LIB, hybrid_ks_cuda.LIB, ntt_pallas_cuda.LIB,
                            pallas_keyswitch_cuda.LIB, ntt_mxu_pallas_cuda.LIB,
                            ntt_pallas_cuda.LIB_POLYMUL])


def run_ranks(target: str, world: int, workdir, args: Optional[dict] = None,
              timeout_s: float = 600.0, env: Optional[dict] = None,
              collective_timeout_s: float = DEFAULT_TIMEOUT_S) -> List[dict]:
    """Run ``target(**args)`` on ``world`` spawned ranks; return each rank's
    result in rank order. ``workdir`` (created) holds the store, the
    arguments, each rank's log and result. Raises ``RuntimeError`` with the
    failing rank's log when a rank fails, or when the run outlasts
    ``timeout_s``; every rank is dead when this returns."""
    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    store = work / "store"
    if store.exists():
        store.unlink()
    (work / "args.json").write_text(json.dumps(args or {}))
    penv = dict(os.environ)
    penv.update(env or {})
    penv["PYTHONPATH"] = os.pathsep.join([str(_REPO)] + [p for p in
                                         [penv.get("PYTHONPATH")] if p])
    penv["OMP_NUM_THREADS"] = "1"
    procs, logs = [], []
    try:
        for r in range(world):
            log = open(work / f"rank{r}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "toyfhe_tpu_torch.parallel.launch", target, str(r),
                 str(world), str(work), str(collective_timeout_s)],
                cwd=str(_REPO), env=penv, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RuntimeError(f"rank {bad[0]} of {target} exited {codes[bad[0]]}:\n"
                                   + _tail(work / f"rank{bad[0]}.log"))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"{target} outlasted {timeout_s:.0f} s; rank 0's log:\n"
                                   + _tail(work / "rank0.log"))
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    return [json.loads((work / f"result{r}.json").read_text()) for r in range(world)]


def _tail(path: Path, nbytes: int = 6000) -> str:
    text = path.read_text(errors="replace") if path.exists() else ""
    return text[-nbytes:]


def _main(target: str, rank: int, world: int, workdir: str, timeout_s: float) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    work = Path(workdir)
    init_distributed(num_processes=world, process_id=rank, store_path=str(work / "store"),
                     timeout_s=timeout_s)
    mod, fn = target.split(":")
    args = json.loads((work / "args.json").read_text())
    result = getattr(importlib.import_module(mod), fn)(workdir=str(work), **args)
    tmp = work / f"result{rank}.json.tmp"
    tmp.write_text(json.dumps(result))
    os.replace(tmp, work / f"result{rank}.json")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], float(sys.argv[5]))
