"""Multi-process runs: process-group start-up, a host-aware mesh, and the
per-collective communication model.

Port of ``toyfhe_tpu/parallel/distributed.py`` on ``torch.distributed``,
one rank a process. The topology rule is the reference's: the axes that
communicate every step, residue ('rp') and coefficient ('cp'), stay inside
one host, where their collectives ride the fast links; batch ('dp') goes
across hosts, since ciphertext-batch parallelism exchanges nothing a step.
A host here is a block of ``LOCAL_WORLD_SIZE`` consecutive ranks (as
``torchrun`` numbers them).

The communication model is arithmetic and equals the reference's. The
reference checks it against the collectives in its compiled HLO; the port
holds it against :class:`.sharding.CollectiveCounter`, which every
collective of the port records into (the HLO parsers are not ported).
"""

from __future__ import annotations

import datetime
import math
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch.distributed as dist

from .sharding import DEFAULT_TIMEOUT_S, Mesh


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     store_path: Optional[str] = None, backend: str = "gloo",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Start this process's rank of the process group (idempotent).

    A no-op when the group is up, and in a single process: no coordinator,
    no store and at most one process, with ``WORLD_SIZE`` unset or 1.
    Otherwise the rendezvous is, in order: the ``FileStore`` at
    ``store_path`` (shared by the ranks of one machine), the TCP
    coordinator ``host:port``, or the environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``). ``backend``: gloo on the
    CPU and for several ranks on one GPU, nccl for one GPU a rank. Every
    collective waits at most ``timeout_s`` seconds."""
    if dist.is_initialized():
        return
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if (coordinator_address is None and store_path is None
            and num_processes in (None, 1) and env_world == 1):
        return
    world = num_processes if num_processes is not None else env_world
    rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    kwargs = dict(backend=backend, rank=rank, world_size=world,
                  timeout=datetime.timedelta(seconds=timeout_s))
    if store_path is not None:
        kwargs["store"] = dist.FileStore(str(store_path), world)
    elif coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    else:
        kwargs["init_method"] = "env://"
    dist.init_process_group(**kwargs)


def make_hybrid_mesh(n_rp: int, n_dp: int = 1, n_cp: int = 1, *, device,
                     ranks: Optional[Sequence[int]] = None) -> Mesh:
    """('dp', 'rp'[, 'cp']) mesh with 'dp' across hosts and 'rp' / 'cp'
    inside each: in the row-major order the rp × cp block of one dp row is
    ``n_rp·n_cp`` consecutive ranks, which must lie on one host of
    ``LOCAL_WORLD_SIZE`` ranks (unset: the whole world is one host).
    Raises ``ValueError`` when the world is too small or a block would
    cross hosts."""
    axes = ("dp", "rp") if n_cp == 1 else ("dp", "rp", "cp")
    shape = (n_dp, n_rp) if n_cp == 1 else (n_dp, n_rp, n_cp)
    total = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(range(total)) if ranks is None else list(ranks)
    if len(ranks) != total or total > world:
        raise ValueError(f"need {total} ranks, have {world}")
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    block = n_rp * n_cp
    for row in range(n_dp):
        members = ranks[row * block:(row + 1) * block]
        if len({r // per_host for r in members}) > 1:
            raise ValueError(f"the rp x cp block {members} crosses hosts of {per_host} ranks: "
                             "only the batch axis may cross hosts")
    return Mesh(axes, shape, device=device, ranks=ranks)


# ---------------------------------------------------------------------------
# the communication-volume model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CollectiveSite:
    """One collective of the sharded step, with its predicted payload."""
    name: str              # site label
    kind: str              # all-gather | all-to-all
    count: int             # invocations a step
    bytes_per_shard: int   # payload each rank contributes an invocation

    @property
    def total_bytes(self) -> int:
        return self.count * self.bytes_per_shard


def sharded_step_comm_model(n: int, L: int, n_rp: int, batch_per_dev: int = 1,
                            ncomp: int = 2, dtype_bytes: int = 4
                            ) -> Dict[str, CollectiveSite]:
    """Predicted collectives of the rp-sharded square → relinearize →
    rescale step (``ops.make_sharded_step``), a rank and a step: one
    all-gather of the local digit lifts, B·(L/n_rp)·N values, and one of
    each component's local last row, B·ncomp·N values. 'dp' exchanges
    nothing."""
    per_limb_row = n * dtype_bytes
    local_rows = -(-L // n_rp)
    return {
        "keyswitch_digit_share": CollectiveSite(
            "keyswitch_digit_share", "all-gather", 1,
            batch_per_dev * local_rows * per_limb_row),
        "rescale_broadcast": CollectiveSite(
            "rescale_broadcast", "all-gather", 1, batch_per_dev * ncomp * per_limb_row),
    }


def coeff_ntt_comm_model(n: int, L_local: int, n_cp: int, batch_per_dev: int = 1,
                         dtype_bytes: int = 4, transforms: int = 1
                         ) -> Dict[str, CollectiveSite]:
    """The coefficient-sharded four-step transform: one all-to-all per
    transform of the rank's whole block, N/n_cp values a limb row."""
    payload = batch_per_dev * L_local * (n // n_cp) * dtype_bytes
    return {"ntt_stage_exchange": CollectiveSite(
        "ntt_stage_exchange", "all-to-all", transforms, payload)}


def step2axis_comm_model(n: int, L: int, n_rp: int, n_cp: int, batch_per_dev: int = 1,
                         ndig: Optional[int] = None, ncomp: int = 2, dtype_bytes: int = 4
                         ) -> Dict[str, CollectiveSite]:
    """Predicted collectives of the dp × rp × cp step
    (``ops.make_2axis_step``), a rank and a step: one all-to-all over 'cp'
    per four-step transform (intt(d3), ntt(digits) with its ``ndig`` axis,
    intt(out), ntt(result)) and the 1-axis step's two 'rp' all-gathers at
    1/n_cp the row length."""
    ndig = L if ndig is None else ndig
    l_loc = -(-L // n_rp)
    n_loc = n // n_cp
    blk = batch_per_dev * l_loc * n_loc * dtype_bytes
    return {
        "ntt_d3_exchange": CollectiveSite("ntt_d3_exchange", "all-to-all", 1, blk),
        "ntt_digit_exchange": CollectiveSite("ntt_digit_exchange", "all-to-all", 1, ndig * blk),
        "ntt_out_exchange": CollectiveSite("ntt_out_exchange", "all-to-all", 1, ncomp * blk),
        "ntt_result_exchange": CollectiveSite("ntt_result_exchange", "all-to-all", 1,
                                              ncomp * blk),
        "keyswitch_digit_share": CollectiveSite("keyswitch_digit_share", "all-gather", 1, blk),
        "rescale_broadcast": CollectiveSite(
            "rescale_broadcast", "all-gather", 1, batch_per_dev * ncomp * n_loc * dtype_bytes),
    }


def counter_matches_model(snapshot: dict, model: Dict[str, CollectiveSite]) -> bool:
    """A :class:`.sharding.CollectiveCounter` snapshot of one step equal to
    the model in sites, kind, count and bytes of every call."""
    if set(snapshot) != set(model):
        return False
    return all(snapshot[k]["kind"] == s.kind and snapshot[k]["count"] == s.count
               and snapshot[k]["bytes"] == [s.bytes_per_shard] * s.count
               for k, s in model.items())


def predicted_scaling_curve(hosts: Sequence[int], chips_per_host: int, n: int, L: int,
                            batch_per_chip: int, t_step_chip_s: float,
                            n_rp: Optional[int] = None, n_cp: int = 1,
                            ici_bw: float = 4 * 45e9, dcn_bw: float = 25e9,
                            dp_across_hosts: bool = True) -> list:
    """Predicted weak-scaling efficiency of the sharded step, 1 chip → N
    hosts, from the communication model: eff = t / (t + t_comm), the
    step's collectives on the in-host links when 'dp' crosses hosts, and
    on each host's network link when they span hosts
    (``dp_across_hosts=False``). The default rates are the reference's
    (TPU links); returns [(n_hosts, efficiency), ...]."""
    n_rp = chips_per_host // n_cp if n_rp is None else n_rp
    if n_cp > 1:
        model = step2axis_comm_model(n, L, n_rp, n_cp, batch_per_chip)
    else:
        model = sharded_step_comm_model(n, L, n_rp, batch_per_chip)
    out = []
    for nh in hosts:
        t_comm = 0.0
        for s in model.values():
            size = n_rp if "gather" in s.kind else n_cp
            wire = s.total_bytes * (size - 1) / max(size, 1)
            if dp_across_hosts or nh == 1:
                t_comm += wire / ici_bw
            else:
                t_comm += wire * chips_per_host / dcn_bw
        out.append((nh, t_step_chip_s / (t_step_chip_s + t_comm)))
    return out


def pipeline_scaling_curve(hosts: Sequence[int], chips_per_host: int, n: int, L: int,
                           n_keyswitches: int, t_pipeline_chip_s: float,
                           n_rp: Optional[int] = None, ici_bw: float = 4 * 45e9,
                           dcn_bw: float = 25e9, dp_across_hosts: bool = True) -> list:
    """Predicted weak-scaling efficiency of the sharded serving pipeline:
    ``n_keyswitches`` steps' worth of 'rp' all-gathers per invocation, the
    rest limb-local; returns [(n_hosts, efficiency), ...]."""
    n_rp = chips_per_host if n_rp is None else n_rp
    model = sharded_step_comm_model(n, L, n_rp, batch_per_dev=1)
    out = []
    for nh in hosts:
        t_comm_step = 0.0
        for s in model.values():
            wire = s.total_bytes * (n_rp - 1) / max(n_rp, 1)
            if dp_across_hosts or nh == 1:
                t_comm_step += wire / ici_bw
            else:
                t_comm_step += wire * chips_per_host / dcn_bw
        t_comm = n_keyswitches * t_comm_step
        out.append((nh, t_pipeline_chip_s / (t_pipeline_chip_s + t_comm)))
    return out
