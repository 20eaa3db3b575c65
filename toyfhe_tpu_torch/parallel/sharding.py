"""Mesh sharding for RNS FHE on ``torch.distributed``: one rank a process.

Port of ``toyfhe_tpu/parallel/sharding.py``. The reference runs one SPMD
body per device of a ``jax.sharding.Mesh`` under ``shard_map``; the port
runs the same body once per rank, one rank per process, with one process
subgroup per mesh axis:

  * **residue parallelism** ('rp') — the RNS limb axis ``L`` sharded;
    cross-limb data moves only at the reference's collective sites: the
    key-switch digit share (an all-gather of the centered digit lifts) and
    the rescale's dropped-limb row (an all-gather of one limb row);
  * **batch parallelism** ('dp') — a leading batch axis sharded, e.g. the
    49-ciphertext MNIST grid;
  * **coefficient parallelism** ('cp') — the ring axis ``N`` sharded, the
    four-step transform with one all-to-all between its two local stages.

``jax.lax.all_gather(..., tiled=True)`` becomes :func:`all_gather`
(``all_gather_into_tensor`` with the gathered dimension moved to the
front), ``jax.lax.all_to_all(..., tiled=True)`` becomes :func:`all_to_all`
(``all_to_all_single`` with the split and concatenated dimensions moved),
``axis_index`` / ``axis_size`` a rank's coordinate and extent on the axis
(``mesh.coords`` / ``mesh.shape``). Residues travel as ``int32`` (they are
below 2^31), so a collective's payload is the reference's at its
``dtype_bytes=4``; each call records its site, kind and payload in the
mesh's :class:`CollectiveCounter`, which stands in for the reference's
compiled-HLO counts. A mesh of one rank needs no process group, and its
collectives are identities (still counted).

The limb-sharded engine (the refresh of ``core/bootstrap.py`` and every
engine operation under it) uses a **strided limb layout** instead of
contiguous blocks: rank r of 'rp' holds the rows of a tower whose index in
the key tower (the root of ``RingContext.select``) is ≡ r (mod rp). A
ciphertext at any level, its expanded tower Q_ℓ ∪ P, the keys, the encoded
diagonals and the constants then place every row on the rank that holds the
same key row, so keys never move; dropping the last limb removes one row on
one rank, and the blocks differ by at most one row (:func:`gather_strided`
pads them). :func:`shard_limbwise` places engine objects that way
(``core.ring.ShardedRing`` is the rank's view of a tower), and
:func:`gather_limbwise` turns a sharded ciphertext back into a whole one.

Transports: gloo on the CPU and for several ranks on one GPU (NCCL refuses
two ranks on one device); NCCL where each rank has its own GPU. Gloo takes
the CUDA tensors of both collectives as they are (torch 2.11 on an H100),
so no block is staged through host memory by this code, and the
arithmetic stays on the card.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import modmath, ntt as nttmod
from ..ops.modmath import MontParams

__all__ = ["Mesh", "CollectiveCounter", "make_mesh", "all_gather", "all_to_all", "all_sum",
           "shard", "unshard", "shard_tree", "shard_ring_tensor", "shard_limbwise",
           "strided_rows", "gather_strided", "gather_limbwise",
           "ntt_table_pytree", "table_specs", "ntt_p", "intt_p", "coeff_shard_layout",
           "mxu_table_pytree", "mxu_table_specs", "mxu2_ntt_local", "mxu2_intt_local",
           "coeff_sharded_ntt_fn", "coeff_sharded_intt_fn", "coeff_sharded_galois_plan",
           "coeff_sharded_galois_fn"]

DEFAULT_TIMEOUT_S = 300.0
WIRE_DTYPE = torch.int32
WIRE_BYTES = 4


class CollectiveCounter:
    """What a rank's collectives moved, by site: ``{site: {"kind", "count",
    "bytes"}}`` with ``bytes`` the payload this rank contributed at each
    call (the reference's ``CollectiveSite.bytes_per_shard``)."""

    def __init__(self):
        self.sites: Dict[str, dict] = {}

    def record(self, site: str, kind: str, nbytes: int) -> None:
        rec = self.sites.setdefault(site, {"kind": kind, "count": 0, "bytes": []})
        if rec["kind"] != kind:
            raise ValueError(f"site {site!r} issued both {rec['kind']} and {kind}")
        rec["count"] += 1
        rec["bytes"].append(int(nbytes))

    def reset(self) -> None:
        self.sites.clear()

    def snapshot(self) -> Dict[str, dict]:
        return {k: {"kind": v["kind"], "count": v["count"], "bytes": list(v["bytes"])}
                for k, v in self.sites.items()}


class Mesh:
    """A mesh of ranks with named axes, in a jax ``Mesh``'s row-major order:
    the rank at flat index ``i`` of ``ranks`` has the coordinates of ``i``
    unravelled over ``shape``. One process subgroup per axis line (the
    ranks that differ only in that axis's coordinate), made by every rank
    of the world in one order, so every rank builds every mesh, members or
    not. ``device`` is where this rank's tensors live.

    A mesh of one rank (every extent 1) needs no process group."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], *, device,
                 ranks: Optional[Sequence[int]] = None):
        self.axis_names = tuple(axis_names)
        extents = tuple(int(s) for s in shape)
        if len(extents) != len(self.axis_names) or min(extents) < 1:
            raise ValueError(f"axes {self.axis_names} with extents {extents}")
        self.shape = dict(zip(self.axis_names, extents))
        self.size = math.prod(extents)
        self.device = modmath.canonical_device(device)
        self.comm = CollectiveCounter()
        initialized = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if initialized else 1
        me = dist.get_rank() if initialized else 0
        self.ranks = tuple(range(self.size)) if ranks is None else tuple(int(r) for r in ranks)
        if len(self.ranks) != self.size:
            raise ValueError(f"a {extents} mesh needs {self.size} ranks, got {len(self.ranks)}")
        if list(self.ranks) != sorted(set(self.ranks)) or self.ranks[-1] >= world:
            raise ValueError(f"mesh ranks {self.ranks} must ascend within a world of {world}")
        self.member = me in self.ranks
        self.coords = None
        if self.member:
            flat = np.unravel_index(self.ranks.index(me), extents)
            self.coords = {name: int(c) for name, c in zip(self.axis_names, flat)}
        self.groups: Dict[str, object] = {}
        grid = np.asarray(self.ranks).reshape(extents)
        timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
        for ax, name in enumerate(self.axis_names):
            self.groups[name] = None
            if extents[ax] == 1:
                continue
            lines = np.moveaxis(grid, ax, -1).reshape(-1, extents[ax])
            for line in lines:
                g = dist.new_group([int(r) for r in line], timeout=timeout)
                if self.member and me in line:
                    self.groups[name] = g

    def index(self, axis: str) -> int:
        """``jax.lax.axis_index``: this rank's coordinate on ``axis``."""
        return self.coords[axis]

    def __repr__(self):
        return (f"Mesh({self.shape}, ranks={self.ranks}, coords={self.coords}, "
                f"device={self.device})")


def make_mesh(n_rp: Optional[int] = None, n_dp: int = 1, *, device,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """('dp', 'rp') mesh over ``ranks`` (default the first n_dp·n_rp of the
    world; ``n_rp`` defaults to all of them on 'rp'): rank ``r`` of the
    mesh sits at (r // n_rp, r % n_rp)."""
    if n_rp is None:
        world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        n_rp = (len(ranks) if ranks is not None else world) // n_dp
    return Mesh(("dp", "rp"), (n_dp, n_rp), device=device, ranks=ranks)


# ---------------------------------------------------------------------------
# collectives (jax.lax's tiled semantics), counted
# ---------------------------------------------------------------------------

def _norm(dim: int, ndim: int) -> int:
    return dim + ndim if dim < 0 else dim


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int, site: str) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``: the blocks of
    the ranks along ``axis`` concatenated on ``dim`` in coordinate order.
    Values must fit int32 (residues and centered lifts do)."""
    mesh.comm.record(site, "all-gather", x.numel() * WIRE_BYTES)
    size = mesh.shape[axis]
    if size == 1:
        return x
    dim = _norm(dim, x.dim())
    w = x.movedim(dim, 0).to(WIRE_DTYPE).contiguous()
    out = torch.empty((size * w.shape[0],) + tuple(w.shape[1:]), dtype=w.dtype, device=w.device)
    _all_gather_single(out, w, group=mesh.groups[axis])
    return out.to(x.dtype).movedim(0, dim)


def _all_gather_single(out, inp, group):
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, inp, group=group)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, split_dim: int, concat_dim: int,
               site: str) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    ``x`` split on ``split_dim`` into one chunk per rank along ``axis``,
    chunk ``j`` sent to coordinate ``j``, the received chunks concatenated
    on ``concat_dim`` in coordinate order."""
    mesh.comm.record(site, "all-to-all", x.numel() * WIRE_BYTES)
    size = mesh.shape[axis]
    split_dim, concat_dim = _norm(split_dim, x.dim()), _norm(concat_dim, x.dim())
    if x.shape[split_dim] % size:
        raise ValueError(f"dimension {split_dim} of {tuple(x.shape)} does not split {size} ways")
    if size == 1:
        return x
    xs = x.movedim(split_dim, 0)
    w = xs.reshape((size, xs.shape[0] // size) + tuple(xs.shape[1:])).to(WIRE_DTYPE).contiguous()
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=mesh.groups[axis])
    out = out.to(x.dtype)
    return torch.cat([out[j].movedim(0, split_dim) for j in range(size)], dim=concat_dim)


def all_sum(x: torch.Tensor, mesh: Mesh, axis: str, mp: MontParams, site: str) -> torch.Tensor:
    """The modular sum of the ranks' residue blocks along ``axis`` (one
    all-gather, then the sum): exact, so equal to any other order of the
    same sum."""
    return modmath.mod_sum(all_gather(x[None], mesh, axis, 0, site), mp, axis=0)


# ---------------------------------------------------------------------------
# placement: a PartitionSpec is a tuple of axis names (or None) per dimension
# ---------------------------------------------------------------------------

def _block(extent: int, mesh: Mesh, axis: str) -> Tuple[int, int]:
    size = mesh.shape[axis]
    if extent % size:
        raise ValueError(f"an extent of {extent} does not shard {size} ways over {axis!r}")
    step = extent // size
    return mesh.index(axis) * step, step


def limb_rows(nlimbs: int, mesh: Mesh, axis: str = "rp") -> list:
    """The global limb indices this rank owns."""
    lo, step = _block(nlimbs, mesh, axis)
    return list(range(lo, lo + step))


def shard(x, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the global array ``x`` (a tensor or host array)
    under ``spec``, on ``mesh.device``."""
    if not torch.is_tensor(x):
        a = np.asarray(x)
        x = torch.as_tensor(a.astype(np.int64) if a.dtype.kind == "u" else a)
    for dim, axis in enumerate(spec):
        if axis is not None:
            lo, step = _block(x.shape[dim], mesh, axis)
            x = x.narrow(dim, lo, step)
    return x.to(mesh.device).contiguous()


def unshard(x: torch.Tensor, spec, mesh: Mesh, site: str = "unshard") -> torch.Tensor:
    """The global tensor on every rank from each rank's block under
    ``spec`` (one all-gather per sharded dimension)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = all_gather(x, mesh, axis, dim, site)
    return x


def shard_tree(tree, specs, mesh: Mesh):
    """:func:`shard` over a dict (or tuple) of leaves with a matching tree
    of specs; a tuple leaf under one spec shards each of its members."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_tree(v, specs, mesh) for v in tree)
    return shard(tree, specs, mesh)


def shard_ring_tensor(mesh: Mesh, x, batch: bool = False) -> torch.Tensor:
    """[..., L, N] with L on 'rp' (and axis 0 of a [B, 2, L, N] batch on
    'dp' when ``batch``): this rank's block."""
    return shard(x, ("dp", None, "rp", None) if batch else ("rp", None), mesh)


def shard_limbwise(tree, mesh: Mesh, axis_name: str = "rp"):
    """Place a tree on ``mesh`` limb-wise: the reference's placement of
    engine pytrees (keys, ciphertexts, whole bootstrap contexts).

    A ``CipherText``, ``KeySwitchKey`` (also inside an ``EvalMultKey``, a
    ``GaloisKey`` or ``GaloisKeys``) or ``BootstrapContext`` keeps, of each
    ring element, the rows of the strided layout this rank holds, on its
    tower's ``core.ring.ShardedRing`` (a sharded context starts with an
    empty plain cache: each rank encodes its own rows); the engine then
    runs on it as it is, each cross-limb step one counted collective. Other
    tensor leaves of a dict / list / tuple have their limb axis (axis −2)
    cut to this rank's contiguous block wherever the extent divides, whole
    otherwise; other leaves stay as they are."""
    from ..core import bootstrap as B, ring as R, rlwe

    size = mesh.shape[axis_name]

    def elt(ring, x):
        return R.RingElt(**{k: None if v is None else R.held_rows(ring, v).to(mesh.device)
                            for k, v in (("primal", x.primal), ("dual", x.dual))})

    def ksk(k):
        view = R.shard_view(k.ring, mesh, axis_name)
        return rlwe.KeySwitchKey(k.params, [rlwe.KeyComponent(elt(view, c.mask),
                                                              elt(view, c.masked))
                                            for c in k.key], view)

    def put(x):
        if isinstance(x, rlwe.CipherText):
            view = R.shard_view(x.ring, mesh, axis_name)
            return rlwe.CipherText(x.params, tuple(elt(view, e) for e in x.cs), view, x.enc)
        if isinstance(x, rlwe.KeySwitchKey):
            return ksk(x)
        if isinstance(x, rlwe.EvalMultKey):
            return rlwe.EvalMultKey(ksk(x.key))
        if isinstance(x, rlwe.GaloisKey):
            return rlwe.GaloisKey(x.galois_element, ksk(x.key))
        if isinstance(x, rlwe.GaloisKeys):
            return rlwe.GaloisKeys([put(k) for k in x.keys])
        if isinstance(x, B.BootstrapContext):
            return dataclasses.replace(x, ek=put(x.ek), gks=put(x.gks),
                                       gk_conj=put(x.gk_conj), plain_cache={})
        if isinstance(x, R.RingElt):
            raise TypeError("a ring element's rows follow its tower: place it inside its "
                            "ciphertext or key")
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        if not torch.is_tensor(x):
            return x
        spec = [None] * x.dim()
        if x.dim() >= 2 and x.shape[-2] % size == 0:
            spec[-2] = axis_name
        return shard(x, spec, mesh)

    return put(tree)


def gather_limbwise(tree):
    """The whole ciphertexts of a tree (a ciphertext, or a dict / list /
    tuple of them) on every rank, from limb-sharded ones: one all-gather
    over 'rp' a ciphertext (``rlwe.ct_gather``, site ``level_gather``);
    whole ciphertexts and other leaves as they are."""
    from ..core import rlwe

    if isinstance(tree, rlwe.CipherText):
        return rlwe.ct_gather(tree)
    if isinstance(tree, dict):
        return {k: gather_limbwise(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_limbwise(v) for v in tree)
    return tree


# ---------------------------------------------------------------------------
# the strided limb layout of the sharded engine
# ---------------------------------------------------------------------------

def strided_rows(roots: Sequence[int], size: int, index: int) -> list:
    """The positions of a tower's rows that rank ``index`` of ``size``
    holds: those whose key-tower index (``roots``) is ≡ ``index`` (mod
    ``size``)."""
    return [q for q, g in enumerate(roots) if g % size == index]


@functools.lru_cache(maxsize=None)
def _strided_plan(roots: Tuple[int, ...], size: int):
    """(the largest block, each row's position in the padded gather)."""
    blocks = [strided_rows(roots, size, s) for s in range(size)]
    width = max(len(b) for b in blocks)
    perm = [0] * len(roots)
    for s, rows in enumerate(blocks):
        for j, q in enumerate(rows):
            perm[q] = s * width + j
    return width, tuple(perm)


_PERMS: dict = {}


def gather_strided(x: torch.Tensor, roots: Sequence[int], mesh: Mesh, axis: str,
                   site: str) -> torch.Tensor:
    """The whole tower ``[..., len(roots), N]`` on every rank from each
    rank's strided rows ``x`` (:func:`strided_rows`): one all-gather over
    ``axis``, every block padded with zero rows to the largest, the padding
    dropped after."""
    roots = tuple(int(g) for g in roots)
    size = mesh.shape[axis]
    width, perm = _strided_plan(roots, size)
    if x.shape[-2] < width:
        x = torch.cat([x, x.new_zeros(x.shape[:-2] + (width - x.shape[-2], x.shape[-1]))], -2)
    g = all_gather(x, mesh, axis, -2, site)
    if size == 1:
        return g
    key = (roots, size, g.device)
    if key not in _PERMS:
        _PERMS[key] = torch.as_tensor(perm, dtype=torch.int64, device=g.device)
    return g.index_select(-2, _PERMS[key])


# ---------------------------------------------------------------------------
# limb-sharded NTT tables and transforms
# ---------------------------------------------------------------------------

def ntt_table_pytree(tables: nttmod.NttTables, device, mesh: Optional[Mesh] = None,
                     axis: str = "rp") -> dict:
    """The NTT constants as ``int64`` tensors on ``device`` (limb axis
    leading, :func:`table_specs`), with ``"tables"``, the
    :class:`NttTables` the transforms route through. With ``mesh``: this
    rank's limb block, its tables sliced once here (``NttTables.select``)."""
    if mesh is not None:
        tables = tables.select(limb_rows(len(tables.primes), mesh, axis))
    d = dict(tables.on(device))
    d["ninv"] = tables.mp.on(device).ninv
    d["tables"] = tables
    return d


def table_specs() -> dict:
    """The partition of :func:`ntt_table_pytree`: limb axis on 'rp'."""
    return {"p": ("rp", None), "rinv": ("rp", None), "ninv": ("rp", None),
            "psi_pow": ("rp", None), "psi_ipow": ("rp", None),
            "tw": ("rp", None, None), "twi": ("rp", None, None), "bitrev": (None,)}


def _transform(x: torch.Tensor, tables: nttmod.NttTables, inverse: bool, lazy: bool):
    if lazy:
        from ..ops import ntt_cuda
        if max(tables.primes) >= ntt_cuda.LAZY_PRIME_LIMIT:
            raise ValueError("lazy butterflies need every prime below 2^30")
        if x.is_cuda:
            return ntt_cuda.launch_cluster(tables, x.contiguous(), inverse, lazy=True)
    return nttmod.intt(tables, x) if inverse else nttmod.ntt(tables, x)


def ntt_p(x: torch.Tensor, tabs: dict, lazy: bool = False) -> torch.Tensor:
    """Forward negacyclic NTT of [..., L_loc, N] over the rank's limb block
    (``tabs`` from :func:`ntt_table_pytree`): K1 on a CUDA tensor, the
    plain twin on the CPU. ``lazy=True`` forces K1's lazy butterflies (all
    primes below 2^30); the values are the same either way."""
    return _transform(x, tabs["tables"], False, lazy)


def intt_p(x: torch.Tensor, tabs: dict, lazy: bool = False) -> torch.Tensor:
    """Inverse of :func:`ntt_p`."""
    return _transform(x, tabs["tables"], True, lazy)


# ---------------------------------------------------------------------------
# coefficient-axis (sequence-parallel) sharded four-step NTT
# ---------------------------------------------------------------------------
#
# N = N1·N2, Xmat[j1, j2] = x[j1·N2 + j2] sharded along j2:
#   A = W_{N1}·Xmat (local), B = A ⊙ ω^{k1·j2} (local),
#   all_to_all: j2-sharded → k1-sharded,
#   C = B·W_{N2} (local), X[k1 + N1·k2] = C[k1, k2] sharded along k1.
# The modular matrix products are the digit products of ops/ntt_mxu.py.

def coeff_shard_layout(n: int, n2: int, nshards: int):
    """Host index maps of the sharded four-step layout: ``in_src[pos]`` the
    natural coefficient at global position ``pos`` of the concatenated
    input blocks (shard s owns columns j2 of its block, j1-major locally),
    ``out_nat[pos]`` the natural dual index at ``pos`` of the output
    blocks (shard s owns rows k1 of its block, k2-major locally)."""
    N1 = n // n2
    npb = n2 // nshards
    k1pb = N1 // nshards
    pos = np.arange(n)
    shard_i = pos // (n // nshards)
    within = pos % (n // nshards)
    j1 = within // npb
    j2 = shard_i * npb + within % npb
    in_src = j1 * n2 + j2
    k2 = within // k1pb
    k1 = shard_i * k1pb + within % k1pb
    out_nat = k1 + N1 * k2
    return in_src, out_nat


def mxu_table_pytree(mxu_tables, nshards: int, device) -> dict:
    """Four-step constants as ``int64`` tensors on ``device``, shardable over
    the limb axis ('rp') and the coefficient axis ('cp')
    (:func:`mxu_table_specs`); the ψ tables are permuted into
    :func:`coeff_shard_layout`'s input layout, so a plain 'cp' block hands
    each shard its part. Assumes the n1 = 128 factorization."""
    mt = mxu_tables
    if getattr(mt, "n1", 128) != 128:
        raise ValueError("the coefficient-sharded four-step assumes n1 = 128")
    in_src, _ = coeff_shard_layout(mt.n, mt.n2, nshards)
    t = lambda a: modmath.as_residues(a, device)
    mp = mt.mp
    return {"p": t(mp.p), "ninv": t(mp.ninv), "r2": t(mp.r2), "r1": t(mp.r1),
            "half": t(mp.half), "rinv": t(mp.rinv),
            "cs": t(mt.cs), "corr": t(mt.corr), "r1m": t(mt.r1_mont), "him": t(mt.hi_mont),
            "w1": t(mt.w1), "w1i": t(mt.w1i), "w2": t(mt.w2), "w2i": t(mt.w2i),
            "tw": t(mt.tw), "twi": t(mt.twi),
            "psi": t(np.asarray(mt.psi_pow)[:, in_src]),
            "ipsi": t(np.asarray(mt.psi_ipow)[:, in_src])}


def mxu_table_specs() -> dict:
    """Partition of :func:`mxu_table_pytree`: limb axis on 'rp'; the
    j2-indexed tables (tw, ψ) on 'cp'; twi on 'cp' along its k1 axis."""
    r = ("rp", None)
    return {"p": r, "ninv": r, "r2": r, "r1": r, "half": r, "rinv": r,
            "cs": (None, "rp", None, None), "corr": ("rp", None, None),
            "r1m": ("rp", None, None), "him": ("rp", None, None),
            "w1": ("rp", None, None, None), "w1i": ("rp", None, None, None),
            "w2": ("rp", None, None, None), "w2i": ("rp", None, None, None),
            "tw": ("rp", None, "cp"), "twi": ("rp", "cp", None),
            "psi": ("rp", "cp"), "ipsi": ("rp", "cp")}


def _mp_local(ct: dict) -> MontParams:
    return MontParams(p=ct["p"], ninv=ct["ninv"], r2=ct["r2"], r1=ct["r1"],
                      half=ct["half"], rinv=ct["rinv"])


def _mod_matmul(x, w, ct: dict, mp3: MontParams):
    from ..ops import ntt_mxu as MX
    return MX._mod_matmul_c(MX._balanced_digits_device(x), w, ct["cs"], ct["r1m"],
                            ct["him"], ct["corr"], mp3)


def mxu2_ntt_local(x: torch.Tensor, ct: dict, mesh: Mesh, axis_name: str = "cp",
                   site: str = "ntt_stage_exchange") -> torch.Tensor:
    """Forward four-step negacyclic NTT with every table local: x
    [..., L_loc, N_loc] primal in the input layout → the dual in the output
    layout. One all-to-all over ``axis_name``."""
    from ..ops import ntt_mxu as MX
    mpl = _mp_local(ct)
    mp3 = mpl.expand()
    x = modmath.mont_mul(x, ct["psi"], mpl)
    npb = ct["tw"].shape[-1]
    xm = x.reshape(x.shape[:-1] + (MX.N1, npb))
    b = modmath.mont_mul(_mod_matmul(xm, ct["w1"], ct, mp3), ct["tw"], mp3)
    bt = all_to_all(b, mesh, axis_name, b.dim() - 2, b.dim() - 1, site)
    c = _mod_matmul(bt.transpose(-1, -2), ct["w2"], ct, mp3)
    return c.reshape(c.shape[:-2] + (c.shape[-2] * c.shape[-1],))


def mxu2_intt_local(y: torch.Tensor, ct: dict, mesh: Mesh, axis_name: str = "cp",
                    site: str = "ntt_stage_exchange") -> torch.Tensor:
    """Inverse of :func:`mxu2_ntt_local` (output layout → input layout), one
    all-to-all."""
    mpl = _mp_local(ct)
    mp3 = mpl.expand()
    n2 = ct["w2"].shape[-1]
    ym = y.reshape(y.shape[:-1] + (n2, y.shape[-1] // n2))
    d = modmath.mont_mul(_mod_matmul(ym, ct["w2i"], ct, mp3), ct["twi"].transpose(-1, -2), mp3)
    e = all_to_all(d, mesh, axis_name, d.dim() - 2, d.dim() - 1, site)
    x = _mod_matmul(e.transpose(-1, -2), ct["w1i"], ct, mp3)
    out = x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))
    return modmath.mont_mul(out, ct["ipsi"], mpl)


def _cp_tables(mxu_tables, nshards: int, mesh: Mesh, axis_name: str) -> dict:
    """The rank's 'cp' block of the four-step tables (limbs whole)."""
    specs = {k: tuple(axis_name if a == "cp" else None for a in s)
             for k, s in mxu_table_specs().items()}
    if mesh.shape[axis_name] != nshards:
        raise ValueError(f"{nshards} shards on a {axis_name!r} axis of {mesh.shape[axis_name]}")
    return shard_tree(mxu_table_pytree(mxu_tables, nshards, mesh.device), specs, mesh)


def coeff_sharded_ntt_fn(mxu_tables, nshards: int, axis_name: str = "cp", *, mesh: Mesh):
    """The rank's body of the forward NTT with the coefficient axis sharded
    over ``axis_name``: ``body(x_local [..., L, N/C])`` in the input layout
    → the dual in the output layout, one all-to-all. The rank's table
    blocks are cut here, once."""
    ct = _cp_tables(mxu_tables, nshards, mesh, axis_name)
    return lambda x_local: mxu2_ntt_local(x_local, ct, mesh, axis_name)


def coeff_sharded_intt_fn(mxu_tables, nshards: int, axis_name: str = "cp", *, mesh: Mesh):
    """The rank's body of the inverse transform: the dual in the output
    layout → coefficients in the input layout, one all-to-all."""
    ct = _cp_tables(mxu_tables, nshards, mesh, axis_name)
    return lambda y_local: mxu2_intt_local(y_local, ct, mesh, axis_name)


def coeff_sharded_galois_plan(n: int, n2: int, nshards: int, galois_element: int):
    """Host routing plan of x(X) ↦ x(X^g) on primal coefficients in
    :func:`coeff_shard_layout`'s input layout. The source column of a
    destination column j2 is (g⁻¹·j2) mod n2 for every j1, so whole columns
    move between shards: one padded all-to-all of C·B columns a shard (B
    the most any pair of shards exchanges) and a local gather.

    Returns (send_idx[C, C, B] local columns to ship, recv_map[C, N_loc]
    flat gather into the (N1, C·B) receive buffer, neg_mask[C, N_loc] sign
    flips, B)."""
    src, neg = nttmod.galois_perm_tables(n, galois_element)
    N1 = n // n2
    npb = n2 // nshards
    nloc = n // nshards
    col_src = src[np.arange(n2)] % n2
    if not np.all(src.reshape(N1, n2) % n2 == col_src):
        raise ValueError("the galois source column is not constant per destination column")
    lists = [[set() for _ in range(nshards)] for _ in range(nshards)]
    for s in range(nshards):
        for j2loc in range(npb):
            j2s = int(col_src[s * npb + j2loc])
            lists[j2s // npb][s].add(j2s % npb)
    lists = [[sorted(cell) for cell in row] for row in lists]
    B = max(1, max(len(cell) for row in lists for cell in row))
    send_idx = np.zeros((nshards, nshards, B), dtype=np.int32)
    for t, s in itertools.product(range(nshards), repeat=2):
        row = lists[t][s] or [0]
        send_idx[t, s] = row + [row[-1]] * (B - len(row))
    recv_map = np.zeros((nshards, nloc), dtype=np.int32)
    neg_mask = np.zeros((nshards, nloc), dtype=bool)
    for s in range(nshards):
        for pos in range(nloc):
            j1, j2loc = divmod(pos, npb)
            j = j1 * n2 + (s * npb + j2loc)
            j1s, j2s = divmod(int(src[j]), n2)
            t, cloc = divmod(j2s, npb)
            recv_map[s, pos] = j1s * (nshards * B) + t * B + lists[t][s].index(cloc)
            neg_mask[s, pos] = neg[j]
    return send_idx, recv_map, neg_mask, B


def coeff_sharded_galois_fn(mxu_tables, nshards: int, galois_element: int,
                            axis_name: str = "cp", *, mesh: Mesh):
    """The rank's body applying the galois permutation (with its sign flips)
    to [..., L, N/C] primal coefficients in the input layout: one padded
    all-to-all (:func:`coeff_sharded_galois_plan`)."""
    mt = mxu_tables
    N1 = mt.n // mt.n2
    npb = mt.n2 // nshards
    send_idx, recv_map, neg_mask, B = coeff_sharded_galois_plan(mt.n, mt.n2, nshards,
                                                                galois_element)
    me = mesh.index(axis_name)
    dev = mesh.device
    sidx = torch.as_tensor(send_idx[me].reshape(-1).astype(np.int64), device=dev)
    ridx = torch.as_tensor(recv_map[me].astype(np.int64), device=dev)
    negm = torch.as_tensor(neg_mask[me], device=dev)
    mp = mt.mp

    def body(x_local):
        lead = x_local.shape[:-1]
        xm = x_local.reshape(lead + (N1, npb))
        send = xm.index_select(-1, sidx).reshape(lead + (N1, nshards, B))
        recv = all_to_all(send, mesh, axis_name, len(lead) + 1, len(lead) + 2,
                          "galois_exchange")
        y = recv.reshape(lead + (N1 * nshards * B,)).index_select(-1, ridx)
        return torch.where(negm, modmath.neg_mod(y, mp), y)

    return body
