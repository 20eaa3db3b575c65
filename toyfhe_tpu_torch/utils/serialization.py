"""Key and ciphertext serialization.

Port of ``toyfhe_tpu/utils/serialization.py``, writing the reference's own
file format: one ``np.savez_compressed`` file per object, a JSON ``header``
(the object's kind, its ring as ``n``, ``primes`` and ``psis``, which of the
primal and dual tensors each ring element carries, a CKKS scale as numerator
and denominator) and the residues as ``uint32`` arrays under the reference's
names (``c0.dual``, ``k3.masked.primal``, ``pub.mask.dual``, ...). A file
written by either package loads in the other.

Loaders take the scheme parameters the caller rebuilt (as in the reference,
parameters are not serialized) and the ``device`` the tensors go to. A
stored tower that is the parameters' key tower or a prefix of it reuses that
ring (the port's cached tables and key stacks hang off ring identity);
another tower gets a ring of its own.
"""

from __future__ import annotations

import json
from fractions import Fraction
from typing import Dict

import numpy as np
import torch

from ..core import rlwe
from ..core.ckks_encoding import CKKSTag
from ..core.ring import RingContext, RingElt


def _ring_meta(ring: RingContext) -> dict:
    return {"n": ring.n, "primes": [str(p) for p in ring.primes],
            "psis": [str(p) for p in ring.psis]}


def ring_from_meta(meta: dict) -> RingContext:
    return RingContext(meta["n"], [int(p) for p in meta["primes"]],
                       [int(p) for p in meta["psis"]])


def _put_elt(arrays: dict, prefix: str, x: RingElt) -> dict:
    info = {}
    for domain in ("primal", "dual"):
        t = getattr(x, domain)
        if t is not None:
            arrays[f"{prefix}.{domain}"] = t.cpu().numpy().astype(np.uint32)
            info[domain] = True
    return info


def _get_elt(arrays, prefix: str, info: dict, device) -> RingElt:
    def get(domain):
        if not info.get(domain):
            return None
        return torch.as_tensor(arrays[f"{prefix}.{domain}"].astype(np.int64), device=device)
    return RingElt(primal=get("primal"), dual=get("dual"))


def _save(path: str, header: dict, arrays: Dict[str, np.ndarray]) -> None:
    arrays["header"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def _load(path: str, kind: str):
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    header = json.loads(bytes(arrays.pop("header")).decode())
    if header.get("kind") != kind:
        raise ValueError(f"{path} holds a {header.get('kind')!r}, not a {kind!r}")
    return header, arrays


def _resolve_ring(params, meta: dict) -> RingContext:
    """Reuse the params' ring chain when the serialized tower is the key
    tower or one of its prefixes; else a ring from the file's metadata."""
    primes = [int(p) for p in meta["primes"]]
    ring = params.ring_key
    while ring.nlimbs > len(primes):
        ring = ring.drop_last()
    if ring.primes == primes and ring.n == meta["n"]:
        return ring
    return ring_from_meta(meta)


def save_ciphertext(path: str, c: rlwe.CipherText) -> None:
    arrays: Dict[str, np.ndarray] = {}
    comps = [_put_elt(arrays, f"c{i}", x) for i, x in enumerate(c.cs)]
    header = {"kind": "ciphertext", "ring": _ring_meta(c.ring),
              "ncomp": len(c.cs), "comps": comps}
    if isinstance(c.enc, CKKSTag):
        header["scale"] = [str(c.enc.scale.numerator), str(c.enc.scale.denominator)]
    _save(path, header, arrays)


def load_ciphertext(path: str, params, *, device) -> rlwe.CipherText:
    header, z = _load(path, "ciphertext")
    ring = _resolve_ring(params, header["ring"])
    cs = tuple(_get_elt(z, f"c{i}", info, device) for i, info in enumerate(header["comps"]))
    enc = None
    if "scale" in header:
        enc = CKKSTag(Fraction(int(header["scale"][0]), int(header["scale"][1])))
    return rlwe.CipherText(params, cs, ring, enc=enc)


def _put_components(arrays: dict, ksk: rlwe.KeySwitchKey) -> list:
    return [{"mask": _put_elt(arrays, f"k{i}.mask", kc.mask),
             "masked": _put_elt(arrays, f"k{i}.masked", kc.masked)}
            for i, kc in enumerate(ksk.key)]


def _get_components(z, header: dict, device) -> list:
    return [rlwe.KeyComponent(mask=_get_elt(z, f"k{i}.mask", info["mask"], device),
                              masked=_get_elt(z, f"k{i}.masked", info["masked"], device))
            for i, info in enumerate(header["comps"])]


def save_keyswitch_key(path: str, ksk: rlwe.KeySwitchKey) -> None:
    arrays: Dict[str, np.ndarray] = {}
    comps = _put_components(arrays, ksk)
    _save(path, {"kind": "keyswitch_key", "ring": _ring_meta(ksk.ring),
                 "ndig": len(ksk.key), "comps": comps}, arrays)


def load_keyswitch_key(path: str, params, *, device) -> rlwe.KeySwitchKey:
    header, z = _load(path, "keyswitch_key")
    ring = _resolve_ring(params, header["ring"])
    return rlwe.KeySwitchKey(params, _get_components(z, header, device), ring)


def save_keypair(path: str, kp: rlwe.KeyPair) -> None:
    arrays: Dict[str, np.ndarray] = {}
    header = {
        "kind": "keypair",
        "ring": _ring_meta(kp.priv.params.ring_key),
        "secret": _put_elt(arrays, "secret", kp.priv.secret),
        "mask": _put_elt(arrays, "pub.mask", kp.pub.key.mask),
        "masked": _put_elt(arrays, "pub.masked", kp.pub.key.masked),
    }
    _save(path, header, arrays)


def load_keypair(path: str, params, *, device) -> rlwe.KeyPair:
    header, z = _load(path, "keypair")
    priv = rlwe.PrivKey(params, _get_elt(z, "secret", header["secret"], device))
    pub = rlwe.PubKey(params, rlwe.KeyComponent(
        mask=_get_elt(z, "pub.mask", header["mask"], device),
        masked=_get_elt(z, "pub.masked", header["masked"], device)))
    return rlwe.KeyPair(priv, pub)


def save_eval_mult_key(path: str, ek: rlwe.EvalMultKey) -> None:
    save_keyswitch_key(path, ek.key)


def load_eval_mult_key(path: str, params, *, device) -> rlwe.EvalMultKey:
    return rlwe.EvalMultKey(load_keyswitch_key(path, params, device=device))


def save_galois_key(path: str, gk: rlwe.GaloisKey) -> None:
    arrays: Dict[str, np.ndarray] = {}
    comps = _put_components(arrays, gk.key)
    _save(path, {"kind": "galois_key", "galois_element": gk.galois_element,
                 "ring": _ring_meta(gk.key.ring), "comps": comps}, arrays)


def load_galois_key(path: str, params, *, device) -> rlwe.GaloisKey:
    header, z = _load(path, "galois_key")
    ring = _resolve_ring(params, header["ring"])
    return rlwe.GaloisKey(header["galois_element"],
                          rlwe.KeySwitchKey(params, _get_components(z, header, device), ring))
