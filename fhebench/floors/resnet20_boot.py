"""The byte floor of one request of the encrypted ResNet-20: the least bytes
it moves at least once, at 4 bytes a residue.

Counted from the configuration alone, frozen here out of the program's
reach: the input image; every evaluation key once, at the level of its
largest use — the pipeline's Galois keys (one a rotation of its plans),
the relinearization key, the refresh's conjugation and rotation keys; every
encoded weight, mask and bias vector once at its level, and the refresh's
transform diagonals; the returned logits.

The levels follow the recipe's tower (``bootstrap.make_boot_ring``: two
base limbs, ``depth`` level limbs, dnum = ⌊(depth + 2)/5⌋ digits, k =
⌈(depth + 2)/dnum⌉ + 1 raising limbs). A refresh at N = 2^13 and radix 16
spends 35 limbs (48 in, 13 out at depth 46: the bootstrapped MNIST
pipeline's record), so it hands the layers depth + 2 − 35 limbs; the
first conv's input holds the two base limbs, one for the alignment to the
refresh, two for the conv and the ReLU's; a stride-2 conv spends one limb
before its repack. The ReLU spends, for each
component of degree d, ⌈log₂(d + 1)⌉ + 1 limbs, one to set the scale of
each component after the first, and one for its product.
Where the level of a use is not plain from the configuration a lower one
is taken (the refresh's relinearization key at its ReLU use, EvalMod's and
SlotToCoeff's keys at the base), so the floor stays a floor.
"""

from __future__ import annotations

import math

from fhebench import work

REFRESH_LIMBS = 35          # limbs a refresh spends at N = 2^13, radix 16
TAPS = 9


def _layouts(model: dict, slots: int) -> list:
    """(side, channel slots a ciphertext, ciphertexts) of the input and of
    each stage."""
    side, out = model["image"], []
    for channels in [model["in_channels"]] + list(model["widths"]):
        cpc = slots // (side * side)
        out.append((side, cpc, -(-channels // cpc)))
        if len(out) > 1:
            side //= 2
    return out


def parts(config: dict) -> dict:
    """The counts the floor is made of: ``keys`` (the pipeline's rotation
    shifts), ``vectors`` [(name, vectors, limbs)] of the encoded weights,
    masks and biases, ``tower`` (data limbs, raising limbs, dnum) and
    ``layer_limbs`` (the limbs a refresh hands the layers)."""
    model, r = config["model"], config["recipe"]
    n = 1 << model["ring_logn"]
    slots = n // 2
    depth = r["depth"]
    dnum = max(1, (depth + 2) // 5)
    data, special = depth + 2, -(-(depth + 2) // dnum) + 1
    out_limbs = data - REFRESH_LIMBS
    degrees = model["relu"]["degrees"]
    relu = sum(math.ceil(math.log2(d + 1)) + 1 for d in degrees) + len(degrees)
    top = 2 + 1 + 2 + relu
    lays = _layouts(model, slots)
    blocks = model["blocks_per_stage"]
    shifts = set()
    def conv(n_out, cpc, n_in, cin):
        # a vector a (output, channel offset, input, tap); a ciphertext of
        # cin channels needs at least min(cpc, cin) offsets (all at full width)
        return n_out * min(cpc, cin) * n_in * TAPS + n_out

    vectors = [("stem", conv(lays[1][2], lays[1][1], lays[0][2], model["in_channels"]), top)]
    for i in range(len(model["widths"])):
        side, cpc, n_ct = lays[i + 1]
        hw = side * side
        m = math.isqrt(cpc - 1) + 1 if cpc > 1 else 1
        shifts |= {dy * side + dx for dy in (-1, 0, 1) for dx in (-1, 0, 1)}
        shifts |= {d % m * hw for d in range(cpc)} | {d // m * m * hw for d in range(cpc)}
        width = model["widths"][i]
        for j in range(blocks):
            if i and not j:
                pside, pcpc, pct = lays[i]
                half = pside // 2
                cin = model["widths"][i - 1]
                vectors.append((f"s{i}.b{j}.conv1", conv(2 * pct, pcpc, pct, cin), out_limbs))
                vectors.append((f"s{i}.b{j}.repack", 2 * pct * half * half, out_limbs - 1))
                vectors.append((f"s{i}.b{j}.shortcut", pct * half * half, out_limbs))
                shifts |= set(range(half)) | {3 * pside * y // 2 for y in range(half)}
                shifts |= {-k * pside * pside // 4 for k in range(4)}
            else:
                vectors.append((f"s{i}.b{j}.conv1", conv(n_ct, cpc, n_ct, width), out_limbs))
            vectors.append((f"s{i}.b{j}.conv2", conv(n_ct, cpc, n_ct, width), out_limbs))
    side, cpc, n_ct = lays[-1]
    hw = side * side
    vectors.append(("fc", min(cpc, model["widths"][-1]) * n_ct + 1, out_limbs - 2 - relu - 1))
    k = hw // 2
    while k:
        shifts.add(k)
        k //= 2
    return {"keys": sorted({s % slots for s in shifts} - {0}), "vectors": vectors,
            "tower": (data, special, dnum), "layer_limbs": out_limbs}


def floor_bytes(config: dict, encoded_inputs: bool) -> int:
    model, r = config["model"], config["recipe"]
    n = 1 << model["ring_logn"]
    p = parts(config)
    data, special, dnum = p["tower"]
    t = work.Tower(n, data, special, dnum)
    L, sl, lo = t.data, r["scale_limbs"], p["layer_limbs"]
    keys = [(("rotation", s), t.key(lo)) for s in p["keys"]]
    keys += [("relin", t.key(lo)), ("public", 2 * t.poly(L))]
    plain = sum(count * t.poly(limbs) for _, count, limbs in p["vectors"])
    keys += [("conjugation", t.key(L))]
    for i, offsets in enumerate(work.sfft_level_offsets(n // 2, r["radix"])):
        level = L - sl * i
        keys += [(("refresh rotation", s), t.key(level))
                 for s in work.bsgs_rotation_steps(offsets, n // 2)]
        plain += 4 * len(offsets) * t.poly(level)
    for offsets in reversed(work.sfft_level_offsets(n // 2, r["radix"])):
        keys += [(("refresh rotation", s), t.key(sl))
                 for s in work.bsgs_rotation_steps(offsets, n // 2)]
        plain += 2 * len(offsets) * t.poly(sl)
    side = model["image"]
    slots = n // 2
    cts = -(-model["in_channels"] // (slots // (side * side)))
    inputs = (cts * t.poly(p["vectors"][0][2]) if encoded_inputs
              else model["in_channels"] * side * side * work.FLOAT_BYTES)
    logits = model["classes"] * work.FLOAT_BYTES
    return inputs + work._keys(keys) + plain + logits
