"""One run of one cell: set-up, warm-up, the measured window, the check of
every answer against the plain reference, and the result line.

Everything is found by name: the cell in ``BENCHMARK.json``; its
configuration in the file the entry names; the configuration's system in
``fhebench/systems/<system>.py`` and its plain reference in
``fhebench/reference/<reference>.py``; the traffic mix in
``fhebench/traffic/<mix>.json``; each metric's reader in
``fhebench/metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import trace as T
from . import work
from .client import Client, Requests, images

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
WARMUP_REQUESTS = 2          # the first captures every graph, the second replays them
CHUNK_S = 0.25               # a traced chunk: requests until this much host time
PROFILED_CHUNKS = 8          # profiled chunks a traced window holds at most
FORBIDDEN = ("jax", "jaxlib", "flax", "toyfhe_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(kind: str, name: str, here: Path = HERE):
    """``<here>/<kind>/<name>.py`` as ``fhebench.<kind>.<name>``."""
    path = here / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"fhebench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: dict, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries the cell reports."""
    return [m for m in bench[kind] if cell["name"] in m.get("workloads", [cell["name"]])]


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must never load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Window:
    """What the readers of ``fhebench/metrics`` read."""

    def __init__(self, config: dict, mix: dict, setup_s: float):
        self.config, self.mix, self.setup_s = config, mix, setup_s
        self.images_per_request = work.model_shape(config["model"])[1]
        self.encoded_inputs = not mix["encode_in_request"]
        self.latencies_s: list = []       # every request of the window
        self.seconds = 0.0                # first request sent to last answer back
        self.stages: list = []            # traced: {stage: ms} of each clocked request
        self.chunks: list = []            # traced: one summary a profiled chunk

    def mean_stage_ms(self, pick):
        """Mean over the clocked requests of the summed stages ``pick``
        selects, or None when no request has any of them."""
        per = [sum(v for k, v in st.items() if pick(k)) for st in self.stages
               if any(pick(k) for k in st)]
        return sum(per) / len(per) if per else None


def measure(client: Client, seconds: float, traced: bool, device, win: Window) -> list:
    """Closed-loop requests for ``seconds``; returns [(index, logits)].

    Traced, the window alternates profiled chunks (no stage clock; at most
    ``PROFILED_CHUNKS``) with chunks whose requests carry the stage clock."""
    answers = []

    def one(stages=None) -> None:
        i = len(answers)
        imgs = client.batch(i)
        t = time.perf_counter()
        logits = client.request(i, imgs, stages)
        win.latencies_s.append(time.perf_counter() - t)
        answers.append((i, np.asarray(logits, dtype=np.float64)))

    def chunk(clocked: bool) -> int:
        c0, n = time.perf_counter(), 0
        while n == 0 or time.perf_counter() - c0 < CHUNK_S:
            if clocked:
                win.stages.append({})
            one(win.stages[-1] if clocked else None)
            n += 1
        return n

    t0 = time.perf_counter()
    profile_next = True
    while time.perf_counter() - t0 < seconds:
        if not traced:
            one()
        elif profile_next and len(win.chunks) < PROFILED_CHUNKS:
            win.chunks.append(T.profile_chunk(lambda: chunk(False), device))
            profile_next = False
        else:
            chunk(True)
            profile_next = True
    win.seconds = time.perf_counter() - t0
    return answers


UNIT_BITS = 11    # the judge's unit: the reference's pass at float16's precision


def judge(answers, client: Requests, reference, model: dict, weights: dict, limits: dict):
    """Every answer of the window against the plain reference on the same
    images and weights. Per request, with the program's logits P, the
    reference's R and the reference's pass at float16's precision F (every
    operand and result rounded to 11 significant bits), all [classes, B]:

    * ``logit_f16`` — rms(P − R) / rms(F − R): the request's gap in float16
      roundings of the same pass;
    * ``image_f16`` — the largest over the request's images of the RMS of
      that image's gap, in the same unit: one image wrong shows undiluted;
    * ``logit_rms_rel`` — rms(P − R) / rms(R);
    * ``logit_gap_rel`` — max |P − R| / max |R|.

    Each reading is the largest over all requests. Returns (readings,
    failed requests: those over a limit, or not finite)."""
    refs: dict = {}
    worst = {"logit_f16": 0.0, "image_f16": 0.0, "logit_rms_rel": 0.0, "logit_gap_rel": 0.0}
    failed = 0
    for i, got in answers:
        key = i % len(client.pool) if client.pool else i
        if key not in refs:
            imgs = client.batch(i)
            want = reference.forward(model, weights, imgs).T                  # [classes, B]
            unit = reference.forward(model, weights, imgs, bits=UNIT_BITS).T - want
            refs[key] = (want, float(np.sqrt(np.mean(unit * unit))))
        want, unit = refs[key]
        if got.shape != want.shape or not np.all(np.isfinite(got)):
            failed += 1
            worst = {k: float("inf") for k in worst}
            continue
        d = got - want
        read = {"logit_f16": float(np.sqrt(np.mean(d * d))) / unit,
                "image_f16": float(np.sqrt(np.max(np.mean(d * d, axis=0)))) / unit,
                "logit_rms_rel": float(np.sqrt(np.mean(d * d) / np.mean(want * want))),
                "logit_gap_rel": float(np.max(np.abs(d)) / np.max(np.abs(want)))}
        if any(read[k] > v for k, v in limits.items()):
            failed += 1
        worst = {k: max(v, read[k]) for k, v in worst.items()}
    return worst, failed


def seed_words(seed: int) -> int:
    return seed % (1 << 63)


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, traced: bool, device,
             t_start: float, here: Path = HERE, root: Path = ROOT) -> dict:
    """One run of ``cell``; the result line as a dict."""
    entry = find(bench["configs"], cell["config"], "configuration")
    config = load_json(root / entry["file"])
    mix = load_json(here / "traffic" / f"{cell['traffic']}.json")
    reference = load_module("reference", config["reference"], here)
    system_mod = load_module("systems", config["system"], here)
    s = seed_words(seed)
    weights = reference.init_params(config["model"], np.random.default_rng([s, 1]))
    gen = torch.Generator(device=device).manual_seed(s)
    phases = {"start": time.perf_counter() - t_start}
    system = system_mod.System(config, weights, gen)
    phases["keys_and_pipeline"] = time.perf_counter() - t_start - sum(phases.values())
    client = Client(system, mix, config["model"], s, gen, device)
    phases["pool"] = time.perf_counter() - t_start - sum(phases.values())
    for w in range(WARMUP_REQUESTS):
        client.request(w, images(mix, config["model"], s, (1 << 40) + w))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phases["warmup"] = time.perf_counter() - t_start - sum(phases.values())
    win = Window(config, mix, time.perf_counter() - t_start)
    answers = measure(client, seconds, traced, device, win)

    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, cell, kind):
        value = load_module("metrics", m["name"], here).read(win)
        if value is None and kind == "end_to_end":
            raise RuntimeError(f"the end-to-end metric {m['name']} read nothing")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}
    if traced:
        dev["busy_s"] = sum(c["busy_s"] for c in win.chunks)
        dev["window_s"] = sum(c["wall_s"] for c in win.chunks)

    del system, client.system, client.encoded
    if device.type == "cuda":
        torch.cuda.empty_cache()
    limits = config["limits"]
    readings, failed = judge(answers, client, reference, config["model"], weights, limits)
    result = {"correct": failed == 0 and all(readings[k] <= v for k, v in limits.items()),
              "attempted": len(answers), "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = T.breakdown(win.chunks)
        result["k1_check"] = [[c["k1_kernels"], c["k1_launches"]] for c in win.chunks]
    result["setup_phases_s"] = phases
    result["readings"] = {k: v for k, v in readings.items() if k not in limits}
    result["compared"] = {k: {"value": readings[k], "limit": v} for k, v in limits.items()}
    return result


def compared_lines(result: dict) -> list:
    return [f"compared {k} {c['value']!r} limit {c['limit']!r}"
            for k, c in result["compared"].items()]
