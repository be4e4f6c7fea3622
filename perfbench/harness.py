"""The harness: finds a cell's files by name and runs it.

Everything that belongs to one configuration, traffic mix, entry path,
reference or metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``perfbench/configs/<config>.json`` (the file the config's entry names);
- ``perfbench/workloads/<traffic>.json``, read by ``traffic.py``;
- ``perfbench/paths/<path>.py`` with a class ``Entry``, named by the
  config's ``path``;
- ``perfbench/reference/<reference>.py`` with ``reference`` and
  ``compare``, named by the config's ``reference``;
- ``perfbench/limits/<cell>.json``: the limit of each number compared;
- ``perfbench/metrics/<metric>.py`` with ``read(rec)``, one per metric;
  a metric ``<base>.<variant>`` with no file of its own (the same quantity
  under another name, in cells that report another end-to-end metric) is
  read by ``<base>.py``.

A run is closed-loop: an interval is one call of the entry's stepper, and
the next starts when the host has read the last one's telemetry.  Every
episode starts again from the seeded initial field, and the window ends at
the first episode's end past ``--seconds``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from . import trace
from . import traffic as generator

__all__ = ["Bench", "run_cell"]


class Bench:
    """The benchmark found under ``root`` (the checkout's root)."""

    def __init__(self, root):
        self.root = Path(root)
        self.dir = self.root / "perfbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def _entry(self, key, name):
        for item in self.spec[key]:
            if item["name"] == name:
                return item
        raise KeyError(f"BENCHMARK.json has no {key} entry named {name!r}")

    def cell(self, name):
        return self._entry("workloads", name)

    def config(self, name):
        return json.loads((self.root / self._entry("configs", name)["file"])
                          .read_text())

    def data(self, kind, name):
        return json.loads((self.dir / kind / f"{name}.json").read_text())

    def module(self, kind, name):
        path = self.dir / kind / f"{name}.py"
        key = f"_perfbench_{kind}_{name}_{abs(hash(str(path)))}"
        if key not in sys.modules:
            spec = importlib.util.spec_from_file_location(key, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[key] = mod
            spec.loader.exec_module(mod)
        return sys.modules[key]

    def reader(self, metric):
        """The module that reads ``metric``."""
        if not (self.dir / "metrics" / f"{metric}.py").is_file():
            metric = metric.split(".")[0]
        return self.module("metrics", metric)

    def metrics(self, cell, traced):
        """The metric entries a run of ``cell`` reports: its end-to-end
        metrics, or with ``traced`` its per-layer ones."""
        e2e = [m for m in self.spec["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not traced:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in moved
                                 else [])]


class _Clock:
    """Interval times: CUDA events on the card (the device's own clock), the
    host clock elsewhere."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return [ev]
        return [time.perf_counter()]

    def stop(self, mark):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            mark.append(ev)
        else:
            mark.append(time.perf_counter())

    def ms(self, mark):
        if self.cuda:
            return mark[0].elapsed_time(mark[1])
        return (mark[1] - mark[0]) * 1e3


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _drive(entry, intervals):
    """``intervals`` intervals from the start field, each read as the
    window reads it; returns the last field."""
    T = entry.start()
    for _ in range(intervals):
        T, telemetry = entry.interval(T)
        entry.interval_failed(telemetry.tolist())
    return T


def run_cell(bench, name, seed, seconds, traced, device, t_start):
    """One run of cell ``name``.  Returns the result's fields and the
    numbers compared, as ``(result, check)``."""
    cell = bench.cell(name)
    config = bench.config(cell["config"])
    traffic = bench.data("workloads", cell["traffic"])
    limits = bench.data("limits", name)
    path = bench.module("paths", config["path"])
    ref = bench.module("reference", config["reference"])
    steps, per_episode = generator.schedule(traffic)

    # --- set-up: inputs, the system under test, one whole episode ---------
    inputs = generator.make_inputs(config, traffic, seed, device)
    entry = path.Entry(config, traffic, inputs, device)
    entry.end_episode(_drive(entry, per_episode))
    _sync(device)
    setup_s = time.perf_counter() - t_start

    # --- the measured window ---------------------------------------------
    clock = _Clock(device)
    interval_ms, attempted, failed, k = [], 0, 0, 0
    T = entry.start()
    t0 = time.perf_counter()
    while True:
        mark = clock.start()
        T, telemetry = entry.interval(T)
        clock.stop(mark)
        failed += bool(entry.interval_failed(telemetry.tolist()))
        interval_ms.append(clock.ms(mark))
        attempted += 1
        k += 1
        if k == per_episode:
            entry.end_episode(T)
            T, k = entry.start(), 0
            # whole episodes only: every window does the same work a step
            if time.perf_counter() - t0 >= seconds:
                break
    window_s = time.perf_counter() - t0

    rec = dict(setup_s=setup_s, window_s=window_s, steps=attempted * steps,
               steps_per_interval=steps, interval_ms=interval_ms,
               capacity_s=entry.capacity_s, numel=entry.numel,
               itemsize=entry.itemsize, trace=None, syncs=None, launches=None,
               device_kind=(torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"))

    # --- traced readings, after the window ---------------------------------
    if traced:
        n_trace = int(traffic["trace_episodes"]) * per_episode
        rec["trace"] = trace.profile(lambda: _drive(entry, n_trace))
        if rec["trace"] is not None:
            rec["trace"]["steps"] = n_trace * steps
        before = entry.counters()["stencil_launches"]
        if device.type == "cuda":
            rec["syncs"] = (trace.count_syncs(
                lambda: _drive(entry, per_episode)), per_episode * steps)
        else:
            _drive(entry, per_episode)
        rec["launches"] = (entry.counters()["stencil_launches"] - before,
                           per_episode * steps)

    # --- the answers; then the program's state goes ------------------------
    answers = entry.answers()
    _sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del entry, T
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # --- the check ---------------------------------------------------------
    try:
        numbers = ref.compare(answers, ref.reference(config, traffic, inputs,
                                                     device), config)
    except RuntimeError as err:
        print(f"reference failed: {err}", file=sys.stderr)
        numbers = {key: math.inf for key in limits}
    check = {key: dict(value=numbers.get(key, math.inf), limit=limits[key])
             for key in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in check.values())

    metrics = {}
    for m in bench.metrics(name, traced):
        value = bench.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=rec["device_kind"], count=int(cell["chips"]),
               memory_peak_bytes=int(peak))
    result = dict(correct=correct, attempted=attempted, failed=failed,
                  metrics=metrics, device=dev)
    if traced and rec["trace"] is not None:
        s0, s1 = rec["trace"]["span"]
        busy = sum(e - s for s, e in trace.busy_intervals(
            rec["trace"]["device"]))
        dev["busy_s"] = busy * 1e-9
        dev["window_s"] = (s1 - s0) * 1e-9
        if rec["trace"]["device"]:
            result["breakdown"] = trace.breakdown(rec["trace"])
    return result, check
