"""What a traced run reads from ``torch.profiler`` and from the CUDA sync
debug mode, reduced to plain lists the metric readers take.

A profiled stretch is wrapped in one ``record_function`` span; its wall span
(host clock, in the profiler's time base) is the traced window.  The device
events inside it are kernels, copies and fills; the span's own annotation
on the device timeline is left out.
"""

from __future__ import annotations

import bisect
import warnings

import torch

__all__ = ["profile", "count_syncs", "busy_intervals", "breakdown"]

LABEL = "perfbench.window"


def _events(prof):
    """(host events, device events) as (name, start_ns, end_ns, thread)."""
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        start = int(e.start_ns())
        item = (e.name(), start, start + int(e.duration_ns()),
                int(e.start_thread_id()))
        (device if e.device_type() == torch.autograd.DeviceType.CUDA
         else host).append(item)
    return host, device


def profile(fn):
    """Run ``fn`` under the profiler; returns ``dict(span, host, device)``
    with times in ns and the device events inside the span only."""
    from torch.profiler import ProfilerActivity, profile as _profile, \
        record_function
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with _profile(activities=activities) as prof:
        with record_function(LABEL):
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    host, device = _events(prof)
    spans = [(s, e) for name, s, e, _ in host if name == LABEL]
    if not spans:
        return None
    s0, s1 = spans[0]
    device = [ev for ev in device if ev[0] != LABEL and ev[1] >= s0
              and ev[2] <= s1]
    host = [ev for ev in host if ev[0] != LABEL and ev[2] >= s0
            and ev[1] <= s1]
    return dict(span=(s0, s1), host=host, device=device)


def count_syncs(fn):
    """Run ``fn`` with CUDA sync debugging on; returns the number of calls
    that waited for the device."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def busy_intervals(device_events):
    """The union of the device events' intervals, merged and sorted."""
    merged = []
    for _, s, e, *_ in sorted(device_events, key=lambda ev: ev[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(host, thread, times, reach=64):
    """For each time, the name of the innermost host event on ``thread``
    that encloses it: events on one thread nest, so that is the latest one
    to start before it and end after it.  'python' where none of the
    ``reach`` latest to start does (the host was between operations)."""
    evs = sorted((ev for ev in host if ev[3] == thread), key=lambda ev: ev[1])
    starts = [ev[1] for ev in evs]
    out = []
    for t in times:
        i = bisect.bisect_right(starts, t)
        label = "python"
        for j in range(i - 1, max(i - 1 - reach, -1), -1):
            if evs[j][2] >= t:
                label = evs[j][0]
                break
        out.append(label)
    return out


def breakdown(rec, top=10):
    """``dict(device_ops, idle_gaps)``: device time by kernel name, and idle
    device time by the host operation it fell in, in seconds, largest
    first, ``top`` of each."""
    by_op = {}
    for name, s, e, *_ in rec["device"]:
        by_op[name] = by_op.get(name, 0.0) + (e - s) * 1e-9
    s0, s1 = rec["span"]
    gaps, prev = [], s0
    for s, e in busy_intervals(rec["device"]) + [[s1, s1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    threads = {}
    for ev in rec["host"]:
        threads[ev[3]] = threads.get(ev[3], 0) + 1
    main = max(threads, key=threads.get) if threads else None
    labels = _innermost(rec["host"], main, [(a + b) // 2 for a, b in gaps])
    by_gap = {}
    for (a, b), label in zip(gaps, labels):
        by_gap[label] = by_gap.get(label, 0.0) + (b - a) * 1e-9
    order = lambda d: sorted(([k, v] for k, v in d.items()),
                             key=lambda kv: -kv[1])[:top]
    return dict(device_ops=order(by_op), idle_gaps=order(by_gap))
