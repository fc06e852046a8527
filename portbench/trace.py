"""The traced window: ``torch.profiler`` (CPU and CUDA activity) around the
measured jobs, read back from its Chrome trace.

From the trace: the window's length (the span ``portbench.window`` that the
harness opens around the jobs), the seconds in which the card ran any
kernel, copy or fill (the union of their intervals inside the window), the
kernels' summed seconds, the device operations that took the most time,
and the idle gaps of the card named by the innermost host operation of the
harness's thread that spans each gap's middle.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
from collections import defaultdict

import numpy as np
import torch

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
NO_OP = "host (no profiled op)"
TOP = 10


class TracedWindow:
    """Context manager: profile what runs inside, write the trace to ``path``."""

    def __init__(self, path: str):
        self.path = path
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                       torch.profiler.ProfilerActivity.CUDA])
        self.span = torch.profiler.record_function(WINDOW)

    def __enter__(self):
        self.prof.__enter__()
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.span.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.prof.export_chrome_trace(self.path)
        return False


@contextlib.contextmanager
def spans(points):
    """While inside, each (owner, attribute, span name) of ``points`` runs in
    a ``record_function`` span of that name: a function around each call, a
    name ending in ``" wait"`` around each item its iterator yields.  The
    harness's own spans around calls into the program's layers; the
    attributes are restored on leaving."""
    saved = []
    try:
        for owner, attr, name in points:
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn))
            setattr(owner, attr, _iter_span(fn, name) if name.endswith(" wait")
                    else _call_span(fn, name))
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def _call_span(fn, name):
    @functools.wraps(fn)
    def spanned(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)

    return spanned


def _iter_span(fn, name):
    @functools.wraps(fn)
    def spanned(*a, **kw):
        it = iter(fn(*a, **kw))
        while True:
            with torch.profiler.record_function(name):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item

    return spanned


def _union(iv: np.ndarray) -> np.ndarray:
    """Sorted disjoint intervals covering the [n, 2] intervals ``iv``."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > reach[:-1]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    ends = reach[np.append(idx[1:] - 1, len(iv) - 1)]
    return np.stack([starts, ends], 1)


def _innermost(host: list, points: np.ndarray) -> list:
    """For each point, the name of the innermost host event spanning it."""
    host = sorted(host, key=lambda e: (e[0], -e[1]))
    starts = np.array([e[0] for e in host])
    parent, stack = [], []
    for i, (s, e, _) in enumerate(host):  # events of one thread nest
        while stack and host[stack[-1]][1] < s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    names = []
    for m in points:
        i = int(np.searchsorted(starts, m, side="right")) - 1
        while i >= 0 and host[i][1] < m:
            i = parent[i]
        names.append(host[i][2] if i >= 0 else NO_OP)
    return names


def read_trace(path: str) -> dict | None:
    """-> {window_s, busy_s, kernel_s, device_ops, idle_gaps}, or None when
    the trace holds no window span or no device activity."""
    with open(path) as fh:
        events = [e for e in json.load(fh).get("traceEvents", []) if e.get("ph") == "X"]
    spans = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not spans:
        return None
    w = spans[0]
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    iv = np.array([[max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"]))]
                   for e in dev], dtype=np.float64).reshape(-1, 2)
    keep = iv[:, 1] > iv[:, 0]
    dev = [e for e, k in zip(dev, keep) if k]
    iv = iv[keep]
    if not len(iv):
        return None
    busy = _union(iv)
    by_name: dict = defaultdict(float)
    kernel_us = 0.0
    for e, (a, b) in zip(dev, iv):
        by_name[e["name"]] += (b - a) * 1e-6
        if e["cat"] == "kernel":
            kernel_us += b - a
    edges = np.concatenate([[w0], busy.ravel(), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
            if e.get("cat") in HOST_CATS and e.get("tid") == w.get("tid")
            and e.get("pid") == w.get("pid") and e is not w]
    gap_names: dict = defaultdict(float)
    for name, (a, b) in zip(_innermost(host, gaps.mean(1)), gaps):
        gap_names[name] += (b - a) * 1e-6
    top = sorted(by_name.items(), key=lambda x: -x[1])[:TOP]
    idle = sorted(gap_names.items(), key=lambda x: -x[1])[:TOP]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": float((busy[:, 1] - busy[:, 0]).sum()) * 1e-6,
            "kernel_s": kernel_us * 1e-6, "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in idle]}


def traced_record(path: str) -> dict | None:
    """read_trace, then the trace file removed (the run writes little to disk)."""
    try:
        return read_trace(path)
    finally:
        if os.path.exists(path):
            os.remove(path)
