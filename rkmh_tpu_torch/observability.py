"""Observability: the run's counters and metrics line, its spans, and a
profiler trace.

* Counters (``count``): process-wide plain numbers, reset at the start of
  each run; the input layer counts reads and bp as batches are made, at
  the points where rkmh-tpu counts them, so one input gives the same
  integers in both packages.  ``RKMH_TPU_METRICS=1`` (or the CLI's
  ``--metrics``): on exit, one JSON line to stderr with rkmh-tpu's keys:
  the command, wall seconds, the reads and bp processed and their rates.
* Spans (``span``): the program's one tracer.  A span is a context manager
  around one piece of work (a chunk, a batch, a phase; never a read) that
  takes two ``perf_counter_ns`` stamps and gives its ``seconds`` whatever
  the state of tracing, for the clocks the commands report
  (``Hpv16Tables.setup_s``, ``call_cmd.run(stats=)``).  A command's
  ``run()`` opens one run (``traced``); tracing is on for it exactly when
  a torch profiler is active as the outermost run starts.  Then each span
  is also recorded into the run, with its enclosing span on its thread
  (else the run's root) as parent, its thread and its bytes, and on the
  run's thread it opens a ``record_function`` of its name, so that it lands
  in the profiler's trace.  Finished runs are kept, the newest
  ``MAX_RUNS`` (``finished_runs``).  With tracing off a span costs its two
  stamps and one test.
* ``RKMH_TPU_PROFILE=<dir>``: the run inside ``torch.profiler.profile``
  (CPU activity, and CUDA activity where a card is present), its Chrome
  trace written into ``<dir>`` as ``trace.json``; open it in Perfetto or
  ``chrome://tracing`` for per-kernel device time.  The profiler records
  no ``record_function`` opened on another thread, so the spans of the
  other threads (the reader thread's ``input.parse``, ``input.unpack``,
  ``input.handoff``) are added to that file as events of their own thread,
  on the trace's clock (through the run's anchor pair of wall and
  ``perf_counter`` stamps).

Span names: ``run`` (the root), ``input.parse`` / ``input.unpack`` /
``input.handoff`` / ``input.wait`` (host input), ``device.h2d`` /
``device.fetch`` (copies, with their bytes), ``output.format`` /
``output.emit`` (host output), ``counter.pass``, ``hpv16.tables.<phase>``,
``call.parse`` / ``call.depth_map.<phase>`` / ``call.scan``,
``dist.join`` (a --dist-* rank's group, host-name gather and placement),
``dist.counter_reduce`` (children ``.fetch``, ``.allreduce``, ``.fill``,
with the table's bytes) / ``dist.counter_checkpoint``, ``dist.collective``
(``allmin`` / ``allmax``: the wait on the slowest rank), ``dist.merge``
(the stripes merged, with their bytes).  Counters: ``reads``, ``bp``;
``dist.local_devices`` (the devices a --dist-* rank took at its join).
"""

from __future__ import annotations

import functools
import itertools
import json
import os
import sys
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import NamedTuple

import torch

COUNTERS: dict[str, float] = defaultdict(float)
TRACE_FILE = "trace.json"
MAX_RUNS = 1024


def count(name: str, n: float) -> None:
    COUNTERS[name] += n


class SpanRecord(NamedTuple):
    """One finished span of a traced run; times are ``perf_counter_ns``."""

    name: str
    start_ns: int
    end_ns: int
    parent: int | None  # the enclosing span's id; None for the root
    thread: str
    nbytes: int | None
    id: int
    tid: int            # the thread's native id

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class Run:
    """One traced run: its id, the command, one anchor pair
    ``(time.time_ns(), perf_counter_ns())`` taken together, the native id
    of the thread that opened it, and its spans in the order they ended."""

    __slots__ = ("id", "command", "anchor", "tid", "root", "spans", "_ids")

    def __init__(self, run_id: int, command: str):
        self.id = run_id
        self.command = command
        self.tid = threading.get_native_id()
        self.root = None
        self.spans: list[SpanRecord] = []
        self._ids = itertools.count()
        self.anchor = (time.time_ns(), time.perf_counter_ns())

    def wall_ns(self, perf_ns: int) -> int:
        """A ``perf_counter_ns`` stamp of this process on the wall clock."""
        return self.anchor[0] + perf_ns - self.anchor[1]


_current: Run | None = None    # the run being recorded (process-wide: every thread's spans)
_open_runs = 0                 # runs open, nested ones included
_run_ids = itertools.count(1)
_finished: deque = deque(maxlen=MAX_RUNS)
_local = threading.local()     # .top: (run, id) of the innermost open span on this thread


class span:
    """``with span(name, nbytes=None) as s: ...``, then ``s.seconds``.
    ``nbytes`` may also be set inside the block, once known.  Traced, the
    span opens its ``record_function`` after its first stamp and closes it
    after its second: the span starts no later than the profiler's event,
    and its seconds leave out the close, which lets go of the interpreter
    lock and may wait to take it back from the reader thread."""

    __slots__ = ("name", "nbytes", "start_ns", "end_ns", "_run", "_id", "_parent", "_prev",
                 "_rf")

    def __init__(self, name: str, nbytes: int | None = None):
        self.name = name
        self.nbytes = nbytes
        self._run = None

    def __enter__(self):
        self.start_ns = time.perf_counter_ns()
        if _current is not None:
            self._open(_current)
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._run is not None:
            self._close(exc)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def _open(self, run: Run) -> None:
        self._run = run
        self._id = next(run._ids)
        prev = self._prev = getattr(_local, "top", None)
        self._parent = prev[1] if prev is not None and prev[0] is run else run.root
        _local.top = (run, self._id)
        self._rf = None
        if threading.get_native_id() == run.tid:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()

    def _close(self, exc) -> None:
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _local.top = self._prev
        t = threading.current_thread()
        self._run.spans.append(SpanRecord(self.name, self.start_ns, self.end_ns, self._parent,
                                          t.name, self.nbytes, self._id, t.native_id))


@contextmanager
def run_scope(command: str):
    """One command run under its root span ``run``, recorded when a torch
    profiler is active as it starts.  A run opened inside another (classify
    forwarding to stream) opens nothing: the outermost run holds it all."""
    global _current, _open_runs
    _open_runs += 1
    try:
        if _open_runs > 1:
            yield
            return
        if torch.autograd.profiler._is_profiler_enabled:
            _current = Run(next(_run_ids), command)
        try:
            with span("run") as root:
                if _current is not None:
                    _current.root = root._id
                yield
        finally:
            if _current is not None:
                _finished.append(_current)
                _current = None
    finally:
        _open_runs -= 1


def traced(command: str):
    """Decorator: each call of a command's ``run()`` in ``run_scope``."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with run_scope(command):
                return fn(*args, **kwargs)

        return run

    return wrap


def finished_runs() -> list[Run]:
    """The recorded runs, oldest first (the newest MAX_RUNS)."""
    return list(_finished)


def metrics_enabled() -> bool:
    return os.environ.get("RKMH_TPU_METRICS", "0") == "1"


def _profiler():
    """A ``torch.profiler.profile`` of CPU activity, and of CUDA activity
    where a card is present."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _add_thread_spans(path: str, runs) -> None:
    """Add to the Chrome trace at ``path`` the spans of ``runs`` that the
    profiler could not record (those of threads other than the run's), as
    ``"X"`` events of their own thread on the trace's clock:
    ``ts = (wall ns - baseTimeNanoseconds) / 1000``."""
    with open(path) as fh:
        trace = json.load(fh)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = trace.setdefault("traceEvents", [])
    threads = {}
    for run in runs:
        for s in run.spans:
            if s.tid == run.tid:
                continue
            threads[s.tid] = s.thread
            args = {"run": run.id, "span": s.id, "parent": s.parent}
            if s.nbytes is not None:
                args["nbytes"] = s.nbytes
            events.append({"ph": "X", "cat": "user_annotation", "name": s.name, "pid": pid,
                           "tid": s.tid, "ts": (run.wall_ns(s.start_ns) - base) / 1000,
                           "dur": (s.end_ns - s.start_ns) / 1000, "args": args})
    events += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": name}} for tid, name in threads.items()]
    with open(path, "w") as fh:
        json.dump(trace, fh)


@contextmanager
def observed_run(command: str, enabled: bool | None = None):
    """Wrap a command run: profiler trace + metrics line on exit."""
    enabled = metrics_enabled() if enabled is None else enabled
    profile_dir = os.environ.get("RKMH_TPU_PROFILE", "")
    prof = None
    if profile_dir:
        last = _finished[-1].id if _finished else 0
        prof = _profiler()
        prof.__enter__()
    COUNTERS.clear()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            path = os.path.join(profile_dir, TRACE_FILE)
            prof.export_chrome_trace(path)
            _add_thread_spans(path, [r for r in _finished if r.id > last])
            print(f"rkmh-tpu-torch: device trace written to {profile_dir}", file=sys.stderr)
        if enabled:
            line = {"command": command, "wall_s": round(wall, 3)}
            for k, v in sorted(COUNTERS.items()):
                line[k] = int(v)
                if wall > 0:
                    line[f"{k}_per_sec"] = round(v / wall, 1)
            print(json.dumps(line), file=sys.stderr)
