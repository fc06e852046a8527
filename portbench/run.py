"""The benchmark of rkmh_tpu_torch: one run of one cell of BENCHMARK.json.

    python3 -m portbench.run --workload CELL --seed N --seconds S --trace 0|1

The cell names a configuration (``configs/<config>.json``: the deployment's
published shapes) and a traffic mix (``traffic/<traffic>.json``: the
command, its flags and the inputs of one job).  Set-up makes the inputs
from the seed (``gen``, into ``.cache/inputs``) and runs one whole job to
warm every shape and build every kernel.  The window then runs whole jobs back to back through
the command's own entry point (``jobs/<command>.py``), one at a time, until
``--seconds`` have passed, the job that crosses it included.  Once the
window has closed and the device's peak memory is read, the plain
reference (``reference/<command>.py``) computes the job's output from the
same input files, and every window job's output is compared with it, line
for line.

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` runs the
window under ``torch.profiler`` and prints its per-layer metrics: each
metric is a file ``metrics/<name>.py`` whose ``read(record)`` gives its
value or None.  The last line of standard output is the result as one JSON
object; the numbers compared, with their limits, are the last lines of
standard error.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up runs from here to the first timed job

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "rkmh_tpu")
LIMITS = {"jobs_failed": 0, "lines_wrong": 0}  # every line of every job exact


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def cell_spec(bench: dict, name: str):
    """-> (the workload entry, its end-to-end metrics, its per-layer metrics)."""
    cells = [w for w in bench["workloads"] if w["name"] == name]
    if not cells:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return cells[0], mine(bench["end_to_end"]), mine(bench["per_layer"])


def metric_reader(name: str):
    """``read`` of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is a JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


class Sink:
    """Where a job writes its output: the text, kept as it was written."""

    def __init__(self):
        self.parts = []

    def write(self, s: str) -> int:
        self.parts.append(s)
        return len(s)

    def flush(self) -> None:
        pass

    def text(self) -> str:
        return "".join(self.parts)


def lines_wrong(expected: str, got: str) -> int:
    """Lines that differ at their place, and lines missing or extra."""
    if expected == got:
        return 0
    a, b = expected.splitlines(), got.splitlines()
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def run_cell(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
             metrics: list, device: str, t0: float, chips: int = 1) -> dict:
    """Set-up, the window, the reference and the metrics of one run -> the
    result object (``checks`` last)."""
    import torch

    from portbench import gen
    from portbench.trace import TracedWindow, spans, traced_record

    cuda = device.startswith("cuda")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    job = importlib.import_module(f"portbench.jobs.{traffic['command']}")
    ref = importlib.import_module(f"portbench.reference.{traffic['command']}")
    readers = [(m, metric_reader(m["name"])) for m in metrics]
    t_inputs = time.perf_counter()
    inputs = gen.make_inputs(cfg, traffic, seed, os.path.join(CACHE, "inputs"))
    t_warm = time.perf_counter()
    failed = 0
    if job.run(inputs, cfg, traffic, Sink(), {}, device) != 0:  # warms every shape
        failed += 1
    sync()
    setup_s = time.perf_counter() - t0
    print(f"portbench: set-up {setup_s:.3f} s: to the inputs {t_inputs - t0:.3f} s, inputs "
          f"{t_warm - t_inputs:.3f} s, warm job {t0 + setup_s - t_warm:.3f} s", file=sys.stderr)

    # Every window job's output is judged.  Those equal to the first job's,
    # as written, count as copies of it, and only the first and any that
    # differ are kept, so that the process's memory stays as set-up left it
    # and does not grow with the window.
    first, first_rcs, kept, jobs, job_s = None, [], [], [], []
    trace_path = os.path.join(CACHE, "trace.json")
    with TracedWindow(trace_path) if trace else contextlib.nullcontext(), \
            spans(job.SPANS) if trace else contextlib.nullcontext():
        start = t_job = time.perf_counter()
        while True:
            sink, st = Sink(), {"reads": inputs["reads_n"], "bases": inputs["bases"]}
            try:
                with torch.profiler.record_function("job") if trace else contextlib.nullcontext():
                    rc = job.run(inputs, cfg, traffic, sink, st, device)
            except Exception as e:  # a job that fails counts; the window goes on
                print(f"portbench: job failed: {e!r}", file=sys.stderr)
                rc = -1
            sync()
            if first is None:
                first = sink
            if sink.parts == first.parts:
                first_rcs.append(rc)
            else:
                kept.append((sink, [rc]))
            jobs.append(st)
            now = time.perf_counter()
            job_s.append(now - t_job)
            t_job = now
            if now - start >= seconds:
                break
        window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    tr = traced_record(trace_path) if trace else None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    expected, job_bytes = ref.expected(inputs, cfg, traffic, device)
    print(f"portbench: {len(jobs)} jobs in {window_s:.3f} s; reference "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    print("portbench: job seconds " + " ".join(f"{t:.3f}" for t in job_s), file=sys.stderr)
    wrong = 0
    for sink, rcs in [(first, first_rcs)] + kept:
        n = lines_wrong(expected, sink.text())
        wrong += n * len(rcs)
        failed += sum(rc != 0 or n > 0 for rc in rcs)
    checks = {"jobs_failed": failed, "lines_wrong": wrong}

    rec = {"setup_s": setup_s, "window_s": window_s, "jobs": jobs, "trace": tr,
           "work_bytes": job_bytes * len(jobs)}
    values = {}
    for m, read in readers:
        v = read(rec)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    out = {"correct": all(checks[c] <= LIMITS[c] for c in LIMITS) and bool(jobs),
           "attempted": len(jobs), "failed": int(failed), "metrics": values,
           "device": dev}
    if tr is not None:
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    out["checks"] = {c: {"value": checks[c], "limit": LIMITS[c]} for c in LIMITS}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    cell, e2e, per_layer = cell_spec(bench, args.workload)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['name']} needs {cell['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    cfg = load_json(HERE, "configs", f"{cell['config']}.json")
    traffic = load_json(HERE, "traffic", f"{cell['traffic']}.json")
    out = run_cell(cfg, traffic, args.seed, args.seconds, bool(args.trace),
                   per_layer if args.trace else e2e, "cuda", T0, cell["chips"])
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"portbench check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
