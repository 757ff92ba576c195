"""One run of one cell of the port's benchmark (``BENCHMARK.json``).

    python3 benchmark/run.py --workload <cell> --seed <n> \
        [--seconds <s>] [--trace 0|1]

(``python3 -m benchmark.run`` takes the same arguments.)  From the root
of a checkout on a machine with a CUDA card: makes the cell's inputs
from the seed, sets the configuration up through the port's public
calls (``deploy.py``), warms the mix's calls up, then drives the mix's
closed loop (``loop.py``) for ``--seconds`` seconds, judges a sample of
the window's answers against the plain reference (``check.py``), and
prints one JSON line as the last line of stdout: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, read by
``benchmark/metrics/<name>.py``), ``device`` (and ``breakdown`` when
traced), and last ``compared``, each number compared beside its limit.
The same numbers close stderr.

Exits nonzero and prints no result without a CUDA card (or with fewer
than the cell asks for), when any run-time failure occurs, or when a
module of JAX or of the JAX package is loaded once the window has
closed.
"""

import time

T0 = time.perf_counter()       # set-up is timed from here

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# Every build and kernel cache stays at a fixed path in the checkout.
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(ROOT, ".bench_cache", _sub)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check  # noqa: E402
from benchmark.deploy import deploy, synchronize  # noqa: E402
from benchmark.inputs import SAMPLE, point_cloud, stream_seed  # noqa: E402
from benchmark.loop import Mix, closed_loop  # noqa: E402
from benchmark.trace import Tracer  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "gravomg_tpu"}
WARMUP_CALLS = 2
TRACE_SPAN_S = 3.0         # traced stretch, from a third into the window


def load_json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def cell_spec(workload: str):
    """(BENCHMARK.json, the cell's entry, its configuration, its mix)."""
    bench = load_json("BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return (bench, cell, load_json(entry["file"]),
            load_json("benchmark", "traffic", cell["traffic"] + ".json"))


def merged(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(base[k], v) if isinstance(v, dict) else v
    return out


def in_cell(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def load_reader(name: str):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What the per-layer readers see: ``spans`` (set-up stages, s),
    ``window`` (loop.Window), ``trace`` (trace.Trace or None), ``mix``
    (loop.Mix, with its deployment ``mix.dep``) and ``device``."""

    def __init__(self, spans, window, trace, mix, device):
        self.spans, self.window, self.trace = spans, window, trace
        self.mix, self.device = mix, device


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.splitlines()[0] if out else "nvidia-smi: no output"


def end_to_end(name: str, window, setup_s: float, peak: int):
    if name == "call_ms":
        return 1e3 * window.seconds / len(window.durations)
    if name == "call_ms.p95":
        return float(np.percentile(np.array(window.durations) * 1e3, 95))
    if name == "peak_mem_gb":
        return peak / 1e9
    if name == "setup_s":
        return setup_s
    raise ValueError(f"no end-to-end metric {name!r}")


class Setup:
    """A cell set up: its specs, its cloud and its deployment (``dep``,
    which :func:`measure` drops before the reference runs)."""

    def __init__(self, workload: str, device: torch.device,
                 overrides: dict = None):
        self.workload, self.device = workload, device
        self.bench, self.cell, config, self.traffic = cell_spec(workload)
        self.config = merged(config, overrides) if overrides else config
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        self.points = point_cloud(self.config["points"])
        self.spans = {}
        self.dep = deploy(self.config, self.points, device, self.spans)


def drive(s: Setup, seed: int, seconds: float, trace: bool, call=None,
          log=sys.stderr):
    """The mix of ``seed`` on a set-up cell: warm-up, window, metrics.
    Returns (the result line without ``correct`` and ``compared``, the
    sampled calls' inputs, their outputs)."""
    device, workload, bench = s.device, s.workload, s.bench
    mix = Mix(s.traffic, s.config, s.dep, seed, device, trace, call)
    for i in range(WARMUP_CALLS):
        mix.run(i)
    mix.kept.clear()
    synchronize(device)
    setup_s = time.perf_counter() - T0
    print(f"# {workload} seed {seed} set-up {setup_s:.3f} s {s.spans}",
          file=log, flush=True)

    tracer = (Tracer(device, seconds / 3, min(TRACE_SPAN_S, seconds / 3),
                     mix.kind) if trace else None)
    window = closed_loop(mix, seconds, tracer and tracer.boundary)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    tr = tracer.summary() if tracer else None
    ms = [round(d * 1e3, 3) for d in window.durations]
    print(f"# window {window.seconds:.3f} s, {len(ms)} calls, "
          f"{window.failed} failed; call ms: first {ms[:5]}, median "
          f"{float(np.median(ms)):.3f}, min {min(ms)}, max {max(ms)}",
          file=log, flush=True)

    if trace:
        run = Run(s.spans, window, tr, mix, device)
        metrics = {}
        for m in bench["per_layer"]:
            if in_cell(m, workload):
                value = load_reader(m["name"])(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        del run
    else:
        metrics = {m["name"]: {"value": end_to_end(m["name"], window,
                                                   setup_s, peak),
                               "unit": m["unit"]}
                   for m in bench["end_to_end"] if in_cell(m, workload)}

    # The sample of the window's answers, drawn from the seed.
    rng = np.random.default_rng(stream_seed(seed, SAMPLE))
    slots = sorted(mix.kept)
    chosen = sorted(rng.choice(slots, min(s.traffic["compare"], len(slots)),
                               replace=False).tolist()) if slots else []
    ins = [mix.inputs[j] if mix.inputs is not None else None for j in chosen]
    answers = [mix.kept[j][1] for j in chosen]
    print(f"# sampled calls' records {[a.record for a in answers]}",
          file=log, flush=True)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": s.cell["chips"] if device.type == "cuda" else 1,
           "memory_peak_bytes": peak}
    result = {"attempted": len(window.durations), "failed": window.failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = tr.busy_s if tr else None
        dev["window_s"] = tr.window_s if tr else None
        result["breakdown"] = {"device_ops": tr.device_ops if tr else [],
                               "idle_gaps": tr.idle_gaps if tr else []}
    return result, ins, [a.out for a in answers]


def measure(workload: str, seed: int, seconds: float, trace: bool,
            device: torch.device, overrides: dict = None, call=None,
            log=sys.stderr):
    """One run; returns (result line as a dict, the numbers compared as
    {name: value}).  ``overrides`` merges into the configuration (small
    sizes for tests), ``call`` replaces the mix's call (controls).  The
    program's state goes before the reference runs."""
    s = Setup(workload, device, overrides)
    part, ins, outs = drive(s, seed, seconds, trace, call, log)
    if device.type == "cuda":
        print(f"# card {card_line()}", file=log, flush=True)
    s.dep = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    values = (check.readings(s.traffic["call"], s.points, s.config,
                             s.traffic, ins, outs, device) if outs else {})
    print(f"# check of {len(outs)} answers "
          f"{time.perf_counter() - t_check:.3f} s", file=log, flush=True)
    correct, compared = check.judge(values, part["failed"],
                                    check.limits(workload))
    return {"correct": correct, **part, "compared": compared}, values


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window (default: BENCHMARK.json run_seconds)")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench, cell, _, _ = cell_spec(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    seconds = args.seconds or bench["run_seconds"]
    result, _ = measure(args.workload, args.seed, seconds, bool(args.trace),
                        torch.device("cuda"))
    found = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
