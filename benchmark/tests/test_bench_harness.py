"""The harness on the CPU at a tiny size: every cell's files found by
name, the result line's keys, no module of JAX or of the JAX package
loaded, and no result without a card or without the program.

Run from the repository's root: ``python -m pytest benchmark/tests``."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
TINY = {"points": {"n": 3000}}
# ``compared`` (each number the check compared, beside its limit) comes
# last, so that the end of the line shows why a run was not correct.
KEYS = {"correct", "attempted", "failed", "metrics", "device", "compared"}


def test_bench_files_found_by_name():
    bench_dir = os.path.join(ROOT, "benchmark")
    for c in BENCH["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        gen = json.load(open(os.path.join(ROOT, c["file"])))["points"]
        assert os.path.isfile(os.path.join(bench_dir, "clouds",
                                           gen["generator"] + ".py"))
    for w in BENCH["workloads"]:
        traffic = os.path.join(bench_dir, "traffic", w["traffic"] + ".json")
        assert os.path.isfile(traffic)
        call = os.path.join(bench_dir, "calls",
                            json.load(open(traffic))["call"] + ".py")
        assert os.path.isfile(call)
        assert os.path.isfile(os.path.join(bench_dir, "limits",
                                           w["name"] + ".json"))
    for m in BENCH["per_layer"]:
        assert os.path.isfile(os.path.join(bench_dir, "metrics",
                                           m["name"] + ".py"))


_RUN = """
import json, sys, torch
sys.path.insert(0, {root!r})
from benchmark import run
out = []
for trace in (False, True):
    res, _ = run.measure({cell!r}, 2**31 + 11, 1.0, trace,
                         torch.device("cpu"), overrides={tiny!r})
    out.append(json.dumps(res))
top = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"lines": out, "modules": top}}))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_bench_tiny_run_line(cell):
    """A 1-second run of each cell, untraced and traced, in a fresh
    process: the last line's keys, a breakdown only when traced, the
    cell's metrics, and no JAX afterwards."""
    proc = subprocess.run(
        [sys.executable, "-c", _RUN.format(root=ROOT, cell=cell, tiny=TINY)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    plain, traced = (json.loads(x) for x in got["lines"])
    assert set(plain) == KEYS and list(plain)[-1] == "compared"
    assert set(traced) == KEYS | {"breakdown"}
    assert list(traced)[-1] == "compared"
    assert plain["correct"] is True and traced["correct"] is True
    assert plain["attempted"] >= 1 and plain["failed"] == 0
    e2e = {m["name"] for m in BENCH["end_to_end"]
           if cell in m.get("workloads", [cell])}
    assert set(plain["metrics"]) == e2e
    # Host-clock per-layer metrics are there on the CPU too; device ones
    # (times from CUDA events, the trace's shares) only on the card.
    host = {m["name"] for m in BENCH["per_layer"]
            if cell in m.get("workloads", [cell])
            and m["source"] != "device_trace"}
    assert host <= set(traced["metrics"])
    for m in list(plain["metrics"].values()) + list(
            traced["metrics"].values()):
        assert set(m) == {"value", "unit"}
    assert not {"jax", "jaxlib", "flax", "gravomg_tpu"} & set(got["modules"])
    assert "gravomg_tpu_torch" in got["modules"]


def test_bench_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_bench_alone_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files
    (no program) exits nonzero and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for p in BENCH["paths"]:
        shutil.copytree(os.path.join(ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, *BENCH["command"][1:], "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
        timeout=300, cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
