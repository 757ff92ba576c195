"""The readings each limit of ``benchmark/limits/<cell>.json`` is set
from, in one process on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 7 8 9] [--seconds 3] [--out PATH] \
        [--device cpu --n 8000]          # a rehearsal at a small size

The cell is set up once (its cloud is the configuration's, whatever
the seed).  For each of ``--seeds``, the mix of that seed as ``run.py``
drives it (a short window at the cell's own load, the same sample of
answers, the same check) prints the numbers compared: their largest
over a dozen seeds or more is the lower reading.  For each of
``--control-seeds`` the same run with the control of the mix's entry
(``benchmark/calls/<call>.py::control``) in the program's place: its
smallest reading is the upper one.  One JSON line per run on stdout
(and appended to ``--out``).  The benchmark's own runs never run a
control.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

import argparse  # noqa: E402
import gc  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from benchmark.check import readings  # noqa: E402
from benchmark.loop import load_call  # noqa: E402
from benchmark.reference.graph import knn_graph  # noqa: E402
from benchmark.run import Setup, drive  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, help="points (small sizes for tests)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    s = Setup(args.workload, dev,
              {"points": {"n": args.n}} if args.n else None)
    kind = s.traffic["call"]
    g = knn_graph(s.points, s.config["knn"]["k"], dev)
    runs = [(seed, False) for seed in args.seeds] + [
        (seed, True) for seed in args.control_seeds]
    for seed, control in runs:
        part, ins, outs = drive(s, seed, args.seconds, False,
                                load_call(kind).control if control else None)
        t0 = time.perf_counter()
        values = readings(kind, s.points, s.config, s.traffic, ins, outs,
                          dev, g)
        check_s = time.perf_counter() - t0
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "control": control, "values": values,
                           "attempted": part["attempted"],
                           "failed": part["failed"],
                           "call_ms": part["metrics"]["call_ms"]["value"],
                           "check_s": check_s})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del ins, outs
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
