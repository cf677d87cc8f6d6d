"""The readings that the limits of `correct` are set from, for one cell:

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 101 102 103 --seconds 5

It runs the cell in one process, once a seed, with a short window at the
cell's own load, no pre-load, and the run's own check: first the program on `--seeds`
(the lower readings: the largest number of sound runs), then the control
on `--control-seeds` (the upper readings). The control is the plain
reference put in the program's place and computed in the nearest precision
below the configuration's float32 with TF32 off: float32 matrix products in
TF32. Each run prints one JSON line of its compared numbers; the benchmark's
own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

import torch  # noqa: E402

from benchmark import check, harness  # noqa: E402
from benchmark.reference import pipeline as rpipe  # noqa: E402
from benchmark.reference.cloud import ScanGrid as RScanGrid  # noqa: E402


def control_step(pipeline: dict, device):
    """A chunk call that runs the reference with TF32 matrix products."""
    checker = check.Checker(pipeline, device)

    def step(state, scans, cfg):
        before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            return rpipe.process_scan_chunk(check.as_reference(state, checker.template),
                                            RScanGrid(*scans), checker.cfg)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
    return step


def readings(cell, seeds, control_seeds, seconds: float, device) -> list[dict]:
    """One dict a run: which side, the seed, correct, failed and each number."""
    out = []
    # the pre-load steadies the card's pace for timing, which a reading has none of
    preload, harness.PRELOAD_S = harness.PRELOAD_S, 0.0
    try:
        for side, seed_list in (("program", seeds), ("control", control_seeds)):
            for seed in seed_list:
                step = (control_step(cell.config["pipeline"], device) if side == "control"
                        else None)
                res = harness.run(cell, seed, seconds, False, device, time.perf_counter(),
                                  step=step)
                row = {"side": side, "seed": seed, "correct": res["correct"],
                       "failed": res["failed"], "attempted": res["attempted"],
                       **{k: v["value"] for k, v in res["checks"].items()}}
                print(json.dumps(row), flush=True)
                out.append(row)
    finally:
        harness.PRELOAD_S = preload
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=5.0)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card: the readings are the card's", file=sys.stderr)
        return 2
    rows = readings(harness.load_cell(a.workload), a.seeds, a.control_seeds, a.seconds,
                    torch.device("cuda", 0))
    for side in ("program", "control"):
        mine = [r for r in rows if r["side"] == side]
        if mine:
            worst = {k: (max if side == "program" else min)(
                (r[k] if r[k] is not None else float("nan")) for r in mine) for k in check.NUMBERS}
            print(json.dumps({"side": side, "runs": len(mine), "reading": worst}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
