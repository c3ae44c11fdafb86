#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, on the card:

    python3 benchmark/calibrate.py --workload NAME --seeds 1,2,3
        [--control-seeds 4,5,6] [--tf32-seeds 7,8]
        [--fault NAME --fault-seeds 9,10]

For each seed of ``--seeds``, the program is built from that seed as a
run builds it, serves the requests that a run with that seed compares
where its window completes the mix's ``check.window`` requests (the
cell's own path, at the cell's sizes), and each number of the cell's
comparison is printed (the lower readings).  For each seed of
``--control-seeds``, the control, the plain reference one step below the
configuration's precision (``reference.Precision(control=True)``), takes
the program's place on the same requests (the upper readings).  For each
seed of ``--tf32-seeds``, the program serves them with TF32 switched on
after it is built: its float32 stages (encoders, sampler) one step below
the configuration's precision, its bfloat16 decode as the configuration
states.  With ``--fault``, the program with that fault of
``harness/faults.py`` planted serves them.  One JSON line a seed and a
side.
"""
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]


def _requests(run, driver, indices):
    out = []
    for req in driver.requests(run):
        if req.index > max(indices):
            return out
        if req.index in indices:
            out.append(req)


def readings(root, workload, seed, side, device):
    """``side``: "program", "control", "tf32" or a fault's name (planted
    by the caller)."""
    import torch

    from harness.main import Run, judge, sample_for
    from harness.reference import F32, Precision
    from harness.spec import Cell
    cell = Cell(root, workload)
    driver = cell.driver()
    run = Run(cell, seed, 0.0, False, device)
    run.sample = sample_for(run, driver)
    for i in range(int(run.mix["check"]["window"])):
        run.sample.offer(i)
    reqs = _requests(run, driver, run.sample.indices())
    t0 = time.perf_counter()
    if side == "control":
        for req in reqs:
            run.keep(req.index, driver.expected(run, req,
                                                Precision(control=True)))
    else:
        run.build()
        if side == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        driver.warm(run)
        for req in reqs:
            driver.serve(run, req)
        run.pipe = None
        run.release()
    run.requests = reqs
    numbers = judge(run, driver, F32)
    return {"workload": workload, "seed": seed, "side": side,
            "requests": run.sample.indices(), "numbers": numbers,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--tf32-seeds", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    sides = [(args.seeds, "program"), (args.control_seeds, "control"),
             (args.tf32_seeds, "tf32")]
    if args.fault:
        sides.append((args.fault_seeds, args.fault))
    for arg, side in sides:
        if side == args.fault:
            from harness.faults import FAULTS
            FAULTS[args.fault](setattr)
        for s in filter(None, arg.split(",")):
            print(json.dumps(readings(ROOT, args.workload, int(s), side,
                                      "cuda:0")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
