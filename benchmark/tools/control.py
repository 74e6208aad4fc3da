"""Readings of a cell's control: the plain reference computed in float8 in
the program's place, compared with the float32 reference by the cell's own
numbers, at the cell's own size, on each seed given.

    python3 benchmark/tools/control.py --workload vg.sample --seeds 11 12 13

Prints one JSON line per seed: the numbers and whether the cell's limits
call the control correct (they must not).
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from benchlib import cells  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--batches", type=int, default=3, help="sampling: window batches")
    p.add_argument("--fault", default=None, help="training: half_batch or no_exchange in "
                   "place of the float8 control")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    drv = cell.driver()
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t = time.time()
        if cell.traffic["kind"] == "sample":
            nums = drv.control(cell, seed, dev, args.batches)
        else:
            nums = drv.control(cell, seed, dev, cell.chips, args.fault)
        ok = all(nums[k] <= lim for k, lim in cell.limits.items() if k in nums)
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "control": nums,
                          "passes_limits": ok, "seconds": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
