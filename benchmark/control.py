"""Readings for the correctness limits: the program's numbers and its
control's, per seed, in one process (run on the card; never part of a
benchmark run).

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --seeds 11,12,13 [--controls tf32] [--out readings.json]

For each seed it runs the cell as run.py does (set-up, a window of
`--seconds`, the flush) and judges the chosen frames twice: the program
against the float32 reference, and the control against it: the same
reference computed with TF32 matmuls, standing in the program's place.
"bf16" is the reference with
the gray frames, the window scores and the weights rounded to bfloat16.
--faults names the runs of each seed: "none", the program as it is, and
each planted fault of faults.py by name; --no-check leaves out the reference's frame checks
(for readings of the CLEAR-MOT numbers alone).  Each seed's numbers go to standard output
as one JSON line and, with --out, into one JSON file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import cells  # noqa: E402
import faults  # noqa: E402
import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="tf32,bf16")
    ap.add_argument("--faults", default="none")
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 3
    cell = cells.cell(cells.benchmark(), args.workload)
    controls = tuple(c for c in args.controls.split(",") if c)
    planted = [None if f == "none" else f
               for f in args.faults.split(",") if f]
    out = []
    for seed in (int(s) for s in args.seeds.split(",")):
        for fault in planted:
            res = run.run(cells.config(cell["config"]),
                          cells.traffic(cell["traffic"]),
                          cells.limits(cell["name"]), seed, args.seconds,
                          False, controls=() if fault else controls,
                          engine_hook=fault and faults.FAULTS[fault],
                          judge=not args.no_check)
            rec = {"workload": cell["name"], "seed": seed, "fault": fault,
                   "frames": res["frames"], "program": res["numbers"],
                   "controls": res["control_numbers"]}
            print(json.dumps(rec), flush=True)
            out.append(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
