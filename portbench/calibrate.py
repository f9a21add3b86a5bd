"""The readings a cell's limit is set from: for each seed, one run at the
cell's own load (a shorter window), the program's widest served-token gap
against the plain reference (a lower reading) and, on the same sample, the
widest gap of the tokens the reference on float8 weights puts first (the
control; an upper reading).  Not part of a benchmark run.

    python3 portbench/calibrate.py --workload <cell> --seeds a,b,c \\
        --seconds 15

prints one JSON line per seed, all seeds in one process.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    import torch
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import manifest, serve
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    man = manifest.Manifest()
    cell = man.cell(args.workload)
    conf = man.config(cell["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        res = serve.run_cell(conf, manifest.traffic(cell["traffic"]),
                             manifest.limits(cell["name"]), seed=seed,
                             seconds=args.seconds, trace=False,
                             control=True)
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "attempted": res["attempted"],
                          **res["readings"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
