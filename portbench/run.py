"""Run one cell of ``BENCHMARK.json`` on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` (and ``breakdown`` with ``--trace 1``), and
last ``check``: each number compared with its limit.  Exits 2 without
enough CUDA cards, 3 if JAX or the JAX package was loaded, 1 on any other
failure; none of those prints a result.
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import manifest, serve

    man = manifest.Manifest()
    cell = man.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    conf = man.config(cell["config"])
    e2e, layer = man.end_to_end(cell["name"]), man.per_layer(cell["name"])
    result = serve.run_cell(
        conf, manifest.traffic(cell["traffic"]),
        manifest.limits(cell["name"]), seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace), e2e=e2e,
        layer_metrics=layer,
        readers={m["name"]: manifest.reader(m["name"]) for m in layer})
    bad = serve.forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
