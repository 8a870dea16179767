"""The control of the comparison that decides ``correct``: whole runs of a
cell in which every reply is judged cut to the plaintext's bits
(portbench.judge.cut_to_plaintext_bits), which breaks the configuration's
guarantee of exact retrieval.  Every seed has to come out not correct.

    python3 -m portbench.control --workload <cell> --seeds 11 12 13 --seconds 3

Prints one JSON line a seed: the numbers compared and whether the run came
out correct.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    run.set_cache_dirs(run.ROOT)
    cell = spec.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    for seed in args.seeds:
        out = run.run_cell(cell, seed, args.seconds, False, control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": out["correct"],
                          "attempted": out["attempted"], "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
