"""Readings that the limits of ``correct`` are set from, on the card at a
cell's own size: for each seed, one run of the cell (a short window) with
every number read for the program and for each control (the reference in
a lower precision put in the program's place: "fp8", the fp8 GEMM;
"fp8w", fp8 weights alone), and each judged by the run's own ``correct``.
One process, the weights drawn anew in place for each seed.

    python3 bench/control.py --workload <cell> --seconds 3 --seeds 1 2 3
"""
import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.join(os.path.dirname(BENCH), "src")]


def main():
    import torch
    from harness import manifest as MF
    from harness.port import Weights, port_config
    from harness.run_cell import run
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    _, cfg, _ = MF.cell(MF.load(), args.workload)
    weights = Weights(port_config(cfg), getattr(torch, cfg["dtype"]),
                      "cuda")
    for seed in args.seeds:
        r = run(args.workload, seed, args.seconds, False, weights=weights,
                readings=(None, "fp8", "fp8w"))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": r["readings"],
                          "correct": r["correct"],
                          "controls": r["controls"],
                          "failed": r["failed"]}), flush=True)


if __name__ == "__main__":
    main()
