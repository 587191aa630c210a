"""The open-loop fleet's knee: one process serves the cell's traffic at
each of several fixed rates and prints, for each, the tails, the
throughput and the backlog (requests waiting for admission) at the
window's open and close. The knee is the highest rate whose backlog does
not grow over the window.

    python3 bench/sweep.py --workload <cell> --seconds 20 --rates 4 5 6
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
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--wait", type=float, default=20.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args()
    _, cfg, _ = MF.cell(MF.load(), args.workload)
    weights = Weights(port_config(cfg), getattr(torch, cfg["dtype"]),
                      "cuda")
    for rate in args.rates:
        def adjust(c, tr, rate=rate):
            return c, dict(tr, rate_per_s=rate, drain=True,
                           wait_s=args.wait, tail_s=args.wait)
        r = run(args.workload, args.seed, args.seconds, False,
                weights=weights, adjust=adjust, readings=())
        print(json.dumps({"rate_per_s": rate, "window": r["window"],
                          "metrics": r["metrics"],
                          "failed": r["failed"]}), flush=True)


if __name__ == "__main__":
    main()
