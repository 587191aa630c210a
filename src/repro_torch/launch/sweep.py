"""The dry-run sweep: every (arch x shape) cell on the single-pod and
multi-pod meshes, one subprocess per cell (``python -m
repro_torch.launch.dryrun``), on the CPU and the meta device.

    PYTHONPATH=src python -m repro_torch.launch.sweep --out artifacts/dryrun_torch

Cells ``configs.shape_supported`` refuses are listed as skipped; a cell
whose row already exists in ``--out`` is not run again. The sweep prints
its wall time and, for every row in ``--out``, one device's FLOPs and
collective bytes by kind. The summary goes to ``_sweep_summary.json`` in
``--out``; the exit code is 1 if any cell failed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, get_config,
                                 shape_supported)

SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cell_done(out_dir: str, arch: str, shape: str, mesh: str,
              tag: str = "") -> bool:
    suffix = f"-{tag}" if tag else ""
    return os.path.exists(os.path.join(
        out_dir, f"{arch}__{shape}__{mesh}{suffix}.json"))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="artifacts/dryrun_torch")
    p.add_argument("--meshes", default="single_pod,multi_pod")
    p.add_argument("--archs", default=",".join(ASSIGNED_ARCHS))
    p.add_argument("--shapes", default=",".join(SHAPES))
    p.add_argument("--timeout", type=int, default=3000)
    p.add_argument("--skip-done", action="store_true", default=True)
    args = p.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    skipped, failed, ok = [], [], []
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        x for x in (SRC, os.environ.get("PYTHONPATH")) if x)}
    t00 = time.time()
    for mesh in args.meshes.split(","):
        for arch in args.archs.split(","):
            cfg = get_config(arch)
            for shape in args.shapes.split(","):
                sup, why = shape_supported(cfg, SHAPES[shape])
                if not sup:
                    skipped.append((arch, shape, why))
                    continue
                if args.skip_done and cell_done(args.out, arch, shape, mesh):
                    ok.append((arch, shape, mesh, "cached"))
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--out", args.out]
                if mesh == "multi_pod":
                    cmd.append("--multi-pod")
                t0 = time.time()
                try:
                    r = subprocess.run(cmd, capture_output=True, text=True,
                                       timeout=args.timeout, env=env)
                    dt = time.time() - t0
                    if r.returncode == 0:
                        ok.append((arch, shape, mesh, f"{dt:.0f}s"))
                        print(f"OK   {arch} x {shape} x {mesh} ({dt:.0f}s)",
                              flush=True)
                    else:
                        failed.append((arch, shape, mesh,
                                       r.stderr.strip().splitlines()[-1]
                                       if r.stderr.strip() else "?"))
                        print(f"FAIL {arch} x {shape} x {mesh}:\n"
                              + "\n".join(r.stderr.strip().splitlines()[-15:]),
                              flush=True)
                except subprocess.TimeoutExpired:
                    failed.append((arch, shape, mesh, "timeout"))
                    print(f"TIMEOUT {arch} x {shape} x {mesh}", flush=True)
    wall = time.time() - t00
    print(f"\n=== sweep done in {wall / 60:.1f} min ({wall:.1f} s): "
          f"{len(ok)} ok, {len(failed)} failed, {len(skipped)} skipped ===")
    for f in failed:
        print("FAILED:", f)
    for s in skipped:
        print("SKIPPED:", s)
    for arch, shape, mesh, _ in ok:
        with open(os.path.join(args.out,
                               f"{arch}__{shape}__{mesh}.json")) as f:
            row = json.load(f)
        coll = row["collectives"]
        print(f"ROW {arch} {shape} {mesh} flops/dev="
              f"{row['cost']['flops']:.6e} trace={row['t_compile_s']:.1f}s "
              + " ".join(f"{k}={v:.6e}" for k, v in sorted(coll.items())))
    with open(os.path.join(args.out, "_sweep_summary.json"), "w") as f:
        json.dump({"ok": ok, "failed": failed, "skipped": skipped}, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
