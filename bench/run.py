"""The benchmark of the PyTorch/CUDA port on one NVIDIA H100.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout and prints
its result as the last line of standard output (see
``harness/run_cell.py``). Exits non-zero, printing no result, without a
CUDA device."""
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, os.path.join(ROOT, "src")]
# caches of the run stay inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(BENCH, ".cache", sub)

if __name__ == "__main__":
    from harness.run_cell import main
    sys.exit(main())
