"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` under ``repro_torch/kernels`` is compiled for Hopper
(``sm_90a``) at first use, one ``nvcc`` per source started together, and
linked into one shared library with a plain C interface that ``ctypes``
loads (no PyTorch headers, so a build takes seconds). The library lands in
``kernels/.build/<hash of the sources>/``, so an edited source is rebuilt
and an unchanged one is loaded as it is. Processes that build at once (the
ranks of a sharded engine on a fresh checkout) take turns on an exclusive
lock file beside that directory: the first compiles and links, the others
then find the library.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_KERNELS = Path(__file__).resolve().parent
BUILD_ROOT = _KERNELS / ".build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of the entry points; each returns the cudaError_t of its launch
# (decode_split_smem, which launches nothing, returns a size; the graph_if_
# entries, the cudaError_t of their graph calls)
SIGNATURES = {
    # q, k, v, index, scratch, out, q_bf16, kv_dtype, B, S, N, K, h,
    # kv_batch_stride, window, stream
    "decode_attention_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, _L, _I, _P],
    # h, kv_bytes, G: a split decode block's dynamic shared memory (bytes)
    "decode_split_smem": [_I, _I, _I],
    # q, k_pages, v_pages, k_scales, v_scales, page_table, index, scratch,
    # out, q_bf16, kv_dtype, scale_mode, B, N, K, h, page_size, npg, window,
    # stream
    "paged_decode_attention_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                      _I, _P],
    # q, k, v, index, out, q_bf16, kv_dtype, B, S, L, N, K, h, bk,
    # kv_batch_stride, window, stream
    "chunk_prefill_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _L, _I, _P],
    # q, k_pages, v_pages, k_scales, v_scales, page_table, index, out,
    # q_bf16, kv_dtype, scale_mode, B, S, N, K, h, page_size, npg, window,
    # stream
    "paged_chunk_prefill_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, wi, wg, h, bf16, act, E, C, D, F, rows, stream
    "gmm_gated_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # h, wo, y, bf16, E, C, F, D, stream
    "gmm_down_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, dt, a_log, b, c, scratch, y, state, bf16, B, S, H, P, N, Q, stream
    "ssd_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   _I, _P],
    # q, k, v, out, lse, bf16, B, S, Sk, N, K, h, window, causal, stream
    "flash_attention_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _P],
    # stream (capturing), flag (device bool), body graph (out): an IF node
    "graph_if_node": [_P, _P, _P],
    # body graph, child graph
    "graph_if_fill": [_P, _P],
}


def sources():
    return sorted(_KERNELS.glob("*/csrc/*.cu"))


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(_KERNELS.glob("*/csrc/*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card")


def build() -> Path:
    """Compile every kernel source (in parallel) and link the library;
    returns its path. A library already built from the same sources is
    reused."""
    srcs = sources()
    if len({p.stem for p in srcs}) != len(srcs):
        raise RuntimeError(f"kernel sources must have distinct names: {srcs}")
    digest = _digest(srcs)
    out_dir = BUILD_ROOT / digest
    lib = out_dir / "libkernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(BUILD_ROOT / f"{digest}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)      # released when closed
        if not lib.exists():
            _compile_and_link(srcs, out_dir, lib)
    return lib


def _compile_and_link(srcs, out_dir: Path, lib: Path) -> None:
    nvcc = _nvcc()
    objs, procs = [], []
    for src in srcs:
        obj = out_dir / (src.stem + ".o")     # one object per source
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"{src}:\n{log}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = out_dir / f"libkernels.{os.getpid()}.so"
    subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                   check=True, capture_output=True, text=True)
    os.replace(tmp, lib)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with every entry's
    argument types declared (pointers and the stream as ``c_void_p``)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args) -> None:
    """Call one C entry and raise if its launch failed."""
    err = getattr(library(), name)(*args)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def timed_build() -> float:
    """Build and load the library; returns the seconds it took."""
    t0 = time.perf_counter()
    library()
    return time.perf_counter() - t0
