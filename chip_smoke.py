"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``
(with ptxas's registers and spills for the redesigned kernels: both chunk
prefill bodies, bf16 on the tensor cores and the 3xTF32 one for every
other type, flash attention built from the same two bodies, the SSD
scan's two passes, the bf16 gmm_gated and gmm_down, and the split-key
decode kernels with their combine pass), holds each kernel against its
plain PyTorch version at the shapes of the main paths and, for the
redesigned kernels, at the edges of their tiles and splits (the paged
kernels bit-equal to the dense ones at page size 32, the chunk kernels
chunking-invariant, the 3xTF32 kernels within 1e-4 of f32, gmm_gated,
gmm_down, the decode kernels and the SSD scan the same on two calls),
ties the card to
the CPU port
on the reduced molmoact-7b (control step, admit-stall and chunked serving
engines), then drives the full-width molmoact-7b paths with seeded random
weights and checks that each ran through the kernels: one VLA control step
(B=4 robots) through ``vla_control_step``, and the serving engine answering
16 robot requests on 8 slots, admit-stall (dense; paged f32, int8 and fp8
pools) and chunked under the token-budget scheduler (dense; paged f32,
int8 and fp8 pools; the serving engines on molmoact's first 14 layers).
The MoE family follows: the grouped-expert kernels
against their plain versions at granite-moe-3b-a800m's width, the reduced
granite engine on card and CPU, and the full-width granite-moe-3b-a800m
serving the same 16-request shape through three engines (admit-stall
dense and paged f32, chunked paged f32) with its decode breakdown. The
Mamba2 family last: the SSD scan kernel against its plain version at
mamba2-780m's width, reduced mamba2-780m and the reduced jamba hybrid on
card and CPU, and the full-width mamba2-780m serving the same shape
admit-stall (dense and paged f32) with its decode breakdown. Every
full-width decode path runs twice: its decode step replayed from a
captured CUDA graph (the main path: ``model.DecodeGraph``, the engines'
``DecodeTick``; launches count the replays), then eagerly; the two must
give the same tokens and, step for step, the same kernels in the same
order, and a replayed step at most MAX_GRAPH_LAUNCHES host launch calls;
both modes' phase splits, tick percentiles and decode breakdowns are
printed side by side. Self-speculative decode: the chunk kernels at the
verify chunk's shapes (S = 2, 4, 8 rows a slot from per-slot starts; the
whole view bit-equal to the live band), the reduced engines (half-stack
and full-depth int8 drafts; dense, paged f32 and int8-token) on card and
CPU and equal to the card's fused streams, a decode write past a full
cache (dense, paged, MoE) card vs CPU, phase 5c's full-width speculative
engines (dense and paged f32) graphed and eager, and the verify chunk's
kernel times; phase 4 prints the analytical model's phase split of the
control step on an H100 beside the measured one. Prints
the card, the phase numbers, one JSON line describing each kernel and,
last, ``{"ok": true, "device": {...}}``. Exits non-zero, without that
line, when there is no CUDA device or any phase fails.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
L2_BYTES = 50 * 2 ** 20            # H100 SXM L2 cache
# peak operations per second by input type (dense, no sparsity): bf16
# tensor cores; f32 outside the tensor cores (the exact f32 function);
# int8/fp8 tensor cores
OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12,
             "float8_e4m3fn": 1979e12}
KERNEL_TOL = 1e-2    # relative to max(1, |plain|): a bf16 output is off by
#                      up to half an ulp (2**-9 relative) plus f32 sums
#                      taken in another order
TF32X3_TOL = 1e-4    # a 3xTF32 kernel (chunk prefill, flash attention,
#                      the SSD scan) with an f32 output, relative to
#                      max(1, |plain|): ~2**-21 a product, f32 sums in
#                      another order
# dense TF32 tensor-core peak (H100 SXM data sheet): the 3xTF32 chunk body's
# own bound takes three TF32 products for each product of the function
TF32_OPS_PER_S = 494.7e12
CPU_LOGIT_TOL = 1e-3               # f32 weights; summation order only
SEED = 0
FULL_B, FULL_TEXT = 4, 64          # robots per step, instruction tokens
PHASE_REPEATS = 3                  # timed control steps after the first
# full-width serving: 8 slots, 16 requests (8 observations, each sent
# twice), 144 CoT + 48 action tokens + the prefill token per request
SERVE_SLOTS, SERVE_OBS, SERVE_TOKENS = 8, 8, 193
SERVE_MAX_SEQ, SERVE_TICK = 864, 8
# molmoact-7b's serving engines run its first 14 of 28 layers (full
# width; every engine and gate kept), so that the script, with the MoE
# phases, stays near half its time limit; the control step and the f32
# prefill check keep every layer
SERVE_LAYERS = 14
PAGE = 32
SPEC_K = 4           # the speculative engines' chunk: 3 drafts + 1
# phase 5c: (name, engine options, phase 5's engine whose streams it is
# compared with); the draft is every layer, int8-rounded
SPEC = dict(spec_decode=True, spec_k=SPEC_K, draft_quant="int8")
SPEC_ENGINES = [("spec-dense", dict(SPEC), "dense"),
                ("spec-paged-f32", dict(SPEC, paged=True), "paged-f32")]
# (name, engine options): the first three carry the gates of the phase
SERVE_ENGINES = [
    ("dense", {}),
    ("paged-f32", dict(paged=True)),
    ("paged-int8-head", dict(paged=True, kv_dtype="int8")),
    ("paged-int8-token", dict(paged=True, kv_dtype="int8",
                              scale_granularity="token")),
    ("paged-fp8-head", dict(paged=True, kv_dtype="fp8")),
    ("paged-fp8-token", dict(paged=True, kv_dtype="fp8",
                             scale_granularity="token")),
]
# chunked serving: the same 16 requests under the token-budget scheduler;
# prompt chunks of 128 positions, 256 positions of work per tick
CHUNK_SIZE, TOKEN_BUDGET = 128, 256
CHUNKED = dict(chunked_prefill=True, chunk_size=CHUNK_SIZE,
               token_budget=TOKEN_BUDGET)
CHUNKED_ENGINES = [
    ("dense-chunked", dict(CHUNKED)),
    ("paged-f32-chunked", dict(CHUNKED, paged=True)),
    ("paged-int8-head-chunked", dict(CHUNKED, paged=True, kv_dtype="int8")),
    ("paged-fp8-token-chunked", dict(CHUNKED, paged=True, kv_dtype="fp8",
                                     scale_granularity="token")),
]
CMP_LAYERS = 4       # depth of the f32 chunked-vs-monolithic comparison
CMP_TOL = 1e-4       # f32 weights; GEMM and attention sums in other orders
# paged storage variants: (row name, kv_dtype, granularity or page dtype)
PAGED_VARIANTS = [("f32", "bf16", "f32"), ("bf16", "bf16", "bf16"),
                  ("int8-head", "int8", "head"),
                  ("int8-token", "int8", "token"),
                  ("fp8-head", "fp8", "head"), ("fp8-token", "fp8", "token")]
# the tensor-core chunk body (bf16 q over a bf16 view) at the edges of its
# 64-row tiles and 64-key blocks: (label, B, S, L, N, K, h, start, window)
BF16_CHUNK_CASES = [
    ("h=64 G=7 ragged S=600 of L=640", 2, 600, 640, 28, 4, 64, 0, 0),
    ("h=64 G=7 ragged S=600 window=64", 2, 600, 640, 28, 4, 64, 0, 64),
    ("h=16 G=7 S=77 L=200 per-slot starts", 3, 77, 200, 28, 4, 16,
     (0, 61, 123), 0),
    ("h=16 G=1 S=77 L=200 window=64", 3, 77, 200, 8, 8, 16, (0, 61, 123),
     64),
    ("h=128 G=1 S=300 window=64", 1, 300, 300, 7, 7, 128, 0, 64),
    ("h=128 G=7 S=100 from 37 and 50, L=150", 2, 100, 150, 28, 4, 128,
     (37, 50), 0),
]
# chunking invariance of the control step's prefill, split on and off the
# 64-row tiles
CHUNK_SPLITS = (1, 17, 320, 383)
# the MoE family: granite-moe-3b-a800m served in molmoact's serving shape
# (8 prompts of 640 random tokens, each sent twice, 193 tokens each)
MOE_ARCH, MOE_PROMPT = "granite-moe-3b-a800m", 640
# expert capacities on the served path: decode at 8 slots, a 128-row
# chunk, a 640-row admission prefill; and a ragged one for the checks
MOE_C, MOE_RAGGED_C = (2, 32, 160), 7
# gmm_down (bf16, tensor cores) at the edges of its tiles: capacities off
# its 32-row slices and past one 256-row pass; (C, D, F) with widths that
# are multiples of 8 but not of its 128-column tile or 64-deep stage
GMM_DOWN_EDGES = [(1, None, None), (33, None, None), (161, None, None),
                  (256, None, None), (300, None, None), (33, 1544, 520)]
# gmm_gated (bf16, tensor cores) at the edges of its passes of 32, 64, 128,
# 160 and 256 rows and past one pass, at granite's widths, and with D and
# F multiples of 8 but not of its 64-deep stages and 64-column tiles
GATED_EDGES = [(C, None, None) for C in (1, 2, 7, 32, 33, 64, 65, 160, 161,
                                         256, 257)] + [
    (33, 1544, 520), (161, 1544, 520), (257, 1544, 520)]
MOE_ENGINES = [
    ("moe-dense", {}),
    ("moe-paged-f32", dict(paged=True)),
    ("moe-paged-f32-chunked", dict(CHUNKED, paged=True)),
]
# the Mamba2 family: mamba2-780m served in the same shape (8 prompts of
# 640 random tokens, each sent twice, 193 tokens each; admit-stall only,
# as in the reference); the jamba hybrid (attention, Mamba2 and MoE
# layers) at its reduced width only (398 B parameters do not fit one card)
SSM_ARCH, HYBRID_ARCH = "mamba2-780m", "jamba-1.5-large-398b"
# SSD scans at mamba2-780m's width (H=48, P=64, N=128, chunks of 128)
# unless "reduced" (P = N = 16): (B, S, type, width): the admission
# prefill, one chunk, a chunk shorter than 128, f32, six chunks, and the
# reduced models' width with one ragged chunk and with three
SSD_CASES = [(1, 640, "bfloat16", "full"), (1, 128, "bfloat16", "full"),
             (1, 64, "bfloat16", "full"), (2, 256, "float32", "full"),
             (2, 768, "float32", "full"), (2, 40, "float32", "reduced"),
             (1, 384, "bfloat16", "reduced")]
SSM_ENGINES = [("ssm-dense", {}), ("ssm-paged-f32", dict(paged=True))]
# training: smollm-135m at full width in f32 (the reference's training
# type), B=4 sequences of 2048 tokens from the port's lm_batches; one
# warm-up step and TRAIN_STEPS timed ones on one repeated batch
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS = "smollm-135m", 4, 2048, 3
TRAIN_LR = 1e-3
GRAD_TOL = 1e-4      # FlashAttention's backward vs autograd through the
#                      plain version (f32; sums in another order)
# flash attention vs its plain version: (label, B, S, Sk, N, K, h, type,
# window, causal); smollm-135m's heads unless said
FLASH_CASES = [("smollm f32", 4, 2048, 2048, 9, 3, 64, "float32", 0, True),
               ("smollm bf16", 4, 2048, 2048, 9, 3, 64, "bfloat16", 0,
                True),
               ("one block S=128", 2, 128, 128, 9, 3, 64, "float32", 0,
                True),
               ("molmoact heads S=1024 bf16", 1, 1024, 1024, 28, 4, 128,
                "bfloat16", 0, True),
               ("molmoact heads S=512 f32", 1, 512, 512, 28, 4, 128,
                "float32", 0, True),
               ("window=512", 2, 2048, 2048, 9, 3, 64, "float32", 512, True),
               ("causal=False", 2, 512, 512, 9, 3, 64, "float32", 0, False),
               ("causal=False bf16", 2, 512, 512, 9, 3, 64, "bfloat16", 0,
                False),
               ("causal=False window=96", 1, 256, 256, 9, 3, 64, "float32",
                96, False),
               ("Sk=1024 < S=2048", 2, 2048, 1024, 9, 3, 64, "float32", 0,
                True),
               ("Sk=256 > S=128, causal=False", 2, 128, 256, 9, 3, 64,
                "float32", 0, False),
               ("h=16 S=100", 2, 100, 100, 4, 2, 16, "float32", 0, True),
               ("h=16 S=384 window=64 bf16", 1, 384, 384, 4, 2, 16,
                "bfloat16", 64, True)]


# the speculative verify chunk (phase 2, phase 6): S query rows a slot from
# per-slot starts, some with rows past the 864-position cache; the low
# starts' live band (one of 32-row blocks up to 320) is shorter than the view
VERIFY_S = (2, 4, 8)
VERIFY_TIMED_S = 4
VERIFY_STARTS = (0, 31, 32, 300, 639, 830, 858, 863)
VERIFY_LOW_STARTS = (0, 5, 31, 32, 100, 250, 299, 300)
VERIFY_PAGES = ("f32", "int8-token", "fp8-token")
# per-slot decode positions of the engines' 8 slots in phase 2's checks
SERVE_MIXED = (0, 31, 32, 300, 639, 700, 831, 5)
# the decode shapes phase 2 also holds against the plain version, dense
# and paged, at the engines' 8 slots: label -> (N, K, h). Granite's heads,
# and query groups of 16 and 32 (the kernels' wide instantiation, which
# the G <= 32 contract needs and no configuration runs)
DECODE_SHAPES = {f"{MOE_ARCH} (h=64, G=3)": (24, 8, 64),
                 "G=16 h=16": (32, 2, 16), "G=32 h=16": (32, 1, 16),
                 "G=16 h=128": (32, 2, 128), "G=32 h=128": (32, 1, 128)}
# (index, window) of the split-key decode kernels' phase-2 checks: the
# edges of their 128-key splits, windows across a split edge and shorter
# than a split, per-slot indices with 0 (a tensor when a tuple)
SPLIT_CASES = [(127, 0), (128, 0), (255, 0), (150, 64), (280, 64),
               (736, 16), ((0, 127, 128, 255), 0)]


# the redesigned kernels' instantiations on the main paths (and the
# decode kernels' wide-group one), by the substring of their (mangled)
# names, and the dynamic shared memory each launch asks for there: bytes,
# from their layouts, or for a split decode block (h, bytes of a cache
# element, G), which the library sizes
TF32_F32_SMEM = 2 * 64 * (144 + 132) * 4       # 2 stages of f32 K and V
TF32_CODE_SMEM = 64 * (144 + 132) * 4 + 4 * 64 * 128   # + raw int8/fp8 ring
PTXAS_KERNELS = {
    "16chunk_mma_kernelILi128E": ("chunk_mma_kernel<128> (control step)",
                                  (64 + 4 * 64) * 136 * 2),
    "17chunk_tf32_kernelILi128Ef13__nv_bfloat16E":
        ("chunk_tf32_kernel<128, f32 view, bf16 q> (engines' admission)",
         TF32_F32_SMEM),
    "17chunk_tf32_kernelILi128EffE": ("chunk_tf32_kernel<128, f32, f32 q>",
                                      TF32_F32_SMEM),
    "18paged_chunk_kernelILi128EfLi0E13__nv_bfloat16E":
        ("paged_chunk_kernel<128, f32> (3xTF32)", TF32_F32_SMEM),
    "18paged_chunk_kernelILi128EaLi1E13__nv_bfloat16E":
        ("paged_chunk_kernel<128, int8, head> (3xTF32)", TF32_CODE_SMEM),
    "18paged_chunk_kernelILi128E13__nv_fp8_e4m3Li2E13__nv_bfloat16E":
        ("paged_chunk_kernel<128, fp8, token> (3xTF32)", TF32_CODE_SMEM),
    "23gmm_gated_stream_kernelILi0ELi32E":
        ("gmm_gated_stream_kernel<silu, 32> (C <= 32)",
         3 * (64 * 128 + 32 * 64) * 2),
    "23gmm_gated_stream_kernelILi0ELi160E":
        ("gmm_gated_stream_kernel<silu, 160> (C = 160)",
         4 * (64 * 128 + 160 * 64) * 2),
    "22paged_chunk_mma_kernelILi128E": ("paged_chunk_mma_kernel<128>",
                                        (64 + 4 * 64) * 136 * 2),
    "22gmm_down_stream_kernelILi32E": ("gmm_down_stream_kernel<32> (C <= 32)",
                                       4 * (64 * 128 + 8 * 33 * 8) * 2),
    "19gmm_down_res_kernelILi160E": ("gmm_down_res_kernel<160> (C = 160)",
                                     (8 * 8 * 161 * 8 + 4 * 64 * 128) * 2),
    "13decode_kernelILi128E13__nv_bfloat16Li8ES1_E":
        ("decode_kernel<128, bf16> (control step)", (128, 2, 7)),
    "13decode_kernelILi128EfLi8E13__nv_bfloat16E":
        ("decode_kernel<128, f32> (engines)", (128, 4, 7)),
    "12paged_kernelILi128EfLi0ELi8E13__nv_bfloat16E":
        ("paged_kernel<128, f32>", (128, 4, 7)),
    "12paged_kernelILi128EaLi1ELi8E13__nv_bfloat16E":
        ("paged_kernel<128, int8, head>", (128, 1, 7)),
    "12paged_kernelILi128E13__nv_fp8_e4m3Li2ELi8E13__nv_bfloat16E":
        ("paged_kernel<128, fp8, token>", (128, 1, 7)),
    "13decode_kernelILi64EfLi8E13__nv_bfloat16E":
        (f"decode_kernel<64, f32> ({MOE_ARCH})", (64, 4, 3)),
    "12paged_kernelILi64EfLi0ELi8E13__nv_bfloat16E":
        (f"paged_kernel<64, f32> ({MOE_ARCH})", (64, 4, 3)),
    "13decode_kernelILi128EfLi32E13__nv_bfloat16E":
        ("decode_kernel<128, f32, G <= 32> (no configuration)",
         (128, 4, 32)),
    "20split_combine_kernelILi128E13__nv_bfloat16E":
        ("split_combine_kernel<128, bf16>", 0),
    # flash attention on the chunk bodies: smollm's h = 64 (the train
    # step, f32) and molmoact's 128, causal
    "17flash_tf32_kernelILi64ELb1E": ("flash_tf32_kernel<64, causal> "
                                      "(train step)", 2 * 64 * (80 + 68) * 4),
    "17flash_tf32_kernelILi128ELb1E": ("flash_tf32_kernel<128, causal>",
                                       TF32_F32_SMEM),
    "16flash_mma_kernelILi64ELb1E": ("flash_mma_kernel<64, causal>",
                                     (64 + 4 * 64) * 72 * 2),
    "16flash_mma_kernelILi128ELb1E": ("flash_mma_kernel<128, causal>",
                                      (64 + 4 * 64) * 136 * 2),
    # the SSD scan's two passes
    "17ssd_states_kernelI13__nv_bfloat16E": (
        "ssd_states_kernel<bf16> (Mamba2 serving)",
        4 * (2 * 128 + 128 * 72 + 128 * 136)),
    "17ssd_output_kernelI13__nv_bfloat16E": (
        "ssd_output_kernel<bf16> (Mamba2 serving)",
        4 * (2 * 128 + 2 * 128 * 132 + 128 * 68 + 64 * 132)),
    "17ssd_states_kernelIfE": ("ssd_states_kernel<f32>",
                               4 * (2 * 128 + 128 * 72 + 128 * 136)),
    "17ssd_output_kernelIfE": (
        "ssd_output_kernel<f32>",
        4 * (2 * 128 + 2 * 128 * 132 + 128 * 68 + 64 * 132)),
}
PTXAS_SOURCES = ["chunk_prefill/csrc/chunk_prefill.cu",
                 "chunk_prefill/csrc/paged_chunk_prefill.cu",
                 "chunk_prefill/csrc/paged_chunk_int8.cu",
                 "chunk_prefill/csrc/paged_chunk_fp8.cu",
                 "moe_gmm/csrc/gmm_gated_tc.cu",
                 "moe_gmm/csrc/gmm_down_tc.cu",
                 "decode_attention/csrc/decode_attention.cu",
                 "decode_attention/csrc/paged_decode_attention.cu",
                 "decode_attention/csrc/paged_decode_int8.cu",
                 "decode_attention/csrc/paged_decode_fp8.cu",
                 "flash_attention/csrc/flash_attention.cu",
                 "ssd/csrc/ssd.cu"]


def start_ptxas_report():
    """nvcc -Xptxas -v on the redesigned kernels' sources, in parallel
    with the build (objects under kernels/.build/ptxas)."""
    from repro_torch.kernels import _build
    out = _build.BUILD_ROOT / "ptxas"
    out.mkdir(parents=True, exist_ok=True)
    return [subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
         str(_build._KERNELS / src), "-o", str(out / f"{i}.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, src in enumerate(PTXAS_SOURCES)]


def ptxas_report(procs) -> None:
    """One line per redesigned kernel: registers, shared memory, spills."""
    found = {}
    for proc in procs:
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise AssertionError(f"nvcc -Xptxas -v failed:\n{log[-4000:]}")
        key = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                key = next((k for k in PTXAS_KERNELS if k in line), None)
            elif key and "spill" in line:
                found.setdefault(key, {})["spill"] = line.strip()
            elif key and "Used" in line and "registers" in line:
                found.setdefault(key, {})["regs"] = line.split(":", 1)[1]
    from repro_torch.kernels import _build
    for key, (label, dyn) in PTXAS_KERNELS.items():
        got = found.get(key)
        if not got:
            raise AssertionError(f"ptxas printed nothing for {label}")
        if isinstance(dyn, tuple):
            dyn = _build.library().decode_split_smem(*dyn)
        print(f"  ptxas {label}:{got['regs'].strip()}; {dyn} bytes of "
              f"dynamic shared memory; {got.get('spill', 'no spill line')}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in a
    CUDA graph and replayed, so the wrapper's host time (~20-30 us a call
    in Python) does not hide the kernel's. A ``fn`` that cycles through
    copies of its inputs (``cycling``) is captured with each call's own."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def cycling(fn, args):
    """A call of fn(*a), a taking each of ``args`` in turn."""
    it = itertools.cycle(args)
    return lambda: fn(*next(it))


def cold_copies(nbytes: float) -> int:
    """How many copies of a call's inputs to cycle through so that what a
    round of calls reads (``nbytes`` a call) is twice the L2: then each
    call finds its inputs cold, as on the main path, where every layer
    reads a cache of its own."""
    return max(2, -(-2 * L2_BYTES // int(nbytes)))


def bound(nbytes: float, ops: float, dtype):
    """(least time in ms, what bounds it) on the H100's published peaks,
    the operations at the peak rate of the cache's storage type."""
    rate = OPS_PER_S[str(dtype).replace("torch.", "")]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check(name: str, got, want, tol: float, quiet: bool = False) -> float:
    """Fail unless |got - want| <= tol * max(1, |want|) everywhere; returns
    the largest absolute error (printed unless ``quiet`` and it held)."""
    import torch
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    ok = bool(torch.isfinite(got).all()) and bool(
        (diff <= tol * want.float().abs().clamp(min=1.0)).all())
    if not (ok and quiet):
        print(f"  {name}: max_abs_err={err:.3g} (tol {tol:g} x max(1, "
              f"|plain|)){'' if ok else '  FAILED'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err} > {tol})")
    return err


def kernel_checks(cfg):
    """Phase 2: each kernel against its plain version at the main paths'
    shapes: the control step's bf16 caches (B=4) and the serving engine's
    f32 caches and page pools (B=8 slots, 864 positions, 217 pages of 32);
    the paged kernel bit-equal to the dense one over the same rows; then
    the decode kernels, dense and paged, at DECODE_SHAPES. Returns the
    inputs and largest errors for the kernel times."""
    import torch
    from repro_torch.kernels.chunk_prefill import ops as cp
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    from repro_torch.core.vla import control_step_lengths
    B, N, K, h = FULL_B, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    S, _, smax = control_step_lengths(cfg, FULL_TEXT)     # 640, 833

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    q, kc, vc = randn(B, N, h), randn(B, smax, K, h), randn(B, smax, K, h)
    errs = {}

    def record(name, label, got, want):
        errs[name] = max(errs.get(name, 0.0),
                         check(label, got, want, KERNEL_TOL))

    cases = [(i, 0) for i in (0, 511, 512, 640, 831)]
    cases += [(torch.tensor([640, 700, 783, 831], dtype=torch.int32,
                            device=dev), 0), (736, 64)]
    cases += split_cases(dev, B)
    decode_cases("decode_attention", q, kc, vc, cases, record)
    # the serving engine's f32 dense cache: 8 slots x 864 positions
    qs = randn(SERVE_SLOTS, N, h)
    ks32 = randn(SERVE_SLOTS, SERVE_MAX_SEQ, K, h, dtype=torch.float32)
    vs32 = randn(SERVE_SLOTS, SERVE_MAX_SEQ, K, h, dtype=torch.float32)
    decode_cases("decode_attention_f32", qs, ks32, vs32, serve_cases(dev),
                 record)

    qc = randn(B, S, N, h)
    kv, vv = kc[:, :S], vc[:, :S]        # the chunk route's view of the cache
    print("chunk_prefill vs plain, q", tuple(qc.shape), "view",
          tuple(kv.shape))
    full = cp.chunk_prefill_attention(qc, kv, vv, 0)
    for label, got, want in [
            ("index=0", full, cp.chunk_prefill_ref(qc.float(), kv, vv, 0)),
            ("index=320 L=640", cp.chunk_prefill_attention(
                qc[:, 320:], kv, vv, 320),
             cp.chunk_prefill_ref(qc[:, 320:].float(), kv, vv, 320)),
            ("index=0 window=64", cp.chunk_prefill_attention(
                qc, kv, vv, 0, window=64),
             cp.chunk_prefill_ref(qc.float(), kv, vv, 0, 64))]:
        record("chunk_prefill", label, got, want)
    torch.cuda.synchronize()
    part = cp.chunk_prefill_attention(qc[:, 320:].contiguous(), kv, vv, 320)
    if not torch.equal(full[:, 320:], part):
        raise AssertionError("chunk_prefill: rows 320..639 differ between "
                             "one chunk from 0 and a chunk at 320")
    print("  chunking invariance: rows 320..639 bit-equal")
    bf16_chunk_checks(g, qc, kv, vv, record)
    # the engine's admission prefill: batch 1, f32 cache view of 640 rows
    q1 = qc[:1].contiguous()
    k1, v1 = ks32[:1, :S], vs32[:1, :S]
    print("chunk_prefill vs plain, q", tuple(q1.shape), "f32 view",
          tuple(k1.shape))
    for label, start, window in (("index=0", 0, 0),
                                 ("index=320", 320, 0),
                                 ("index=0 window=64", 0, 64)):
        got = cp.chunk_prefill_attention(q1[:, start:], k1, v1, start,
                                         window=window)
        want = cp.chunk_prefill_ref(q1[:, start:].float(), k1, v1, start,
                                    window)
        record("chunk_prefill_f32", label, got, want)
    tf32_chunk_checks(g, q1, k1, v1, errs)

    paged = paged_checks(g, errs, (SERVE_SLOTS, N, K, h), smax)
    paged_chunk = paged_chunk_checks(cfg, g, errs)
    verify = verify_checks(cfg, g, errs)
    # the other decode shapes: granite-moe-3b-a800m's and the wide groups
    for label, (n_q, n_kv, hd) in DECODE_SHAPES.items():
        print(f"decode shape: {label}")
        qw = randn(SERVE_SLOTS, n_q, hd)
        for kv_type in (torch.float32, torch.bfloat16):
            kw = randn(SERVE_SLOTS, SERVE_MAX_SEQ, n_kv, hd, dtype=kv_type)
            vw = randn(SERVE_SLOTS, SERVE_MAX_SEQ, n_kv, hd, dtype=kv_type)
            decode_cases("decode_attention" if kv_type == torch.bfloat16
                         else "decode_attention_f32", qw, kw, vw,
                         serve_cases(dev), record)
        paged_checks(g, errs, (SERVE_SLOTS, n_q, n_kv, hd), smax)
    return {"decode": (q, kc, vc), "decode_f32": (qs, ks32, vs32),
            "chunk": (qc, kv, vv), "chunk_f32": (q1, k1, v1),
            "paged": paged, "paged_chunk": paged_chunk,
            "verify": verify}, errs


def decode_cases(name, q, kc, vc, cases, record):
    """The dense decode kernel against its plain version at each (index,
    window) of ``cases``, and the same bits on two calls."""
    import torch
    from repro_torch.kernels.decode_attention import ops as da
    print(f"decode_attention vs plain, q {tuple(q.shape)} {q.dtype}, cache "
          f"{tuple(kc.shape)} {kc.dtype}")
    for idx, window in cases:
        got = da.decode_attention(q, kc, vc, idx, window=window)
        again = da.decode_attention(q, kc, vc, idx, window=window)
        want = da.decode_attention_ref(q.float(), kc, vc, idx, window)
        label = (f"index={idx if isinstance(idx, int) else idx.tolist()}"
                 f" window={window}")
        record(name, label, got, want)
        if not torch.equal(got, again):
            raise AssertionError(f"decode_attention: two calls differ at "
                                 f"{label}")
    print(f"  the same bits on two calls at each of {len(cases)} cases")


def serve_cases(dev):
    """(index, window) of the decode checks at the engines' 8 slots."""
    import torch
    mixed = torch.tensor(SERVE_MIXED, dtype=torch.int32, device=dev)
    return ([(0, 0), (511, 0), (831, 0), (mixed, 0), (736, 64)]
            + split_cases(dev, SERVE_SLOTS))


def split_cases(dev, B: int):
    """SPLIT_CASES for B slots, per-slot indices as int32 tensors on
    ``dev`` (a tuple repeated over the slots)."""
    import torch
    return [(torch.tensor((i * B)[:B], dtype=torch.int32, device=dev)
             if isinstance(i, tuple) else i, w) for i, w in SPLIT_CASES]


def bf16_chunk_checks(g, qc, kv, vv, record):
    """The tensor-core chunk body against its plain version at the edges
    of its tiles (BF16_CHUNK_CASES), and chunking invariance bit for bit
    of the control step's prefill split at CHUNK_SPLITS, window 0 and
    64."""
    import torch
    from repro_torch.kernels.chunk_prefill import ops as cp
    dev = qc.device
    print("chunk_prefill (bf16, tensor cores) at tile and block edges")
    for label, B, S, L, N, K, h, start, window in BF16_CHUNK_CASES:
        q = torch.randn(B, S, N, h, generator=g, device=dev).bfloat16()
        k = torch.randn(B, L, K, h, generator=g, device=dev).bfloat16()
        v = torch.randn(B, L, K, h, generator=g, device=dev).bfloat16()
        idx = (torch.tensor(start, dtype=torch.int32, device=dev)
               if isinstance(start, tuple) else start)
        record("chunk_prefill", label,
               cp.chunk_prefill_attention(q, k, v, idx, window=window),
               cp.chunk_prefill_ref(q.float(), k, v, idx, window))
    for window in (0, 64):
        whole = cp.chunk_prefill_attention(qc, kv, vv, 0, window=window)
        for split in CHUNK_SPLITS:
            head = cp.chunk_prefill_attention(qc[:, :split].contiguous(), kv,
                                              vv, 0, window=window)
            tail = cp.chunk_prefill_attention(qc[:, split:].contiguous(), kv,
                                              vv, split, window=window)
            torch.cuda.synchronize()
            if not (torch.equal(whole[:, :split], head)
                    and torch.equal(whole[:, split:], tail)):
                raise AssertionError(f"chunk_prefill: chunks split at "
                                     f"{split} (window {window}) differ "
                                     f"from one chunk")
    print(f"  chunking invariance: splits at {list(CHUNK_SPLITS)}, window "
          f"0 and 64, bit-equal to one chunk")


def tf32_chunk_checks(g, q1, k1, v1, errs):
    """The 3xTF32 chunk body with an f32 q, so an f32 output: over the
    engines' f32 admission view (B=1, 640 rows) at starts 0 and 320,
    windows across a 64-key block edge (64, 100) and shorter than one (48),
    and over the same rows in bf16; within TF32X3_TOL x max(1, |plain|),
    the largest error printed against that bound. Then chunking invariance
    bit for bit, split on and off the 64-row tiles."""
    import torch
    from repro_torch.kernels.chunk_prefill import ops as cp
    qf = q1.float()
    print(f"chunk_prefill (3xTF32) with an f32 q {tuple(qf.shape)}, f32 and "
          f"bf16 views {tuple(k1.shape)}")
    worst = 0.0
    for view in ("f32", "bf16"):
        kv, vv = ((k1, v1) if view == "f32"
                  else (k1.bfloat16(), v1.bfloat16()))
        for start, window in ((0, 0), (320, 0), (0, 64), (0, 100), (0, 48),
                              (320, 48)):
            got = cp.chunk_prefill_attention(qf[:, start:], kv, vv, start,
                                             window=window)
            want = cp.chunk_prefill_ref(qf[:, start:], kv, vv, start,
                                        window)
            worst = max(worst, check(f"{view} view start={start} "
                                     f"window={window}", got, want,
                                     TF32X3_TOL, quiet=True))
    errs["chunk_prefill_f32q"] = worst
    print(f"  largest error {worst:.3g} (bound {TF32X3_TOL:g} x max(1, "
          f"|plain|)) over 12 cases")
    for window in (0, 64):
        whole = cp.chunk_prefill_attention(qf, k1, v1, 0, window=window)
        for split in CHUNK_SPLITS + (100,):
            head = cp.chunk_prefill_attention(qf[:, :split].contiguous(), k1,
                                              v1, 0, window=window)
            tail = cp.chunk_prefill_attention(qf[:, split:].contiguous(), k1,
                                              v1, split, window=window)
            torch.cuda.synchronize()
            if not (torch.equal(whole[:, :split], head)
                    and torch.equal(whole[:, split:], tail)):
                raise AssertionError(f"chunk_prefill (3xTF32): chunks split "
                                     f"at {split} (window {window}) differ "
                                     f"from one chunk")
    print(f"  chunking invariance (3xTF32): splits at "
          f"{list(CHUNK_SPLITS) + [100]}, window 0 and 64, bit-equal to one "
          f"chunk")


def make_pool(g, kv_dtype: str, store: str, num_pages: int, B: int,
              npg: int, K: int, h: int):
    """K and V page pools of ``num_pages`` pages of 32 rows on the card,
    with slot b's npg logical pages at shuffled physical pages (never the
    null page 0). ``store`` is "f32"/"bf16" for unquantized pools, else
    the scale granularity of an int8/fp8 pool. Returns (k pages, v pages,
    k scales, v scales, full page table [B, npg] int32)."""
    import torch
    from repro_torch.models import kv_quant
    dev = torch.device("cuda")
    perm = torch.randperm(num_pages - 1, generator=g, device=dev)[:B * npg]
    table = (perm + 1).reshape(B, npg).to(torch.int32)
    qd = kv_quant.quant_dtype(kv_dtype)
    dtype = qd or (torch.float32 if store == "f32" else torch.bfloat16)
    out = []
    for _ in range(2):
        rows = torch.randn(B * npg, PAGE, K, h, generator=g, device=dev)
        pages = torch.zeros(num_pages, PAGE, K, h, dtype=dtype, device=dev)
        scales = None
        if qd is not None:
            rows, sc = kv_quant.quantize_page_rows(rows, qd, store)
            scales = torch.zeros((num_pages,) + sc.shape[1:], device=dev)
            scales[table.reshape(-1).long()] = sc
        pages[table.reshape(-1).long()] = rows.to(dtype)
        out.append((pages, scales))
    (kp, ks), (vp, vs) = out
    return kp, vp, ks, vs, table


def live_table(table, index):
    """The engine's view of a table: entries past each slot's position
    point at the null page 0."""
    import torch
    npg = table.shape[1]
    idx = torch.as_tensor(index, device=table.device).reshape(-1)
    live = torch.arange(npg, device=table.device)[None] <= (idx[:, None]
                                                            // PAGE)
    return torch.where(live, table, 0).to(torch.int32)


def paged_checks(g, errs, shape, smax: int):
    """The paged decode kernel against its plain version at the serving
    engine's pool (``shape`` = (B, N, K, h), 864 positions: 1 + B * 27
    pages of 32; shuffled tables, null entries past each slot's length)
    for every storage type, and bit-equal to the dense kernel over the
    same rows (f32 and bf16), also against a dense cache of ``smax``
    rows."""
    import torch
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention import paged as pg
    dev = torch.device("cuda")
    B, N, K, h = shape
    npg = SERVE_MAX_SEQ // PAGE
    num_pages = 1 + B * npg
    q = torch.randn(B, N, h, generator=g, device=dev).bfloat16()
    mixed = torch.tensor(SERVE_MIXED, dtype=torch.int32, device=dev)
    cases = [(i, 0) for i in (0, 31, 32, 639, 831)] + [(mixed, 0), (736, 64)]
    cases += split_cases(dev, B)
    pools = {}
    for name, kv_dtype, store in PAGED_VARIANTS:
        kp, vp, ks, vs, table = make_pool(g, kv_dtype, store, num_pages, B,
                                          npg, K, h)
        pools[name] = (kp, vp, ks, vs, table)
        print(f"paged_decode_attention vs plain, {name} pages "
              f"{tuple(kp.shape)} {kp.dtype}, q {tuple(q.shape)}")
        for idx, window in cases:
            pt = live_table(table, idx if not isinstance(idx, int)
                            else torch.full((B,), idx, device=dev))
            got = pg.paged_decode_attention(q, kp, vp, pt, idx, k_scales=ks,
                                            v_scales=vs, window=window)
            again = pg.paged_decode_attention(q, kp, vp, pt, idx,
                                              k_scales=ks, v_scales=vs,
                                              window=window)
            if ks is None:
                want = pg.paged_decode_attention_ref(q.float(), kp, vp, pt,
                                                     idx, window)
            else:
                want = pg.paged_decode_attention_quant_ref(
                    q.float(), kp, vp, ks, vs, pt, idx, window)
            label = (f"index={idx if isinstance(idx, int) else idx.tolist()}"
                     f" window={window}")
            key = f"paged_decode_attention/{name}"
            errs[key] = max(errs.get(key, 0.0),
                            check(label, got, want, KERNEL_TOL))
            if not torch.equal(got, again):
                raise AssertionError(f"paged_decode_attention ({name}): two "
                                     f"calls differ at {label}")
        print(f"  the same bits on two calls at each of {len(cases)} cases")
    for name in ("f32", "bf16"):
        kp, vp, _, _, table = pools[name]
        kd, vd = pg.gather_pages(kp, table), pg.gather_pages(vp, table)
        for idx, window in [(mixed, 0), (736, 64), (831, 0)] \
                + split_cases(dev, B):
            a = pg.paged_decode_attention(q, kp, vp, table, idx,
                                          window=window)
            for rows in (npg * PAGE, smax):
                b = da.decode_attention(q, kd[:, :rows], vd[:, :rows], idx,
                                        window=window)
                torch.cuda.synchronize()
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"paged ({name}, {npg} pages) and dense decode "
                        f"(S={rows}) differ at index {idx}, window {window}")
        print(f"  paged vs dense decode over the same {name} rows: "
              f"bit-equal (mixed, 736/window 64, 831 and the split cases; "
              f"dense S = {npg * PAGE} and {smax} against {npg} pages)")
    return q, pools


def band_table(table, live: int):
    """A table sliced to the pages of the live band [0, live), as the
    chunk route slices it."""
    return table[:, :-(-live // PAGE)].contiguous()


def paged_chunk_checks(cfg, g, errs):
    """The paged chunk-prefill kernel against its plain version at the
    chunked engine's shapes (128-row chunks of a 640-position prompt, N=28,
    K=4, h=128, a shuffled 217-page pool) for every storage type: one slot
    at starts 0, 480 and 512, two slots at mixed starts, window 0 and 64;
    bit-equal to the dense chunk kernel over the same rows (f32 and bf16
    pages); and chunking-invariant bit for bit (a 640-row prompt as chunks
    of 32, 128 and 640). Returns (q of the last chunk, pools)."""
    import torch
    from repro_torch.kernels.chunk_prefill import ops as cp
    from repro_torch.kernels.chunk_prefill import paged as pcp
    from repro_torch.kernels.decode_attention import paged as pg
    dev = torch.device("cuda")
    N, K, h = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    S, npg = CHUNK_SIZE, 640 // PAGE
    num_pages = 1 + SERVE_SLOTS * (SERVE_MAX_SEQ // PAGE)
    q2 = torch.randn(2, S, N, h, generator=g, device=dev).bfloat16()
    mixed = torch.tensor([512, 256], dtype=torch.int32, device=dev)
    cases = [(1, start, window) for start in (0, 480, 512)
             for window in (0, 64)] + [(2, mixed, 0), (2, mixed, 64)]
    pools = {}
    for name, kv_dtype, store in PAGED_VARIANTS:
        kp, vp, ks, vs, table = make_pool(g, kv_dtype, store, num_pages, 2,
                                          npg, K, h)
        pools[name] = (kp, vp, ks, vs, table)
        print(f"paged_chunk_prefill vs plain, {name} pages "
              f"{tuple(kp.shape)} {kp.dtype}, q [B,{S},{N},{h}]")
        for B, start, window in cases:
            q = q2[:B]
            top = int(start.max()) if B > 1 else start
            pt = band_table(table[:B], top + S)
            got = pcp.paged_chunk_prefill_attention(
                q, kp, vp, pt, start, k_scales=ks, v_scales=vs,
                window=window)
            want = pcp.paged_chunk_prefill_ref(q.float(), kp, vp, pt, start,
                                               ks, vs, window)
            label = (f"B={B} start="
                     f"{start if B == 1 else start.tolist()} window={window}")
            key = f"paged_chunk_prefill/{name}"
            errs[key] = max(errs.get(key, 0.0),
                            check(label, got, want, KERNEL_TOL))
    qf = q2.float()
    for name in ("f32", "bf16", "int8-head", "int8-token", "fp8-head",
                 "fp8-token"):
        kp, vp, ks, vs, table = pools[name]
        worst = 0.0
        for B, start, window in cases:
            top = int(start.max()) if B > 1 else start
            pt = band_table(table[:B], top + S)
            got = pcp.paged_chunk_prefill_attention(
                qf[:B], kp, vp, pt, start, k_scales=ks, v_scales=vs,
                window=window)
            want = pcp.paged_chunk_prefill_ref(qf[:B], kp, vp, pt, start, ks,
                                               vs, window)
            worst = max(worst, check(f"{name} pages f32 q B={B} window="
                                     f"{window}", got, want, TF32X3_TOL,
                                     quiet=True))
        key = f"paged_chunk_prefill/{name}/f32q"
        errs[key] = worst
        print(f"  {name} pages, f32 q (3xTF32): largest error {worst:.3g} "
              f"(bound {TF32X3_TOL:g} x max(1, |plain|)) over "
              f"{len(cases)} cases")
    off_block = torch.tensor([497, 33], dtype=torch.int32, device=dev)
    for name in ("f32", "bf16"):
        kp, vp, _, _, table = pools[name]
        kd = pg.gather_pages(kp, table).contiguous()
        vd = pg.gather_pages(vp, table).contiguous()
        for starts, window, qq in itertools.product(
                (mixed, off_block), (0, 64, 48), (q2, qf)):
            a = pcp.paged_chunk_prefill_attention(qq, kp, vp, table, starts,
                                                  window=window)
            b = cp.chunk_prefill_attention(qq, kd, vd, starts, window=window)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(f"paged ({name}) and dense chunk "
                                     f"prefill differ, starts "
                                     f"{starts.tolist()}, window {window}, "
                                     f"q {qq.dtype}")
        print(f"  paged vs dense chunk prefill over the same {name} rows: "
              f"bit-equal (starts {mixed.tolist()} and "
              f"{off_block.tolist()}, window 0, 64 and 48, bf16 and f32 q)")
    qp = torch.randn(1, 640, N, h, generator=g, device=dev).bfloat16()
    for name in ("f32", "int8-head", "fp8-token"):
        kp, vp, ks, vs, table = pools[name]
        outs = []
        for c in (32, 128, 640):
            outs.append(torch.cat([pcp.paged_chunk_prefill_attention(
                qp[:, s:s + c].contiguous(), kp, vp,
                band_table(table[:1], s + c), s, k_scales=ks, v_scales=vs)
                for s in range(0, 640, c)], dim=1))
        torch.cuda.synchronize()
        if not (torch.equal(outs[0], outs[1])
                and torch.equal(outs[1], outs[2])):
            raise AssertionError(f"paged chunk prefill ({name}): chunks of "
                                 f"32, 128 and 640 give different rows")
        print(f"  chunking invariance ({name} pages): a 640-row prompt as "
              f"chunks of 32, 128 and 640 gives bit-equal rows")
    return q2[:1].contiguous(), pools


def verify_checks(cfg, g, errs):
    """Phase 2, the speculative verify chunk's shapes: rows 3 and 4 at
    S = 2, 4, 8 query rows a slot, B = 8 slots from their own starts (some
    with rows past the 864-position cache: the engine drops their writes
    with n_valid, their outputs are never read, and the kernels still
    compute them) against the plain versions: dense bf16 and f32 views
    with a bf16 q (an f32 q too, within TF32X3_TOL), paged f32, int8-token
    and fp8-token pages. Then the live bound: from starts whose band is
    shorter than the view, the whole view (a whole table) gives the same
    bits as the band (the table sliced to it), which the graphed
    speculative tick, captured over the whole view, relies on. Returns
    the S = 4 inputs for the phase-6 timings."""
    import torch
    from repro_torch.kernels.chunk_prefill import ops as cp
    from repro_torch.kernels.chunk_prefill import paged as pcp
    from repro_torch.models.layers import band_len
    dev = torch.device("cuda")
    B, N, K, h = SERVE_SLOTS, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L, npg = SERVE_MAX_SEQ, SERVE_MAX_SEQ // PAGE
    starts = torch.tensor(VERIFY_STARTS, dtype=torch.int32, device=dev)
    low = torch.tensor(VERIFY_LOW_STARTS, dtype=torch.int32, device=dev)
    kb = torch.randn(B, L, K, h, generator=g, device=dev).bfloat16()
    vb = torch.randn(B, L, K, h, generator=g, device=dev).bfloat16()
    kf = torch.randn(B, L, K, h, generator=g, device=dev)
    vf = torch.randn(B, L, K, h, generator=g, device=dev)
    pools = {name: make_pool(g, kv_dtype, store, 1 + B * npg, B, npg, K, h)
             for name, kv_dtype, store in PAGED_VARIANTS
             if name in VERIFY_PAGES}
    inputs = {}
    print(f"verify chunk (S = {list(VERIFY_S)}, B = {B}, starts "
          f"{list(VERIFY_STARTS)}) vs plain versions")
    for S in VERIFY_S:
        q = torch.randn(B, S, N, h, generator=g, device=dev).bfloat16()
        for view, (kv, vv) in (("bf16", (kb, vb)), ("f32", (kf, vf))):
            key = "chunk_prefill" if view == "bf16" else "chunk_prefill_f32"
            for qq, tol in ((q, KERNEL_TOL), (q.float(), TF32X3_TOL)):
                if view == "bf16" and qq.dtype == torch.float32:
                    continue
                err = check(f"{view} view, {qq.dtype} q, S={S}",
                            cp.chunk_prefill_attention(qq, kv, vv, starts),
                            cp.chunk_prefill_ref(qq.float(), kv, vv, starts),
                            tol, quiet=True)
                k = f"{key}/verify" + ("_f32q" if qq.dtype == torch.float32
                                       else "")
                errs[k] = max(errs.get(k, 0.0), err)
            # the live band of the low starts against the whole view
            Lb = band_len(int(low.max()) + S, PAGE, L)
            whole = cp.chunk_prefill_attention(q, kv, vv, low)
            band = cp.chunk_prefill_attention(q, kv[:, :Lb], vv[:, :Lb], low)
            torch.cuda.synchronize()
            if not torch.equal(whole, band):
                raise AssertionError(f"verify chunk ({view} view, S={S}): "
                                     f"the band of {Lb} and the whole view "
                                     f"give other bits")
        for name, (kp, vp, ks, vs, table) in pools.items():
            key = f"paged_chunk_prefill/{name}/verify"
            errs[key] = max(errs.get(key, 0.0), check(
                f"{name} pages, S={S}",
                pcp.paged_chunk_prefill_attention(q, kp, vp, table, starts,
                                                  k_scales=ks, v_scales=vs),
                pcp.paged_chunk_prefill_ref(q.float(), kp, vp, table, starts,
                                            ks, vs), KERNEL_TOL, quiet=True))
            Lb = band_len(int(low.max()) + S, PAGE, L)
            whole = pcp.paged_chunk_prefill_attention(
                q, kp, vp, table, low, k_scales=ks, v_scales=vs)
            band = pcp.paged_chunk_prefill_attention(
                q, kp, vp, band_table(table, Lb), low, k_scales=ks,
                v_scales=vs)
            torch.cuda.synchronize()
            if not torch.equal(whole, band):
                raise AssertionError(f"verify chunk ({name} pages, S={S}): "
                                     f"the band's pages and the whole table "
                                     f"give other bits")
        if S == VERIFY_TIMED_S:
            inputs = {"q": q, "f32": (kf, vf), "pools": pools,
                      "starts": starts}
    for k in sorted(e for e in errs if "/verify" in e):
        print(f"  {k}: max_abs_err={errs[k]:.3g}")
    print(f"  the live band and the whole view (table) give the same bits "
          f"(starts {list(VERIFY_LOW_STARTS)}, every view and page type)")
    return inputs


def moe_experts(g, cfg, C: int, dtype):
    """Seeded capacity buffer x [E,C,D] and expert weights wi, wg [E,D,F],
    wo [E,F,D] (normal / sqrt(fan_in)) of ``cfg`` on the card."""
    import torch
    E, D, F = cfg.num_experts, cfg.d_model, cfg.moe_d_ff

    def rnd(*shape, fan_in=1):
        return (torch.randn(shape, generator=g, device="cuda")
                * fan_in ** -0.5).to(dtype)
    return (rnd(E, C, D), rnd(E, D, F, fan_in=D), rnd(E, D, F, fan_in=D),
            rnd(E, F, D, fan_in=F))


def moe_kernel_checks(cfg):
    """Phase 2b: gmm_gated, gmm_down and grouped_mlp against their plain
    versions at granite-moe-3b-a800m's width (E=40, D=1536, F=512), at the
    served capacities and a ragged one, in bf16 and f32, for every
    activation; then the bf16 tensor-core kernels at the edges of their
    tiles and passes (GMM_DOWN_EDGES, GATED_EDGES), the same bits on two
    calls. Returns the largest errors by (kernel, C)."""
    import torch
    from repro_torch.kernels.moe_gmm import ops as gmm
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for C in MOE_C + (MOE_RAGGED_C,):
            x, wi, wg, wo = moe_experts(g, cfg, C, dtype)
            line = {}
            for act in ("silu", "gelu", "gelu_plain"):
                h = gmm.gmm_gated(x, wi, wg, act=act)
                for name, got, want in (
                        ("gmm_gated", h, gmm.gmm_gated_ref(x, wi, wg, act)),
                        ("gmm_down", gmm.gmm_down(h, wo),
                         gmm.gmm_down_ref(h, wo)),
                        ("grouped_mlp", gmm.grouped_mlp(x, wi, wg, wo, act),
                         gmm.grouped_mlp_ref(x, wi, wg, wo, act))):
                    err = check(f"{name} {dtype} C={C} {act}", got, want,
                                KERNEL_TOL, quiet=True)
                    line[name] = max(line.get(name, 0.0), err)
                    errs[name, C] = max(errs.get((name, C), 0.0), err)
            print(f"  {str(dtype).replace('torch.', '')} C={C} (silu, gelu, "
                  f"gelu_plain): max_abs_err " + ", ".join(
                      f"{k} {v:.3g}" for k, v in line.items())
                  + f" (tol {KERNEL_TOL:g} x max(1, |plain|))")
    E, D0, F0 = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    for C, D, F in GMM_DOWN_EDGES:
        D, F = D or D0, F or F0
        h = torch.randn(E, C, F, generator=g, device="cuda").bfloat16()
        wo = (torch.randn(E, F, D, generator=g, device="cuda")
              * F ** -0.5).bfloat16()
        y = gmm.gmm_down(h, wo)
        again = gmm.gmm_down(h, wo)
        err = check(f"gmm_down bfloat16 C={C} D={D} F={F}", y,
                    gmm.gmm_down_ref(h, wo), KERNEL_TOL)
        errs["gmm_down", C] = max(errs.get(("gmm_down", C), 0.0), err)
        torch.cuda.synchronize()
        if not torch.equal(y, again):
            raise AssertionError(f"gmm_down C={C}: two calls differ")
    print("  gmm_down (bf16, tensor cores): the same bits on two calls at "
          "every edge shape")
    worst = 0.0
    for C, D, F in GATED_EDGES:
        D, F = D or D0, F or F0
        x = torch.randn(E, C, D, generator=g, device="cuda").bfloat16()
        wi, wg = ((torch.randn(E, D, F, generator=g, device="cuda")
                   * D ** -0.5).bfloat16() for _ in range(2))
        for act in ("silu", "gelu", "gelu_plain"):
            h = gmm.gmm_gated(x, wi, wg, act=act)
            again = gmm.gmm_gated(x, wi, wg, act=act)
            err = check(f"gmm_gated bfloat16 C={C} D={D} F={F} {act}", h,
                        gmm.gmm_gated_ref(x, wi, wg, act), KERNEL_TOL,
                        quiet=True)
            worst = max(worst, err)
            errs["gmm_gated", C] = max(errs.get(("gmm_gated", C), 0.0), err)
            torch.cuda.synchronize()
            if not torch.equal(h, again):
                raise AssertionError(f"gmm_gated C={C} D={D} F={F} {act}: "
                                     f"two calls differ")
    print(f"  gmm_gated (bf16, tensor cores) at C = "
          f"{sorted({c for c, _, _ in GATED_EDGES})}, also D=1544 F=520, "
          f"every act: max_abs_err {worst:.3g} (tol {KERNEL_TOL:g} x max(1, "
          f"|plain|)), the same bits on two calls")
    return errs


def card_vs_cpu(cfg_full):
    """Phase 3: reduced molmoact-7b on the card (kernels) and on the CPU
    (plain versions): equal token streams, prefill logits within
    CPU_LOGIT_TOL."""
    import torch
    from repro_torch.core import vla
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves, set_leaf
    cfg = dataclasses.replace(cfg_full.reduced(), n_cot_tokens=5)
    opts = M.ModelOptions()
    gen = torch.Generator().manual_seed(SEED)
    p_cpu = M.init_params(cfg, gen, torch.float32, device="cpu")
    p_gpu = {}
    for path, t in leaves(p_cpu):
        set_leaf(p_gpu, path, t.cuda())
    rng = np.random.default_rng(SEED)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 6)),
             "patches": rng.standard_normal(
                 (2, cfg.vision.num_tokens, cfg.vision.embed_dim),
                 dtype=np.float32)}
    _, _, max_seq = vla.control_step_lengths(cfg, 6)
    lg, _ = M.prefill(cfg, opts, p_gpu, batch, max_seq, device="cuda")
    lc, _ = M.prefill(cfg, opts, p_cpu, batch, max_seq, device="cpu")
    check("reduced prefill logits, card vs CPU", lg.cpu(), lc, CPU_LOGIT_TOL)
    og = vla.vla_control_step(cfg, opts, p_gpu, batch, device="cuda")
    oc = vla.vla_control_step(cfg, opts, p_cpu, batch, device="cpu")
    for name in ("cot_tokens", "action_tokens"):
        a, b = getattr(og, name).cpu(), getattr(oc, name)
        if not torch.equal(a, b):
            raise AssertionError(f"reduced {name}: card {a.tolist()} vs "
                                 f"CPU {b.tolist()}")
    print(f"  reduced control step: CoT {oc.cot_tokens.tolist()} and "
          f"actions {oc.action_tokens.tolist()} equal on card and CPU")
    serving_card_vs_cpu(cfg, p_cpu, p_gpu)


def serving_card_vs_cpu(cfg, p_cpu, p_gpu):
    """The reduced molmoact-7b serving engine on the card (kernels) and on
    the CPU (plain versions): 5 requests with mixed budgets on 2 slots;
    greedy streams equal for the dense layout and paged f32, int8 and fp8
    pools."""
    rng = np.random.default_rng(SEED + 1)
    reqs = [(rng.integers(0, cfg.vocab_size, n, dtype=np.int32), m,
             rng.standard_normal((cfg.vision.num_tokens,
                                  cfg.vision.embed_dim), dtype=np.float32))
            for n, m in ((6, 9), (9, 4), (4, 14), (7, 6), (5, 11))]
    # chunked engines: prompts of 8 + 21..52 positions in chunks of 32
    long_reqs = [(rng.integers(0, cfg.vocab_size, n, dtype=np.int32), m,
                  rng.standard_normal((cfg.vision.num_tokens,
                                       cfg.vision.embed_dim),
                                      dtype=np.float32))
                 for n, m in ((30, 9), (52, 4), (21, 14), (44, 6), (36, 11))]
    chunked = dict(chunked_prefill=True, chunk_size=PAGE, token_budget=48)
    runs = [(name, kw, reqs, 64) for name, kw in SERVE_ENGINES]
    runs += [(name, dict(chunked, **kw), long_reqs, 128)
             for name, kw in (("dense-chunked", {}),
                              ("paged-f32-chunked", dict(paged=True)),
                              ("paged-int8-token-chunked",
                               dict(paged=True, kv_dtype="int8",
                                    scale_granularity="token")))]
    res = engines_card_vs_cpu(cfg, p_cpu, p_gpu, runs, n_slots=2)
    spec_card_vs_cpu(cfg, p_cpu, p_gpu, reqs,
                     {layout: res[layout][0] for layout in
                      ("dense", "paged-f32", "paged-int8-token")})


def engines_card_vs_cpu(cfg, p_cpu, p_gpu, runs, n_slots: int,
                        opts=None):
    """Each run (name, engine options, requests, max_seq) on the card
    (kernels) and on the CPU (plain versions): every request finishes and
    the greedy streams are equal. Returns {name: (streams, card
    engine)}."""
    import warnings
    from repro_torch.models import model as M
    from repro_torch.serving import Request, ServingEngine
    out = {}
    for name, kw, rq, max_seq in runs:
        streams, engines = [], []
        for params, dev in ((p_gpu, "cuda"), (p_cpu, "cpu")):
            eng = ServingEngine(cfg, opts or M.ModelOptions(), params,
                                n_slots=n_slots, max_seq=max_seq, eos=-1,
                                tick_tokens=4, page_size=PAGE, device=dev,
                                **kw)
            for i, (prompt, m, px) in enumerate(rq):
                eng.submit(Request(uid=i, prompt=prompt, max_tokens=m,
                                   patches=px))
            with warnings.catch_warnings():
                # a budget clamped to the cache (the write-past-the-cache
                # runs) warns; the run's gates are the streams
                warnings.simplefilter("ignore", RuntimeWarning)
                streams.append({r.uid: r.out_tokens for r in eng.run()})
            engines.append(eng)
        if streams[0] != streams[1] or len(streams[0]) != len(rq):
            raise AssertionError(f"reduced serving ({name}): card "
                                 f"{streams[0]} vs CPU {streams[1]}")
        print(f"  reduced serving engine, {name}: {len(rq)} streams equal "
              f"on card and CPU ({sum(map(len, streams[0].values()))} "
              f"tokens)")
        out[name] = (streams[0], engines[0])
    return out


def fault_requests(cfg, rng, max_seq: int):
    """The write-past-a-full-cache repro at the card's page size: 2 slots,
    the first request's prefill (vision prefix and prompt) 6 positions
    short of ``max_seq`` and asking for 20 tokens, the second a 3-token
    prompt asking for 12: the first one's budget is clamped to the cache
    and its index reaches ``max_seq`` while the other slot still decodes
    (masked steps, then retired-slot steps, write past the cache)."""
    n_prefix = cfg.vision.num_tokens if cfg.vision else 0

    def patches():
        return (rng.standard_normal((n_prefix, cfg.vision.embed_dim),
                                    dtype=np.float32) if n_prefix else None)
    return [(rng.integers(0, cfg.vocab_size, n, dtype=np.int32), m,
             patches()) for n, m in ((max_seq - 6 - n_prefix, 20), (3, 12))]


def spec_card_vs_cpu(cfg, p_cpu, p_gpu, reqs, fused):
    """Phase 3, self-speculative decode on the reduced model (f32): K = 4
    with the half-stack draft and with the full-depth int8 draft, dense,
    paged f32 and paged int8-token; card and CPU streams equal, and the
    card's spec streams equal its fused streams (``fused``: {layout:
    streams}). Then verify_chunk on the card over the whole view and over
    the live band, the same bits; and the write-past-a-full-cache repro,
    dense and paged, card vs CPU."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves, set_leaf
    L = cfg.num_layers
    runs, layout_of = [], {}
    for layout, kw in (("dense", {}), ("paged-f32", dict(paged=True)),
                       ("paged-int8-token",
                        dict(paged=True, kv_dtype="int8",
                             scale_granularity="token"))):
        for draft, dkw in (("half", {}), ("int8-full",
                                          dict(draft_layers=L,
                                               draft_quant="int8"))):
            name = f"spec-{layout}-{draft}"
            layout_of[name] = layout
            runs.append((name, dict(kw, spec_decode=True, spec_k=SPEC_K,
                                    **dkw), reqs, 64))
    res = engines_card_vs_cpu(cfg, p_cpu, p_gpu, runs, n_slots=2)
    for name, (streams, eng) in res.items():
        layout = layout_of[name]
        if streams != fused[layout]:
            raise AssertionError(f"reduced {name}: card spec streams differ "
                                 f"from the card's fused {layout} streams")
        rep = eng.stats.phase_report()
        print(f"  {name}: = the card's fused {layout} streams; accepted a "
              f"pass {rep['spec_accept_per_pass']:.3f}, histogram "
              f"{rep['spec_accept_hist']}, masked rounds "
              f"{eng.masked_steps}, syncs {eng.stats.decode_syncs} over "
              f"{eng.stats.ticks} ticks")
    rng = np.random.default_rng(SEED + 12)
    caches = M.init_caches(cfg, 3, 64, torch.float32, device="cuda")
    for _, t in leaves(caches):
        t.normal_()
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (3, SPEC_K)),
                           device="cuda")
    start = torch.tensor([3, 17, 25], dtype=torch.int32, device="cuda")
    outs = []
    for live in (None, 32):
        fresh = {}
        for path, t in leaves(caches):
            set_leaf(fresh, path, t.clone())
        outs.append(M.verify_chunk(cfg, M.ModelOptions(), p_gpu, toks,
                                   fresh, start, live_len=live,
                                   device="cuda")[0])
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError("reduced verify_chunk: the whole view and the "
                             "live band give other bits on the card")
    print("  reduced verify_chunk on the card: the whole view (64) and the "
          "live band (32) give the same bits")
    fault = fault_requests(cfg, rng, 64)
    past_the_cache(engines_card_vs_cpu(
        cfg, p_cpu, p_gpu, [("write-past-cache-dense", {}, fault, 64),
                            ("write-past-cache-paged", dict(paged=True),
                             fault, 64)], n_slots=2))


def moe_card_vs_cpu(cfg_full):
    """Phase 3b: reduced granite-moe-3b-a800m in f32 on the card (the
    grouped-expert and attention kernels) and on the CPU (plain versions):
    prefill logits (f32 caches) within CPU_LOGIT_TOL, and the serving engine's greedy
    streams equal (dense, paged f32, paged int8 and chunked paged f32; 5
    requests with mixed budgets on 3 slots, so slots finish at staggered
    times and sit idle)."""
    import torch
    from repro_torch.kernels.moe_gmm import ops as gmm
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves, set_leaf
    cfg = cfg_full.reduced()
    p_cpu = M.init_params(cfg, torch.Generator().manual_seed(SEED),
                          torch.float32, device="cpu")
    p_gpu = {}
    for path, t in leaves(p_cpu):
        set_leaf(p_gpu, path, t.cuda())
    rng = np.random.default_rng(SEED + 8)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12))
    launches = gmm.gmm_gated.launches
    # f32 caches, as the engines keep: no bf16 rounding of cached keys
    lg, _ = M.prefill(cfg, M.ModelOptions(), p_gpu, {"tokens": tokens}, 32,
                      cache_dtype=torch.float32, device="cuda")
    if gmm.gmm_gated.launches - launches != cfg.num_layers:
        raise AssertionError("reduced granite prefill did not run the "
                             "grouped-expert kernels")
    lc, _ = M.prefill(cfg, M.ModelOptions(), p_cpu, {"tokens": tokens}, 32,
                      cache_dtype=torch.float32, device="cpu")
    check("reduced granite prefill logits (f32 caches), card vs CPU",
          lg.cpu(), lc, CPU_LOGIT_TOL)
    reqs = [(rng.integers(0, cfg.vocab_size, n, dtype=np.int32), m, None)
            for n, m in ((6, 9), (9, 4), (4, 14), (7, 6), (5, 11))]
    long_reqs = [(rng.integers(0, cfg.vocab_size, n, dtype=np.int32), m,
                  None)
                 for n, m in ((30, 9), (52, 4), (21, 14), (44, 6), (36, 11))]
    chunked = dict(chunked_prefill=True, chunk_size=PAGE, token_budget=48,
                   paged=True)
    runs = [("moe-dense", {}, reqs, 64),
            ("moe-paged-f32", dict(paged=True), reqs, 64),
            ("moe-paged-int8-head", dict(paged=True, kv_dtype="int8"), reqs,
             64),
            ("moe-paged-f32-chunked", chunked, long_reqs, 128)]
    engines_card_vs_cpu(cfg, p_cpu, p_gpu, runs, n_slots=3)
    # the write-past-a-full-cache repro under capacity dispatch: a done
    # row's hidden state competes with the live one's
    past_the_cache(engines_card_vs_cpu(
        cfg, p_cpu, p_gpu, [("moe-write-past-cache-dense", {},
                             fault_requests(cfg, rng, 32), 32)], n_slots=2,
        opts=M.ModelOptions(moe_capacity_factor=0.5)))


def past_the_cache(res):
    """The repro's runs really wrote past the cache: the first request
    emitted the 7 tokens its clamped budget allows (the prefill's and 6
    decoded, its index ending at max_seq) and later steps of its tick ran
    masked."""
    for name, (streams, eng) in res.items():
        if len(streams[0]) != 7 or not eng.masked_steps:
            raise AssertionError(f"{name}: {len(streams[0])} tokens, "
                                 f"{eng.masked_steps} masked steps")
        print(f"  {name}: the clamped request's index reached max_seq; "
              f"{eng.masked_steps} masked steps wrote past the cache")


def full_params(cfg):
    """Seeded random bf16 weights of the full-width model, on the card."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = M.init_params(cfg, gen, torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in leaves(params))
    print(f"full width: {cfg.name}, {n_params / 1e9:.3f} B parameters in "
          f"bf16, initialised in {time.perf_counter() - t0:.1f} s")
    return params


def reset_launches():
    from repro_torch.kernels.chunk_prefill.ops import chunk_prefill_attention
    from repro_torch.kernels.chunk_prefill.paged import (
        paged_chunk_prefill_attention)
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.paged import (
        paged_decode_attention)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.moe_gmm.ops import gmm_down, gmm_gated
    from repro_torch.kernels.ssd.ops import ssd
    kernels = {"decode_attention": decode_attention,
               "chunk_prefill": chunk_prefill_attention,
               "paged_decode_attention": paged_decode_attention,
               "paged_chunk_prefill": paged_chunk_prefill_attention,
               "gmm_gated": gmm_gated, "gmm_down": gmm_down, "ssd": ssd,
               "flash_attention": flash_attention}
    for fn in kernels.values():
        fn.launches = 0
    return kernels


def read_launches(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def full_width(cfg, params):
    """Phase 4: the full-width molmoact-7b control step, B=4, its decode
    replayed from a CUDA graph (``M.DecodeGraph``, the main path) and run
    eagerly (the oracle): the same tokens, the same kernels a step (by
    name, in order), both modes timed phase by phase."""
    import torch
    from repro_torch.core import vla
    from repro_torch.models import model as M
    dev = torch.device("cuda")
    opts = M.ModelOptions()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    tokens = torch.randint(0, cfg.vocab_size, (FULL_B, FULL_TEXT),
                           generator=gen, device=dev)
    patches = torch.randn((FULL_B, cfg.vision.num_tokens,
                           cfg.vision.embed_dim), generator=gen,
                          device=dev).bfloat16()
    prompt, n_act, max_seq = vla.control_step_lengths(cfg, FULL_TEXT)

    prefix = M.encode_vision(cfg, opts, params, patches, device=dev)
    batch = {"tokens": tokens, "prefix": prefix}
    graphs = {"graphed": M.DecodeGraph(dev),
              "eager": M.DecodeGraph(dev, eager=True)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = reset_launches()
    t0 = time.perf_counter()
    out = vla.vla_control_step(cfg, opts, params, batch, device=dev,
                               graph=graphs["graphed"])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = read_launches(kernels)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"chunk_prefill": cfg.num_layers,
            "decode_attention": cfg.num_layers * (cfg.n_cot_tokens + n_act),
            "paged_decode_attention": 0, "paged_chunk_prefill": 0,
            "gmm_gated": 0, "gmm_down": 0, "ssd": 0, "flash_attention": 0}
    print(f"  launches on the main path (decode graph-replayed, replays "
          f"counted): {launches} (expected {want})")
    if launches != want:
        raise AssertionError("the main path did not run through the kernels "
                             "as expected")
    for name, t, n in (("cot_tokens", out.cot_tokens, cfg.n_cot_tokens),
                       ("action_tokens", out.action_tokens, n_act)):
        if tuple(t.shape) != (FULL_B, n) or int(t.min()) < 0 \
                or int(t.max()) >= cfg.vocab_size:
            raise AssertionError(f"{name}: shape {tuple(t.shape)}, range "
                                 f"[{int(t.min())}, {int(t.max())}]")
    eager = vla.vla_control_step(cfg, opts, params, batch, device=dev,
                                 graph=graphs["eager"])
    if not (torch.equal(eager.cot_tokens, out.cot_tokens)
            and torch.equal(eager.action_tokens, out.action_tokens)):
        raise AssertionError("graphed and eager control steps give other "
                             "tokens")
    print(f"  graphed and eager control steps: the same {cfg.n_cot_tokens} "
          f"CoT and {n_act} action tokens per robot")

    # the same phases, timed one by one with CUDA events, in both modes
    names = ("vision", "prefill", "cot_decode", "action_decode")
    runs = {mode: [] for mode in graphs}
    for rep in range(PHASE_REPEATS):
        for mode, graph in graphs.items():
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            prefix = M.encode_vision(cfg, opts, params, patches, device=dev)
            ev[1].record()
            logits, caches = M.prefill(cfg, opts, params,
                                       {"tokens": tokens, "prefix": prefix},
                                       max_seq, device=dev)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            ev[2].record()
            cot, tok, caches = vla.decode_tokens(
                cfg, opts, params, tok, caches, prompt, cfg.n_cot_tokens,
                device=dev, graph=graph)
            ev[3].record()
            act, _, _ = vla.decode_tokens(
                cfg, opts, params, tok, caches, prompt + cfg.n_cot_tokens,
                n_act, device=dev, graph=graph)
            ev[4].record()
            torch.cuda.synchronize()
            if not (bool(torch.isfinite(logits).all())
                    and torch.equal(cot, out.cot_tokens)
                    and torch.equal(act, out.action_tokens)):
                raise AssertionError(f"the phase-by-phase run ({mode}) "
                                     f"disagrees with vla_control_step")
            runs[mode].append({n: ev[i].elapsed_time(ev[i + 1])
                               for i, n in enumerate(names)})
            print(f"  run {rep} ({mode}): phases (ms) " + ", ".join(
                f"{n}={t:.2f}" for n, t in runs[mode][-1].items())
                + f", step {sum(runs[mode][-1].values()):.2f}")
    phase_ms = {}
    for mode, rs in runs.items():
        phase_ms[mode] = {n: float(np.median([r[n] for r in rs]))
                          for n in names}
        total = float(np.median([sum(r.values()) for r in rs]))
        act_share = np.median([r["action_decode"] / sum(r.values())
                               for r in rs])
        dec_share = np.median([(r["cot_decode"] + r["action_decode"])
                               / sum(r.values()) for r in rs])
        print(f"  {mode}, median of {PHASE_REPEATS}: control step "
              f"{total:.2f} ms (" + ", ".join(
                  f"{n} {t:.2f}" for n, t in phase_ms[mode].items())
              + f"); action-generation share {act_share:.4f}; CoT+action "
              f"decode share {dec_share:.4f}")
    simulated_split(cfg, phase_ms["graphed"])
    runner = graphs["graphed"].runner
    print(f"  vla_control_step (graphed, vision precomputed, first call) "
          f"{step_s * 1e3:.2f} ms by host clock; peak memory {peak_gb:.2f} "
          f"GB; decode graph captures {runner.captures} (one a control "
          f"step's caches), {runner.capture_s / runner.captures * 1e3:.1f} "
          f"ms a capture")
    graph = graphs["graphed"]

    def reset():
        # the traced steps decode at the action loop's first position
        # again: the caches hold one position past the loops, no more
        graph.counter.zero_()
        graph.idx.fill_(prompt + cfg.n_cot_tokens)
    graph_step_checks("control-step decode", runner, reset)
    tok = torch.zeros(FULL_B, 1, dtype=torch.long, device="cuda")
    for mode, graph in graphs.items():
        def run_steps(n, g=graph):
            vla.decode_tokens(cfg, opts, params, tok, caches,
                              prompt + cfg.n_cot_tokens, n, device="cuda",
                              graph=g)
        run_steps(1)             # a capture for these caches, untraced
        decode_breakdown(run_steps, phase_ms[mode]["action_decode"] / n_act,
                         label=f"decode step ({mode})")
    return launches


def simulated_split(cfg, measured):
    """Phase 4, the paper's Fig. 2 question asked of the card: the
    analytical model's phase split of the same control step (``core.
    xpu_sim.simulate_vla`` at B = FULL_B) on an H100 built from this
    script's data-sheet constants (HBM rate, bf16 peak; the model's
    default efficiencies), beside the graphed step's measured split
    (``measured``: ms by phase, medians). The generation fraction is the
    paper's: prefill + CoT decode over the step."""
    from repro_torch.core.hardware import Hardware
    from repro_torch.core.xpu_sim import simulate_vla
    hw = Hardware("h100", mem_bw_gbs=HBM_BYTES_PER_S / 1e9,
                  bf16_tflops=OPS_PER_S["bfloat16"] / 1e12, hbm_gb=80)
    sim = simulate_vla(cfg, hw, B=FULL_B)
    sim_ms = {p: t * 1e3 for p, t in sim.phase_seconds().items()}
    names = dict(zip(("vision_encode", "generation_prefill",
                      "generation_decode", "action_generate"),
                     ("vision", "prefill", "cot_decode", "action_decode")))
    total = sum(measured.values())
    gen = (measured["prefill"] + measured["cot_decode"]) / total
    print(f"  analytical model (simulate_vla, {hw.name}: "
          f"{hw.mem_bw_gbs:g} GB/s, {hw.bf16_tflops:g} TFLOP/s bf16, "
          f"gemm_eff {hw.gemm_eff}, gemv_bw_eff {hw.gemv_bw_eff}; B="
          f"{FULL_B}) vs measured (graphed, median): " + ", ".join(
              f"{m} {sim_ms[p]:.2f} vs {measured[m]:.2f} ms"
              for p, m in names.items())
          + f"; step {sim.e2e * 1e3:.2f} vs {total:.2f} ms; generation "
          f"fraction {sim.generation_fraction:.4f} vs {gen:.4f}; action "
          f"share {sim.phase_fractions()['action_generate']:.4f} vs "
          f"{measured['action_decode'] / total:.4f}")


def graph_step_checks(label: str, runner, reset):
    """One step replayed from ``runner``'s graph against the same step run
    eagerly: the same kernels by name in the order the device ran them
    (both traced in one profiler session), and at most
    MAX_GRAPH_LAUNCHES host launch calls a replayed step (torch.profiler's
    runtime events over 4 replays; the eager step's are printed beside).
    ``reset`` puts the step's counter (and any position that would leave
    its cache) back before each traced run: its buffers take only so many
    steps."""
    import difflib
    replay = (lambda: runner.step(runner.key))
    # the profiler has now and then left a few of a long step's device
    # events (or a marker) out of a trace: a trace with a missing marker
    # or a difference is taken again, up to TRACE_ATTEMPTS times in all,
    # and each attempt's outcome is printed. A step that runs other
    # kernels when replayed differs in every attempt.
    graphed = eager = None
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        seqs = step_sequences([(reset, replay), (reset, runner.body)])
        if seqs is not None:
            graphed, eager = seqs
            if graphed and graphed == eager:
                break
        print(f"  {label}: trace {attempt} " + (
            "lost a marker kernel" if seqs is None else
            f"has {len(seqs[0])} device events graph-replayed, "
            f"{len(seqs[1])} eager, not the same"))
    if graphed is None:
        raise AssertionError(f"{label}: every trace lost a marker kernel")
    reset()
    calls = launch_calls(replay, steps=4)
    reset()
    e_calls = launch_calls(runner.body)
    n_calls = sum(calls.values())
    print(f"  {label}: a step runs {len(graphed)} kernels graph-replayed, "
          f"{len(eager)} eagerly; host launch calls a step: graphed "
          f"{n_calls:g} {calls}, eager {sum(e_calls.values()):g}; capture "
          f"{runner.capture_s / max(runner.captures, 1) * 1e3:.1f} ms")
    if not graphed or graphed != eager:
        ops = [op for op in difflib.SequenceMatcher(
            None, graphed, eager, autojunk=False).get_opcodes()
            if op[0] != "equal"]
        raise AssertionError(
            f"{label}: the replayed step's kernels differ from the eager "
            f"step's: " + "; ".join(
                f"{tag} graphed[{i1}:{i2}] {[n[:60] for n in graphed[i1:i2]]}"
                f" eager[{j1}:{j2}] {[n[:60] for n in eager[j1:j2]]}"
                for tag, i1, i2, j1, j2 in ops[:4]))
    if not 0 < n_calls <= MAX_GRAPH_LAUNCHES:
        raise AssertionError(f"{label}: {n_calls} host launch calls a "
                             f"graph-replayed step")


# host calls that start work on the device, as the profiler names them
# (cudaLaunchKernel, cuLaunchKernel, cudaGraphLaunch and the like)
MAX_GRAPH_LAUNCHES = 2
TRACE_ATTEMPTS = 3
TRACE_PAD_S = 0.2     # idle host time at each edge of a traced window


def _traced(body):
    """torch.profiler's events (device activity and runtime calls) over
    ``body()``. A warm-up cycle and a pause come first, and a pause last:
    device events near the edges of a traced window were sometimes
    missing from it, more often the longer the process had run (as if
    the device's timestamps drifted from the host's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    traces = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traces.append(p.events())) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        time.sleep(TRACE_PAD_S)
        body()
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
        prof.step()
    events, = traces
    return events


def step_sequences(segments):
    """For each (prepare, fn) of ``segments``: the names of the device's
    kernels, memory copies and sets over one call of ``fn``, in the order
    it ran them. One profiler session traces them all; a marker kernel
    (``torch.cuda._sleep``) before and after each call splits the
    device's timeline. The first segment runs twice, and its first run is
    not read: the device events at the start of a traced window were
    sometimes left out of it (a marker among them, their timestamps ~1
    ms ahead of the host's launch calls). None when a marker of a segment
    read was lost."""
    import torch
    from torch.autograd import DeviceType

    def body():
        for prepare, fn in segments[:1] + segments:
            prepare()
            torch.cuda._sleep(1000)
            fn()
            torch.cuda._sleep(1000)
    device = sorted((e for e in _traced(body)
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(device) if "spin_kernel" in e.name]
    n = 2 * len(segments)
    if not n <= len(marks) <= n + 2:
        print(f"  a trace of {len(device)} device events holds "
              f"{len(marks)} marker kernels, not {n} (+ 2 unread)")
        return None
    marks = marks[-n:]
    return [[_op(e.name) for e in device[a + 1:b]]
            for a, b in zip(marks[::2], marks[1::2])]


def launch_calls(fn, steps: int = 1):
    """Host launch calls per call of ``fn`` by name, over ``steps``
    calls (torch.profiler's runtime events)."""
    from torch.autograd import DeviceType

    def body():
        for _ in range(steps):
            fn()
    calls = {}
    for e in _traced(body):
        if e.device_type != DeviceType.CUDA and "Launch" in e.name:
            calls[e.name] = calls.get(e.name, 0) + 1 / steps
    return calls


def _op(name: str) -> str:
    """A device event's name, a memory copy or set by its kind only: a
    graph runs a captured copy as a memcpy node, which the profiler names
    by the kernel that carries it out (``memcpy32_post``), where an eager
    step names the copy itself."""
    low = name.lower()
    return next((k for k in ("memcpy", "memset") if low.startswith(k)),
                name)


# substrings of kernel names -> the part of a decode step they belong to
KERNEL_GROUPS = (("grouped experts", ("gmm_kernel", "gmm_gated",
                                      "gmm_down")),
                 ("attention", ("decode_kernel", "split_combine",
                                "chunk_kernel", "chunk_tf32", "chunk_mma",
                                "paged_kernel", "flash_kernel")),
                 ("library GEMMs", ("gemm", "nvjet", "xmma", "cutlass")))


def decode_breakdown(run_steps, wall_ms: float, steps: int = 4,
                     label: str = "decode step"):
    """Device-busy time of a full-width decode step (or of the step
    ``label`` names), by torch.profiler over ``steps`` steps
    (``run_steps(n)`` runs n steps), against its wall time: the device's
    idle share, device time by part of the step (the grouped-expert
    kernels, attention, the library's GEMMs, the rest: norms, RoPE,
    routing and dispatch, sampling), and the kernels that take the most
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_steps(steps)
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    if busy_ms == 0:
        print(f"  {label}: device busy time not measured (the profiler "
              "saw no kernels)")
        return
    # the CUDA activity also lists runtime calls (no device time): skip them
    kernels = sum(e.count for e in rows if e.self_device_time_total) / steps
    print(f"  {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} "
          f"ms, idle share {1 - busy_ms / wall_ms:.4f}, {kernels:.0f} "
          f"kernels per step")
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for e in rows:
        name = next((g for g, keys in KERNEL_GROUPS
                     if any(k in e.key for k in keys)), "other")
        groups[name] += e.self_device_time_total / 1e3 / steps
    print("    device ms/step by part: " + ", ".join(
        f"{g} {t:.3f}" for g, t in groups.items()))
    for e in rows[:8]:
        print(f"    {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
              f"{e.count // steps:5d} calls/step  {e.key[:70]}")
    # the port's own kernels (grouped experts, attention): device ms a
    # launch as this step runs them, and launches a step
    ours = [e for e in rows if e.self_device_time_total and any(
        k in e.key for _, keys in KERNEL_GROUPS[:2] for k in keys)]
    if ours:
        print("    port kernels, ms a launch x launches a step: " + "; ".join(
            f"{_short(e.key)} "
            f"{e.self_device_time_total / 1e3 / e.count:.4f} x "
            f"{e.count / steps:g}" for e in ours))


def _short(name: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameters."""
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0].split("::")[-1]


def observations(cfg, vocab: int, seed: int):
    """SERVE_OBS seeded observations: FULL_TEXT instruction tokens below
    ``vocab`` and the vision tower's patches."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_vis, emb = cfg.vision.num_tokens, cfg.vision.embed_dim
    return [(torch.randint(0, vocab, (FULL_TEXT,), generator=gen,
                           device="cuda").cpu().numpy().astype(np.int32),
             torch.randn((n_vis, emb), generator=gen,
                         device="cuda").cpu().numpy())
            for _ in range(SERVE_OBS)]


def run_engine(cfg, params, obs, kw, device):
    """The 16 requests (each observation twice in a row) on one engine;
    returns (engine, {uid: tokens}, wall seconds)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serving import Request, ServingEngine
    eng = ServingEngine(cfg, M.ModelOptions(), params, n_slots=SERVE_SLOTS,
                        max_seq=SERVE_MAX_SEQ, eos=-1,
                        tick_tokens=SERVE_TICK, device=device, **kw)
    for i in range(2 * SERVE_OBS):
        prompt, px = obs[i // 2]
        eng.submit(Request(uid=i, prompt=prompt, max_tokens=SERVE_TOKENS,
                           patches=px))
    t0 = time.perf_counter()
    done = eng.run()
    if device == "cuda":
        torch.cuda.synchronize()
    return eng, {r.uid: r.out_tokens for r in done}, \
        time.perf_counter() - t0


PLAN_FIELDS = ("ticks", "device_steps", "prefill_tokens", "prefill_skipped",
               "prefix_hits", "pages_hwm", "tick_prefill_tokens")


def plan_counts(eng):
    """The counters a chunked engine's host plan fixes: they follow from
    the requests' lengths and the pool alone (eos never fires)."""
    return {f: getattr(eng.stats, f) for f in PLAN_FIELDS} | {
        "masked_steps": eng.masked_steps}


def host_plans(cfg):
    """The chunked engines' host plan, replayed on the CPU: a model of the
    reduced width with the full model's vision prefix (576 positions) gets
    the same request lengths, twins, slots, pool and budget, so it runs the
    same ticks, chunks, prefix hits and pages; the counts of the card's
    engines must equal these. Returns {"dense": counts, "paged": counts}."""
    import torch
    from repro_torch.models import model as M
    small = cfg.reduced()
    small = dataclasses.replace(small, vision=dataclasses.replace(
        small.vision, num_tokens=cfg.vision.num_tokens))
    params = M.init_params(small, torch.Generator().manual_seed(SEED),
                           torch.float32, device="cpu")
    obs = observations(small, small.vocab_size, SEED + 4)
    plans = {}
    for layout, kw in (("dense", {}), ("paged", dict(paged=True))):
        t0 = time.perf_counter()
        eng, out, _ = run_engine(small, params, obs, dict(CHUNKED, **kw),
                                 "cpu")
        if len(out) != 2 * SERVE_OBS:
            raise AssertionError(f"host plan ({layout}): {len(out)} "
                                 f"requests finished")
        plans[layout] = plan_counts(eng)
        c = plans[layout]
        print(f"  host plan ({layout}, replayed on the CPU in "
              f"{time.perf_counter() - t0:.1f} s): ticks {c['ticks']}, "
              f"device steps {c['device_steps']}, masked steps "
              f"{c['masked_steps']}, prefill_tokens {c['prefill_tokens']}, "
              f"prefill_skipped {c['prefill_skipped']}, prefix_hits "
              f"{c['prefix_hits']}, pages_hwm {c['pages_hwm']}")
    return plans


def serving_full(cfg, params):
    """Phase 5: the full-width serving engine. 16 requests from 8 seeded
    observations (576 patches, 64 instruction tokens; each observation sent
    twice in a row, so its twin can hit the prefix cache), 193 tokens each
    (eos=-1 never fires), on 8 slots with max_seq 864 and 8-token ticks,
    for every engine of SERVE_ENGINES (admit-stall) and CHUNKED_ENGINES.
    Gates (``serve_engine``), and: the chunked engines' host plan counts
    (ticks, steps, prefix hits, pages) equal to its CPU replay's; paged-f32
    streams equal dense streams in each mode. The engines run the first
    SERVE_LAYERS layers. Returns {engine: (launches, stats, masked
    steps)}."""
    obs = observations(cfg, cfg.vocab_size, SEED + 3)
    plans = host_plans(cfg)
    cfg, params = first_layers(cfg, params, SERVE_LAYERS)
    results, streams = {}, {}
    for name, kw in SERVE_ENGINES + CHUNKED_ENGINES:
        eng, out, launches, gates, eager = serve_both(
            cfg, params, obs, name, kw, cfg.vision.num_tokens + FULL_TEXT)
        if eng.scheduler is not None:
            plan = plans["paged" if eng.paged else "dense"]
            gates["host plan counts equal the CPU replay's"] = \
                plan_counts(eng) == plan == plan_counts(eager)
        failed = [k for k, ok in gates.items() if not ok]
        if failed:
            raise AssertionError(f"full-width serving ({name}): {failed}")
        streams[name] = out
        results[name] = (launches, eng.stats, eng.masked_steps)
        if name in ("dense", "paged-f32"):
            tick_breakdown(eng, f"{cfg.name} ({SERVE_LAYERS} layers, "
                                f"{name})")
        del eng, eager
    for paged, dense in (("paged-f32", "dense"),
                         ("paged-f32-chunked", "dense-chunked")):
        if streams[paged] != streams[dense]:
            raise AssertionError(f"full-width serving: {paged} streams "
                                 f"differ from {dense} streams")
        print(f"  {paged} streams equal {dense} streams")
    for name, out in streams.items():
        if "int8" in name or "fp8" in name:
            ref = "paged-f32-chunked" if "chunked" in name else "paged-f32"
            print(f"  {name}: share of tokens equal to {ref}'s streams "
                  f"{stream_share(out, streams[ref]):.4f} (reported, not a "
                  f"gate)")
    print(f"  dense-chunked vs dense (admit-stall): share of equal tokens "
          f"{stream_share(streams['dense-chunked'], streams['dense']):.4f} "
          f"(reported, not a gate)")
    return results, streams


def spec_serving_full(cfg, params, fused):
    """Phase 5c: the full-width self-speculative engines. Phase 5's 16
    requests, 8 slots, 8-token ticks, f32 caches, pages of 32 and first
    SERVE_LAYERS layers; K = SPEC_K with the full-depth int8 draft (every
    layer, weights rounded to int8 codes a channel), dense and paged f32,
    each with its round replayed from a CUDA graph (the main path) and run
    eagerly. Gates (``serve_spec``) in each mode, and: graphed streams and
    launches equal eager ones, a replayed round runs the eager round's
    kernels in order with at most MAX_GRAPH_LAUNCHES host launch calls.
    Reported, not gated: the share of tokens equal to phase 5's fused
    streams (``fused``): the verify chunk runs the chunk kernels and a
    wider GEMM than a decode step, and near-tie argmaxes of random weights
    flip. Returns {engine: (launches, stats, masked rounds)}."""
    t0 = time.perf_counter()
    obs = observations(cfg, cfg.vocab_size, SEED + 3)
    cfg, params = first_layers(cfg, params, SERVE_LAYERS)
    results = {}
    for name, kw, ref in SPEC_ENGINES:
        kw = dict(kw, draft_layers=cfg.num_layers)
        eng, out, launches, gates = serve_spec(cfg, params, obs, name, kw)
        tick = eng._tick
        graph_step_checks(f"{name} round", tick.graph, reset=lambda: None)
        eager, out_e, launches_e, gates_e = serve_spec(
            cfg, params, obs, name, kw, graphs=False)
        gates.update({f"eager: {k}": ok for k, ok in gates_e.items()})
        gates["graphed streams equal eager streams"] = out == out_e
        gates["graphed launches equal eager launches"] = \
            launches == launches_e
        failed = [k for k, ok in gates.items() if not ok]
        if failed:
            raise AssertionError(f"full-width speculative serving ({name}): "
                                 f"{failed}")
        g, e = eng.stats, eager.stats
        print(f"  {name}, graphed vs eager: decode tick p50/p99 "
              f"{np.percentile(g.decode_tick_s, 50) * 1e3:.2f}/"
              f"{np.percentile(g.decode_tick_s, 99) * 1e3:.2f} vs "
              f"{np.percentile(e.decode_tick_s, 50) * 1e3:.2f}/"
              f"{np.percentile(e.decode_tick_s, 99) * 1e3:.2f} ms; decode "
              f"{g.decode_time:.3f} vs {e.decode_time:.3f} s; one capture "
              f"{tick.graph.capture_s * 1e3:.1f} ms ({tick.graph.captures} "
              f"captures); share of tokens equal to phase 5's {ref} streams "
              f"{stream_share(out, fused[ref]):.4f} (reported, not a gate)")
        round_breakdown(eng, f"{cfg.name} ({SERVE_LAYERS} layers, {name})")
        results[name] = (launches, eng.stats, eng.masked_steps)
        del eng, eager
    print(f"  phase 5c took {time.perf_counter() - t0:.1f} s")
    return results


def serve_spec(cfg, params, obs, name: str, kw, graphs: bool = True):
    """The 16 requests through one full-width speculative engine, its
    rounds replayed from a CUDA graph or (``graphs=False``) run eagerly;
    prints its row and returns (engine, {uid: tokens}, launches, gates).
    Gates: every request finishes with 193 tokens; a round (masked rounds
    too) launches the decode kernel once a draft layer for each of its
    spec_k - 1 draft steps and the layout's chunk kernel once a layer for
    its verify chunk; each admission prefill the dense chunk kernel once a
    layer; nothing else; one first-token readback per request and at least
    one readback a tick; a paged pool drains to 0 pages."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels = reset_launches()
    eng, out, wall = run_engine(cfg, params, obs, dict(kw, graphs=graphs),
                                "cuda")
    launches = read_launches(kernels)
    st, L = eng.stats, cfg.num_layers
    rounds = st.device_steps + eng.masked_steps
    rep = st.phase_report()
    n_tok = sum(map(len, out.values()))
    decode_kernel = ("paged_decode_attention" if eng.paged
                     else "decode_attention")
    verify_kernel = "paged_chunk_prefill" if eng.paged else "chunk_prefill"
    expected = {decode_kernel: rounds * (SPEC_K - 1) * eng.draft_layers,
                verify_kernel: rounds * L}
    expected["chunk_prefill"] = expected.get("chunk_prefill", 0) \
        + 2 * SERVE_OBS * L
    print(f"  {name} ({'graphed' if graphs else 'eager'}): {len(out)} "
          f"requests, {n_tok} tokens in {wall:.3f} s "
          f"({n_tok / wall:.2f} tokens/s); ticks {st.ticks}, rounds "
          f"{st.device_steps}, masked rounds {eng.masked_steps} "
          f"({eng.masked_steps / st.ticks:.3f} a tick), syncs "
          f"{st.decode_syncs} ({st.decode_syncs / st.ticks:.3f} a tick); "
          f"verify passes {st.spec_verify_passes}, accepted tokens a pass "
          f"{rep['spec_accept_per_pass']:.4f}, histogram "
          f"{rep['spec_accept_hist']}, spec_draft_frac "
          f"{rep['spec_draft_frac']:.4f}; decode tick p50/p99 "
          f"{rep['decode_tick_p50'] * 1e3:.2f}/"
          f"{rep['decode_tick_p99'] * 1e3:.2f} ms; TTFT p50 "
          f"{rep['ttft_p50'] * 1e3:.2f} ms; phases prefill "
          f"{st.prefill_time:.3f} s decode {st.decode_time:.3f} s; pages_hwm "
          f"{st.pages_hwm}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (the draft's "
          f"int8-rounded tree included); launches {launches}")
    idle = [k for k in launches if not expected.get(k)]
    gates = {
        "every request finishes with 193 tokens":
            len(out) == 2 * SERVE_OBS
            and all(len(t) == SERVE_TOKENS for t in out.values()),
        f"{decode_kernel} launches == rounds x {SPEC_K - 1} x "
        f"{eng.draft_layers}":
            launches[decode_kernel] == expected[decode_kernel],
        f"{verify_kernel} launches == rounds x {L} (+ {L} x 16 admissions)":
            launches[verify_kernel] == expected[verify_kernel],
        "chunk_prefill launches as expected":
            launches["chunk_prefill"] == expected["chunk_prefill"],
        f"{idle} never launched": not any(launches[k] for k in idle),
        "one first-token readback per request":
            st.prefill_syncs == 2 * SERVE_OBS,
        "a readback or more a tick": st.decode_syncs >= st.ticks,
        "verify passes counted": st.spec_verify_passes > 0,
    }
    if eng.paged:
        gates["pages_in_use == 0 at drain"] = st.pages_in_use == 0
    return eng, out, launches, gates


def round_breakdown(eng, label: str):
    """``decode_breakdown`` of a speculative engine's round after it
    drained (every round masked, but each a full draft and verify),
    replayed from its graph and run eagerly; the wall by host clock over
    4 rounds."""
    import torch
    tick = eng._tick
    for mode, step in (("graphed", lambda: tick.graph.step(tick.graph.key)),
                       ("eager", tick.graph.body)):
        def run_steps(n, step=step):
            for _ in range(n):
                step()
        run_steps(2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_steps(4)
        torch.cuda.synchronize()
        decode_breakdown(run_steps, (time.perf_counter() - t0) / 4 * 1e3,
                         label=f"{label} speculative round ({mode})")


def stream_share(out, ref) -> float:
    """Share of ``ref``'s tokens that ``out`` repeats at the same place."""
    same = sum(a == b for u in out for a, b in zip(out[u], ref[u]))
    return same / sum(len(t) for t in ref.values())


def first_layers(cfg, params, n: int, dtype=None):
    """The model cut to its first ``n`` layers: (config, parameters),
    the stacked layer leaves sliced (views unless ``dtype`` asks for a
    copy in another type)."""
    from repro_torch.models.params import leaves, set_leaf
    cut = {}
    for path, t in leaves(params):
        if path.startswith("decoder/blocks/"):
            t = t[:n]
        set_leaf(cut, path, t if dtype is None else t.to(dtype))
    return dataclasses.replace(cfg, num_layers=n), cut


def serve_engine(cfg, params, obs, name: str, kw, prompt_len: int,
                 graphs: bool = True):
    """The 16 requests through one full-width engine on the card, its tick
    step replayed from a CUDA graph or (``graphs=False``) run eagerly;
    prints its serving row and returns (engine, {uid: tokens}, launches,
    gates). Launches count replays (``graphs.StepGraph``).
    Gates: every request finishes with 193 tokens; each decode step (masked
    steps too) launches the engine's decode kernel once an attention layer,
    and each prefill run its chunk kernel once an attention layer
    (admit-stall: one dense chunk prefill per request; chunked: one launch
    of the layout's chunk kernel per chunk run); MoE layers launch
    gmm_gated and gmm_down once a layer per prefill run and per decode
    step; Mamba2 layers launch the SSD scan once a layer per prefill run
    (decode runs the recurrence, no kernel); no other kernel runs; one
    readback per decode tick and one first-token readback per request;
    admit-stall: a readback every tick, and paged engines >= 8 x the
    prompt's pages of prefix hits; chunked: prefill_tokens +
    prefill_skipped = 16 x the prompt, no tick prefills more than the
    token budget; a paged pool drains to 0 pages."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels = reset_launches()
    eng, out, wall = run_engine(cfg, params, obs, dict(kw, graphs=graphs),
                                "cuda")
    launches = read_launches(kernels)
    st = eng.stats
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    L = cfg.num_layers
    n_tok = sum(map(len, out.values()))
    steps = st.device_steps + eng.masked_steps
    rep = st.phase_report()
    chunked = eng.scheduler is not None
    decode_kernel = ("paged_decode_attention" if eng.paged
                     else "decode_attention")
    chunk_kernel = ("paged_chunk_prefill" if eng.paged and chunked
                    else "chunk_prefill")
    # a chunk run adds chunk_size x max_seq full-view key lanes
    runs = (st.prefill_key_lanes_full // (CHUNK_SIZE * SERVE_MAX_SEQ)
            if chunked else 2 * SERVE_OBS)
    n_attn = sum(cfg.is_attn_layer(i) for i in range(L))
    n_moe = sum(cfg.is_moe_layer(i) for i in range(L))
    expected = {decode_kernel: n_attn * steps, chunk_kernel: n_attn * runs,
                "gmm_gated": n_moe * (runs + steps),
                "gmm_down": n_moe * (runs + steps),
                "ssd": (L - n_attn) * runs}
    idle = [k for k in launches if not expected.get(k)]
    print(f"  {name} ({'graphed' if graphs else 'eager'}): {len(out)} "
          f"requests, {n_tok} tokens in "
          f"{wall:.3f} s ({n_tok / wall:.2f} tokens/s); ticks "
          f"{st.ticks}, device steps {st.device_steps}, masked steps "
          f"{eng.masked_steps}; TTFT p50/p99 "
          f"{rep['ttft_p50'] * 1e3:.2f}/{rep['ttft_p99'] * 1e3:.2f} ms; "
          f"decode tick p50/p99 {rep['decode_tick_p50'] * 1e3:.2f}/"
          f"{rep['decode_tick_p99'] * 1e3:.2f} ms; tick p50/p99 "
          f"{np.percentile(st.tick_s, 50) * 1e3:.2f}/"
          f"{np.percentile(st.tick_s, 99) * 1e3:.2f} ms; phases vision "
          f"{st.vision_time:.3f} s prefill {st.prefill_time:.3f} s "
          f"decode {st.decode_time:.3f} s; prefill_tokens "
          f"{st.prefill_tokens}, prefill_skipped {st.prefill_skipped}, "
          f"max tick prefill {max(st.tick_prefill_tokens)}; "
          f"{'chunk runs ' + str(runs) + '; ' if chunked else ''}"
          f"pages_hwm {st.pages_hwm}, cache_bytes_hwm "
          f"{st.cache_bytes_hwm}, prefix_hits {st.prefix_hits}; peak "
          f"memory {peak_gb:.2f} GB; launches {launches}")
    gates = {
        "every request finishes with 193 tokens":
            len(out) == 2 * SERVE_OBS
            and all(len(t) == SERVE_TOKENS for t in out.values()),
        f"{decode_kernel} launches == {n_attn} x tick steps":
            launches[decode_kernel] == expected[decode_kernel],
        f"{chunk_kernel} launches == {n_attn} x {runs} prefill runs":
            launches[chunk_kernel] == expected[chunk_kernel],
        f"{idle} never launched": not any(launches[k] for k in idle),
        "one readback per decode tick":
            st.decode_syncs == len(st.decode_tick_s) <= st.ticks,
        "one first-token readback per request":
            st.prefill_syncs == 2 * SERVE_OBS,
    }
    if n_moe:
        for k in ("gmm_gated", "gmm_down"):
            gates[f"{k} launches == {n_moe} x ({runs} prefill runs + "
                  f"{steps} tick steps)"] = launches[k] == expected[k]
    if L > n_attn:
        gates[f"ssd launches == {L - n_attn} x {runs} prefill runs"] = \
            launches["ssd"] == expected["ssd"]
    if chunked:
        gates.update({
            f"prefill_tokens + prefill_skipped == 16 x {prompt_len}":
                st.prefill_tokens + st.prefill_skipped
                == 2 * SERVE_OBS * prompt_len,
            f"no tick prefills more than {TOKEN_BUDGET} positions":
                max(st.tick_prefill_tokens) <= TOKEN_BUDGET,
        })
    else:
        gates["decode_syncs == ticks"] = st.decode_syncs == st.ticks
    if eng.paged:
        gates["pages_in_use == 0 at drain"] = st.pages_in_use == 0
        if not chunked:
            pages = prompt_len // PAGE
            gates[f"prefix_hits >= {SERVE_OBS} x {pages}"] = \
                st.prefix_hits >= SERVE_OBS * pages
    return eng, out, launches, gates


def serve_both(cfg, params, obs, name: str, kw, prompt_len: int):
    """One engine of a serving phase in both modes: its tick step replayed
    from a CUDA graph (the main path), then run eagerly (``graphs=False``,
    the oracle). Each run holds ``serve_engine``'s gates; the graphed run's
    streams and launches must equal the eager run's, and a replayed step
    must run the eager step's kernels with at most a couple of host launch
    calls (``graph_step_checks``). Prints the two runs' walls and tick
    percentiles side by side. Returns (graphed engine, its streams, its
    launches, gates, eager engine)."""
    eng, out, launches, gates = serve_engine(cfg, params, obs, name, kw,
                                             prompt_len)
    tick = eng._tick
    graph_step_checks(f"{name} tick step", tick.graph,
                      reset=tick.counter.zero_)
    eager, out_e, launches_e, gates_e = serve_engine(
        cfg, params, obs, name, kw, prompt_len, graphs=False)
    gates.update({f"eager: {k}": ok for k, ok in gates_e.items()})
    gates["graphed streams equal eager streams"] = out == out_e
    gates["graphed launches equal eager launches"] = launches == launches_e
    g, e = eng.stats, eager.stats
    print(f"  {name}, graphed vs eager: decode tick p50/p99 "
          f"{np.percentile(g.decode_tick_s, 50) * 1e3:.2f}/"
          f"{np.percentile(g.decode_tick_s, 99) * 1e3:.2f} vs "
          f"{np.percentile(e.decode_tick_s, 50) * 1e3:.2f}/"
          f"{np.percentile(e.decode_tick_s, 99) * 1e3:.2f} ms; tick p50/p99 "
          f"{np.percentile(g.tick_s, 50) * 1e3:.2f}/"
          f"{np.percentile(g.tick_s, 99) * 1e3:.2f} vs "
          f"{np.percentile(e.tick_s, 50) * 1e3:.2f}/"
          f"{np.percentile(e.tick_s, 99) * 1e3:.2f} ms; decode "
          f"{g.decode_time:.3f} vs {e.decode_time:.3f} s; one capture "
          f"{tick.graph.capture_s * 1e3:.1f} ms")
    return eng, out, launches, gates, eager


def tick_breakdown(eng, label: str):
    """``decode_breakdown`` of an engine's tick step after it drained (8
    slots, every step masked but each a full decode), replayed from its
    graph and run eagerly; the wall by host clock over 4 steps."""
    import torch
    tick = eng._tick
    for mode, step in (("graphed", lambda: tick.graph.step(tick.graph.key)),
                       ("eager", tick.graph.body)):
        def run_steps(n, step=step):
            tick.counter.zero_()
            for _ in range(n):
                step()
        run_steps(2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_steps(4)
        torch.cuda.synchronize()
        decode_breakdown(run_steps, (time.perf_counter() - t0) / 4 * 1e3,
                         label=f"{label} tick step ({mode})")


def moe_serving_full(cfg):
    """Phase 7: full-width granite-moe-3b-a800m (seeded bf16 weights)
    serving the molmoact engines' shape: 16 requests from 8 prompts of 640
    seeded random tokens (each sent twice in a row), 193 tokens each, 8
    slots, max_seq 864, 8-token ticks, f32 caches, pages of 32; through
    MOE_ENGINES. Gates (``serve_engine``), and the paged-f32 streams equal
    the dense ones; the chunked engine's share of tokens equal to the dense
    streams is reported. Then the decode breakdown of 4 decode steps of
    the dense engine's batch. Returns {engine: (launches, stats, masked
    steps)}."""
    import torch
    from repro_torch.models import model as M
    params = full_params(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    obs = [(torch.randint(0, cfg.vocab_size, (MOE_PROMPT,), generator=gen,
                          device="cuda").cpu().numpy().astype(np.int32),
            None) for _ in range(SERVE_OBS)]
    results, streams = {}, {}
    for name, kw in MOE_ENGINES:
        eng, out, launches, gates, eager = serve_both(cfg, params, obs, name,
                                                      kw, MOE_PROMPT)
        failed = [k for k, ok in gates.items() if not ok]
        if failed:
            raise AssertionError(f"full-width MoE serving ({name}): "
                                 f"{failed}")
        streams[name] = out
        results[name] = (launches, eng.stats, eng.masked_steps)
        if name == "moe-dense":
            caches = eng.caches
            tick_breakdown(eng, cfg.name)
        del eng, eager
    if streams["moe-paged-f32"] != streams["moe-dense"]:
        raise AssertionError("full-width MoE serving: moe-paged-f32 streams "
                             "differ from moe-dense streams")
    print("  moe-paged-f32 streams equal moe-dense streams")
    share = stream_share(streams["moe-paged-f32-chunked"],
                         streams["moe-dense"])
    print(f"  moe-paged-f32-chunked vs moe-dense: share of equal tokens "
          f"{share:.4f} (reported, not a gate)")
    # decode steps of the dense engine's batch: 8 slots at position 700
    opts = M.ModelOptions()
    tok = torch.zeros(SERVE_SLOTS, 1, dtype=torch.long, device="cuda")
    idx = torch.full((SERVE_SLOTS,), 700, dtype=torch.int32, device="cuda")

    def run_steps(n):
        for _ in range(n):
            M.decode_step(cfg, opts, params, tok, caches, idx, device="cuda")
    run_steps(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_steps(4)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 4 * 1e3
    print(f"  granite decode step at 8 slots (index 700, dense f32 caches):")
    decode_breakdown(run_steps, wall_ms)
    return results


def prefill_consistency(cfg, params):
    """Phase 5b: chunked against monolithic prefill of one 640-position
    prompt at full width in f32 (f32 copies of the seeded weights, the
    first CMP_LAYERS layers): ``prefill`` from 0 against ``embed_prompt``
    and five 128-row ``prefill_chunk`` calls on a fresh f32 cache. The last
    logits and every cached K/V row must agree within CMP_TOL x max(1,
    |monolithic|). The same comparison in the engines' arithmetic (bf16
    weights, all layers) and ``shape_dependence`` are reported: they show
    where chunked and admit-stall streams part."""
    import torch
    from repro_torch.core.vla import control_step_lengths
    from repro_torch.models.params import leaves
    cut, p32 = first_layers(cfg, params, CMP_LAYERS, torch.float32)
    (tokens, patches), = observations(cfg, cfg.vocab_size, SEED + 5)[:1]
    batch = {"tokens": tokens[None], "patches": patches[None]}
    P = control_step_lengths(cfg, FULL_TEXT)[0]
    (mono, c_mono), (chunked, c_chunk) = both_prefills(cut, p32, batch, P)

    def rel(a, b):
        return ((a.float() - b.float()).abs()
                / b.float().abs().clamp(min=1.0)).max().item()
    err_logits = rel(chunked, mono)
    err_kv = max(rel(a[..., :P, :, :], b[..., :P, :, :])
                 for (_, a), (_, b) in zip(leaves(c_chunk), leaves(c_mono)))
    print(f"  chunked (5 x {CHUNK_SIZE}) vs monolithic prefill, {P} "
          f"positions, {CMP_LAYERS} layers at full width in f32: last "
          f"logits max rel diff {err_logits:.3g}, K/V rows max rel diff "
          f"{err_kv:.3g} (tol {CMP_TOL:g} x max(1, |monolithic|))")
    if not (err_logits <= CMP_TOL and err_kv <= CMP_TOL):
        raise AssertionError("chunked and monolithic prefill disagree")
    del p32, c_mono, c_chunk
    torch.cuda.empty_cache()
    (mono, c_mono), (chunked, c_chunk) = both_prefills(cfg, params, batch, P)
    pairs = [(a[..., :P, :, :], b[..., :P, :, :])
             for (_, a), (_, b) in zip(leaves(c_chunk), leaves(c_mono))]
    print(f"  the same in the engines' arithmetic (bf16 weights, f32 "
          f"caches, {cfg.num_layers} layers): last logits max abs diff "
          f"{(chunked.float() - mono.float()).abs().max().item():.3g}, "
          f"argmax equal {bool(chunked.argmax() == mono.argmax())}, "
          f"{sum(int((a != b).sum()) for a, b in pairs)} of "
          f"{sum(a.numel() for a, _ in pairs)} K/V values differ "
          f"(reported, not a gate)")
    del c_mono, c_chunk
    shape_dependence(cfg, params, P)


def both_prefills(cfg, params, batch, P: int):
    """One prompt of P positions through ``prefill`` from 0 and through
    ``embed_prompt`` and CHUNK_SIZE-row ``prefill_chunk`` calls, each into
    a fresh f32 cache: ((logits, caches) monolithic, (logits, caches)
    chunked)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.layers import band_len
    dev = torch.device("cuda")
    opts = M.ModelOptions()
    mono = M.prefill(cfg, opts, params, batch, SERVE_MAX_SEQ,
                     cache_dtype=torch.float32, device=dev)
    embeds = M.embed_prompt(cfg, opts, params, batch, device=dev)
    caches = M.init_caches(cfg, 1, SERVE_MAX_SEQ, torch.float32, device=dev)
    for s in range(0, P, CHUNK_SIZE):
        logits, _ = M.prefill_chunk(
            cfg, opts, params, embeds[:, s:s + CHUNK_SIZE], caches,
            torch.tensor(s, dtype=torch.int32, device=dev),
            n_valid=torch.tensor(CHUNK_SIZE, dtype=torch.int32, device=dev),
            live_len=band_len(s + CHUNK_SIZE, opts.prefill_band,
                              SERVE_MAX_SEQ), device=dev)
    torch.cuda.synchronize()
    return mono, (logits, caches)


def shape_dependence(cfg, params, P: int):
    """Which of layer 0's row-wise operations give other bits for P rows
    run in one call than for the same rows in CHUNK_SIZE-row calls, in the
    engines' bf16 (seeded random inputs of each operation's width): cuBLAS
    and PyTorch's reduction kernels may sum in another order for another
    shape, which separates chunked from admit-stall streams. Reported, not
    a gate."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models.stacks import layer_slice
    p = layer_slice(params["decoder"]["blocks"], 0)["sub0"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    mats = {n: (p[n].reshape(-1, p[n].shape[-1]) if n == "wo"
                else p[n].reshape(p[n].shape[0], -1))
            for n in ("wq", "wk", "wv", "wo", "wi", "wg", "wo_mlp")}
    ops = {n: (lambda x, w=w: x @ w) for n, w in mats.items()}
    ops["rms_norm"] = lambda x: L.rms_norm(x, p["ln1_w"], cfg.norm_eps)
    width = {n: w.shape[0] for n, w in mats.items()}
    width["rms_norm"] = cfg.d_model
    counts = {}
    for name, op in ops.items():
        x = torch.randn(P, width[name], generator=g,
                        device="cuda").bfloat16()
        whole = op(x)
        parts = torch.cat([op(x[s:s + CHUNK_SIZE])
                           for s in range(0, P, CHUNK_SIZE)])
        counts[name] = int((whole != parts).sum())
    torch.cuda.synchronize()
    print(f"  layer-0 bf16 operations on {P} rows in one call vs in "
          f"{CHUNK_SIZE}-row calls, outputs that differ: {counts} "
          f"(reported, not a gate)")


def redesigned(row, library: str, kernel_fn, library_fn,
               lib_ms: float | None = None) -> None:
    """The line of a redesigned kernel: its time and the library call's
    (same call), launched one by one as the row's and replayed from a CUDA
    graph (device time alone), their ratios, and the kernel's share of
    the bound; without a library call (``library_fn`` None), the kernel's
    times beside its bound. ``lib_ms`` times a yardstick that is not one
    call of the same function (so not the row's ``library_ms``)."""
    ms, lib = row["ms"], row["library_ms"] if lib_ms is None else lib_ms
    g_ms = graph_ms(kernel_fn, 30)
    if library_fn is None:
        print(f"  redesigned {row['name']}: {ms:.4f} ms, bound/ms "
              f"{row['bound_ms'] / ms:.3f}; graph-replayed {g_ms:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms, bound/ms "
              f"{row['bound_ms'] / g_ms:.3f}")
        return
    g_lib = graph_ms(library_fn, 30)
    print(f"  redesigned {row['name']}: {ms:.4f} ms, {library} {lib:.4f} "
          f"ms, ratio {ms / lib:.3f}, bound/ms {row['bound_ms'] / ms:.3f}; "
          f"graph-replayed {g_ms:.4f} ms, {library} {g_lib:.4f} ms, ratio "
          f"{g_ms / g_lib:.3f}, bound/ms {row['bound_ms'] / g_ms:.3f}")


def kernel_timings(inputs, errs, launches, serving):
    """Phase 6: each kernel's time, its plain version's, the library
    yardstick where one PyTorch call computes the same function, and the
    bound, at the main paths' shapes; the paged decode kernel per storage
    type at index 736 of the serving engine's pool, the paged chunk kernel
    per storage type at the chunked engine's last chunk of a prompt (128
    rows from 512, 20 live pages)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.chunk_prefill import ops as cp
    from repro_torch.kernels.chunk_prefill import paged as pcp
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention import paged as pg
    rows, off_path = [], []
    pos = 736                           # mid-way through the decode phase
    live = pos + 1
    serve = {name: res[0] for name, res in serving.items()}

    def serve_launches(kernel, names):
        return sum(serve[n][kernel] for n in names)

    def decode_row(name, key, q, kc, vc, n_launches, iters):
        B, N, h = q.shape
        K = kc.shape[2]
        idx = torch.full((B,), pos, dtype=torch.int32, device=q.device)
        nbytes = 2 * q.numel() * q.element_size() \
            + B * live * K * h * 2 * kc.element_size()
        t_b, by = bound(nbytes, 4 * B * N * h * live, kc.dtype)
        mask = (torch.arange(kc.shape[1], device=q.device) <= pos)[
            None, None, None]
        qs = q[:, :, None].to(kc.dtype)
        caches = [(kc, vc)] + [(kc.clone(), vc.clone())
                               for _ in range(cold_copies(nbytes) - 1)]
        print(f"  {name}: {len(caches)} copies of the cache in turn, "
              f"{len(caches) * nbytes / 2**20:.0f} MB read a round (L2 "
              f"cold)")
        kernel = cycling(lambda k, v: da.decode_attention(q, k, v, idx),
                         caches)
        library = cycling(lambda k, v: F.scaled_dot_product_attention(
            qs, k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            enable_gqa=True), caches)
        row = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/decode_attention/csrc/"
                      "decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/"
                        "decode_attention.py:142",
            "launches": n_launches, "max_abs_err": errs[key],
            "ms": time_ms(kernel, iters),
            "plain_ms": time_ms(lambda: da.decode_attention_ref(
                q, kc, vc, idx), 20),
            "bound_ms": t_b, "bound_by": by,
            "library_ms": time_ms(library, iters)}
        redesigned(row, "SDPA", kernel, library)
        return row

    def chunk_row(name, key, qc, kv, vv, n_launches, source,
                  redesign=False, cold=False):
        B, S, N, h = qc.shape
        L, K = kv.shape[1], kv.shape[2]
        pairs = S * (S + 1) // 2        # causal (row, key) pairs from 0
        nbytes = 2 * qc.numel() * qc.element_size() \
            + B * L * K * h * 2 * kv.element_size()
        ops = 4 * B * N * h * pairs
        t_b, by = bound(nbytes, ops, kv.dtype)
        zero = torch.zeros(B, dtype=torch.int32, device=qc.device)
        # the view cold in the L2 (each call reads its own copy, as each
        # layer reads its own cache on the main path)
        copies = [(qc, kv, vv)] + [
            (qc.clone(), kv.clone(), vv.clone())
            for _ in range((cold_copies(nbytes) if cold else 1) - 1)]
        if cold:
            tf32_ms = max(nbytes / HBM_BYTES_PER_S,
                          3 * ops / TF32_OPS_PER_S) * 1e3
            print(f"  {name}: {len(copies)} copies of q and the view in "
                  f"turn, {len(copies) * nbytes / 2**20:.0f} MB read a "
                  f"round (L2 cold); 3xTF32 bound {tf32_ms:.4f} ms")
        kernel = cycling(lambda q, k, v: cp.chunk_prefill_attention(
            q, k, v, zero), copies)
        library = cycling(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True),
            [(q.transpose(1, 2).to(k.dtype), k.transpose(1, 2),
              v.transpose(1, 2)) for q, k, v in copies])
        row = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/chunk_prefill/csrc/" + source,
            "replaces": "src/repro/kernels/chunk_prefill/chunk_prefill.py"
                        ":152",
            "launches": n_launches, "max_abs_err": errs[key],
            "ms": time_ms(kernel, 20),
            "plain_ms": time_ms(lambda: cp.chunk_prefill_ref(
                qc, kv, vv, zero), 5),
            "bound_ms": t_b, "bound_by": by,
            "library_ms": time_ms(library, 20)}
        if redesign:
            redesigned(row, "SDPA", kernel, library)
        return row

    dense_engines = [n for n, kw in SERVE_ENGINES + CHUNKED_ENGINES
                     if not kw.get("paged")]
    rows.append(decode_row("decode_attention", "decode_attention",
                           *inputs["decode"],
                           launches["decode_attention"], 200))
    rows.append(decode_row("decode_attention/f32_kv", "decode_attention_f32",
                           *inputs["decode_f32"],
                           serve_launches("decode_attention", dense_engines),
                           100))
    rows.append(chunk_row("chunk_prefill", "chunk_prefill",
                          *inputs["chunk"], launches["chunk_prefill"],
                          "chunk_mma.cuh", redesign=True))
    rows.append(chunk_row("chunk_prefill/f32_kv", "chunk_prefill_f32",
                          *inputs["chunk_f32"],
                          serve_launches("chunk_prefill", list(serve)),
                          "chunk_tf32.cuh", redesign=True, cold=True))

    q, pools = inputs["paged"]
    B, N, h = q.shape
    idx = torch.full((B,), pos, dtype=torch.int32, device=q.device)
    engine_of = {"f32": ["paged-f32", "paged-f32-chunked"], "bf16": [],
                 "int8-head": ["paged-int8-head", "paged-int8-head-chunked"],
                 "int8-token": ["paged-int8-token"],
                 "fp8-head": ["paged-fp8-head"],
                 "fp8-token": ["paged-fp8-token", "paged-fp8-token-chunked"]}
    # the file that instantiates each storage type's kernel (the template
    # itself is paged_kernel.cuh)
    PAGED_SOURCE = {"f32": "paged_decode_attention.cu",
                    "bf16": "paged_decode_attention.cu",
                    "int8": "paged_decode_int8.cu",
                    "fp8": "paged_decode_fp8.cu"}
    for name, _, store in PAGED_VARIANTS:
        kp, vp, ks, vs, table = pools[name]
        K = kp.shape[2]
        pt = live_table(table, idx)
        n_pages = -(-live // PAGE)
        nbytes = (2 * q.numel() * q.element_size()
                  + B * live * K * h * 2 * kp.element_size()
                  + B * n_pages * 4)                          # table entries
        if ks is not None:  # scales: one per (page, head), or per row
            nbytes += B * 2 * 4 * (n_pages * K if ks.dim() == 2
                                   else live * K)
        t_b, by = bound(nbytes, 4 * B * N * h * live, kp.dtype)

        def plain(kp=kp, vp=vp, ks=ks, vs=vs, pt=pt):
            if ks is None:
                return pg.paged_decode_attention_ref(q, kp, vp, pt, idx)
            return pg.paged_decode_attention_quant_ref(q, kp, vp, ks, vs, pt,
                                                       idx)

        def clone(t):
            return None if t is None else t.clone()
        pool_copies = [(kp, vp, ks, vs)] + [
            (kp.clone(), vp.clone(), clone(ks), clone(vs))
            for _ in range(cold_copies(nbytes) - 1)]
        print(f"  paged_decode_attention/{name}: {len(pool_copies)} copies "
              f"of the pool in turn, {len(pool_copies) * nbytes / 2**20:.0f}"
              f" MB read a round (L2 cold)")
        kernel = cycling(lambda kp, vp, ks, vs, pt=pt:
                         pg.paged_decode_attention(q, kp, vp, pt, idx,
                                                   k_scales=ks, v_scales=vs),
                         pool_copies)
        row = {
            "name": f"paged_decode_attention/{name}", "route": "cuda",
            "source": "src/repro_torch/kernels/decode_attention/csrc/"
                      + PAGED_SOURCE[name.split("-")[0]],
            "replaces": "src/repro/kernels/decode_attention/paged.py:136",
            "launches": serve_launches("paged_decode_attention",
                                       engine_of[name]),
            "max_abs_err": errs[f"paged_decode_attention/{name}"],
            "ms": time_ms(kernel, 100),
            "plain_ms": time_ms(plain, 20),
            "bound_ms": t_b, "bound_by": by,
            "library_ms": None}
        redesigned(row, None, kernel, None)
        # bf16 pages run on no main path (the engine's pools are f32 or
        # codes): timed and printed, but kept out of the kernels line
        (rows if engine_of[name] else off_path).append(row)

    qc, cpools = inputs["paged_chunk"]
    B, S, N, h = qc.shape
    start = 512                         # the last chunk of a 640 prompt
    # on the device, so that a call can be captured in a CUDA graph
    start_t = torch.full((B,), start, dtype=torch.int32, device=qc.device)
    live = start + S
    pairs = S * start + S * (S + 1) // 2       # causal (row, key) pairs
    chunk_engine_of = {"f32": ["paged-f32-chunked"],
                       "int8-head": ["paged-int8-head-chunked"],
                       "fp8-token": ["paged-fp8-token-chunked"]}
    CHUNK_SOURCE = {"f32": "paged_chunk_prefill.cu",
                    "bf16": "paged_chunk_prefill.cu",
                    "int8": "paged_chunk_int8.cu",
                    "fp8": "paged_chunk_fp8.cu"}
    for name, _, store in PAGED_VARIANTS:
        kp, vp, ks, vs, table = cpools[name]
        K = kp.shape[2]
        pt = band_table(table[:1], live)
        n_pages = pt.shape[1]
        nbytes = (2 * qc.numel() * qc.element_size()
                  + B * live * K * h * 2 * kp.element_size()
                  + B * n_pages * 4)                          # table entries
        if ks is not None:  # scales: one per (page, head), or per row
            nbytes += B * 2 * 4 * (n_pages * K if ks.dim() == 2
                                   else live * K)
        ops = 4 * B * N * h * pairs
        t_b, by = bound(nbytes, ops, kp.dtype)
        names = chunk_engine_of.get(name, [])
        pool_copies = [(kp, vp, ks, vs)]
        if names:           # the main-path rows: each call's pool L2-cold
            pool_copies += [(kp.clone(), vp.clone(), clone(ks), clone(vs))
                            for _ in range(cold_copies(nbytes) - 1)]
            tf32_ms = max(nbytes / HBM_BYTES_PER_S,
                          3 * ops / TF32_OPS_PER_S) * 1e3
            print(f"  paged_chunk_prefill/{name}: {len(pool_copies)} copies "
                  f"of the pool in turn (L2 cold); 3xTF32 bound "
                  f"{tf32_ms:.4f} ms")
        kernel = cycling(lambda kp, vp, ks, vs, pt=pt:
                         pcp.paged_chunk_prefill_attention(
                             qc, kp, vp, pt, start_t, k_scales=ks,
                             v_scales=vs), pool_copies)
        row = {
            "name": f"paged_chunk_prefill/{name}", "route": "cuda",
            "source": "src/repro_torch/kernels/chunk_prefill/csrc/"
                      + CHUNK_SOURCE[name.split("-")[0]],
            "replaces": "src/repro/kernels/chunk_prefill/paged.py:135",
            "launches": serve_launches("paged_chunk_prefill", names),
            "max_abs_err": errs[f"paged_chunk_prefill/{name}"],
            "ms": time_ms(kernel, 50),
            "plain_ms": time_ms(lambda kp=kp, vp=vp, ks=ks, vs=vs, pt=pt:
                                pcp.paged_chunk_prefill_ref(
                                    qc, kp, vp, pt, start, ks, vs), 10),
            "bound_ms": t_b, "bound_by": by,
            "library_ms": None}
        if names:
            redesigned(row, None, kernel, None)
        # storage types no chunked engine of phase 5 runs: timed and
        # printed, but kept out of the kernels line
        (rows if names else off_path).append(row)
    for r in rows + off_path:
        lib = ("-" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"  {r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, library {lib}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), launches {r['launches']}"
              + ("" if r in rows else " (on no main path)"))
    return rows


def verify_timings(cfg, inputs, errs, spec):
    """Phase 6, rows 3 and 4 at the speculative verify shape (B = 8 slots,
    S = VERIFY_TIMED_S rows a slot from VERIFY_STARTS, molmoact's heads,
    the engines' whole 864-position view or 27-page table, bf16 q): the
    dense kernel over the f32 view, the paged one over f32 and int8-token
    pages, launched one by one and replayed from a CUDA graph, each call's
    inputs cold in the L2; the plain version's time; the bound from the
    shapes (each slot's keys up to its last row read once, q read and the
    output written once; the causal pairs' operations at the f32 rate, as
    the other f32 rows); SDPA with a boolean mask over the dense view as
    the library time. Launches are phase 5c's verify chunks (its
    admission prefills left out); int8-token pages run on no engine of
    phase 5c, so that row is printed and kept out of the kernels line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.chunk_prefill import ops as cp
    from repro_torch.kernels.chunk_prefill import paged as pcp
    q, (kf, vf), pools = inputs["q"], inputs["f32"], inputs["pools"]
    starts = inputs["starts"]
    B, S, N, h = q.shape
    L, K = kf.shape[1], kf.shape[2]
    first = torch.tensor(VERIFY_STARTS)
    pos = (first[:, None] + torch.arange(S)).clamp(max=L - 1)   # [B, S]
    keys = int((first + S).clamp(max=L).sum())     # rows each slot reads
    pairs = int((pos + 1).sum())                   # causal (row, key) pairs
    ops = 4 * N * h * pairs
    q_bytes = 2 * q.numel() * q.element_size()
    n_attn = SERVE_LAYERS
    dense_v = spec["spec-dense"][0]["chunk_prefill"] \
        - 2 * SERVE_OBS * n_attn
    paged_v = spec["spec-paged-f32"][0]["paged_chunk_prefill"]
    rows, off_path = [], []

    def clone(t):
        return None if t is None else t.clone()

    # the dense f32 view, against SDPA with the same causal mask
    nbytes = q_bytes + keys * K * h * 2 * kf.element_size()
    t_b, by = bound(nbytes, ops, kf.dtype)
    copies = [(kf, vf)] + [(kf.clone(), vf.clone())
                           for _ in range(cold_copies(nbytes) - 1)]
    qpos = starts.long()[:, None] + torch.arange(S, device=q.device)
    mask = (torch.arange(L, device=q.device)[None, None]
            <= qpos[..., None])[:, None]                     # [B,1,S,L]
    qs = q.transpose(1, 2).float()
    kernel = cycling(lambda k, v: cp.chunk_prefill_attention(q, k, v,
                                                             starts), copies)
    library = cycling(lambda k, v: F.scaled_dot_product_attention(
        qs, k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
        enable_gqa=True), copies)
    print(f"  verify chunk (B={B}, S={S}, starts {list(VERIFY_STARTS)}): "
          f"{len(copies)} copies of the f32 view in turn (L2 cold)")
    row = {"name": "chunk_prefill/verify_f32_kv", "route": "cuda",
           "source": "src/repro_torch/kernels/chunk_prefill/csrc/"
                     "chunk_tf32.cuh",
           "replaces": "src/repro/kernels/chunk_prefill/chunk_prefill.py:152",
           "launches": dense_v,
           "max_abs_err": errs["chunk_prefill_f32/verify"],
           "ms": time_ms(kernel, 50),
           "plain_ms": time_ms(lambda: cp.chunk_prefill_ref(q, kf, vf,
                                                            starts), 5),
           "bound_ms": t_b, "bound_by": by, "library_ms": time_ms(library, 50)}
    redesigned(row, "SDPA", kernel, library)
    rows.append(row)
    for name, launches in (("f32", paged_v), ("int8-token", 0)):
        kp, vp, ks, vs, table = pools[name]
        nbytes = (q_bytes + keys * K * h * 2 * kp.element_size()
                  + B * table.shape[1] * 4)                   # table entries
        if ks is not None:
            nbytes += keys * K * 2 * 4                        # a row's scales
        t_b, by = bound(nbytes, ops, kp.dtype)
        copies = [(kp, vp, ks, vs)] + [
            (kp.clone(), vp.clone(), clone(ks), clone(vs))
            for _ in range(cold_copies(nbytes) - 1)]
        kernel = cycling(lambda kp, vp, ks, vs, table=table:
                         pcp.paged_chunk_prefill_attention(
                             q, kp, vp, table, starts, k_scales=ks,
                             v_scales=vs), copies)
        row = {"name": f"paged_chunk_prefill/verify_{name}", "route": "cuda",
               "source": "src/repro_torch/kernels/chunk_prefill/csrc/"
                         + ("paged_chunk_prefill.cu" if name == "f32"
                            else "paged_chunk_int8.cu"),
               "replaces": "src/repro/kernels/chunk_prefill/paged.py:135",
               "launches": launches,
               "max_abs_err": errs[f"paged_chunk_prefill/{name}/verify"],
               "ms": time_ms(kernel, 50),
               "plain_ms": time_ms(lambda kp=kp, vp=vp, ks=ks, vs=vs,
                                   table=table: pcp.paged_chunk_prefill_ref(
                                       q, kp, vp, table, starts, ks, vs), 5),
               "bound_ms": t_b, "bound_by": by, "library_ms": None}
        redesigned(row, None, kernel, None)
        (rows if launches else off_path).append(row)
    for r in rows + off_path:
        lib = ("-" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"  {r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, library {lib}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), launches {r['launches']}, launches x "
              f"(ms - bound) {r['launches'] * (r['ms'] - r['bound_ms']):.1f}"
              f" ms" + ("" if r in rows else " (on no main path)"))
    return rows


def moe_timings(cfg, errs, serving):
    """Phase 6b: gmm_gated and gmm_down at each served capacity in bf16
    (ms per launch, plain version, bound, launches on the main path at
    that capacity: decode steps at 8 slots C=2, 128-row chunk runs C=32,
    640-row admission prefills C=160), both on the tensor cores, with a
    ``redesigned`` line each (one by one and graph-replayed). Each timed
    call reads the next of three weight sets (378 MB of gmm_gated weights
    in all, past the 50 MB L2), as each layer of the model reads its own.
    gmm_down's library yardstick is torch.bmm(h, wo); gmm_gated has none
    (its two bmm products, without the activation, are its line's
    yardstick, not one call). Returns the kernels-line rows."""
    import torch
    from repro_torch.kernels.moe_gmm import ops as gmm
    L = cfg.num_layers
    by_c = dict.fromkeys(MOE_C, 0)
    for name, (launches, st, masked) in serving.items():
        by_c[2] += L * (st.device_steps + masked)
        if "chunked" in name:
            by_c[32] += L * (st.prefill_key_lanes_full
                             // (CHUNK_SIZE * SERVE_MAX_SEQ))
        else:
            by_c[160] += L * 2 * SERVE_OBS
    for k in ("gmm_gated", "gmm_down"):
        total = sum(res[0][k] for res in serving.values())
        if total != sum(by_c.values()):
            raise AssertionError(f"{k}: {total} launches on the MoE path, "
                                 f"{by_c} by capacity")
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    sets = [moe_experts(g, cfg, 1, torch.bfloat16)[1:] for _ in range(3)]
    src = "src/repro_torch/kernels/moe_gmm/csrc/gmm_gated_tc.cu"
    src_down = "src/repro_torch/kernels/moe_gmm/csrc/gmm_down_tc.cu"
    E, D, F = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    rows = []

    def cycled(fn, args, iters):
        """ms per call of fn(*a), a taking each of ``args`` in turn."""
        return time_ms(cycling(fn, args), iters)
    for C in MOE_C:
        x = moe_experts(g, cfg, C, torch.bfloat16)[0]
        b = x.element_size()
        gated = [(x, wi, wg) for wi, wg, _ in sets]
        down = [(gmm.gmm_gated(x, wi, wg), wo) for wi, wg, wo in sets]
        t_b, by = bound((E * C * D + 2 * E * D * F + E * C * F) * b,
                        4 * E * C * D * F, x.dtype)
        rows.append({
            "name": f"gmm_gated/C={C}", "route": "cuda", "source": src,
            "replaces": "src/repro/kernels/moe_gmm/moe_gmm.py:84",
            "launches": by_c[C], "max_abs_err": errs["gmm_gated", C],
            "ms": cycled(gmm.gmm_gated, gated, 60),
            "plain_ms": cycled(gmm.gmm_gated_ref, gated, 12),
            "bound_ms": t_b, "bound_by": by, "library_ms": None})
        two_bmm_fn = cycling(lambda x, wi, wg: (torch.bmm(x, wi),
                                                torch.bmm(x, wg)), gated)
        two_bmm = time_ms(two_bmm_fn, 60)
        redesigned(rows[-1], "two torch.bmm (no activation, not one call)",
                   cycling(gmm.gmm_gated, gated), two_bmm_fn, lib_ms=two_bmm)
        t_b, by = bound((E * C * F + E * F * D + E * C * D) * b,
                        2 * E * C * F * D, x.dtype)
        rows.append({
            "name": f"gmm_down/C={C}", "route": "cuda", "source": src_down,
            "replaces": "src/repro/kernels/moe_gmm/moe_gmm.py:108",
            "launches": by_c[C], "max_abs_err": errs["gmm_down", C],
            "ms": cycled(gmm.gmm_down, down, 60),
            "plain_ms": cycled(gmm.gmm_down_ref, down, 12),
            "bound_ms": t_b, "bound_by": by,
            "library_ms": cycled(torch.bmm, down, 60)})
        redesigned(rows[-1], "torch.bmm", cycling(gmm.gmm_down, down),
                   cycling(torch.bmm, down))
    return rows


def ssd_inputs(g, cfg, B: int, S: int, dtype):
    """Seeded SSD operands at ``cfg``'s Mamba2 width: x, B, C in
    ``dtype``; dt = softplus(normal) and A_log in [0, 1.5) in f32 (the
    reference kernel tests' distributions)."""
    import torch
    from repro_torch.models.layers import mamba_dims
    _, H, P, N, _, _ = mamba_dims(cfg)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale
    return (rnd(B, S, H, P).to(dtype),
            torch.nn.functional.softplus(rnd(B, S, H)),
            1.5 * torch.rand(H, generator=g, device="cuda"),
            rnd(B, S, 1, N, scale=0.3).to(dtype),
            rnd(B, S, 1, N, scale=0.3).to(dtype))


def ssd_kernel_checks(cfg):
    """Phase 2c: the SSD kernel against its plain version at mamba2-780m's
    width (and the reduced one), for SSD_CASES: y within KERNEL_TOL x
    max(1, |plain|) in bf16 and TF32X3_TOL in f32; the final state (f32)
    within TF32X3_TOL, and the chunk states and seg its first pass leaves
    in the scratch against ``ssd_chunk_states`` likewise; the same bits on
    two calls. Returns the first case's inputs (the admission prefill's
    shape, for the timing) and the largest error by case."""
    import torch
    from repro_torch.kernels.ssd import ops as ssd
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    errs, first = {}, None
    for B, S, dtype, width in SSD_CASES:
        args = ssd_inputs(g, cfg if width == "full" else cfg.reduced(), B, S,
                          getattr(torch, dtype))
        N = args[3].shape[-1]
        y, st, scratch = ssd._launch(*args, 128)
        y2, st2, scratch2 = ssd._launch(*args, 128)
        states, segs = ssd.scratch_states(scratch, args[0], N)
        states2, segs2 = ssd.scratch_states(scratch2, args[0], N)
        yp, sp = ssd.ssd_chunked(*args)
        ps, pseg = ssd.ssd_chunk_states(*args[:4])
        case = f"{dtype} B={B} S={S}" + ("" if width == "full"
                                         else " reduced")
        y_tol = KERNEL_TOL if dtype == "bfloat16" else TF32X3_TOL
        errs[B, S, dtype, width] = max(
            check(f"ssd y, {case}", y, yp, y_tol),
            check(f"ssd final state, {case}", st, sp, TF32X3_TOL),
            check(f"ssd chunk states (scratch), {case}", states, ps,
                  TF32X3_TOL, quiet=True),
            check(f"ssd chunk seg (scratch), {case}", segs, pseg,
                  TF32X3_TOL, quiet=True))
        same = all(torch.equal(a, b) for a, b in (
            (y, y2), (st, st2), (states, states2), (segs, segs2)))
        if not same:
            raise AssertionError(f"ssd, {case}: two calls differ")
        first = first or args
    print(f"  ssd: the scratch's chunk states and seg within {TF32X3_TOL:g} "
          f"of ssd_chunk_states, and the same bits on two calls, in every "
          f"case")
    return first, errs


def ssm_card_vs_cpu(names):
    """Phase 3c: reduced mamba2-780m and reduced jamba in f32 on the card
    (the SSD kernel; jamba's attention and grouped-expert kernels) and on
    the CPU (plain versions): prefill logits (f32 caches) within
    CPU_LOGIT_TOL with one SSD launch per Mamba layer, ``decode_loop``
    streams equal (B=2, 8 steps), and the admit-stall dense and paged f32
    engines' greedy streams equal (5 requests with mixed budgets on 3
    slots, one of them a one-token prompt)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ops as ssd
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves, set_leaf
    opts = M.ModelOptions()
    for name in names:
        cfg = get_config(name).reduced()
        p_cpu = M.init_params(cfg, torch.Generator().manual_seed(SEED),
                              torch.float32, device="cpu")
        p_gpu = {}
        for path, t in leaves(p_cpu):
            set_leaf(p_gpu, path, t.cuda())
        rng = np.random.default_rng(SEED + 13)
        tokens = rng.integers(0, cfg.vocab_size, (2, 12))
        n_ssm = sum(not cfg.is_attn_layer(i) for i in range(cfg.num_layers))
        launches = ssd.ssd.launches
        lg, cg = M.prefill(cfg, opts, p_gpu, {"tokens": tokens}, 32,
                           cache_dtype=torch.float32, device="cuda")
        if ssd.ssd.launches - launches != n_ssm:
            raise AssertionError(f"reduced {name} prefill did not run the "
                                 f"SSD kernel once a Mamba layer")
        lc, cc = M.prefill(cfg, opts, p_cpu, {"tokens": tokens}, 32,
                           cache_dtype=torch.float32, device="cpu")
        check(f"reduced {name} prefill logits (f32 caches), card vs CPU",
              lg.cpu(), lc, CPU_LOGIT_TOL)
        tok = lc[:, -1].argmax(-1, keepdim=True)
        sg = M.decode_loop(cfg, opts, p_gpu, tok.cuda(), cg, 12, 8,
                           device="cuda")[0].cpu()
        sc = M.decode_loop(cfg, opts, p_cpu, tok, cc, 12, 8,
                           device="cpu")[0]
        if not torch.equal(sg, sc):
            raise AssertionError(f"reduced {name} decode_loop: card "
                                 f"{sg.tolist()} vs CPU {sc.tolist()}")
        print(f"  reduced {name} decode_loop: 2 x 8 tokens equal on card "
              f"and CPU")
        reqs = [(rng.integers(0, cfg.vocab_size, n, dtype=np.int32), m,
                 None)
                for n, m in ((6, 9), (9, 4), (1, 14), (7, 6), (5, 11))]
        tag = name.split("-")[0]
        engines_card_vs_cpu(cfg, p_cpu, p_gpu,
                            [(f"{tag}-dense", {}, reqs, 64),
                             (f"{tag}-paged-f32", dict(paged=True), reqs,
                              64)], n_slots=3)


def replayed_plan(cfg, obs, engines):
    """The admit-stall engines' host plan, replayed on the CPU: the
    reduced model gets prompts of the same lengths (each sent twice, as
    ``obs``), slots, pool and ticks, so it runs the same ticks, steps,
    prefix hits and pages; returns {engine name: counts}."""
    import torch
    from repro_torch.models import model as M
    small = cfg.reduced()
    params = M.init_params(small, torch.Generator().manual_seed(SEED),
                           torch.float32, device="cpu")
    rng = np.random.default_rng(SEED + 14)
    sobs = [(rng.integers(0, small.vocab_size, len(p), dtype=np.int32), px)
            for p, px in obs]
    plans = {}
    for name, kw in engines:
        t0 = time.perf_counter()
        eng, out, _ = run_engine(small, params, sobs, kw, "cpu")
        if len(out) != 2 * SERVE_OBS:
            raise AssertionError(f"host plan ({name}): {len(out)} requests "
                                 f"finished")
        c = plans[name] = plan_counts(eng)
        print(f"  host plan ({name}, replayed on the CPU in "
              f"{time.perf_counter() - t0:.1f} s): ticks {c['ticks']}, "
              f"device steps {c['device_steps']}, masked steps "
              f"{c['masked_steps']}, prefix_hits {c['prefix_hits']}, "
              f"pages_hwm {c['pages_hwm']}")
    return plans


def ssm_serving_full(cfg):
    """Phase 8: full-width mamba2-780m (seeded bf16 weights, f32 caches)
    serving the granite engines' shape: 16 requests from 8 prompts of 640
    seeded random tokens (each sent twice in a row), 193 tokens each, 8
    slots, max_seq 864, 8-token ticks; through SSM_ENGINES (admit-stall
    dense and paged f32). Gates (``serve_engine``: 48 SSD launches per
    admission and no other kernel), the host plan counts equal to their
    CPU replay's, and the paged streams equal the dense ones. Then the
    decode breakdown of 4 decode steps of the dense engine's batch.
    Returns {engine: (launches, stats, masked steps)}."""
    import torch
    from repro_torch.models import model as M
    params = full_params(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    obs = [(torch.randint(0, cfg.vocab_size, (MOE_PROMPT,), generator=gen,
                          device="cuda").cpu().numpy().astype(np.int32),
            None) for _ in range(SERVE_OBS)]
    plans = replayed_plan(cfg, obs, SSM_ENGINES)
    results, streams = {}, {}
    for name, kw in SSM_ENGINES:
        eng, out, launches, gates, eager = serve_both(cfg, params, obs, name,
                                                      kw, MOE_PROMPT)
        gates["host plan counts equal the CPU replay's"] = \
            plan_counts(eng) == plans[name] == plan_counts(eager)
        failed = [k for k, ok in gates.items() if not ok]
        if failed:
            raise AssertionError(f"full-width SSM serving ({name}): "
                                 f"{failed}")
        streams[name] = out
        results[name] = (launches, eng.stats, eng.masked_steps)
        if name == "ssm-dense":
            caches = eng.caches
            tick_breakdown(eng, cfg.name)
        del eng, eager
    if streams["ssm-paged-f32"] != streams["ssm-dense"]:
        raise AssertionError("full-width SSM serving: ssm-paged-f32 streams "
                             "differ from ssm-dense streams")
    print("  ssm-paged-f32 streams equal ssm-dense streams")
    opts = M.ModelOptions()
    tok = torch.zeros(SERVE_SLOTS, 1, dtype=torch.long, device="cuda")
    idx = torch.full((SERVE_SLOTS,), 700, dtype=torch.int32, device="cuda")

    def run_steps(n):
        for _ in range(n):
            M.decode_step(cfg, opts, params, tok, caches, idx, device="cuda")
    run_steps(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_steps(4)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 4 * 1e3
    print(f"  mamba2 decode step at 8 slots (f32 states):")
    decode_breakdown(run_steps, wall_ms)
    return results


def ssd_timings(inputs, errs, serving):
    """Phase 6c: the SSD kernel at the admission prefill's shape (B=1,
    S=640, bf16, mamba2-780m's width): ms per call (two kernels), its plain
    version's, the bound, and its calls on the main path (phase 8, every
    one at this shape); then graph-replayed with the inputs cycled cold in
    the L2. Bytes: x and y, dt, A_log, B and C, the f32 state, each once;
    operations: per (head, chunk) C B^T, the intra-chunk product, the
    inter-chunk term and the state update over whole Q x Q tiles, as the
    TPU kernel computes them, at the input type's peak. No single PyTorch
    call computes the chunked scan (library_ms null)."""
    from repro_torch.kernels.ssd import ops as ssd
    x, dt, A_log, B_, C_ = inputs
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    Q = ssd.chunk_len(S, 128)
    b = x.element_size()
    nbytes = (2 * x.numel() * b + 4 * (dt.numel() + A_log.numel())
              + 2 * B_.numel() * b + 4 * Bsz * H * P * N)
    ops = Bsz * H * (S // Q) * (2 * Q * Q * N + 2 * Q * Q * P
                                + 4 * Q * P * N)
    t_b, by = bound(nbytes, ops, x.dtype)
    row = {
        "name": f"ssd/S={S}", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/ssd.py:84",
        "launches": sum(res[0]["ssd"] for res in serving.values()),
        "max_abs_err": errs[SSD_CASES[0]],
        "ms": time_ms(lambda: ssd.ssd(*inputs), 50),
        "plain_ms": time_ms(lambda: ssd.ssd_chunked(*inputs), 10),
        "bound_ms": t_b, "bound_by": by, "library_ms": None}
    copies = [inputs] + [tuple(t.clone() for t in inputs)
                         for _ in range(cold_copies(nbytes) - 1)]
    redesigned(row, None, cycling(ssd.ssd, copies), None)
    return [row]


def flash_checks():
    """Phase 2d: the flash-attention kernel against its plain version
    (``attention_ref`` on the same inputs taken to f32: the function the
    kernel computes, as the TPU kernel does, from inputs of either type)
    for FLASH_CASES, the output and its log-sum-exp [B,N,S] within
    TF32X3_TOL x max(1, |plain|) in f32 (the 3xTF32 body) and KERNEL_TOL
    in bf16 (the bf16 body rounds P to bf16);
    ``FlashAttention``'s backward against autograd through the plain
    version at S=256 in f32 within GRAD_TOL x max(1, |plain|); and the
    refusal of S=320. Returns the smollm-shape inputs by type (for the
    timing) and the largest error by case."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    g = torch.Generator(device="cuda").manual_seed(SEED + 15)

    def qkv(B, S, N, K, h, dtype, Sk=None):
        Sk = Sk or S
        return [torch.randn(shape, generator=g, device="cuda").to(dtype)
                for shape in ((B, S, N, h), (B, Sk, K, h), (B, Sk, K, h))]
    errs, inputs = {}, {}
    for label, B, S, Sk, N, K, h, dtype, window, causal in FLASH_CASES:
        q, k, v = qkv(B, S, N, K, h, getattr(torch, dtype), Sk)
        got = fa.flash_attention(q, k, v, window=window, causal=causal)
        _, lse = fa._launch(q, k, v, window, causal)
        want, want_lse = fa._attention_lse(q.float(), k.float(), v.float(),
                                           window, causal)
        tol = TF32X3_TOL if dtype == "float32" else KERNEL_TOL
        errs[label] = max(
            check(f"flash_attention {label}, q {tuple(q.shape)}", got, want,
                  tol),
            check(f"flash_attention log-sum-exp {label}", lse, want_lse,
                  tol, quiet=True))
        if label.startswith("smollm"):
            inputs[dtype] = (q, k, v)
    print(f"  flash_attention: every log-sum-exp within its case's "
          f"tolerance")
    q, k, v = (t.requires_grad_() for t in qkv(2, 256, 9, 3, 64,
                                               torch.float32))
    dout = torch.randn(q.shape, generator=g, device="cuda")
    got = torch.autograd.grad(fa.flash_attention(q, k, v), (q, k, v), dout)
    want = torch.autograd.grad(fa.attention_ref(q, k, v), (q, k, v), dout)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        check(f"FlashAttention backward {name}, S=256 f32 vs autograd "
              f"through the plain version", a, b, GRAD_TOL)
    q, k, v = qkv(1, 320, 9, 3, 64, torch.float32)
    try:
        fa.flash_attention(q, k, v)
    except ValueError as e:
        print(f"  S=320 refused: {e}")
    else:
        raise AssertionError("flash_attention took S=320 (not whole "
                             "128-row blocks)")
    return inputs, errs


def loss_and_grads(cfg, params, batch, device):
    """lm_loss (the train step's z-loss) and its gradients by leaf."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves, map_tree
    from repro_torch.training import TrainConfig, lm_loss
    live = map_tree(lambda t: t.detach().requires_grad_(True), params)
    loss = lm_loss(cfg, M.ModelOptions(), live, batch, TrainConfig().z_loss,
                   device=device)
    grads = torch.autograd.grad(loss, [t for _, t in leaves(live)])
    return float(loss.detach()), dict(zip([p for p, _ in leaves(live)],
                                          grads))


def train_card_vs_cpu():
    """Phase 3d: reduced smollm-135m (256 tokens) and reduced molmoact-7b
    (8 vision patches + 120 tokens), f32, the same seeded weights and
    batch on the card (the flash kernel, once a layer) and on the CPU
    (plain versions): the loss within 1e-5 relative, gradients within
    1e-5 x max|g| of each leaf, one train step's parameters within
    1e-4 x lr (plus two f32 ulps) where |g| > 1e-2 x max|g| of the leaf
    and within 2 x lr elsewhere (a gradient near AdamW's eps moves its
    parameter by up to about lr); and on the card microbatches=2 against
    microbatches=1 (loss within 1e-4 relative, parameters within 1e-4,
    the reference's own contract)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves, map_tree
    from repro_torch.training import (AdamWConfig, TrainConfig,
                                      init_train_state, make_train_step)
    opts = M.ModelOptions()
    for name, text, vision in ((TRAIN_ARCH, 256, False),
                               ("molmoact-7b", 120, True)):
        cfg = get_config(name).reduced()
        p_cpu = M.init_params(cfg, torch.Generator().manual_seed(SEED),
                              torch.float32, device="cpu")
        p_gpu = map_tree(lambda t: t.cuda(), p_cpu)
        rng = np.random.default_rng(SEED + 16)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, text))}
        if vision:
            batch["patches"] = 0.1 * rng.standard_normal(
                (4, cfg.vision.num_tokens, cfg.vision.embed_dim),
                dtype=np.float32)
        before = fa.flash_attention.launches
        lg, gg = loss_and_grads(cfg, p_gpu, batch, "cuda")
        if fa.flash_attention.launches - before != cfg.num_layers:
            raise AssertionError(f"reduced {name}: the train forward did "
                                 f"not launch the flash kernel once a "
                                 f"layer")
        lc, gc = loss_and_grads(cfg, p_cpu, batch, "cpu")
        if not abs(lg - lc) <= 1e-5 * abs(lc):
            raise AssertionError(f"reduced {name} loss: card {lg} vs CPU "
                                 f"{lc}")
        worst = 0.0
        for path, want in gc.items():
            rel = float((gg[path].cpu() - want).abs().max()
                        / want.abs().max().clamp(min=1e-30))
            worst = max(worst, rel)
            if rel > 1e-5:
                raise AssertionError(f"reduced {name} grad {path}: "
                                     f"{rel} x max|g| apart")
        tcfg = TrainConfig(opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=0))
        new = {}
        for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
            step = make_train_step(cfg, opts, tcfg, device=dev)
            new[dev] = step(p, init_train_state(cfg, tcfg, p), batch)
        if not abs(float(new["cuda"][2]["loss"]) - lc) <= 1e-5 * abs(lc):
            raise AssertionError(f"reduced {name}: train step loss apart")
        worst_p = 0.0
        for (path, a), (_, b) in zip(leaves(new["cuda"][0]),
                                     leaves(new["cpu"][0])):
            g = gc[path].abs()
            d = ((a.cpu() - b).abs()
                 - 2 * torch.finfo(torch.float32).eps * b.abs())
            sure = g > 1e-2 * g.max()
            worst_p = max(worst_p, float(d[sure].max()) if sure.any()
                          else 0.0)
            if (sure.any() and float(d[sure].max()) > 1e-4 * TRAIN_LR) \
                    or float(d.max()) > 2 * TRAIN_LR:
                raise AssertionError(f"reduced {name} updated {path}: "
                                     f"card and CPU apart")
        outs = []
        for mb in (1, 2):
            t = TrainConfig(microbatches=mb, z_loss=0.0)
            step = make_train_step(cfg, opts, t, device="cuda")
            outs.append(step(p_gpu, init_train_state(cfg, t, p_gpu), batch))
        (p1, _, m1), (p2, _, m2) = outs
        mb_d = max(float((a - b).abs().max()) for (_, a), (_, b)
                   in zip(leaves(p1), leaves(p2)))
        if not (abs(float(m1["loss"]) - float(m2["loss"]))
                <= 1e-4 * abs(float(m1["loss"])) and mb_d < 1e-4):
            raise AssertionError(f"reduced {name}: microbatches=2 differs "
                                 f"from microbatches=1 ({mb_d})")
        print(f"  reduced {name}: loss card {lg:.7f} CPU {lc:.7f}; grads "
              f"within {worst:.3g} x max|g|; updated parameters within "
              f"{worst_p / TRAIN_LR:.3g} x lr where |g| > 1e-2 max|g|; "
              f"microbatches 2 vs 1 within {mb_d:.3g}")


def train_full():
    """Phase 9: the full-width smollm-135m train step (seeded f32 weights,
    B=4 x 2048 tokens from ``lm_batches``, AdamW at lr TRAIN_LR): one
    warm-up and TRAIN_STEPS timed steps on one repeated batch, gated on
    exactly one flash launch a layer a step and no other kernel, a finite
    loss that falls over the 4 steps; then the step's time split
    (forward, backward, optimizer by CUDA events), its device breakdown,
    and a checkpoint round trip: the state saved with the port's ``save``
    and restored into a fresh state, one more step from each, bit-equal.
    Returns the launches of the 4 steps."""
    import tempfile
    import torch
    from repro_torch.checkpoint import restore, save
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves, map_tree, set_leaf
    from repro_torch.training import (AdamWConfig, TrainConfig,
                                      init_train_state, lm_loss,
                                      make_train_step)
    from repro_torch.training.optimizer import adamw_update
    cfg = get_config(TRAIN_ARCH)
    dev = torch.device("cuda")
    opts = M.ModelOptions()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                           torch.float32, device=dev)
    n_params = sum(t.numel() for _, t in leaves(params))
    batch = next(lm_batches(cfg, TRAIN_B, TRAIN_S, seed=SEED, steps=1))
    tcfg = TrainConfig(opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=0))
    step = make_train_step(cfg, opts, tcfg, device=dev)
    state = init_train_state(cfg, tcfg, params)
    print(f"  {TRAIN_ARCH}: {n_params / 1e6:.2f} M parameters in f32, "
          f"batch {TRAIN_B} x {TRAIN_S} tokens")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = reset_launches()
    losses, step_s = [], []
    for _ in range(1 + TRAIN_STEPS):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = read_launches(kernels)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = dict.fromkeys(launches, 0)
    want["flash_attention"] = cfg.num_layers * (1 + TRAIN_STEPS)
    print(f"  launches in {1 + TRAIN_STEPS} steps: {launches} (expected "
          f"{want})")
    if launches != want:
        raise AssertionError("the train step did not run through the flash "
                             "kernel once a layer a step")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train losses {losses}: not finite or not "
                             f"falling")
    ms = float(np.median(step_s[1:])) * 1e3
    timed = [round(t * 1e3, 1) for t in step_s[1:]]
    print(f"  losses {[round(x, 4) for x in losses]}; warm-up step "
          f"{step_s[0] * 1e3:.1f} ms; steps {timed} ms, median {ms:.1f} ms, "
          f"{TRAIN_B * TRAIN_S / ms * 1e3:.0f} tokens/s; peak memory "
          f"{peak_gb:.2f} GB")

    # the time split of one more step, by CUDA events
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    live = map_tree(lambda t: t.detach().requires_grad_(True), params)
    ev[0].record()
    loss = lm_loss(cfg, opts, live, batch, tcfg.z_loss, device=dev)
    ev[1].record()
    grads = torch.autograd.grad(loss, [t for _, t in leaves(live)])
    ev[2].record()
    tree = {}
    for (path, _), gr in zip(leaves(live), grads):
        set_leaf(tree, path, gr)
    adamw_update(tcfg.opt, tree, state["inner"], params)
    ev[3].record()
    torch.cuda.synchronize()
    split = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    print(f"  step split (ms): forward {split[0]:.2f}, backward "
          f"{split[1]:.2f}, optimizer {split[2]:.2f}")
    del live, loss, grads, tree

    def run_steps(n):
        for _ in range(n):
            step(params, state, batch)
    decode_breakdown(run_steps, ms, steps=1, label="train step")

    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as d:
        t0 = time.perf_counter()
        save(d, 1 + TRAIN_STEPS, {"params": params, "opt": state})
        fresh = {"params": map_tree(torch.zeros_like, params),
                 "opt": init_train_state(cfg, tcfg, params)}
        back = restore(d, 1 + TRAIN_STEPS, fresh)
        ck_s = time.perf_counter() - t0
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        cont = step(params, state, batch)
        resumed = step(back["params"], back["opt"], batch)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    pairs = list(zip(leaves({"p": cont[0], "s": cont[1]}),
                     leaves({"p": resumed[0], "s": resumed[1]})))
    bad = [pa for (pa, a), (_, b) in pairs if not torch.equal(a, b)]
    if bad or float(cont[2]["loss"]) != float(resumed[2]["loss"]):
        raise AssertionError(f"the step from the restored checkpoint "
                             f"differs from the continued one: {bad[:5]}")
    print(f"  checkpoint: saved and restored in {ck_s:.1f} s; the step from "
          f"the restored state is bit-equal to the continued one "
          f"({len(pairs)} leaves and the loss)")
    return launches


def flash_timings(inputs, errs, launches):
    """Phase 6d: the flash kernel at smollm-135m's training shape (B=4,
    S=2048, N=9, K=3, h=64): ms per launch, its plain version's, the
    library yardstick's (scaled_dot_product_attention, causal, GQA, on
    [B,N,S,h] copies made outside the timing; never called by the port),
    and the bound: q, k, v and out once and the f32 log-sum-exp; the
    causal work 4 x B x N x h x S^2 / 2 at the type's peak (f32: the f32
    CUDA cores', the exact function; the 3xTF32 body's own bound is
    printed beside it); then both graph-replayed with the inputs cycled
    cold in the L2. The f32 row is the one on the main path (phase 9's
    launches); the bf16 row is printed and kept out of the kernels
    line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    rows = []
    for dtype, (q, k, v) in inputs.items():
        B, S, N, h = q.shape
        b = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * b + 4 * B * N * S
        ops = 4 * B * N * h * S * S / 2
        t_b, by = bound(nbytes, ops, q.dtype)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        rows.append({
            "name": f"flash_attention/{dtype}", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:79",
            "launches": launches["flash_attention"] if dtype == "float32"
            else 0,
            "max_abs_err": errs["smollm " + ("f32" if dtype == "float32"
                                             else "bf16")],
            "ms": time_ms(lambda: fa.flash_attention(q, k, v), 20),
            "plain_ms": time_ms(lambda: fa.attention_ref(q, k, v), 5),
            "bound_ms": t_b, "bound_by": by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 20)})
        r = rows[-1]
        t_3x = max(nbytes / HBM_BYTES_PER_S, 3 * ops / TF32_OPS_PER_S) * 1e3
        tf32 = (f", 3xTF32 bound {t_3x:.4f} ms" if dtype == "float32"
                else "")
        print(f"  {r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, library {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}){tf32}, launches "
              f"{r['launches']}" + ("" if r['launches'] else
                                    " (on no main path)"))
        copies = [(q, k, v)] + [tuple(t.clone() for t in (q, k, v))
                                for _ in range(cold_copies(nbytes) - 1)]
        redesigned(r, "SDPA", cycling(fa.flash_attention, copies),
                   cycling(lambda q, k, v: F.scaled_dot_product_attention(
                       q, k, v, is_causal=True, enable_gqa=True),
                       [tuple(t.transpose(1, 2).contiguous() for t in c)
                        for c in copies]))
    return [r for r in rows if r["launches"]]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    ptxas = start_ptxas_report()
    print(f"phase 1: kernels built and loaded in {_build.timed_build():.1f} s")
    ptxas_report(ptxas)
    cfg = get_config("molmoact-7b")
    moe_cfg = get_config(MOE_ARCH)
    print("phase 2: kernels vs plain versions")
    inputs, errs = kernel_checks(cfg)
    print(f"phase 2b: grouped-expert kernels vs plain versions, "
          f"{MOE_ARCH} width")
    moe_errs = moe_kernel_checks(moe_cfg)
    ssm_cfg = get_config(SSM_ARCH)
    print(f"phase 2c: SSD kernel vs plain version, {SSM_ARCH} width")
    ssd_inputs_640, ssd_errs = ssd_kernel_checks(ssm_cfg)
    print("phase 2d: flash-attention kernel vs plain version")
    flash_inputs, flash_errs = flash_checks()
    print("phase 3: reduced molmoact-7b, card vs CPU")
    card_vs_cpu(cfg)
    print(f"phase 3b: reduced {MOE_ARCH}, card vs CPU")
    moe_card_vs_cpu(moe_cfg)
    print(f"phase 3c: reduced {SSM_ARCH} and {HYBRID_ARCH}, card vs CPU")
    ssm_card_vs_cpu([SSM_ARCH, HYBRID_ARCH])
    print(f"phase 3d: reduced {TRAIN_ARCH} and molmoact-7b training, card "
          f"vs CPU")
    train_card_vs_cpu()
    params = full_params(cfg)
    print("phase 4: full-width control step")
    launches = full_width(cfg, params)
    print("phase 5: full-width serving engine")
    serving, fused_streams = serving_full(cfg, params)
    prefill_consistency(cfg, params)
    print("phase 5c: full-width self-speculative serving engine")
    spec_serving = spec_serving_full(cfg, params, fused_streams)
    del fused_streams
    del params
    torch.cuda.empty_cache()
    print(f"phase 7: full-width {MOE_ARCH} serving engine")
    moe_serving = moe_serving_full(moe_cfg)
    torch.cuda.empty_cache()
    print(f"phase 8: full-width {SSM_ARCH} serving engine")
    ssm_serving = ssm_serving_full(ssm_cfg)
    torch.cuda.empty_cache()
    print(f"phase 9: full-width {TRAIN_ARCH} train step")
    train_launches = train_full()
    print("phase 6: kernel times")
    rows = kernel_timings(inputs, errs, launches, serving)
    rows += verify_timings(cfg, inputs["verify"], errs, spec_serving)
    rows += moe_timings(moe_cfg, moe_errs, moe_serving)
    rows += ssd_timings(ssd_inputs_640, ssd_errs, ssm_serving)
    for r in rows[-2 * len(MOE_C) - 1:]:
        lib = ("-" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"  {r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, library {lib}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), launches {r['launches']}")
    rows += flash_timings(flash_inputs, flash_errs, train_launches)
    print(card_line())      # again here, beside the numbers it qualifies
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
