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
int8 and fp8 pools; the serving engines on molmoact's first SERVE_LAYERS layers).
The MoE family follows: the grouped-expert kernels
against their plain versions at granite-moe-3b-a800m's width, the reduced
granite engine on card and CPU, and the full-width granite-moe-3b-a800m
(its first MOE_SERVE_LAYERS layers) serving the same 16-request shape through three
engines (admit-stall dense and paged f32, chunked paged f32) with its
decode breakdown. The Mamba2 family last: the SSD scan kernel against
its plain version at mamba2-780m's width, reduced mamba2-780m and the
reduced jamba hybrid on card and CPU, and the full-width mamba2-780m (its
first SSM_SERVE_LAYERS layers) serving the same shape admit-stall (dense and paged
f32) with its decode breakdown. Phase 12 serves molmoact-7b sharded,
model=2, rank 0 and one spawned worker sharing the card over gloo. Every
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
control step on an H100 beside the measured one. The DiT action head:
phase 3e, reduced molmoact-7b-dit on card and CPU; phase 4b, the
full-width molmoact-7b-dit control step, its denoising loop replayed from
one graph and run eagerly, beside phase 4's discrete split. The fleet
rim: phase 5d, the asyncio front end over two reduced replicas (each
captured at the front end's start, then ticked side by side on two
threads) against a synchronous CPU engine, and the serve driver; phase
5e, two full-width replicas replaying a robot-fleet trace in real time
(TTFT, 10 Hz attainment). The reference's other architectures: phase 2e,
the decode kernel as ring decode (gemma3-27b's heads over a ring of its
1024-row window) and as cross decode (whisper-small's 1500 frames), and
the flash kernel at S = W = 1024, against their plain versions; phase
3f, reduced granite-3-2b, internvl2-1b, gemma3-27b (6 layers, ring and
full caches) and whisper-small on card and CPU; phase 10, full-width
granite-3-2b (10 of 40 layers; admit-stall and chunked paged f32 engines),
internvl2-1b (24 + 24 layers; dense engine with 256 patches a request),
gemma3-27b's first 6 layers (model level with ring and full caches, a
1024-token prefill and 256 steps past the wrap; a ring-cache engine) and
whisper-small (12 + 12 layers; B=4 over 1500 frames, 220 steps), each
decode path graph-replayed and eager under phase 5's gates. Training the
MoE and Mamba2 families: phases 2b and 2c hold the gmm pair's backward
(its five products on gmm_down's kernel) and the SSD scan's (the plain
scan again under autograd) to autograd through their plain versions;
phase 3d trains reduced granite-moe-3b-a800m, arctic-480b, mamba2-780m
and jamba on card and CPU with layer remat (launches as predicted from
the layer pattern; remat on = off); phase 9b takes full-width f32 train
steps of mamba2-780m and granite-moe-3b-a800m. The prefill stages as
graphs and the tick that ends on the device: phase 4 runs PHASE_REPEATS
+ 1 control steps through one kept ``PrefillGraph`` (vision + prefill as
one graph) and one kept ``DecodeGraph`` (one capture each; graphed
prefill logits against eager ones, the prefill graph's kernels in
order); the engines capture their tick, vision and chunk graphs first
(``capture``: one vision graph, at most a slot's or the pool's chunk
graphs; the admit-stall prefill runs kernel by kernel), their ticks'
steps and rounds are guarded by a CUDA graph IF node (the replays that
ran are the device steps; a replay with the guard false costs under a
tenth of a live step; a speculative tick reads back once); phase 5d
sends a prompt length first seen mid-run while both replicas tick, and
nothing captures. Prints each
phase's seconds, the card, the phase numbers, one JSON line describing
each kernel and, last, ``{"ok": true, "device": {...}}``. Exits
non-zero, without that line, when there is no CUDA device or any phase
fails.
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

from repro_torch.core.hardware import H100_SXM  # noqa: E402

# the H100 SXM data sheet (``core.hardware.H100_SXM``, one source for the
# card's HBM rate and bf16 peak)
HBM_BYTES_PER_S = H100_SXM.mem_bw_gbs * 1e9
L2_BYTES = 50 * 2 ** 20            # H100 SXM L2 cache
# peak operations per second by input type (dense, no sparsity): bf16
# tensor cores; f32 outside the tensor cores (the exact f32 function);
# int8/fp8 tensor cores
OPS_PER_S = {"bfloat16": H100_SXM.bf16_tflops * 1e12, "float32": 67e12,
             "int8": 1979e12, "float8_e4m3fn": 1979e12}
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
# the eager oracle's control step is host-bound (seconds at full width):
# its split is timed on the first EAGER_REPEATS of them only
EAGER_REPEATS = 1
# full-width serving: 8 slots, 16 requests (8 observations, each sent
# twice), 144 CoT + 48 action tokens + the prefill token per request
SERVE_SLOTS, SERVE_OBS, SERVE_TOKENS = 8, 8, 193
SERVE_MAX_SEQ, SERVE_TICK = 864, 8
# molmoact-7b's serving engines run its first 10 of 28 layers (full
# width; every engine and gate kept), so that the script, with the MoE
# phases, phase 9b's full-width train steps, phase 10 and phase 12, stays
# inside its time limit on a slower host; the control step and the f32
# prefill check keep every layer
SERVE_LAYERS = 10
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
# phase 12: sharded serving, model=2 (rank 0 here and one spawned worker
# sharing the card over gloo), phase 5's requests and layer cut; a
# rank's local heads of molmoact-7b (28 query, 4 KV) at model=2 and 4
MESH_MODEL = 2
LOCAL_HEADS = {2: (14, 2), 4: (7, 1)}
SHARDED_ENGINES = [("paged-f32-chunked", dict(CHUNKED, paged=True)),
                   ("dense", {})]
# the first 17 of the 193 tokens (two 8-step decode ticks a request): the
# sharded tick runs eagerly and each of a step's collectives costs
# milliseconds in gloo on the card's host (phase 12 times them), so a
# step takes ~100 ms and the whole shape would not fit the phase's minute
SHARD_TOKENS = 17
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
# phases 7, 8 and 10 serve their models' first layers only, at full width
# (granite-moe-3b-a800m 8 of 32, mamba2-780m 24 of 48, granite-3-2b 20
# of 40): each engine's eager oracle run is host-bound (granite-moe's
# most, ~8 s a layer), and with phase 12 the script must stay inside its
# limit on a slower host (1,256.4 s at full depth, 1,059.1 s at 16, 24
# and 20 layers, on such a host)
MOE_SERVE_LAYERS, SSM_SERVE_LAYERS, GRANITE_LAYERS = 8, 24, 20
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
# the MoE and Mamba2 families' training. Phases 2b and 2c hold the
# backward of the gmm pair at granite-moe-3b-a800m's width, at a 128-row
# chunk's and a 640-row prefill's capacities and at the full-width train
# step's (B=4 x 2048 tokens, top-8 of 40 experts at capacity factor 1.25:
# C = 2048), and the SSD scan's at mamba2-780m's, S = 640 and 2048
MOE_GRAD_C = (32, 160, 2048)
SSD_GRAD_S = (640, 2048)
# phase 3d: the reduced families trained card vs CPU (B=4 x 128 tokens)
TRAIN_FAMILIES = ("granite-moe-3b-a800m", "arctic-480b", "mamba2-780m",
                  "jamba-1.5-large-398b")
# phase 9b: full-width f32 train steps with layer remat, B=4 x 2048 tokens
# unless the reckoned memory passes TRAIN_MEMORY_GB (then B=2)
TRAIN_FULL = ("mamba2-780m", "granite-moe-3b-a800m")
TRAIN_MEMORY_GB = 75
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
    """Phase 4: the full-width molmoact-7b control step, B=4: vision and
    prefill one replay of a kept ``M.PrefillGraph``, the decode replayed
    from a kept ``M.DecodeGraph`` (the main path), against both run
    eagerly (the oracle): the same tokens, graphed prefill logits within
    KERNEL_TOL of eager ones (bit-equality reported), the same kernels a
    decode step and a prefill (by name, in order), PHASE_REPEATS + 1
    control steps through the two kept graphs with one capture each, and
    both modes timed phase by phase."""
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

    batch = {"tokens": tokens, "patches": patches}
    graphs = {"graphed": M.DecodeGraph(dev),
              "eager": M.DecodeGraph(dev, eager=True)}
    prefills = {"graphed": M.PrefillGraph(dev),
                "eager": M.PrefillGraph(dev, eager=True)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = reset_launches()
    t0 = time.perf_counter()
    out = vla.vla_control_step(cfg, opts, params, batch, device=dev,
                               graph=graphs["graphed"],
                               prefill_graph=prefills["graphed"])
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
                                 graph=graphs["eager"],
                                 prefill_graph=prefills["eager"])
    if not (torch.equal(eager.cot_tokens, out.cot_tokens)
            and torch.equal(eager.action_tokens, out.action_tokens)):
        raise AssertionError("graphed and eager control steps give other "
                             "tokens")
    print(f"  graphed and eager control steps: the same {cfg.n_cot_tokens} "
          f"CoT and {n_act} action tokens per robot")
    logits_g, _ = prefills["graphed"].run(cfg, opts, params, batch, max_seq)
    logits_e, _ = prefills["eager"].run(cfg, opts, params, batch, max_seq)
    check("vision + prefill logits, graphed vs eager", logits_g, logits_e,
          KERNEL_TOL)
    print(f"  vision + prefill logits graphed vs eager: bit-equal "
          f"{torch.equal(logits_g, logits_e)}")
    # more control steps through the same two kept graphs: neither
    # captures again (the prefill graph's caches keep their address)
    step_ms = [step_s * 1e3]
    for _ in range(PHASE_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = vla.vla_control_step(cfg, opts, params, batch, device=dev,
                                     graph=graphs["graphed"],
                                     prefill_graph=prefills["graphed"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if not (torch.equal(again.cot_tokens, out.cot_tokens)
                and torch.equal(again.action_tokens, out.action_tokens)):
            raise AssertionError("a later control step through the kept "
                                 "graphs gives other tokens")
    pre, dec = prefills["graphed"].runner, graphs["graphed"].runner
    print(f"  {len(step_ms)} control steps through one kept PrefillGraph and "
          f"one kept DecodeGraph: host-clock ms {[round(t, 2) for t in step_ms]};"
          f" prefill graph captures {pre.captures} ({pre.capture_s * 1e3:.1f} "
          f"ms), decode graph captures {dec.captures} "
          f"({dec.capture_s * 1e3:.1f} ms); [{card_line()}]")
    if (pre.captures, dec.captures) != (1, 1):
        raise AssertionError(f"control steps captured the prefill graph "
                             f"{pre.captures} and the decode graph "
                             f"{dec.captures} times, not once each")
    graph_step_checks("control-step vision + prefill", pre, lambda: None)

    # the same phases, timed one by one with CUDA events, in both modes
    # (graphed: median of PHASE_REPEATS; eager: EAGER_REPEATS runs); the
    # split runs vision and prefill as two graphs of its own, and decode
    # graphs of its own, so the control step's graphs above keep their
    # one capture each
    names = ("vision", "prefill", "cot_decode", "action_decode")
    runs = {mode: [] for mode in graphs}
    split = {mode: (M.VisionGraph(dev, eager=mode == "eager"),
                    M.PrefillGraph(dev, eager=mode == "eager"),
                    M.DecodeGraph(dev, eager=mode == "eager"))
             for mode in graphs}
    joint_ms = {mode: [] for mode in graphs}
    for rep in range(PHASE_REPEATS):
        for mode in graphs:
            if mode == "eager" and rep >= EAGER_REPEATS:
                continue
            vis_graph, pre_graph, graph = split[mode]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
            ev[0].record()
            prefix = vis_graph.run(cfg, opts, params, patches)
            ev[1].record()
            logits, caches = pre_graph.run(
                cfg, opts, params, {"tokens": tokens, "prefix": prefix},
                max_seq)
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
            ev[5].record()          # the control step's joint graph
            prefills[mode].run(cfg, opts, params, batch, max_seq)
            ev[6].record()
            torch.cuda.synchronize()
            joint_ms[mode].append(ev[5].elapsed_time(ev[6]))
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
        print(f"  {mode}, median of {len(rs)}: control step "
              f"{total:.2f} ms (" + ", ".join(
                  f"{n} {t:.2f}" for n, t in phase_ms[mode].items())
              + f"); action-generation share {act_share:.4f}; CoT+action "
              f"decode share {dec_share:.4f}")
        print(f"  {mode}: vision + prefill as the control step runs it "
              f"(one {'graph replay' if mode == 'graphed' else 'eager body'}"
              f"), median {float(np.median(joint_ms[mode])):.2f} ms vs "
              f"{phase_ms[mode]['vision'] + phase_ms[mode]['prefill']:.2f} "
              f"as two stages; [{card_line()}]")
    simulated_split(cfg, phase_ms["graphed"])
    runner = graphs["graphed"].runner
    print(f"  vla_control_step (graphed, vision + prefill one graph, first "
          f"call) {step_s * 1e3:.2f} ms by host clock; peak memory "
          f"{peak_gb:.2f} GB; decode graph captures {runner.captures} (one "
          f"a control step's caches, over {len(step_ms)} control steps), "
          f"{runner.capture_s / runner.captures * 1e3:.1f} ms a capture")
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
    return launches, phase_ms["graphed"]


def simulated_split(cfg, measured):
    """Phase 4, the paper's Fig. 2 question asked of the card: the
    analytical model's phase split of the same control step (``core.
    xpu_sim.simulate_vla`` at B = FULL_B) on ``core.hardware.H100_SXM``
    (the data sheet's HBM rate and bf16 peak; the model's default
    efficiencies), beside the graphed step's measured split
    (``measured``: ms by phase, medians). The generation fraction is the
    paper's: prefill + CoT decode over the step."""
    from repro_torch.core.xpu_sim import simulate_vla
    hw = H100_SXM
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


def tick_bodies(eng) -> int:
    """How many of an engine's fused-tick steps (speculative: rounds) ran
    their body on the device: eagerly every step, masked ones too; graphed,
    after ``capture()``, its masked warm-up step and each replay whose
    guard held, which are the device steps the ticks counted
    (``guard_gates`` holds the runner's ``ran`` to them)."""
    g = eng._tick.graph
    if g.eager:
        return eng.stats.device_steps + eng.masked_steps
    return g.captures + eng.stats.device_steps


def capture_steps(eng) -> int:
    """The masked steps (speculative: rounds) ``capture()`` ran as the tick
    graph's warm-up: one graphed, none eagerly."""
    g = eng._tick.graph
    return 0 if g.eager else g.captures


def guard_gates(eng):
    """A graphed engine that ``capture()`` captured before its first tick:
    its tick graph captured once, there, and sealed; the replays whose
    guard held (the runner's ``ran``, read back on the device) are the
    device steps (speculative: rounds) the ticks counted from the carry,
    no more and no fewer."""
    g, st = eng._tick.graph, eng.stats
    if g.eager:
        return {}
    return {
        "the tick graph captured once, by capture(), and sealed":
            g.captures == 1 and g.sealed,
        f"replays that ran the body ({g.replays_ran}) == device steps "
        f"({st.device_steps})": g.replays_ran == st.device_steps,
    }


def launches_vs_eager(eng, eager, launches, launches_e, per_step,
                      per_chunk):
    """A graphed engine's launches held against the eager engine's, which
    counted each kernel as it launched: the eager ticks ran their masked
    steps in full (``eager.masked_steps``), the graphed ticks ran none of
    them but ran ``capture()``'s warm-up step (one a tick capture) and its
    masked chunks (``masked_chunks``). ``per_step`` / ``per_chunk``: each
    kernel's launches a tick step (speculative: round) and a chunk. Both
    engines must take the same device steps."""
    g = eng._tick.graph
    extra = g.captures - eager.masked_steps
    want = {k: launches_e[k] + per_step.get(k, 0) * extra
            + per_chunk.get(k, 0) * eng.masked_chunks for k in launches}
    return {
        "graphed device steps == eager device steps":
            eng.stats.device_steps == eager.stats.device_steps,
        f"graphed launches == eager launches + a step's x ({g.captures} "
        f"capture warm-up - {eager.masked_steps} eager masked steps) + a "
        f"chunk's x {eng.masked_chunks} masked capture chunks":
            launches == want,
    }


def chunk_warmups(eng) -> int:
    """The masked chunks a chunked engine's ``capture()`` ran as its chunk
    graphs' warm-up steps (none eagerly; a chunk graph captured at first
    use warms up on that real chunk)."""
    return eng.masked_chunks


def live_carry(eng):
    """A reset for a drained engine's tick whose step (or round) must run:
    the tick's carry with every slot live and no quota spent, positions
    (kept LIVE_MARGIN steps or rounds inside the cache), current tokens
    and Mamba2 states back where the reset was made, counters zero (its
    buffers take only so many steps), a paged slot's table on pages of
    its own, so the guard holds and the step does a slot's work, the same
    after every reset."""
    import torch
    tick = eng._tick
    margin = LIVE_MARGIN * (tick.K if eng.spec_decode else 1) + 1
    index = tick.index.clamp(max=eng.max_seq - margin).clone()
    tokens = tick.tokens.clone()
    states = [t.clone() for t in getattr(tick, "recurrent", ())]
    if tick.page_table is not None:
        # pages of its own for each slot (a drained pool's, free): through
        # the null page the slots' writes would collide, and which one
        # lands is not fixed
        B, npg = tick.page_table.shape
        if eng.pool.num_pages < 1 + B * npg:
            raise AssertionError("live_carry needs a page a slot position")
        tick.page_table.copy_(torch.arange(
            1, 1 + B * npg, dtype=torch.int32,
            device=tick.page_table.device).reshape(B, npg))

    def reset():
        tick.index.copy_(index)
        tick.tokens.copy_(tokens)
        for t, held in zip(getattr(tick, "recurrent", ()), states):
            t.copy_(held)
        tick.done.zero_()
        tick.entry_done.zero_()
        tick.budget.fill_(1 << 20)
        tick.out.fill_(-1)
        if hasattr(tick, "counter"):                 # DecodeTick
            tick.counter.zero_()
            tick.n_emit.zero_()
            tick.steps.zero_()
        else:                                        # SpecTick
            tick.cap.fill_(tick.T)
            for buf in (tick.e, tick.passes, tick.hist, tick.rounds):
                buf.zero_()
        tick.graph.ran.zero_()
    return reset


def carry(tick):
    """The tensors of a tick's carry that the host reads back."""
    names = (("out", "n_emit", "index", "budget", "done", "tokens", "steps")
             if hasattr(tick, "counter") else
             ("out", "e", "index", "budget", "done", "tokens", "passes",
              "hist", "rounds"))
    return [getattr(tick, n) for n in names]


LIVE_MARGIN = 6      # steps a reset of live_carry serves at most
CHUNK_CHECKED = "paged-f32-chunked"   # the chunk graph graph_step_checks


# a spin of ~0.1 s of the card's clock, long enough for the host to queue
# every timed call of ``queued_ms`` behind it
SPIN_CYCLES = 200_000_000


def queued_ms(fn, iters: int, warmup: int = 3):
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events,
    the calls queued behind a spin kernel (``torch.cuda._sleep``) so that
    the device reaches them only once the host has launched them all:
    where a call's device work is shorter than its launch, ``time_ms``
    times the host's launches instead. Returns (ms a call, host ms to
    queue the calls, spin ms): a queue time past the spin means the host
    still bounded the figure (from above)."""
    import torch
    for _ in range(warmup):
        fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    torch.cuda._sleep(SPIN_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    queued = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    return (ev[1].elapsed_time(ev[2]) / iters, queued,
            ev[0].elapsed_time(ev[1]))


def masked_vs_live(label: str, eng, reps: int = 20):
    """A guarded tick step replayed with its guard false (every slot done)
    against the same step live, on the device (``queued_ms``, ``reps``
    replays each): a live replay follows ``live_carry``'s reset (a few
    small kernels, in its time), so it never runs past its buffers or its
    cache; a replay with the guard false changes nothing and needs none.
    Also printed: the guarded-off replays timed back to back
    (``time_ms``), which the host's graph launches bound. Returns (masked
    ms, live ms), the device's."""
    tick = eng._tick
    reset = live_carry(eng)
    g = tick.graph

    def live_step():
        reset()
        g.step(g.key)
    live, q_live, spin = queued_ms(live_step, reps)
    ran_live = int(g.ran)            # each reset zeroes it: the last ran
    reset()
    tick.done.fill_(True)
    tick.entry_done.fill_(True)
    masked, q_masked, _ = queued_ms(lambda: g.step(g.key), reps)
    launched = time_ms(lambda: g.step(g.key), reps)
    ran_masked = int(g.ran)
    reset()
    print(f"  {label}: a replay with the guard false {masked:.4f} ms on "
          f"the device, a live step {live:.4f} ms ({masked / live:.4f} of "
          f"it; {reps} replays each, queued in {q_masked:.1f} / "
          f"{q_live:.1f} ms behind a {spin:.1f} ms spin); back to back, "
          f"bound by the host's launches, {launched:.4f} ms a guarded-off "
          f"replay; [{card_line()}]")
    if (ran_live, ran_masked) != (1, 0):
        raise AssertionError(f"{label}: the last live replay ran the step "
                             f"{ran_live} times, the {2 * reps + 6} "
                             f"guarded-off ones {ran_masked} times, not 1 "
                             f"and 0")
    return masked, live


def graph_step_checks(label: str, runner, reset, state=None):
    """One step replayed from ``runner``'s graph against the same step run
    eagerly: the same kernels by name in the order the device ran them
    (both traced in one profiler session), and at most
    MAX_GRAPH_LAUNCHES host launch calls a replayed step (torch.profiler's
    runtime events over 4 replays; the eager step's are printed beside).
    ``reset`` puts the step's counter (and any position that would leave
    its cache) back before each traced run: its buffers take only so many
    steps.

    A guarded runner's replay is its guard, the kernel that sets its IF
    node's condition and, in the node, a copy of its body's graph (the
    body and the ``ran`` count); ``reset`` must let the guard hold
    (``live_carry``). The profiler neither keeps the order of the kernels
    a conditional node runs among the graph's others nor, now and then,
    sees all of them, so the order is held on the body's own graph,
    replayed alone (the same nodes as the copy in the IF node), against
    the eager body; that the guarded replay ran the whole body is held on
    what it wrote: ``state()`` (the tensors the step writes that the
    host reads) after a guarded replay equals it after the eager step, bit
    for bit."""
    import difflib
    import torch
    replay = (lambda: runner.step(runner.key))
    guarded = runner.guard is not None
    if not guarded:
        eager_step, order_fn = runner.body, replay
    else:
        body_graph = runner.graphs[runner.key][2][0]

        def eager_step():
            runner.body()
            runner.ran.add_(1)
        order_fn = body_graph.replay
        reset()
        replay()
        after_replay = [t.clone() for t in state()]
        reset()
        runner.guard()
        eager_step()
        if not all(torch.equal(a, b) for a, b in zip(after_replay,
                                                       state())):
            raise AssertionError(f"{label}: a guarded replay did not write "
                                 f"what the eager step writes")
    # the profiler has now and then left a few of a long step's device
    # events (or a marker) out of a trace: a trace with a missing marker
    # or a difference is taken again, up to TRACE_ATTEMPTS times in all,
    # and each attempt's outcome is printed. A step that runs other
    # kernels when replayed differs in every attempt.
    graphed = eager = None
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        seqs = step_sequences([(reset, order_fn), (reset, eager_step)])
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
    if guarded:
        print(f"  {label}: a guarded replay wrote what the eager step "
              f"writes; the order is held on the body's own graph")
    reset()
    calls = launch_calls(replay, steps=4)
    reset()
    e_calls = launch_calls(eager_step)
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
                                "paged_kernel", "flash_kernel",
                                "flash_tf32", "flash_mma")),
                 ("library GEMMs", ("gemm", "nvjet", "xmma", "cutlass")),
                 ("SSD scan", ("ssd_states", "ssd_output")))


def decode_breakdown(run_steps, wall_ms: float, steps: int = 4,
                     label: str = "decode step"):
    """Device-busy time of a full-width decode step (or of the step
    ``label`` names), by torch.profiler over ``steps`` steps
    (``run_steps(n)`` runs n steps), against its wall time: the device's
    idle share, device time by part of the step (the grouped-expert
    kernels, attention, the library's GEMMs, the rest: norms, RoPE,
    routing and dispatch, sampling), and the kernels that take the most
    time. Returns (busy ms, kernels) a step, None when not measured."""
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
        return None
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
    return busy_ms, kernels


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


def run_engine(cfg, params, obs, kw, device, max_tokens=SERVE_TOKENS):
    """The 16 requests (each observation twice in a row) on one engine,
    its graphs captured first as the front end captures them (``capture``:
    nothing eagerly); returns (engine, {uid: tokens}, wall seconds)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serving import Request, ServingEngine
    eng = ServingEngine(cfg, M.ModelOptions(), params, n_slots=SERVE_SLOTS,
                        max_seq=SERVE_MAX_SEQ, eos=-1,
                        tick_tokens=SERVE_TICK, device=device, **kw)
    eng.capture()
    for i in range(2 * SERVE_OBS):
        prompt, px = obs[i // 2]
        eng.submit(Request(uid=i, prompt=prompt, max_tokens=max_tokens,
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
        "masked_steps": eng.masked_steps - capture_steps(eng)}


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
    SERVE_LAYERS layers. Returns {engine: (launches, stats, tick steps
    run, masked capture chunks)}."""
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
        results[name] = (launches, eng.stats, tick_bodies(eng),
                         chunk_warmups(eng))
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
    flip. Graphed, the tick replays its cap of guarded rounds and reads
    the carry back once: decode_syncs == ticks. Returns {engine:
    (launches, stats, rounds run)}."""
    t0 = time.perf_counter()
    obs = observations(cfg, cfg.vocab_size, SEED + 3)
    cfg, params = first_layers(cfg, params, SERVE_LAYERS)
    results = {}
    for name, kw, ref in SPEC_ENGINES:
        kw = dict(kw, draft_layers=cfg.num_layers)
        eng, out, launches, gates, per_round = serve_spec(cfg, params, obs,
                                                          name, kw)
        tick = eng._tick
        graph_step_checks(f"{name} round", tick.graph,
                          reset=live_carry(eng), state=lambda: carry(tick))
        masked, live = masked_vs_live(f"{name} round", eng, reps=10)
        gates["a guarded-off round costs under a tenth of a live one"] = \
            masked < live / 10
        eager, out_e, launches_e, gates_e, _ = serve_spec(
            cfg, params, obs, name, kw, graphs=False)
        gates.update({f"eager: {k}": ok for k, ok in gates_e.items()})
        gates["graphed streams equal eager streams"] = out == out_e
        gates.update(launches_vs_eager(eng, eager, launches, launches_e,
                                       per_round, {}))
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
              f"{stream_share(out, fused[ref]):.4f} (reported, not a gate); "
              f"syncs {g.decode_syncs} vs {e.decode_syncs} over "
              f"{g.ticks} ticks; [{card_line()}]")
        round_breakdown(eng, f"{cfg.name} ({SERVE_LAYERS} layers, {name})")
        results[name] = (launches, eng.stats, tick_bodies(eng))
        del eng, eager
    print(f"  phase 5c took {time.perf_counter() - t0:.1f} s")
    return results


def serve_spec(cfg, params, obs, name: str, kw, graphs: bool = True):
    """The 16 requests through one full-width speculative engine, its
    rounds replayed from a CUDA graph or (``graphs=False``) run eagerly;
    prints its row and returns (engine, {uid: tokens}, launches, gates,
    each kernel's launches a round). Gates: every request finishes with
    193 tokens; a round whose body ran (``tick_bodies``) launches the
    decode kernel once a draft layer for each of its spec_k - 1 draft
    steps and the layout's chunk kernel once a layer for its verify chunk;
    each admission prefill the dense chunk kernel once a layer; nothing
    else; one first-token readback per request; graphed, one readback a
    tick (``decode_syncs == ticks``), ``guard_gates`` and
    ``capture_gates``, eagerly at least one readback a tick; a paged pool
    drains to 0 pages."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels = reset_launches()
    eng, out, wall = run_engine(cfg, params, obs, dict(kw, graphs=graphs),
                                "cuda")
    launches = read_launches(kernels)
    st, L = eng.stats, cfg.num_layers
    rounds = tick_bodies(eng)
    rep = st.phase_report()
    n_tok = sum(map(len, out.values()))
    decode_kernel = ("paged_decode_attention" if eng.paged
                     else "decode_attention")
    verify_kernel = "paged_chunk_prefill" if eng.paged else "chunk_prefill"
    per_round = {decode_kernel: (SPEC_K - 1) * eng.draft_layers,
                 verify_kernel: L}
    expected = {k: n * rounds for k, n in per_round.items()}
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
          f"{rep['spec_accept_hist']}, rounds run {rounds}, spec_draft_frac "
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
    if graphs:
        gates["decode_syncs == ticks"] = st.decode_syncs == st.ticks
        gates.update(guard_gates(eng))
        gates.update(capture_gates(eng))
    if eng.paged:
        gates["pages_in_use == 0 at drain"] = st.pages_in_use == 0
    return eng, out, launches, gates, per_round


def round_breakdown(eng, label: str):
    """``decode_breakdown`` of a speculative engine's round after it
    drained (each round made live again: ``live_carry``, reset before
    every round, so no slot runs out of room), replayed from its graph and
    run eagerly; the wall by host clock over 4 rounds."""
    import torch
    tick = eng._tick
    reset = live_carry(eng)
    for mode, step in (("graphed", lambda: tick.graph.step(tick.graph.key)),
                       ("eager", tick.graph.body)):
        def run_steps(n, step=step):
            for _ in range(n):
                reset()
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
                 graphs: bool = True, max_tokens: int = SERVE_TOKENS):
    """The 16 requests through one full-width engine on the card, its tick
    step replayed from a CUDA graph or (``graphs=False``) run eagerly;
    prints its serving row and returns (engine, {uid: tokens}, launches,
    gates, (each kernel's launches a tick step, and a chunk run)).
    Launches count replays (``graphs.StepGraph``).
    Gates: every request finishes with 193 tokens; each decode step whose
    body ran (``tick_bodies``: eagerly every step, masked ones too;
    graphed, the capture's warm-up and each replay whose guard held, held
    to the device steps by ``guard_gates``) launches the engine's decode
    kernel once an attention layer, and each
    prefill run its chunk kernel once an attention layer (admit-stall: one
    dense chunk prefill per request; chunked: one launch of the layout's
    chunk kernel per chunk run, and per masked chunk a chunk graph's
    capture ran as its warm-up); MoE layers launch
    gmm_gated and gmm_down once a layer per prefill run and per decode
    step; Mamba2 layers launch the SSD scan once a layer per prefill run
    (decode runs the recurrence, no kernel); no other kernel runs; one
    readback per decode tick and one first-token readback per request;
    admit-stall: a readback every tick, and paged engines >= 8 x the
    prompt's pages of prefix hits; chunked: prefill_tokens +
    prefill_skipped = 16 x the prompt, no tick prefills more than the
    token budget; a paged pool drains to 0 pages. Graphed:
    ``guard_gates`` and ``capture_gates``."""
    import gc
    import torch
    torch.cuda.synchronize()
    gc.collect()            # an engine's graphs and buffers form cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels = reset_launches()
    eng, out, wall = run_engine(cfg, params, obs, dict(kw, graphs=graphs),
                                "cuda", max_tokens)
    launches = read_launches(kernels)
    st = eng.stats
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    L = cfg.num_layers
    n_tok = sum(map(len, out.values()))
    steps = tick_bodies(eng)
    warm = chunk_warmups(eng)
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
    per_step = {decode_kernel: n_attn, "gmm_gated": n_moe,
                "gmm_down": n_moe}
    per_run = {chunk_kernel: n_attn, "gmm_gated": n_moe, "gmm_down": n_moe,
               "ssd": L - n_attn}
    # (Mamba2 stacks serve admit-stall only: no masked chunk runs the scan)
    expected = {k: per_step.get(k, 0) * steps
                + per_run.get(k, 0) * (runs + warm)
                for k in set(per_step) | set(per_run)}
    idle = [k for k in launches if not expected.get(k)]
    print(f"  {name} ({'graphed' if graphs else 'eager'}): {len(out)} "
          f"requests, {n_tok} tokens in "
          f"{wall:.3f} s ({n_tok / wall:.2f} tokens/s); ticks "
          f"{st.ticks}, device steps {st.device_steps}, masked steps "
          f"{eng.masked_steps} ({st.device_steps + eng.masked_steps - steps}"
          f" skipped by the guard); captures: tick "
          f"{eng._tick.graph.captures}, vision {vision_graphs(eng)}, chunk "
          f"{chunk_graphs(eng)}; TTFT p50/p99 "
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
        f"every request finishes with {max_tokens} tokens":
            len(out) == 2 * SERVE_OBS
            and all(len(t) == max_tokens for t in out.values()),
        f"{decode_kernel} launches == {n_attn} x tick steps":
            launches[decode_kernel] == expected[decode_kernel],
        f"{chunk_kernel} launches == {n_attn} x ({runs} prefill runs + "
        f"{warm} masked capture chunks)":
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
                  f"{warm} masked chunks + {steps} tick steps)"] = \
                launches[k] == expected[k]
    if graphs:
        gates.update(guard_gates(eng))
        gates.update(capture_gates(eng))
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
    return eng, out, launches, gates, (per_step, per_run)


def chunk_graphs(eng):
    return "-" if eng._chunk is None else eng._chunk.runner.captures


def vision_graphs(eng):
    return "-" if eng._vision is None else eng._vision.runner.captures


def graph_captures(eng):
    """(tick, vision, chunk) graph captures of an engine (0: none)."""
    return tuple(0 if r is None else r.captures for r in (
        eng._tick.graph, eng._vision and eng._vision.runner,
        eng._chunk and eng._chunk.runner))


def capture_ms(eng) -> float:
    """Host ms of a graphed engine's vision and chunk captures."""
    return sum(r.runner.capture_s for r in (eng._vision, eng._chunk)
               if r is not None) * 1e3


def capture_gates(eng):
    """A graphed engine's captures over its life, all made by
    ``capture()``: one vision graph (a config with a tower), and at most
    one chunk graph a slot's staging cache (dense) or one (the pool),
    chunked."""
    gates = {}
    if eng.scheduler is not None:
        limit = 1 if eng.paged else eng.n_slots
        gates[f"chunk graph captures {eng._chunk.runner.captures} <= "
              f"{limit}"] = 1 <= eng._chunk.runner.captures <= limit
    if eng._vision is not None:
        gates["one vision graph capture"] = eng._vision.runner.captures == 1
    return gates


def serve_both(cfg, params, obs, name: str, kw, prompt_len: int):
    """One engine of a serving phase in both modes: its stages replayed
    from CUDA graphs (the main path: the guarded tick step, the vision
    graph, the chunk graphs; the admit-stall prefill runs kernel by
    kernel), then run eagerly (``graphs=False``, the oracle). Each run
    holds ``serve_engine``'s gates; the graphed run's streams must equal
    the eager run's, and its launches the eager run's less the eager
    masked steps and plus its capture's warm-up step and masked chunks
    (``launches_vs_eager``); a replayed tick
    step (and chunk) must run the eager one's kernels with at most a
    couple of host launch calls (``graph_step_checks``), and a replayed
    step with the guard false must cost under a tenth of a live one
    (``masked_vs_live``). Prints the two runs' walls, TTFT, tokens/s and
    tick percentiles side by side. Returns (graphed engine, its streams,
    its launches, gates, eager engine)."""
    t0 = time.perf_counter()
    eng, out, launches, gates, (per_step, per_run) = serve_engine(
        cfg, params, obs, name, kw, prompt_len)
    wall_g = time.perf_counter() - t0
    tick = eng._tick
    graph_step_checks(f"{name} tick step", tick.graph,
                      reset=live_carry(eng), state=lambda: carry(tick))
    masked, live = masked_vs_live(f"{name} tick step", eng)
    gates["a guarded-off replay costs under a tenth of a live step"] = \
        masked < live / 10
    if name == CHUNK_CHECKED:
        graph_step_checks(f"{name} chunk", eng._chunk.runner,
                          reset=eng._chunk.load_masked)
    t0 = time.perf_counter()
    eager, out_e, launches_e, gates_e, _ = serve_engine(
        cfg, params, obs, name, kw, prompt_len, graphs=False)
    wall_e = time.perf_counter() - t0
    gates.update({f"eager: {k}": ok for k, ok in gates_e.items()})
    gates["graphed streams equal eager streams"] = out == out_e
    gates.update(launches_vs_eager(eng, eager, launches, launches_e,
                                   per_step, per_run))
    g, e = eng.stats, eager.stats
    gr, er = g.phase_report(), e.phase_report()
    n_tok = sum(map(len, out.values()))
    print(f"  {name}, graphed vs eager: TTFT p50/p99 "
          f"{gr['ttft_p50'] * 1e3:.2f}/{gr['ttft_p99'] * 1e3:.2f} vs "
          f"{er['ttft_p50'] * 1e3:.2f}/{er['ttft_p99'] * 1e3:.2f} ms; "
          f"tokens/s {n_tok / wall_g:.2f} vs {n_tok / wall_e:.2f} (whole "
          f"run, engine built and captures in); prefill "
          f"{g.prefill_time:.3f} vs {e.prefill_time:.3f} s; vision "
          f"{g.vision_time:.3f} vs {e.vision_time:.3f} s; vision / chunk "
          f"graph captures {vision_graphs(eng)} / {chunk_graphs(eng)} "
          f"({capture_ms(eng):.1f} ms, by capture() before the requests); "
          f"[{card_line()}]")
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


def local_kernel_checks(cfg):
    """Phase 12, rows 1-4 against their plain versions at a sharded rank's
    local heads (LOCAL_HEADS: G = 7 with K = 2 and K = 1, h = 128): the
    dense decode kernel over bf16 and f32 caches of the engines' 8 slots,
    the paged decode kernel over every page type (and bit-equal to the
    dense one), the chunk kernel at the admission prefill (one 640-row
    prompt) and a 128-row chunk over bf16 and f32 views, and the paged
    chunk kernel's phase-2 checks. Returns the largest errors."""
    import torch
    from repro_torch.core.vla import control_step_lengths
    from repro_torch.kernels.chunk_prefill import ops as cp
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    h = cfg.head_dim
    _, _, smax = control_step_lengths(cfg, FULL_TEXT)
    errs = {}

    def record(name, label, got, want):
        errs[name] = max(errs.get(name, 0.0),
                         check(label, got, want, KERNEL_TOL, quiet=True))

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    for n, (N, K) in LOCAL_HEADS.items():
        print(f"  model={n}: {N} query and {K} KV heads a rank (G = "
              f"{N // K}, h = {h})")
        q = randn(SERVE_SLOTS, N, h)
        for kv_type in (torch.float32, torch.bfloat16):
            kc = randn(SERVE_SLOTS, SERVE_MAX_SEQ, K, h, dtype=kv_type)
            vc = randn(SERVE_SLOTS, SERVE_MAX_SEQ, K, h, dtype=kv_type)
            decode_cases(f"decode_attention/local{n}/{kv_type}", q, kc, vc,
                         serve_cases(dev), record)
        paged_checks(g, errs, (SERVE_SLOTS, N, K, h), smax)
        qc = randn(1, 640, N, h)
        for kv_type in (torch.bfloat16, torch.float32):
            k1 = randn(1, 640, K, h, dtype=kv_type)
            v1 = randn(1, 640, K, h, dtype=kv_type)
            for start, window in ((0, 0), (512, 0), (0, 64), (512, 64)):
                qs = qc[:, start:].contiguous()
                record(f"chunk_prefill/local{n}/{kv_type}",
                       f"start={start} window={window}",
                       cp.chunk_prefill_attention(qs, k1, v1, start,
                                                  window=window),
                       cp.chunk_prefill_ref(qs.float(), k1, v1, start,
                                            window))
        paged_chunk_checks(dataclasses.replace(cfg, num_heads=N,
                                               num_kv_heads=K), g, errs)
    for k, v in sorted(errs.items()):
        if "local" in k:
            print(f"  {k}: max_abs_err={v:.3g} (tol {KERNEL_TOL:g} x "
                  f"max(1, |plain|))")
    return errs


def shard_step_bytes(cfg, eng, mesh):
    """(counted, formula, seconds, all-reduces) of one fused decode step
    of a sharded engine's 8 slots: the collective bytes counted and by the
    formula (an all-reduce of [B, 1, D] after each layer's attention when
    the heads shard and after its MLP when the width does, one after the
    embedding when the vocab shards, and one all-gather of [B, 1, V]
    logits, at the weights' item size), rank 0's seconds in each kind of
    collective (``ShardGroup.seconds``, the card synchronized around each
    one) and in the whole step (by host clock, timing on), and the number
    of all-reduces."""
    import torch
    from repro_torch.distributed.collectives import KINDS
    from repro_torch.distributed.sharding import serving_rules
    n, B = mesh.shape["model"], eng.n_slots
    rules = serving_rules(n, cfg.num_heads, cfg.num_kv_heads)
    item = eng.params["embed"].element_size()
    act = B * cfg.d_model * item
    vocab = cfg.vocab_size % n == 0
    layer = (rules["heads"] is not None) + (cfg.d_ff % n == 0)
    want = {"all-reduce": float(cfg.num_layers * layer * act + vocab * act),
            "all-gather": float(vocab * B * cfg.vocab_size * item)}
    want["total"] = want["all-reduce"] + want["all-gather"]
    mesh.group.reset_counts()
    mesh.group.seconds = dict.fromkeys(KINDS, 0.0)
    pt = eng._decode_page_table() if eng.paged else None
    done = np.asarray([s is None for s in eng.slots])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        eng._dev("tick", eng.tokens, eng.index, eng.budget, done, eng.keys,
                 pt, 1)
        torch.cuda.synchronize()
        seconds = dict(mesh.group.seconds,
                       step=time.perf_counter() - t0)
    finally:
        mesh.group.seconds = None
    return (mesh.group.counts(), want, seconds,
            cfg.num_layers * layer + vocab)


def first_logits(cfg, eng, obs):
    """An engine's logits of observation 0's admission prefill and of one
    decode step after it (slot 0 at its next position; the others at 0),
    through its device stages."""
    prompt, px = obs[0]
    eng._dev("vision", px)
    pre = eng._dev("prefill", 0, prompt, True)
    eng._dev("scatter", 0, None)
    tokens = np.zeros((eng.n_slots, 1), np.int32)
    index = np.zeros(eng.n_slots, np.int32)
    tokens[0, 0] = int(pre[0, -1].float().argmax())
    index[0] = cfg.vision.num_tokens + len(prompt)
    return pre, eng._dev("decode", tokens, index, None)


def sharded_serving_full(cfg, params, streams, serving):
    """Phase 12: sharded serving on the card, model=2: this process is rank
    0 and one spawned worker (``serving.sharded.spawn_mesh``) shares the
    card over gloo, each rank holding its slice of phase 5's seeded bf16
    weights (drawn leaf by leaf and sliced, ``SeededWeights``) on the
    same SERVE_LAYERS cut. Rows 1-4 at the local head shapes first
    (``local_kernel_checks``). Then the gates: the admission prefill's and
    a decode step's logits within CMP_TOL x max(1, |unsharded|) of an
    unsharded engine on the same f32 weights (on phase 5's bf16 weights
    the error is reported: every layer's sums in another order move the
    bf16 residual stream by a rounding, as phase 5's dense-chunked engine
    does); per engine (paged f32
    chunked, dense) ``serve_engine``'s gates on rank 0 (every request
    finishes, each kernel's launches per layer and step), one rank's
    cache bytes half the pool's, and a decode step's counted collective
    bytes equal to the formula (``shard_step_bytes``) and to the dry
    run's count of the same step (``launch.dryrun.
    serving_decode_collectives``: the step traced as DTensors on a fake
    ('model',) mesh on the meta device, on the host). Reported: the share
    of greedy tokens equal to phase 5's streams (bf16 near-ties may flip
    as the sums change order), tokens/s and decode-tick p50 of two ranks
    sharing one card (not a multi-card figure), rank 0's time in a decode
    step's all-reduces and all-gather, and each rank's peak memory."""
    import torch
    from repro_torch.launch.dryrun import serving_decode_collectives
    from repro_torch.models import model as M
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.sharded import SeededWeights, spawn_mesh
    t0 = time.perf_counter()
    local_kernel_checks(cfg)
    print(f"  rows 1-4 at the local heads: {time.perf_counter() - t0:.1f} s")
    obs = observations(cfg, cfg.vocab_size, SEED + 3)       # phase 5's
    cut, cut_params = first_layers(cfg, params, SERVE_LAYERS)
    weights = SeededWeights(SEED, torch.bfloat16,
                            draw_layers=cfg.num_layers)
    prompt_len = cfg.vision.num_tokens + FULL_TEXT
    t0 = time.perf_counter()
    mesh = spawn_mesh(MESH_MODEL, device="cuda", timeout=120.0)
    print(f"  mesh: model={MESH_MODEL} over gloo, both ranks on "
          f"{torch.cuda.get_device_name(0)}, started in "
          f"{time.perf_counter() - t0:.1f} s; the collectives run on the "
          f"card's tensors")
    kw = dict(n_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, eos=-1,
              tick_tokens=SERVE_TICK, device="cuda", graphs=False)
    try:
        # the function, on f32 weights (another seed, drawn on the cut);
        # then phase 5's bf16 weights, where each layer's sums in another
        # order move the bf16 residual stream by its rounding
        f32 = SeededWeights(SEED + 12, torch.float32)
        for w, whole, tol in ((f32, None, CMP_TOL),
                              (weights, cut_params, None)):
            plain = ServingEngine(cut, M.ModelOptions(),
                                  whole or w(cut, "cuda"), **kw)
            sharded = ServingEngine(cut, M.ModelOptions(), w, mesh=mesh,
                                    **kw)
            for (label, want), got in zip(
                    zip(("prefill logits", "decode logits"),
                        first_logits(cut, plain, obs)),
                    first_logits(cut, sharded, obs)):
                dtype = str(plain.params["embed"].dtype)
                label = (f"sharded vs unsharded {label} "
                         f"({dtype.removeprefix('torch.')})")
                if tol is not None:
                    check(label, got, want, tol)
                    continue
                err = (got.float() - want.float()).abs()
                rel = (err / want.float().abs().clamp(min=1.0)).max()
                same = (got.float().argmax(-1)
                        == want.float().argmax(-1)).float().mean()
                print(f"  {label}: max_abs_err={err.max().item():.4g}, "
                      f"largest error / max(1, |unsharded|) "
                      f"{rel.item():.4g}, argmax equal in {same.item():.4f}"
                      f" of rows (reported, not a gate)")
            sharded.close(workers=False)
            del plain, sharded
            torch.cuda.empty_cache()
        print(f"  logits checks: {time.perf_counter() - t0:.1f} s since the "
              f"mesh's start")
        for name, ekw in SHARDED_ENGINES:
            eng, out, launches, gates, _ = serve_engine(
                cut, weights, obs, f"sharded {name}", dict(ekw, mesh=mesh),
                prompt_len, graphs=False, max_tokens=SHARD_TOKENS)
            st = eng.stats
            counted, want, sec, n_ar = shard_step_bytes(cut, eng, mesh)
            gates[f"collective bytes a step == {want}"] = counted == want
            t0 = time.perf_counter()
            traced = serving_decode_collectives(
                cut, mesh.shape["model"], eng.n_slots, SERVE_MAX_SEQ,
                eng.params["embed"].dtype)
            t_trace = time.perf_counter() - t0
            gates[f"the dry run's count of the step {traced} == the "
                  f"counted bytes"] = traced == counted
            if eng.paged:
                gates["cache_bytes_hwm_shard x 2 == cache_bytes_hwm"] = \
                    st.cache_bytes_hwm_shard * 2 == st.cache_bytes_hwm
            mem = eng.rank_memory()
            eng.close(workers=False)
            ref = {u: t[:SHARD_TOKENS] for u, t in streams[name].items()}
            failed = [k for k, ok in gates.items() if not ok]
            if failed:
                raise AssertionError(f"sharded serving ({name}): {failed}")
            n_tok = sum(map(len, out.values()))
            rep = st.phase_report()
            p5 = serving[name][1].phase_report()
            print(f"  sharded {name}, two ranks sharing one card over gloo "
                  f"({card_line()}): {n_tok / sum(st.tick_s):.2f} tokens/s "
                  f"over its ticks, decode tick p50 "
                  f"{rep['decode_tick_p50'] * 1e3:.2f} ms (phase 5's "
                  f"graphed unsharded engine: "
                  f"{p5['decode_tick_p50'] * 1e3:.2f} ms); collective "
                  f"bytes a step {counted['total']:.0f} (all-reduce "
                  f"{counted['all-reduce']:.0f}, all-gather "
                  f"{counted['all-gather']:.0f}) = the formula = the dry "
                  f"run's trace of the step ({traced['total']:.0f}; "
                  f"{t_trace:.1f} s on the host); one decode "
                  f"step {sec['step'] * 1e3:.2f} ms by host clock, of it "
                  f"{n_ar} all-reduces {sec['all-reduce'] * 1e3:.2f} ms "
                  f"({sec['all-reduce'] / max(n_ar, 1) * 1e3:.3f} ms each)"
                  f" and the all-gather {sec['all-gather'] * 1e3:.2f} ms "
                  f"(rank 0, the card synchronized around each); "
                  f"cache_bytes_hwm_shard {st.cache_bytes_hwm_shard} of "
                  f"{st.cache_bytes_hwm}; peak memory "
                  + ", ".join(f"rank {r} {b / 1e9:.2f} GB"
                              for r, b in enumerate(mem))
                  + f"; share of tokens equal to phase 5's {name} streams "
                  f"(their first {SHARD_TOKENS}) "
                  f"{stream_share(out, ref):.4f} (reported, not a gate)")
            del eng
    finally:
        mesh.shutdown()


def tick_breakdown(eng, label: str):
    """``decode_breakdown`` of an engine's tick step after it drained (8
    slots, each made live again: ``live_carry``), replayed from its graph
    and run eagerly; the wall by host clock over 4 steps."""
    import torch
    tick = eng._tick
    reset = live_carry(eng)
    for mode, step in (("graphed", lambda: tick.graph.step(tick.graph.key)),
                       ("eager", tick.graph.body)):
        def run_steps(n, step=step):
            reset()
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
    """Phase 7: full-width granite-moe-3b-a800m, its first MOE_SERVE_LAYERS
    layers (seeded bf16 weights)
    serving the molmoact engines' shape: 16 requests from 8 prompts of 640
    seeded random tokens (each sent twice in a row), 193 tokens each, 8
    slots, max_seq 864, 8-token ticks, f32 caches, pages of 32; through
    MOE_ENGINES. Gates (``serve_engine``), and the paged-f32 streams equal
    the dense ones; the chunked engine's share of tokens equal to the dense
    streams is reported. Then the decode breakdown of 4 decode steps of
    the dense engine's batch. Returns {engine: (launches, stats, tick
    steps run, masked capture chunks)}."""
    import torch
    from repro_torch.models import model as M
    cfg = dataclasses.replace(cfg, num_layers=MOE_SERVE_LAYERS)
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
        results[name] = (launches, eng.stats, tick_bodies(eng),
                         chunk_warmups(eng))
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
    L = MOE_SERVE_LAYERS            # the layers phase 7 served
    by_c = dict.fromkeys(MOE_C, 0)
    for name, (launches, st, bodies, warm) in serving.items():
        by_c[2] += L * bodies
        if "chunked" in name:
            by_c[32] += L * (st.prefill_key_lanes_full
                             // (CHUNK_SIZE * SERVE_MAX_SEQ) + warm)
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


def moe_backward_checks(cfg):
    """Phase 2b, backward: each of ``GmmGated`` and ``GmmDown`` (their
    forward kernels; their backward's three and two products on
    gmm_down's kernel) against autograd through its plain version on the
    card, on the same operands and a seeded cotangent, at
    granite-moe-3b-a800m's width and C in MOE_GRAD_C, f32 and bf16, every
    act: each gradient within GRAD_TOL x max(1, |plain|) in f32 (sums in
    another order) and KERNEL_TOL in bf16 (each rounded to bf16 once, as
    the plain version's); the backwards launch gmm_down's kernel three
    and two times and gmm_gated's never. (Chained in bf16, a sum that
    rounds to the other neighbour in one backward moves the next one's
    result by that ulp times an operand, past KERNEL_TOL where the result
    is near zero; so the bf16 backwards are held one at a time.) Then the
    five products' times at the train step's C in f32 (the phase 9b
    path), each beside its bound and ``torch.bmm`` of the same
    operands."""
    import torch
    from repro_torch.kernels.moe_gmm import ops as gmm
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)

    def backward(fn, plain, ins, cot, spent):
        out = fn(*ins)
        before = (gmm.gmm_gated.launches, gmm.gmm_down.launches)
        got = torch.autograd.grad(out, ins, cot)
        torch.cuda.synchronize()
        n = (gmm.gmm_gated.launches - before[0],
             gmm.gmm_down.launches - before[1])
        if n != (0, spent):
            raise AssertionError(f"a backward launched (gmm_gated, "
                                 f"gmm_down) {n}, not (0, {spent})")
        return got, torch.autograd.grad(plain(*ins), ins, cot,
                                        allow_unused=True,
                                        materialize_grads=True)

    for dtype in (torch.float32, torch.bfloat16):
        tol = GRAD_TOL if dtype == torch.float32 else KERNEL_TOL
        for C in MOE_GRAD_C:
            x, wi, wg, wo = (t.requires_grad_()
                             for t in moe_experts(g, cfg, C, dtype))
            worst = {}
            for act in ("silu", "gelu", "gelu_plain"):
                dh = torch.randn(x.shape[0], C, wi.shape[-1],
                                 generator=g, device="cuda").to(dtype)
                got, want = backward(
                    lambda *a: gmm.gmm_gated(*a, act=act),
                    lambda *a: gmm.gmm_gated_ref(*a, act),
                    (x, wi, wg), dh, 3)
                for name, a, b in zip(("x", "wi", "wg"), got, want):
                    worst[name] = max(worst.get(name, 0.0), check(
                        f"gmm_gated d{name} {dtype} C={C} {act}", a, b,
                        tol, quiet=True))
            h = gmm.gmm_gated(x, wi, wg).detach().requires_grad_()
            dy = torch.randn(x.shape, generator=g, device="cuda").to(dtype)
            got, want = backward(gmm.gmm_down, gmm.gmm_down_ref, (h, wo),
                                 dy, 2)
            for name, a, b in zip(("h", "wo"), got, want):
                worst[name] = check(f"gmm_down d{name} {dtype} C={C}", a, b,
                                    tol, quiet=True)
            print(f"  backward, {str(dtype).replace('torch.', '')} C={C}: "
                  f"max_abs_err gmm_gated (silu, gelu, gelu_plain) "
                  + ", ".join(f"d{k} {worst[k]:.3g}" for k in
                              ("x", "wi", "wg"))
                  + f"; gmm_down dh {worst['h']:.3g}, dwo {worst['wo']:.3g}"
                  f" (tol {tol:g} x max(1, |plain|)); 3 and 2 gmm_down "
                  f"launches")
    E, D, F, C = cfg.num_experts, cfg.d_model, cfg.moe_d_ff, MOE_GRAD_C[-1]

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    products = {  # name -> (a [E,M,K], b [E,K,N])
        "x [wi|wg] (the sums again)": (rnd(E, C, D), rnd(E, D, 2 * F)),
        "dx = [da|dg] [wi|wg]^T": (rnd(E, C, 2 * F), rnd(E, 2 * F, D)),
        "[dwi|dwg] = x^T [da|dg]": (rnd(E, D, C), rnd(E, C, 2 * F)),
        "dh = dy wo^T": (rnd(E, C, D), rnd(E, D, F)),
        "dwo = h^T dy": (rnd(E, F, C), rnd(E, C, D))}
    print(f"  backward products at the train step's C={C} (f32, E={E}; "
          f"ms a launch, one by one):")
    for name, (a, b) in products.items():
        ms = time_ms(lambda: gmm._products(a, b), 5, warmup=1)
        lib = time_ms(lambda: torch.bmm(a, b), 5, warmup=1)
        M, K, N = a.shape[1], a.shape[2], b.shape[2]
        bd, by = bound(4 * E * (M * K + K * N + M * N), 2 * E * M * K * N,
                       torch.float32)
        print(f"    {name}: {ms:.3f} ms, torch.bmm {lib:.3f} ms, bound "
              f"{bd:.3f} ms ({by}; f32 outside the tensor cores)")


def ssd_backward_checks(cfg):
    """Phase 2c, backward: ``ssd`` through ``SSD`` (the kernel forward,
    the backward ``ssd_chunked`` again under autograd) against autograd
    through ``ssd_chunked`` on the card, at mamba2-780m's width, B=1 and S
    in SSD_GRAD_S, f32 and bf16, with seeded cotangents on y and the final
    state: each gradient within GRAD_TOL x max(1, |plain|) (f32) or
    KERNEL_TOL (bf16); the backward launches no kernel."""
    import torch
    from repro_torch.kernels.ssd import ops as ssd
    g = torch.Generator(device="cuda").manual_seed(SEED + 19)
    for S in SSD_GRAD_S:
        for dtype in (torch.float32, torch.bfloat16):
            tol = GRAD_TOL if dtype == torch.float32 else KERNEL_TOL
            ins = [t.requires_grad_()
                   for t in ssd_inputs(g, cfg, 1, S, dtype)]
            y, st = ssd.ssd(*ins)
            dy = torch.randn(y.shape, generator=g, device="cuda").to(dtype)
            ds = torch.randn(st.shape, generator=g, device="cuda")
            before = ssd.ssd.launches
            got = torch.autograd.grad((y, st), ins, (dy, ds))
            if ssd.ssd.launches != before:
                raise AssertionError("the ssd backward launched the kernel")
            want = torch.autograd.grad(ssd.ssd_chunked(*ins), ins, (dy, ds))
            errs = [check(f"ssd d{n} {dtype} S={S}", a, b, tol, quiet=True)
                    for n, a, b in zip(("x", "dt", "A_log", "B", "C"), got,
                                       want)]
            print(f"  ssd backward, {str(dtype).replace('torch.', '')} "
                  f"S={S}: max_abs_err dx, ddt, dA_log, dB, dC "
                  + ", ".join(f"{e:.3g}" for e in errs)
                  + f" (tol {tol:g} x max(1, |plain|))")


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
    """Phase 8: full-width mamba2-780m, its first SSM_SERVE_LAYERS layers
    (seeded bf16 weights, f32 caches)
    serving the granite engines' shape: 16 requests from 8 prompts of 640
    seeded random tokens (each sent twice in a row), 193 tokens each, 8
    slots, max_seq 864, 8-token ticks; through SSM_ENGINES (admit-stall
    dense and paged f32). Gates (``serve_engine``: 48 SSD launches per
    admission and no other kernel), the host plan counts equal to their
    CPU replay's, and the paged streams equal the dense ones. Then the
    decode breakdown of 4 decode steps of the dense engine's batch.
    Returns {engine: (launches, stats, tick steps run, masked capture
    chunks)}."""
    import torch
    from repro_torch.models import model as M
    cfg = dataclasses.replace(cfg, num_layers=SSM_SERVE_LAYERS)
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
        results[name] = (launches, eng.stats, tick_bodies(eng),
                         chunk_warmups(eng))
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


def loss_and_grads(cfg, params, batch, device, opts):
    """lm_loss (the train step's z-loss) and its gradients by leaf."""
    import torch
    from repro_torch.models.params import leaves, map_tree
    from repro_torch.training import TrainConfig, lm_loss
    live = map_tree(lambda t: t.detach().requires_grad_(True), params)
    loss = lm_loss(cfg, opts, live, batch, TrainConfig().z_loss,
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
    the reference's own contract). Layer remat is off here (one flash
    launch a layer); ``train_families_card_vs_cpu`` runs it on."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves, map_tree
    from repro_torch.training import (AdamWConfig, TrainConfig,
                                      init_train_state, make_train_step)
    opts = M.ModelOptions(remat=False)
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
        lg, gg = loss_and_grads(cfg, p_gpu, batch, "cuda", opts)
        if fa.flash_attention.launches - before != cfg.num_layers:
            raise AssertionError(f"reduced {name}: the train forward did "
                                 f"not launch the flash kernel once a "
                                 f"layer")
        lc, gc = loss_and_grads(cfg, p_cpu, batch, "cpu", opts)
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


def predicted_train_launches(cfg, remat: bool):
    """The port's kernel launches in one loss-and-gradient pass at S a
    multiple of 128, from the layer pattern: an attention layer launches
    the flash kernel once, a Mamba2 layer the SSD scan once, an MoE layer
    gmm_gated and gmm_down once each, all twice in a layer body that remat
    runs again (the tail layers are not checkpointed); an MoE layer's
    backward launches gmm_down's kernel five more times (three products
    for gmm_gated's gradient, two for gmm_down's); the flash and SSD
    backwards launch none."""
    from repro_torch.models.stacks import stack_plan, sub_kinds
    period, nblocks, ntail = stack_plan(cfg)
    kinds = sub_kinds(cfg)
    want = dict.fromkeys(("flash_attention", "ssd", "gmm_gated",
                          "gmm_down"), 0)
    for kind, again in ([(k, remat) for _ in range(nblocks) for k in kinds]
                        + [(kinds[j], False) for j in range(ntail)]):
        n = 2 if again else 1
        want["flash_attention" if kind.mixer == "attn" else "ssd"] += n
        if kind.ffn.startswith("moe"):
            want["gmm_gated"] += n
            want["gmm_down"] += n + 5
    return want


def grads_apart(got, want):
    """(the largest |got - want| of a leaf over its max|want|, that leaf's
    path), over the leaves of two {path: gradient} dicts."""
    return max((float((got[p].cpu() - w).abs().max()
                      / w.abs().max().clamp(min=1e-30)), p)
               for p, w in want.items())


def train_families_card_vs_cpu():
    """Phase 3d, the MoE and Mamba2 families: reduced granite-moe-3b-a800m,
    arctic-480b, mamba2-780m and jamba-1.5-large-398b, f32, B=4 x 128
    tokens, layer remat on, the same seeded weights and batch on the card
    (gmm_gated, gmm_down, ssd, flash) and on the CPU (plain versions): the
    loss within 1e-5 relative and the gradients within 1e-5 x max|g| of
    each leaf (jamba's within GRAD_TOL: its 14 Mamba2 layers each take
    the SSD kernel's 3xTF32 forward, 2.5e-5 x max|g| measured on dt_bias
    and A_log); the kernels' launches in the pass exactly
    ``predicted_train_launches``; remat off (and on jamba's 8-sublayer
    bodies, remat_sublayers) against remat on, on the card: every
    gradient within 1e-6 x max|g| (the same values recomputed;
    bit-equality printed); one train step's parameters on the smollm
    case's bars."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves, map_tree
    from repro_torch.training import (AdamWConfig, TrainConfig,
                                      init_train_state, make_train_step)
    opts = M.ModelOptions()
    for name in TRAIN_FAMILIES:
        cfg = get_config(name).reduced()
        p_cpu = M.init_params(cfg, torch.Generator().manual_seed(SEED),
                              torch.float32, device="cpu")
        p_gpu = map_tree(lambda t: t.cuda(), p_cpu)
        rng = np.random.default_rng(SEED + 18)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 128))}
        # the CPU's on one thread: its sums then come in one order
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            lc, gc = loss_and_grads(cfg, p_cpu, batch, "cpu", opts)
        finally:
            torch.set_num_threads(threads)
        kernels = reset_launches()
        lg, gg = loss_and_grads(cfg, p_gpu, batch, "cuda", opts)
        torch.cuda.synchronize()
        got = {k: v for k, v in read_launches(kernels).items()
               if k in ("flash_attention", "ssd", "gmm_gated", "gmm_down")}
        want = predicted_train_launches(cfg, remat=True)
        if got != want:
            raise AssertionError(f"reduced {name}: launches {got} in a "
                                 f"loss-and-gradient pass, not {want}")
        if not abs(lg - lc) <= 1e-5 * abs(lc):
            raise AssertionError(f"reduced {name} loss: card {lg} vs CPU "
                                 f"{lc}")
        worst, leaf = grads_apart(gg, gc)
        if worst > (GRAD_TOL if name == HYBRID_ARCH else 1e-5):
            raise AssertionError(f"reduced {name}: gradients of {leaf} "
                                 f"{worst} x max|g| apart")
        variants = [("remat off", M.ModelOptions(remat=False))]
        if name == HYBRID_ARCH:
            variants.append(("remat_sublayers",
                             M.ModelOptions(remat_sublayers=True)))
        remat_line = []
        for label, o in variants:
            _, gv = loss_and_grads(cfg, p_gpu, batch, "cuda", o)
            apart, _ = grads_apart(gv, {p: t.cpu() for p, t in gg.items()})
            if apart > 1e-6:
                raise AssertionError(f"reduced {name}: {label} gradients "
                                     f"{apart} x max|g| from remat on")
            same = all(torch.equal(gv[p], gg[p]) for p in gg)
            remat_line.append(f"{label} within {apart:.3g} x max|g|"
                              + (" (bit-equal)" if same else ""))
        tcfg = TrainConfig(opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=0))
        new = {}
        for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
            step = make_train_step(cfg, opts, tcfg, device=dev)
            new[dev] = step(p, init_train_state(cfg, tcfg, p), batch)
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
        print(f"  reduced {name} (remat on): loss card {lg:.7f} CPU "
              f"{lc:.7f}; grads within {worst:.3g} x max|g| ({leaf}); "
              f"launches "
              f"{got} as predicted; {'; '.join(remat_line)}; updated "
              f"parameters within {worst_p / TRAIN_LR:.3g} x lr where "
              f"|g| > 1e-2 max|g|")


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
    opts = M.ModelOptions(remat=False)
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


def train_families_full():
    """Phase 9b: full-width f32 train steps of the MoE and Mamba2 families
    (TRAIN_FULL: mamba2-780m's 48 layers, granite-moe-3b-a800m's 32;
    seeded weights, B=4 x 2048 tokens from ``lm_batches`` unless the
    reckoned memory passes TRAIN_MEMORY_GB, AdamW at lr TRAIN_LR, layer
    remat on, the update in place: ``donate=True``): one warm-up and
    TRAIN_STEPS timed steps on one repeated batch, gated on a finite loss
    that falls and on the launches ``predicted_train_launches`` predicts
    for each step;
    then the step's split (forward, backward, optimizer by CUDA events),
    peak memory and device breakdown. Returns ({arch: launches},
    {arch: (batch, median step ms)})."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves, map_tree, set_leaf
    from repro_torch.training import (AdamWConfig, TrainConfig,
                                      init_train_state, lm_loss,
                                      make_train_step)
    from repro_torch.training.optimizer import adamw_update
    dev = torch.device("cuda")
    opts = M.ModelOptions()
    tcfg = TrainConfig(opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=0))
    out, walls = {}, {}
    for name in TRAIN_FULL:
        cfg = get_config(name)
        t0 = time.perf_counter()
        params = M.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED),
            torch.float32, device=dev)
        n_params = sum(t.numel() for _, t in leaves(params))
        # parameters, gradients and two moments at 4 bytes each; the
        # layers' saved inputs under remat; four f32 copies of the logits
        reckon = {B: (16 * n_params + 4 * cfg.num_layers * B * TRAIN_S
                      * cfg.d_model + 16 * B * TRAIN_S * cfg.vocab_size)
                  / 1e9 for B in (TRAIN_B, 2)}
        B = TRAIN_B if reckon[TRAIN_B] <= TRAIN_MEMORY_GB else 2
        batch = next(lm_batches(cfg, B, TRAIN_S, seed=SEED, steps=1))
        step = make_train_step(cfg, opts, tcfg, device=dev, donate=True)
        state = init_train_state(cfg, tcfg, params)
        torch.cuda.synchronize()
        print(f"  {name}: {n_params / 1e9:.3f} B parameters in f32 "
              f"({time.perf_counter() - t0:.1f} s to build), batch {B} x "
              f"{TRAIN_S} tokens (memory reckoned {reckon[TRAIN_B]:.1f} GB "
              f"at B={TRAIN_B}, limit {TRAIN_MEMORY_GB} GB)")
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
        want.update({k: v * (1 + TRAIN_STEPS) for k, v in
                     predicted_train_launches(cfg, remat=True).items()})
        print(f"  launches in {1 + TRAIN_STEPS} steps: "
              + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
              + (" (as predicted)" if launches == want
                 else f" (expected {want})"))
        if launches != want:
            raise AssertionError(f"{name}: the train step's launches are "
                                 f"not the predicted ones")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"{name} train losses {losses}: not finite "
                                 f"or not falling")
        ms = float(np.median(step_s[1:])) * 1e3
        print(f"  losses {[round(x, 4) for x in losses]}; warm-up step "
              f"{step_s[0] * 1e3:.1f} ms; steps "
              f"{[round(t * 1e3, 1) for t in step_s[1:]]} ms, median "
              f"{ms:.1f} ms, {B * TRAIN_S / ms * 1e3:.0f} tokens/s; peak "
              f"memory {peak_gb:.2f} GB")
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
        del live, loss, grads
        adamw_update(tcfg.opt, tree, state["inner"], params, inplace=True)
        ev[3].record()
        torch.cuda.synchronize()
        split = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
        print(f"  step split (ms): forward {split[0]:.2f}, backward "
              f"{split[1]:.2f}, optimizer {split[2]:.2f}")
        del tree

        def run_steps(n):
            for _ in range(n):
                step(params, state, batch)
        decode_breakdown(run_steps, ms, steps=1,
                         label=f"{name} train step")
        out[name] = launches
        walls[name] = (B, ms)
        del params, state, step
        torch.cuda.empty_cache()
    return out, walls


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


# ---------------------------------------------------------------------------
# the DiT action head (phases 3e, 4b) and the fleet front end (5d, 5e)
# ---------------------------------------------------------------------------

DIT_ARCH = "molmoact-7b-dit"
DIT_TOL = 1e-4       # card vs CPU, f32: sums in other orders
DIT_BF16_TOL = 1e-2  # bf16 head vs the same head in f32, both on the card
DIT_ZERO_LEAVES = ("ada", "final_ada", "out_proj")


def perturb_head(head, gen):
    """The DiT head's zero-initialised leaves set to normal x 0.02 drawn
    from ``gen`` (on the head's device): a head at init returns its input
    noise, so a check of it would be vacuous."""
    import torch
    from repro_torch.models.params import leaves
    for path, t in leaves(head):
        if path.split("/")[-1] in DIT_ZERO_LEAVES:
            t.copy_(0.02 * torch.randn(t.shape, generator=gen,
                                       device=t.device))


def dit_card_vs_cpu():
    """Phase 3e: reduced molmoact-7b-dit (10 denoising steps, horizon 8,
    the head perturbed) on the card (kernels, the DiT loop graph-replayed)
    and on the CPU (plain versions): CoT tokens equal, the trajectory
    within DIT_TOL x max(1, |CPU|), 10 DiT steps."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import vla
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves, set_leaf
    cfg = get_config(DIT_ARCH).reduced()
    cfg = dataclasses.replace(cfg, n_cot_tokens=5, action=dataclasses.replace(
        cfg.action, dit_steps=10, horizon=8))
    p_cpu = M.init_params(cfg, torch.Generator().manual_seed(SEED),
                          torch.float32, device="cpu")
    perturb_head(p_cpu["action_dit"], torch.Generator().manual_seed(SEED + 1))
    p_gpu = {}
    for path, t in leaves(p_cpu):
        set_leaf(p_gpu, path, t.cuda())
    rng = np.random.default_rng(SEED + 5)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 6)),
             "patches": rng.standard_normal(
                 (2, cfg.vision.num_tokens, cfg.vision.embed_dim),
                 dtype=np.float32)}
    noise = rng.standard_normal((2, 8, cfg.action.action_dim),
                                dtype=np.float32)
    og = vla.vla_control_step(cfg, M.ModelOptions(), p_gpu, batch,
                              noise=noise, device="cuda")
    oc = vla.vla_control_step(cfg, M.ModelOptions(), p_cpu, batch,
                              noise=noise, device="cpu")
    if not torch.equal(og.cot_tokens.cpu(), oc.cot_tokens):
        raise AssertionError(f"reduced {DIT_ARCH}: CoT card "
                             f"{og.cot_tokens.tolist()} vs CPU "
                             f"{oc.cot_tokens.tolist()}")
    err = check(f"reduced {DIT_ARCH} trajectory, card vs CPU",
                og.trajectory.cpu(), oc.trajectory, DIT_TOL)
    moved = float((oc.trajectory - torch.from_numpy(noise)).abs().max())
    if og.phase_tokens["action"] != 10 or og.action_tokens is not None \
            or moved < 0.05:
        raise AssertionError(f"reduced {DIT_ARCH}: phase_tokens "
                             f"{og.phase_tokens}, the head moved the noise "
                             f"by {moved}")
    print(f"  reduced {DIT_ARCH}: CoT {oc.cot_tokens.tolist()} equal on card "
          f"and CPU; trajectory {tuple(og.trajectory.shape)} within "
          f"{err:.3g}; 10 DiT steps; the head moves the noise by up to "
          f"{moved:.4f}")


def dit_full_width(cfg, params, discrete_ms):
    """Phase 4b: the full-width molmoact-7b-dit control step (all 28
    layers, phase 4's backbone weights, a seeded bf16 DiT head with its
    zero leaves perturbed), B=4, prompt 640, 144 CoT tokens, 10 DiT steps:
    graphed (``M.DecodeGraph`` + ``M.DiTGraph``, the main path) and eager,
    the same CoT tokens and the trajectory bit for bit, the same kernels
    in the same order in the DiT loop and at most MAX_GRAPH_LAUNCHES host
    launch calls a replayed loop, the bf16 trajectory within
    DIT_BF16_TOL x max(1, |f32|) of the same head in f32; timed phase by
    phase (graphed: median of PHASE_REPEATS; eager: EAGER_REPEATS runs)
    beside phase 4's discrete split
    (``discrete_ms``) and ``simulate_vla``'s, with the DiT loop's wall,
    busy time, idle share and kernels a denoising step, and its byte
    bound."""
    import torch
    from repro_torch.core import vla
    from repro_torch.models import action as A
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params, leaves, set_leaf
    dev = torch.device("cuda")
    opts = M.ModelOptions()
    a = cfg.action
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    head = init_params(A.dit_template(a, cfg.d_model), gen, torch.bfloat16,
                       device=dev)
    perturb_head(head, gen)
    params = dict(params, action_dit=head)
    head_bytes = sum(t.numel() * t.element_size() for _, t in leaves(head))
    tokens = torch.randint(0, cfg.vocab_size, (FULL_B, FULL_TEXT),
                           generator=gen, device=dev)
    patches = torch.randn((FULL_B, cfg.vision.num_tokens,
                           cfg.vision.embed_dim), generator=gen,
                          device=dev).bfloat16()
    noise = torch.randn((FULL_B, a.horizon, a.action_dim), generator=gen,
                        device=dev).bfloat16()
    prompt, n_act, max_seq = vla.control_step_lengths(cfg, FULL_TEXT)
    prefix = M.encode_vision(cfg, opts, params, patches, device=dev)
    batch = {"tokens": tokens, "prefix": prefix}
    graphs = {"graphed": (M.DecodeGraph(dev), M.DiTGraph(dev)),
              "eager": (M.DecodeGraph(dev, eager=True),
                        M.DiTGraph(dev, eager=True))}
    torch.cuda.synchronize()
    kernels = reset_launches()
    out = vla.vla_control_step(cfg, opts, params, batch, device=dev,
                               graph=graphs["graphed"][0],
                               dit_graph=graphs["graphed"][1], noise=noise)
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    want = {"chunk_prefill": cfg.num_layers,
            "decode_attention": cfg.num_layers * cfg.n_cot_tokens,
            "paged_decode_attention": 0, "paged_chunk_prefill": 0,
            "gmm_gated": 0, "gmm_down": 0, "ssd": 0, "flash_attention": 0}
    print(f"  launches on the DiT control step (decode graph-replayed): "
          f"{launches} (expected {want}; the DiT loop runs no kernel of "
          f"the port)")
    traj = out.trajectory
    if launches != want or n_act != 0 \
            or tuple(traj.shape) != (FULL_B, a.horizon, a.action_dim) \
            or not bool(torch.isfinite(traj).all()) \
            or out.phase_tokens["action"] != a.dit_steps:
        raise AssertionError(f"{cfg.name}: launches {launches}, trajectory "
                             f"{tuple(traj.shape)}, phase_tokens "
                             f"{out.phase_tokens}")
    eager = vla.vla_control_step(cfg, opts, params, batch, device=dev,
                                 graph=graphs["eager"][0],
                                 dit_graph=graphs["eager"][1], noise=noise)
    if not (torch.equal(eager.cot_tokens, out.cot_tokens)
            and torch.equal(eager.trajectory, traj)):
        raise AssertionError("graphed and eager DiT control steps differ")
    cond = params["embed"][out.cot_tokens[:, -1]]
    head32 = {"action_dit": {}, "embed": params["embed"]}
    for path, t in leaves(head):
        set_leaf(head32["action_dit"], path, t.float())
    traj32 = M.generate_actions_dit(cfg, head32, cond.float(),
                                    noise=noise.float(), device=dev,
                                    graph=M.DiTGraph(dev, eager=True))
    err = check("bf16 DiT trajectory vs the same head in f32", traj, traj32,
                DIT_BF16_TOL)
    print(f"  graphed and eager DiT control steps: the same "
          f"{cfg.n_cot_tokens} CoT tokens and trajectory bit for bit; the "
          f"head moves the noise by up to "
          f"{float((traj - noise.float()).abs().max()):.4f}; bf16 vs f32 "
          f"{err:.3g}")

    names = ("vision", "prefill", "cot_decode", "action_decode")
    runs = {mode: [] for mode in graphs}
    for rep in range(PHASE_REPEATS):
        for mode, (graph, dit) in graphs.items():
            if mode == "eager" and rep >= EAGER_REPEATS:
                continue
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
            tr = M.generate_actions_dit(cfg, params,
                                        params["embed"][tok[:, 0]],
                                        noise=noise, device=dev, graph=dit)
            ev[4].record()
            torch.cuda.synchronize()
            if not (torch.equal(cot, out.cot_tokens)
                    and torch.equal(tr, traj)):
                raise AssertionError(f"the phase-by-phase DiT run ({mode}) "
                                     f"disagrees with vla_control_step")
            runs[mode].append({n: ev[i].elapsed_time(ev[i + 1])
                               for i, n in enumerate(names)})
            print(f"  DiT run {rep} ({mode}): phases (ms) " + ", ".join(
                f"{n}={t:.2f}" for n, t in runs[mode][-1].items())
                + f", step {sum(runs[mode][-1].values()):.2f}")
    phase_ms = {}
    for mode, rs in runs.items():
        phase_ms[mode] = {n: float(np.median([r[n] for r in rs]))
                          for n in names}
        total = float(np.median([sum(r.values()) for r in rs]))
        share = np.median([r["action_decode"] / sum(r.values()) for r in rs])
        print(f"  {cfg.name} {mode}, median of {len(rs)}: control "
              f"step {total:.2f} ms (" + ", ".join(
                  f"{n} {t:.2f}" for n, t in phase_ms[mode].items())
              + f"); action (DiT) share {share:.4f}")
    print("  DiT vs discrete (graphed, medians, this call): " + ", ".join(
        f"{n} {phase_ms['graphed'][n]:.2f} vs {discrete_ms[n]:.2f} ms"
        for n in names) + f"; step "
        f"{sum(phase_ms['graphed'].values()):.2f} vs "
        f"{sum(discrete_ms.values()):.2f} ms")
    simulated_split(cfg, phase_ms["graphed"])
    dit = graphs["graphed"][1]
    runner = dit.runner
    bound_ms = head_bytes * a.dit_steps / HBM_BYTES_PER_S * 1e3
    print(f"  DiT loop: {a.dit_steps} steps over {head_bytes / 1e6:.1f} MB "
          f"of bf16 weights, byte bound {bound_ms:.4f} ms vs measured "
          f"{phase_ms['graphed']['action_decode']:.3f} ms graphed, "
          f"{phase_ms['eager']['action_decode']:.3f} ms eager; captures "
          f"{runner.captures}, {runner.capture_s / runner.captures * 1e3:.1f}"
          f" ms a capture")
    graph_step_checks("DiT loop", runner, reset=lambda: None)

    def run_loops(n):
        for _ in range(n):
            runner.step(runner.key)
    res = decode_breakdown(run_loops, phase_ms["graphed"]["action_decode"],
                           label="DiT loop (graphed)")
    if res is not None:
        print(f"  DiT loop: {res[1] / a.dit_steps:.1f} kernels a denoising "
              f"step")
    return phase_ms["graphed"]["action_decode"]


def frontend_card_vs_cpu(cfg_full):
    """Phase 5d: the front end over two replicas of reduced molmoact-7b
    (paged f32, chunked, ticks offloaded to two threads) on the card. The
    front end's start captures each replica's tick, vision and chunk
    graphs, one replica after the other, and seals them; then six
    observations go in at once, so that both replicas
    tick side by side on two threads; their twins follow once they
    finished (prefix routing); then a request cancelled mid-decode.
    Gates: every stream equals the same request's on one synchronous CPU
    engine of the port; each replica captured each graph once, before its
    driver started, with only its own step's launches recorded, and
    nothing raises; each replica's replays that ran its tick's body are
    its device steps; some ticks of the two replicas overlapped in time on
    two
    threads; each wrapper's launches equal the capture steps' and prefill
    chunks' eager launches plus replays x recorded; routed_prefix >= 1;
    the cancel returns the pool to its baseline. Then the serve driver
    once, front-end mode, its default arch (qwen1.5-0.5b) reduced."""
    import asyncio
    import threading
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves, set_leaf
    from repro_torch.serving import AsyncFrontend, Request, ServingEngine
    cfg = cfg_full.reduced()
    p_cpu = M.init_params(cfg, torch.Generator().manual_seed(SEED + 7),
                          torch.float32, device="cpu")
    p_gpu = {}
    for path, t in leaves(p_cpu):
        set_leaf(p_gpu, path, t.cuda())
    kw = dict(n_slots=2, max_seq=128, eos=-1, tick_tokens=4, paged=True,
              page_size=PAGE, chunked_prefill=True, chunk_size=PAGE,
              token_budget=64)
    rng = np.random.default_rng(SEED + 8)
    obs = [(rng.integers(0, cfg.vocab_size, n, dtype=np.int32), m,
            rng.standard_normal((cfg.vision.num_tokens,
                                 cfg.vision.embed_dim), dtype=np.float32))
           for n, m in ((40, 9), (52, 6), (30, 12), (45, 7), (36, 10),
                        (60, 5))]
    reqs = obs + obs
    long_req = (rng.integers(0, cfg.vocab_size, 30, dtype=np.int32), 60,
                rng.standard_normal((cfg.vision.num_tokens,
                                     cfg.vision.embed_dim),
                                    dtype=np.float32))
    sync = ServingEngine(cfg, M.ModelOptions(), p_cpu, device="cpu", **kw)
    for i, (p, m, px) in enumerate(reqs):
        sync.submit(Request(uid=i, prompt=p, max_tokens=m, patches=px))
    want = {r.uid: r.out_tokens for r in sync.run()}
    kernels = reset_launches()
    ticks = []          # (replica, thread, start, end) of offloaded ticks

    def traced(i, tick):
        def step_fused():
            t0 = time.perf_counter()
            try:
                return tick()
            finally:
                ticks.append((i, threading.get_ident(), t0,
                              time.perf_counter()))
        return step_fused

    async def go():
        engines = [ServingEngine(cfg, M.ModelOptions(), p_gpu,
                                 device="cuda", **kw) for _ in range(2)]
        for i, e in enumerate(engines):
            e.step_fused = traced(i, e.step_fused)
        async with AsyncFrontend(engines, offload_ticks=True) as fe:
            at_start = [graph_captures(e) for e in engines]
            outs = []
            for wave in (reqs[:6], reqs[6:]):
                streams = [await fe.submit(p, m, patches=px)
                           for p, m, px in wave]
                outs += [await s.tokens() for s in streams]
            base = [e.pool.pages_in_use for e in engines]
            stream = await fe.submit(*long_req[:2], patches=long_req[2])
            got = []
            async for t in stream:
                got.append(t)
                if len(got) == 3:
                    stream.cancel()
            await fe.drain()
            after = [e.pool.pages_in_use for e in engines]
        return engines, fe, at_start, outs, stream, got, base, after

    engines, fe, at_start, outs, stream, got, base, after = asyncio.run(go())
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    n_attn = cfg.num_layers
    steps = [tick_bodies(e) for e in engines]
    runs = [e.stats.prefill_key_lanes_full // (PAGE * 128)
            + chunk_warmups(e) for e in engines]
    runners = [e._tick.graph for e in engines]
    decode = kernels["paged_decode_attention"]
    eager_decode = sum(r.captures * n_attn for r in runners)
    # pairs of ticks of the two replicas that overlapped in time (on two
    # threads: one thread runs one tick at a time), and for how long
    overlaps = [min(a[3], b[3]) - max(a[2], b[2])
                for a in ticks if a[0] == 0 for b in ticks if b[0] == 1
                if a[1] != b[1] and min(a[3], b[3]) > max(a[2], b[2])]
    rep = fe.stats.report()
    gates = {
        "every stream equals the synchronous CPU engine's":
            outs == [want[i] for i in range(len(reqs))],
        "each replica captured its tick, vision and chunk graphs once, "
        "before its driver started":
            at_start == [graph_captures(e) for e in engines]
            == [(1, 1, 1), (1, 1, 1)],
        "each replica's replays that ran == its device steps":
            all(e._tick.graph.replays_ran == e.stats.device_steps
                for e in engines),
        "each capture recorded only its own step's launches":
            all(r.recorded == {decode: n_attn} for r in runners),
        "ticks of the two replicas overlapped on two threads":
            len(overlaps) >= 1,
        "paged_decode_attention launches == warm-ups + replays that ran x "
        "recorded == layers x tick steps run":
            launches["paged_decode_attention"] == eager_decode + sum(
                r.replays_ran * r.recorded.get(decode, 0) for r in runners)
            == n_attn * sum(steps),
        "paged_chunk_prefill launches == layers x (chunk runs + masked "
        "capture chunks)":
            launches["paged_chunk_prefill"] == n_attn * sum(runs),
        "no other kernel launched": not any(
            v for k, v in launches.items()
            if k not in ("paged_decode_attention", "paged_chunk_prefill")),
        "routed_prefix >= 1": rep["routed_prefix"] >= 1,
        "a cancel mid-decode returns the pool to its baseline":
            stream.cancelled and 3 <= len(got) < 60 and after == base
            and all(e.pending == 0 for e in engines),
    }
    print(f"  front end, 2 replicas (reduced, paged f32 chunked, ticks "
          f"offloaded): {rep['completed']} completed, {rep['cancelled']} "
          f"cancelled; routed prefix {rep['routed_prefix']} / load "
          f"{rep['routed_load']} / rejected {rep['rejected']}; captures "
          f"{[r.captures for r in runners]} (at start "
          f"{at_start}, "
          f"{[round(r.capture_s * 1e3, 1) for r in runners]} ms), replays "
          f"{[r.replays for r in runners]}; ticks "
          f"{[sum(t[0] == i for t in ticks) for i in range(2)]} on "
          f"{len({t[1] for t in ticks})} threads, {len(overlaps)} pairs of "
          f"the two replicas' ticks overlapped for "
          f"{sum(overlaps) * 1e3:.1f} ms in all; launches {launches}; pages "
          f"{base} -> {after}")
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise AssertionError(f"front end (reduced): {failed}")
    frontend_new_length_midrun(cfg, p_cpu, p_gpu)
    streams = serve.main(["--reduced", "--frontend", "--replicas", "2",
                          "--paged", "--chunked-prefill", "--requests", "6",
                          "--max-tokens", "8", "--prompt-len", "40"])
    if len(streams) != 6 or any(len(s.request.out_tokens) != 8
                                for s in streams):
        raise AssertionError("the serve driver's streams are short")


def frontend_new_length_midrun(cfg, p_cpu, p_gpu):
    """Phase 5d, a prompt length first seen mid-run: two admit-stall
    replicas (reduced molmoact-7b, paged f32, 3 slots) behind the front
    end on two threads. Four requests of one prompt length start both
    replicas decoding; once each has streamed tokens, two requests of a
    second length arrive while both tick. Admission runs its prefill
    kernel by kernel, and the front end's start captured every graph the
    replicas replay and sealed them, so nothing captures mid-run (a sealed
    runner would raise). Gates: every stream equals one synchronous CPU
    engine's; each replica's tick and vision graphs were captured once,
    before the drivers started, and never again; each replica's replays
    that ran its tick's body are its device steps; ticks of the two
    replicas overlapped on two threads; launches follow from the device
    steps, the capture's warm-up step and the admissions."""
    import asyncio
    import threading
    import torch
    from repro_torch.models import model as M
    from repro_torch.serving import AsyncFrontend, Request, ServingEngine
    kw = dict(n_slots=3, max_seq=128, eos=-1, tick_tokens=4, paged=True,
              page_size=PAGE)
    rng = np.random.default_rng(SEED + 13)
    n_vis, emb = cfg.vision.num_tokens, cfg.vision.embed_dim
    first = [(rng.integers(0, cfg.vocab_size, 40, dtype=np.int32), 48,
              rng.standard_normal((n_vis, emb), dtype=np.float32))
             for _ in range(4)]
    second = [(rng.integers(0, cfg.vocab_size, 52, dtype=np.int32), 12,
               rng.standard_normal((n_vis, emb), dtype=np.float32))
              for _ in range(2)]
    reqs = first + second
    sync = ServingEngine(cfg, M.ModelOptions(), p_cpu, device="cpu", **kw)
    for i, (p, m, px) in enumerate(reqs):
        sync.submit(Request(uid=i, prompt=p, max_tokens=m, patches=px))
    want = {r.uid: r.out_tokens for r in sync.run()}
    kernels = reset_launches()
    ticks = []

    def traced(i, fn):
        def run(*a):
            t0 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                ticks.append((i, threading.get_ident(), t0,
                              time.perf_counter()))
        return run

    async def go():
        engines = [ServingEngine(cfg, M.ModelOptions(), p_gpu,
                                 device="cuda", **kw) for _ in range(2)]
        for i, e in enumerate(engines):
            e.step_fused = traced(i, e.step_fused)
        async with AsyncFrontend(engines, offload_ticks=True) as fe:
            at_start = [graph_captures(e) for e in engines]
            streams = [await fe.submit(p, m, patches=px)
                       for p, m, px in first]
            its = [s.__aiter__() for s in streams]
            for it in its:                  # every replica is decoding
                await it.__anext__()
                await it.__anext__()
            late = [await fe.submit(p, m, patches=px) for p, m, px in second]
            for it in its:
                async for _ in it:
                    pass
            outs = [await s.tokens() for s in late]
            await fe.drain()
        return engines, streams, outs, at_start

    engines, streams, outs, at_start = asyncio.run(go())
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    got = [s.request.out_tokens for s in streams] + outs
    L = cfg.num_layers
    lengths = [sorted({n_vis + len(r.prompt) for r in e.finished})
               for e in engines]
    overlaps = [1 for a in ticks if a[0] == 0 for b in ticks if b[0] == 1
                if a[1] != b[1] and min(a[3], b[3]) > max(a[2], b[2])]
    gates = {
        "every stream equals the synchronous CPU engine's":
            got == [want[i] for i in range(len(reqs))],
        "each replica's tick and vision graphs captured once, before its "
        "driver started, and never again":
            at_start == [graph_captures(e) for e in engines]
            == [(1, 1, 0), (1, 1, 0)],
        "the second length reached a replica mid-run":
            any(len(n) == 2 for n in lengths),
        "each replica's replays that ran == its device steps":
            all(e._tick.graph.replays_ran == e.stats.device_steps
                for e in engines),
        "ticks of the two replicas overlapped on two threads":
            len(overlaps) >= 1,
        "decode launches == layers x (capture warm-up + device steps)":
            launches["paged_decode_attention"]
            == L * sum(tick_bodies(e) for e in engines),
        "chunk_prefill launches == layers x admissions":
            launches["chunk_prefill"] == L * len(reqs),
    }
    print(f"  front end, 2 admit-stall replicas, a prompt length first seen "
          f"mid-run: lengths admitted {lengths}; (tick, vision, chunk) "
          f"captures {[graph_captures(e) for e in engines]}, at start "
          f"{at_start}; {len(overlaps)} pairs of ticks overlapped; launches "
          f"{launches}")
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise AssertionError(f"front end (a length first seen mid-run): "
                             f"{failed}")


FLEET = dict(n_robots=8, steps_per_robot=4, control_hz=10.0,
             arrival_rate=4.0, action_tokens=48, seed=0)
FLEET_TIMEOUT_S = 240      # the replay's trace spans ~2.5 s


def fleet_full(cfg, params):
    """Phase 5e: two full-width replicas of molmoact-7b's backbone
    (SERVE_LAYERS layers, one set of weights; the trace's prompts are
    tokens only) behind the front end, paged f32 chunked
    (chunk 128, budget 256, pages of 32), 8 slots, max_seq 864, slo_hz 10,
    graphed, ticks offloaded, replaying ``fleet_trace`` in real time.
    Gates: every accepted request finishes with its tokens, within the
    vocabulary; each replica captures once; the kernels' launches follow
    from the replicas' steps and chunk runs. Reported: client TTFT and
    latency, 10 Hz SLO attainment, routing, tokens/s, each replica's
    decode-tick percentiles, and the share of tokens equal to the same
    requests served by one synchronous engine (near ties flip in bf16, so
    not a gate)."""
    import asyncio
    import torch
    from repro_torch.core.workload import fleet_trace
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serving import AsyncFrontend, Request, ServingEngine
    t_phase = time.perf_counter()
    cfg, params = first_layers(cfg, params, SERVE_LAYERS)
    # the trace's context tokens stand for the robot's camera frame and
    # instruction (``fleet_trace``), so the replicas serve the backbone
    # alone: no request carries patches for the tower
    cfg = dataclasses.replace(cfg, vision=None)
    kw = dict(n_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, eos=-1,
              tick_tokens=SERVE_TICK, paged=True, slo_hz=10.0,
              device="cuda", **CHUNKED)
    trace = fleet_trace(ctx_max=SERVE_MAX_SEQ - FLEET["action_tokens"] - 8,
                        vocab_size=cfg.vocab_size, **FLEET)
    kernels = reset_launches()

    async def go():
        engines = [ServingEngine(cfg, M.ModelOptions(), params, **kw)
                   for _ in range(2)]
        async with AsyncFrontend(engines, offload_ticks=True) as fe:
            served, wall = await asyncio.wait_for(
                serve.replay_fleet(fe, trace), FLEET_TIMEOUT_S)
        return engines, fe, served, wall

    engines, fe, served, wall = asyncio.run(go())
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    rep = fe.stats.report()
    met, ctrl_met = serve.fleet_slo(served)
    n_ctrl = sum(e.kind == "control" for e, _ in served)
    toks = sum(len(s.request.out_tokens) for _, s in served)
    steps = sum(tick_bodies(e) for e in engines)
    runs = sum(e.stats.prefill_key_lanes_full // (CHUNK_SIZE * SERVE_MAX_SEQ)
               + chunk_warmups(e) for e in engines)
    print(f"  fleet replay ({len(trace)} requests of {FLEET['n_robots']} "
          f"robots at {FLEET['control_hz']:g} Hz, 2 replicas of "
          f"{SERVE_LAYERS} layers): {len(served)} accepted, "
          f"{rep['rejected']} rejected; {toks} tokens in {wall:.3f} s "
          f"({toks / wall:.2f} tokens/s); client TTFT p50/p99 "
          f"{rep['ttft_p50_s'] * 1e3:.2f}/{rep['ttft_p99_s'] * 1e3:.2f} ms, "
          f"latency p50/p99 {rep['latency_p50_s'] * 1e3:.2f}/"
          f"{rep['latency_p99_s'] * 1e3:.2f} ms; in deadline "
          f"{met}/{len(served)}, control steps {ctrl_met}/{n_ctrl} at "
          f"{FLEET['control_hz']:g} Hz ({ctrl_met / max(n_ctrl, 1):.4f}); "
          f"routed prefix {rep['routed_prefix']} / load "
          f"{rep['routed_load']}")
    for i, e in enumerate(engines):
        ph = e.stats.phase_report()
        print(f"  replica {i}: captures {e._tick.graph.captures} "
              f"({e._tick.graph.capture_s * 1e3:.1f} ms), ticks "
              f"{e.stats.ticks}, decode tick p50/p99 "
              f"{ph['decode_tick_p50'] * 1e3:.2f}/"
              f"{ph['decode_tick_p99'] * 1e3:.2f} ms, tokens "
              f"{e.stats.tokens_decoded}, prefill_tokens "
              f"{e.stats.prefill_tokens}, skipped {e.stats.prefill_skipped}, "
              f"prefix_hits {e.stats.prefix_hits}; " + ", ".join(
                  f"{k} {v:.4f}" for k, v in ph.items()
                  if k.startswith(("deadline_attainment", "preemptions"))))
    gates = {
        "every accepted request finishes with its tokens": all(
            not s.cancelled and len(s.request.out_tokens) == e.max_tokens
            and all(0 <= t < cfg.vocab_size for t in s.request.out_tokens)
            for e, s in served) and rep["completed"] == len(served),
        "each replica captures its tick and chunk graphs once (no tower)":
            [graph_captures(e) for e in engines] == [(1, 0, 1), (1, 0, 1)],
        "each replica's replays that ran == its device steps":
            all(e._tick.graph.replays_ran == e.stats.device_steps
                for e in engines),
        "paged_decode_attention launches == layers x tick steps run":
            launches["paged_decode_attention"] == SERVE_LAYERS * steps,
        "paged_chunk_prefill launches == layers x (chunk runs + masked "
        "capture chunks)":
            launches["paged_chunk_prefill"] == SERVE_LAYERS * runs,
    }
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise AssertionError(f"fleet replay: {failed}")
    del engines
    torch.cuda.empty_cache()
    sync = ServingEngine(cfg, M.ModelOptions(), params, **kw)
    for i, (e, _) in enumerate(served):
        sync.submit(Request(uid=i, prompt=e.prompt, max_tokens=e.max_tokens,
                            priority=e.priority))
    ref = {r.uid: r.out_tokens for r in sync.run()}
    out = {i: s.request.out_tokens for i, (_, s) in enumerate(served)}
    print(f"  fleet replay: share of tokens equal to one synchronous "
          f"engine's streams {stream_share(out, ref):.4f} (reported, not a "
          f"gate); phase 5e took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# the reference's other architectures (phases 2e, 3f and 10): granite-3-2b
# (GQA 32/8, tied embeddings), internvl2-1b (a 24-layer ViT tower, qkv
# bias), gemma3-27b (5:1 local:global; ring caches under window_cache) and
# whisper-small (encoder-decoder: absolute positions, layer norm, cross
# attention). No kernel is new: ring decode and cross decode are the
# split-key decode kernel (row 1) at another index, and a ring prefill of
# the whole window runs the flash kernel (row 5).
# ---------------------------------------------------------------------------

GRANITE, INTERNVL, GEMMA, WHISPER = ("granite-3-2b", "internvl2-1b",
                                     "gemma3-27b", "whisper-small")
GEMMA_LAYERS = 6     # gemma3-27b cut to one 5:1 period: 5 local, 1 global
ARCH_SLOTS, ARCH_NEW = 8, 64       # the engines' slots; tokens a request
GRANITE_PROMPT, INTERNVL_TEXT = 256, 64   # internvl2: after 256 patches
GRANITE_ENGINES = [("granite-paged-f32", dict(paged=True)),
                   ("granite-paged-f32-chunked", dict(CHUNKED, paged=True))]
# gemma3-27b, model level: B=2, a prefill of its window (1024 tokens), then
# 256 decode steps (the ring wraps at the first); engine level: 8 requests
# with prompts of 256-1024, each decoding to position GEMMA_END - 2, past
# the ring's 1024 rows
GEMMA_B, GEMMA_PREFILL, GEMMA_STEPS, GEMMA_FORCED = 2, 1024, 256, 32
GEMMA_PROMPTS = (256, 384, 512, 640, 768, 896, 1000, 1024)
GEMMA_END, GEMMA_MAX_SEQ = 1100, 1120
# whisper-small: B=4 over 1500 frames, a 4-token prompt, 220 decode steps
WHISPER_B, WHISPER_PROMPT, WHISPER_STEPS = 4, 4, 220


def gemma_cut(cfg):
    return dataclasses.replace(cfg, num_layers=GEMMA_LAYERS)


def hold(label: str, gates) -> None:
    """Raise unless every gate of ``gates`` ({description: bool}) held."""
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise AssertionError(f"{label}: {failed}")
    print(f"  {label}: all {len(gates)} gates held")


def timed_route(label: str, fn, plain, nbytes: float, ops: float, dtype):
    """A route's device ms a call (CUDA events, its inputs reused) beside
    its plain version's and the bound of its bytes and operations."""
    ms, plain_ms = time_ms(fn, 50), time_ms(plain, 5, warmup=1)
    least, by = bound(nbytes, ops, dtype)
    print(f"  {label}: {ms:.4f} ms a call, plain {plain_ms:.4f} ms, bound "
          f"{least:.4f} ms ({by}), {ms / least:.1f}x the bound")


def arch_kernel_checks():
    """Phase 2e: the new paths' routes through rows 1 and 5 against their
    plain versions at the full widths' shapes. Ring decode
    (``decode_ring``: the split-key kernel at min(index, W - 1), no
    window): gemma3-27b's heads (G = 2 at h = 128) over a ring of W = 1024
    rows (the kernel's S == W), per-slot indices before, at and past the
    wrap, against ``attention_decode_ring``. Cross decode
    (``decode_cross``: the kernel at the last context row): whisper-small's
    12 heads at h = 64 over its 1500 frames (not a multiple of the
    128-key split), against the reference's non-causal dense core. Both in
    bf16 and f32 storage. The flash kernel at gemma3's ring prefill: S = W
    = 1024 with the window 1024, bf16. Each also timed beside its plain
    version and its bound."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    opts = L.ModelOptions()

    def rand(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    gcfg, wcfg = get_config(GEMMA), get_config(WHISPER)
    N, K, h = gcfg.num_heads, gcfg.num_kv_heads, gcfg.head_dim
    W = gcfg.window_pattern[0]
    idx = torch.tensor((0, 500, W - 1, W, W + 76, 2 * W - 1, 3 * W,
                        4 * W + 5), dtype=torch.int32, device=dev)
    B = len(idx)
    wN, wK, wh = wcfg.num_heads, wcfg.num_kv_heads, wcfg.head_dim
    T = wcfg.encoder.num_tokens
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).replace("torch.", "")
        q = rand(B, 1, N, h, dtype=dtype)
        kc, vc = rand(B, W, K, h, dtype=dtype), rand(B, W, K, h, dtype=dtype)

        def ring(q=q, kc=kc, vc=vc):
            return L.run_attention_core("decode_ring", q, kc, vc, opts=opts,
                                        window=W, index=idx)

        def ring_plain(q=q, kc=kc, vc=vc):
            return L.attention_decode_ring(q.float(), kc.float(),
                                           vc.float(), idx)
        check(f"ring decode ({GEMMA} heads {N}/{K}, h={h}, W={W}, B={B}, "
              f"indices {idx.tolist()}, {dt})", ring(), ring_plain(),
              KERNEL_TOL)
        timed_route(f"ring decode {dt}", ring, ring_plain,
                    2 * kc.numel() * kc.element_size()
                    + 2 * q.numel() * q.element_size(), 4 * B * N * W * h,
                    dtype)
        q = rand(WHISPER_B, 1, wN, wh, dtype=dtype)
        xk = rand(WHISPER_B, T, wK, wh, dtype=dtype)
        xv = rand(WHISPER_B, T, wK, wh, dtype=dtype)

        def cross(q=q, xk=xk, xv=xv):
            return L.run_attention_core("decode_cross", q, xk, xv,
                                        opts=opts, window=0, causal=False)

        def cross_plain(q=q, xk=xk, xv=xv):
            return L.attention_dense(q.float(), xk.float(), xv.float(),
                                     torch.arange(1, device=dev),
                                     torch.arange(T, device=dev), 0,
                                     causal=False)
        check(f"cross decode ({WHISPER} heads {wN}/{wK}, h={wh}, T={T}, "
              f"B={WHISPER_B}, {dt})", cross(), cross_plain(), KERNEL_TOL)
        timed_route(f"cross decode {dt}", cross, cross_plain,
                    2 * xk.numel() * xk.element_size()
                    + 2 * q.numel() * q.element_size(),
                    4 * WHISPER_B * wN * T * wh, dtype)
    S = GEMMA_PREFILL
    q = rand(GEMMA_B, S, N, h, dtype=torch.bfloat16)
    k, v = (rand(GEMMA_B, S, K, h, dtype=torch.bfloat16) for _ in range(2))
    pos = torch.arange(S, device=dev)

    def flash():
        return L.run_attention_core("fresh_flash", q, k, v, opts=opts,
                                    window=W, causal=True, q_pos=pos,
                                    k_pos=pos)

    def flash_plain():
        return L.attention_dense(q.float(), k.float(), v.float(), pos, pos,
                                 W)
    check(f"flash attention, the ring prefill ({GEMMA} heads, B={GEMMA_B}, "
          f"S = W = {S}, bf16)", flash(), flash_plain(), KERNEL_TOL)
    timed_route(f"flash attention S = W = {S} bf16", flash, flash_plain,
                2 * (q.numel() + k.numel() + v.numel()),
                2 * GEMMA_B * N * S * S * h, torch.bfloat16)


def arch_card_vs_cpu():
    """Phase 3f: the reduced forms on the card (kernels) and on the CPU
    (plain versions), with f32 weights: the engines' greedy streams equal
    (``engines_card_vs_cpu``: granite-3-2b and internvl2-1b, the latter
    with patches, dense and paged f32; gemma3-27b in 6 layers, with ring
    caches and with full ones, budgets past the ring's 32 rows); and
    whisper-small's prefill logits within CPU_LOGIT_TOL and its greedy
    ``decode_loop`` streams equal."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves, set_leaf

    def params_pair(cfg):
        p_cpu = M.init_params(cfg, torch.Generator().manual_seed(SEED),
                              torch.float32, device="cpu")
        p_gpu = {}
        for path, t in leaves(p_cpu):
            set_leaf(p_gpu, path, t.cuda())
        return p_cpu, p_gpu
    rng = np.random.default_rng(SEED + 12)
    for name in (GRANITE, INTERNVL, GEMMA):
        cfg = get_config(name).reduced()
        shape = ((6, 9), (9, 4), (4, 14), (7, 6), (5, 11))
        if name == GEMMA:
            cfg = gemma_cut(cfg)
            shape = ((6, 30), (9, 5), (20, 18), (3, 12))
        p_cpu, p_gpu = params_pair(cfg)
        reqs = [(rng.integers(0, cfg.vocab_size, n, dtype=np.int32), m,
                 None if cfg.vision is None else rng.standard_normal(
                     (cfg.vision.num_tokens, cfg.vision.embed_dim),
                     dtype=np.float32)) for n, m in shape]
        if name == GEMMA:
            for ring in (True, False):
                engines_card_vs_cpu(
                    cfg, p_cpu, p_gpu,
                    [(f"{cfg.name}, {'ring' if ring else 'full'} caches",
                      {}, reqs, 64)], n_slots=2,
                    opts=M.ModelOptions(window_cache=ring))
        else:
            engines_card_vs_cpu(cfg, p_cpu, p_gpu,
                                [(f"{cfg.name}, dense", {}, reqs, 64),
                                 (f"{cfg.name}, paged-f32",
                                  dict(paged=True), reqs, 64)], n_slots=2)
    cfg = get_config(WHISPER).reduced()
    p_cpu, p_gpu = params_pair(cfg)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 4)),
             "frames": rng.standard_normal(
                 (2, cfg.encoder.num_tokens, cfg.encoder.embed_dim),
                 dtype=np.float32)}
    out = {}
    for params, dev in ((p_gpu, "cuda"), (p_cpu, "cpu")):
        opts = M.ModelOptions()
        logits, caches = M.prefill(cfg, opts, params, batch, 32, device=dev)
        toks, _, _ = M.decode_loop(cfg, opts, params,
                                   logits[:, -1].argmax(-1, keepdim=True),
                                   caches, 4, 20, device=dev)
        out[dev] = (logits.cpu(), toks.cpu())
    check(f"{cfg.name} prefill logits, card vs CPU", out["cuda"][0],
          out["cpu"][0], CPU_LOGIT_TOL)
    if not torch.equal(out["cuda"][1], out["cpu"][1]):
        raise AssertionError(f"{cfg.name} decode_loop: card "
                             f"{out['cuda'][1].tolist()} vs CPU "
                             f"{out['cpu'][1].tolist()}")
    print(f"  {cfg.name}: decode_loop streams equal on card and CPU "
          f"({out['cpu'][1].numel()} tokens)")


def arch_engine(cfg, opts, params, name: str, kw, reqs, max_seq: int,
                expected, graphs: bool = True):
    """``reqs`` ([(prompt, max_tokens, patches)]) through one full-width
    engine on the card, its tick step replayed from a CUDA graph or
    (``graphs=False``) run eagerly; prints its serving row and returns
    (engine, {uid: tokens}, launches, gates). ``expected(engine)`` gives
    the kernels' launches the run must show (others: none). The engine's
    graphs are captured first (``capture``). Gates: every request ends
    with its budget (eos never fires); the launches; one readback a
    decode tick and one a request's first token; a paged pool drains;
    graphed, ``guard_gates``."""
    import gc
    import torch
    from repro_torch.serving import Request, ServingEngine
    torch.cuda.synchronize()
    gc.collect()            # an engine's graphs and buffers form cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels = reset_launches()
    eng = ServingEngine(cfg, opts, params, n_slots=ARCH_SLOTS,
                        max_seq=max_seq, eos=-1, tick_tokens=SERVE_TICK,
                        device="cuda", graphs=graphs, **kw)
    eng.capture()
    for i, (prompt, m, px) in enumerate(reqs):
        eng.submit(Request(uid=i, prompt=prompt, max_tokens=m, patches=px))
    t0 = time.perf_counter()
    out = {r.uid: r.out_tokens for r in eng.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(kernels)
    want = expected(eng)
    want = {k: want.get(k, 0) for k in launches}
    st, rep = eng.stats, eng.stats.phase_report()
    n_tok = sum(map(len, out.values()))
    print(f"  {name} ({'graphed' if graphs else 'eager'}): {len(out)} "
          f"requests, {n_tok} tokens in {wall:.3f} s ({n_tok / wall:.2f} "
          f"tokens/s); ticks {st.ticks}, device steps {st.device_steps}, "
          f"masked steps {eng.masked_steps}; TTFT p50/p99 "
          f"{rep['ttft_p50'] * 1e3:.2f}/{rep['ttft_p99'] * 1e3:.2f} ms; "
          f"decode tick p50/p99 {rep['decode_tick_p50'] * 1e3:.2f}/"
          f"{rep['decode_tick_p99'] * 1e3:.2f} ms; phases vision "
          f"{st.vision_time:.3f} s prefill {st.prefill_time:.3f} s decode "
          f"{st.decode_time:.3f} s; pages_hwm {st.pages_hwm}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
          f"{launches}")
    gates = {
        "every request ends with its budget":
            len(out) == len(reqs) and all(
                len(out[i]) == m for i, (_, m, _) in enumerate(reqs)),
        f"launches == {want}": launches == want,
        "one readback per decode tick":
            st.decode_syncs == len(st.decode_tick_s) <= st.ticks,
        "one first-token readback per request":
            st.prefill_syncs == len(reqs),
    }
    gates.update(guard_gates(eng))
    if eng.paged:
        gates["pages_in_use == 0 at drain"] = st.pages_in_use == 0
    return eng, out, launches, gates


def arch_serve_both(cfg, opts, params, name: str, kw, reqs, max_seq: int,
                    expected, breakdown: bool = True):
    """``arch_engine`` graph-replayed (the main path), then eagerly (the
    oracle): both runs' gates, the same streams and launches, a replayed
    tick step running the eager step's kernels in order with at most
    MAX_GRAPH_LAUNCHES host launch calls (``graph_step_checks``), and
    (``breakdown``) the tick step's wall, device-busy time, idle share
    and kernels a step in both modes (``tick_breakdown``). Returns the
    graphed run's (launches, streams)."""
    eng, out, launches, gates = arch_engine(cfg, opts, params, name, kw,
                                            reqs, max_seq, expected)
    tick = eng._tick
    graph_step_checks(f"{name} tick step", tick.graph,
                      reset=live_carry(eng), state=lambda: carry(tick))
    eager, out_e, launches_e, gates_e = arch_engine(
        cfg, opts, params, name, kw, reqs, max_seq, expected, graphs=False)
    gates.update({f"eager: {k}": ok for k, ok in gates_e.items()})
    gates["graphed streams equal eager streams"] = out == out_e
    # the expected launches differ by the eager masked steps, the
    # capture's warm-up step and masked chunks (``tick_bodies``)
    want, want_e = expected(eng), expected(eager)
    gates["graphed device steps == eager device steps"] = \
        eng.stats.device_steps == eager.stats.device_steps
    gates["graphed launches == eager launches - eager masked steps' + "
          "capture warm-up's and masked chunks'"] = all(
        launches[k] - launches_e[k] == want.get(k, 0) - want_e.get(k, 0)
        for k in launches)
    hold(f"{name}, graphed and eager", gates)
    g, e = eng.stats, eager.stats
    print(f"  {name}, graphed vs eager: wall decode {g.decode_time:.3f} vs "
          f"{e.decode_time:.3f} s; decode tick p50 "
          f"{np.percentile(g.decode_tick_s, 50) * 1e3:.2f} vs "
          f"{np.percentile(e.decode_tick_s, 50) * 1e3:.2f} ms; one capture "
          f"{tick.graph.capture_s * 1e3:.1f} ms")
    del eager
    if breakdown:
        tick_breakdown(eng, name)
    return launches, out


def seeded_prompts(vocab: int, lengths, seed: int):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randint(0, vocab, (n,), generator=gen, device="cuda")
            .cpu().numpy().astype(np.int32) for n in lengths]


def granite_full(cfg, params):
    """granite-3-2b at full width, its first GRANITE_LAYERS layers (bf16): 8 requests
    of GRANITE_PROMPT tokens, ARCH_NEW new tokens each, on 8 slots,
    through admit-stall paged f32 and chunked paged f32 (chunks of
    CHUNK_SIZE, TOKEN_BUDGET a tick). Launches: the paged decode kernel
    once a layer a tick step; admit-stall, the dense chunk kernel once a
    layer a request (its batch-1 prefill); chunked, the paged chunk
    kernel once a layer a chunk run."""
    from repro_torch.models import model as M
    L = cfg.num_layers
    reqs = [(p, ARCH_NEW, None) for p in seeded_prompts(
        cfg.vocab_size, [GRANITE_PROMPT] * ARCH_SLOTS, SEED + 14)]
    max_seq = GRANITE_PROMPT + ARCH_NEW
    out = {}
    for name, kw in GRANITE_ENGINES:
        def expected(eng):
            steps = tick_bodies(eng)
            if eng.scheduler is None:
                return {"paged_decode_attention": L * steps,
                        "chunk_prefill": L * len(reqs)}
            runs = eng.stats.prefill_key_lanes_full // (CHUNK_SIZE
                                                        * max_seq)
            return {"paged_decode_attention": L * steps,
                    "paged_chunk_prefill": L * (runs + chunk_warmups(eng))}
        # the chunked engine's tick step is the admit-stall one's
        out[name] = arch_serve_both(cfg, M.ModelOptions(), params, name, kw,
                                    reqs, max_seq, expected,
                                    breakdown=not kw.get("chunked_prefill"))[0]
    return out


def internvl_full(cfg, params):
    """internvl2-1b at full width and depth (24 LM layers, the 24-layer
    ViT tower over 256 patches, bf16): 8 requests of 256 patches and
    INTERNVL_TEXT text tokens, ARCH_NEW new tokens each, admit-stall on
    the dense layout; the vision stage's time is the row's ``vision``."""
    import torch
    from repro_torch.models import model as M
    L = cfg.num_layers
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    reqs = [(p, ARCH_NEW, torch.randn(
        (cfg.vision.num_tokens, cfg.vision.embed_dim), generator=gen,
        device="cuda").cpu().numpy()) for p in seeded_prompts(
            cfg.vocab_size, [INTERNVL_TEXT] * ARCH_SLOTS, SEED + 16)]
    max_seq = cfg.vision.num_tokens + INTERNVL_TEXT + ARCH_NEW

    def expected(eng):
        steps = tick_bodies(eng)
        return {"decode_attention": L * steps, "chunk_prefill": L * len(reqs)}
    return {"internvl-dense": arch_serve_both(
        cfg, M.ModelOptions(), params, "internvl-dense", {}, reqs, max_seq,
        expected)[0]}


def loop_runs(cfg, opts, params, prefill, start: int, n: int, label: str,
              expected):
    """A model-level path, graphed and eager: ``prefill()`` -> (logits,
    caches), then ``n`` greedy steps of ``decode_loop`` from ``start``
    through a ``DecodeGraph``, the launches counted from the prefill on.
    Gates: the same tokens in both modes, finite prefill logits,
    ``expected`` launches, one capture, graphed = eager kernels a step and
    host launch calls (``graph_step_checks``). Prints prefill ms, ms a
    token (by host clock, the graph's capture taken out) and the graphed
    step's busy time, idle share and kernels (``decode_breakdown``, over
    steps that rewrite the loop's first positions). Returns (graphed
    tokens, the graphed run's caches, busy ms a step or None, ms a token,
    the graphed run's launches)."""
    import torch
    from repro_torch.models import model as M
    dev = torch.device("cuda")
    runs = {}
    for mode in ("graphed", "eager"):
        graph = M.DecodeGraph(dev, eager=mode == "eager")
        kernels = reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill()
        tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks, _, _ = M.decode_loop(cfg, opts, params, tok, caches, start, n,
                                   device=dev, graph=graph)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        capture_s = graph.runner.capture_s
        runs[mode] = dict(toks=toks, launches=read_launches(kernels),
                          logits=logits, caches=caches, graph=graph,
                          tok=tok, prefill_ms=(t1 - t0) * 1e3,
                          token_ms=(t2 - t1 - capture_s) * 1e3 / n)
        print(f"  {label} ({mode}): prefill {runs[mode]['prefill_ms']:.2f} "
              f"ms; decode {runs[mode]['token_ms']:.3f} ms a token over "
              f"{n} steps (capture {capture_s * 1e3:.1f} ms apart); "
              f"launches {runs[mode]['launches']}")
    g, e = runs["graphed"], runs["eager"]
    want = {k: expected.get(k, 0) for k in g["launches"]}
    hold(f"{label}, graphed and eager", {
        "graphed tokens equal eager tokens": torch.equal(g["toks"],
                                                         e["toks"]),
        "finite prefill logits": bool(torch.isfinite(g["logits"]).all()),
        "tokens in the vocabulary": 0 <= int(g["toks"].min())
            and int(g["toks"].max()) < cfg.vocab_size,
        f"launches == {want}": g["launches"] == want == e["launches"],
        "one capture a call's caches": g["graph"].runner.captures == 1})
    graph = g["graph"]

    def reset():
        # the traced steps (up to 4 in a row) decode the loop's last
        # positions again: the caches hold no position past the loop
        graph.counter.zero_()
        graph.idx.fill_(start + n - 8)
    graph_step_checks(f"{label} decode step", graph.runner, reset)

    def run_steps(k):
        M.decode_loop(cfg, opts, params, g["tok"], g["caches"], start, k,
                      device=dev, graph=graph)
    res = decode_breakdown(run_steps, g["token_ms"],
                           label=f"{label} decode step (graphed)")
    return (g["toks"], g["caches"], res and res[0], g["token_ms"],
            g["launches"])


def gemma_full(cfg, params):
    """gemma3-27b at full width, its first GEMMA_LAYERS layers (5 local of
    window 1024, 1 global; bf16; the tied 262,144-row embedding). Model
    level (``loop_runs``): B = GEMMA_B, a prefill of GEMMA_PREFILL tokens,
    GEMMA_STEPS decode steps, with ring caches (window_cache: the local
    layers' prefill is the flash kernel at S = W, their decode the ring
    route) and with full ones (the chunk kernel with the window). Gated:
    the two modes' prefill logits, and their logits over GEMMA_FORCED
    teacher-forced steps past the wrap, within KERNEL_TOL x max(1, |x|);
    reported: the share of equal greedy tokens. The logits are compared
    on the same weights in f32 (f32 caches: the 3xTF32 flash and chunk
    bodies, the f32 decode): in bf16 the two layouts' rounding between
    layers alone moves some of the 262,144 logits by more than 1e-2
    from the second step past the wrap on, so the bf16 runs are held by
    their tokens (graphed = eager) and their share of equal tokens is
    reported. Engine level: ring
    caches, 8 requests with prompts GEMMA_PROMPTS, each decoding past
    position 1024 (``arch_serve_both``)."""
    import torch
    from repro_torch.configs import GLOBAL_WINDOW
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves, set_leaf
    dev = torch.device("cuda")
    L = cfg.num_layers
    n_local = sum(cfg.layer_window(i) != GLOBAL_WINDOW for i in range(L))
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    tokens = torch.randint(0, cfg.vocab_size, (GEMMA_B, GEMMA_PREFILL),
                           generator=gen, device=dev)
    max_seq = GEMMA_PREFILL + GEMMA_STEPS
    res = {}
    for ring in (True, False):
        opts = M.ModelOptions(window_cache=ring)
        label = f"{cfg.name} ({L} layers), {'ring' if ring else 'full'} " \
                f"caches"
        expected = {"decode_attention": L * GEMMA_STEPS,
                    "flash_attention": n_local if ring else 0,
                    "chunk_prefill": L - n_local if ring else L}
        res[ring] = loop_runs(
            cfg, opts, params,
            lambda opts=opts: M.prefill(cfg, opts, params,
                                        {"tokens": tokens}, max_seq,
                                        device=dev),
            GEMMA_PREFILL, GEMMA_STEPS, label, expected)
        if ring:
            k = res[ring][1]["blocks"]["sub0"]["k"]
            print(f"  ring cache leaf {tuple(k.shape)} (layers, B, W, K, "
                  f"h) against the full cache's {max_seq} rows")
    # the two cache layouts sum the same keys in another order: compared
    # on the same weights in f32, so that the bf16 model's rounding
    # between layers does not hide what the layouts do
    p32 = {}
    for path, t in leaves(params):
        set_leaf(p32, path, t.float())
    logits, caches = {}, {}
    for ring in (True, False):
        logits[ring], caches[ring] = M.prefill(
            cfg, M.ModelOptions(window_cache=ring), p32, {"tokens": tokens},
            max_seq, cache_dtype=torch.float32, device=dev)
    errs = [check("f32 prefill logits, ring vs full caches", logits[True],
                  logits[False], KERNEL_TOL)]
    forced = res[False][0][:, :GEMMA_FORCED]
    tok = logits[False][:, -1].argmax(-1, keepdim=True)
    for i in range(GEMMA_FORCED):
        for ring in (True, False):
            logits[ring], _ = M.decode_step(
                cfg, M.ModelOptions(window_cache=ring), p32, tok,
                caches[ring], GEMMA_PREFILL + i, device=dev)
        errs.append(check(f"f32 decode logits at {GEMMA_PREFILL + i}, ring "
                          f"vs full", logits[True], logits[False],
                          KERNEL_TOL, quiet=True))
        tok = forced[:, i:i + 1]
    del p32
    print(f"  ring vs full caches, f32 weights: logits of the prefill and "
          f"of {GEMMA_FORCED} teacher-forced steps past the wrap within "
          f"{KERNEL_TOL} x max(1, |x|), largest error {max(errs):.3g}; "
          f"bf16 weights: "
          f"share of equal greedy tokens over {GEMMA_STEPS} steps "
          f"{float((res[True][0] == res[False][0]).float().mean()):.4f} "
          f"(reported, not a gate)")
    out = {f"gemma-{'ring' if ring else 'full'}-model": r[4]
           for ring, r in res.items()}
    del caches, logits, res
    reqs = [(p, GEMMA_END - len(p), None) for p in seeded_prompts(
        cfg.vocab_size, GEMMA_PROMPTS, SEED + 18)]
    n_flash = sum(len(p) % 128 == 0 for p, _, _ in reqs)

    def expected(eng):
        steps = tick_bodies(eng)
        return {"decode_attention": L * steps,
                "flash_attention": n_local * n_flash,
                "chunk_prefill": (L - n_local) * len(reqs)}
    out["gemma-ring"] = arch_serve_both(
        cfg, M.ModelOptions(window_cache=True), params, "gemma-ring", {},
        reqs, GEMMA_MAX_SEQ, expected)[0]
    return out


def whisper_full(cfg, params):
    """whisper-small at full width and depth (12 encoder and 12 decoder
    layers, bf16): B = WHISPER_B over 1500 seeded frames, a
    WHISPER_PROMPT-token prompt, WHISPER_STEPS greedy steps through
    ``DecodeGraph`` (``loop_runs``). Launches: the chunk kernel once a
    decoder layer (the prompt's prefill), the decode kernel twice a layer
    a step (self attention; cross attention over the cached 1500-row
    context). Prints the encoder's ms (alone, median of 3), and the cross
    attention's share of the decode step's device time: its 12 calls
    timed alone (graph-replayed, on the caches' own context rows) over
    the step's busy time."""
    import torch
    from repro_torch.models import layers as Lyr
    from repro_torch.models import model as M
    from repro_torch.models import stacks
    dev = torch.device("cuda")
    L = cfg.num_layers
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    frames = torch.randn((WHISPER_B, cfg.encoder.num_tokens,
                          cfg.encoder.embed_dim), generator=gen,
                         device=dev).to(params["embed"].dtype)
    tokens = torch.randint(0, cfg.vocab_size, (WHISPER_B, WHISPER_PROMPT),
                           generator=gen, device=dev)
    enc = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        stacks.apply_tower(params["encoder"], frames, cfg.encoder)
        ev[1].record()
        torch.cuda.synchronize()
        enc.append(ev[0].elapsed_time(ev[1]))
    print(f"  {cfg.name} encoder ({cfg.encoder.num_layers} layers over "
          f"{cfg.encoder.num_tokens} frames, B={WHISPER_B}): "
          f"{float(np.median(enc)):.2f} ms (median of 3)")
    opts = M.ModelOptions()
    toks, caches, busy_ms, token_ms, launches = loop_runs(
        cfg, opts, params,
        lambda: M.prefill(cfg, opts, params,
                          {"tokens": tokens, "frames": frames},
                          WHISPER_PROMPT + WHISPER_STEPS, device=dev),
        WHISPER_PROMPT, WHISPER_STEPS, f"{cfg.name}",
        {"chunk_prefill": L, "decode_attention": 2 * L * WHISPER_STEPS})
    q = torch.randn((WHISPER_B, 1, cfg.num_heads, cfg.head_dim),
                    generator=gen, device=dev).to(params["embed"].dtype)
    sub = caches["blocks"]["sub0"]
    xkv = [(sub["xk"][i], sub["xv"][i]) for i in range(L)]

    def cross_all():
        for xk, xv in xkv:
            Lyr.run_attention_core("decode_cross", q, xk, xv,
                                   opts=opts, window=0, causal=False)
    cross_ms = graph_ms(cross_all, 1, replays=20)
    share = "not measured" if not busy_ms else f"{cross_ms / busy_ms:.4f}"
    print(f"  {cfg.name} cross attention in the decode step: {L} calls "
          f"{cross_ms:.4f} ms (graph-replayed) of the step's busy "
          f"{busy_ms or 0:.4f} ms: share {share}; {token_ms:.3f} ms a "
          f"token ({WHISPER_B} streams)")
    return {"whisper-model": launches}


def arch_full():
    """Phase 10: the four architectures at full width (seeded bf16
    weights, each freed before the next): ``granite_full``,
    ``internvl_full``, ``gemma_full`` (6 layers), ``whisper_full``, each
    returning {path: its graphed run's launches}; returns them all."""
    import torch
    from repro_torch.configs import get_config
    launches = {}
    for name, run in ((GRANITE, granite_full), (INTERNVL, internvl_full),
                      (GEMMA, gemma_full), (WHISPER, whisper_full)):
        t0 = time.perf_counter()
        cfg = get_config(name)
        if name == GEMMA:
            cfg = gemma_cut(cfg)
        if name == GRANITE:
            cfg = dataclasses.replace(cfg, num_layers=GRANITE_LAYERS)
        params = full_params(cfg)
        launches.update(run(cfg, params))
        del params
        torch.cuda.empty_cache()
        print(f"  {name}: {time.perf_counter() - t0:.1f} s")
    return launches


ONE_CARD = {"pod": 1, "data": 1, "model": 1}
# the engines' decode positions: prompt 640 (576 patches + 64 instruction
# tokens), then 192 decoded tokens at 640 .. 831; their mean context
DECODE_CONTEXT = 640 + (SERVE_TOKENS - 1) // 2


def roofline_row(label, cfg, shape, measured_ms, *, dtype_bytes=2,
                 cache_bytes=None, peak=None, steps=1, counted=None):
    """One line of phase 11: ``analytic_cell`` of the run's own shape on a
    one-card mesh (``dtype_bytes`` the weights' and activations' width,
    ``cache_bytes`` the cache's where it differs) priced by
    ``RooflineTerms`` on ``H100_SXM`` (``peak`` in FLOP/s for a type other
    than bf16), times ``steps`` steps a measured wall; prints FLOPs, HBM
    bytes, the bound, the measured ms and measured / bound."""
    from repro_torch.roofline.analytic import analytic_cell, kv_cache_bytes
    from repro_torch.roofline.report import RooflineTerms
    c = analytic_cell(cfg, shape, mesh=ONE_CARD, dtype_bytes=dtype_bytes)
    hbm = c.hbm_bytes_per_dev
    if cache_bytes is not None and "hbm_cache" in c.breakdown:
        hbm += kv_cache_bytes(cfg, shape, ONE_CARD,
                              dtype_bytes=cache_bytes) - \
            c.breakdown["hbm_cache"]
    t = RooflineTerms(arch=cfg.name, shape=shape.name, mesh="one_card",
                      flops_per_dev=c.flops_per_dev * steps,
                      bytes_per_dev=hbm * steps, coll_bytes_per_dev=0.0,
                      model_flops=0.0, hardware=H100_SXM,
                      peak_tflops=None if peak is None else peak / 1e12)
    return _roofline_line(label, shape, t, measured_ms, counted, steps)


def _roofline_line(label, shape, t, measured_ms, counted, steps):
    bound_ms = t.bound_time * 1e3
    extra = "" if counted is None else \
        f" (counted on the meta device: {counted * steps:.6e})"
    print(f"  {label}: {shape}; FLOPs {t.flops_per_dev:.6e}{extra}, HBM "
          f"bytes {t.bytes_per_dev:.6e}; bound {bound_ms:.4f} ms "
          f"({t.dominant}); measured {measured_ms:.4f} ms; measured / "
          f"bound {measured_ms / bound_ms:.2f}")
    return {"label": label, "bound_ms": bound_ms, "ms": measured_ms,
            "ratio": measured_ms / bound_ms}


def roofline_phase(discrete_ms, dit_ms, serving, train_walls):
    """Phase 11: the roofline of walls phases 4, 4b, 5 and 9b measured (no
    new timed run). For each: the ShapeConfig the run had, priced by the
    port's analytic cost model on a one-card mesh and ``RooflineTerms`` on
    ``H100_SXM``, in the run's own types: phase 4's decode step
    (molmoact-7b, B=4, bf16 weights and cache; the graphed action phase's
    median over its 48 steps, at their mean context), phase 4b's DiT
    loop (the analytic model has no DiT ops: its FLOPs are the loop's
    matrix products counted on the meta device, its bytes the bf16 head
    read once a denoising step), phase 5's decode ticks (the first
    SERVE_LAYERS layers, 8 slots, bf16 weights, f32 caches, SERVE_TICK
    steps a tick; decode-tick p50 by host clock) and phase 9b's f32 train
    steps (layer remat; f32 products priced at the f32 peak). Then the
    dry-run CLI on this host (``python -m repro_torch.launch.dryrun``,
    PyTorch only), its row's FLOPs and per-device argument bytes."""
    import dataclasses
    import tempfile

    import torch
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core import vla
    from repro_torch.models import action as A
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves, meta_params
    from repro_torch.roofline.counts import dot_flops
    from repro_torch.roofline.report import RooflineTerms
    meta = torch.device("meta")
    rows = []
    cfg = get_config("molmoact-7b")
    # the action phase's steps: pure replays (the CoT phase's first step
    # captures the graph for the prefill's new caches) at positions
    # prompt + n_cot .. prompt + n_cot + n_act - 1
    prompt, n_act, _ = vla.control_step_lengths(cfg, FULL_TEXT)
    ctx = prompt + cfg.n_cot_tokens + n_act // 2
    shape = ShapeConfig("phase4-action-decode", ctx, FULL_B, "decode")
    step_ms = discrete_ms["action_decode"] / n_act
    p = meta_params(M.model_template(cfg), torch.bfloat16)
    caches = M.init_caches(cfg, FULL_B, ctx, torch.bfloat16, device=meta)
    counted, _ = dot_flops(
        M.decode_step, cfg, M.ModelOptions(), p,
        torch.empty(FULL_B, 1, dtype=torch.long, device=meta), caches,
        torch.empty((), dtype=torch.int32, device=meta), device=meta)
    rows.append(roofline_row("phase 4 action decode step (graphed)", cfg,
                             shape, step_ms, counted=counted))

    dcfg = get_config(DIT_ARCH)
    a = dcfg.action
    head = meta_params(A.dit_template(a, dcfg.d_model), torch.bfloat16)
    head_bytes = sum(t.numel() * t.element_size() for _, t in leaves(head))
    cond = torch.empty(FULL_B, dcfg.d_model, dtype=torch.bfloat16,
                       device=meta)
    noise = torch.empty(FULL_B, a.horizon, a.action_dim,
                        dtype=torch.bfloat16, device=meta)
    dit_flops, _ = dot_flops(M.generate_actions_dit, dcfg,
                             {"action_dit": head, "embed": p["embed"]},
                             cond, noise=noise, device=meta)
    dshape = ShapeConfig("phase4b-dit-loop", a.horizon, FULL_B, "decode")
    t = RooflineTerms(arch=dcfg.name, shape=dshape.name, mesh="one_card",
                      flops_per_dev=dit_flops,
                      bytes_per_dev=head_bytes * a.dit_steps,
                      coll_bytes_per_dev=0.0, model_flops=0.0,
                      hardware=H100_SXM)
    rows.append(_roofline_line(f"phase 4b DiT loop ({a.dit_steps} steps, "
                               f"graphed)", dshape, t, dit_ms, None, 1))

    scfg = dataclasses.replace(cfg, num_layers=SERVE_LAYERS)
    eshape = ShapeConfig("phase5-tick", DECODE_CONTEXT, SERVE_SLOTS,
                         "decode")
    for name in ("dense", "paged-f32"):
        st = serving[name][1]
        tick_ms = float(np.percentile(st.decode_tick_s, 50)) * 1e3
        rows.append(roofline_row(
            f"phase 5 {name} decode tick p50 ({SERVE_TICK} steps, "
            f"{SERVE_LAYERS} layers)", scfg, eshape, tick_ms, cache_bytes=4,
            steps=SERVE_TICK))

    for arch, (B, ms) in train_walls.items():
        tshape = ShapeConfig("phase9b-train", TRAIN_S, B, "train")
        rows.append(roofline_row(
            f"phase 9b {arch} train step (f32, remat)", get_config(arch),
            tshape, ms, dtype_bytes=4, peak=OPS_PER_S["float32"]))

    with tempfile.TemporaryDirectory() as out:
        env = dict(os.environ, PYTHONPATH=os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "src"))
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                            "--arch", "smollm-135m", "--shape", "decode_32k",
                            "--out", out], capture_output=True, text=True,
                           env=env, timeout=300)
        if r.returncode:
            raise AssertionError(f"the dry-run CLI failed: {r.stderr[-2000:]}")
        with open(os.path.join(
                out, "smollm-135m__decode_32k__single_pod.json")) as f:
            row = json.load(f)
    if not row["cost"]["flops"] > 0:
        raise AssertionError(f"dry-run row without a count: {row}")
    print(f"  dry run on this host (python -m repro_torch.launch.dryrun "
          f"--arch smollm-135m --shape decode_32k; meta device, no JAX): "
          f"flops {row['cost']['flops']:.6e} (counted, global), argument "
          f"bytes per device "
          f"{row['memory']['argument_size_in_bytes']:.6e} on the "
          f"{row['mesh']} mesh; meta run {row['t_lower_s']:.2f} s")
    return rows


class Laps:
    """Prints the seconds each phase took, as it ends, and the total."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def __call__(self, phase: str) -> None:
        now = time.perf_counter()
        print(f"  [{phase} took {now - self.last:.1f} s; "
              f"{now - self.start:.1f} s in all]", flush=True)
        self.last = now


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lap = Laps()
    print(card_line())
    ptxas = start_ptxas_report()
    print(f"phase 1: kernels built and loaded in {_build.timed_build():.1f} s")
    ptxas_report(ptxas)
    lap("phase 1")
    cfg = get_config("molmoact-7b")
    moe_cfg = get_config(MOE_ARCH)
    print("phase 2: kernels vs plain versions")
    inputs, errs = kernel_checks(cfg)
    lap("phase 2")
    print(f"phase 2b: grouped-expert kernels vs plain versions, "
          f"{MOE_ARCH} width, and their backward")
    moe_errs = moe_kernel_checks(moe_cfg)
    moe_backward_checks(moe_cfg)
    lap("phase 2b")
    ssm_cfg = get_config(SSM_ARCH)
    print(f"phase 2c: SSD kernel vs plain version, {SSM_ARCH} width, and "
          f"its backward")
    ssd_inputs_640, ssd_errs = ssd_kernel_checks(ssm_cfg)
    ssd_backward_checks(ssm_cfg)
    lap("phase 2c")
    print("phase 2d: flash-attention kernel vs plain version")
    flash_inputs, flash_errs = flash_checks()
    lap("phase 2d")
    print(f"phase 2e: ring and cross decode ({GEMMA}, {WHISPER} widths) "
          f"and flash attention at S = W = {GEMMA_PREFILL} vs plain "
          f"versions")
    arch_kernel_checks()
    lap("phase 2e")
    print("phase 3: reduced molmoact-7b, card vs CPU")
    card_vs_cpu(cfg)
    lap("phase 3")
    print(f"phase 3b: reduced {MOE_ARCH}, card vs CPU")
    moe_card_vs_cpu(moe_cfg)
    lap("phase 3b")
    print(f"phase 3c: reduced {SSM_ARCH} and {HYBRID_ARCH}, card vs CPU")
    ssm_card_vs_cpu([SSM_ARCH, HYBRID_ARCH])
    lap("phase 3c")
    print(f"phase 3d: reduced {TRAIN_ARCH}, molmoact-7b, "
          f"{', '.join(TRAIN_FAMILIES)} training, card vs CPU")
    train_card_vs_cpu()
    train_families_card_vs_cpu()
    lap("phase 3d")
    print(f"phase 3e: reduced {DIT_ARCH}, card vs CPU")
    dit_card_vs_cpu()
    lap("phase 3e")
    print(f"phase 3f: reduced {GRANITE}, {INTERNVL}, {GEMMA} "
          f"({GEMMA_LAYERS} layers) and {WHISPER}, card vs CPU")
    arch_card_vs_cpu()
    lap("phase 3f")
    params = full_params(cfg)
    print("phase 4: full-width control step")
    launches, discrete_ms = full_width(cfg, params)
    lap("phase 4")
    print(f"phase 4b: full-width {DIT_ARCH} control step")
    dit_ms = dit_full_width(get_config(DIT_ARCH), params, discrete_ms)
    lap("phase 4b")
    print("phase 5: full-width serving engine")
    serving, fused_streams = serving_full(cfg, params)
    prefill_consistency(cfg, params)
    lap("phase 5")
    print("phase 5c: full-width self-speculative serving engine")
    spec_serving = spec_serving_full(cfg, params, fused_streams)
    lap("phase 5c")
    print("phase 5d: the front end over two reduced replicas, card vs CPU")
    frontend_card_vs_cpu(cfg)
    lap("phase 5d")
    print("phase 5e: full-width fleet replay through the front end")
    fleet_full(cfg, params)
    lap("phase 5e")
    print(f"phase 12: sharded serving, model={MESH_MODEL}: two ranks "
          f"sharing one card over gloo")
    sharded_serving_full(cfg, params, fused_streams, serving)
    del fused_streams
    lap("phase 12")
    del params
    torch.cuda.empty_cache()
    print(f"phase 7: full-width {MOE_ARCH} serving engine")
    moe_serving = moe_serving_full(moe_cfg)
    torch.cuda.empty_cache()
    lap("phase 7")
    print(f"phase 8: full-width {SSM_ARCH} serving engine")
    ssm_serving = ssm_serving_full(ssm_cfg)
    torch.cuda.empty_cache()
    lap("phase 8")
    print(f"phase 9: full-width {TRAIN_ARCH} train step")
    train_launches = train_full()
    torch.cuda.empty_cache()
    lap("phase 9")
    print(f"phase 9b: full-width {', '.join(TRAIN_FULL)} train steps")
    family_launches, train_walls = train_families_full()
    lap("phase 9b")
    print(f"phase 10: full-width {GRANITE}, {INTERNVL}, {GEMMA} (first "
          f"{GEMMA_LAYERS} layers) and {WHISPER}")
    arch_launches = arch_full()
    lap("phase 10")
    print("phase 11: roofline of the measured phases on H100_SXM, and the "
          "dry run on this host")
    roofline_phase(discrete_ms, dit_ms, serving, train_walls)
    lap("phase 11")
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
    lap("phase 6")
    print(f"  phase 9b's launches ({1 + TRAIN_STEPS} train steps; rows 5-8): "
          + "; ".join(f"{arch} " + ", ".join(f"{k} {n}" for k, n in
                                             counts.items() if n)
                      for arch, counts in family_launches.items()))
    print("  phase 10's launches (graphed runs; rows 1-3, 5): " + "; ".join(
        f"{path} " + ", ".join(f"{k} {n}" for k, n in counts.items() if n)
        for path, counts in arch_launches.items()))
    print(card_line())      # again here, beside the numbers it qualifies
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
