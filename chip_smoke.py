"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``,
holds each kernel against its plain PyTorch version at the shapes of the
main path, ties the card to the CPU port on the reduced molmoact-7b, then
drives one full-width molmoact-7b VLA control step (B=4 robots, seeded
random weights) through ``vla_control_step`` and checks that it ran through
the kernels. Prints the card, the phase times, one JSON line describing
each kernel and, last, ``{"ok": true, "device": {...}}``. Exits non-zero,
without that line, when there is no CUDA device or any phase fails.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_OPS_PER_S = 989e12            # dense bf16 tensor-core peak
KERNEL_TOL = 1e-2    # relative to max(1, |plain|): a bf16 output is off by
#                      up to half an ulp (2**-9 relative) plus f32 sums
#                      taken in another order
CPU_LOGIT_TOL = 1e-3               # f32 weights; summation order only
SEED = 0
FULL_B, FULL_TEXT = 4, 64          # robots per step, instruction tokens
PHASE_REPEATS = 3                  # timed control steps after the first


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


def bound(nbytes: float, ops: float):
    """(least time in ms, what bounds it) on the H100's published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check(name: str, got, want, tol: float) -> float:
    """Fail unless |got - want| <= tol * max(1, |want|) everywhere; returns
    the largest absolute error."""
    import torch
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    ok = bool(torch.isfinite(got).all()) and bool(
        (diff <= tol * want.float().abs().clamp(min=1.0)).all())
    print(f"  {name}: max_abs_err={err:.3g} (tol {tol:g} x max(1, |plain|))"
          f"{'' if ok else '  FAILED'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err} > {tol})")
    return err


def kernel_checks(cfg):
    """Phase 2: each kernel against its plain version at the main path's
    shapes, in bf16; returns the inputs and largest errors for phase 5."""
    import torch
    from repro_torch.kernels.chunk_prefill import ops as cp
    from repro_torch.kernels.decode_attention import ops as da
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    from repro_torch.core.vla import control_step_lengths
    B, N, K, h = FULL_B, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    S, _, smax = control_step_lengths(cfg, FULL_TEXT)     # 640, 833

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()

    q, kc, vc = randn(B, N, h), randn(B, smax, K, h), randn(B, smax, K, h)
    errs = {"decode_attention": 0.0, "chunk_prefill": 0.0}
    print("decode_attention vs plain, q", tuple(q.shape), "cache",
          tuple(kc.shape))
    cases = [(i, 0) for i in (0, 511, 512, 640, 831)]
    cases += [(torch.tensor([640, 700, 783, 831], dtype=torch.int32,
                            device=dev), 0), (736, 64)]
    for idx, window in cases:
        got = da.decode_attention(q, kc, vc, idx, window=window)
        want = da.decode_attention_ref(q.float(), kc, vc, idx, window)
        label = (f"index={idx if isinstance(idx, int) else idx.tolist()} "
                 f"window={window}")
        errs["decode_attention"] = max(errs["decode_attention"],
                                       check(label, got, want, KERNEL_TOL))

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
        errs["chunk_prefill"] = max(errs["chunk_prefill"],
                                    check(label, got, want, KERNEL_TOL))
    torch.cuda.synchronize()
    part = cp.chunk_prefill_attention(qc[:, 320:].contiguous(), kv, vv, 320)
    if not torch.equal(full[:, 320:], part):
        raise AssertionError("chunk_prefill: rows 320..639 differ between "
                             "one chunk from 0 and a chunk at 320")
    print("  chunking invariance: rows 320..639 bit-equal")
    return {"decode": (q, kc, vc), "chunk": (qc, kv, vv)}, errs


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


def full_width(cfg):
    """Phase 4: the full-width molmoact-7b control step, B=4."""
    import torch
    from repro_torch.core import vla
    from repro_torch.kernels.chunk_prefill.ops import chunk_prefill_attention
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves
    dev = torch.device("cuda")
    opts = M.ModelOptions()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = M.init_params(cfg, gen, torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in leaves(params))
    print(f"full width: {cfg.name}, {n_params / 1e9:.3f} B parameters in "
          f"bf16, initialised in {time.perf_counter() - t0:.1f} s")
    tokens = torch.randint(0, cfg.vocab_size, (FULL_B, FULL_TEXT),
                           generator=gen, device=dev)
    patches = torch.randn((FULL_B, cfg.vision.num_tokens,
                           cfg.vision.embed_dim), generator=gen,
                          device=dev).bfloat16()
    prompt, n_act, max_seq = vla.control_step_lengths(cfg, FULL_TEXT)

    prefix = M.encode_vision(cfg, opts, params, patches, device=dev)
    batch = {"tokens": tokens, "prefix": prefix}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    decode_attention.launches = chunk_prefill_attention.launches = 0
    t0 = time.perf_counter()
    out = vla.vla_control_step(cfg, opts, params, batch, device=dev)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = {"decode_attention": decode_attention.launches,
                "chunk_prefill": chunk_prefill_attention.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"chunk_prefill": cfg.num_layers,
            "decode_attention": cfg.num_layers * (cfg.n_cot_tokens + n_act)}
    print(f"  launches on the main path: {launches} (expected {want})")
    if launches != want:
        raise AssertionError("the main path did not run through the kernels "
                             "as expected")
    for name, t, n in (("cot_tokens", out.cot_tokens, cfg.n_cot_tokens),
                       ("action_tokens", out.action_tokens, n_act)):
        if tuple(t.shape) != (FULL_B, n) or int(t.min()) < 0 \
                or int(t.max()) >= cfg.vocab_size:
            raise AssertionError(f"{name}: shape {tuple(t.shape)}, range "
                                 f"[{int(t.min())}, {int(t.max())}]")

    # the same phases, timed one by one with CUDA events
    names = ("vision", "prefill", "cot_decode", "action_decode")
    runs = []
    for rep in range(PHASE_REPEATS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        prefix = M.encode_vision(cfg, opts, params, patches, device=dev)
        ev[1].record()
        logits, caches = M.prefill(cfg, opts, params,
                                   {"tokens": tokens, "prefix": prefix},
                                   max_seq, device=dev)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        ev[2].record()
        cot, tok, caches = vla.decode_tokens(cfg, opts, params, tok, caches,
                                             prompt, cfg.n_cot_tokens,
                                             device=dev)
        ev[3].record()
        act, _, _ = vla.decode_tokens(cfg, opts, params, tok, caches,
                                      prompt + cfg.n_cot_tokens, n_act,
                                      device=dev)
        ev[4].record()
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(logits).all())
                and torch.equal(cot, out.cot_tokens)
                and torch.equal(act, out.action_tokens)):
            raise AssertionError("the phase-by-phase run disagrees with "
                                 "vla_control_step")
        runs.append({n: ev[i].elapsed_time(ev[i + 1])
                     for i, n in enumerate(names)})
        print(f"  run {rep}: phases (ms) " + ", ".join(
            f"{n}={t:.2f}" for n, t in runs[-1].items())
            + f", step {sum(runs[-1].values()):.2f}")
    phase_ms = {n: float(np.median([r[n] for r in runs])) for n in names}
    total = float(np.median([sum(r.values()) for r in runs]))
    act_share = np.median([r["action_decode"] / sum(r.values())
                           for r in runs])
    dec_share = np.median([(r["cot_decode"] + r["action_decode"])
                           / sum(r.values()) for r in runs])
    print(f"  median of {PHASE_REPEATS}: control step {total:.2f} ms; "
          f"action-generation share {act_share:.4f}; "
          f"CoT+action decode share {dec_share:.4f}; "
          f"vla_control_step (vision precomputed, first call) "
          f"{step_s * 1e3:.2f} ms by host clock; peak memory {peak_gb:.2f} GB")
    decode_breakdown(cfg, params, caches, prompt + cfg.n_cot_tokens,
                     phase_ms["action_decode"] / n_act)
    return launches


def decode_breakdown(cfg, params, caches, start: int, wall_ms: float):
    """Device-busy time of a full-width decode step, by torch.profiler
    over a few steps, against its wall time from the phase timing: the
    device's idle share, and the kernels that take the most time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import vla
    from repro_torch.models import model as M
    steps = 4
    tok = torch.zeros(FULL_B, 1, dtype=torch.long, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        vla.decode_tokens(cfg, M.ModelOptions(), params, tok, caches, start,
                          steps, device="cuda")
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    if busy_ms == 0:
        print("  decode step: device busy time not measured (the profiler "
              "saw no kernels)")
        return
    # the CUDA activity also lists runtime calls (no device time): skip them
    kernels = sum(e.count for e in rows if e.self_device_time_total) / steps
    print(f"  decode step: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} "
          f"ms, idle share {1 - busy_ms / wall_ms:.4f}, {kernels:.0f} "
          f"kernels per step")
    for e in rows[:5]:
        print(f"    {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
              f"{e.count // steps:5d} calls/step  {e.key[:70]}")


def kernel_timings(inputs, errs, launches):
    """Phase 5: each kernel's time, its plain version's, the SDPA yardstick
    and the bound, at the phase-2 shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.chunk_prefill import ops as cp
    from repro_torch.kernels.decode_attention import ops as da
    rows = []

    q, kc, vc = inputs["decode"]
    B, N, h = q.shape
    K = kc.shape[2]
    pos = 736                           # mid-way through the decode phase
    idx = torch.full((B,), pos, dtype=torch.int32, device=q.device)
    live = pos + 1
    nbytes = 2 * q.numel() * 2 + B * live * K * h * 2 * 2
    t_b, by = bound(nbytes, 4 * B * N * h * live)
    mask = (torch.arange(kc.shape[1], device=q.device) <= pos)[None, None,
                                                               None]
    qs, ks, vs = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    rows.append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/csrc/"
                  "decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py"
                    ":142",
        "launches": launches["decode_attention"],
        "max_abs_err": errs["decode_attention"],
        "ms": time_ms(lambda: da.decode_attention(q, kc, vc, idx), 200),
        "plain_ms": time_ms(lambda: da.decode_attention_ref(q, kc, vc, idx),
                            20),
        "bound_ms": t_b, "bound_by": by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True), 200)})

    qc, kv, vv = inputs["chunk"]
    B, S, N, h = qc.shape
    L = kv.shape[1]
    pairs = S * (S + 1) // 2            # causal (row, key) pairs from index 0
    nbytes = 2 * qc.numel() * 2 + B * L * K * h * 2 * 2
    t_b, by = bound(nbytes, 4 * B * N * h * pairs)
    qt, kt, vt = qc.transpose(1, 2), kv.transpose(1, 2), vv.transpose(1, 2)
    zero = torch.zeros(B, dtype=torch.int32, device=qc.device)
    rows.append({
        "name": "chunk_prefill", "route": "cuda",
        "source": "src/repro_torch/kernels/chunk_prefill/csrc/"
                  "chunk_prefill.cu",
        "replaces": "src/repro/kernels/chunk_prefill/chunk_prefill.py:152",
        "launches": launches["chunk_prefill"],
        "max_abs_err": errs["chunk_prefill"],
        "ms": time_ms(lambda: cp.chunk_prefill_attention(qc, kv, vv, zero),
                      20),
        "plain_ms": time_ms(lambda: cp.chunk_prefill_ref(qc, kv, vv, zero),
                            5),
        "bound_ms": t_b, "bound_by": by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 20)})
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, SDPA {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
              f"ms ({r['bound_by']})")
    return rows


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
    print(f"phase 1: kernels built and loaded in {_build.timed_build():.1f} s")
    cfg = get_config("molmoact-7b")
    print("phase 2: kernels vs plain versions")
    inputs, errs = kernel_checks(cfg)
    print("phase 3: reduced molmoact-7b, card vs CPU")
    card_vs_cpu(cfg)
    print("phase 4: full-width control step")
    launches = full_width(cfg)
    print("phase 5: kernel times")
    rows = kernel_timings(inputs, errs, launches)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
