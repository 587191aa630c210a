"""Arithmetic shared by the per-layer metrics' readers (``metrics/``).
Each reader returns None where its run has nothing for it to read."""
from __future__ import annotations

from harness import counts, peaks
from harness.stats import median


def tick_ms_p50(run):
    ticks = run.window.get("tick_s")
    return median(ticks) * 1e3 if ticks else None


def serve_mfu(run):
    """Model FLOPs of every image, prompt position, first-token head and
    decoded token of the window's ticks over their summed walls at the
    bf16 peak, in %. A prompt position counts the prompt's mean causal
    attention, a decoded token the mean of its request's positions."""
    w, cfg = run.window, run.cfg
    ticks = w.get("tick_s")
    if not ticks:
        return None
    prompt, mt = w["prompt"], w["max_tokens"]
    flops = (w["images"] * counts.image_flops(cfg)
             + w["prefill_positions"]
             * counts.prefill_flops(cfg, 0, prompt, heads=0) / prompt
             + w["heads"] * 2.0 * counts.head_params(cfg)
             + w["tokens_decoded"]
             * counts.decode_flops(cfg, prompt + (mt - 2) / 2))
    return 100.0 * flops / (sum(ticks) * peaks.BF16_FLOPS_PER_S)


def control_replays(run):
    """The traced control step's graph replays as (prefill, [decode],
    dit or None), or None unless the trace holds exactly the replays
    the step makes, each with its device operations."""
    if run.trace is None:
        return None
    reps = run.trace.replays()
    if len(reps) != run.traced["graph_launches"] or None in reps:
        return None
    dit = run.cfg["action"]["mode"] == "dit"
    return reps[0], reps[1:len(reps) - dit], (reps[-1] if dit else None)


def span_ms(rep) -> float:
    return (rep[1] - rep[0]) * 1e3


def decode_attention_roofline(run):
    """The least time of the traced control step's decode attention (K
    and V rows up to each step's position, q and the output, each byte
    once, at the HBM peak) over the device time of its kernels (the
    split-key pass and the combine), in %."""
    if run.trace is None:
        return None
    t = run.trace.kernel_s("decode_kernel", "split_combine")
    if t <= 0:
        return None
    nbytes = sum(counts.decode_attention_bytes(run.cfg,
                                               run.traced["robots"], p)
                 for p in run.traced["decode_positions"])
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S / t


def idle_share(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def control_mfu(run):
    w = run.window
    flops = counts.control_step_flops(run.cfg, w["robots"],
                                      w["text_tokens"])
    return 100.0 * flops / (w["step_s"] * peaks.BF16_FLOPS_PER_S)

