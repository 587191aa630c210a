"""95th percentile over the window's requests of due time to admission
(Request.t_submit + queue_s, on the benchmark's perf_counter clock), ms."""

from harness.stats import percentile

LAYER = "scheduler and KV pool (serving/scheduler, serving/kv_pool)"
SOURCE = "program_span"
UNIT = "ms"
MOVES = "ttft_p95_ms"


def read(run):
    waits = run.window.get("queue_wait_s")
    return percentile(waits, 95) * 1e3 if waits else None
