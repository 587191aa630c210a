"""Continuous-batching serving engine with a device-resident decode tick
(the port of ``repro.serving.engine``: admit-stall admission, dense or
paged caches, unquantized or int8/fp8 pools, fused or per-token decode, on
one device).

Decode runs over a fixed slot batch; each slot carries its own cache
position. A finished slot is refilled from the queue: vision runs as its
own stage, then a batch-1 prefill into an f32 cache whose rows are
scattered into the slot's batch row (dense) or into pool pages (paged).

- **fused** (default): the tick runs ``min(tick_tokens, max_steps)``
  decode steps with sampling on the device and reads the results back
  once. Its carry lives in static buffers and one masked step over them
  (``DecodeTick``) is captured in a CUDA graph on the card, once for the
  engine's life, and replayed for each step: a step costs the host one
  graph launch, not one launch a kernel (the counterpart of the
  reference's jitted ``lax.while_loop``). ``graphs=False`` runs the same
  step eagerly. The reference exits its ``while_loop`` early when
  every slot is done or a slot newly finishes; a Python ``if`` on a device
  value would force a host sync, so here a device-side ``go`` flag masks
  the steps after that point instead:
  they change no carry value, and ``device_steps`` counts only the steps
  where ``go`` held, as the reference counts its loop iterations. A masked
  step still costs a full decode; the engine counts those in
  ``masked_steps`` (not an ``EngineStats`` field).
- **per-token** (``fused=False``, ``step()``): one decode step, one host
  sync per token: the equivalence oracle.

Temperature sampling draws counter-based noise keyed on (request key,
position), the request key drawn at ``submit`` from a ``torch.Generator``
seeded with ``seed``: a request's sampled stream does not depend on masked
steps, tick sizes, fused or per-token mode, or its slot.

Decoders with Mamba2 layers (``mamba2-780m``, the jamba hybrid) are
served admit-stall only, as in the reference: their per-slot ``ssm`` and
``conv`` states are slot-batched leaves in either layout, scattered into
the slot's row at admission and advanced by every decode step.

Paged pools (``paged=True``) keep attention K/V in shared
``[num_pages, page_size, K, h]`` pools addressed through the host-side
``KVPool``'s page table; full prompt pages are shared through the prefix
cache. ``kv_dtype="int8"/"fp8"`` stores 1-byte codes with f32 scales per
(page, KV head) or per row (``scale_granularity``). On the card the paged
kernels take ``page_size`` 32 only.

Chunked prefill (``chunked_prefill=True``) replaces admit-stall admission
with the token-budget scheduler (``serving.scheduler``): a request takes a
slot as a prefill task, and each tick runs its prompt in ``chunk_size``
chunks under ``token_budget`` beside the budget-capped decode stage
(``_tick_chunked``); ``slo_hz`` adds the SLO controller. Chunks write a
batch-1 dense cache (dense engines) or the slot's pool pages in place.

Self-speculative decode (``spec_decode=True``; fused and greedy only,
attention-only decoders): each round of the tick drafts ``spec_k - 1``
tokens with the model's leading ``draft_layers`` (optionally through
int8/fp8-rounded weights), verifies all ``spec_k`` positions through the
full model as one chunk (the chunk-prefill kernels) and emits the longest
accepted prefix plus one bonus token, the stream the plain tick makes. Its
carry lives in static buffers and one round is captured in a CUDA graph
once an engine (``SpecTick``).

Not ported yet, and refused with ``NotImplementedError``: a device mesh
(ROADMAP item 11).
"""
from __future__ import annotations

import hashlib
import math
import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.paged import PAGE_SIZE
from repro_torch.kernels.ssd.ops import Q_MAX, chunk_len
from repro_torch.models import kv_quant
from repro_torch.models import model as M
from repro_torch.models.graphs import StepGraph, tensor_key
from repro_torch.models.layers import ModelOptions, band_len
from repro_torch.models.params import leaves
from repro_torch.models.stacks import (cache_batch_axis, is_paged_leaf,
                                       is_recurrent_leaf, is_scale_leaf,
                                       stack_plan)
from repro_torch.serving import sampler as S
from repro_torch.serving.kv_pool import KVPool, PoolExhausted
from repro_torch.serving.scheduler import (BEST_EFFORT, ChunkedScheduler,
                                           ChunkPlan, PrefillTask,
                                           SLOController, eviction_victims,
                                           insert_by_class, is_realtime,
                                           req_deadline)


@dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # [S] int32
    max_tokens: int
    patches: Optional[np.ndarray] = None
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    cancelled: bool = False            # aborted via ServingEngine.cancel()
    t_submit: float = 0.0
    t_prefill: float = 0.0
    t_done: float = 0.0
    queue_s: float = 0.0               # submit -> prefill start (queue wait)
    ttft_s: float = 0.0                # submit -> first token
    pages_used: int = 0                # paged engine: pages held at finish
    pages_shared: int = 0              # paged engine: prefix-cache hits
    prefill_skipped: int = 0           # prompt positions skipped (prefix hit)
    priority: str = BEST_EFFORT        # scheduling class ("realtime" jumps
    #                                    the queue, EDF within class)
    deadline_s: float = 0.0            # relative SLO (0 = none)
    t_deadline: float = math.inf       # t_submit + deadline_s (set by
    #                                    ServingEngine.submit; inf = none)
    sample_key: int = 0                # sampling-noise key (set by submit)


@dataclass
class EngineStats:
    """Host-sync contract + phase + cache accounting for one engine
    lifetime (the reference's fields, less those of sharded serving, which
    come with ROADMAP item 11).

    A "sync" is a device->host readback that blocks the Python loop: the
    fused path pays one per tick, the per-token path one per token. The
    cache fields are live only on the paged engine: ``pages_in_use`` /
    ``pages_hwm`` count pool pages held by live slots, ``cache_bytes_hwm``
    is the high-water of their device bytes at the pool's storage dtype
    (codes plus scales for a quantized pool), ``prefix_hits`` counts pages
    served from the prefix cache."""
    decode_syncs: int = 0       # blocking readbacks on the decode path
    prefill_syncs: int = 0      # blocking readbacks at admission
    ticks: int = 0              # engine ticks (fused or per-token)
    device_steps: int = 0       # decode steps executed on device
    tokens_decoded: int = 0     # tokens emitted by the decode path
    vision_time: float = 0.0
    prefill_time: float = 0.0
    decode_time: float = 0.0
    prefill_tokens: int = 0     # prompt positions run through prefill
    prefill_skipped: int = 0    # prompt positions skipped via prefix hits
    prefill_key_lanes: int = 0       # sum of rows x banded key length
    prefill_key_lanes_full: int = 0  # rows x max_seq
    pages_in_use: int = 0       # paged: current pool pages held by slots
    pages_hwm: int = 0          # paged: high-water pages in use
    cache_bytes_hwm: int = 0    # paged: high-water KV bytes actually held
    prefix_hits: int = 0        # paged: pages reused via the prefix cache
    # speculative decode: a verify pass is one slot's row block of a
    # full-model verify chunk (spec_k positions), the weight and cache
    # pass speculation shares; spec_accept_hist[n] counts passes that
    # emitted n tokens, so emitted / passes is the tokens a pass. Draft
    # steps cost draft_layers / num_layers of a pass (spec_draft_pass_
    # equiv); spec_key_lanes sums verify rows x each slot's own band bound
    spec_verify_passes: int = 0
    spec_draft_steps: int = 0            # truncated draft steps executed
    spec_draft_pass_equiv: float = 0.0   # draft cost in full-model passes
    spec_accept_hist: List[int] = field(default_factory=list)
    spec_key_lanes: int = 0              # verify rows x per-slot band bound
    spec_key_lanes_full: int = 0         # verify rows x max_seq
    queue_s: List[float] = field(default_factory=list)
    ttft_s: List[float] = field(default_factory=list)
    tick_s: List[float] = field(default_factory=list)    # whole-tick wall
    decode_tick_s: List[float] = field(default_factory=list)  # decode stage
    tick_prefill_tokens: List[int] = field(default_factory=list)
    tick_key_lanes: List[int] = field(default_factory=list)
    deadline_hit: Dict[str, int] = field(default_factory=dict)
    deadline_miss: Dict[str, int] = field(default_factory=dict)
    preemptions: Dict[str, int] = field(default_factory=dict)
    tick_ewma_s: float = 0.0    # EWMA whole-tick wall (alpha 0.2)

    def record_tick_wall(self, wall_s: float):
        """Fold one tick's wall time into the EWMA (first sample seeds)."""
        self.tick_ewma_s = (wall_s if self.tick_ewma_s == 0.0
                            else 0.8 * self.tick_ewma_s + 0.2 * wall_s)

    def record_deadline(self, req) -> None:
        """Score a finishing request against its absolute deadline."""
        if not (req.deadline_s > 0):
            return
        bucket = (self.deadline_hit if req.t_done <= req.t_deadline
                  else self.deadline_miss)
        bucket[req.priority] = bucket.get(req.priority, 0) + 1

    def record_preemption(self, req) -> None:
        self.preemptions[req.priority] = \
            self.preemptions.get(req.priority, 0) + 1

    def phase_report(self) -> Dict[str, float]:
        """Wall-time decomposition (vision / prefill / decode seconds),
        decode-tick p50/p99, queue-wait and TTFT p50/p99, the prefill
        key-lane ratio, per-class deadline attainment and preemptions, and
        the paged cache figures."""
        rep = {"vision": self.vision_time, "prefill": self.prefill_time,
               "decode": self.decode_time}
        if self.decode_tick_s:
            rep["decode_tick_p50"] = float(np.percentile(self.decode_tick_s,
                                                         50))
            rep["decode_tick_p99"] = float(np.percentile(self.decode_tick_s,
                                                         99))
        for name, samples in (("queue", self.queue_s), ("ttft", self.ttft_s)):
            if samples:
                rep[f"{name}_p50"] = float(np.percentile(samples, 50))
                rep[f"{name}_p99"] = float(np.percentile(samples, 99))
        if self.prefill_key_lanes_full:
            rep["prefill_key_lane_ratio"] = (self.prefill_key_lanes
                                             / self.prefill_key_lanes_full)
        for cls in sorted(set(self.deadline_hit) | set(self.deadline_miss)):
            hit = self.deadline_hit.get(cls, 0)
            miss = self.deadline_miss.get(cls, 0)
            rep[f"deadline_attainment_{cls}"] = hit / (hit + miss)
            rep[f"deadline_total_{cls}"] = float(hit + miss)
        for cls, n in sorted(self.preemptions.items()):
            rep[f"preemptions_{cls}"] = float(n)
        if self.tick_ewma_s:
            rep["tick_ewma_s"] = float(self.tick_ewma_s)
        if self.pages_hwm:
            rep["pages_in_use"] = float(self.pages_in_use)
            rep["pages_hwm"] = float(self.pages_hwm)
            rep["cache_bytes_hwm"] = float(self.cache_bytes_hwm)
            rep["prefix_hits"] = float(self.prefix_hits)
        if self.spec_verify_passes:
            emitted = sum(n * c for n, c in enumerate(self.spec_accept_hist))
            rep["spec_verify_passes"] = float(self.spec_verify_passes)
            rep["spec_accept_per_pass"] = emitted / self.spec_verify_passes
            rep["spec_accept_hist"] = [int(c) for c in self.spec_accept_hist]
            rep["spec_draft_steps"] = float(self.spec_draft_steps)
            rep["spec_draft_pass_equiv"] = float(self.spec_draft_pass_equiv)
            # the share of the model work (in full-model passes) drafting
            tot = self.spec_draft_pass_equiv + self.spec_verify_passes
            rep["spec_draft_frac"] = float(self.spec_draft_pass_equiv / tot)
            if self.spec_key_lanes_full:
                rep["spec_key_lane_ratio"] = (self.spec_key_lanes
                                              / self.spec_key_lanes_full)
        return rep


def prefix_page_keys(cfg_name: str, page_size: int, kv_dtype: str,
                     prompt: np.ndarray, patches: Optional[np.ndarray] = None,
                     n_prefix: int = 0) -> List[bytes]:
    """Prefix-closed digests, one per *full* page of a request's prompt
    prefix: the content address a ``KVPool`` shares pages under. Key ``i``
    covers every input that determines KV for positions
    ``[0, (i+1)*page_size)``: the vision patches (one digest, repeated over
    the ``n_prefix`` positions they fill) and the prompt tokens so far,
    seeded with the model name, page size and pool storage dtype. The bytes
    equal the reference's for the same inputs."""
    h = hashlib.sha1(f"{cfg_name}:{page_size}:{kv_dtype}".encode())
    items: List[bytes] = []
    if n_prefix:
        pd = hashlib.sha1(np.ascontiguousarray(patches).tobytes()).digest()
        items.extend([pd] * n_prefix)
    items.extend(int(t).to_bytes(8, "little", signed=True) for t in prompt)
    keys = []
    for i, item in enumerate(items):
        h.update(item)
        if (i + 1) % page_size == 0:
            keys.append(h.digest())
    return keys


class DecodeTick:
    """The fused tick's carry in static device buffers, and one masked
    decode step over them: the body a ``graphs.StepGraph`` captures once
    on the card and replays ``cap`` times a tick, so that one graph serves
    every depth the chunked planner picks.

    Buffers (``load`` fills them from the host before a tick, outside the
    graph): current token ``tokens`` [B,1], position ``index`` [B],
    remaining ``budget`` [B], ``done`` [B] and its value at the tick's
    entry, the slots' sampling ``keys`` [B], the ``page_table`` [B, npg]
    of a paged cache; a step writes ``out`` [B,K] (each live slot fills a
    prefix of its row, ``n_emit`` long) through the device step counter
    and counts the steps where ``go`` held in ``steps``.

    The reference stops when every slot is done or once any slot newly
    finishes; here that condition is a device flag ``go``, and a step
    taken after it turns false is masked: every row counts as done, so no
    carry value changes and each row's cache write lands where a done
    row's does in the reference (its unchanged position: a retired slot's
    null page, a live slot's next position, rewritten identically by its
    next real step), and the null page of a paged cache is put back as the
    step found it (the reference never ran the step, and retired slots
    attend that page), and so is every Mamba2 state (a step advances it,
    so a masked step would advance each slot's state once more than the
    reference does). A step's sampling noise is keyed on the row's
    position, so masked steps consume no randomness. ``graphs=False`` runs
    the same step eagerly (the oracle of the graphed tick); on the CPU it
    always runs eagerly."""

    def __init__(self, cfg: ModelConfig, opts: ModelOptions, params, caches,
                 n_slots: int, K: int, eos: int, temperature: float,
                 top_k: int, pages_per_slot: int = 0, *, device,
                 graphs: bool = True):
        self.args = (cfg, opts, params, caches)
        self.eos, self.temperature, self.top_k = eos, temperature, top_k
        B = n_slots
        self.tokens = torch.zeros(B, 1, dtype=torch.long, device=device)
        self.index = torch.zeros(B, dtype=torch.int32, device=device)
        self.budget = torch.zeros(B, dtype=torch.int32, device=device)
        self.done = torch.zeros(B, dtype=torch.bool, device=device)
        self.entry_done = torch.zeros(B, dtype=torch.bool, device=device)
        self.keys = torch.zeros(B, dtype=torch.long, device=device)
        self.page_table = (torch.zeros(B, pages_per_slot, dtype=torch.int32,
                                       device=device)
                           if pages_per_slot else None)
        self.out = torch.full((B, K), -1, dtype=torch.long, device=device)
        self.n_emit = torch.zeros(B, dtype=torch.int32, device=device)
        self.steps = torch.zeros((), dtype=torch.int32, device=device)
        self.counter = torch.zeros(1, dtype=torch.long, device=device)
        self.null_pages = ([(leaf, cache_batch_axis(path))
                            for path, leaf in leaves(caches)
                            if is_paged_leaf(path)] if pages_per_slot else [])
        self.recurrent = [leaf for path, leaf in leaves(caches)
                          if is_recurrent_leaf(path)]
        self.graph = StepGraph(self._step, device, eager=not graphs)

    def load(self, tokens, index, budget, done, keys, page_table=None):
        """Start a tick from the carry (host arrays or tensors)."""
        for buf, value in ((self.tokens, tokens), (self.index, index),
                           (self.budget, budget), (self.done, done),
                           (self.keys, keys), (self.page_table, page_table)):
            if value is not None:
                buf.copy_(torch.as_tensor(value).reshape(buf.shape))
        self.entry_done.copy_(self.done)
        self.out.fill_(-1)
        self.n_emit.zero_()
        self.steps.zero_()
        self.counter.zero_()

    def key(self):
        """Every tensor the step reads or writes, and the configuration."""
        cfg, opts, params, caches = self.args
        return (cfg, opts) + tensor_key(
            params, caches, self.tokens, self.index, self.budget, self.done,
            self.entry_done, self.keys, self.page_table, self.out,
            self.n_emit, self.steps, self.counter)

    def run(self, cap: int):
        """``cap`` steps of the loaded tick."""
        key = self.key()
        for _ in range(cap):
            self.graph.step(key)

    def _step(self):
        cfg, opts, params, caches = self.args
        done, entry_done = self.done, self.entry_done
        go = ~done.all() & ~(done & ~entry_done).any()
        held = [leaf.select(axis, 0).clone() for leaf, axis in self.null_pages]
        held_states = [leaf.clone() for leaf in self.recurrent]
        logits, _ = M.decode_step(cfg, opts, params, self.tokens, caches,
                                  self.index, self.page_table,
                                  device=self.tokens.device)
        for (leaf, axis), page in zip(self.null_pages, held):
            leaf.select(axis, 0).copy_(
                torch.where(go, leaf.select(axis, 0), page))
        for leaf, old in zip(self.recurrent, held_states):
            leaf.copy_(torch.where(go, leaf, old))
        nxt = S.sample_token(logits, self.temperature, self.top_k, self.keys,
                             self.index)                           # [B]
        live = ~done & go
        self.out.index_copy_(1, self.counter,
                             torch.where(live, nxt, -1)[:, None])
        self.n_emit.add_(live.int())
        self.budget.copy_(torch.where(live, self.budget - 1, self.budget))
        newly = live & ((nxt == self.eos) | (self.budget <= 0))
        self.index.copy_(torch.where(live, self.index + 1, self.index))
        self.tokens.copy_(torch.where(live[:, None], nxt[:, None],
                                      self.tokens))
        done.logical_or_(newly)
        self.steps.add_(go.int())
        self.counter.add_(1)


class SpecTick:
    """The self-speculative tick's carry in static device buffers, and one
    draft -> verify -> accept round over them: the body a
    ``graphs.StepGraph`` captures once on the card and replays (the
    counterpart of the reference's ``_fused_spec_tick`` loop body).

    A round, for each live slot at position ``index`` with its current
    token ``tokens`` (whose KV is not yet written):

    1. **Draft**: ``K - 1`` greedy ``model.draft_step``s through the
       leading ``draft_blocks`` blocks of ``draft_params`` propose tokens;
       with the current one they form the chunk [B, K] at positions
       ``index .. index+K-1``. The draft's KV lands in the shared caches.
    2. **Verify**: ``model.verify_chunk`` runs the K positions through the
       full model (the chunk-prefill kernels), rewriting every layer's KV
       there, and returns every row's logits.
    3. **Accept** (``sampler.spec_accept``): the longest accepted prefix
       plus one bonus token, capped by the budget, by the tick's room
       ``cap - e`` and by a first EOS; the verifier's argmaxes are emitted,
       so the stream is the plain tick's.

    Rejected rows past the accepted ones hold stale KV that nothing reads
    (a query sees no key past its position) and the next round's verify
    rewrites first. Draft and verify rows at or past ``max_seq``, and a
    dead slot's, keep out of the caches (``n_valid``): dropped from a
    dense cache, zeros into a pool's null page.

    The reference loops while some slot is live with room and none newly
    finished; here that is the device flag ``go``, and a round taken
    after it fell is masked: no slot is live, so no carry value changes
    and every cache write is masked, and the null page, which masked rows
    sink zeros into, is put back as the round found it. The verify chunk
    reads the whole cache view (``live_len=None``): a graph holds one
    shape, and the chunk kernels skip each slot's key blocks past its last
    row, so the bound changes no bit.

    Buffers: ``tokens`` [B,1], ``index``, ``budget`` [B], ``done`` and its
    value at the tick's entry, the tick's quota ``cap`` (0-d), the
    ``page_table`` of a pool; a round writes ``out`` [B, T+1] (column T
    the drop column of rows that do not emit), ``e`` [B] (tokens emitted
    this tick), ``hist`` [K+2] (passes by tokens emitted; bucket K+1 the
    drop bucket of dead slots), ``passes`` [B] and ``rounds`` (rounds where
    ``go`` held). ``graphs=False`` runs the same round eagerly (the
    oracle); on the CPU it always runs eagerly."""

    def __init__(self, cfg: ModelConfig, opts: ModelOptions, params,
                 draft_params, caches, n_slots: int, T: int, K: int,
                 draft_blocks: int, eos: int, max_seq: int,
                 pages_per_slot: int = 0, *, device, graphs: bool = True):
        self.args = (cfg, opts, params, draft_params, caches)
        self.T, self.K, self.draft_blocks = T, K, draft_blocks
        self.eos, self.max_seq = eos, max_seq
        B = n_slots

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)
        self.tokens = zeros(B, 1, dtype=torch.long)
        self.index, self.budget = zeros(B), zeros(B)
        self.done = zeros(B, dtype=torch.bool)
        self.entry_done = zeros(B, dtype=torch.bool)
        self.cap = zeros()
        self.page_table = zeros(B, pages_per_slot) if pages_per_slot \
            else None
        self.out = torch.full((B, T + 1), -1, dtype=torch.long,
                              device=device)
        self.e, self.passes = zeros(B), zeros(B)
        self.hist = zeros(K + 2)
        self.rounds = zeros()
        self.kcol = torch.arange(K, dtype=torch.int32, device=device)
        self.null_pages = ([(leaf, cache_batch_axis(path))
                            for path, leaf in leaves(caches)
                            if is_paged_leaf(path)] if pages_per_slot else [])
        self.graph = StepGraph(self._round, device, eager=not graphs)

    def load(self, tokens, index, budget, done, cap: int, page_table=None):
        """Start a tick from the carry (host arrays or tensors) and its
        quota of ``cap`` tokens a slot."""
        for buf, value in ((self.tokens, tokens), (self.index, index),
                           (self.budget, budget), (self.done, done),
                           (self.page_table, page_table)):
            if value is not None:
                buf.copy_(torch.as_tensor(value).reshape(buf.shape))
        self.entry_done.copy_(self.done)
        self.cap.fill_(cap)
        self.out.fill_(-1)
        for buf in (self.e, self.passes, self.hist, self.rounds):
            buf.zero_()

    def key(self):
        """Every tensor a round reads or writes, and the configuration."""
        cfg, opts, params, draft_params, caches = self.args
        return (cfg, opts, self.K, self.draft_blocks) + tensor_key(
            params, draft_params, caches, self.tokens, self.index,
            self.budget, self.done, self.entry_done, self.cap,
            self.page_table, self.out, self.e, self.hist, self.passes,
            self.rounds)

    def run(self, rounds: int):
        """``rounds`` rounds of the loaded tick."""
        key = self.key()
        for _ in range(rounds):
            self.graph.step(key)

    def _round(self):
        cfg, opts, params, draft_params, caches = self.args
        K, dev = self.K, self.tokens.device
        done, e, cap = self.done, self.e, self.cap
        room = ~done & (e < cap)
        go = room.any() & ~(done & ~self.entry_done).any()
        live = room & go
        held = [leaf.select(axis, 0).clone() for leaf, axis in self.null_pages]
        # draft: K - 1 truncated steps; the chunk's column 0 is the token
        # the plain decode feeds next
        cur, chunk = self.tokens, [self.tokens]
        for j in range(K - 1):
            pos = self.index + j
            nv = (live & (pos < self.max_seq)).int()
            logits, _ = M.draft_step(cfg, opts, draft_params, cur, caches,
                                     pos, self.draft_blocks, self.page_table,
                                     n_valid=nv, device=dev)
            cur = logits[:, -1].argmax(-1, keepdim=True)
            chunk.append(cur)
        chunk = torch.cat(chunk, dim=1)                              # [B,K]
        # verify: the K positions through the full model in one chunk
        nv = torch.where(live, (self.max_seq - self.index).clamp(0, K), 0)
        logits, _ = M.verify_chunk(cfg, opts, params, chunk, caches,
                                   self.index, n_valid=nv,
                                   page_table=self.page_table, device=dev)
        verify = logits.argmax(-1)                                   # [B,K]
        for (leaf, axis), page in zip(self.null_pages, held):
            leaf.select(axis, 0).copy_(
                torch.where(go, leaf.select(axis, 0), page))
        # accept: the longest prefix and a bonus token, within the quotas
        n_emit, newly = S.spec_accept(chunk, verify, eos=self.eos,
                                      budget=self.budget, room=cap - e,
                                      live=live)
        emit = live[:, None] & (self.kcol[None] < n_emit[:, None])
        cols = torch.where(emit, e[:, None] + self.kcol[None], self.T)
        self.out.scatter_(1, cols.long(), verify)
        nxt = verify.gather(1, (n_emit - 1).clamp(min=0).long()[:, None])
        self.tokens.copy_(torch.where(live[:, None], nxt, self.tokens))
        step = torch.where(live, n_emit, 0)
        self.index.add_(step)
        self.budget.sub_(step)
        e.add_(step)
        self.hist.index_add_(0, torch.where(live, n_emit, K + 1).long(),
                             torch.ones_like(n_emit))
        self.passes.add_(live.int())
        self.rounds.add_(go.int())
        done.logical_or_(newly)


def _fused_tick(cfg: ModelConfig, opts: ModelOptions, K: int, eos: int,
                temperature: float, top_k: int, params, tokens, caches,
                index, budget, done, keys, max_steps: int, page_table=None,
                *, device):
    """One fused tick over ``caches`` from the given carry, through a new
    ``DecodeTick``: ``cap = min(K, max_steps)`` masked decode steps on the
    device, without a host sync. Returns (tokens, caches, index, budget,
    done, out, n_emit, steps)."""
    B = tokens.shape[0]
    tick = DecodeTick(cfg, opts, params, caches, B, K, eos, temperature,
                      top_k, 0 if page_table is None else page_table.shape[1],
                      device=device)
    tick.load(tokens, index, budget, done, keys, page_table)
    tick.run(min(K, max_steps))
    return (tick.tokens, caches, tick.index, tick.budget, tick.done,
            tick.out, tick.n_emit, tick.steps)


class ServingEngine:
    def __init__(self, cfg: ModelConfig, opts: ModelOptions, params,
                 n_slots: int = 4, max_seq: int = 512, eos: int = 1,
                 fused: bool = True, tick_tokens: int = 8,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 paged: bool = False, page_size: int = PAGE_SIZE,
                 num_pages: Optional[int] = None, kv_dtype: str = "bf16",
                 scale_granularity: Optional[str] = None,
                 chunked_prefill: bool = False, chunk_size: int = 32,
                 token_budget: int = 64,
                 reserve_pages: Optional[int] = None,
                 spec_decode: bool = False, spec_k: int = 4,
                 draft_layers: Optional[int] = None,
                 draft_quant: Optional[str] = None,
                 slo_hz: float = 0.0, mesh=None,
                 *, device="cuda", graphs: bool = True):
        """The reference's engine options, less those of the parts not
        ported yet: ``mesh`` is accepted only to be refused, and ``slo_hz``
        is refused without chunked prefill, as in the reference. The
        reference's ``stop_on_finish`` and ``prefix_cache`` are fixed on: a
        tick stops when a slot finishes, and full prompt pages are always
        shared. ``reserve_pages`` (paged) is the decode headroom admission
        never takes: n_slots by default under chunked prefill, else 0.
        ``spec_decode`` (``spec_k``, ``draft_layers`` a multiple of the
        stack's period, half the blocks by default, ``draft_quant`` None,
        "none", "int8" or "fp8") makes each tick speculative rounds
        (``SpecTick``); a quantized pool then takes token scales, and its
        default turns to them. ``graphs`` (the card only): each fused-tick
        step, or speculative round, replays one captured CUDA graph
        (``DecodeTick``, ``SpecTick``); False runs the same body eagerly,
        the oracle the graphed engine is held to."""
        if tick_tokens < 1:
            raise ValueError(f"tick_tokens must be >= 1, got {tick_tokens}")
        if mesh is not None:
            raise NotImplementedError("sharded serving (mesh=) is ROADMAP "
                                      "item 11")
        if slo_hz < 0:
            raise ValueError(f"slo_hz must be >= 0, got {slo_hz}")
        if slo_hz > 0 and not chunked_prefill:
            raise ValueError("slo_hz requires chunked_prefill=True: the SLO "
                             "controller steers the per-tick decode depth "
                             "and chunk quota, which only exist under the "
                             "token-budget scheduler")
        if kv_quant.quant_dtype(kv_dtype) is not None and not paged:
            raise ValueError("kv_dtype quantization requires paged=True "
                             "(the page pool is the quantization boundary)")
        if chunked_prefill:
            if not fused:
                raise ValueError("chunked_prefill requires the fused decode "
                                 "path (fused=True)")
            if not all(cfg.is_attn_layer(i) for i in range(cfg.num_layers)):
                raise ValueError("chunked_prefill requires attention-only "
                                 "decoders (SSM prefill state is not "
                                 "chunk-resumable yet)")
            if paged and chunk_size % page_size:
                raise ValueError(f"chunk_size {chunk_size} must divide by "
                                 f"page_size {page_size} so chunk writes "
                                 f"start page-aligned")
        self.spec_decode, self.spec_k = spec_decode, spec_k
        self.draft_blocks = self.draft_layers = 0
        self.draft_quant = draft_quant
        if spec_decode:
            if not fused:
                raise ValueError("spec_decode requires the fused decode "
                                 "path (fused=True)")
            if temperature > 0:
                raise ValueError("spec_decode is greedy-only: longest-"
                                 "prefix acceptance re-emits the verifier's "
                                 "argmax, which only matches the reference "
                                 "stream at temperature 0")
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            if cfg.encoder is not None:
                raise ValueError("spec_decode does not support "
                                 "encoder-decoder models")
            if not all(cfg.is_attn_layer(i) for i in range(cfg.num_layers)):
                raise ValueError("spec_decode requires attention-only "
                                 "decoders (SSM state cannot roll back "
                                 "rejected drafts by position re-write)")
            period, nblocks, _ = stack_plan(cfg)
            if draft_layers is None:
                self.draft_blocks = max(1, nblocks // 2)
            else:
                if draft_layers % period or not (
                        0 < draft_layers <= nblocks * period):
                    raise ValueError(
                        f"draft_layers must be a multiple of the stack "
                        f"period ({period}) in 1..{nblocks * period}, "
                        f"got {draft_layers}")
                self.draft_blocks = draft_layers // period
            self.draft_layers = self.draft_blocks * period
            if draft_quant not in (None, "none", "int8", "fp8"):
                raise ValueError(f"draft_quant must be None/'none'/'int8'/"
                                 f"'fp8', got {draft_quant!r}")
        quantized = kv_quant.quant_dtype(kv_dtype) is not None
        if scale_granularity is not None and not quantized:
            raise ValueError("scale_granularity applies only to quantized "
                             "pools (kv_dtype int8/fp8)")
        if quantized:
            if scale_granularity is None:
                scale_granularity = "token" if spec_decode else "head"
            if scale_granularity not in kv_quant.SCALE_GRANULARITIES:
                raise ValueError(
                    f"scale_granularity must be one of "
                    f"{kv_quant.SCALE_GRANULARITIES}, "
                    f"got {scale_granularity!r}")
            if spec_decode and scale_granularity == "head":
                raise ValueError(
                    "spec_decode on a quantized pool requires "
                    "scale_granularity='token': shared per-(page, head) "
                    "scales let a rejected draft row's amax requantize "
                    "accepted rows on the same page, so speculative streams "
                    "cannot stay bit-equal to the per-token reference")
        self.device = dev = resolve_device(device)
        if params["embed"].device.type != dev.type:
            raise ValueError(f"parameters are on {params['embed'].device}, "
                             f"the engine on {dev}")
        if paged and dev.type == "cuda" and page_size != PAGE_SIZE:
            raise ValueError(f"on the card the paged kernels take "
                             f"page_size {PAGE_SIZE}, got {page_size}")
        if spec_decode and paged and dev.type == "cuda" \
                and page_size != opts.prefill_band:
            # the verify pass runs the paged chunk kernel, which blocks the
            # key axis per page; the dense one blocks it per prefill_band
            raise ValueError(
                f"spec_decode with paged=True on the card requires "
                f"page_size ({page_size}) == ModelOptions.prefill_band "
                f"({opts.prefill_band})")
        if chunked_prefill and dev.type == "cuda":
            if chunk_size % PAGE_SIZE:
                raise ValueError(f"on the card chunk_size must divide by "
                                 f"{PAGE_SIZE} (the kernels' query tile "
                                 f"and page), got {chunk_size}")
            if paged and page_size != opts.prefill_band:
                # the paged chunk kernel blocks the key axis per page, the
                # dense one per prefill_band: bit-equality across
                # chunkings and layouts needs one absolute partition
                raise ValueError(
                    f"chunked_prefill with paged=True on the card requires "
                    f"page_size ({page_size}) == ModelOptions.prefill_band "
                    f"({opts.prefill_band})")
        self.scale_granularity = scale_granularity   # None when unquantized
        self.cfg, self.opts, self.params = cfg, opts, params
        self.n_slots, self.max_seq, self.eos = n_slots, max_seq, eos
        self.fused, self.tick_tokens = fused, tick_tokens
        self.temperature, self.top_k = temperature, top_k
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.index = np.zeros(n_slots, np.int32)       # per-slot position
        self.budget = np.zeros(n_slots, np.int32)
        self.tokens = np.zeros((n_slots, 1), np.int32)
        self.keys = np.zeros(n_slots, np.int64)        # slots' sample keys
        self.paged, self.page_size = paged, page_size
        self.kv_dtype = kv_dtype
        self.pool: Optional[KVPool] = None
        self._bytes_per_page = 0
        if paged:
            if max_seq % page_size:
                raise ValueError(f"max_seq {max_seq} must divide by "
                                 f"page_size {page_size}")
            pages_per_slot = max_seq // page_size
            if num_pages is None:
                # worst case every slot fills up, +1 for the null page
                num_pages = 1 + n_slots * pages_per_slot
            self.pool = KVPool(num_pages, page_size, n_slots, pages_per_slot)
            self.caches = M.init_caches(
                cfg, n_slots, max_seq, torch.float32, paged=True,
                num_pages=num_pages, page_size=page_size, kv_dtype=kv_dtype,
                scale_granularity=scale_granularity or "head", device=dev)
            self._bytes_per_page = sum(
                t.numel() * t.element_size() // num_pages
                for path, t in leaves(self.caches) if is_paged_leaf(path))
        else:
            self.caches = M.init_caches(cfg, n_slots, max_seq, torch.float32,
                                        device=dev)
        # the fused tick's buffers and step (or speculative round),
        # captured once on the card: the caches keep their storage for the
        # engine's life (every write and admission scatter is in place)
        npg = max_seq // page_size if paged else 0
        if spec_decode:
            # the weight-quantized draft: a second tree of the same dtypes
            self.draft_params = (
                kv_quant.fake_quantize_tree(params, draft_quant)
                if draft_quant in ("int8", "fp8") else params)
            self._tick = SpecTick(
                cfg, opts, params, self.draft_params, self.caches, n_slots,
                tick_tokens, spec_k, self.draft_blocks, eos, max_seq, npg,
                device=dev, graphs=graphs)
        else:
            self._tick = DecodeTick(
                cfg, opts, params, self.caches, n_slots, tick_tokens, eos,
                temperature, top_k, npg, device=dev, graphs=graphs)
        self.stats = EngineStats()
        self.masked_steps = 0       # fused-tick steps (speculative:
        #                             rounds) run after go fell
        self.generator = torch.Generator().manual_seed(seed)
        self.chunk_size = chunk_size
        self.scheduler: Optional[ChunkedScheduler] = (
            ChunkedScheduler(chunk_size, token_budget) if chunked_prefill
            else None)
        self._slo = SLOController(slo_hz) if slo_hz > 0 else None
        # slot -> last time it made progress (a chunk ran, tokens came
        # out); pool-pressure admission evicts the longest-idle stalled task
        self._last_active = np.zeros(n_slots, np.float64)
        if paged:
            # decode headroom: admission never takes the last pages an
            # in-flight decode needs to grow into
            if reserve_pages is None:
                reserve_pages = n_slots if chunked_prefill else 0
            self.pool.set_reserve(min(reserve_pages,
                                      max(0, self.pool.num_pages - 2)))

    # -- queue -----------------------------------------------------------
    def _sync(self):
        """Wait for the device (stage timing only; reads nothing back)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sample(self, logits, keys, pos):
        """Admission / per-token sampling with the tick's temperature and
        top_k (greedy by default) for rows with sample ``keys`` at
        positions ``pos`` (host arrays); returns device tokens [B]."""
        return S.sample_token(logits, self.temperature, self.top_k,
                              self._device(keys, torch.long),
                              self._device(pos, torch.long))

    def _fresh_cache1(self):
        """A zeroed batch-1 f32 dense cache for one chunked admission
        (dense engines): its chunks write it in place, and the finished
        prefill is scattered into the slot's batch row."""
        return M.init_caches(self.cfg, 1, self.max_seq, torch.float32,
                             device=self.device)

    def submit(self, req: Request):
        """Queue ``req``. A stack with Mamba2 layers refuses, here and
        before anything is drawn or queued, a prefill length (vision
        prefix + prompt) its SSD scan cannot take (``chunk_len``'s
        ``ValueError``), so an accepted request never fails at admission."""
        if not all(self.cfg.is_attn_layer(i)
                   for i in range(self.cfg.num_layers)):
            n_prefix = (self.cfg.vision.num_tokens
                        if req.patches is not None and self.cfg.vision
                        else 0)
            chunk_len(n_prefix + len(req.prompt), Q_MAX)   # ssd's chunk
        req.t_submit = time.perf_counter()
        req.sample_key = int(torch.randint(0, 2 ** 31, (),
                                           generator=self.generator))
        req.t_deadline = (req.t_submit + req.deadline_s
                          if req.deadline_s > 0 else math.inf)
        if self.scheduler is not None:
            self.scheduler.submit(req)
        else:
            insert_by_class(self.queue, req)

    @property
    def pending(self) -> int:
        """Requests not yet finished: queued + mid-prefill + in slots."""
        n = len(self.queue) + sum(r is not None for r in self.slots)
        if self.scheduler is not None:
            n += self.scheduler.pending
        return n

    def cancel(self, uid: int) -> bool:
        """Abort request ``uid`` between ticks, queued, mid-prefill
        (chunked engines: the task is dropped without requeue) or
        mid-decode: it is marked ``cancelled``, not appended to
        ``finished``, and a slot's pages return to the pool (its table row
        resets to the null page; full prompt pages its finished chunks
        registered stay in the prefix cache). Returns whether the uid was
        found."""
        if self.scheduler is not None:
            for k, r in enumerate(self.scheduler.waiting):
                if r.uid == uid:
                    self.scheduler.waiting.pop(k)
                    r.cancelled = True
                    return True
            for s, t in list(self.scheduler.tasks.items()):
                if t.req.uid == uid:
                    self.scheduler.tasks.pop(s)
                    if self.paged:
                        self.pool.free_slot(s)
                        self._update_cache_stats()
                    t.req.cancelled = True
                    return True
        for k, r in enumerate(self.queue):
            if r.uid == uid:
                self.queue.pop(k)
                r.cancelled = True
                return True
        for s in range(self.n_slots):
            req = self.slots[s]
            if req is not None and req.uid == uid:
                self.slots[s] = None
                if self.paged:
                    self.pool.free_slot(s)
                    self._update_cache_stats()
                req.cancelled = True
                return True
        return False

    # -- paged bookkeeping ------------------------------------------------
    def _prefix_page_keys(self, req: Request, n_prefix: int) -> List[bytes]:
        """``prefix_page_keys`` with this engine's configuration."""
        return prefix_page_keys(self.cfg.name, self.page_size, self.kv_dtype,
                                req.prompt, req.patches, n_prefix)

    def _update_cache_stats(self):
        st, pool = self.stats, self.pool
        st.pages_in_use = pool.pages_in_use
        st.pages_hwm = max(st.pages_hwm, pool.pages_hwm)
        st.cache_bytes_hwm = max(
            st.cache_bytes_hwm,
            pool.byte_stats(self._bytes_per_page)["bytes_in_use"])
        st.prefix_hits = pool.prefix_hits

    def _page_table_device(self):
        """The page table for the decode tick. Done slots' rows are all
        null page (``free_slot`` reset them), so their writes sink. A
        mid-prefill slot's row is live (its chunks need it), so it is
        nulled in this snapshot only: the tick's write at that slot's stale
        index must not land on chunk rows already written. It is copied
        into the decode tick's one table buffer, which its graph reads."""
        pt = self.pool.page_table
        if self.scheduler is not None and self.scheduler.tasks:
            pt = pt.copy()
            for s in self.scheduler.tasks:
                pt[s, :] = 0
        self._tick.page_table.copy_(torch.from_numpy(pt))
        return self._tick.page_table

    def _slot_req(self, s: int) -> Optional[Request]:
        """The request holding slot ``s``, decoding or mid-prefill."""
        if self.slots[s] is not None:
            return self.slots[s]
        if self.scheduler is not None and s in self.scheduler.tasks:
            return self.scheduler.tasks[s].req
        return None

    def _preempt_slot(self, s: int):
        """Evict a live slot under pool pressure: free its pages and requeue
        the request from scratch at the head of its class (greedy streams
        regenerate identically). A mid-prefill slot's chunks are dropped;
        full prompt pages its finished chunks registered stay in the prefix
        cache, so the retry may skip them."""
        self.pool.free_slot(s)
        req = self.slots[s]
        if req is not None:
            self.slots[s] = None
            req.out_tokens = []
            self.stats.record_preemption(req)
            if self.scheduler is not None:
                self.scheduler.submit(req, front=True)
            else:
                insert_by_class(self.queue, req, front=True)
        elif self.scheduler is not None:
            task = self.scheduler.requeue_task(s)
            if task is not None:
                self.stats.record_preemption(task.req)

    def _evict_longest_idle(self, exclude: int = -1) -> bool:
        """Pool-pressure admission policy: preempt the longest-idle
        *stalled* best-effort prefill task (``eviction_victims``), never a
        decoder or a task that is progressing, which free their pages by
        finishing. Returns whether a victim was evicted."""
        if self.scheduler is None:
            return False
        cands = eviction_victims(self.scheduler.tasks, exclude=exclude)
        if not cands:
            return False
        self._preempt_slot(min(cands, key=lambda s: self._last_active[s]))
        return True

    def _ensure_pages(self, steps: int, extra: int = 0):
        """Allocate pages covering every position the next tick may write
        (index .. index+steps-1 per live slot, never past its budget, and
        ``extra`` more: a speculative tick writes up to ``spec_k - 1``
        draft and verify rows past its last accepted token; rows past
        ``max_seq`` sink into the null page instead and need none) and
        copy-on-write any shared page in that range. If growth exhausts the
        pool, the live slot holding the most pages (best-effort first) is
        preempted; a single request the pool cannot hold raises. Pages a
        slot gained here get their scale rows zeroed before the tick, so the
        monotone-amax write starts clean (history independence)."""
        copies = []
        held_before: Dict[int, set] = {}
        for s in range(self.n_slots):
            if self.slots[s] is None:
                continue
            held_before[s] = set(self.pool.slot_pages[s])
            start = int(self.index[s])
            end = min(start + min(steps, max(int(self.budget[s]), 1))
                      + extra, self.max_seq)
            while True:
                try:
                    self.pool.ensure(s, end)
                    copies += self.pool.prepare_write(s, start, end)
                    break
                except PoolExhausted:
                    victims = [v for v in range(self.n_slots)
                               if v != s and self._slot_req(v) is not None]
                    if not victims:
                        raise PoolExhausted(
                            f"KV pool too small for a single request "
                            f"(slot {s} needs pages for {end} positions)")
                    # best-effort work yields first; realtime only when
                    # nothing else can free pages
                    be = [v for v in victims
                          if not is_realtime(self._slot_req(v))]
                    self._preempt_slot(max(
                        be or victims,
                        key=lambda v: len(self.pool.slot_pages[v])))
            self.slots[s].pages_used = len(self.pool.slot_pages[s])
        self._reset_fresh_scales(sorted(
            {p for s, held in held_before.items()
             if self.slots[s] is not None
             for p in self.pool.slot_pages[s]
             if p not in held}))
        self._dispatch_copies(copies)
        self._update_cache_stats()

    def _dispatch_copies(self, copies: List):
        """Materialize copy-on-write (src, dst) page pairs on the device."""
        if not copies:
            return
        src, dst = (torch.as_tensor(c, device=self.device)
                    for c in zip(*copies))
        _copy_pages_impl(self.caches, src, dst)

    def _reset_fresh_scales(self, fresh: List[int]):
        """Quantized pools: zero the scale rows of pages just handed to a
        slot, so the monotone-amax write does not inherit a dead request's
        range."""
        if not fresh or kv_quant.quant_dtype(self.kv_dtype) is None:
            return
        # the null page too, as the reference's zero-padded id list does
        _reset_page_scales_impl(self.caches, torch.as_tensor(
            [0] + list(fresh), device=self.device))

    def _clamped_budget(self, req: Request, pos: int) -> int:
        """Clamp generation to cache capacity: decode writes positions
        pos..pos+budget-1, which must stay < max_seq in both layouts."""
        budget = min(req.max_tokens - 1, self.max_seq - pos)
        if budget < req.max_tokens - 1:
            warnings.warn(
                f"request {req.uid}: max_tokens {req.max_tokens} "
                f"exceeds cache capacity (prompt {pos} + budget > "
                f"max_seq {self.max_seq}); clamping",
                RuntimeWarning, stacklevel=2)
        return budget

    def _finish_slot(self, s: int, now: float):
        req = self.slots[s]
        req.done = True
        req.t_done = now
        self.stats.record_deadline(req)
        if self.paged:
            req.pages_used = len(self.pool.slot_pages[s])
            self.pool.free_slot(s)
            self._update_cache_stats()
        self.finished.append(req)
        self.slots[s] = None

    def _admit(self):
        """Admit-stall admission: pop the queue head into every free slot.
        Per request: a pool capacity check (prompt plus the first decode
        write) before anything is paid for; vision as its own stage; the
        batch-1 f32 prefill and its first token (one readback, the TTFT
        boundary); then the page-wise (paged) or batch-row (dense) scatter.
        A request that finishes at prefill never takes the slot."""
        for s in range(self.n_slots):
            while self.slots[s] is None and self.queue:
                req = self.queue[0]
                n_prefix = (self.cfg.vision.num_tokens
                            if req.patches is not None and self.cfg.vision
                            else 0)
                pos = n_prefix + len(req.prompt)
                keys = (self._prefix_page_keys(req, n_prefix)
                        if self.paged else [])
                need = (0 if req.max_tokens <= 1
                        else min(pos + 1, self.max_seq))
                if self.paged and need and not self.pool.can_admit(need,
                                                                   keys):
                    if not any(r is not None for r in self.slots):
                        raise PoolExhausted(
                            f"KV pool ({self.pool.num_pages - 1} pages) too "
                            f"small for request {req.uid} "
                            f"({self.pool.num_pages_for(need)} pages)")
                    return          # defer until a finishing slot frees pages
                self.queue.pop(0)
                t0 = time.perf_counter()
                req.queue_s = t0 - req.t_submit
                self.stats.queue_s.append(req.queue_s)
                batch = {"tokens": req.prompt[None, :]}
                if n_prefix:
                    batch["prefix"] = M.encode_vision(
                        self.cfg, self.opts, self.params, req.patches[None],
                        device=self.device)
                    self._sync()
                    t1 = time.perf_counter()
                    self.stats.vision_time += t1 - t0
                    t0 = t1
                logits, cache1 = M.prefill(self.cfg, self.opts, self.params,
                                           batch, self.max_seq,
                                           cache_dtype=torch.float32,
                                           device=self.device)
                tok = int(self._sample(logits, [req.sample_key],
                                       [pos - 1])[0])
                self.stats.prefill_syncs += 1
                req.t_prefill = time.perf_counter()
                self.stats.prefill_time += req.t_prefill - t0
                self.stats.prefill_tokens += pos
                lanes = band_len(pos, self.opts.prefill_band, self.max_seq)
                self.stats.prefill_key_lanes += pos * lanes
                self.stats.prefill_key_lanes_full += pos * self.max_seq
                req.ttft_s = req.t_prefill - req.t_submit
                self.stats.ttft_s.append(req.ttft_s)
                req.out_tokens.append(tok)
                budget = self._clamped_budget(req, pos)
                if tok == self.eos or req.max_tokens <= 1 or budget <= 0:
                    req.done = True
                    req.t_done = req.t_prefill
                    self.stats.record_deadline(req)
                    self.finished.append(req)
                    continue
                if self.paged:
                    try:
                        pages, n_shared = self.pool.admit(s, pos, keys)
                    except PoolExhausted:
                        # can_admit() raced a cached-page eviction: defer,
                        # rolling this attempt's stats back
                        self.queue.insert(0, req)
                        req.out_tokens.pop()
                        self.stats.queue_s.pop()
                        self.stats.ttft_s.pop()
                        self.stats.prefill_tokens -= pos
                        self.stats.prefill_key_lanes -= pos * lanes
                        self.stats.prefill_key_lanes_full -= (
                            pos * self.max_seq)
                        return
                    req.pages_used = len(pages)
                    req.pages_shared = n_shared
                    # shared pages already hold this prefix's KV
                    dest = np.zeros(self.pool.pages_per_slot, np.int32)
                    dest[n_shared:len(pages)] = pages[n_shared:]
                    _scatter_pages_impl(self.caches, cache1, dest,
                                        self.page_size)
                    _scatter_slot(self.caches, cache1, s, skip_paged=True)
                    self._update_cache_stats()
                else:
                    _scatter_slot(self.caches, cache1, s)
                self.index[s] = pos
                self.budget[s] = budget
                self.tokens[s, 0] = tok
                self.keys[s] = req.sample_key
                self.slots[s] = req

    # -- one engine tick ---------------------------------------------------
    def _end_tick(self, t_tick: float, pf0: int, kl0: int):
        self.stats.tick_prefill_tokens.append(
            self.stats.prefill_tokens - pf0)
        self.stats.tick_key_lanes.append(self.stats.prefill_key_lanes - kl0)
        wall = time.perf_counter() - t_tick
        self.stats.tick_s.append(wall)
        self.stats.record_tick_wall(wall)

    def _device(self, array, dtype):
        return torch.as_tensor(array, dtype=dtype, device=self.device)

    def step(self) -> int:
        """Per-token path: one decode step, one host sync per token."""
        if self.scheduler is not None:
            raise RuntimeError("chunked_prefill engines tick via "
                               "step_fused()/run() (fused only)")
        t_tick = time.perf_counter()
        pf0, kl0 = self.stats.prefill_tokens, self.stats.prefill_key_lanes
        self._admit()
        active = [s for s in range(self.n_slots) if self.slots[s] is not None]
        if active and self.paged:
            self._ensure_pages(1)
            active = [s for s in range(self.n_slots)
                      if self.slots[s] is not None]
        if not active:
            self._end_tick(t_tick, pf0, kl0)
            return 0
        pt = self._page_table_device() if self.paged else None
        t0 = time.perf_counter()
        logits, _ = M.decode_step(
            self.cfg, self.opts, self.params,
            self._device(self.tokens, torch.long), self.caches,
            self._device(self.index, torch.int32), pt, device=self.device)
        nxt = self._sample(logits, self.keys, self.index).tolist()
        now = time.perf_counter()
        self.stats.decode_syncs += 1
        self.stats.ticks += 1
        self.stats.device_steps += 1
        self.stats.tokens_decoded += len(active)
        self.stats.decode_time += now - t0
        self.stats.decode_tick_s.append(now - t0)
        for s in active:
            req = self.slots[s]
            tok = int(nxt[s])
            req.out_tokens.append(tok)
            self.index[s] += 1
            self.budget[s] -= 1
            if tok == self.eos or self.budget[s] <= 0:
                self._finish_slot(s, now)
            else:
                self.tokens[s, 0] = tok
        self._end_tick(t_tick, pf0, kl0)
        return len(active)

    def step_fused(self) -> int:
        """Fused path: up to ``tick_tokens`` decode steps per host sync;
        a chunked engine's tick also packs prefill chunks under the token
        budget (``_tick_chunked``)."""
        if self.scheduler is not None:
            return self._tick_chunked()
        t_tick = time.perf_counter()
        pf0, kl0 = self.stats.prefill_tokens, self.stats.prefill_key_lanes
        self._admit()
        emitted = self._decode_tick(self.tick_tokens)
        self._end_tick(t_tick, pf0, kl0)
        return emitted

    def _decode_tick(self, max_steps: int) -> int:
        """The fused decode stage of one tick: ``min(max_steps,
        tick_tokens)`` device steps (a chunked engine's planned depth) and
        one readback of the out, n_emit, index, budget, done, tokens and
        steps tensors together. The carry goes into the ``DecodeTick``'s
        buffers (copies outside its graph), and each step is one replay of
        its graph on the card."""
        active = [s for s in range(self.n_slots) if self.slots[s] is not None]
        if not active:
            return 0
        cap = min(max_steps, self.tick_tokens)
        if self.paged:
            self._ensure_pages(cap, extra=self.spec_k - 1
                               if self.spec_decode else 0)
            self._page_table_device()
            # growth may have preempted a slot under pool pressure
            active = [s for s in range(self.n_slots)
                      if self.slots[s] is not None]
            if not active:
                return 0
        if self.spec_decode:
            return self._decode_tick_spec(cap, active)
        t0 = time.perf_counter()
        done0 = np.asarray([self.slots[s] is None
                            for s in range(self.n_slots)])
        tick = self._tick
        tick.load(self.tokens, self.index, self.budget, done0, self.keys)
        tick.run(cap)
        B, K = tick.out.shape
        host = torch.cat([tick.out.reshape(-1), tick.n_emit.long(),
                          tick.index.long(), tick.budget.long(),
                          tick.done.long(), tick.tokens[:, 0],
                          tick.steps.long().reshape(1)]).cpu().numpy()
        now = time.perf_counter()
        out_h = host[:B * K].reshape(B, K)
        n_emit_h, idx_h, bud_h, done_h, tok_h = \
            host[B * K:B * K + 5 * B].reshape(5, B)
        steps_h = int(host[-1])
        self.stats.decode_syncs += 1
        self.stats.ticks += 1
        self.stats.device_steps += steps_h
        self.masked_steps += cap - steps_h
        self.stats.decode_time += now - t0
        self.stats.decode_tick_s.append(now - t0)
        return self._take_tick(active, now, out_h, n_emit_h, idx_h, bud_h,
                               done_h, tok_h)

    def _take_tick(self, active: List[int], now: float, out_h, n_emit_h,
                   idx_h, bud_h, done_h, tok_h) -> int:
        """Take a decode tick's readback into the host carry: each active
        slot's ``n_emit_h`` tokens of ``out_h``, its new position, budget
        and token, and the slots that finished. Returns the tokens."""
        self.index = idx_h.astype(np.int32)
        self.budget = bud_h.astype(np.int32)
        self.tokens = tok_h.astype(np.int32)[:, None]
        emitted = 0
        for s in active:
            req = self.slots[s]
            k = int(n_emit_h[s])
            req.out_tokens.extend(int(t) for t in out_h[s, :k])
            emitted += k
            if k:
                self._last_active[s] = now
            if done_h[s]:
                self._finish_slot(s, now)
        self.stats.tokens_decoded += emitted
        return emitted

    def _decode_tick_spec(self, cap: int, active: List[int]) -> int:
        """The speculative decode stage: draft -> verify -> accept rounds
        (``SpecTick``, one graph replay a round on the card) until no slot
        has room or one newly finished. Each live slot emits at least one
        token a round, so the rounds are data-dependent: the tick replays
        ceil(r / spec_k) rounds for the r tokens the slot with the most
        room may still emit (``cap`` at first), reads the carry back, and
        goes on the same way while the reference's loop would: each
        readback is a decode sync, each round run after ``go`` fell a
        masked step. The key lanes use the reference's per-slot bounds
        (each slot's deepest verify row this tick), though the verify
        chunk reads the whole view."""
        t0 = time.perf_counter()
        st, K, tick = self.stats, self.spec_k, self._tick
        B, T = self.n_slots, self.tick_tokens
        idx0 = self.index.copy()
        done0 = np.asarray([self.slots[s] is None for s in range(B)])
        bounds = {s: band_len(min(int(idx0[s]) + cap + K - 1, self.max_seq),
                              self.opts.prefill_band, self.max_seq)
                  for s in active}
        tick.load(self.tokens, self.index, self.budget, done0, cap)
        left, run = cap, 0
        while True:
            n = -(-left // K)
            tick.run(n)
            run += n
            host = torch.cat([
                tick.out[:, :T].reshape(-1), tick.e.long(),
                tick.index.long(), tick.budget.long(), tick.done.long(),
                tick.tokens[:, 0], tick.passes.long(), tick.hist.long(),
                tick.rounds.long().reshape(1)]).cpu().numpy()
            st.decode_syncs += 1
            out_h = host[:B * T].reshape(B, T)
            e_h, idx_h, bud_h, done_h, tok_h, passes_h = \
                host[B * T:B * T + 6 * B].reshape(6, B)
            hist_h = host[B * T + 6 * B:-1]
            rounds_h = int(host[-1])
            # the reference's loop condition, on the carry read back
            room = (done_h == 0) & (e_h < cap)
            if not room.any() or ((done_h != 0) & ~done0).any():
                break
            left = int((cap - e_h[room]).max())
        now = time.perf_counter()
        st.ticks += 1
        # one round = one full-model verify chunk, the plain tick's step
        st.device_steps += rounds_h
        self.masked_steps += run - rounds_h
        vp = int(passes_h.sum())
        st.spec_verify_passes += vp
        st.spec_draft_steps += vp * (K - 1)
        st.spec_draft_pass_equiv += (vp * (K - 1) * self.draft_layers
                                     / max(1, self.cfg.num_layers))
        if len(st.spec_accept_hist) < K + 1:
            st.spec_accept_hist.extend(
                [0] * (K + 1 - len(st.spec_accept_hist)))
        for n, c in enumerate(hist_h[:K + 1]):
            st.spec_accept_hist[n] += int(c)
        for s in active:
            st.spec_key_lanes += int(passes_h[s]) * K * bounds[s]
            st.spec_key_lanes_full += int(passes_h[s]) * K * self.max_seq
        st.decode_time += now - t0
        st.decode_tick_s.append(now - t0)
        return self._take_tick(active, now, out_h, e_h, idx_h, bud_h,
                               done_h, tok_h)

    # -- chunked prefill ---------------------------------------------------
    def _admit_chunked(self):
        """Admission in scheduler mode: waiting requests take free slots as
        prefill tasks (no prompt compute yet: chunks run under the tick
        budget). A paged engine allocates chunk by chunk: shared prefix
        pages plus the first chunk's pages now, the rest as chunks arrive.
        On a prefix-cache hit chunking starts at the first position not
        shared, capped one position before the prompt's end so that the
        last position's logits are computed."""
        sched = self.scheduler
        for s in range(self.n_slots):
            # re-read the head each pass: an eviction requeues its victim
            # at the front of the waiting queue
            while (sched.waiting and self.slots[s] is None
                   and s not in sched.tasks):
                req = sched.waiting[0]
                n_prefix = (self.cfg.vision.num_tokens
                            if req.patches is not None and self.cfg.vision
                            else 0)
                total = n_prefix + len(req.prompt)
                if total > self.max_seq:
                    raise ValueError(
                        f"request {req.uid}: prompt ({total} positions) "
                        f"exceeds max_seq {self.max_seq}")
                n_skip = 0
                keys: List[bytes] = []
                if self.paged:
                    keys = self._prefix_page_keys(req, n_prefix)
                    n_hit = self.pool.match_prefix(keys)
                    # never skip the final position: its logits seed decode
                    skip_pages = min(n_hit, (total - 1) // self.page_size)
                    n_skip = skip_pages * self.page_size
                    first_len = min(total, n_skip + self.chunk_size)
                    need_total = min(
                        total + (0 if req.max_tokens <= 1 else 1),
                        self.max_seq)
                    # a request that can never complete raises now: the
                    # pool must hold the prompt and the first decode page,
                    # and, when any prompt page is new, the whole prompt
                    # outside the decode reserve
                    usable = self.pool.num_pages - 1
                    prefill_pages = self.pool.num_pages_for(total)
                    if (self.pool.num_pages_for(need_total) > usable
                            or (prefill_pages - n_hit > 0 and prefill_pages
                                > usable - self.pool.reserve)):
                        raise PoolExhausted(
                            f"KV pool ({usable} pages, {self.pool.reserve} "
                            f"reserved) too small for request {req.uid} "
                            f"({prefill_pages} prompt pages, "
                            f"{n_hit} prefix-shared)")
                    if not self.pool.can_admit(first_len, keys):
                        in_flight = any(self._slot_req(v) is not None
                                        for v in range(self.n_slots))
                        if not in_flight:
                            raise PoolExhausted(
                                f"KV pool cannot admit request {req.uid} "
                                f"with nothing in flight to free pages")
                        # evict the longest-idle stalled task and look at
                        # the (maybe new) head again; with no such victim,
                        # wait for work in flight to free pages
                        if not self._evict_longest_idle():
                            return
                        continue
                    try:
                        pages, n_shared = self.pool.admit(s, first_len, keys,
                                                          register=False)
                        # recomputed positions may land in shared pages
                        # when the skip cap pulled below the hit run
                        copies = self.pool.prepare_write(s, n_skip, total)
                    except PoolExhausted:
                        self.pool.free_slot(s)
                        return
                    req.pages_shared = n_shared
                    self._reset_fresh_scales(list(pages[n_shared:])
                                             + [d for _, d in copies])
                    self._dispatch_copies(copies)
                    self._update_cache_stats()
                sched.waiting.pop(0)
                t0 = time.perf_counter()
                req.queue_s = t0 - req.t_submit
                self.stats.queue_s.append(req.queue_s)
                batch = {"tokens": req.prompt[None, :]}
                if n_prefix:
                    if n_skip < n_prefix:
                        batch["prefix"] = M.encode_vision(
                            self.cfg, self.opts, self.params,
                            req.patches[None], device=self.device)
                        self._sync()
                        t1 = time.perf_counter()
                        self.stats.vision_time += t1 - t0
                        t0 = t1
                    else:
                        # the whole vision prefix is shared: its KV is in
                        # pool pages, so the tower does not run (no chunk
                        # reads these rows)
                        batch["prefix"] = torch.zeros(
                            1, n_prefix, self.cfg.d_model,
                            dtype=self.params["embed"].dtype,
                            device=self.device)
                embeds = M.embed_prompt(self.cfg, self.opts, self.params,
                                        batch, device=self.device)
                req.prefill_skipped = n_skip
                self.stats.prefill_skipped += n_skip
                sched.start_task(PrefillTask(
                    req=req, slot=s, total=total, n_skip=n_skip,
                    embeds=embeds,
                    cache1=None if self.paged else self._fresh_cache1(),
                    prefix_keys=keys, t_start=t0))
                self._last_active[s] = t0

    def _run_chunk(self, cp: ChunkPlan):
        """Run one planned prefill chunk: grow the slot's pages to cover it
        (paged), pad the embedding slice to ``chunk_size`` rows, run the
        positioned chunk prefill with its start and valid-row count on the
        device (no host read), and on the final chunk sample the first
        token and hand the slot to decode."""
        task, s = cp.task, cp.task.slot
        t0 = time.perf_counter()
        pt_row = None
        if self.paged:
            end = cp.start + cp.n_tok
            held0 = set(self.pool.slot_pages[s])
            stalled = False
            try:
                self.pool.ensure(s, end, use_reserve=False)
            except PoolExhausted:
                # admission-side growth must not eat the decode headroom:
                # mark the task stalled, try evicting another stalled task,
                # else retry next tick
                task.stalled = stalled = True
                if self._evict_longest_idle(exclude=s):
                    try:
                        self.pool.ensure(s, end, use_reserve=False)
                        stalled = False
                    except PoolExhausted:
                        pass
            # pages gained here, even by a raising ensure(), lose their
            # previous owner's scales
            self._reset_fresh_scales(sorted(
                p for p in self.pool.slot_pages[s] if p not in held0))
            if stalled:
                return
            pt_row = self._device(self.pool.page_table[s:s + 1], torch.int32)
        emb = task.embeds
        chunk = torch.zeros(1, self.chunk_size, emb.shape[-1],
                            dtype=emb.dtype, device=self.device)
        chunk[:, :cp.n_tok] = emb[:, cp.start:cp.start + cp.n_tok]
        start = self._device(cp.start, torch.int32)
        n_valid = self._device(cp.n_tok, torch.int32)
        # the chunk attends the live prefix [0, start + n_tok), rounded up
        # to whole bands
        live = band_len(cp.start + cp.n_tok, self.opts.prefill_band,
                        self.max_seq)
        caches = self.caches if self.paged else task.cache1
        logits, _ = M.prefill_chunk(self.cfg, self.opts, self.params, chunk,
                                    caches, start, n_valid=n_valid,
                                    page_table=pt_row, live_len=live,
                                    device=self.device)
        if self.paged:
            self.pool.register_prefix_pages(s, task.prefix_keys or (),
                                            cp.start + cp.n_tok)
            self._update_cache_stats()
        self.stats.prefill_key_lanes += self.chunk_size * live
        self.stats.prefill_key_lanes_full += self.chunk_size * self.max_seq
        task.pos = cp.start + cp.n_tok
        task.stalled = False
        self.stats.prefill_tokens += cp.n_tok
        self._last_active[s] = time.perf_counter()
        if task.pos >= task.total:
            self._finish_prefill(task, logits)
        self.stats.prefill_time += time.perf_counter() - t0

    def _finish_prefill(self, task: PrefillTask, logits):
        """Last chunk done: sample the first token (one readback, the TTFT
        boundary) from the chunk's last valid row, then finish the request
        outright (eos, max_tokens <= 1, no cache headroom) or hand the slot
        to the decode stage."""
        req, s = task.req, task.slot
        pos = task.total
        tok = int(self._sample(logits, [req.sample_key], [pos - 1])[0])
        self.stats.prefill_syncs += 1
        now = time.perf_counter()
        req.t_prefill = now
        req.ttft_s = now - req.t_submit
        self.stats.ttft_s.append(req.ttft_s)
        req.out_tokens.append(tok)
        budget = self._clamped_budget(req, pos)
        self.scheduler.finish_task(s)
        if tok == self.eos or req.max_tokens <= 1 or budget <= 0:
            req.done = True
            req.t_done = now
            self.stats.record_deadline(req)
            if self.paged:
                req.pages_used = len(self.pool.slot_pages[s])
                self.pool.free_slot(s)
                self._update_cache_stats()
            self.finished.append(req)
            return
        if self.paged:
            req.pages_used = len(self.pool.slot_pages[s])
        else:
            _scatter_slot(self.caches, task.cache1, s)
            task.cache1 = None
        self.index[s] = pos
        self.budget[s] = budget
        self.tokens[s, 0] = tok
        self.keys[s] = req.sample_key
        self.slots[s] = req
        self._last_active[s] = now

    def _tick_chunked(self) -> int:
        """One scheduler tick, in four stages:

        1. Admit (``_admit_chunked``): every free slot without a task gets
           one; ``scheduler.tasks`` then names the mid-prefill slots.
        2. Plan (``ChunkedScheduler.plan_tick``, with the SLO controller's
           context when ``slo_hz`` is set): the decode reservation first,
           then chunks in class order into the rest of the budget.
           ``n_active`` is read before chunks run, so a prefill finishing
           in this tick joins this tick's decode stage.
        3. Chunks (``_run_chunk``), each checked against live state first:
           a task preempted or finished by an earlier entry is skipped, and
           so is a chunk whose predecessor stalled (positions are written
           in order).
        4. Decode (``_decode_tick(plan.decode_steps)``).

        ``tick_prefill_tokens`` records each tick's prefill positions; no
        entry exceeds the token budget."""
        t_tick = time.perf_counter()
        pf0, kl0 = self.stats.prefill_tokens, self.stats.prefill_key_lanes
        sched = self.scheduler
        self._admit_chunked()
        n_active = sum(r is not None for r in self.slots)
        slo = None
        if self._slo is not None:
            rt_decode = [(int(self.budget[s]), req_deadline(self.slots[s]))
                         for s in range(self.n_slots)
                         if self.slots[s] is not None
                         and is_realtime(self.slots[s])]
            rt_prefill = (any(is_realtime(t.req)
                              for t in sched.tasks.values())
                          or any(is_realtime(r) for r in sched.waiting))
            slo = self._slo.plan(t_tick, self.stats.tick_ewma_s, rt_decode,
                                 rt_prefill)
        plan = sched.plan_tick(n_active, self.tick_tokens, slo=slo)
        for cp in plan.chunks:
            if sched.tasks.get(cp.task.slot) is not cp.task:
                continue    # finished or preempted earlier this tick
            if cp.task.pos != cp.start:
                continue    # an earlier chunk of this task stalled
            self._run_chunk(cp)
        emitted = 0
        if n_active:
            emitted = self._decode_tick(plan.decode_steps)
        elif plan.chunks:
            self.stats.ticks += 1
        self._end_tick(t_tick, pf0, kl0)
        return emitted

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        """Drive ticks until the queue and slots drain, or ``max_ticks`` is
        hit; a hit tick budget is surfaced as a warning with the pending
        count and the phase decomposition."""
        step = self.step_fused if self.fused else self.step
        ticks = 0
        while self.pending and ticks < max_ticks:
            step()
            ticks += 1
        if self.pending:
            queued = (len(self.scheduler.waiting) if self.scheduler
                      else len(self.queue))
            ph = self.stats.phase_report()
            diag = (f"phases vision={ph['vision']:.3f}s "
                    f"prefill={ph['prefill']:.3f}s "
                    f"decode={ph['decode']:.3f}s")
            for k in ("queue_p50", "queue_p99", "ttft_p50", "ttft_p99",
                      "decode_tick_p99"):
                if k in ph:
                    diag += f"; {k}={ph[k]:.4f}s"
            warnings.warn(
                f"ServingEngine.run: tick budget ({max_ticks}) exhausted "
                f"with {self.pending} requests pending "
                f"({queued} queued, "
                f"{sum(r is not None for r in self.slots)} in flight; "
                f"{diag})",
                RuntimeWarning, stacklevel=2)
        return self.finished


# ---------------------------------------------------------------------------
# cache maintenance, in place on the engine's cache tensors
# ---------------------------------------------------------------------------

def _scatter_slot(caches, cache1, slot: int, skip_paged: bool = False):
    """Copy a batch-1 prefill cache into slot ``slot`` of the slot caches,
    along each leaf's batch axis (``cache_batch_axis``). With
    ``skip_paged`` the pool-layout leaves (attention k/v and their scales)
    are left alone: a paged engine's admission fills them with
    ``_scatter_pages_impl`` and scatters only the slot-batched Mamba2
    states here."""
    small = dict(leaves(cache1))
    for path, big in leaves(caches):
        if skip_paged and is_paged_leaf(path):
            continue
        axis = cache_batch_axis(path)
        big.select(axis, slot).copy_(small[path].select(axis, 0))
    return caches


def _scatter_pages_impl(caches, cache1, dest_pages, page_size: int):
    """Scatter a batch-1 dense prefill cache into pool pages, quantizing on
    the way in for an int8/fp8 pool. ``dest_pages`` [pages_per_slot] (host
    ints) holds each prompt page's destination; entries 0 (prefix-shared
    pages, pages past the allocation) are write sinks into the null page:
    as in the reference's scatter, whose duplicates land in order, the
    null page ends up holding the last of them (usually an empty page past
    the prompt). A quantized page's scales are its amax / qmax at the
    pool's granularity (read from the scale leaf's shape), written beside
    the codes they encode."""
    dest = np.asarray(dest_pages).reshape(-1)
    keep = np.flatnonzero(dest)
    null = np.flatnonzero(dest == 0)
    if len(null):
        keep = np.sort(np.append(keep, null[-1]))
    big = dict(leaves(caches))
    small = dict(leaves(cache1))
    src_idx = torch.as_tensor(keep)
    for path, leaf in big.items():
        if not is_paged_leaf(path) or is_scale_leaf(path):
            continue
        stacked = cache_batch_axis(path) == 1
        dense = small[path]                     # [(nb,) 1, S, K, h]
        dst = torch.as_tensor(dest[keep], device=leaf.device)
        lead = dense.shape[:1] if stacked else ()
        rows = dense.reshape(*lead, -1, page_size, *dense.shape[-2:])
        rows = rows[:, src_idx.to(rows.device)] if stacked \
            else rows[src_idx.to(rows.device)]
        if kv_quant.is_quantized(leaf.dtype):
            sc = big[path + "_scale"]
            gran = "token" if sc.dim() == (4 if stacked else 3) else "head"
            rows, scales = kv_quant.quantize_page_rows(rows, leaf.dtype, gran)
            if stacked:
                sc[:, dst] = scales
            else:
                sc[dst] = scales
        if stacked:
            leaf[:, dst] = rows.to(leaf.dtype)
        else:
            leaf[dst] = rows.to(leaf.dtype)
    return caches


def _reset_page_scales_impl(caches, page_ids):
    """Zero the quantization-scale rows of ``page_ids`` (the null page 0 is
    harmless to reset): pages entering a slot through decode growth must
    not carry their previous owner's scales into the monotone-amax write."""
    for path, leaf in leaves(caches):
        if is_scale_leaf(path):
            if cache_batch_axis(path) == 1:
                leaf[:, page_ids] = 0.0
            else:
                leaf[page_ids] = 0.0
    return caches


def _copy_pages_impl(caches, src_pages, dst_pages):
    """Copy-on-write on the device: page dst <- page src for every pair,
    values and scales alike (0 -> 0 pairs are null-page no-ops)."""
    for path, leaf in leaves(caches):
        if is_paged_leaf(path):
            if cache_batch_axis(path) == 1:
                leaf[:, dst_pages] = leaf[:, src_pages]
            else:
                leaf[dst_pages] = leaf[src_pages]
    return caches
