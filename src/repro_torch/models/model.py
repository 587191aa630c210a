"""Top-level model API of the port, driven entirely by ModelConfig.

    template = model_template(cfg)
    params   = init_params(cfg, generator, device=...)   # or params.from_jax
    logits   = forward(cfg, opts, params, batch)
    logits, caches = prefill(cfg, opts, params, batch, max_seq)
    logits, caches = prefill(..., caches=caches, cache_index=5)  # a suffix
    embeds = embed_prompt(cfg, opts, params, batch)    # chunked prefill:
    logits, caches = prefill_chunk(cfg, opts, params, embeds[:, s:s + C],
                                   caches, s, n_valid=n)
    logits, caches = decode_step(cfg, opts, params, tok, caches, index)
    logits, caches = decode_step(..., page_table=table)   # paged pools
    logits, caches = draft_step(cfg, opts, params, tok, caches, index,
                                draft_blocks, n_valid=nv)  # speculative
    logits, caches = verify_chunk(cfg, opts, params, toks, caches, index,
                                  n_valid=nv)          # logits [B, K, V]
    toks, last, caches = decode_loop(cfg, opts, params, tok, caches,
                                     index, n_steps)   # one graph a step

``batch`` is a dict: tokens [B,S] (+ 'patches' [B,T,e] for the VLM's vision
tower, or a precomputed 'prefix' [B,T,d_model] from ``encode_vision``).
Every entry point runs on ``device`` (default ``"cuda"``); the parameters
and caches must already live there. Caches are updated in place. A stack
with Mamba2 layers (``family`` "ssm" or "hybrid") prefills from position 0
only: its scan starts from a zero state, so positioned prefill and
``prefill_chunk`` refuse it, as the reference's chunked engine does.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as P
from repro_torch.models import stacks
from repro_torch.models.graphs import StepGraph, tensor_key
from repro_torch.models.layers import ModelOptions, apply_norm
from repro_torch.models.stacks import init_caches  # re-export

__all__ = ["model_template", "forward", "prefill", "embed_prompt",
           "prefill_chunk", "decode_step", "draft_step", "verify_chunk",
           "decode_loop", "DecodeGraph",
           "encode_vision",
           "init_params", "init_caches", "ModelOptions"]


def model_template(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    if cfg.pos != "rope" or cfg.encoder is not None:
        raise NotImplementedError(f"{cfg.name}: absolute positions and "
                                  "encoder-decoder models are ROADMAP "
                                  "item 12")
    if cfg.action is not None and cfg.action.mode == "dit":
        raise NotImplementedError("the DiT action head is ROADMAP item 4")
    t: Dict = {
        "embed": P.PSpec((cfg.vocab_size, d), fan_in=d),
        "decoder": stacks.decoder_template(cfg),
    }
    t.update(stacks._norm_template(cfg, "final_norm", d))
    if not cfg.tie_embeddings:
        t["lm_head"] = P.PSpec((cfg.vocab_size, d), fan_in=d)
    if cfg.vision is not None:
        t["vision"] = stacks.tower_template(cfg.vision, d)
    return t


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda"):
    """Seeded random parameters for ``cfg`` on ``device``."""
    return P.init_params(model_template(cfg), generator, dtype, device)


def _on(x, dev, dtype=None):
    """An input (numpy array, list or tensor) as a tensor on ``dev``."""
    return torch.as_tensor(x, device=dev, dtype=dtype)


def _check_params(params, dev):
    if params["embed"].device.type != dev.type:
        raise ValueError(f"parameters are on {params['embed'].device}, "
                         f"the call asked for {dev}")


def _embed_tokens(params, tokens):
    return params["embed"][tokens]


def _encode_context(params, batch, cfg: ModelConfig, dev):
    """The vision prefix: ``batch['prefix']`` as given, else the tower over
    ``batch['patches']``, else None."""
    if "prefix" in batch:
        return _on(batch["prefix"], dev)
    if cfg.vision is None:
        return None
    if "patches" not in batch:
        raise KeyError("vision model needs batch['patches'] "
                       "(or a precomputed batch['prefix'])")
    patches = _on(batch["patches"], dev, params["vision"]["in_proj"].dtype)
    return stacks.apply_tower(params["vision"], patches, cfg.vision)


def encode_vision(cfg: ModelConfig, opts: ModelOptions, params, patches, *,
                  device="cuda"):
    """Vision tower alone: patches [B,T,e] -> prefix embeds [B,T,d_model],
    which ``prefill``/``forward`` accept as ``batch['prefix']``."""
    dev = resolve_device(device)
    if cfg.vision is None:
        raise ValueError("encode_vision requires a vision tower")
    _check_params(params, dev)
    patches = _on(patches, dev, params["vision"]["in_proj"].dtype)
    return stacks.apply_tower(params["vision"], patches, cfg.vision)


def _logits(params, x, cfg: ModelConfig):
    x = apply_norm(params, x, cfg, "final_norm")
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return x @ head.T                                     # head [V, D]


def _sequence(params, batch, cfg, dev):
    """Token embeddings for full-sequence passes (vision prefix folded in)
    and their positions [B, S]."""
    tokens = _on(batch["tokens"], dev, torch.long)
    prefix = _encode_context(params, batch, cfg, dev)
    x = _embed_tokens(params, tokens)
    if prefix is not None:
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=dev).expand(B, S)
    return x, positions


def _refuse_ssm_resume(cfg: ModelConfig):
    if not all(cfg.is_attn_layer(i) for i in range(cfg.num_layers)):
        raise NotImplementedError(
            f"{cfg.name}: Mamba2 layers prefill from position 0 only (the "
            "SSM prefill state is not chunk-resumable; ROADMAP item 12)")


def _positions(index, B: int, S: int, dev):
    """Positions [B, S] of S rows from ``index`` (int, or a 0-d or [B]
    tensor, kept on the device)."""
    start = torch.as_tensor(index, device=dev, dtype=torch.long)
    return (start.reshape(-1, 1) + torch.arange(S, device=dev)).expand(B, S)


def forward(cfg: ModelConfig, opts: ModelOptions, params, batch, *,
            device="cuda"):
    """Full-sequence forward -> logits [B, S_total, V]."""
    dev = resolve_device(device)
    _check_params(params, dev)
    x, positions = _sequence(params, batch, cfg, dev)
    x, _ = stacks.apply_decoder(params["decoder"], x, cfg, opts, positions)
    return _logits(params, x, cfg)


def prefill(cfg: ModelConfig, opts: ModelOptions, params, batch,
            max_seq: int, cache_dtype=torch.bfloat16, caches=None,
            cache_index=0, page_table=None, live_len=None, *,
            device="cuda"):
    """Process the prompt, filling a decode cache sized ``max_seq``.
    Returns (last-position logits [B,1,V], caches).

    From position 0 (the default) a fresh dense cache is allocated.
    ``cache_index > 0`` is prefill-from-position: ``batch['tokens']`` is a
    suffix starting there, written into the given ``caches`` (in place)
    and attending to everything already in them. Positioned prefill is
    tokens-only (a vision prefix fills positions 0..n_vis-1, before any
    suffix) and needs ``caches``. ``page_table`` [B, npg] routes writes and
    reads through a paged pool. ``live_len`` bounds the banded chunk
    core's key axis to ``[0, live_len)``; an int ``cache_index`` derives
    it, a device one leaves the whole view unless it is given."""
    dev = resolve_device(device)
    _check_params(params, dev)
    positioned = caches is not None or page_table is not None \
        or not (isinstance(cache_index, int) and cache_index == 0)
    if not positioned:
        x, positions = _sequence(params, batch, cfg, dev)
        caches = init_caches(cfg, x.shape[0], max_seq, cache_dtype,
                             device=dev)
        if live_len is None:
            live_len = x.shape[1]
    else:
        if caches is None:
            raise ValueError("prefill from cache_index > 0 (or through a "
                             "page table) needs existing caches")
        if not (isinstance(cache_index, int) and cache_index == 0):
            _refuse_ssm_resume(cfg)
        if "prefix" in batch or "patches" in batch:
            raise ValueError("positioned prefill is tokens-only; fold the "
                             "vision prefix in at cache_index == 0 (or use "
                             "prefill_chunk over precomputed embeddings)")
        tokens = _on(batch["tokens"], dev, torch.long)
        B, S = tokens.shape
        positions = _positions(cache_index, B, S, dev)
        x = _embed_tokens(params, tokens)
        if page_table is not None:
            page_table = _on(page_table, dev, torch.int32)
        if live_len is None and isinstance(cache_index, int):
            live_len = cache_index + S
    x, caches = stacks.apply_decoder(params["decoder"], x, cfg, opts,
                                     positions, caches=caches,
                                     cache_index=cache_index,
                                     live_len=live_len,
                                     page_table=page_table)
    return _logits(params, x[:, -1:], cfg), caches


def embed_prompt(cfg: ModelConfig, opts: ModelOptions, params, batch, *,
                 device="cuda"):
    """The prompt's embedding sequence [B, S_total, d_model] exactly as
    ``prefill`` builds it (vision prefix folded in). The chunked scheduler
    computes it once per request and slices it into ``prefill_chunk``
    calls."""
    dev = resolve_device(device)
    _check_params(params, dev)
    return _sequence(params, batch, cfg, dev)[0]


def prefill_chunk(cfg: ModelConfig, opts: ModelOptions, params, embeds,
                  caches, cache_index, n_valid=None, page_table=None,
                  live_len=None, *, device="cuda"):
    """Positioned prefill over one chunk of precomputed embeddings
    (``embed_prompt``'s output sliced to [B, C, d], zero-padded to C) at
    ``cache_index`` (int or device tensor). Returns (logits at the last
    valid row [B,1,V], caches), the caches written in place.

    The chunk's queries attend to every cache position up to their own,
    earlier chunks and prefix-cache pages alike, through the banded chunk
    core over ``[0, live_len)`` (None: the whole view). ``n_valid`` (int or
    device scalar) is how many rows are real prompt: padding rows are kept
    out of the cache (dense writes dropped, paged writes sent to the null
    page), and only row ``n_valid - 1``, picked by a device index, goes
    through the lm head."""
    dev = resolve_device(device)
    _check_params(params, dev)
    _refuse_ssm_resume(cfg)
    B, C, _ = embeds.shape
    positions = _positions(cache_index, B, C, dev)
    if page_table is not None:
        page_table = _on(page_table, dev, torch.int32)
    x, caches = stacks.apply_decoder(params["decoder"], embeds, cfg, opts,
                                     positions, caches=caches,
                                     cache_index=cache_index,
                                     page_table=page_table, n_valid=n_valid,
                                     live_len=live_len)
    last = torch.as_tensor(C if n_valid is None else n_valid, device=dev,
                           dtype=torch.long).reshape(1) - 1
    return _logits(params, x.index_select(1, last), cfg), caches


def decode_step(cfg: ModelConfig, opts: ModelOptions, params, token,
                caches, index, page_table=None, *, device="cuda"):
    """One autoregressive step. token [B,1]; index: position of the token,
    an int or a per-slot [B] tensor. ``page_table`` [B, npg] selects the
    paged layout: the caches' attention leaves are page pools (from
    ``init_caches(paged=True)``; a quantized pool carries its scale leaves)
    and positions resolve through the table. Returns (logits [B,1,V],
    caches)."""
    dev = resolve_device(device)
    _check_params(params, dev)
    token = _on(token, dev, torch.long)
    B = token.shape[0]
    positions = _positions(index, B, 1, dev)
    x = _embed_tokens(params, token)
    if page_table is not None:
        page_table = _on(page_table, dev, torch.int32)
    x, caches = stacks.apply_decoder(params["decoder"], x, cfg, opts,
                                     positions, caches=caches,
                                     cache_index=index,
                                     page_table=page_table)
    return _logits(params, x, cfg), caches


def draft_step(cfg: ModelConfig, opts: ModelOptions, params, token, caches,
               index, draft_blocks: int, page_table=None, n_valid=None, *,
               device="cuda"):
    """The self-speculative draft pass: ``decode_step`` through the
    leading ``draft_blocks`` stacked blocks only (``stacks.apply_decoder(
    n_blocks=)``), leaving through the shared final norm and lm head. Its
    layers' KV lands in the same caches, where the verify pass rewrites
    it. ``n_valid`` (0 or 1 a slot, int or [B]) keeps a dead slot's row,
    and a row past the cache, out of the cache: dropped from a dense
    cache, sent to the null page of a pool. Returns (logits [B,1,V],
    caches)."""
    dev = resolve_device(device)
    _check_params(params, dev)
    token = _on(token, dev, torch.long)
    B = token.shape[0]
    positions = _positions(index, B, 1, dev)
    x = _embed_tokens(params, token)
    if page_table is not None:
        page_table = _on(page_table, dev, torch.int32)
    x, caches = stacks.apply_decoder(params["decoder"], x, cfg, opts,
                                     positions, caches=caches,
                                     cache_index=index,
                                     page_table=page_table, n_valid=n_valid,
                                     n_blocks=draft_blocks)
    return _logits(params, x, cfg), caches


def verify_chunk(cfg: ModelConfig, opts: ModelOptions, params, tokens,
                 caches, cache_index, n_valid=None, page_table=None,
                 live_len=None, *, device="cuda"):
    """The self-speculative verify pass: K candidate tokens [B, K] a slot
    through the full model as one chunk (the chunk-prefill kernels) from
    each slot's own start ``cache_index`` (int or [B]). Returns the logits
    of every row [B, K, V] (acceptance reads all K argmaxes) and the
    caches, every layer's KV rewritten at ``cache_index .. +K-1`` (which
    erases the draft's rows and an earlier round's rejected ones before
    anything reads them). ``n_valid`` (int or [B]) keeps rows past a
    slot's cache, and a dead slot's, out of the write path; their logits
    are never accepted. ``live_len`` bounds the chunk core's key axis
    (None: the whole view); the kernels skip each slot's key blocks past
    its last row either way, so the bound changes no bit."""
    dev = resolve_device(device)
    _check_params(params, dev)
    _refuse_ssm_resume(cfg)
    tokens = _on(tokens, dev, torch.long)
    B, K = tokens.shape
    positions = _positions(cache_index, B, K, dev)
    x = _embed_tokens(params, tokens)
    if page_table is not None:
        page_table = _on(page_table, dev, torch.int32)
    x, caches = stacks.apply_decoder(params["decoder"], x, cfg, opts,
                                     positions, caches=caches,
                                     cache_index=cache_index,
                                     page_table=page_table, n_valid=n_valid,
                                     live_len=live_len)
    return _logits(params, x, cfg), caches


class DecodeGraph:
    """``decode_loop``'s static buffers and its one decode step, captured
    in a CUDA graph on the card and replayed once a token (``graphs.
    StepGraph``), reusable across calls: the CoT and action loops of a
    control step share one. Its buffers are the current token [B,1], the
    position [B], the output [B, n] and a device step counter; the step
    runs ``decode_step``, the argmax, writes ``toks[:, counter]`` through
    the counter and advances the position and the counter, with no host
    sync. The graph is keyed on every tensor it reads or writes (caches,
    parameters, buffers): a call with other caches (``prefill`` allocates
    new ones each control step) reuses it when their addresses and layout
    match and captures again when any differs, as it does for a larger
    ``n_steps``. ``eager=True`` runs the same step without a graph: the
    oracle the graphed loop is held to. On the CPU the step always runs
    eagerly, on the same buffers."""

    def __init__(self, device="cuda", *, eager: bool = False):
        self.device = resolve_device(device)
        self.runner = StepGraph(self._step, self.device, eager=eager)
        self.tok = self.idx = self.toks = self.counter = None
        self._args = None

    def _buffers(self, B: int, n_steps: int):
        if self.tok is None or self.tok.shape[0] != B \
                or self.toks.shape[1] < n_steps:
            dev = self.device
            self.tok = torch.zeros(B, 1, dtype=torch.long, device=dev)
            self.idx = torch.zeros(B, dtype=torch.int32, device=dev)
            self.toks = torch.zeros(B, n_steps, dtype=torch.long, device=dev)
            self.counter = torch.zeros(1, dtype=torch.long, device=dev)

    def _step(self):
        cfg, opts, params, caches = self._args
        logits, _ = decode_step(cfg, opts, params, self.tok, caches, self.idx,
                                device=self.device)
        nxt = logits[:, -1].argmax(-1, keepdim=True)              # [B, 1]
        self.toks.index_copy_(1, self.counter, nxt)
        self.tok.copy_(nxt)
        self.idx.add_(1)
        self.counter.add_(1)

    def run(self, cfg: ModelConfig, opts: ModelOptions, params, token,
            caches, index, n_steps: int):
        """``decode_loop`` through this graph (same arguments, less the
        device: the graph's)."""
        _check_params(params, self.device)
        tok = _on(token, self.device, torch.long)
        self._buffers(tok.shape[0], n_steps)
        self.tok.copy_(tok)
        self.idx.copy_(torch.as_tensor(index, dtype=torch.int32)
                       .reshape(-1).expand(tok.shape[0]))
        self.counter.zero_()
        self._args = (cfg, opts, params, caches)
        key = self.key()
        for _ in range(n_steps):
            self.runner.step(key)
        return self.toks[:, :n_steps].clone(), self.tok.clone(), caches

    def key(self):
        """The captured step's key: every tensor it reads or writes, and
        the configuration and options that chose its kernels."""
        cfg, opts, params, caches = self._args
        return (cfg, opts) + tensor_key(params, caches, self.tok, self.idx,
                                        self.toks, self.counter)


def decode_loop(cfg: ModelConfig, opts: ModelOptions, params, token, caches,
                index, n_steps: int, *, device="cuda",
                graph: Optional[DecodeGraph] = None):
    """``n_steps`` greedy decode steps. The position advances on the device
    and tokens stay there, so the loop never waits on the host; on the card
    each step is one replay of a captured CUDA graph (``DecodeGraph``:
    ``graph`` to reuse one across calls, else a new one). index: int start
    position or per-slot [B]. Returns (tokens [B, n_steps], last_token
    [B,1], caches)."""
    graph = graph if graph is not None else DecodeGraph(device)
    if graph.device != resolve_device(device):
        raise ValueError(f"the decode graph is on {graph.device}, the call "
                         f"asked for {device}")
    return graph.run(cfg, opts, params, token, caches, index, n_steps)
