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
    logits, caches = PrefillGraph().run(cfg, opts, params, batch,
                                        max_seq)       # one dispatch
    traj = generate_actions_dit(cfg, params, cond, noise=noise)  # DiT head

``batch`` is a dict: tokens [B,S] (+ 'patches' [B,T,e] for the VLM's vision
tower, or a precomputed 'prefix' [B,T,d_model] from ``encode_vision``; +
'frames' [B,T,e] for the encoder-decoder's audio tower, whose output the
decoder's cross-attention layers read; ``prefill`` caches its K/V for
decode).
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
from repro_torch.distributed.sharding import (constrain, dense, is_dtensor,
                                              local_call, replicated_like,
                                              shard_start)
from repro_torch.models import action as A
from repro_torch.models import params as P
from repro_torch.models import stacks
from repro_torch.models.graphs import OutputBuffers, StepGraph, tensor_key
from repro_torch.models.layers import ModelOptions, apply_norm
from repro_torch.models.stacks import init_caches  # re-export

__all__ = ["model_template", "forward", "prefill", "embed_prompt",
           "prefill_chunk", "decode_step", "draft_step", "verify_chunk",
           "decode_loop", "DecodeGraph", "PrefillGraph", "VisionGraph",
           "generate_actions_dit", "DiTGraph", "encode_vision",
           "init_params", "init_caches", "ModelOptions"]


def model_template(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    t: Dict = {
        "embed": P.PSpec((cfg.vocab_size, d), ("vocab", "embed"), fan_in=d),
        "decoder": stacks.decoder_template(cfg),
    }
    t.update(stacks._norm_template(cfg, "final_norm", d))
    if not cfg.tie_embeddings:
        t["lm_head"] = P.PSpec((cfg.vocab_size, d), ("vocab", "embed"),
                               fan_in=d)
    if cfg.pos == "absolute":
        # the reference's size: its largest decode shape (32k positions)
        t["pos"] = P.PSpec((32_768, d), (None, None), "pos")
    if cfg.encoder is not None:
        t["encoder"] = stacks.tower_template(cfg.encoder, d)
    if cfg.vision is not None:
        t["vision"] = stacks.tower_template(cfg.vision, d)
    if cfg.action is not None and cfg.action.mode == "dit":
        t["action_dit"] = A.dit_template(cfg.action, d)
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


def _embed_tokens(params, tokens, cfg: ModelConfig, positions=None,
                  shard=None):
    """Token embeddings [B,S,d], plus the absolute position table's rows
    at ``positions`` (default 0..S-1) for ``pos == "absolute"``. With
    ``shard`` and a vocab-sharded table (rank i holds rows [i*vl,
    (i+1)*vl)), each rank looks up its own rows, zeroes the ids it does
    not hold and the ranks sum: exactly one contributes each token."""
    emb = params["embed"]
    if shard is not None and emb.shape[0] != cfg.vocab_size:
        vl = emb.shape[0]
        loc = tokens - shard.rank * vl
        ok = (loc >= 0) & (loc < vl)
        x = emb[torch.where(ok, loc, 0)]
        x = shard.all_reduce_sum(torch.where(ok[..., None], x,
                                             torch.zeros_like(x)))
    elif is_dtensor(emb):
        x = _sharded_lookup(emb, tokens)
    else:
        x = emb[tokens]
    if cfg.pos == "absolute":
        if positions is None:
            positions = torch.arange(tokens.shape[-1], device=x.device)
        x = x + params["pos"][positions].to(x.dtype)
    return x


def _sharded_lookup(emb, tokens):
    """``emb[tokens]`` on DTensors (the dry run), explicitly
    (``local_call``): the ids keep their shards; the table keeps its vocab
    shards, and its width shards where the ids are whole (else it is
    gathered there). Each rank looks up the ids its rows hold and zeroes
    the others, so the rows are partial sums over the vocab's mesh dims
    (the sharded serving path's lookup, which the next constraint
    reduces)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    tokens = replicated_like(tokens, emb)
    vocab = [p.is_shard(0) and not q.is_shard()
             for p, q in zip(emb.placements, tokens.placements)]
    width = [p.is_shard(1) and not q.is_shard()
             for p, q in zip(emb.placements, tokens.placements)]
    epl = tuple(Shard(0) if v else Shard(1) if w else Replicate()
                for v, w in zip(vocab, width))
    tpl = tuple(Replicate() if v else q for v, q in zip(vocab,
                                                        tokens.placements))
    out = tuple(Partial() if v else Shard(tokens.dim()) if w else q
                for v, w, q in zip(vocab, width, tpl))
    grad = tuple(Shard(0) if v else Shard(1) if w else
                 Partial() if q.is_shard() else Replicate()
                 for v, w, q in zip(vocab, width, tpl))
    v0 = shard_start(epl, emb.device_mesh, 0, emb.shape[0])

    def lookup(e, t):
        loc = t - v0
        ok = (loc >= 0) & (loc < e.shape[0])
        x = e[torch.where(ok, loc, 0)]
        return torch.where(ok[..., None], x, torch.zeros_like(x))
    return local_call(lookup, (emb, tokens), (epl, tpl), (out,),
                      (grad, tpl))


def _encode_context(params, batch, cfg: ModelConfig, dev):
    """(cross-attention context, vision prefix): the encoder tower over
    ``batch['frames']`` (an encoder-decoder's), else None; and
    ``batch['prefix']`` as given, else the vision tower over
    ``batch['patches']``, else None."""
    ctx = prefix = None
    if cfg.encoder is not None:
        if "frames" not in batch:
            raise KeyError("encoder-decoder model needs batch['frames']")
        frames = _on(batch["frames"], dev,
                     params["encoder"]["in_proj"].dtype)
        ctx = stacks.apply_tower(params["encoder"], frames, cfg.encoder)
    if "prefix" in batch:
        prefix = _on(batch["prefix"], dev)
    elif cfg.vision is not None:
        if "patches" not in batch:
            raise KeyError("vision model needs batch['patches'] "
                           "(or a precomputed batch['prefix'])")
        patches = _on(batch["patches"], dev,
                      params["vision"]["in_proj"].dtype)
        prefix = stacks.apply_tower(params["vision"], patches, cfg.vision)
    return ctx, prefix


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


def _logits(params, x, cfg: ModelConfig, shard=None):
    """The lm head's logits; with ``shard`` and a vocab-sharded head (the
    embedding when tied) each rank's [B, S, V/n] slice is gathered to the
    whole vocab, the sharded program's one all-gather."""
    x = apply_norm(params, x, cfg, "final_norm")
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = dense(x, head.T)                             # head [V, D]
    if shard is not None and head.shape[0] != cfg.vocab_size:
        logits = shard.all_gather_last(logits)
    return constrain(logits, "batch", "act_seq", "act_vocab")


def _sequence(params, batch, cfg, dev, shard=None):
    """Token embeddings for full-sequence passes (vision prefix folded in),
    their positions [B, S] and the cross-attention context (or None)."""
    tokens = _on(batch["tokens"], dev, torch.long)
    ctx, prefix = _encode_context(params, batch, cfg, dev)
    x = _embed_tokens(params, tokens, cfg, shard=shard)
    if prefix is not None:
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=dev).expand(B, S)
    return x, positions, ctx


def _refuse_ssm_resume(cfg: ModelConfig):
    if not all(cfg.is_attn_layer(i) for i in range(cfg.num_layers)):
        raise NotImplementedError(
            f"{cfg.name}: Mamba2 layers prefill from position 0 only: the "
            "SSD scan starts from a zero state, and the reference has no "
            "chunk-resumable SSM prefill either")


def _positions(index, B: int, S: int, dev):
    """Positions [B, S] of S rows from ``index`` (int, or a 0-d or [B]
    tensor, kept on the device)."""
    start = torch.as_tensor(index, device=dev, dtype=torch.long)
    return (start.reshape(-1, 1) + torch.arange(S, device=dev)).expand(B, S)


def forward(cfg: ModelConfig, opts: ModelOptions, params, batch,
            train: bool = False, *, device="cuda"):
    """Full-sequence forward -> logits [B, S_total, V]. ``train`` lets
    ``opts.remat`` checkpoint the decoder's layers."""
    dev = resolve_device(device)
    _check_params(params, dev)
    x, positions, ctx = _sequence(params, batch, cfg, dev, opts.shard)
    x = constrain(x, "batch", "act_seq", "act_embed")
    x, _ = stacks.apply_decoder(params["decoder"], x, cfg, opts, positions,
                                ctx=ctx, train=train)
    return _logits(params, x, cfg, opts.shard)


def prefill(cfg: ModelConfig, opts: ModelOptions, params, batch,
            max_seq: int, cache_dtype=torch.bfloat16, caches=None,
            cache_index=0, page_table=None, live_len=None, *,
            device="cuda", into=None):
    """Process the prompt, filling a decode cache sized ``max_seq``.
    Returns (last-position logits [B,1,V], caches).

    From position 0 (the default) a fresh dense cache is allocated, or
    ``into`` (caches of the same template) is zeroed and filled in place
    instead: the same values, at addresses a captured graph can keep.
    ``cache_index > 0`` is prefill-from-position: ``batch['tokens']`` is a
    suffix starting there, written into the given ``caches`` (in place)
    and attending to everything already in them. Positioned prefill is
    tokens-only (a vision prefix fills positions 0..n_vis-1, before any
    suffix; an encoder-decoder's context is whole-sequence state) and
    needs ``caches``. ``opts.window_cache`` gives sliding-window layers
    ring caches, which take a prefill of at most their window, from
    position 0. ``page_table`` [B, npg] routes writes and
    reads through a paged pool. ``live_len`` bounds the banded chunk
    core's key axis to ``[0, live_len)``; an int ``cache_index`` derives
    it, a device one leaves the whole view unless it is given."""
    dev = resolve_device(device)
    _check_params(params, dev)
    positioned = caches is not None or page_table is not None \
        or not (isinstance(cache_index, int) and cache_index == 0)
    ctx = None
    if not positioned:
        x, positions, ctx = _sequence(params, batch, cfg, dev, opts.shard)
        if into is not None:
            if ctx is not None:
                raise ValueError("prefill into given caches is "
                                 "decoder-only (an encoder-decoder's "
                                 "cross K/V take the context's type)")
            caches = into
            for _, leaf in P.leaves(caches):
                leaf.zero_()
        else:
            caches = init_caches(cfg, x.shape[0], max_seq, cache_dtype,
                                 opts, device=dev)
        if ctx is not None:
            # the reference caches the cross K/V as computed, unrounded
            for path, leaf in P.leaves(caches):
                if path.split("/")[-1] in ("xk", "xv"):
                    P.set_leaf(caches, path, leaf.to(ctx.dtype))
        if live_len is None:
            live_len = x.shape[1]
    else:
        if caches is None:
            raise ValueError("prefill from cache_index > 0 (or through a "
                             "page table) needs existing caches")
        if not (isinstance(cache_index, int) and cache_index == 0):
            _refuse_ssm_resume(cfg)
        if cfg.encoder is not None or "prefix" in batch \
                or "patches" in batch:
            raise ValueError("positioned prefill is tokens-only; fold the "
                             "vision prefix in at cache_index == 0 (or use "
                             "prefill_chunk over precomputed embeddings)")
        tokens = _on(batch["tokens"], dev, torch.long)
        B, S = tokens.shape
        positions = _positions(cache_index, B, S, dev)
        x = _embed_tokens(params, tokens, cfg, positions, opts.shard)
        if page_table is not None:
            page_table = _on(page_table, dev, torch.int32)
        if live_len is None and isinstance(cache_index, int):
            live_len = cache_index + S
    x, caches = stacks.apply_decoder(params["decoder"], x, cfg, opts,
                                     positions, caches=caches,
                                     cache_index=cache_index,
                                     live_len=live_len,
                                     page_table=page_table, ctx=ctx)
    return _logits(params, x[:, -1:], cfg, opts.shard), caches


def embed_prompt(cfg: ModelConfig, opts: ModelOptions, params, batch, *,
                 device="cuda"):
    """The prompt's embedding sequence [B, S_total, d_model] exactly as
    ``prefill`` builds it (vision prefix folded in). The chunked scheduler
    computes it once per request and slices it into ``prefill_chunk``
    calls. Encoder-decoder models are not sliceable this way (their
    cross-attention context is whole-sequence state)."""
    if cfg.encoder is not None:
        raise ValueError("chunked prefill does not support encoder-decoder "
                         "models (whole-sequence cross-attention context)")
    dev = resolve_device(device)
    _check_params(params, dev)
    return _sequence(params, batch, cfg, dev, opts.shard)[0]


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
    x = constrain(embeds, "batch", "act_seq", "act_embed")
    x, caches = stacks.apply_decoder(params["decoder"], x, cfg, opts,
                                     positions, caches=caches,
                                     cache_index=cache_index,
                                     page_table=page_table, n_valid=n_valid,
                                     live_len=live_len)
    # a chunk with no valid row (a graph's masked capture) reads row 0
    last = (torch.as_tensor(C if n_valid is None else n_valid, device=dev,
                            dtype=torch.long).reshape(1) - 1).clamp(min=0)
    return _logits(params, x.index_select(1, last), cfg,
                   opts.shard), caches


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
    x = _embed_tokens(params, token, cfg, positions, opts.shard)
    x = constrain(x, "batch", "act_seq", "act_embed")
    if page_table is not None:
        page_table = _on(page_table, dev, torch.int32)
    x, caches = stacks.apply_decoder(params["decoder"], x, cfg, opts,
                                     positions, caches=caches,
                                     cache_index=index,
                                     page_table=page_table)
    return _logits(params, x, cfg, opts.shard), caches


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
    x = _embed_tokens(params, token, cfg, positions, opts.shard)
    x = constrain(x, "batch", "act_seq", "act_embed")
    if page_table is not None:
        page_table = _on(page_table, dev, torch.int32)
    x, caches = stacks.apply_decoder(params["decoder"], x, cfg, opts,
                                     positions, caches=caches,
                                     cache_index=index,
                                     page_table=page_table, n_valid=n_valid,
                                     n_blocks=draft_blocks)
    return _logits(params, x, cfg, opts.shard), caches


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
    x = _embed_tokens(params, tokens, cfg, positions, opts.shard)
    x = constrain(x, "batch", "act_seq", "act_embed")
    if page_table is not None:
        page_table = _on(page_table, dev, torch.int32)
    x, caches = stacks.apply_decoder(params["decoder"], x, cfg, opts,
                                     positions, caches=caches,
                                     cache_index=cache_index,
                                     page_table=page_table, n_valid=n_valid,
                                     live_len=live_len)
    return _logits(params, x, cfg, opts.shard), caches


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


class VisionGraph:
    """``encode_vision`` as one body, captured in a CUDA graph on the card
    and replayed (``graphs.StepGraph``): the counterpart of the reference
    engine's one-dispatch ``_jit_vision``. Static buffers, one pair a
    shape: the patches [B,T,e] and the prefix [B,T,d_model] the tower
    writes; the graph is keyed on them and on the tower's parameters.
    ``run`` returns the prefix buffer itself, valid until the next run of
    that shape. ``eager=True`` runs the same body without a graph (the
    oracle); on the CPU it always runs eagerly."""

    def __init__(self, device="cuda", *, eager: bool = False):
        self.device = resolve_device(device)
        self.runner = StepGraph(self._body, self.device, eager=eager)
        self._inputs: Dict = {}
        self._out = OutputBuffers()
        self._args = None

    def _body(self):
        cfg, opts, params, patches = self._args
        self._out.write(tuple(patches.shape), encode_vision(
            cfg, opts, params, patches, device=self.device))

    def run(self, cfg: ModelConfig, opts: ModelOptions, params, patches):
        """The prefix [B,T,d_model] of ``patches`` [B,T,e]."""
        _check_params(params, self.device)
        patches = _on(patches, self.device, params["vision"]["in_proj"].dtype)
        sig = tuple(patches.shape)
        buf = self._inputs.get(sig)
        if buf is None or buf.dtype != patches.dtype:
            self._inputs[sig] = buf = torch.zeros_like(patches)
        buf.copy_(patches)
        self._args = (cfg, opts, params, buf)
        self.runner.step((cfg, opts) + tensor_key(params["vision"], buf))
        return self._out.bufs[sig]


class PrefillGraph:
    """``prefill`` from position 0 as one body, captured in a CUDA graph on
    the card and replayed while the shapes stay (a new shape captures
    anew: ``graphs.StepGraph`` keeps one graph): the counterpart of the
    reference's one-dispatch ``_jit_prefill`` and, given
    ``batch['patches']``, of the control step's joint vision + prefill
    lowering (the tower runs in the same graph).

    Static buffers: the tokens [B,S] and the patches [B,T,e] or prefix
    [B,T,d_model], one set a shape; the last row's logits [B,1,V]; and the
    caches [B, max_seq], allocated once for the batch, length and type and
    zeroed and filled in place by every run (``prefill(into=)``: the
    values of a fresh prefill). So the caches keep one address for any
    prompt length, and a ``DecodeGraph`` kept beside this one captures
    once for any number of control steps. A graph is keyed on the shapes,
    the types and the parameters' addresses, as the reference's jit
    retraces per shape. ``run`` returns (a copy of the logits, the caches
    themselves: valid until the next run). ``eager=True`` runs the same
    body without a graph (the oracle); on the CPU it always runs eagerly.
    Decoder-only (an encoder-decoder's cross K/V are refused)."""

    def __init__(self, device="cuda", *, eager: bool = False):
        self.device = resolve_device(device)
        self.runner = StepGraph(self._body, self.device, eager=eager)
        self.caches = None
        self._caches_for = None
        self._inputs: Dict = {}
        self._out = OutputBuffers()
        self._args = None

    def _input(self, name: str, value: torch.Tensor) -> torch.Tensor:
        sig = (name, tuple(value.shape), value.dtype)
        buf = self._inputs.get(sig)
        if buf is None:
            self._inputs[sig] = buf = torch.zeros_like(value)
        buf.copy_(value)
        return buf

    def _body(self):
        cfg, opts, params, batch, max_seq, cache_dtype = self._args
        logits, _ = prefill(cfg, opts, params, batch, max_seq, cache_dtype,
                            device=self.device, into=self.caches)
        self._out.write(batch["tokens"].shape[0], logits)

    def run(self, cfg: ModelConfig, opts: ModelOptions, params, batch,
            max_seq: int, cache_dtype=torch.bfloat16):
        """``prefill(cfg, opts, params, batch, max_seq, cache_dtype)``
        through this graph: (logits [B,1,V], caches)."""
        dev = self.device
        _check_params(params, dev)
        if cfg.encoder is not None:
            raise ValueError(f"{cfg.name}: PrefillGraph is decoder-only "
                             "(run an encoder-decoder through prefill)")
        tokens = _on(batch["tokens"], dev, torch.long)
        B = tokens.shape[0]
        inputs = {"tokens": self._input("tokens", tokens)}
        if "prefix" in batch:
            inputs["prefix"] = self._input("prefix", _on(batch["prefix"],
                                                         dev))
        elif "patches" in batch and cfg.vision is not None:
            inputs["patches"] = self._input("patches", _on(
                batch["patches"], dev, params["vision"]["in_proj"].dtype))
        want = (cfg, opts, B, max_seq, cache_dtype)
        if self._caches_for != want:
            self.caches = None                # its memory goes back first
            self.caches = init_caches(cfg, B, max_seq, cache_dtype, opts,
                                      device=dev)
            self._caches_for = want
        self._args = (cfg, opts, params, inputs, max_seq, cache_dtype)
        self.runner.step((cfg, opts, max_seq, cache_dtype, tuple(inputs))
                         + tensor_key(params, self.caches,
                                      list(inputs.values())))
        return self._out.bufs[B].clone(), self.caches


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


class DiTGraph:
    """The DiT head's whole denoising loop (``dit_steps`` denoiser steps)
    as one body, captured in a CUDA graph on the card and replayed once a
    control step (``graphs.StepGraph``): the counterpart of the
    reference's one-dispatch ``lax.scan`` over the steps. Its static
    buffers are the noise, the condition, the timesteps and the
    trajectory; the graph is keyed on them and on the head's parameters,
    so a control step keeps one across calls and replays it while the
    batch, the type and the parameters stay. ``eager=True`` runs the same
    loop without a graph: the oracle the graphed loop is held to. On the
    CPU the loop always runs eagerly, on the same buffers."""

    def __init__(self, device="cuda", *, eager: bool = False):
        self.device = resolve_device(device)
        self.runner = StepGraph(self._loop, self.device, eager=eager)
        self.noise = self.cond = self.ts = self.traj = None
        self._args = None

    def _buffers(self, a, cond):
        shape = (cond.shape[0], a.horizon, a.action_dim)
        if self.noise is None or tuple(self.noise.shape) != shape \
                or self.cond.shape != cond.shape \
                or self.cond.dtype != cond.dtype \
                or self.ts.shape[0] != a.dit_steps:
            dev = self.device
            self.noise = torch.zeros(shape, dtype=cond.dtype, device=dev)
            self.cond = torch.zeros_like(cond, device=dev)
            self.traj = torch.zeros(shape, dtype=torch.float32, device=dev)
            self.ts = A.timesteps(a, dev)

    def _loop(self):
        a, p = self._args
        self.traj.copy_(A.denoise_loop(p, self.noise, self.cond, a, self.ts))

    def run(self, cfg: ModelConfig, params, cond, noise):
        """The trajectory [B, horizon, action_dim] f32 from ``noise`` under
        ``cond`` [B, d_model] (``generate_actions_dit``'s arguments)."""
        _check_params(params, self.device)
        a = cfg.action
        cond = _on(cond, self.device)
        self._buffers(a, cond)
        self.cond.copy_(cond)
        self.noise.copy_(_on(noise, self.device))
        self._args = (a, params["action_dit"])
        self.runner.step(self.key())
        return self.traj.clone()

    def key(self):
        """The captured loop's key: the head's configuration, its
        parameters and the buffers."""
        a, p = self._args
        return (a,) + tensor_key(p, self.noise, self.cond, self.ts,
                                 self.traj)


def generate_actions_dit(cfg: ModelConfig, params, cond, *, noise=None,
                         generator: Optional[torch.Generator] = None,
                         device="cuda", graph: Optional[DiTGraph] = None):
    """Continuous trajectory [B, horizon, action_dim] (f32) via the DiT head
    (``cfg.action.mode == 'dit'``) under ``cond`` [B, d_model], from
    ``noise`` [B, horizon, action_dim], else a standard normal draw of
    ``generator`` (a seed-0 generator on ``device`` when neither is
    given: the counterpart of the reference's default key). On the card
    the loop is one replay of ``graph`` (a ``DiTGraph``; a new one when
    None)."""
    if cfg.action is None or cfg.action.mode != "dit":
        raise ValueError(f"{cfg.name} has no DiT action head")
    dev = resolve_device(device)
    graph = graph if graph is not None else DiTGraph(dev)
    if graph.device != dev:
        raise ValueError(f"the DiT graph is on {graph.device}, the call "
                         f"asked for {device}")
    cond = _on(cond, dev)
    if noise is None:
        noise = A.draw_noise(cfg.action, cond, generator if generator
                             is not None else
                             torch.Generator(device=dev).manual_seed(0))
    return graph.run(cfg, params, cond, noise)
