"""Decoder stacks: templates and the loop over layers (the port of
``repro.models.stacks``: attention (self, and cross attention over an
encoder context) and Mamba2 mixers with a dense, MoE or MoE + dense FFN,
with dense, ring or paged caches).

The stack is a repeating pattern of ``period`` sub-layers; parameters of
the ``L // period`` blocks are stacked on a leading axis, the ``L % period``
tail layers are kept apart, exactly as in the reference's templates. A
Python loop over the stacked axis replaces ``lax.scan``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import GLOBAL_WINDOW, ModelConfig, VisionConfig
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import constrain, dense, serving_rules
from repro_torch.models import kv_quant
from repro_torch.models import layers as L
from repro_torch.models.params import (PSpec, leaves, set_leaf,
                                       shard_template, stack)


# ---------------------------------------------------------------------------
# pattern plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SubKind:
    mixer: str          # 'attn' | 'mamba'
    ffn: str            # 'dense' | 'moe' | 'moe+dense' | 'none'
    cross: bool
    window: int


def _kind_for_layer(cfg: ModelConfig, i: int) -> SubKind:
    mixer = "attn" if cfg.is_attn_layer(i) else "mamba"
    if cfg.family == "ssm" or (mixer == "mamba" and cfg.d_ff == 0
                               and not cfg.num_experts):
        ffn = "none"
    elif cfg.is_moe_layer(i):
        ffn = "moe+dense" if cfg.dense_residual else "moe"
    elif cfg.d_ff:
        ffn = "dense"
    else:
        ffn = "none"
    window = cfg.layer_window(i) if mixer == "attn" else GLOBAL_WINDOW
    return SubKind(mixer=mixer, ffn=ffn, cross=(cfg.family == "encdec"),
                   window=window)


def stack_plan(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(period, num_blocks, num_tail_layers)."""
    period = math.lcm(len(cfg.window_pattern), max(cfg.attn_every, 1),
                      max(cfg.moe_every, 1))
    period = min(period, cfg.num_layers)
    return period, cfg.num_layers // period, cfg.num_layers % period


def sub_kinds(cfg: ModelConfig) -> Tuple[SubKind, ...]:
    period, _, _ = stack_plan(cfg)
    kinds = tuple(_kind_for_layer(cfg, i) for i in range(period))
    for i in range(cfg.num_layers):
        if _kind_for_layer(cfg, i) != kinds[i % period]:
            raise ValueError(f"{cfg.name}: layer {i} breaks the pattern")
    return kinds


# ---------------------------------------------------------------------------
# templates
# ---------------------------------------------------------------------------

def _norm_template(cfg: ModelConfig, prefix: str, d: int) -> Dict[str, PSpec]:
    t = {prefix + "_w": PSpec((d,), (None,), "ones")}
    if cfg.norm == "layernorm":
        t[prefix + "_b"] = PSpec((d,), (None,), "zeros")
    return t


def attn_template(cfg: ModelConfig, pre: str = "") -> Dict[str, PSpec]:
    d, n, k, h = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    t = {
        pre + "wq": PSpec((d, n, h), ("embed", "heads", "head_dim"),
                          fan_in=d),
        pre + "wk": PSpec((d, k, h), ("embed", "kv_heads", "head_dim"),
                          fan_in=d),
        pre + "wv": PSpec((d, k, h), ("embed", "kv_heads", "head_dim"),
                          fan_in=d),
        pre + "wo": PSpec((n, h, d), ("heads", "head_dim", "embed"),
                          fan_in=n * h),
    }
    if cfg.qkv_bias:
        t[pre + "bq"] = PSpec((n, h), ("heads", "head_dim"), "zeros")
        t[pre + "bk"] = PSpec((k, h), ("kv_heads", "head_dim"), "zeros")
        t[pre + "bv"] = PSpec((k, h), ("kv_heads", "head_dim"), "zeros")
    return t


def mlp_template(cfg: ModelConfig) -> Dict[str, PSpec]:
    d, f = cfg.d_model, cfg.d_ff
    t = {"wi": PSpec((d, f), ("embed", "mlp"), fan_in=d),
         "wo_mlp": PSpec((f, d), ("mlp", "embed"), fan_in=f)}
    if cfg.act in ("silu", "gelu"):
        t["wg"] = PSpec((d, f), ("embed", "mlp"), fan_in=d)
    return t


def moe_template(cfg: ModelConfig) -> Dict[str, PSpec]:
    d, f = cfg.d_model, cfg.moe_d_ff
    e = max(cfg.num_experts_padded, cfg.num_experts)
    return {
        "router": PSpec((d, e), ("embed", None), fan_in=d),
        "moe_wi": PSpec((e, d, f), ("experts", "embed", "mlp"), fan_in=d),
        "moe_wg": PSpec((e, d, f), ("experts", "embed", "mlp"), fan_in=d),
        "moe_wo": PSpec((e, f, d), ("experts", "mlp", "embed"), fan_in=f),
    }


def mamba_template(cfg: ModelConfig) -> Dict[str, PSpec]:
    d = cfg.d_model
    d_in, H, P, N, G, conv_ch = L.mamba_dims(cfg)
    return {
        "w_z": PSpec((d, d_in), ("embed", "ssm_inner"), fan_in=d),
        "w_xbc": PSpec((d, conv_ch), ("embed", "ssm_inner"), fan_in=d),
        "w_dt": PSpec((d, H), ("embed", None), fan_in=d),
        "conv_w": PSpec((cfg.ssm_conv, conv_ch), ("conv", "ssm_inner"),
                        fan_in=cfg.ssm_conv),
        "conv_b": PSpec((conv_ch,), ("ssm_inner",), "zeros"),
        "A_log": PSpec((H,), (None,), "ssm_a"),
        "dt_bias": PSpec((H,), (None,), "ssm_dt"),
        "d_skip": PSpec((H,), (None,), "ones"),
        "mamba_norm_w": PSpec((d_in,), (None,), "ones"),
        "w_out": PSpec((d_in, d), ("ssm_inner", "embed"), fan_in=d_in),
    }


def layer_template(cfg: ModelConfig, kind: SubKind) -> Dict[str, PSpec]:
    t: Dict[str, PSpec] = {}
    t.update(_norm_template(cfg, "ln1", cfg.d_model))
    if kind.mixer == "attn":
        t.update(attn_template(cfg))
        if kind.cross:
            t.update(_norm_template(cfg, "ln_cross", cfg.d_model))
            t.update(attn_template(cfg, pre="x"))
    else:
        t.update(mamba_template(cfg))
    if kind.ffn != "none":
        t.update(_norm_template(cfg, "ln2", cfg.d_model))
    if kind.ffn in ("dense", "moe+dense"):
        t.update(mlp_template(cfg))
    if kind.ffn in ("moe", "moe+dense"):
        t.update(moe_template(cfg))
    return t


def decoder_template(cfg: ModelConfig) -> Dict:
    period, nblocks, ntail = stack_plan(cfg)
    kinds = sub_kinds(cfg)
    block = {f"sub{j}": layer_template(cfg, kinds[j]) for j in range(period)}
    t = {"blocks": stack(block, nblocks, "layers")}
    if ntail:
        t["tail"] = {f"tail{j}": layer_template(cfg, kinds[j])
                     for j in range(ntail)}
    return t


def tower_template(enc: VisionConfig, d_out: int) -> Dict:
    """Vision/audio encoder tower (pre-LN MHA + plain-gelu MLP) +
    projector."""
    d, n, f = enc.d_model, enc.num_heads, enc.d_ff
    h = d // n
    layer = {
        "ln1_w": PSpec((d,), (None,), "ones"),
        "ln1_b": PSpec((d,), (None,), "zeros"),
        "wq": PSpec((d, n, h), ("embed", "heads", "head_dim"), fan_in=d),
        "wk": PSpec((d, n, h), ("embed", "heads", "head_dim"), fan_in=d),
        "wv": PSpec((d, n, h), ("embed", "heads", "head_dim"), fan_in=d),
        "wo": PSpec((n, h, d), ("heads", "head_dim", "embed"), fan_in=d),
        "ln2_w": PSpec((d,), (None,), "ones"),
        "ln2_b": PSpec((d,), (None,), "zeros"),
        "wi": PSpec((d, f), ("embed", "mlp"), fan_in=d),
        "wo_mlp": PSpec((f, d), ("mlp", "embed"), fan_in=f),
    }
    return {
        "in_proj": PSpec((enc.embed_dim, d), (None, "embed"),
                         fan_in=enc.embed_dim),
        "pos": PSpec((enc.num_tokens, d), (None, None), "pos"),
        "stack": stack(layer, enc.num_layers, "layers"),
        "final_ln_w": PSpec((d,), (None,), "ones"),
        "final_ln_b": PSpec((d,), (None,), "zeros"),
        "out_proj": PSpec((d, d_out), ("embed", None), fan_in=d),
    }


# ---------------------------------------------------------------------------
# application
# ---------------------------------------------------------------------------

def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked parameter or cache dict (views, no copy)."""
    return {k: (layer_slice(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def apply_sublayer(p, x, cfg: ModelConfig, opts: L.ModelOptions,
                   kind: SubKind, positions, cache=None, cache_index=None,
                   live_len=None, page_table=None, n_valid=None, ctx=None):
    """One pre-norm mixer (attention or Mamba2) + FFN sub-layer (dense MLP
    and/or MoE on the same ``ln2`` output, summed). An attention layer's
    ``cache`` (``k``/``v``, dense, ring or page pools, plus ``k_scale``/
    ``v_scale`` for a quantized pool) is written in place, a prefill
    chunk's rows at or past ``n_valid`` dropped; a Mamba2 layer's (``ssm``
    [B,H,P,N], ``conv`` [B, ssm_conv - 1, conv_ch]) is overwritten with the
    new states: one row with a cache runs the recurrence from them, more
    rows run the scan from zero (a prefill from position 0). A
    cross-attention layer (an encoder-decoder's) adds, after the self
    attention, attention over the encoder context: its K/V are projected
    from ``ctx`` [B, T, d] (and copied into the cache's ``xk``/``xv``,
    which keep their storage, when there is a cache), or read from the
    cache when ``ctx`` is None (decode). Returns x."""
    h = L.apply_norm(p, x, cfg, "ln1")
    if kind.mixer == "attn":
        kv = None
        if cache is not None:
            kv = (cache["k"], cache["v"])
            if "k_scale" in cache:
                kv += (cache["k_scale"], cache["v_scale"])
        a, _ = L.attention(p, h, cfg, opts, kind.window, positions,
                           cache=kv, cache_index=cache_index,
                           live_len=live_len, page_table=page_table,
                           n_valid=n_valid)
        if kind.cross:
            x = x + a
            hc = L.apply_norm(p, x, cfg, "ln_cross")
            if ctx is None:
                xkv = (cache["xk"], cache["xv"])
            else:
                xkv = (L._proj(ctx, p["xwk"]), L._proj(ctx, p["xwv"]))
                if cfg.qkv_bias:
                    xkv = (xkv[0] + p["xbk"].to(xkv[0].dtype),
                           xkv[1] + p["xbv"].to(xkv[1].dtype))
                if cache is not None:
                    cache["xk"].copy_(xkv[0])
                    cache["xv"].copy_(xkv[1])
            a, _ = L.attention(p, hc, cfg, opts, GLOBAL_WINDOW, positions,
                               ctx=xkv, ctx_prefix="x", causal=False)
    else:
        decode = cache is not None and x.shape[1] == 1
        a, state, conv = L.mamba_block(
            p, h, cfg, opts, state=cache["ssm"] if cache else None,
            conv_state=cache["conv"] if cache else None, decode=decode)
        if cache is not None:
            cache["ssm"].copy_(state)
            cache["conv"].copy_(conv)
    x = x + a
    if kind.ffn != "none":
        h = L.apply_norm(p, x, cfg, "ln2")
        y = (L.mlp(p, h, cfg, opts.shard)
             if kind.ffn in ("dense", "moe+dense") else 0.0)
        if kind.ffn in ("moe", "moe+dense"):
            y = y + L.moe(p, h, cfg, opts)
        x = x + y
    return constrain(x, "batch", "act_seq", "act_embed")


def apply_decoder(params, x, cfg: ModelConfig, opts: L.ModelOptions,
                  positions, caches=None, cache_index=None, live_len=None,
                  page_table=None, n_valid=None, n_blocks=None, ctx=None,
                  train: bool = False):
    """Run the decoder stack, layer by layer. ``caches`` (from
    ``init_caches``) is updated in place; ``page_table`` [B, npg] marks
    them as page pools; ``n_valid`` masks a prefill chunk's padding rows
    (or a draft step's dead rows) out of every layer's cache write;
    ``ctx`` [B, T, d] is an encoder-decoder's context (None at decode,
    where the cross-attention layers read their cached K/V).

    ``n_blocks`` truncates the stack to its leading ``n_blocks`` stacked
    blocks: the self-speculative draft pass, which shares the parameters
    and caches of the full model and writes its layers' KV into them (the
    verify pass rewrites those rows). The tail layers are skipped then,
    even at ``n_blocks == num_blocks``, as in the reference.

    ``train`` with ``opts.remat`` runs each block (its ``period``
    sublayers) under ``torch.utils.checkpoint``, and with
    ``opts.remat_sublayers`` and ``period > 1`` each sublayer inside it
    too, as the reference's ``jax.checkpoint``s; the tail layers run as
    they are. Returns (x, caches)."""
    period, nblocks, ntail = stack_plan(cfg)
    kinds = sub_kinds(cfg)
    if n_blocks is not None:
        if not 0 < n_blocks <= nblocks:
            raise ValueError(f"n_blocks must be in 1..{nblocks}, "
                             f"got {n_blocks}")
        nblocks, ntail = n_blocks, 0
    remat = train and opts.remat
    sub_remat = remat and opts.remat_sublayers and period > 1

    def sublayer(p, kind, cache, x):
        return apply_sublayer(p, x, cfg, opts, kind, positions, cache=cache,
                              cache_index=cache_index, live_len=live_len,
                              page_table=page_table, n_valid=n_valid,
                              ctx=ctx)

    def block(x, subs, nested: bool):
        for p, kind, cache in subs:
            x = (_checkpoint(sublayer, p, kind, cache, x) if nested
                 else sublayer(p, kind, cache, x))
        return x

    for i in range(nblocks):
        subs = [(layer_slice(params["blocks"], i)[f"sub{j}"], kinds[j],
                 layer_slice(caches["blocks"], i)[f"sub{j}"] if caches
                 else None) for j in range(period)]
        x = (_checkpoint(block, x, subs, sub_remat) if remat
             else block(x, subs, False))
    tail = [(params["tail"][f"tail{j}"], kinds[j],
             caches["tail"][f"tail{j}"] if caches else None)
            for j in range(ntail)]
    return block(x, tail, False), caches


def _checkpoint(fn, *args):
    """``fn(*args)`` whose saved activations the backward recomputes; the
    layers draw no random numbers, so no RNG state is kept."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)


def apply_tower(params, embeds, enc: VisionConfig):
    """Vision/audio tower over stubbed frontend embeddings
    [B,T,embed_dim]."""
    x = dense(embeds, params["in_proj"])
    x = x + params["pos"].to(x.dtype)[None]
    pos = torch.arange(x.shape[1], device=x.device)
    for i in range(enc.num_layers):
        p = layer_slice(params["stack"], i)
        y = L.layer_norm(x, p["ln1_w"], p["ln1_b"])
        q, k, v = L._proj(y, p["wq"]), L._proj(y, p["wk"]), L._proj(y, p["wv"])
        a = (L.sharded_attention(L.attention_dense, q, k, v, pos, pos,
                                 GLOBAL_WINDOW, False)
             if SH.is_dtensor(q) else
             L.attention_dense(q, k, v, pos, pos, GLOBAL_WINDOW,
                               causal=False))
        x = x + constrain(dense(a.reshape(*a.shape[:2], -1),
                                p["wo"].reshape(-1, x.shape[-1])),
                          "batch", "act_seq", "act_embed")
        y = L.layer_norm(x, p["ln2_w"], p["ln2_b"])
        y = F.gelu(dense(y, p["wi"]), approximate="tanh")
        x = x + constrain(dense(y, p["wo_mlp"]), "batch", "act_seq",
                          "act_embed")
    x = L.layer_norm(x, params["final_ln_w"], params["final_ln_b"])
    return dense(x, params["out_proj"])


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def cache_template(cfg: ModelConfig, batch: int, max_seq: int,
                   opts: Optional[L.ModelOptions] = None, *,
                   paged: bool = False, num_pages: int = 0,
                   page_size: int = 0, kv_dtype: str = "bf16",
                   scale_granularity: str = "head") -> Dict:
    """Shape tree of the decode cache, stacked like the parameters.

    Dense (default): per attention sub-layer, K and V buffers
    [batch, max_seq, K, h]; under ``opts.window_cache`` a sliding-window
    layer's are rings of min(max_seq, window) rows. Paged: K and V become
    shared pools [num_pages, page_size, K, h] addressed through a
    per-slot page table (``serving.kv_pool``); rings and pools exclude
    each other. ``kv_dtype`` "int8"/"fp8" (paged only) adds an f32 scale
    sibling per pool (``k_scale``/``v_scale``): [num_pages, K] at "head"
    granularity, [num_pages, page_size, K] at "token". A cross-attention
    sub-layer adds the encoder context's K and V, ``xk``/``xv``
    [batch, T, K, h], and a Mamba2 sub-layer holds its recurrent state
    ``ssm`` [batch, H, P, N] and the conv's last inputs ``conv``
    [batch, ssm_conv - 1, conv_ch]: these are batched by slot in either
    layout. Under ``opts.shard`` the shapes are one rank's shard."""
    period, nblocks, ntail = stack_plan(cfg)
    kinds = sub_kinds(cfg)
    opts = opts or L.ModelOptions()
    quantized = kv_quant.quant_dtype(kv_dtype) is not None
    if scale_granularity not in kv_quant.SCALE_GRANULARITIES:
        raise ValueError(f"scale_granularity must be one of "
                         f"{kv_quant.SCALE_GRANULARITIES}, "
                         f"got {scale_granularity!r}")
    K, h = cfg.num_kv_heads, cfg.head_dim
    if paged:
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("paged cache_template needs num_pages/page_size")
        if opts.window_cache:
            raise ValueError("window_cache (per-layer ring buffers) and the "
                             "paged KV pool are mutually exclusive")
    elif quantized:
        raise ValueError("kv_dtype quantization requires the paged layout "
                         "(the page pool is the quantization boundary)")
    _, H, P, N, _, conv_ch = L.mamba_dims(cfg)

    def sub(kind: SubKind):
        if kind.mixer != "attn":
            return {"ssm": PSpec((batch, H, P, N),
                                 ("batch", None, None, None), "zeros"),
                    "conv": PSpec((batch, cfg.ssm_conv - 1, conv_ch),
                                  ("batch", None, "ssm_inner"), "zeros")}
        if paged:
            kv = (num_pages, page_size, K, h)
            kv_axes = (None, None, "act_kv_heads", None)
        else:
            seq = max_seq
            if opts.window_cache and kind.window != GLOBAL_WINDOW:
                seq = min(max_seq, kind.window)
            kv = (batch, seq, K, h)
            kv_axes = ("batch", "kv_seq", "act_kv_heads", None)
        c = {"k": PSpec(kv, kv_axes, "zeros"),
             "v": PSpec(kv, kv_axes, "zeros")}
        if quantized:
            sshape, saxes = (num_pages, K), (None, "act_kv_heads")
            if scale_granularity == "token":
                sshape = (num_pages, page_size, K)
                saxes = (None, None, "act_kv_heads")
            c["k_scale"] = PSpec(sshape, saxes, "zeros")
            c["v_scale"] = PSpec(sshape, saxes, "zeros")
        if kind.cross and cfg.encoder:
            xkv = (batch, cfg.encoder.num_tokens, K, h)
            xaxes = ("batch", None, "act_kv_heads", None)
            c["xk"] = PSpec(xkv, xaxes, "zeros")
            c["xv"] = PSpec(xkv, xaxes, "zeros")
        return c
    t = {"blocks": stack({f"sub{j}": sub(kinds[j]) for j in range(period)},
                         nblocks, "layers")}
    if ntail:
        t["tail"] = {f"tail{j}": sub(kinds[j]) for j in range(ntail)}
    if opts.shard is not None:
        # one rank's shard of a serving mesh: the KV head axis splits by
        # the serving rules (GQA-atomic), everything else is whole
        n = opts.shard.size
        t = shard_template(t, {opts.shard.axis: n},
                           serving_rules(n, cfg.num_heads, cfg.num_kv_heads),
                           whole=())
    return t


def cache_batch_axis(path: str) -> int:
    """Batch (or page) axis of a cache leaf, from its "/"-joined path:
    leaves under ``blocks`` are layer-stacked, so it sits at axis 1; tail
    leaves carry it at axis 0."""
    return 1 if path.split("/")[0] == "blocks" else 0


def cache_dtype(path_key: str, dtype, kv_dtype: str = "bf16"):
    """Storage dtype of a cache leaf named ``path_key``: the SSM state (it
    integrates over the whole stream) and scales are f32, quantized pool
    values are 1-byte codes, anything else ``dtype``."""
    if path_key in ("ssm", "k_scale", "v_scale"):
        return torch.float32
    q = kv_quant.quant_dtype(kv_dtype)
    if q is not None and path_key in ("k", "v"):
        return q
    return dtype


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                dtype=torch.bfloat16, opts: Optional[L.ModelOptions] = None,
                *, paged: bool = False, num_pages: int = 0,
                page_size: int = 0, kv_dtype: str = "bf16",
                scale_granularity: str = "head", device="cuda"):
    """Zeroed caches on ``device`` (see ``cache_template``; ``opts``
    chooses ring caches); values in ``dtype`` (bf16 by default) unless the
    pool stores codes. Under a ``global_mesh`` holding a ``DeviceMesh``
    (the dry run) each leaf is a DTensor placed by its logical axes."""
    dev = resolve_device(device)
    out: Dict = {}
    for path, spec in leaves(cache_template(
            cfg, batch, max_seq, opts, paged=paged, num_pages=num_pages,
            page_size=page_size, kv_dtype=kv_dtype,
            scale_granularity=scale_granularity)):
        leaf_dtype = cache_dtype(path.split("/")[-1], dtype, kv_dtype)
        set_leaf(out, path, SH.zeros(spec.shape, spec.axes, leaf_dtype,
                                     dev))
    return out


def is_paged_leaf(path: str) -> bool:
    """Whether a leaf of a paged cache lives in the pool layout (leading
    axis = pages): attention ``k``/``v`` and their scale siblings, not the
    slot-batched ``xk``/``xv``/``ssm``/``conv``. Only meaningful for
    caches built with ``paged=True``."""
    return path.split("/")[-1] in ("k", "v", "k_scale", "v_scale")


def is_scale_leaf(path: str) -> bool:
    """Whether a cache leaf is a quantization scale sibling of a pool."""
    return path.split("/")[-1] in ("k_scale", "v_scale")


def is_recurrent_leaf(path: str) -> bool:
    """Whether a cache leaf is a Mamba2 state (``ssm`` or ``conv``): a
    decode step overwrites it, so running a step twice is not running it
    once."""
    return path.split("/")[-1] in ("ssm", "conv")
