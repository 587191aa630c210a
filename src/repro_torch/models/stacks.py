"""Decoder stacks: templates and the loop over layers (the port of
``repro.models.stacks`` for stacks of attention and Mamba2 mixers with a
dense, MoE or MoE + dense FFN, with dense or paged caches).

The stack is a repeating pattern of ``period`` sub-layers; parameters of
the ``L // period`` blocks are stacked on a leading axis, the ``L % period``
tail layers are kept apart, exactly as in the reference's templates. A
Python loop over the stacked axis replaces ``lax.scan``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import GLOBAL_WINDOW, ModelConfig, VisionConfig
from repro_torch.models import kv_quant
from repro_torch.models import layers as L
from repro_torch.models.params import PSpec, leaves, set_leaf, stack


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
    t = {prefix + "_w": PSpec((d,), "ones")}
    if cfg.norm == "layernorm":
        t[prefix + "_b"] = PSpec((d,), "zeros")
    return t


def attn_template(cfg: ModelConfig) -> Dict[str, PSpec]:
    d, n, k, h = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    t = {
        "wq": PSpec((d, n, h), fan_in=d),
        "wk": PSpec((d, k, h), fan_in=d),
        "wv": PSpec((d, k, h), fan_in=d),
        "wo": PSpec((n, h, d), fan_in=n * h),
    }
    if cfg.qkv_bias:
        t["bq"] = PSpec((n, h), "zeros")
        t["bk"] = PSpec((k, h), "zeros")
        t["bv"] = PSpec((k, h), "zeros")
    return t


def mlp_template(cfg: ModelConfig) -> Dict[str, PSpec]:
    d, f = cfg.d_model, cfg.d_ff
    t = {"wi": PSpec((d, f), fan_in=d), "wo_mlp": PSpec((f, d), fan_in=f)}
    if cfg.act in ("silu", "gelu"):
        t["wg"] = PSpec((d, f), fan_in=d)
    return t


def moe_template(cfg: ModelConfig) -> Dict[str, PSpec]:
    d, f = cfg.d_model, cfg.moe_d_ff
    e = max(cfg.num_experts_padded, cfg.num_experts)
    return {
        "router": PSpec((d, e), fan_in=d),
        "moe_wi": PSpec((e, d, f), fan_in=d),
        "moe_wg": PSpec((e, d, f), fan_in=d),
        "moe_wo": PSpec((e, f, d), fan_in=f),
    }


def mamba_template(cfg: ModelConfig) -> Dict[str, PSpec]:
    d = cfg.d_model
    d_in, H, P, N, G, conv_ch = L.mamba_dims(cfg)
    return {
        "w_z": PSpec((d, d_in), fan_in=d),
        "w_xbc": PSpec((d, conv_ch), fan_in=d),
        "w_dt": PSpec((d, H), fan_in=d),
        "conv_w": PSpec((cfg.ssm_conv, conv_ch), fan_in=cfg.ssm_conv),
        "conv_b": PSpec((conv_ch,), "zeros"),
        "A_log": PSpec((H,), "ssm_a"),
        "dt_bias": PSpec((H,), "ssm_dt"),
        "d_skip": PSpec((H,), "ones"),
        "mamba_norm_w": PSpec((d_in,), "ones"),
        "w_out": PSpec((d_in, d), fan_in=d_in),
    }


def layer_template(cfg: ModelConfig, kind: SubKind) -> Dict[str, PSpec]:
    if kind.cross:
        raise NotImplementedError(
            f"{cfg.name}: {kind} needs cross-attention layers "
            "(ROADMAP item 12)")
    t: Dict[str, PSpec] = {}
    t.update(_norm_template(cfg, "ln1", cfg.d_model))
    t.update(attn_template(cfg) if kind.mixer == "attn"
             else mamba_template(cfg))
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
    t = {"blocks": stack(block, nblocks)}
    if ntail:
        t["tail"] = {f"tail{j}": layer_template(cfg, kinds[j])
                     for j in range(ntail)}
    return t


def tower_template(enc: VisionConfig, d_out: int) -> Dict:
    """Vision tower (pre-LN MHA + plain-gelu MLP) + projector."""
    d, n, f = enc.d_model, enc.num_heads, enc.d_ff
    h = d // n
    layer = {
        "ln1_w": PSpec((d,), "ones"),
        "ln1_b": PSpec((d,), "zeros"),
        "wq": PSpec((d, n, h), fan_in=d),
        "wk": PSpec((d, n, h), fan_in=d),
        "wv": PSpec((d, n, h), fan_in=d),
        "wo": PSpec((n, h, d), fan_in=d),
        "ln2_w": PSpec((d,), "ones"),
        "ln2_b": PSpec((d,), "zeros"),
        "wi": PSpec((d, f), fan_in=d),
        "wo_mlp": PSpec((f, d), fan_in=f),
    }
    return {
        "in_proj": PSpec((enc.embed_dim, d), fan_in=enc.embed_dim),
        "pos": PSpec((enc.num_tokens, d), "pos"),
        "stack": stack(layer, enc.num_layers),
        "final_ln_w": PSpec((d,), "ones"),
        "final_ln_b": PSpec((d,), "zeros"),
        "out_proj": PSpec((d, d_out), fan_in=d),
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
                   live_len=None, page_table=None, n_valid=None):
    """One pre-norm mixer (attention or Mamba2) + FFN sub-layer (dense MLP
    and/or MoE on the same ``ln2`` output, summed). An attention layer's
    ``cache`` (``k``/``v``, dense or page pools, plus ``k_scale``/
    ``v_scale`` for a quantized pool) is written in place, a prefill
    chunk's rows at or past ``n_valid`` dropped; a Mamba2 layer's (``ssm``
    [B,H,P,N], ``conv`` [B, ssm_conv - 1, conv_ch]) is overwritten with the
    new states: one row with a cache runs the recurrence from them, more
    rows run the scan from zero (a prefill from position 0). Returns x."""
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
        y = L.mlp(p, h, cfg) if kind.ffn in ("dense", "moe+dense") else 0.0
        if kind.ffn in ("moe", "moe+dense"):
            y = y + L.moe(p, h, cfg, opts)
        x = x + y
    return x


def apply_decoder(params, x, cfg: ModelConfig, opts: L.ModelOptions,
                  positions, caches=None, cache_index=None, live_len=None,
                  page_table=None, n_valid=None, n_blocks=None):
    """Run the decoder stack, layer by layer. ``caches`` (from
    ``init_caches``) is updated in place; ``page_table`` [B, npg] marks
    them as page pools; ``n_valid`` masks a prefill chunk's padding rows
    (or a draft step's dead rows) out of every layer's cache write.

    ``n_blocks`` truncates the stack to its leading ``n_blocks`` stacked
    blocks: the self-speculative draft pass, which shares the parameters
    and caches of the full model and writes its layers' KV into them (the
    verify pass rewrites those rows). The tail layers are skipped then,
    even at ``n_blocks == num_blocks``, as in the reference. Returns (x,
    caches)."""
    period, nblocks, ntail = stack_plan(cfg)
    kinds = sub_kinds(cfg)
    if n_blocks is not None:
        if not 0 < n_blocks <= nblocks:
            raise ValueError(f"n_blocks must be in 1..{nblocks}, "
                             f"got {n_blocks}")
        nblocks, ntail = n_blocks, 0
    layers = [(layer_slice(params["blocks"], i)[f"sub{j}"], kinds[j],
               layer_slice(caches["blocks"], i)[f"sub{j}"] if caches else None)
              for i in range(nblocks) for j in range(period)]
    layers += [(params["tail"][f"tail{j}"], kinds[j],
                caches["tail"][f"tail{j}"] if caches else None)
               for j in range(ntail)]
    for p, kind, cache in layers:
        x = apply_sublayer(p, x, cfg, opts, kind, positions, cache=cache,
                           cache_index=cache_index, live_len=live_len,
                           page_table=page_table, n_valid=n_valid)
    return x, caches


def apply_tower(params, embeds, enc: VisionConfig):
    """Vision tower over stubbed frontend embeddings [B,T,embed_dim]."""
    x = embeds @ params["in_proj"]
    x = x + params["pos"].to(x.dtype)[None]
    pos = torch.arange(x.shape[1], device=x.device)
    for i in range(enc.num_layers):
        p = layer_slice(params["stack"], i)
        y = L.layer_norm(x, p["ln1_w"], p["ln1_b"])
        q, k, v = L._proj(y, p["wq"]), L._proj(y, p["wk"]), L._proj(y, p["wv"])
        a = L.attention_dense(q, k, v, pos, pos, GLOBAL_WINDOW, causal=False)
        x = x + a.reshape(*a.shape[:2], -1) @ p["wo"].reshape(-1, x.shape[-1])
        y = L.layer_norm(x, p["ln2_w"], p["ln2_b"])
        y = F.gelu(y @ p["wi"], approximate="tanh")
        x = x + y @ p["wo_mlp"]
    x = L.layer_norm(x, params["final_ln_w"], params["final_ln_b"])
    return x @ params["out_proj"]


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def cache_template(cfg: ModelConfig, batch: int, max_seq: int, *,
                   paged: bool = False, num_pages: int = 0,
                   page_size: int = 0, kv_dtype: str = "bf16",
                   scale_granularity: str = "head") -> Dict:
    """Shape tree of the decode cache, stacked like the parameters.

    Dense (default): per attention sub-layer, K and V buffers
    [batch, max_seq, K, h]. Paged: K and V become shared pools
    [num_pages, page_size, K, h] addressed through a per-slot page table
    (``serving.kv_pool``). ``kv_dtype`` "int8"/"fp8" (paged only) adds an
    f32 scale sibling per pool (``k_scale``/``v_scale``): [num_pages, K]
    at "head" granularity, [num_pages, page_size, K] at "token". A Mamba2
    sub-layer holds its recurrent state ``ssm`` [batch, H, P, N] and the
    conv's last inputs ``conv`` [batch, ssm_conv - 1, conv_ch], batched by
    slot in either layout."""
    period, nblocks, ntail = stack_plan(cfg)
    kinds = sub_kinds(cfg)
    quantized = kv_quant.quant_dtype(kv_dtype) is not None
    if scale_granularity not in kv_quant.SCALE_GRANULARITIES:
        raise ValueError(f"scale_granularity must be one of "
                         f"{kv_quant.SCALE_GRANULARITIES}, "
                         f"got {scale_granularity!r}")
    K, h = cfg.num_kv_heads, cfg.head_dim
    if paged:
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("paged cache_template needs num_pages/page_size")
        kv = (num_pages, page_size, K, h)
    elif quantized:
        raise ValueError("kv_dtype quantization requires the paged layout "
                         "(the page pool is the quantization boundary)")
    else:
        kv = (batch, max_seq, K, h)
    attn = {"k": PSpec(kv, "zeros"), "v": PSpec(kv, "zeros")}
    if quantized:
        sshape = ((num_pages, page_size, K) if scale_granularity == "token"
                  else (num_pages, K))
        attn["k_scale"] = PSpec(sshape, "zeros")
        attn["v_scale"] = PSpec(sshape, "zeros")
    _, H, P, N, _, conv_ch = L.mamba_dims(cfg)
    ssm = {"ssm": PSpec((batch, H, P, N), "zeros"),
           "conv": PSpec((batch, cfg.ssm_conv - 1, conv_ch), "zeros")}

    def sub(kind: SubKind):
        return dict(attn if kind.mixer == "attn" else ssm)
    t = {"blocks": stack({f"sub{j}": sub(kinds[j]) for j in range(period)},
                         nblocks)}
    if ntail:
        t["tail"] = {f"tail{j}": sub(kinds[j]) for j in range(ntail)}
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
                dtype=torch.bfloat16, *, paged: bool = False,
                num_pages: int = 0, page_size: int = 0,
                kv_dtype: str = "bf16", scale_granularity: str = "head",
                device="cuda"):
    """Zeroed caches on ``device`` (see ``cache_template``); values in
    ``dtype`` (bf16 by default) unless the pool stores codes."""
    dev = resolve_device(device)
    out: Dict = {}
    for path, spec in leaves(cache_template(
            cfg, batch, max_seq, paged=paged, num_pages=num_pages,
            page_size=page_size, kv_dtype=kv_dtype,
            scale_granularity=scale_granularity)):
        leaf_dtype = cache_dtype(path.split("/")[-1], dtype, kv_dtype)
        set_leaf(out, path, torch.zeros(spec.shape, dtype=leaf_dtype,
                                        device=dev))
    return out


def is_paged_leaf(path: str) -> bool:
    """Whether a leaf of a paged cache lives in the pool layout (leading
    axis = pages): attention ``k``/``v`` and their scale siblings, not the
    slot-batched ``ssm``/``conv`` states. Only meaningful for caches built
    with ``paged=True``."""
    return path.split("/")[-1] in ("k", "v", "k_scale", "v_scale")


def is_scale_leaf(path: str) -> bool:
    """Whether a cache leaf is a quantization scale sibling of a pool."""
    return path.split("/")[-1] in ("k_scale", "v_scale")


def is_recurrent_leaf(path: str) -> bool:
    """Whether a cache leaf is a Mamba2 state (``ssm`` or ``conv``): a
    decode step overwrites it, so running a step twice is not running it
    once."""
    return path.split("/")[-1] in ("ssm", "conv")
