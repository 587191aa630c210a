"""Layer math of the port (``repro.models.layers``): norms, RoPE,
attention (dense / flash / banded fresh rows, banded chunk, decode; dense,
ring or paged caches; cross attention over an encoder context), the cache
write paths (decode rows and prefill chunks), the routed attention
sub-layer, the MLP, the capacity-dispatched mixture-of-experts FFN and
the Mamba2 mixer (its chunked SSD scan and per-token recurrence).

Everything is a function over a parameter dict in the reference's layout.
Compute dtype follows the inputs; norms and softmax run in f32. Unlike the
reference, the cache write path updates the cache tensors in place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import GLOBAL_WINDOW, ModelConfig
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.collectives import ShardGroup
from repro_torch.kernels.chunk_prefill.ops import chunk_prefill_attention
from repro_torch.kernels.chunk_prefill.paged import (
    paged_chunk_prefill_attention)
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      slot_index)
from repro_torch.kernels.decode_attention.paged import paged_decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.moe_gmm.ops import gmm_down, grouped_mlp
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.models import kv_quant

NEG_INF = -1e30


@dataclass(frozen=True)
class ModelOptions:
    """Runtime knobs the port reads. Whether an attention core runs as a
    CUDA kernel or as its plain version follows from the tensors' device."""
    dense_attn_threshold: int = 2048   # fresh attention runs dense up to this
    attn_chunk: int = 512              # q/kv chunk of the banded and the
    #                                    plain flash fresh cores
    causal_pairs: bool = False         # the plain flash core visits only the
    #                                    lower-triangular / in-window chunk
    #                                    pairs
    prefill_band: int = 32             # key block of the banded chunk core:
    #                                    one stack-wide absolute partition,
    #                                    which keeps results independent of
    #                                    how a prompt is chunked
    moe_capacity_factor: float = 1.25
    moe_per_seq_dispatch: bool = False  # slots assigned within each sequence
    moe_gather_decode: bool = False    # T*K <= E: gather the hit experts'
    #                                    weights instead of the capacity path
    window_cache: bool = False         # a sliding-window layer keeps a ring
    #                                    cache of min(max_seq, window) rows
    remat: bool = True                 # a training forward checkpoints each
    #                                    layer body (its period of
    #                                    sublayers): the backward runs it
    #                                    again instead of keeping its
    #                                    activations
    remat_sublayers: bool = False      # and, inside a body of more than one
    #                                    sublayer, each sublayer: the peak
    #                                    is one sublayer's activations
    shard: Optional[ShardGroup] = None  # the reference's shard_axis: the
    #                                    rank's group when its parameters
    #                                    and caches are one shard of a
    #                                    serving mesh; the attention and MLP
    #                                    output projections all-reduce
    #                                    their partial sums over it and the
    #                                    lm head all-gathers, only where a
    #                                    leaf is sharded (a replicated
    #                                    fallback stays collective-free)


# ---------------------------------------------------------------------------
# norms / rope / small pieces
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def layer_norm(x, w, b, eps=1e-6):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return (((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
            * w.to(x.dtype) + b.to(x.dtype))


def apply_norm(p, x, cfg: ModelConfig, prefix: str):
    if cfg.norm == "layernorm":
        return layer_norm(x, p[prefix + "_w"], p[prefix + "_b"], cfg.norm_eps)
    return rms_norm(x, p[prefix + "_w"], cfg.norm_eps)


def rope(x, positions, theta: float):
    """Llama-style rotary embedding. x [..., S, H, hd]; positions [..., S]."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., :, None].float() * freq          # [..., S, half]
    cos = torch.cos(angles)[..., None, :]               # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], -1)
    return out.to(x.dtype)


def _act(h, g, kind: str):
    if kind == "silu":
        return F.silu(g) * h
    if kind == "gelu":
        return F.gelu(g, approximate="tanh") * h
    return F.gelu(h, approximate="tanh")      # gelu_plain (no gate)


def _proj(x, w):
    """x [..., d] times a weight [d, ...] -> [..., *w.shape[1:]]."""
    return SH.dense(x, w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1],
                                                   *w.shape[1:])


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------

def _grouped_scores(q, k):
    """q [B,Sq,N,h], k [B,Sk,K,h] -> logits [B,K,G,Sq,Sk]; query head n
    uses KV head n // G."""
    B, Sq, N, h = q.shape
    K = k.shape[2]
    return torch.einsum("bskgh,btkh->bkgst", q.reshape(B, Sq, K, N // K, h),
                        k.to(q.dtype))


def _grouped_out(w, v):
    """w [B,K,G,Sq,Sk], v [B,Sk,K,h] -> [B,Sq,N,h]."""
    B, K, G, Sq, _ = w.shape
    out = torch.einsum("bkgst,btkh->bskgh", w, v.to(w.dtype))
    return out.reshape(B, Sq, K * G, v.shape[-1])


def attention_dense(q, k, v, q_pos, k_pos, window: int, causal: bool = True):
    """Plain masked attention. q [B,Sq,N,h]; k,v [B,Sk,K,h]; positions 1-D."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = _grouped_scores(q * scale, k).float()
    mask = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window != GLOBAL_WINDOW:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return _grouped_out(w, v)


def attention_flash_ref(q, k, v, q_pos, k_pos, window: int, chunk: int,
                        causal_pairs: bool = False):
    """Memory-bounded fresh attention in plain PyTorch: an online softmax
    over KV chunks, q chunk by q chunk (the reference's scanned
    ``attention_flash_ref``). The baseline schedule visits every (q chunk,
    kv chunk) pair and keeps a pair's update only where the pair holds a
    live position (``keep``, on the device); ``causal_pairs`` visits only
    the lower-triangular / in-window pairs. q [B,S,N,h]; k, v [B,Sk,K,h];
    positions 1-D; S and Sk multiples of ``chunk``."""
    B, Sq, N, h = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = N // K
    nq, nk = Sq // chunk, Sk // chunk
    qc = (q * (1.0 / math.sqrt(h))).reshape(B, nq, chunk, K, G, h)
    kc = k.reshape(B, nk, chunk, K, h)
    vc = v.reshape(B, nk, chunk, K, h)
    qpc, kpc = q_pos.reshape(nq, chunk), k_pos.reshape(nk, chunk)

    def pair(iq, jk, m, l, acc):
        """One (q chunk, kv chunk) online-softmax update."""
        qp, kp = qpc[iq], kpc[jk]
        s = torch.einsum("bskgh,btkh->bkgst", qc[:, iq], kc[:, jk]).float()
        mask = qp[:, None] >= kp[None, :]
        if window != GLOBAL_WINDOW:
            mask &= (qp[:, None] - kp[None, :]) < window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None]) * mask
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(-1)
        pv = torch.einsum("bkgst,btkh->bkgsh", p.to(q.dtype), vc[:, jk])
        return m_new, l_new, acc * corr[..., None].to(acc.dtype) + pv

    outs = []
    for iq in range(nq):
        m = torch.full((B, K, G, chunk), NEG_INF, device=q.device)
        l = torch.zeros((B, K, G, chunk), device=q.device)
        acc = torch.zeros((B, K, G, chunk, h), dtype=q.dtype,
                          device=q.device)
        if causal_pairs:
            lo = 0
            if window != GLOBAL_WINDOW:
                lo = max(0, (iq * chunk - (window - 1)) // chunk)
            for jk in range(lo, min(iq + 1, nk)):
                m, l, acc = pair(iq, jk, m, l, acc)
        else:
            qp = qpc[iq]
            for jk in range(nk):
                kp = kpc[jk]
                keep = kp.min() <= qp.max()
                if window != GLOBAL_WINDOW:
                    keep &= (qp.min() - kp.max()) < window
                new = pair(iq, jk, m, l, acc)
                m, l, acc = (torch.where(keep, a, b)
                             for a, b in zip(new, (m, l, acc)))
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype))
    out = torch.stack(outs, 3)                        # [B,K,G,nq,chunk,h]
    return out.reshape(B, K, G, Sq, h).permute(0, 3, 1, 2, 4) \
        .reshape(B, Sq, N, h)


def attention_banded(q, k, v, q_pos, k_pos, window: int, chunk: int):
    """Sliding-window fresh attention with linear work (the reference's
    ``attention_banded``): each q chunk attends to a fixed band of
    ceil(window / chunk) + 1 KV chunks ending at its own, KV left-padded
    so every band is in range (padded keys sit at position -1e9)."""
    B, Sq, N, h = q.shape
    nq = Sq // chunk
    band = (math.ceil(window / chunk) + 1) * chunk
    pad = band - chunk
    kp = F.pad(k, (0, 0, 0, 0, pad, 0))
    vp = F.pad(v, (0, 0, 0, 0, pad, 0))
    kpos_p = F.pad(k_pos, (pad, 0), value=-10 ** 9)
    outs = []
    for iq in range(nq):
        st = iq * chunk
        outs.append(attention_dense(q[:, st:st + chunk], kp[:, st:st + band],
                                    vp[:, st:st + band],
                                    q_pos[st:st + chunk],
                                    kpos_p[st:st + band], window))
    return torch.cat(outs, 1)


def band_len(live: int, band: int, limit: int) -> int:
    """Key-axis length of a banded chunk dispatch: the live prefix rounded
    up to a whole key block, clamped to the cache capacity."""
    return min(-(-live // band) * band, limit)


def live_bound(live_len, limit: int) -> int:
    """One key-axis bound from ``live_len``: None -> the whole view; an int
    as it is; a per-slot tuple/list -> its max."""
    if live_len is None:
        return limit
    if isinstance(live_len, (tuple, list)):
        return max(live_len) if live_len else limit
    return live_len


def attention_chunk_banded(q, k_cache, v_cache, index, window: int,
                           band: int):
    """Banded chunk-prefill core in plain PyTorch (the blockwise twin of
    the chunk-prefill kernel): S queries at ``index .. index+S-1`` against
    a cache view [B,L,K,h], an online softmax over fixed ``band``-sized key
    blocks on the absolute partition. A block fully masked for a row is an
    exact no-op for it. Returns [B,S,N,h] in q's dtype."""
    B, S, N, h = q.shape
    L, K = k_cache.shape[1], k_cache.shape[2]
    G = N // K
    Lp = -(-L // band) * band
    if Lp != L:             # padded lanes sit past every query: masked
        pad = (0, 0, 0, 0, 0, Lp - L)
        k_cache, v_cache = F.pad(k_cache, pad), F.pad(v_cache, pad)
    scale = 1.0 / math.sqrt(h)
    qg = (q * scale).reshape(B, S, K, G, h)
    idx = slot_index(index, B, q.device).long()
    q_pos = idx[:, None] + torch.arange(S, device=q.device)      # [B, S]
    m = torch.full((B, K, G, S), NEG_INF, device=q.device)
    l = torch.zeros((B, K, G, S), device=q.device)
    acc = torch.zeros((B, K, G, S, h), device=q.device)
    for jk in range(Lp // band):
        kj = k_cache[:, jk * band:(jk + 1) * band]
        vj = v_cache[:, jk * band:(jk + 1) * band]
        kpos = jk * band + torch.arange(band, device=q.device)
        s = torch.einsum("bskgh,btkh->bkgst", qg, kj.to(qg.dtype)).float()
        mask = kpos[None, None] <= q_pos[..., None]               # [B,S,band]
        if window != GLOBAL_WINDOW:
            mask &= (q_pos[..., None] - kpos[None, None]) < window
        s = torch.where(mask[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None]) * mask[:, None, None]
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bkgst,btkh->bkgsh", p,
                                                   vj.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, N, h).to(q.dtype)


def attention_decode(q, k_cache, v_cache, index, window: int):
    """Single-token decode against a cache, in plain PyTorch (one masked
    softmax). q [B,1,N,h]; cache [B,Smax,K,h]; index scalar or [B]."""
    B, _, N, h = q.shape
    Smax, K = k_cache.shape[1], k_cache.shape[2]
    G = N // K
    qg = (q * (1.0 / math.sqrt(h))).reshape(B, K, G, h)
    s = torch.einsum("bkgh,btkh->bkgt", qg, k_cache.to(qg.dtype)).float()
    kpos = torch.arange(Smax, device=q.device)
    idx = slot_index(index, B, q.device).long()
    valid = kpos[None] <= idx[:, None]                           # [B, Smax]
    if window != GLOBAL_WINDOW:
        valid &= (idx[:, None] - kpos[None]) < window
    s = torch.where(valid[:, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgt,btkh->bkgh", w, v_cache.to(w.dtype))
    return out.reshape(B, 1, N, h)


def attention_decode_ring(q, k_cache, v_cache, index):
    """Single-token decode against a ring cache of W rows (the window), in
    plain PyTorch: the ring holds exactly the last W positions, so the
    window is implicit and slot order does not matter; only slots not yet
    written (index < W) are masked. q [B,1,N,h]; cache [B,W,K,h]; index
    scalar or [B]."""
    B, _, N, h = q.shape
    W, K = k_cache.shape[1], k_cache.shape[2]
    qg = (q * (1.0 / math.sqrt(h))).reshape(B, K, N // K, h)
    s = torch.einsum("bkgh,btkh->bkgt", qg, k_cache.to(qg.dtype)).float()
    slot = torch.arange(W, device=q.device)
    idx = slot_index(index, B, q.device).long()
    valid = (slot[None] <= idx[:, None]) | (idx[:, None] >= W)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgt,btkh->bkgh", w, v_cache.to(w.dtype))
    return out.reshape(B, 1, N, h)


def update_cache_ring(cache, new, index):
    """Write the decode token's KV ``new`` [B,1,K,h] into a ring cache
    [B,W,K,h] at slot ``index % W`` (``index`` int or per-slot [B]), in
    place (an ``index_put_``: the leaf keeps its storage). Unlike a dense
    cache no write is dropped, as in the reference: a masked tick step
    writes what its slot's next real step writes there, and a retired
    slot's ring is replaced whole at its next admission."""
    if SH.is_dtensor(cache):
        return _sharded_row_write(cache, new, index, ring=True)
    B, W = cache.shape[:2]
    slot = slot_index(index, B, cache.device).long() % W
    cache[torch.arange(B, device=cache.device), slot] = \
        new[:, 0].to(cache.dtype)
    return cache


def update_cache(cache, new, index: int):
    """Write ``new`` [B,S,K,h] into ``cache`` [B,Smax,K,h] at position
    ``index`` (an int shared by every slot), in place."""
    cache[:, index:index + new.shape[1]] = new.to(cache.dtype)
    return cache


def chunk_write_plan(index, n_valid, B: int, C: int, smax: int, dev):
    """Where ``update_cache_chunk`` writes C rows of B slots from
    ``index`` (int or [B]) into a dense cache of ``smax`` rows: (rows
    [B,1], positions [B,C], keep [B,C]). Rows past the cache, and with
    ``n_valid`` (int or [B]) rows at or past it, are not kept; a position
    past the cache moves back by C, below the chunk's first row, so no two
    rows of one slot share a target. Computed once for a layer's K and V
    write, on the device (no host sync)."""
    r = torch.arange(C, device=dev)[None]                         # [1, C]
    pos = slot_index(index, B, dev).long()[:, None] + r           # [B, C]
    inside = pos < smax
    keep = inside
    if n_valid is not None:
        keep = inside & (r < slot_index(n_valid, B, dev).long()[:, None])
    return (torch.arange(B, device=dev)[:, None],
            torch.where(inside, pos, pos - C), keep)


def update_cache_chunk(cache, new, index, n_valid=None, plan=None):
    """Write ``new`` [B,C,K,h] into ``cache`` [B,Smax,K,h] at positions
    ``index .. index+C-1`` (``index`` int or per-slot [B] tensor), in
    place. Rows past the cache, and with ``n_valid`` (int or [B]; the
    padding tail of a partial final chunk, a dead draft row) rows at or
    past it, are dropped, as the reference's out-of-bounds scatter drops
    them: a decode step of a slot whose index reached ``Smax`` (a request
    its budget cut to the cache) writes nothing. A dropped row rewrites
    the value its target already holds (``chunk_write_plan``; ``plan``:
    one computed already)."""
    if SH.is_dtensor(cache):
        return _sharded_row_write(cache, new, index, n_valid)
    B, C = new.shape[:2]
    rows, pos, keep = plan or chunk_write_plan(index, n_valid, B, C,
                                               cache.shape[1], cache.device)
    cache[rows, pos] = torch.where(keep[..., None, None],
                                   new.to(cache.dtype), cache[rows, pos])
    return cache


def _sharded_row_write(cache, new, index, n_valid=None, ring=False):
    """A dense (``update_cache_chunk``) or ring (``update_cache_ring``)
    write into a DTensor cache [B, Smax, K, h] (the dry run), on each
    rank's shard (``local_call``): DTensor has no sharding rule for the
    in-place ``index_put_``. ``new`` [B, C, K, h] takes the cache's batch
    and head shards and is whole on every other dim; the cache keeps its
    placements. A cache sharded on its rows (``kv_seq``) takes one row a
    slot (decode), written by the rank whose rows hold its position (a
    row past the cache, or masked by ``n_valid``, by none): no collective
    beyond ``new``'s redistribution."""
    from torch.distributed.tensor import Replicate, Shard
    pl = cache.placements
    rows_sharded = any(p.is_shard(1) for p in pl)
    smax = cache.shape[1]
    off = SH.shard_start(pl, cache.device_mesh, 1, smax)

    def like_cache(t):
        if not SH.is_dtensor(t):
            return None
        if t.dim() == 0:
            return (Replicate(),) * len(pl)
        return tuple(p if p.is_shard(0) or (t.dim() == 4 and p.is_shard(2))
                     else Replicate() for p in pl)

    def write(c, n, idx, nv):
        if not rows_sharded:
            return (update_cache_ring(c, n, idx) if ring
                    else update_cache_chunk(c, n, idx, nv))
        B, C = n.shape[:2]
        if C != 1:
            raise NotImplementedError(
                f"a cache sharded on its rows takes one row a slot, got "
                f"{C}")
        pos = slot_index(idx, B, c.device).long()
        ok = pos < smax
        if ring:
            pos, ok = pos % smax, torch.ones_like(ok)
        if nv is not None:
            ok &= slot_index(nv, B, c.device) > 0
        pos = pos - off
        ok &= (pos >= 0) & (pos < c.shape[1])
        b, pos = torch.arange(B, device=c.device), pos.clamp(0, c.shape[1] - 1)
        c[b, pos] = torch.where(ok[:, None, None], n[:, 0].to(c.dtype),
                                c[b, pos])
        return c

    SH.local_call(write, (cache, new, index, n_valid),
                  [pl] + [like_cache(a) for a in (new, index, n_valid)],
                  (pl,))
    return cache


def _last_writer(pid, row, writes):
    """For each of B row writes to cells (``pid``, ``row``) [B], the last
    row ``b'`` with ``writes[b']`` that targets the same cell, or -1: the
    write that wins when XLA applies a scatter's duplicates in order. Each
    row then writes the winner's value (or, with none, what the cell
    holds), so every duplicate writes one value and the result does not
    depend on the device's write order."""
    b = torch.arange(pid.shape[0], device=pid.device)
    same = ((pid[:, None] == pid[None]) & (row[:, None] == row[None])
            & writes[None])
    return torch.where(same, b[None], -1).amax(1)


def paged_write_plan(page_table, index, B: int, ps: int, valid=None,
                     last: bool = True):
    """Where ``update_cache_paged`` writes one row of each of B slots at
    ``index`` (int or [B]) through ``page_table`` [B, npg] into pages of
    ``ps`` rows: (page ids [B], rows [B], dropped [B], live [B] or None,
    the last writer of each row's cell [B] or None). ``valid`` masks rows
    into the null page; a row at or past ``npg * ps`` that ``valid`` does
    not mask is dropped (its page column clamped for the gather). Computed
    once for a layer's K and V write, on the device; ``last`` only for
    writes of single rows (unquantized and token-scale pools)."""
    npg = page_table.shape[1]
    dev = page_table.device
    idx = slot_index(index, B, dev).long()
    col = idx // ps
    pid = page_table.long().gather(1, col.clamp(max=npg - 1)[:, None])[:, 0]
    drop, live = col >= npg, None
    if valid is not None:
        live = torch.as_tensor(valid, device=dev).reshape(-1).expand(B) \
            .bool()
        drop = drop & live
        pid = torch.where(live, pid, 0)
    row = idx % ps
    return (pid, row, drop, live,
            _last_writer(pid, row, ~drop) if last else None)


def update_cache_paged(pages, new, page_table, index, scales=None,
                       valid=None, plan=None):
    """Write the decode token's KV ``new`` [B,1,K,h] into the page pool
    ``pages`` [P, ps, K, h] in place, quantizing on write for an int8/fp8
    pool. Position i of slot b lives at (page_table[b, i // ps], i % ps);
    ``index`` is an int or per-slot [B]. Returns ``(pages, scales)``.

    A slot whose table entry is the null page 0 (a retired slot) writes
    there as the reference's scatter does: its row into an unquantized
    pool (where several land on one row, the last slot's wins, as XLA
    applies a scatter's duplicates in order; resolved here before the
    write, so it does not depend on the device's write order), zeros into
    a quantized one. Retired slots attend the null page, and under an MoE
    layer's capacity dispatch their rows change the live slots' outputs,
    so its contents must be the reference's. Live slots own distinct
    pages, so no two live writes collide.

    ``valid`` ([B] bool or 0/1; a draft step's dead rows and rows past the
    cache) sends the rows it masks to the null page as zeros, as the
    reference's ``valid`` does. A row at or past the table's last position
    (a slot whose index reached ``npg * ps``), unless ``valid`` masks it,
    writes nothing: the page column is clamped to ``npg - 1`` for the
    gather, and the write is dropped, as the reference's does (its gather
    fills the page id with the least int32, which its scatter drops).
    ``plan``: ``paged_write_plan``'s, computed already.

    Quantized pools follow the reference's two policies:
    - ``scales`` [P, ps, K] ("token"): the row's codes and its scale are
      replaced; nothing else is touched.
    - ``scales`` [P, K] ("head"): the page's scale grows monotonically to
      cover the token's amax and the whole page is re-encoded under it
      (dequantize under the old scale, insert the row, encode). The
      reference skips the page round trip with ``lax.cond`` when no scale
      grew; here every step takes it, because a host branch would read a
      device value. The result is bit-identical: at a fixed scale
      ``encode(decode(c)) == c`` for int8 and fp8 codes, which also makes
      a dropped row's page write (old scale, no row inserted) a no-op."""
    ps = pages.shape[1]
    B = new.shape[0]
    dev = pages.device
    pid, row, drop, live, last = plan or paged_write_plan(
        page_table, index, B, ps, valid,
        last=scales is None or scales.dim() == 3)
    if live is not None:
        new = torch.where(live[:, None, None, None], new, 0.0)
    sink = (pid == 0)[:, None, None]                                 # [B,1,1]
    if scales is None:
        pages[pid, row] = torch.where(
            (last >= 0)[:, None, None],
            new[last.clamp(min=0), 0].float().to(pages.dtype),
            pages[pid, row])
        return pages, None
    tok = torch.where(sink, 0.0, new[:, 0].float())                  # [B,K,h]
    tok_scale = tok.abs().amax(-1) / kv_quant.qmax(pages.dtype)      # [B,K]
    if scales.dim() == 3:
        won = (last >= 0)[:, None]
        codes = kv_quant.encode(tok, tok_scale[..., None], pages.dtype)
        pages[pid, row] = torch.where(won[..., None],
                                      codes[last.clamp(min=0)],
                                      pages[pid, row])
        scales[pid, row] = torch.where(won, tok_scale[last.clamp(min=0)],
                                       scales[pid, row])
        return pages, scales
    old_scale = scales[pid]                                          # [B,K]
    new_scale = torch.where((sink[:, :, 0] | drop[:, None]), old_scale,
                            torch.maximum(old_scale, tok_scale))
    page_f = kv_quant.decode(pages[pid], old_scale[:, None, :, None])
    b = torch.arange(B, device=dev)
    page_f[b, row] = torch.where(drop[:, None, None], page_f[b, row], tok)
    pages[pid] = kv_quant.encode(page_f, new_scale[:, None, :, None],
                                 pages.dtype)
    scales[pid] = new_scale
    return pages, scales


def update_cache_paged_chunk(pages, new, page_table, start, n_valid=None,
                             scales=None):
    """Write one prefill chunk ``new`` [B,C,K,h] into the page pool in
    place, at logical positions ``start .. start+C-1`` of each slot
    (``start`` int or [B]); rows at or past ``n_valid`` (int or [B]; the
    padding tail of a partial final chunk) go to the null page as zeros.
    Returns ``(pages, scales)`` like ``update_cache_paged``.

    - Unquantized and token-scale pools: one vectorised encode and
      scatter (valid rows hit distinct (page, offset) cells; a token row's
      codes and scale depend on that row alone).
    - Head-scale pools: the rows replay ``update_cache_paged``'s
      monotone-amax write in position order. The reference replays one
      row at a time through the pool; pages are independent and a page's
      rows are written in offset order either way, so here the pages the
      chunk touches are gathered once, iteration ``o`` writes the row at
      offset ``o`` of every one of them at once (``ps`` iterations instead
      of C), and the pages are scattered back: bit for bit the same pool.
      An iteration with no valid row for a page re-encodes it at its
      unchanged scale, which leaves every code as it was. The reference's
      replay runs in a compiled loop, where XLA divides by qmax as a
      multiplication by its reciprocal; the replay does the same, so its
      scales equal the reference's bit for bit."""
    B, C = new.shape[:2]
    dev = pages.device
    ps, npg = pages.shape[1], page_table.shape[1]
    st = slot_index(start, B, dev).long()
    nv = slot_index(C if n_valid is None else n_valid, B, dev).long()
    if scales is None or scales.dim() == 3:
        r = torch.arange(C, device=dev)[None]
        idx = st[:, None] + r                                       # [B, C]
        live = r < nv[:, None]
        pid = page_table.long().gather(1, (idx // ps).clamp(max=npg - 1))
        pid = torch.where(live, pid, 0)
        rows = torch.where(live[..., None, None], new.float(), 0.0)
        if scales is None:
            pages[pid, idx % ps] = rows.to(pages.dtype)
            return pages, None
        row_scale = rows.abs().amax(-1) / kv_quant.qmax(pages.dtype)
        pages[pid, idx % ps] = kv_quant.encode(rows, row_scale[..., None],
                                               pages.dtype)
        scales[pid, idx % ps] = row_scale
        return pages, scales
    # head scales: chunk row i sits at offset o of page slot j, where
    # (start // ps + j) * ps + o = start + i
    span = -(-C // ps) + 1                    # page slots a chunk can touch
    K, h = new.shape[2:]
    slot = st[:, None] // ps + torch.arange(span, device=dev)   # [B, span]
    i = ((slot * ps - st[:, None])[..., None]
         + torch.arange(ps, device=dev))                     # [B, span, ps]
    ok = (i >= 0) & (i < C) & (i < nv[:, None, None])
    # a page slot with no valid row writes back to the null page (zeros)
    pid = page_table.long().gather(1, slot.clamp(max=npg - 1))
    pid = torch.where(ok.any(-1), pid, 0).reshape(-1)           # [B*span]
    rows = new.float().gather(1, i.clamp(0, C - 1).reshape(B, -1, 1, 1)
                              .expand(-1, -1, K, h))
    rows = rows.reshape(B * span, ps, K, h)
    ok = ok.reshape(B * span, ps)
    codes, sc = pages[pid], scales[pid]          # [M, ps, K, h], [M, K]
    recip = 1.0 / kv_quant.qmax(pages.dtype)
    for o in range(ps):
        tok, live = rows[:, o], ok[:, o, None]
        grown = torch.where(live, torch.maximum(sc, tok.abs().amax(-1)
                                                * recip), sc)
        page_f = kv_quant.decode(codes, sc[:, None, :, None])
        page_f[:, o] = torch.where(live[..., None], tok, page_f[:, o])
        codes = kv_quant.encode(page_f, grown[:, None, :, None],
                                pages.dtype)
        sc = grown
    pages[pid] = codes
    scales[pid] = sc
    return pages, scales


# ---------------------------------------------------------------------------
# unified attention dispatch
# ---------------------------------------------------------------------------

def _decode_partial(q, k, v, idx, window: int, off: int):
    """One shard's part of a decode: q [B,N,h] against cache rows [B,L,K,h]
    at positions ``off .. off+L-1``, rows up to ``idx`` [B] (and within
    ``window``) live. Returns the f32 running max [B,N], sum [B,N] and
    unnormalised output [B,N,h] that the shards combine (the split-key
    decode kernel's partials)."""
    B, N, h = q.shape
    L, K = k.shape[1], k.shape[2]
    kpos = off + torch.arange(L, device=q.device)
    valid = kpos[None] <= idx[:, None]
    if window != GLOBAL_WINDOW:
        valid &= (idx[:, None] - kpos[None]) < window
    s = torch.einsum("bkgh,btkh->bkgt", q.float().reshape(B, K, N // K, h),
                     k.float()) * (1.0 / math.sqrt(h))
    s = torch.where(valid[:, None, None], s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None]) * valid[:, None, None]
    acc = torch.einsum("bkgt,btkh->bkgh", p, v.float())
    return m.reshape(B, N), p.sum(-1).reshape(B, N), acc.reshape(B, N, h)


def sharded_attention(core, q, k, v, *rest, decode=None):
    """``core(q, k, v, *rest)`` (an attention core: q [B,S,N,h], k and v
    [B,Skv,K,h]) on each rank's shard of DTensors (the dry run), through
    ``local_call``: attention is independent across sequences and heads,
    so q keeps its batch shards, and its head shards when they split the
    KV heads evenly too (else the heads are gathered); k and v follow q
    and are whole along their rows. ``rest``'s DTensors (positions, the
    decode index) are replicated.

    ``decode`` = (window, ring) marks a decode core over a cache sharded
    on its rows (``kv_seq``, where the batch does not divide): each rank
    attends to its own rows (``_decode_partial``) and the ranks combine
    the partial softmax with three all-reduces over the row shards (a
    max, two sums), as the split-key decode kernel combines its splits,
    rather than gathering the cache."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    K, n_heads = k.shape[2], 1
    for m, p in enumerate(q.placements):
        if p.is_shard(2):
            n_heads *= mesh.size(m)
    heads = K % n_heads == 0
    pq = tuple(Shard(0) if p.is_shard(0) else
               Shard(2) if p.is_shard(2) and heads else Replicate()
               for p in q.placements)
    rows = [m for m, p in enumerate(k.placements)
            if p.is_shard(1)] if decode else []
    pk = tuple(Shard(1) if m in rows else p for m, p in enumerate(pq))
    rep = [None if not SH.is_dtensor(t) else (Replicate(),) * mesh.ndim
           for t in rest]
    fn = core
    if rows:
        window, ring = decode
        smax = k.shape[1]
        off = SH.shard_start(k.placements, mesh, 1, smax)

        def fn(q, k, v, q_pos, k_pos, index):
            import torch.distributed._functional_collectives as funcol
            B = q.shape[0]
            idx = slot_index(index, B, q.device).long()
            if ring:
                idx = idx.clamp(max=smax - 1)
            m, l, acc = _decode_partial(q[:, 0], k, v, idx, window, off)
            top = m
            for d in rows:
                top = funcol.all_reduce(top, "max", (mesh, d))
            w = torch.exp(m - top)
            l, acc = l * w, acc * w[..., None]
            for d in rows:
                l = funcol.all_reduce(l, "sum", (mesh, d))
                acc = funcol.all_reduce(acc, "sum", (mesh, d))
            out = acc / torch.clamp(l, min=1e-30)[..., None]
            return out.to(q.dtype)[:, None]
    return SH.local_call(fn, (q, k, v) + rest, [pq, pk, pk] + rep, (pq,))


def attention_route(mode: str, layout: str, *, S: int, Skv: int, window: int,
                    opts: ModelOptions, causal: bool = True) -> str:
    """The routing decision of every attention dispatch of the port:
    (mode x layout x shape) -> core name. Modes: ``decode`` (S == 1
    against a cache), ``chunk`` (S > 1 against a live cache view),
    ``fresh`` (attention over exactly the new rows), ``cross`` (the
    encoder context: never cached here, never causal). Layouts: ``dense``,
    ``paged`` (decode and chunk), ``ring`` (a window-sized ring cache:
    decode, and prefill as fresh rows) and ``none``. Whether a kernel
    core launches its kernel or runs its plain version follows from the
    tensors' device. Fresh and cross attention take the reference's four
    routes in its order: the flash kernel for causal S == Skv in whole
    128-row blocks, dense masked attention up to ``dense_attn_threshold``
    (or off the ``attn_chunk`` grid, or not causal), the banded core for
    a window of at most half the keys, else the plain flash core; a cross
    query of one row (decode) is the decode kernel's ``decode_cross``."""
    if layout == "paged":
        if mode == "decode":
            return "decode_paged_flash"
        if mode == "chunk":
            return "chunk_paged_flash"
        raise NotImplementedError(f"{mode!r} attention through a page "
                                  "table has no route")
    if layout not in ("dense", "ring", "none"):
        raise ValueError(f"unknown cache layout {layout!r}")
    if mode == "decode":
        return "decode_ring" if layout == "ring" else "decode_flash"
    if mode == "chunk":
        if layout == "ring":
            raise ValueError("a ring cache takes no chunk against its "
                             "contents (its prefill attends within the "
                             "fresh rows)")
        return "chunk_flash"
    if mode == "cross" and S == 1:
        return "decode_cross"
    if mode not in ("fresh", "cross"):
        raise ValueError(f"unknown attention mode {mode!r}")
    if causal and S % 128 == 0 and Skv == S:
        return "fresh_flash"
    if Skv <= opts.dense_attn_threshold or Skv % opts.attn_chunk \
            or not causal:
        return "fresh_dense"
    if window != GLOBAL_WINDOW and window <= Skv // 2:
        return "fresh_banded"
    return "fresh_flash_ref"


def run_attention_core(route: str, q, k, v, *, opts: ModelOptions,
                       window: int, causal: bool = True, q_pos=None,
                       k_pos=None, index=None, live_len=None,
                       page_table=None, k_scales=None, v_scales=None):
    """Execute one routed attention core. ``k``/``v`` are the new rows
    (fresh), the dense cache [B, Smax, K, h] (decode/chunk) or the page
    pools [P, ps, K, h] (paged routes, with ``page_table`` and, for a
    quantized pool, ``*_scales``). ``index`` is the decode position /
    chunk start (int or per-slot [B]); ``live_len`` bounds the chunk
    cores' key axis (see ``band_len``). ``decode_dense`` and
    ``chunk_banded`` are the plain cores, kept as the reference's
    fallbacks. DTensor arguments (the dry run) run the core on each rank's
    shard (``sharded_attention``)."""
    if SH.is_dtensor(q):
        if page_table is not None:
            raise NotImplementedError("attention through a page table has "
                                      "no DTensor partitioning")

        def core(q, k, v, q_pos, k_pos, index):
            return run_attention_core(route, q, k, v, opts=opts,
                                      window=window, causal=causal,
                                      q_pos=q_pos, k_pos=k_pos, index=index,
                                      live_len=live_len)
        decode = None
        if route in ("decode_flash", "decode_ring"):
            decode = (GLOBAL_WINDOW if route == "decode_ring" else window,
                      route == "decode_ring")
        return sharded_attention(core, q, k, v, q_pos, k_pos, index,
                                 decode=decode)
    if route == "decode_flash":
        return decode_attention(q[:, 0], k, v, index, window=window)[:, None]
    if route == "decode_ring":
        # attending to ring slots j <= index, or to all W once index >= W,
        # is the dense decode of the W rows at min(index, W - 1) without a
        # window: attention does not depend on slot order, and RoPE is in
        # the cached keys (a device op, so a captured step replays it)
        last = slot_index(index, q.shape[0], q.device).clamp(
            max=k.shape[1] - 1)
        return decode_attention(q[:, 0], k, v, last)[:, None]
    if route == "decode_cross":
        # every context row is live: the dense decode at its last row
        last = torch.full((q.shape[0],), k.shape[1] - 1, dtype=torch.int32,
                          device=q.device)
        return decode_attention(q[:, 0], k, v, last)[:, None]
    if route == "decode_dense":
        return attention_decode(q, k, v, index, window)
    if route == "decode_paged_flash":
        return paged_decode_attention(q[:, 0], k, v, page_table, index,
                                      k_scales=k_scales, v_scales=v_scales,
                                      window=window)[:, None]
    if route in ("chunk_flash", "chunk_banded"):
        band = opts.prefill_band
        smax = k.shape[1]
        Lb = band_len(live_bound(live_len, smax), band, smax)
        kb, vb = k[:, :Lb], v[:, :Lb]
        if route == "chunk_flash":
            return chunk_prefill_attention(q, kb, vb, index, window=window,
                                           bk=band)
        return attention_chunk_banded(q, kb, vb, index, window, band)
    if route == "chunk_paged_flash":
        # the live band through the table: whole pages up to the band bound
        ps, npg = k.shape[1], page_table.shape[1]
        Lb = band_len(live_bound(live_len, npg * ps), opts.prefill_band,
                      npg * ps)
        return paged_chunk_prefill_attention(
            q, k, v, page_table[:, :(Lb + ps - 1) // ps], index,
            k_scales=k_scales, v_scales=v_scales, window=window)
    if route in ("fresh_flash", "fresh_dense", "fresh_banded",
                 "fresh_flash_ref"):
        q_pos = q_pos[0] if q_pos.dim() == 2 else q_pos
        k_pos = k_pos[0] if k_pos.dim() == 2 else k_pos
        if route == "fresh_flash":
            return flash_attention(q, k, v, window=window, causal=causal)
        if route == "fresh_dense":
            return attention_dense(q, k, v, q_pos, k_pos, window, causal)
        if route == "fresh_banded":
            return attention_banded(q, k, v, q_pos, k_pos, window,
                                    opts.attn_chunk)
        return attention_flash_ref(q, k, v, q_pos, k_pos, window,
                                   opts.attn_chunk,
                                   causal_pairs=opts.causal_pairs)
    raise NotImplementedError(f"attention route {route!r} is not ported "
                              "(see ROADMAP)")


def attention(p, x, cfg: ModelConfig, opts: ModelOptions, window: int,
              positions, cache=None, cache_index=None, causal: bool = True,
              live_len=None, page_table=None, n_valid=None, ctx=None,
              ctx_prefix: str = ""):
    """Attention sub-layer: projections + RoPE + cache write path + the
    routed core + output projection. ``cache`` is a dense (k, v) pair of
    [B, Smax, K, h] tensors, written in place at ``cache_index``; S == 1 is
    decode, a chunk filling the whole buffer from 0 attends within itself,
    any other S > 1 runs the banded chunk core against the live cache
    (``live_len`` bounds its key axis). A dense pair whose length is a
    sliding-window layer's window is a ring (``ModelOptions.
    window_cache``): decode writes slot ``index % W`` and attends to the
    whole ring; a prefill, from position 0 and of at most W rows, attends
    within its fresh rows. With ``page_table`` [B, npg] the cache is a
    pair of page pools [P, ps, K, h] (a 4-tuple adds a quantized pool's
    scales): S == 1 writes one row per slot, S > 1 scatters a prefill
    chunk page-wise and attends through the pool. ``n_valid`` drops a
    chunk's padding rows from the write path.

    Cross attention: ``ctx`` (k, v) [B, T, K, h], the encoder context's
    projections, with ``ctx_prefix`` naming the layer's weights ("x":
    ``xwq``, ``xbq``, ``xwo``): q from ``x``, no RoPE, never causal,
    nothing cached here. Returns (out, cache)."""
    pre = ctx_prefix
    B, S, _ = x.shape
    q = _proj(x, p[pre + "wq"])
    if cfg.qkv_bias:
        q = q + p[pre + "bq"].to(q.dtype)
    if ctx is not None:
        k, v = ctx
    else:
        k, v = _proj(x, p["wk"]), _proj(x, p["wv"])
        if cfg.qkv_bias:
            k = k + p["bk"].to(k.dtype)
            v = v + p["bv"].to(v.dtype)
    if cfg.pos == "rope" and ctx is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = SH.constrain(q, "batch", "act_seq", "act_heads", None)

    if ctx is not None:
        route = attention_route("cross", "none", S=S, Skv=k.shape[1],
                                window=GLOBAL_WINDOW, opts=opts,
                                causal=False)
        out = run_attention_core(route, q, k, v, opts=opts,
                                 window=GLOBAL_WINDOW, causal=False,
                                 q_pos=positions,
                                 k_pos=torch.arange(k.shape[1],
                                                    device=x.device))
    elif cache is not None and page_table is not None:
        k_sc, v_sc = cache[2:] if len(cache) == 4 else (None, None)
        if S == 1:
            # n_valid (0 or 1 a slot; a draft step's) masks dead rows and
            # rows past the cache into the null page
            valid = None if n_valid is None else \
                slot_index(n_valid, B, x.device) > 0
            plan = paged_write_plan(page_table, cache_index, B,
                                    cache[0].shape[1], valid,
                                    last=k_sc is None or k_sc.dim() == 3)
            update_cache_paged(cache[0], k, page_table, cache_index, k_sc,
                               plan=plan)
            update_cache_paged(cache[1], v, page_table, cache_index, v_sc,
                               plan=plan)
        else:
            update_cache_paged_chunk(cache[0], k, page_table, cache_index,
                                     n_valid, k_sc)
            update_cache_paged_chunk(cache[1], v, page_table, cache_index,
                                     n_valid, v_sc)
        route = attention_route("decode" if S == 1 else "chunk", "paged",
                                S=S, Skv=S, window=window, opts=opts,
                                causal=causal)
        out = run_attention_core(route, q, cache[0], cache[1], opts=opts,
                                 window=window, index=cache_index,
                                 page_table=page_table, k_scales=k_sc,
                                 v_scales=v_sc, live_len=live_len)
    elif cache is not None:
        smax = cache[0].shape[1]
        ring = window != GLOBAL_WINDOW and smax == window
        if ring and S > 1:
            if S > smax:
                raise ValueError(
                    f"a ring cache of {smax} rows (the layer's window; "
                    f"ModelOptions.window_cache) takes a prefill of at most "
                    f"{smax} rows, got {S}: its rows would overwrite each "
                    "other (the reference cannot take it either)")
            if not (isinstance(cache_index, int) and cache_index == 0):
                raise ValueError("a ring cache takes a prefill from "
                                 "position 0 only (its prefill attends "
                                 "within the fresh rows)")
        if S > smax:
            raise ValueError(f"prefill length {S} exceeds cache {smax}")
        if ring and S == 1:
            update_cache_ring(cache[0], k, cache_index)
            update_cache_ring(cache[1], v, cache_index)
        else:
            plan = chunk_write_plan(cache_index, n_valid, B, S, smax,
                                    cache[0].device)
            update_cache_chunk(cache[0], k, cache_index, plan=plan)
            update_cache_chunk(cache[1], v, cache_index, plan=plan)
        whole = (isinstance(cache_index, int) and cache_index == 0
                 and S == smax)
        layout = "ring" if ring else "dense"
        mode = "decode" if S == 1 else ("fresh" if whole or ring
                                        else "chunk")
        route = attention_route(mode, layout, S=S, Skv=S, window=window,
                                opts=opts, causal=causal)
        if mode == "fresh":
            out = run_attention_core(route, q, k, v, opts=opts, window=window,
                                     causal=causal, q_pos=positions,
                                     k_pos=positions)
        else:
            out = run_attention_core(route, q, cache[0], cache[1], opts=opts,
                                     window=window, index=cache_index,
                                     live_len=live_len)
    else:
        route = attention_route("fresh", "none", S=S, Skv=S, window=window,
                                opts=opts, causal=causal)
        out = run_attention_core(route, q, k, v, opts=opts, window=window,
                                 causal=causal, q_pos=positions,
                                 k_pos=positions)
    wo = p[pre + "wo"]
    out = SH.dense(out.reshape(B, S, -1), wo.reshape(-1, wo.shape[-1]))
    # DTensors: the row-parallel product's partial sums reduced once, here
    # (where the sharded serving path all-reduces them)
    out = SH.constrain(out, "batch", "act_seq", "act_embed")
    if opts.shard is not None and not pre and wo.shape[0] != cfg.num_heads:
        # head-sharded: this rank's heads give a partial sum over the
        # whole d_model (the row-parallel reduction point)
        out = opts.shard.all_reduce_sum(out)
    return out, cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp(p, x, cfg: ModelConfig, shard: Optional[ShardGroup] = None):
    """The dense FFN; with ``shard`` and a width-sharded ``wo_mlp`` (fewer
    than ``d_ff`` rows) the partial sums are all-reduced."""
    h = SH.dense(x, p["wi"])
    if cfg.act in ("silu", "gelu"):
        h = _act(h, SH.dense(x, p["wg"]), cfg.act)
    else:
        h = _act(h, None, cfg.act)
    h = SH.constrain(h, "batch", "act_seq", "act_mlp")
    out = SH.constrain(SH.dense(h, p["wo_mlp"]), "batch", "act_seq",
                       "act_embed")
    if shard is not None and p["wo_mlp"].shape[0] != cfg.d_ff:
        out = shard.all_reduce_sum(out)
    return out


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _route(xt, router, cfg: ModelConfig):
    """Top-k routing of tokens xt [T,D]: (gates [T,K] f32, renormalised;
    expert ids [T,K]). Logits in the activation dtype, then f32; padded
    experts are masked out. Ties go to the lower expert id, as in
    ``jax.lax.top_k`` (``torch.topk`` promises no order)."""
    E = router.shape[-1]
    logits = SH.dense(xt, router).float()
    if E > cfg.num_experts:
        pad = torch.arange(E, device=xt.device) >= cfg.num_experts
        logits = torch.where(pad[None], NEG_INF, logits)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :cfg.top_k], idx[:, :cfg.top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    return gates, idx


def moe(p, x, cfg: ModelConfig, opts: ModelOptions):
    """Capacity-based top-k MoE (sort-free dispatch), x [B,S,D] -> [B,S,D].

    Each of the T = B*S tokens picks K experts; expert e takes its first C
    assignments in token-major order (an exclusive cumsum over the [T*K]
    assignments), C = max(1, ceil(K*T/E_real * factor)); the others go to
    a sink row and contribute nothing. The experts run as one grouped MLP
    over the [E,C,D] capacity buffer (``grouped_mlp``: the CUDA kernels on
    the card); the combine reads each kept assignment's slot times its
    gate. ``moe_per_seq_dispatch`` assigns slots within each sequence
    (C_seq per sequence); ``moe_gather_decode`` (T*K <= E) runs each
    assignment against its expert's gathered weights instead. Shapes are
    fixed by T: nothing is read back to the host."""
    B, S, D = x.shape
    E, K = p["router"].shape[-1], cfg.top_k
    T = B * S
    xt = x.reshape(T, D)
    gates, expert_idx = _route(xt, p["router"], cfg)

    if opts.moe_gather_decode and T * K <= E:
        idx = expert_idx.reshape(-1)                     # [T*K]
        xk = xt.repeat_interleave(K, dim=0)              # [T*K, D]
        h = torch.einsum("td,tdf->tf", xk, p["moe_wi"][idx])
        g = torch.einsum("td,tdf->tf", xk, p["moe_wg"][idx])
        he = torch.einsum("tf,tfd->td", _act(h, g, cfg.act),
                          p["moe_wo"][idx])
        out = (he.reshape(T, K, D) * gates[..., None].to(he.dtype)).sum(1)
        return out.reshape(B, S, D)

    C, Cs = _capacity(cfg, opts, B, S, T)
    if SH.is_dtensor(xt):
        out = _sharded_moe(p, xt, gates, expert_idx, cfg, opts, B, S)
        return SH.constrain(out.reshape(B, S, D), "batch", "act_seq",
                            "act_embed")
    rows = _moe_rows(expert_idx, B, S, K, E, C, Cs, opts)
    xe = _moe_dispatch(xt, rows, E, C, K)
    he = grouped_mlp(xe, p["moe_wi"], p["moe_wg"], p["moe_wo"], cfg.act)
    return _moe_combine(he, rows, gates).reshape(B, S, D)


def _capacity(cfg: ModelConfig, opts: ModelOptions, B: int, S: int,
              T: int):
    """(C, C_seq): the capacity buffer's slots an expert, from the real
    expert count; ``moe_per_seq_dispatch`` gives each of the B sequences
    C_seq of them (C = B * C_seq)."""
    K, E_real = cfg.top_k, cfg.num_experts
    if opts.moe_per_seq_dispatch and B > 1:
        Cs = max(1, math.ceil(K * S / E_real * opts.moe_capacity_factor))
        return B * Cs, Cs
    C = max(1, math.ceil(K * T / E_real * opts.moe_capacity_factor))
    return C, C


def _moe_rows(expert_idx, B: int, S: int, K: int, E: int, C: int, Cs: int,
              opts: ModelOptions, e0: int = 0, c0: int = 0, El=None,
              Cl=None):
    """Where each of the T*K assignments lands: its row in the capacity
    buffer's block of experts [e0, e0+El) x slots [c0, c0+Cl) (the whole
    buffer by default), or -1 (dropped, or outside the block). Expert e
    takes its first C assignments in token-major order (an exclusive
    cumsum over the assignments), or, under ``moe_per_seq_dispatch``, its
    first C_seq within each sequence."""
    El, Cl = El or E, Cl or C
    if opts.moe_per_seq_dispatch and B > 1:
        e_seq = expert_idx.reshape(B, S * K)
        onehot = F.one_hot(e_seq, E)
        pos = onehot.cumsum(1) - onehot                  # local prefix sum
        slot_s = pos.gather(2, e_seq[..., None])[..., 0]
        keep = (slot_s < Cs).reshape(-1)
        b_of = torch.arange(B, device=expert_idx.device).repeat_interleave(
            S * K)
        slot = b_of * Cs + slot_s.reshape(-1)
        flat_e = e_seq.reshape(-1)
    else:
        flat_e = expert_idx.reshape(-1)                  # [T*K]
        onehot = F.one_hot(flat_e, E)
        pos = onehot.cumsum(0) - onehot
        slot = pos.gather(1, flat_e[:, None])[:, 0]
        keep = slot < C
    if (El, Cl) == (E, C):
        return torch.where(keep, flat_e * C + slot, -1)
    keep = (keep & (flat_e >= e0) & (flat_e < e0 + El)
            & (slot >= c0) & (slot < c0 + Cl))
    return torch.where(keep, (flat_e - e0) * Cl + slot - c0, -1)


def _moe_dispatch(xt, rows, El: int, Cl: int, K: int):
    """The capacity buffer's block [El, Cl, D]: each assignment's token row
    at its row (``_moe_rows``), zeros in the slots nobody took."""
    T, D = xt.shape
    dest = torch.where(rows >= 0, rows, El * Cl)         # El*Cl: the sink
    token_of = torch.arange(T, device=xt.device).repeat_interleave(K)
    buf_tokens = torch.zeros(El * Cl + 1, dtype=torch.long, device=xt.device)
    buf_tokens[dest] = token_of
    buf_valid = torch.zeros(El * Cl + 1, dtype=xt.dtype, device=xt.device)
    # index_fill_ takes the 1 as a scalar: an indexed assignment of a
    # Python number copies it to the device first, a host sync that a
    # CUDA graph cannot capture
    buf_valid.index_fill_(0, dest, 1.0)
    return (xt[buf_tokens[:-1]].reshape(El, Cl, D)
            * buf_valid[:-1].reshape(El, Cl, 1))


def _moe_combine(he, rows, gates):
    """Each token's gated sum [T, D] over its assignments whose rows the
    buffer block ``he`` [El, Cl, D] holds."""
    El, Cl, D = he.shape
    T, K = gates.shape
    keep = rows >= 0
    picked = (he.reshape(El * Cl, D)[torch.where(keep, rows, 0)]
              * keep[:, None].to(he.dtype))                  # [T*K, D]
    picked = picked.reshape(T, K, D) * gates[..., None].to(he.dtype)
    return picked.sum(1)


def _sharded_moe(p, xt, gates, expert_idx, cfg: ModelConfig,
                 opts: ModelOptions, B: int, S: int):
    """``moe``'s capacity dispatch on DTensors (the dry run), partitioned
    explicitly (``local_call``; DTensor has no rule for its scatter and
    gather). Returns the tokens' outputs [T, D] as partial sums.

    The capacity buffer [E, C, D] is placed as the reference constrains it
    (experts over ``act_experts``' mesh dims, slots over ``batch``'s).
    Every rank gathers every token's row, expert ids and gates (the slots
    are a prefix sum over all tokens, in token order), numbers the
    assignments as ``moe`` does and fills its own slots; the grouped MLP
    runs on them with the expert weights gathered but for their expert
    shards; each rank's slots give partial sums of every token's output,
    which the sub-layer's constraint reduces onto the tokens' shards.
    Per layer that gathers the tokens [T, D] once, where routing each row
    to its slot's rank (an all-to-all) would move about K x T / n_tokens
    rows: with static shapes an all-to-all must be sized for the whole
    slot range, which costs more than the gather."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = xt.device_mesh
    T, D = xt.shape
    E, K = p["router"].shape[-1], cfg.top_k
    C, Cs = _capacity(cfg, opts, B, S, T)
    xpl = SH.dtensor_placements(
        SH.spec_for((E, C, D), ("act_experts", "batch", None), mesh), mesh)
    n = dict.fromkeys((0, 1), 1)
    for m, pl in enumerate(xpl):
        if pl.is_shard():
            n[pl.dim] *= mesh.size(m)
    block = dict(e0=SH.shard_start(xpl, mesh, 0, E),
                 c0=SH.shard_start(xpl, mesh, 1, C), El=E // n[0],
                 Cl=C // n[1])

    def dispatch(x, idx):
        rows = _moe_rows(idx, B, S, K, E, C, Cs, opts, **block)
        return _moe_dispatch(x, rows, block["El"], block["Cl"], K)

    def combine(h, idx, g):
        return _moe_combine(h, _moe_rows(idx, B, S, K, E, C, Cs, opts,
                                         **block), g)

    whole = (Replicate(),) * mesh.ndim
    part = tuple(Partial() if pl.is_shard() else Replicate() for pl in xpl)
    xe = SH.local_call(dispatch, (xt, expert_idx), (whole, whole), (xpl,),
                       (part, whole))
    xe = SH.constrain(xe, "act_experts", "batch", None)
    he, split = _sharded_grouped_mlp(p, xe, cfg)
    hpl = he.placements
    out = tuple(Shard(1) if m in split else q for m, q in enumerate(part))
    return SH.local_call(combine, (he, expert_idx, gates),
                         (hpl, whole, whole), (out,),
                         (hpl, whole, tuple(Partial() if m in split else q
                                            for m, q in enumerate(part))))


def _sharded_grouped_mlp(p, xe, cfg: ModelConfig):
    """The experts' MLP on the DTensor capacity buffer ``xe`` [E, C, D]
    (``_sharded_moe``): each rank runs its slots against its experts'
    weights. On a mesh dim that shards the weights' ``D`` (FSDP) where the
    slots are sharded too, the weights are gathered (``grouped_mlp``, the
    kernel wrapper, on the shards). Where the slots are whole on it (a
    decode of one sequence), the weights stay put: the gate and up
    products run on ``D``'s slices and their partial sums are all-reduced,
    and the down product leaves its output sharded on ``D``. Returns (the
    outputs [E, C, D], the mesh dims that split ``D``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    xpl = xe.placements
    wi, wg, wo = p["moe_wi"], p["moe_wg"], p["moe_wo"]
    split = [m for m, (q, w) in enumerate(zip(xpl, wi.placements))
             if w.is_shard(1) and not q.is_shard()]
    n = len(xpl)

    def wpl(on_split):
        return tuple(Shard(0) if xpl[m].is_shard(0) else
                     on_split if m in split else Replicate()
                     for m in range(n))

    def wgrad(d_dim):
        return tuple(Shard(0) if xpl[m].is_shard(0) else
                     Shard(d_dim) if m in split else
                     Partial() if xpl[m].is_shard(1) else Replicate()
                     for m in range(n))
    if not split:
        w = wpl(Replicate())
        he = SH.local_call(lambda x, a, b, c: grouped_mlp(x, a, b, c,
                                                          cfg.act),
                           (xe, wi, wg, wo), (xpl,) + (w,) * 3, (xpl,),
                           (xpl,) + (wgrad(1),) * 3)
        return he, split
    xs = tuple(Shard(2) if m in split else q for m, q in enumerate(xpl))
    hp = tuple(Partial() if m in split else q for m, q in enumerate(xpl))
    h, g = (SH.local_call(gmm_down, (xe, w), (xs, wpl(Shard(1))), (hp,),
                          (xs, wgrad(1))).redistribute(placements=xpl)
            for w in (wi, wg))
    return SH.local_call(gmm_down, (_act(h, g, cfg.act), wo),
                         (xpl, wpl(Shard(2))), (xs,),
                         (hp, wgrad(2))), split


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

def mamba_dims(cfg: ModelConfig):
    """(d_inner, heads H, head dim P, state N, groups G = 1, conv channels)
    of a Mamba2 mixer."""
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    G = 1
    conv_ch = d_in + 2 * G * N
    return d_in, H, P, N, G, conv_ch


def _conv1d_causal(x, w, b):
    """Depthwise causal conv. x [B,S,C], w [K,C], b [C]."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i:i + S, :] * w[i] for i in range(K)) + b


def ssd_scan_ref(xs, dt, A_log, B_, C_):
    """Sequential SSD recurrence (the oracle; O(S) steps), in f32:
    h_t = exp(A dt_t) h_{t-1} + dt_t B_t (x) x_t; y_t = C_t . h_t.
    xs [B,S,H,P], dt [B,S,H], A_log [H], B_/C_ [B,S,1,N]. Returns (y in
    xs's dtype, final state [B,H,P,N] f32)."""
    Bsz, S, H, P = xs.shape
    N = B_.shape[-1]
    A = -torch.exp(A_log.float())
    x, d = xs.float(), dt.float()
    b, c = B_[:, :, 0].float(), C_[:, :, 0].float()
    h = torch.zeros(Bsz, H, P, N, dtype=torch.float32, device=xs.device)
    ys = []
    for t in range(S):
        decay = torch.exp(A[None] * d[:, t])                     # [B,H]
        db = d[:, t, :, None] * b[:, t][:, None, :]               # [B,H,N]
        h = h * decay[..., None, None] + x[:, t, ..., None] * db[:, :, None]
        ys.append(torch.einsum("bhpn,bn->bhp", h, c[:, t]))
    return torch.stack(ys, 1).to(xs.dtype), h


def _sharded_ssd(xs, dt, A_log, B_, C_):
    """``ssd`` (the kernel wrapper; its plain version on the meta device)
    on each rank's shard of DTensors (the dry run), through
    ``local_call``: the scan is independent across sequences and heads,
    so xs [B,S,H,P] and dt [B,S,H] keep the batch shards they share and
    the head shards they share, A_log [H] follows the heads, and B_, C_
    [B,S,1,N] the batch; every other dim is whole. Returns (y, the final
    state [B,H,P,N]) placed alike."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    keep = [Shard(0) if a.is_shard(0) and b.is_shard(0) else
            Shard(2) if a.is_shard(2) and b.is_shard(2) else Replicate()
            for a, b in zip(xs.placements, dt.placements)]
    px = tuple(keep)
    pa = tuple(Shard(0) if k.is_shard(2) else Replicate() for k in keep)
    pb = tuple(k if k.is_shard(0) else Replicate() for k in keep)
    ps = tuple(Shard(1) if k.is_shard(2) else k for k in keep)
    ga = tuple(Shard(0) if k.is_shard(2) else
               Partial() if k.is_shard(0) else Replicate() for k in keep)
    gb = tuple(Partial() if k.is_shard(2) else k for k in pb)
    return SH.local_call(ssd, (xs, dt, A_log, B_, C_),
                         (px, px, pa, pb, pb), (px, ps),
                         (px, px, ga, gb, gb))


def mamba_block(p, x, cfg: ModelConfig, opts: ModelOptions, state=None,
                conv_state=None, decode: bool = False):
    """Mamba2 mixer. Returns (out, new_state, new_conv_state).

    Prefill runs the chunked SSD scan from a zero state (``ssd``: the CUDA
    kernel on the card, its plain version on the CPU) and returns the last
    ``ssm_conv - 1`` inputs of the conv as its state; ``decode`` (one row)
    runs the per-token recurrence from ``state`` [B,H,P,N] (f32) and
    ``conv_state`` [B, ssm_conv - 1, conv_ch]. Types follow the reference:
    the conv window takes the wider of the conv state's and the input's
    type, the recurrence runs in f32, and y is rounded to x's type before
    the skip term."""
    d_in, H, P, N, G, conv_ch = mamba_dims(cfg)
    B, S, _ = x.shape
    z = SH.dense(x, p["w_z"])
    xBC = SH.dense(x, p["w_xbc"])
    dt = F.softplus(SH.dense(x, p["w_dt"]).float() + p["dt_bias"].float())
    Kc = p["conv_w"].shape[0]
    if decode:
        wdt = torch.promote_types(conv_state.dtype, xBC.dtype)
        window = torch.cat([conv_state.to(wdt), xBC.to(wdt)], 1)  # [B,Kc,ch]
        xBC_c = ((window * p["conv_w"][None].to(wdt)).sum(1, keepdim=True)
                 + p["conv_b"].to(wdt))
        new_conv_state = window[:, 1:]
    else:
        xBC_c = _conv1d_causal(xBC, p["conv_w"], p["conv_b"])
        new_conv_state = (xBC[:, S - (Kc - 1):] if S >= Kc - 1
                          else F.pad(xBC, (0, 0, Kc - 1 - S, 0)))
    xBC_c = F.silu(xBC_c)
    xs, B_, C_ = torch.split(xBC_c, [d_in, G * N, G * N], dim=-1)
    xs = xs.reshape(B, -1, H, P)
    B_ = B_.reshape(B, -1, G, N)
    C_ = C_.reshape(B, -1, G, N)
    if decode:
        A = -torch.exp(p["A_log"].float())
        dt1 = dt[:, 0]                                            # [B,H]
        decay = torch.exp(A[None] * dt1)
        db = dt1[..., None] * B_[:, 0, 0].float()[:, None, :]     # [B,H,N]
        h = (state * decay[..., None, None]
             + xs[:, 0].float()[..., None] * db[:, :, None, :])
        y = torch.einsum("bhpn,bn->bhp", h, C_[:, 0, 0].float())[:, None]
        new_state = h
    elif SH.is_dtensor(xs):
        y, new_state = _sharded_ssd(xs, dt, p["A_log"], B_, C_)
    else:
        y, new_state = ssd(xs, dt, p["A_log"], B_, C_)
    y = (y.to(x.dtype)
         + xs.to(x.dtype) * p["d_skip"].to(x.dtype)[None, None, :, None])
    y = rms_norm(y.reshape(B, -1, d_in), p["mamba_norm_w"], cfg.norm_eps)
    out = SH.constrain(SH.dense(y * F.silu(z), p["w_out"]), "batch",
                       "act_seq", "act_embed")
    return out, new_state, new_conv_state
