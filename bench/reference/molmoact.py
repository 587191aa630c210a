"""Plain float32 reference of MolmoAct-7B as the benchmark configures it
(arXiv:2508.07917): a Qwen2-style decoder (RMSNorm, GQA with q/k/v bias,
rotary positions on the first and second halves of each head, SiLU-gated
MLP, untied output head) over a ViT prefix tower (pre-LayerNorm
multi-head attention without a mask, tanh-GELU MLP, a final LayerNorm and
a linear connector), and the DiT action head (AdaLN-zero blocks over the
trajectory rows, a sinusoidal timestep embedding, deterministic
``dit_steps``-step sampling).

Departures from the published model, as the configuration's ``assumed``
lists them: the image front end (patchify) is replaced by given patch
embeddings; the connector is one linear projection; the DiT head's sizes
are assumed.

Plain ``torch`` operations only, in float32 with TF32 off: no kernel, no
cache, no batching across requests beyond one tensor. It imports nothing
of the program. The weights come as the nested dict of tensors that the
benchmark drew (its leaf names follow the program's parameter layout:
layer-stacked leaves carry the layer on their first axis), and each
layer's leaves are cast to float32 only while that layer runs, so the
reference fits beside the bfloat16 weights.

``quant="fp8"`` computes the same model with both operands of every
product with a weight rounded to float8 e4m3 (one scale an output channel
for the weight, one a token for the activations; attention, norms and the
softmax stay float32): the fp8 GEMM, the comparison's control, the
precision below the configuration's bfloat16. ``quant="fp8w"`` rounds
the weights alone (weight-only fp8, activations as they are).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
QUANTS = ("fp8", "fp8w")
T_EMBED = 256


def _mat(w, quant, reduce=0):
    """A weight in float32; under ``quant`` rounded to fp8 with one scale
    for each output channel: the maximum over the input axis ``reduce``
    (0 for a [in, out] matrix; -1 for rows of the embedding or head)."""
    w = w.float()
    if quant is None:
        return w
    if quant not in QUANTS:
        raise ValueError(f"unknown precision {quant!r}")
    amax = w.abs().amax(dim=reduce, keepdim=True).clamp_min(1e-30)
    s = amax / FP8_MAX
    return (w / s).to(torch.float8_e4m3fn).float() * s


def _act(x, quant):
    """Activations entering a product: as they are, or under ``quant``
    "fp8" rounded to fp8 with one scale a row (a token)."""
    return _mat(x, quant, reduce=-1) if quant == "fp8" else x


def _lin(x, w, quant):
    """x @ w; under ``quant`` the operands rounded to fp8 first (the
    fp8 GEMM: a scale a token, a scale an output channel)."""
    return _act(x, quant) @ _mat(w, quant)


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _ln(x, w, b, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _rope(x, positions, theta):
    """x [B, S, H, h]; rotate the first and second halves of each head."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float64,
                                   device=x.device) / half)
    ang = positions.double()[:, None] * freq
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attend(q, k, v, causal):
    """q [B, S, N, h], k/v [B, T, K, h] with N a multiple of K (query
    head n reads KV head n // (N / K))."""
    B, S, N, h = q.shape
    g = N // k.shape[2]
    q = q.transpose(1, 2)
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    s = (q @ k.transpose(-1, -2)) / math.sqrt(h)
    if causal:
        mask = torch.ones(S, k.shape[2], dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    return (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(B, S, N * h)


def _layer(p, i):
    return {k: t[i] for k, t in p.items()}


def tower(w, patches, cfg, quant=None):
    """The image prefix [B, P, hidden_size] of patches [B, P, E]."""
    v = cfg["vision"]
    n = v["num_attention_heads"]
    x = _lin(patches.float(), w["in_proj"], quant) + w["pos"].float()[None]
    B, P, d = x.shape
    for i in range(v["num_hidden_layers"]):
        p = _layer(w["stack"], i)
        y = _ln(x, p["ln1_w"].float(), p["ln1_b"].float(),
                v["layer_norm_eps"])
        q, k, vv = (_lin(y, p[m].reshape(d, -1), quant)
                    .reshape(B, P, n, d // n) for m in ("wq", "wk", "wv"))
        a = _attend(q, k, vv, causal=False)
        x = x + _lin(a, p["wo"].reshape(-1, d), quant)
        y = _ln(x, p["ln2_w"].float(), p["ln2_b"].float(),
                v["layer_norm_eps"])
        y = F.gelu(_lin(y, p["wi"], quant), approximate="tanh")
        x = x + _lin(y, p["wo_mlp"], quant)
    x = _ln(x, w["final_ln_w"].float(), w["final_ln_b"].float(),
            v["layer_norm_eps"])
    return _lin(x, w["out_proj"], quant)


def decoder_layer(p, x, positions, cfg, quant=None):
    d = cfg["hidden_size"]
    n, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    h = cfg.get("head_dim") or d // n
    B, S, _ = x.shape
    eps = cfg["rms_norm_eps"]
    y = _rms(x, p["ln1_w"].float(), eps)
    q = _lin(y, p["wq"].reshape(d, -1), quant).reshape(B, S, n, h)
    k = _lin(y, p["wk"].reshape(d, -1), quant).reshape(B, S, kv, h)
    v = _lin(y, p["wv"].reshape(d, -1), quant).reshape(B, S, kv, h)
    if cfg.get("attention_bias"):
        q = q + p["bq"].float()
        k = k + p["bk"].float()
        v = v + p["bv"].float()
    q = _rope(q, positions, cfg["rope_theta"])
    k = _rope(k, positions, cfg["rope_theta"])
    x = x + _lin(_attend(q, k, v, causal=True), p["wo"].reshape(-1, d),
                 quant)
    y = _rms(x, p["ln2_w"].float(), eps)
    g = F.silu(_lin(y, p["wg"], quant)) * _lin(y, p["wi"], quant)
    return x + _lin(g, p["wo_mlp"], quant)


@torch.no_grad()
def served_logits(w, cfg, tokens, patches, served, quant=None):
    """Logits [B, S, V] (float32) of the rows that predict each served
    token: the image prefix, the instruction ``tokens`` [B, T] and the
    served tokens [B, S] but the last run through the whole model at
    once, causally; row j is the prediction of ``served[:, j]``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emb = w["embed"]
    parts = []
    if cfg.get("vision"):
        parts.append(tower(w["vision"], patches, cfg, quant))
    seq = torch.cat([tokens, served[:, :-1]], 1)
    parts.append(_mat(emb[seq], quant, reduce=-1))
    x = torch.cat(parts, 1)
    positions = torch.arange(x.shape[1], device=x.device)
    blocks = w["decoder"]["blocks"]["sub0"]
    for i in range(cfg["num_hidden_layers"]):
        x = decoder_layer(_layer(blocks, i), x, positions, cfg, quant)
    x = x[:, x.shape[1] - served.shape[1]:]
    x = _rms(x, w["final_norm_w"].float(), cfg["rms_norm_eps"])
    head = w["embed"] if cfg.get("tie_word_embeddings") else w["lm_head"]
    return _act(x, quant) @ _mat(head, quant, reduce=-1).T


def _timestep_embed(t, dim=T_EMBED):
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)], -1)


def _timesteps(n, device):
    """1 down to 1/n, evenly spaced, times 1000."""
    s = torch.arange(n - 1, dtype=torch.float32) / max(n - 1, 1)
    stop = torch.tensor(1.0 / n, dtype=torch.float32)
    return (torch.cat([(1 - s) + stop * s, stop.reshape(1)])
            * 1000.0).to(device)


def _plain_rms(x, eps=1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


def _dit_block(p, x, c, a, quant):
    B, H, d = x.shape
    n = a["dit_num_heads"]
    s1, g1, b1, s2, g2, b2 = _lin(c, p["ada"], quant).reshape(
        B, 6, d).unbind(1)
    y = _modulate(_plain_rms(x), b1, s1)
    q, k, v = (_lin(y, p[m].reshape(d, -1), quant).reshape(B, H, n, d // n)
               for m in ("wq", "wk", "wv"))
    o = _attend(q, k, v, causal=False)
    x = x + g1[:, None] * _lin(o, p["wo"].reshape(-1, d), quant)
    y = _modulate(_plain_rms(x), b2, s2)
    y = F.gelu(_lin(y, p["wi"], quant), approximate="tanh")
    return x + g2[:, None] * _lin(y, p["wo_mlp"], quant)


@torch.no_grad()
def trajectory(w, cfg, cond, noise, quant=None):
    """The DiT head's trajectory [B, horizon, action_dim] from ``noise``
    under ``cond`` [B, hidden_size] (the last CoT token's embedding):
    ``dit_steps`` denoiser evaluations, x <- x - eps / dit_steps."""
    torch.backends.cuda.matmul.allow_tf32 = False
    a = cfg["action"]
    steps = a["dit_steps"]
    ts = _timesteps(steps, noise.device)
    cond = _mat(cond, quant, reduce=-1)
    x = noise.float()
    B = x.shape[0]
    for i in range(steps):
        h = _lin(x, w["in_proj"], quant) + w["pos"].float()[None]
        c = (_lin(cond, w["cond_proj"], quant)
             + _lin(_timestep_embed(ts[i].expand(B)), w["t_proj"], quant))
        c = F.silu(c)
        for j in range(a["dit_layers"]):
            h = _dit_block(_layer(w["stack"], j), h, c, a, quant)
        scale, shift = _lin(c, w["final_ada"], quant).reshape(
            B, 2, -1).unbind(1)
        h = _modulate(_plain_rms(h), shift, scale)
        x = x - _lin(h, w["out_proj"], quant) * (1.0 / steps)
    return x
