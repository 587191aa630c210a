"""FLOPs and bytes that the benchmark's inputs need, from a configuration's
published widths (the ``configs/*.json`` keys). A multiply-add counts as
two FLOPs; only products are counted (norms, RoPE, softmax and sampling
are elementwise and left out). Attention counts the keys each query
really attends to: ``p + 1`` for a causal query at position ``p``."""
from __future__ import annotations


def _dims(cfg: dict):
    d = cfg["hidden_size"]
    n, k = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    h = cfg.get("head_dim") or d // n
    return d, n, k, h


def decoder_layer_params(cfg: dict) -> int:
    """Weights of one decoder layer's products: q, k, v, o and the gated
    MLP (biases and norm scales are not products)."""
    d, n, k, h = _dims(cfg)
    attn = d * n * h + 2 * d * k * h + n * h * d
    mlp = 3 * d * cfg["intermediate_size"]
    return attn + mlp


def decoder_params(cfg: dict) -> int:
    return cfg["num_hidden_layers"] * decoder_layer_params(cfg)


def head_params(cfg: dict) -> int:
    return cfg["vocab_size"] * cfg["hidden_size"]


def attention_flops(cfg: dict, keys: int) -> float:
    """One query row against ``keys`` keys, over every layer: QK^T and PV."""
    d, n, k, h = _dims(cfg)
    return 4.0 * n * h * keys * cfg["num_hidden_layers"]


def key_sum(start: int, stop: int) -> int:
    """Sum of ``p + 1`` for causal queries at positions start..stop-1."""
    return (stop * (stop + 1) - start * (start + 1)) // 2


def decode_flops(cfg: dict, position: int) -> float:
    """One decoded token whose input sits at ``position``: the decoder,
    the output head and attention over ``position + 1`` keys."""
    return (2.0 * (decoder_params(cfg) + head_params(cfg))
            + attention_flops(cfg, position + 1))


def prefill_flops(cfg: dict, start: int, stop: int, heads: int = 1) -> float:
    """Prompt positions start..stop-1 through the decoder (causal
    attention), with the output head on ``heads`` rows."""
    d, n, k, h = _dims(cfg)
    return (2.0 * decoder_params(cfg) * (stop - start)
            + 4.0 * n * h * key_sum(start, stop) * cfg["num_hidden_layers"]
            + 2.0 * head_params(cfg) * heads)


def image_flops(cfg: dict) -> float:
    """The vision tower over one image's patches: input projection, the
    layers (products and full attention) and the connector."""
    v = cfg["vision"]
    d, f, t = v["hidden_size"], v["intermediate_size"], v["num_patches"]
    per_layer = 2.0 * t * (4 * d * d + 2 * d * f) + 4.0 * d * t * t
    return (v["num_hidden_layers"] * per_layer
            + 2.0 * t * v["patch_embed_dim"] * d
            + 2.0 * t * d * cfg["hidden_size"])


def dit_flops(cfg: dict) -> float:
    """The DiT head's whole denoising loop for one robot: every step runs
    the input, condition and timestep projections, the blocks (AdaLN
    modulation, attention over the horizon, MLP) and the final layer."""
    a = cfg["action"]
    d, H = a["dit_hidden_size"], a["horizon"]
    per_block = (2.0 * d * 6 * d                      # AdaLN, one row
                 + 2.0 * H * (4 * d * d + 2 * d * 4 * d)
                 + 4.0 * d * H * H)
    per_step = (2.0 * H * a["action_dim"] * d          # in_proj
                + 2.0 * cfg["hidden_size"] * d         # cond_proj
                + 2.0 * 256 * d                        # t_proj
                + a["dit_layers"] * per_block
                + 2.0 * d * 2 * d                      # final AdaLN
                + 2.0 * H * d * a["action_dim"])       # out_proj
    return a["dit_steps"] * per_step


def control_step_flops(cfg: dict, robots: int, text: int) -> float:
    """One control step of ``robots`` observations: the image, the prompt
    (image prefix + ``text`` tokens) with the head on its last row, the
    chain-of-thought and action decode steps, or the DiT loop."""
    prompt = cfg["vision"]["num_patches"] + text
    a = cfg["action"]
    steps = cfg["n_cot_tokens"] + (a["num_action_tokens"]
                                  if a["mode"] == "discrete" else 0)
    one = (image_flops(cfg) + prefill_flops(cfg, 0, prompt)
           + sum(decode_flops(cfg, prompt + j) for j in range(steps)))
    if a["mode"] == "dit":
        one += dit_flops(cfg)
    return robots * one


def decode_attention_bytes(cfg: dict, robots: int, position: int,
                           bytes_per: int = 2) -> float:
    """Least bytes of one decode step's attention over every layer: the K
    and V rows up to the input's ``position`` (inclusive) and q and the
    output, each byte once."""
    d, n, k, h = _dims(cfg)
    kv = 2 * (position + 1) * k * h
    return (float(robots) * cfg["num_hidden_layers"]
            * (kv + 2 * n * h) * bytes_per)
