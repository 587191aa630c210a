"""The VLA control step of the port: vision encode -> generation prefill ->
CoT decode -> action generation, discrete action-token decode or the DiT
head's denoising loop (``repro.core.vla`` in PyTorch). The phases are the
public functions of ``models.model``, so a caller can time each one on its
own; on the card vision + prefill is one graph replay
(``M.PrefillGraph``), each decode step one more (``M.DecodeGraph``) and
the DiT loop one (``M.DiTGraph``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.layers import ModelOptions


@dataclass
class VLAOutput:
    cot_tokens: torch.Tensor                 # [B, n_cot] reasoning trace
    action_tokens: Optional[torch.Tensor]    # [B, n_action] (discrete mode)
    trajectory: Optional[torch.Tensor]       # [B, horizon, action_dim] (dit)
    phase_tokens: Dict[str, int]


def decode_tokens(cfg: ModelConfig, opts: ModelOptions, params, first_token,
                  caches, start_index: int, n_steps: int, *, device="cuda",
                  graph: Optional[M.DecodeGraph] = None):
    """Greedy decode of ``n_steps`` tokens, each step one replay of
    ``graph`` on the card (``M.decode_loop``). Returns (tokens [B,
    n_steps], last_token, caches)."""
    return M.decode_loop(cfg, opts, params, first_token, caches, start_index,
                         n_steps, device=device, graph=graph)


def control_step_lengths(cfg: ModelConfig, n_text: int):
    """(prompt length, action tokens, cache length) of one control step
    with ``n_text`` instruction tokens."""
    a = cfg.action
    n_vis = cfg.vision.num_tokens if cfg.vision else 0
    n_act = a.num_action_tokens if a and a.mode == "discrete" else 0
    prompt = n_vis + n_text
    return prompt, n_act, prompt + cfg.n_cot_tokens + n_act + 1


def vla_control_step(cfg: ModelConfig, opts: ModelOptions, params, batch,
                     max_seq: Optional[int] = None, *, device="cuda",
                     graph: Optional[M.DecodeGraph] = None,
                     prefill_graph: Optional[M.PrefillGraph] = None,
                     dit_graph: Optional[M.DiTGraph] = None,
                     noise=None,
                     generator: Optional[torch.Generator] = None
                     ) -> VLAOutput:
    """One full control step for a VLA observation batch.

    batch: {'tokens': [B, n_prompt] instruction, and 'patches': [B,T,e]
    image or 'prefix': [B,T,d_model] from ``M.encode_vision``}. Vision
    and prefill run as one body, one replay of ``prefill_graph`` (an
    ``M.PrefillGraph``, which a caller may keep across control steps; a
    new one when None), whose caches keep one address. The CoT and action
    loops share one ``M.DecodeGraph``: ``graph``, kept the same way, which
    captures again only when the step's caches lie elsewhere: beside a
    kept ``prefill_graph``, never after its first control step. A DiT head
    (``cfg.action.mode == 'dit'``) is conditioned on the embedding of the
    last CoT token and denoises ``noise`` [B, horizon, action_dim], else a
    draw of ``generator`` (a seed-0 generator when neither is given: the
    counterpart of the reference's ``key``), its loop one replay of
    ``dit_graph`` (kept across control steps like ``graph``; a new one
    when None).
    """
    dev = resolve_device(device)
    graph = graph if graph is not None else M.DecodeGraph(dev)
    prefill_graph = prefill_graph if prefill_graph is not None \
        else M.PrefillGraph(dev)
    for g in (graph, prefill_graph):
        if g.device != dev:
            raise ValueError(f"a graph is on {g.device}, the call asked "
                             f"for {dev}")
    a = cfg.action
    prompt, n_act, total = control_step_lengths(cfg, len(batch["tokens"][0]))
    logits, caches = prefill_graph.run(cfg, opts, params, batch,
                                       max_seq or total)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    cot, tok, caches = decode_tokens(cfg, opts, params, tok, caches, prompt,
                                     cfg.n_cot_tokens, device=dev,
                                     graph=graph)
    action_tokens = trajectory = None
    if a is None or a.mode == "discrete":
        action_tokens, _, caches = decode_tokens(
            cfg, opts, params, tok, caches, prompt + cfg.n_cot_tokens,
            n_act or 24, device=dev, graph=graph)
    else:
        cond = params["embed"][tok[:, 0]]
        trajectory = M.generate_actions_dit(cfg, params, cond, noise=noise,
                                            generator=generator, device=dev,
                                            graph=dit_graph)
    n_vis = cfg.vision.num_tokens if cfg.vision else 0
    return VLAOutput(
        cot_tokens=cot, action_tokens=action_tokens, trajectory=trajectory,
        phase_tokens={"vision": n_vis, "prompt": prompt,
                      "cot": cfg.n_cot_tokens,
                      "action": n_act or (a.dit_steps if a else 0)})
