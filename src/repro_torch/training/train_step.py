"""Training step of the port: causal-LM cross entropy, microbatched
gradient accumulation in f32, optional int8 gradient compression, AdamW
(the port's copy of ``repro.training.train_step``).

Gradients come from autograd through ``models.model.forward`` with
``train=True``, so ``ModelOptions.remat`` checkpoints the layers; fresh
attention in whole 128-row blocks runs the flash kernel
(``kernels/flash_attention``), whose backward is written out in tensor
operations; MoE layers run ``gmm_gated`` / ``gmm_down``, whose backward
products run on ``gmm_down``'s kernel, and Mamba2 layers ``ssd``, whose
backward runs its plain version again under autograd.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as SH
from repro_torch.models import model as M
from repro_torch.models.layers import ModelOptions
from repro_torch.models.params import from_jax, leaves, map_tree, set_leaf
from repro_torch.training import compress as C
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state)


@dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    microbatches: int = 1
    compress_grads: bool = False
    z_loss: float = 1e-4          # logit regularizer (PaLM-style)


def lm_loss(cfg: ModelConfig, opts: ModelOptions, params, batch,
            z_loss: float = 0.0, *, device="cuda"):
    """Next-token CE over batch['tokens']; vision prefix positions and
    padding (token == -1) are masked out of the loss."""
    dev = resolve_device(device)
    tokens = torch.as_tensor(batch["tokens"], device=dev, dtype=torch.long)
    logits = M.forward(cfg, opts, params, batch, train=True, device=dev)
    n_prefix = logits.shape[1] - tokens.shape[1]
    logits = logits[:, n_prefix:]
    targets = tokens[:, 1:]
    logits = logits[:, :-1].float()
    mask = (targets >= 0).float()
    lse = _logsumexp(logits)
    picked = _pick(logits, targets.clamp(min=0))
    nll = (lse - picked) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom
    if z_loss:
        loss = loss + z_loss * (torch.square(lse) * mask).sum() / denom
    return loss


def _pick(logits, targets):
    """``logits`` [B, S, V] at ``targets`` [B, S]. On DTensors (the dry
    run) with the vocab sharded, explicitly (``local_call``): each rank
    picks the targets its vocab shard holds and the picks are partial
    sums over the vocab's mesh dims (DTensor's own rule for a gather on a
    sharded dim does not trace on the meta device)."""
    if not SH.is_dtensor(logits):
        return logits.gather(-1, targets[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    V = logits.shape[-1]
    pl = tuple(p if p.is_shard(0) or p.is_shard(2) else Replicate()
               for p in logits.placements)
    v0 = SH.shard_start(pl, logits.device_mesh, 2, V)
    tpl = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in pl)
    out = tuple(Partial() if p.is_shard(2) else q for p, q in zip(pl, tpl))

    def pick(lg, t):
        t = t - v0
        mine = (t >= 0) & (t < lg.shape[-1])
        got = lg.gather(-1, t.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        return torch.where(mine, got, 0.0)
    return SH.local_call(pick, (logits, SH.replicated_like(targets, logits)),
                         (pl, tpl), (out,))


def _logsumexp(logits):
    """``logsumexp`` over the vocab of ``logits`` [B, S, V]. On DTensors
    (the dry run) with the vocab sharded, explicitly (``local_call``):
    each rank reduces its vocab shard and the shards combine by an
    all-reduce of the maxima and one of the rescaled sums over the
    vocab's mesh dims, where DTensor's own rule gathers the logits."""
    if not SH.is_dtensor(logits):
        return torch.logsumexp(logits, dim=-1)
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate
    mesh = logits.device_mesh
    pl = tuple(p if p.is_shard(0) or p.is_shard(2) else Replicate()
               for p in logits.placements)
    vocab = [m for m, p in enumerate(pl) if p.is_shard(2)]
    out = tuple(Replicate() if p.is_shard(2) else p for p in pl)

    def lse(lg):
        top = lg.amax(-1).detach()
        for m in vocab:
            top = funcol.all_reduce(top, "max", (mesh, m))
        total = torch.exp(lg - top[..., None]).sum(-1)
        for m in vocab:
            total = funcol.all_reduce(total, "sum", (mesh, m))
        return top + torch.log(total)
    return SH.local_call(lse, (logits,), (pl,), (out,))


def _on_device(batch, dev):
    return {k: torch.as_tensor(v, device=dev,
                               dtype=torch.long if k == "tokens" else None)
            for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opts: ModelOptions, tcfg: TrainConfig,
                    *, device="cuda", donate: bool = False):
    """Returns train_step(params, state, batch) -> (params, state,
    metrics); ``state`` is ``init_train_state``'s, metrics 0-d tensors
    (``loss``, ``grad_norm``, ``lr``). batch tokens [B, S] (+ 'patches'),
    numpy or tensors; B must divide by ``tcfg.microbatches``. ``donate``
    updates the parameters and AdamW's moments in place (as a jitted step
    whose arguments are donated reuses their buffers), so that no second
    copy of them is ever held: the trees passed in are then the ones
    returned."""
    dev = resolve_device(device)

    def grads_of(params, batch):
        live = map_tree(lambda t: t.detach().requires_grad_(True), params)
        loss = lm_loss(cfg, opts, live, batch, tcfg.z_loss, device=dev)
        flat = list(leaves(live))
        grads = {}
        for (path, _), g in zip(flat, torch.autograd.grad(
                loss, [t for _, t in flat])):
            set_leaf(grads, path, g)
        return loss.detach(), grads

    def train_step(params, state, batch):
        batch = _on_device(batch, dev)
        n = tcfg.microbatches
        if n > 1:
            grads = map_tree(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            loss = 0.0
            for i in range(n):
                mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                      for k, v in batch.items()}
                l_i, g = grads_of(params, mb)
                grads = map_tree(torch.add, grads, g)
                loss = loss + l_i
            grads = map_tree(lambda g: g / n, grads)
            loss = loss / n
        else:
            loss, grads = grads_of(params, batch)
        if tcfg.compress_grads:
            grads, err = C.compress_grads(grads, state["error"])
        new_params, new_inner, metrics = adamw_update(
            tcfg.opt, grads, state["inner"], params, inplace=donate)
        new_state = {"inner": new_inner}
        if tcfg.compress_grads:
            new_state["error"] = err
        return new_params, new_state, dict(metrics, loss=loss)

    return train_step


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, params):
    state = {"inner": init_opt_state(tcfg.opt, params)}
    if tcfg.compress_grads:
        state["error"] = C.init_error_state(params)
    return state


def train_state_from_jax(template, state, device="cuda"):
    """The reference's train state (``{"inner": {"mu", "nu", "count"},
    "error"?}`` as numpy arrays) on the port: the moment and error trees
    through ``from_jax`` over the model template, keeping their types, and
    the step count as a 0-d int32 tensor."""
    dev = resolve_device(device)
    inner = state["inner"]
    out = {"inner": {
        "mu": from_jax(template, inner["mu"], device=dev),
        "nu": from_jax(template, inner["nu"], device=dev),
        "count": torch.tensor(int(np.asarray(inner["count"])),
                              dtype=torch.int32, device=dev)}}
    if "error" in state:
        out["error"] = from_jax(template, state["error"], device=dev)
    return out
