"""End-to-end training entry point of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 200 --batch 8 --seq 128 --reduced --ckpt CKPT_DIR

Runs on the card by default; ``--device cpu`` runs the plain PyTorch path
(use ``--reduced`` there). Fault tolerance: periodic async checkpoints +
``ResilientLoop`` retry / restore; ``--simulate-failure N`` injects a
``StepFailure`` at step N to exercise the path end to end.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import (ResilientLoop, StepFailure, latest_step,
                                    restore)
from repro_torch.configs import get_config
from repro_torch.data import Prefetcher, lm_batches
from repro_torch.models import model as M
from repro_torch.models.layers import ModelOptions
from repro_torch.training import (AdamWConfig, TrainConfig, init_train_state,
                                  make_train_step)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="smollm-135m")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--ckpt", default="")
    p.add_argument("--save-every", type=int, default=50)
    p.add_argument("--simulate-failure", type=int, default=-1)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opts = ModelOptions(remat=False)
    tcfg = TrainConfig(opt=AdamWConfig(lr=args.lr, warmup_steps=10,
                                       total_steps=args.steps),
                       microbatches=args.microbatches)

    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, gen, torch.float32, device=dev)
    opt_state = init_train_state(cfg, tcfg, params)
    step_fn = make_train_step(cfg, opts, tcfg, device=dev)
    # unbounded stream: failure-replayed steps consume extra batches
    data = Prefetcher(lm_batches(cfg, args.batch, args.seq, steps=None))

    start = 0
    if args.ckpt:
        ck = latest_step(args.ckpt)
        if ck is not None:
            print(f"[train] resuming from step {ck}")
            state0 = restore(args.ckpt, ck,
                             {"params": params, "opt": opt_state})
            params, opt_state = state0["params"], state0["opt"]
            start = ck + 1

    fails = {args.simulate_failure}

    def fault_hook(step):
        if step in fails:
            fails.discard(step)
            raise StepFailure(f"injected at {step}")

    losses = []
    t0 = time.time()

    def one_step(state, step, it):
        params, opt_state, metrics = step_fn(state["params"], state["opt"],
                                             next(it))
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0:
            dt = time.time() - t0
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} ({dt:.1f}s)")
        return {"params": params, "opt": opt_state}

    state = {"params": params, "opt": opt_state}
    if args.ckpt:
        loop = ResilientLoop(one_step, args.ckpt, save_every=args.save_every,
                             fault_hook=fault_hook, async_save=True)
        state, _ = loop.run(state, start, args.steps - start, iter(data))
        print(f"[train] restores={loop.restores}")
    else:
        it = iter(data)
        for s in range(start, args.steps):
            fault_hook(s)
            state = one_step(state, s, it)
    print(f"[train] done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
