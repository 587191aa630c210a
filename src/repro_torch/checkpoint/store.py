"""Atomic, optionally asynchronous checkpoints (the port's copy of
``repro.checkpoint.store``, in the reference's on-disk layout, so either
package reads the other's checkpoints).

Layout: <dir>/step_<n>/ with one .npy per leaf, named by the leaf's
"/"-joined path key, plus index.json (step, and each leaf's file, shape
and dtype). A tree is nested dicts (keys in sorted order) and lists or
tuples (by index) of tensors, numpy arrays or numbers. bf16 leaves are
stored as their uint16 bits with dtype "bfloat16" (no ``ml_dtypes``
needed). Commit is atomic: written to step_<n>.tmp, then renamed.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch


def _to_numpy(v):
    """A leaf as (the array stored on disk, its dtype name): bf16 as its
    uint16 bits named "bfloat16"."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        v = v.numpy()
    v = np.asarray(v)
    return v, str(v.dtype)


def _from_numpy(v: "np.ndarray", dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(v))


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{path key: leaf} in the reference's flattening order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    elif tree is None:
        return {}
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return flat


def save(ckpt_dir: str, step: int, tree, *, async_: bool = False):
    """Save ``tree`` under <ckpt_dir>/step_<step>. The leaves are copied to
    the host before this returns; with ``async_`` the files are written on
    a thread, whose handle (``join()``) is returned, else None."""
    flat = {k: _to_numpy(v) for k, v in _flatten(tree).items()}

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        index = {"step": step, "leaves": {}}
        for k, (v, dtype) in flat.items():
            fname = k.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), v)
            index["leaves"][k] = {"file": fname, "shape": list(v.shape),
                                  "dtype": dtype}
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(index, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _rebuild(like, flat: Dict[str, Any], prefix: str = ""):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], flat, f"{prefix}/{k}" if prefix
                            else str(k)) for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, flat, f"{prefix}/{i}" if prefix
                                   else str(i)) for i, v in enumerate(like))
    if like is None:
        return None
    return flat[prefix]


def restore(ckpt_dir: str, step: int, like):
    """Restore into the structure of ``like``: every leaf as a tensor of
    the stored type, on the device of ``like``'s leaf where that is a
    tensor (else on the CPU)."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "index.json")) as f:
        index = json.load(f)
    out = {}
    for k, leaf in _flatten(like).items():
        meta = index["leaves"][k]
        v = _from_numpy(np.load(os.path.join(d, meta["file"])),
                        meta["dtype"])
        out[k] = v.to(leaf.device) if isinstance(leaf, torch.Tensor) else v
    return _rebuild(like, out)
