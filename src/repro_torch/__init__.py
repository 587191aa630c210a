"""PyTorch/CUDA port of the VLA reproduction.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``configs``, ``models``, ``core``, ``kernels``) and imports nothing
from it. Entry points take an explicit ``device`` that defaults to
``"cuda"``; the attention kernels are hand-written CUDA C++ for Hopper
(``kernels/*/csrc``), and each wrapper runs its plain PyTorch version only
for tensors that lie on the CPU or on the meta device (the dry run's
shapes-only pass, ``launch/dryrun.py``).
"""
import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default of every
    entry point) needs a card: without one this raises rather than fall
    back to the CPU, which must be asked for explicitly. ``"meta"`` runs
    the plain versions on shapes alone (the dry run)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port's plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
