"""The C entries of ``csrc/graph_cond.cu``: an IF node added to a CUDA
graph while PyTorch captures it, and its body filled from another captured
graph afterwards (``models.graphs.StepGraph`` runs both). They exist on the
card only: a graph node has no plain version, and the CPU runs a guarded
step's body eagerly instead."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ops import cuda_stream


def if_node(pred: torch.Tensor) -> ctypes.c_void_p:
    """Inside a capture on the current stream: an IF node on ``pred`` (a
    0-d bool on the card, read when the graph runs) after the work
    captured so far; the work captured after it depends on it. Returns
    the node's body graph, empty until ``fill``."""
    if pred.device.type != "cuda" or pred.dtype != torch.bool \
            or pred.dim() != 0:
        raise ValueError(f"an IF node's condition is a 0-d bool tensor on "
                         f"the card, got {pred.dtype} {tuple(pred.shape)} "
                         f"on {pred.device}")
    body = ctypes.c_void_p()
    _build.launch("graph_if_node", cuda_stream(pred.device),
                  pred.data_ptr(), ctypes.addressof(body))
    return body


def fill(body: ctypes.c_void_p, graph: torch.cuda.CUDAGraph) -> None:
    """A copy of ``graph`` (captured with ``keep_graph=True``, not
    instantiated) as the body of the IF node that ``if_node`` returned."""
    _build.launch("graph_if_fill", body, graph.raw_cuda_graph())
