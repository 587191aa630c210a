"""Grouped expert MLP: the wrappers of the CUDA kernels and their plain
versions.

``gmm_gated`` and ``gmm_down`` launch the C entries of ``csrc/moe_gmm.cu``
(which replace the TPU kernels ``repro/kernels/moe_gmm/moe_gmm.py:
gmm_gated`` and ``gmm_down``; bf16 runs on the tensor cores,
``csrc/gmm_gated_tc.cu`` and ``csrc/gmm_down_tc.cu``) for CUDA tensors and
run ``gmm_gated_ref`` / ``gmm_down_ref`` for CPU tensors; nothing else
chooses between them.
``gmm_gated.launches`` and ``gmm_down.launches`` count the kernels'
launches. The Pallas calls' block sizes and ``interpret`` flag have no
counterpart: the kernels tile themselves and the device picks the path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, count_launches

ACTS = {"silu": 0, "gelu": 1, "gelu_plain": 2}   # the kernels' act codes
DTYPES = (torch.float32, torch.bfloat16)
# rows of C one block of the bf16 gmm_gated covers (wgmma's N): its
# instantiations in csrc/gmm_gated_tc.cu
GATED_ROWS = (32, 64, 128, 160, 256)


def gated_rows(C: int) -> int:
    """The rows per pass the bf16 ``gmm_gated`` kernel takes for capacity
    ``C``: the smallest instantiation that holds C, so that C <= 256 runs
    in one pass and reads each weight byte once; a larger C takes
    ceil(C / 256) passes of 256 rows."""
    return next((r for r in GATED_ROWS if C <= r), GATED_ROWS[-1])


def _act_f32(h, g, act: str):
    """The activation on f32 sums (gelu is the tanh form, as JAX's)."""
    if act == "silu":
        return torch.nn.functional.silu(g) * h
    if act == "gelu":
        return torch.nn.functional.gelu(g, approximate="tanh") * h
    return torch.nn.functional.gelu(h, approximate="tanh")


def gmm_gated_ref(x, wi, wg, act: str = "silu"):
    """Plain version: per expert act(x@wi, x@wg) with f32 sums, rounded to
    x's dtype. x [E,C,D]; wi/wg [E,D,F] -> [E,C,F]."""
    xf = x.float()
    h = torch.bmm(xf, wi.float())
    g = torch.bmm(xf, wg.float()) if act != "gelu_plain" else None
    return _act_f32(h, g, act).to(x.dtype)


def gmm_down_ref(h, wo):
    """Plain version: per expert h@wo with f32 sums, in h's dtype.
    h [E,C,F]; wo [E,F,D] -> [E,C,D]."""
    return torch.bmm(h.float(), wo.float()).to(h.dtype)


def _check(name, x, ws, contraction: int, columns: int):
    if x.dim() != 3 or any(w.dim() != 3 for w in ws):
        raise ValueError(f"{name} wants [E,C,·] activations and [E,·,·] "
                         f"weights; got {tuple(x.shape)}, "
                         f"{[tuple(w.shape) for w in ws]}")
    E = x.shape[0]
    for w in ws:
        if tuple(w.shape) != (E, contraction, columns):
            raise ValueError(f"{name}: weights {tuple(w.shape)} do not "
                             f"match activations {tuple(x.shape)}")
    if x.dtype not in DTYPES or any(w.dtype != x.dtype for w in ws):
        raise TypeError(f"{name}: activations and weights must share one "
                        f"type, float32 or bfloat16; got {x.dtype}, "
                        f"{[w.dtype for w in ws]}")
    if any(w.device != x.device for w in ws):
        raise ValueError(f"{name}: activations and weights must be on one "
                         f"device")


def _launchable(name, x, ws):
    """Contiguous operands the kernel takes: 16-byte rows of whole chunks
    (every width a multiple of 8) at 16-byte aligned addresses."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    ws = [w.contiguous() for w in ws]
    if x.shape[2] % 8 or ws[0].shape[2] % 8:
        raise ValueError(f"{name}: widths must be multiples of 8, got "
                         f"{x.shape[2]} and {ws[0].shape[2]}")
    if any(t.data_ptr() % 16 for t in [x, *ws]):
        raise ValueError(f"{name}: operands must be 16-byte aligned")
    return x, ws


def gmm_gated(x, wi, wg, *, act: str = "silu"):
    """x [E,C,D]; wi/wg [E,D,F] -> act-fused h [E,C,F] in x's dtype (f32
    sums, the activation on them). ``act``: silu (silu(x@wg) * x@wi), gelu
    (tanh gelu of x@wg times x@wi) or gelu_plain (tanh gelu of x@wi; wg is
    not read)."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    _check("gmm_gated", x, [wi, wg], x.shape[-1], wi.shape[-1])
    if x.device.type == "cpu":
        return gmm_gated_ref(x, wi, wg, act)
    x, (wi, wg) = _launchable("gmm_gated", x, [wi, wg])
    E, C, D = x.shape
    F = wi.shape[-1]
    out = torch.empty(E, C, F, dtype=x.dtype, device=x.device)
    if C:
        _build.launch("gmm_gated_launch", x.data_ptr(), wi.data_ptr(),
                      wg.data_ptr(), out.data_ptr(),
                      int(x.dtype == torch.bfloat16), ACTS[act], E, C, D, F,
                      gated_rows(C),
                      torch.cuda.current_stream(x.device).cuda_stream)
        count_launches(gmm_gated)
    return out


def gmm_down(h, wo):
    """h [E,C,F]; wo [E,F,D] -> [E,C,D] in h's dtype (f32 sums)."""
    _check("gmm_down", h, [wo], h.shape[-1], wo.shape[-1])
    if h.device.type == "cpu":
        return gmm_down_ref(h, wo)
    h, (wo,) = _launchable("gmm_down", h, [wo])
    E, C, F = h.shape
    D = wo.shape[-1]
    out = torch.empty(E, C, D, dtype=h.dtype, device=h.device)
    if C:
        _build.launch("gmm_down_launch", h.data_ptr(), wo.data_ptr(),
                      out.data_ptr(), int(h.dtype == torch.bfloat16), E, C,
                      F, D, torch.cuda.current_stream(h.device).cuda_stream)
        count_launches(gmm_down)
    return out


def grouped_mlp(xe, wi, wg, wo, act: str = "silu"):
    """xe [E,C,D]; wi/wg [E,D,F]; wo [E,F,D] -> [E,C,D]: ``gmm_gated``
    (h rounded to xe's dtype) then ``gmm_down``, as the Pallas pair."""
    return gmm_down(gmm_gated(xe, wi, wg, act=act), wo)


def grouped_mlp_ref(xe, wi, wg, wo, act: str = "silu"):
    """Plain version of ``grouped_mlp``."""
    return gmm_down_ref(gmm_gated_ref(xe, wi, wg, act), wo)


gmm_gated.launches = 0
gmm_down.launches = 0
