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

Both are differentiable through ``GmmGated`` and ``GmmDown`` (the TPU
kernels are forward only; the reference trains through plain einsums).
Their backward runs every product on ``gmm_down``'s kernel (``_products``:
the weights transposed into contiguous copies, the capacity padded with
zero rows where it is the contraction), so ``gmm_down.launches`` counts
those launches too: three for a ``gmm_gated`` backward (the f32 sums
x@[wi|wg] again, dx, [dwi|dwg]; on f32 operands, the kernel's f32 body)
and two for a ``gmm_down`` backward (dh, dwo; in h's dtype, bf16 on the
tensor cores). A backward launch that fails raises; nothing falls back to
the plain version on the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build, count_launches, runs_plain

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


_GELU_C = math.sqrt(2.0 / math.pi)


def _gelu_tanh_and_slope(u):
    """(gelu_tanh(u), its derivative) in f32."""
    t = torch.tanh(_GELU_C * (u + 0.044715 * u ** 3))
    slope = 0.5 * (1 + t) + 0.5 * u * (1 - t * t) * _GELU_C * (
        1 + 3 * 0.044715 * u * u)
    return 0.5 * u * (1 + t), slope


def _act_grads(h, g, dout, act: str):
    """The gradients of ``_act_f32`` with respect to its f32 sums h and g,
    given dout (f32): (dh, dg); dg is zeros for gelu_plain, which reads no
    g."""
    if act == "gelu_plain":
        _, slope = _gelu_tanh_and_slope(h)
        return dout * slope, torch.zeros_like(h)
    if act == "silu":
        s = torch.sigmoid(g)
        f, slope = g * s, s * (1 + g * (1 - s))
    else:
        f, slope = _gelu_tanh_and_slope(g)
    return dout * f, dout * h * slope


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


def _gated_launch(x, wi, wg, act: str):
    """One launch of the gmm_gated kernel (CUDA operands)."""
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


def _products(a, b):
    """Per expert a @ b with f32 sums, in a's dtype: a [E,M,K], b [E,K,N]
    (N a multiple of 8) -> [E,M,N]. ``gmm_down``'s kernel for CUDA tensors
    (K padded with zeros to a multiple of 8, which adds nothing to a sum;
    each launch counts in ``gmm_down.launches``), ``gmm_down_ref`` for CPU
    tensors."""
    if runs_plain(a):
        return gmm_down_ref(a, b)
    E, M, K = a.shape
    N = b.shape[-1]
    if K % 8:
        a = torch.nn.functional.pad(a, (0, 8 - K % 8))
        b = torch.nn.functional.pad(b, (0, 0, 0, 8 - K % 8))
    a, (b,) = _launchable("gmm_down", a, [b])
    out = torch.empty(E, M, N, dtype=a.dtype, device=a.device)
    if M and K:
        _build.launch("gmm_down_launch", a.data_ptr(), b.data_ptr(),
                      out.data_ptr(), int(a.dtype == torch.bfloat16), E, M,
                      a.shape[-1], N,
                      torch.cuda.current_stream(a.device).cuda_stream)
        count_launches(gmm_down)
    elif M:
        out.zero_()
    return out


def _t(w):
    """[E,A,B] -> a contiguous [E,B,A]."""
    return w.transpose(1, 2).contiguous()


class GmmGated(torch.autograd.Function):
    """Forward: the gmm_gated kernel on the card, ``gmm_gated_ref`` on the
    CPU. Backward from x, wi and wg (the output is not kept): the f32
    sums [a|g] = x @ [wi|wg] again, the activation's derivative on them
    in f32, then dx = [da|dg] @ [wi|wg]^T and [dwi|dwg] = x^T @ [da|dg],
    each one ``_products`` (gelu_plain reads no wg: its half is left out
    and wg's gradient is zeros). The three run on f32 operands, as
    autograd through the plain version multiplies them: the sums must not
    be rounded, and [da|dg] rounded to bf16 before the contraction over C
    would be off by about 2**-9 x sqrt(C) of a term, more than 1e-2 where
    a gradient is near zero. dx and the weights' gradients are rounded
    to x's dtype once, at the end."""

    @staticmethod
    def forward(ctx, x, wi, wg, act: str):
        ctx.save_for_backward(x, wi, wg)
        ctx.act = act
        if runs_plain(x):
            return gmm_gated_ref(x, wi, wg, act)
        return _gated_launch(x, wi, wg, act)

    @staticmethod
    def backward(ctx, dout):
        x, wi, wg = ctx.saved_tensors
        act, F = ctx.act, wi.shape[-1]
        plain = act == "gelu_plain"
        x32 = x.float()
        w = (wi if plain else torch.cat([wi, wg], dim=2)).float()
        s = _products(x32, w)                                 # [E,C,F|2F]
        a, g = (s, None) if plain else (s[..., :F], s[..., F:])
        da, dg = _act_grads(a, g, dout.float(), act)
        d = da if plain else torch.cat([da, dg], dim=2)
        dx = _products(d, _t(w)).to(x.dtype)
        dw = _products(_t(x32), d).to(x.dtype)                # [E,D,F|2F]
        dwi = dw[..., :F]
        dwg = torch.zeros_like(wg) if plain else dw[..., F:]
        return dx, dwi, dwg, None


class GmmDown(torch.autograd.Function):
    """Forward: the gmm_down kernel on the card, ``gmm_down_ref`` on the
    CPU. Backward: dh = dy @ wo^T and dwo = h^T @ dy, each one
    ``_products``."""

    @staticmethod
    def forward(ctx, h, wo):
        ctx.save_for_backward(h, wo)
        return _products(h, wo)

    @staticmethod
    def backward(ctx, dy):
        h, wo = ctx.saved_tensors
        return _products(dy, _t(wo)), _products(_t(h), dy)


def gmm_gated(x, wi, wg, *, act: str = "silu"):
    """x [E,C,D]; wi/wg [E,D,F] -> act-fused h [E,C,F] in x's dtype (f32
    sums, the activation on them). ``act``: silu (silu(x@wg) * x@wi), gelu
    (tanh gelu of x@wg times x@wi) or gelu_plain (tanh gelu of x@wi; wg is
    not read). Differentiable through ``GmmGated``."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    _check("gmm_gated", x, [wi, wg], x.shape[-1], wi.shape[-1])
    return GmmGated.apply(x, wi, wg, act)


def gmm_down(h, wo):
    """h [E,C,F]; wo [E,F,D] -> [E,C,D] in h's dtype (f32 sums).
    Differentiable through ``GmmDown``."""
    _check("gmm_down", h, [wo], h.shape[-1], wo.shape[-1])
    return GmmDown.apply(h, wo)


def grouped_mlp(xe, wi, wg, wo, act: str = "silu"):
    """xe [E,C,D]; wi/wg [E,D,F]; wo [E,F,D] -> [E,C,D]: ``gmm_gated``
    (h rounded to xe's dtype) then ``gmm_down``, as the Pallas pair."""
    return gmm_down(gmm_gated(xe, wi, wg, act=act), wo)


def grouped_mlp_ref(xe, wi, wg, wo, act: str = "silu"):
    """Plain version of ``grouped_mlp``."""
    return gmm_down_ref(gmm_gated_ref(xe, wi, wg, act), wo)


gmm_gated.launches = 0
gmm_down.launches = 0
