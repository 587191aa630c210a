"""Mamba2 chunked SSD scan: the wrapper of the CUDA kernel and its plain
version.

``ssd`` launches ``csrc/ssd.cu`` (which replaces the TPU kernel
``repro/kernels/ssd/ssd.py: ssd_kernel``) for CUDA tensors and runs
``ssd_chunked`` for CPU tensors; nothing else chooses between them.
``ssd.launches`` counts calls of the C entry, each of which enqueues two
kernels: the chunk states (``ssd_chunk_states``, written to a scratch)
and the output that composes them. Both take the model-facing
layout of ``repro/kernels/ssd/ops.py: ssd`` (B and C with a group axis of
size 1, dropped here) and follow ``ssd_chunked``'s contract: the sequence
is one chunk when S <= Q, else S must be a multiple of Q (the reference's
Pallas kernel leaves the rows past the last whole chunk unwritten there).

``ssd`` is differentiable through ``SSD`` (the TPU kernel is forward only):
its backward runs ``ssd_chunked`` again from the saved inputs under
autograd, on the tensors' device; a backward kernel is later work.
``ssd_chunked`` masks the intra-chunk decay before its exponential, so
its gradient stays finite where an exponential taken over the whole
square and masked afterwards overflows above the diagonal.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, count_launches, runs_plain

DTYPES = (torch.float32, torch.bfloat16)
Q_MAX = 128        # the kernel's largest chunk
N_MAX = 128        # the kernel's largest state size


def chunk_len(S: int, Q: int) -> int:
    """The chunk length for S rows: min(Q, S); S must be a multiple of it."""
    Q = min(Q, S)
    if Q <= 0 or S % Q:
        raise ValueError(f"SSD scan over {S} rows in chunks of {Q}: the "
                         f"sequence must fit one chunk or be a multiple of "
                         f"the chunk length")
    return Q


def _check(xs, dt, A_log, B_, C_):
    if xs.dim() != 4:
        raise ValueError(f"xs must be [B,S,H,P], got {tuple(xs.shape)}")
    Bsz, S, H, P = xs.shape
    if tuple(dt.shape) != (Bsz, S, H) or tuple(A_log.shape) != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / A_log "
                         f"{tuple(A_log.shape)} do not match xs "
                         f"{tuple(xs.shape)}")
    for name, m in (("B_", B_), ("C_", C_)):
        if m.dim() != 4 or tuple(m.shape[:3]) != (Bsz, S, 1):
            raise ValueError(f"{name} must be [B,S,1,N] (one group), got "
                             f"{tuple(m.shape)}")
    if B_.shape != C_.shape:
        raise ValueError("B_ and C_ must have one shape")
    if any(t.device != xs.device for t in (dt, A_log, B_, C_)):
        raise ValueError("ssd operands must be on one device")


def ssd_chunk_states(xs, dt, A_log, B_, Q: int = 128):
    """Each chunk's own contribution to the state and its decay, what the
    kernel's first pass writes to its scratch: (states [B,H,nc,P,N], the
    chunk's u^T B with u = x dt exp(seg - cum), and seg [B,H,nc], the
    chunk's sum of dt a), both f32. Composed in order, h = h exp(seg_k) +
    states_k from h = 0, they give the state entering each chunk and, past
    the last, ``ssd_chunked``'s final state."""
    Bsz, S, H, P = xs.shape
    N = B_.shape[-1]
    Q = chunk_len(S, Q)
    nc = S // Q
    A = -torch.exp(A_log.float())                              # [H]
    x = xs.float().reshape(Bsz, nc, Q, H, P)
    d = dt.float().reshape(Bsz, nc, Q, H)
    b = B_.float().reshape(Bsz, nc, Q, N)
    cum = torch.cumsum(d * A, dim=2)                           # [B,nc,Q,H]
    seg = cum[:, :, -1]                                        # [B,nc,H]
    decay_to_end = torch.exp(seg[:, :, None] - cum)            # [B,nc,Q,H]
    states = torch.einsum("bctn,bcth,bcthp->bchpn", b, decay_to_end * d, x)
    return states.permute(0, 2, 1, 3, 4), seg.permute(0, 2, 1)


def ssd_chunked(xs, dt, A_log, B_, C_, Q: int = 128):
    """Plain version (the chunked SSD of the Mamba2 paper, as the
    reference's ``layers.ssd_chunked`` without its head split): the
    quadratic intra-chunk term plus the linear inter-chunk recurrence, in
    f32 throughout, as the kernel computes (the reference's einsum path
    rounds C B^T to the input type; equal in f32). xs [B,S,H,P]; dt
    [B,S,H]; A_log [H]; B_/C_ [B,S,1,N]. Returns (y [B,S,H,P] in xs's
    dtype, final state [B,H,P,N] f32)."""
    _check(xs, dt, A_log, B_, C_)
    Bsz, S, H, P = xs.shape
    N = B_.shape[-1]
    Q = chunk_len(S, Q)
    nc = S // Q
    A = -torch.exp(A_log.float())                              # [H]
    x = xs.float().reshape(Bsz, nc, Q, H, P)
    d = dt.float().reshape(Bsz, nc, Q, H)
    b = B_.float().reshape(Bsz, nc, Q, N)
    c = C_.float().reshape(Bsz, nc, Q, N)
    cum = torch.cumsum(d * A, dim=2)                           # [B,nc,Q,H]
    seg = cum[:, :, -1]                                        # [B,nc,H]
    # L[s,t] = exp(cum_s - cum_t) for s >= t (masked before the exp)
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool,
                                   device=xs.device))[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # [B,nc,Q,Q,H]
    L = torch.exp(diff.masked_fill(~causal, float("-inf")))
    cb = torch.einsum("bcsn,bctn->bcst", c, b)
    xdt = x * d[..., None]                                     # [B,nc,Q,H,P]
    y = torch.einsum("bcsth,bcthp->bcshp", cb[..., None] * L, xdt)
    states, segs = ssd_chunk_states(xs, dt, A_log, B_, Q)
    h = torch.zeros(Bsz, H, P, N, dtype=torch.float32, device=xs.device)
    h_prev = []
    for k in range(nc):                     # the state before each chunk
        h_prev.append(h)
        h = h * torch.exp(segs[:, :, k])[..., None, None] + states[:, :, k]
    y = y + torch.einsum("bcsn,bcsh,bchpn->bcshp", c, torch.exp(cum),
                         torch.stack(h_prev, 1))
    return y.reshape(Bsz, S, H, P).to(xs.dtype), h


def _aligned(t):
    """``t`` contiguous with 16-byte aligned data (the kernel's vector
    loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(xs, dt, A_log, B_, C_, Q: int):
    """One call of the C entry on the current stream -> (y, final state,
    scratch). The scratch holds what the first kernel writes: the chunk
    states and seg (``scratch_states``), then C B^T [B,nc,Q,Q]."""
    Bsz, S, H, P = xs.shape
    N = B_.shape[-1]
    Q = chunk_len(S, Q)
    if Q > Q_MAX or N > N_MAX:
        raise ValueError(f"the kernel takes chunks of at most {Q_MAX} rows "
                         f"and states of at most {N_MAX}; got Q={Q}, N={N}")
    if xs.dtype not in DTYPES or B_.dtype != xs.dtype \
            or C_.dtype != xs.dtype:
        raise TypeError(f"xs, B_ and C_ must share one type, float32 or "
                        f"bfloat16; got {xs.dtype}, {B_.dtype}, {C_.dtype}")
    x = _aligned(xs)
    d = dt.float().contiguous()
    a = A_log.float().contiguous()
    b = _aligned(B_[:, :, 0])
    c = _aligned(C_[:, :, 0])
    nc = S // Q
    y = torch.empty_like(x)
    state = torch.empty(Bsz, H, P, N, dtype=torch.float32, device=x.device)
    lead = Bsz * H * nc * (P * N + 1)             # states, then seg
    scratch = torch.empty(-(-lead // 4) * 4 + Bsz * nc * Q * Q,
                          dtype=torch.float32, device=x.device)
    _build.launch("ssd_launch", x.data_ptr(), d.data_ptr(), a.data_ptr(),
                  b.data_ptr(), c.data_ptr(), scratch.data_ptr(),
                  y.data_ptr(), state.data_ptr(),
                  int(x.dtype == torch.bfloat16), Bsz, S, H, P, N, Q,
                  torch.cuda.current_stream(x.device).cuda_stream)
    count_launches(ssd)
    return y, state, scratch


def scratch_states(scratch, xs, N: int, Q: int = 128):
    """The chunk states [B,H,nc,P,N] and seg [B,H,nc] in a scratch from
    ``_launch`` (for xs [B,S,H,P]): what ``ssd_chunk_states`` computes."""
    Bsz, S, H, P = xs.shape
    nc = S // chunk_len(S, Q)
    cut = Bsz * H * nc * P * N
    return (scratch[:cut].view(Bsz, H, nc, P, N),
            scratch[cut:cut + Bsz * H * nc].view(Bsz, H, nc))


class SSD(torch.autograd.Function):
    """Forward: the kernel on the card, ``ssd_chunked`` on the CPU.
    Backward: the vector-Jacobian product of ``ssd_chunked`` recomputed
    from the saved inputs, for y and, where it has a gradient, the final
    state."""

    @staticmethod
    def forward(ctx, xs, dt, A_log, B_, C_, Q: int):
        ctx.save_for_backward(xs, dt, A_log, B_, C_)
        ctx.Q = Q
        ctx.set_materialize_grads(False)
        if runs_plain(xs):
            return ssd_chunked(xs, dt, A_log, B_, C_, Q)
        return _launch(xs, dt, A_log, B_, C_, Q)[:2]

    @staticmethod
    def backward(ctx, dy, dstate):
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            outs = ssd_chunked(*ins, ctx.Q)
            pairs = [(o, d) for o, d in zip(outs, (dy, dstate))
                     if d is not None]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], [t for t in ins if t.requires_grad],
                [d for _, d in pairs], allow_unused=True))
        return (*(next(grads) if n else None for n in need), None)


def ssd(xs, dt, A_log, B_, C_, Q: int = 128):
    """Model-facing SSD: xs [B,S,H,P] (f32 or bf16); dt [B,S,H]; A_log [H];
    B_/C_ [B,S,1,N] in xs's type. Returns (y [B,S,H,P] in xs's dtype,
    final state [B,H,P,N] f32): the kernel for CUDA tensors, the plain
    ``ssd_chunked`` for CPU tensors; differentiable through ``SSD``."""
    _check(xs, dt, A_log, B_, C_)
    return SSD.apply(xs, dt, A_log, B_, C_, int(Q))


ssd.launches = 0
