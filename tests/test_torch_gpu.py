"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; each test skips with a reason where no CUDA device exists
(the kernels have no CPU mode). This file imports no JAX, so it runs on the
machine with the card: ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_gpu.py``. Inputs are at the main path's shapes; outputs
must agree within 1e-2 x max(1, |plain|) (bf16 output rounding and f32
sums in another order). A paged launch and a dense launch over the same
rows at page_size 32 must be bit-equal. The decode kernels, dense and
paged, also run at granite-moe-3b-a800m's heads (h=64), at h=16, and at
query groups of 16 and 32; the dense one is also held against the plain
model of its split. The grouped-expert kernels run at
granite-moe-3b-a800m's width (E=40, D=1536, F=512) and the capacities the
served path gives them (C = 2 at decode, 32 for a 128-row chunk, 160 for a
640-row prefill) and a ragged one; the SSD scan at mamba2-780m's width
(H=48, P=64, N=128, chunks of 128) at the admission prefill's 640 rows,
at one to six chunks and at one chunk or less, and at the reduced models'
width, its f32 outputs, its final state and the chunk states of its first
pass (the scratch, against ``ssd_chunk_states``) within 1e-4 x max(1,
|plain|) (3xTF32 on the tensor cores), the same bits on two calls. Both
chunk bodies (bf16 and 3xTF32, tensor cores) and the bf16 gmm_gated and
gmm_down (tensor cores) also run at the edges of their tiles: ragged S and L,
every head dim, G = 1, 4, 7, windows crossing tile and block edges and
shorter than a block, capacities off their row tiles and past one pass,
widths off the 64-wide tiles. The 3xTF32 body (every pairing of q and
storage but bf16 over bf16) with an f32 q is held to 1e-4 x max(1,
|plain|), dense and paged, for every page type and scale mode, and is
chunking-invariant and paged = dense bit for bit too. The flash
kernel (the two chunk bodies) runs at smollm-135m's and molmoact-7b's
heads and h = 16 in f32 and bf16, causal or not, with windows and Sk !=
S, against the plain version on the inputs taken to f32 (the function it
computes from either type), f32 within 1e-4 x max(1, |plain|), with its
log-sum-exp, and its backward against autograd through the plain version
within 1e-4 x max(1, |plain|) (f32, sums in another order). Decode
replayed from a CUDA graph (``model.DecodeGraph``, the engine's
``DecodeTick``) equals the same step run eagerly bit for bit, tokens and
caches, for a graph reused on its caches and captured again for others,
and for engines whose page tables and tick depths change between
replays; a capture that fails raises. Reduced granite-moe-3b-a800m and
mamba2-780m train on the card as on the CPU: loss and gradients within
1e-5 (relative, x max|g|), one step's parameters on the training bars.
"""
import pytest
import torch

from repro_torch.kernels.chunk_prefill import ops as cp
from repro_torch.kernels.chunk_prefill import paged as pcp
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.decode_attention import paged as pg
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.moe_gmm import ops as gmm
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import kv_quant


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card "
                    "(python3 chip_smoke.py runs them on the H100)")
    return torch.device("cuda")


def _close(got, want, tol=1e-2):
    return bool(((got.float() - want.float()).abs()
                 <= tol * want.float().abs().clamp(min=1)).all())


TF32X3 = 1e-4    # a 3xTF32 kernel with an f32 output (~2**-21 a product)


# (index, window) of the decode kernels: the edges of their 128-key splits
# (127, 128, 255), windows across a split edge (150 and 280 with 64) and
# shorter than a split (16), per-slot indices with 0
SPLIT_EDGES = [(0, 0), (127, 0), (128, 0), (255, 0), (511, 0), (831, 0),
               ((640, 700, 783, 831), 0), ((0, 127, 128, 255), 0),
               (150, 64), (280, 64), (736, 16), ((0, 150, 280, 831), 64)]


# (N, K, h) of the decode kernels' card tests: molmoact-7b's heads (G=7),
# granite-moe-3b-a800m's (h=64, G=3), the reduced models' h=16, and query
# groups of 16 and 32, the kernels' wide instantiation (G <= 32)
HEADS = [(28, 4, 128), (24, 8, 64), (8, 2, 16), (32, 2, 16), (32, 1, 16),
         (32, 2, 128), (32, 1, 128)]


def _slots(index, B, dev):
    """An index of the tests as the kernel takes it: an int, or a tuple
    repeated over B slots as an int32 tensor."""
    if not isinstance(index, tuple):
        return index
    return torch.tensor((index * B)[:B], dtype=torch.int32, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("kv", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("index,window", SPLIT_EDGES)
def test_decode_kernel_on_card(index, window, kv, heads):
    """The split-key kernel and its combine against the plain version and
    against the plain model of the split (decode_attention_split_ref); the
    same bits on two calls."""
    dev = _cuda()
    N, K, h = heads
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(4, N, h, generator=g, device=dev).bfloat16()
    kc = torch.randn(4, 833, K, h, generator=g, device=dev).to(kv)
    vc = torch.randn(4, 833, K, h, generator=g, device=dev).to(kv)
    idx = _slots(index, 4, dev)
    got = da.decode_attention(q, kc, vc, idx, window=window)
    again = da.decode_attention(q, kc, vc, idx, window=window)
    want = da.decode_attention_ref(q.float(), kc, vc, idx, window)
    split = da.decode_attention_split_ref(q.float(), kc, vc, idx, window)
    torch.cuda.synchronize()
    assert _close(got, want) and _close(got, split)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("index", [0, 320])
def test_chunk_kernel_on_card(index, kv):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(4, 640 - index, 28, 128, generator=g,
                    device=dev).bfloat16()
    kc = torch.randn(4, 640, 4, 128, generator=g, device=dev).to(kv)
    vc = torch.randn(4, 640, 4, 128, generator=g, device=dev).to(kv)
    got = cp.chunk_prefill_attention(q, kc, vc, index)
    want = cp.chunk_prefill_ref(q.float(), kc, vc, index)
    torch.cuda.synchronize()
    assert _close(got, want)


# (B, S, L, N, K, h, start, window) for the bf16 tensor-core body: every
# head dim, G = 1, 4 and 7, S and L off the 64-row tile and the 64-key
# block (600 rows over L = 640; 100 rows from 37 over L = 150), per-slot
# starts, a window of 64 that crosses tile and block edges
BF16_CHUNKS = [(4, 640, 640, 28, 4, 128, 0, 0),
               (2, 600, 640, 28, 4, 128, 0, 0),
               (2, 600, 640, 28, 4, 128, 0, 64),
               (2, 100, 150, 16, 4, 64, (37, 50), 0),
               (2, 100, 150, 16, 4, 64, (37, 50), 64),
               (3, 77, 200, 8, 8, 16, (0, 61, 123), 0),
               (3, 77, 200, 8, 8, 16, (0, 61, 123), 64),
               (1, 300, 300, 7, 1, 128, 0, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,L,N,K,h,start,window", BF16_CHUNKS)
def test_bf16_chunk_kernel_edges_on_card(B, S, L, N, K, h, start, window):
    """The tensor-core body (bf16 q over a bf16 view) against the plain
    version on the inputs taken to f32, at ragged tile and block edges."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(S + L)
    q = torch.randn(B, S, N, h, generator=g, device=dev).bfloat16()
    kc = torch.randn(B, L, K, h, generator=g, device=dev).bfloat16()
    vc = torch.randn(B, L, K, h, generator=g, device=dev).bfloat16()
    idx = (torch.tensor(start, dtype=torch.int32, device=dev)
           if isinstance(start, tuple) else start)
    got = cp.chunk_prefill_attention(q, kc, vc, idx, window=window)
    want = cp.chunk_prefill_ref(q.float(), kc, vc, idx, window)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and _close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("split", [1, 17, 320, 383])
def test_chunk_kernel_chunking_invariance_on_card(split, window):
    """Rows computed in one chunk from 0 and in a chunk at ``split`` are
    bit-equal: each row walks the same absolute key blocks, whatever
    query tile it sits in (splits on and off the 64-row tiles)."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(2, 640, 28, 128, generator=g, device=dev).bfloat16()
    kc = torch.randn(2, 640, 4, 128, generator=g, device=dev).bfloat16()
    vc = torch.randn(2, 640, 4, 128, generator=g, device=dev).bfloat16()
    whole = cp.chunk_prefill_attention(q, kc, vc, 0, window=window)
    head = cp.chunk_prefill_attention(q[:, :split].contiguous(), kc, vc, 0,
                                      window=window)
    part = cp.chunk_prefill_attention(q[:, split:].contiguous(), kc, vc,
                                      split, window=window)
    assert torch.equal(whole[:, :split], head)
    assert torch.equal(whole[:, split:], part)


@pytest.mark.gpu
def test_kernels_count_launches_on_card():
    dev = _cuda()
    q = torch.zeros(1, 4, 16, device=dev)
    kv = torch.zeros(1, 8, 2, 16, device=dev).bfloat16()
    pages = torch.zeros(2, 32, 2, 16, device=dev)
    table = torch.tensor([[1]], dtype=torch.int32, device=dev)
    counters = (da.decode_attention, cp.chunk_prefill_attention,
                pg.paged_decode_attention,
                pcp.paged_chunk_prefill_attention)
    before = [f.launches for f in counters]
    da.decode_attention(q, kv, kv, 3)
    cp.chunk_prefill_attention(q[:, None], kv, kv, 3)
    pg.paged_decode_attention(q, pages, pages, table, 3)
    pcp.paged_chunk_prefill_attention(q[:, None], pages, pages, table, 3)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(counters, before)] == [1] * 4


def _pool(dev, kv_dtype, gran, B=8, npg=27, num_pages=217, seed=2, K=4,
          h=128):
    """A shuffled, non-contiguous K and V page pool at the serving engine's
    shapes (B=8 slots, page 32; molmoact-7b's 4 KV heads of h=128 unless
    told) holding the rows of dense f32 caches [B, npg*32, K, h]. ``gran``
    is the scale granularity of an int8/fp8 pool, else the storage ("f32"
    or "bf16"). Returns (dense k, dense v, k pages, v pages, k scales, v
    scales, table)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.randperm(num_pages - 1, generator=g, device=dev)[:B * npg]
    table = (perm + 1).reshape(B, npg).to(torch.int32)
    qd = kv_quant.quant_dtype(kv_dtype)
    store = qd or (torch.float32 if gran == "f32" else torch.bfloat16)
    out = []
    for _ in range(2):
        dense = torch.randn(B, npg * 32, K, h, generator=g, device=dev)
        pages = torch.zeros(num_pages, 32, K, h, dtype=store, device=dev)
        rows = dense.reshape(B * npg, 32, K, h)
        scales = None
        if qd is not None:
            rows, sc = kv_quant.quantize_page_rows(rows, qd, gran)
            scales = torch.zeros((num_pages,) + sc.shape[1:], device=dev)
            scales[table.reshape(-1).long()] = sc
        pages[table.reshape(-1).long()] = rows.to(store)
        out.append((dense.to(store) if qd is None else dense, pages, scales))
    (dk, kp, ks), (dv, vp, vs) = out
    return dk, dv, kp, vp, ks, vs, table


MIXED = (0, 31, 32, 300, 639, 700, 831, 5)
EDGES = (0, 127, 128, 255, 256, 150, 280, 831)    # split edges, per slot


@pytest.mark.gpu
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("storage", [("bf16", "f32"), ("bf16", "bf16"),
                                     ("int8", "head"), ("int8", "token"),
                                     ("fp8", "head"), ("fp8", "token")])
@pytest.mark.parametrize("index,window", [
    (0, 0), (31, 0), (32, 0), (127, 0), (128, 0), (255, 0), (639, 0),
    (831, 0), ("mixed", 0), ("edges", 0), (150, 64), (280, 64), (736, 16),
    ("edges", 64)])
def test_paged_kernel_on_card(index, window, storage, heads):
    """Every storage type and scale mode against the plain version at the
    split edges and windows across them; the same bits on two calls."""
    dev = _cuda()
    N, K, h = heads
    _, _, kp, vp, ks, vs, table = _pool(dev, *storage, K=K, h=h)
    q = torch.randn(8, N, h, generator=torch.Generator(
        device=dev).manual_seed(4), device=dev).bfloat16()
    idx = (torch.tensor({"mixed": MIXED, "edges": EDGES}[index],
                        dtype=torch.int32, device=dev)
           if isinstance(index, str) else index)
    got = pg.paged_decode_attention(q, kp, vp, table, idx, k_scales=ks,
                                    v_scales=vs, window=window)
    again = pg.paged_decode_attention(q, kp, vp, table, idx, k_scales=ks,
                                      v_scales=vs, window=window)
    if ks is None:
        want = pg.paged_decode_attention_ref(q.float(), kp, vp, table, idx,
                                             window)
    else:
        want = pg.paged_decode_attention_quant_ref(q.float(), kp, vp, ks, vs,
                                                   table, idx, window)
    torch.cuda.synchronize()
    assert _close(got, want) and torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 64, 16])
@pytest.mark.parametrize("length", [864, 833])
@pytest.mark.parametrize("index", [MIXED, EDGES])
def test_paged_kernel_bit_equal_to_dense_on_card(store, window, length,
                                                 index, heads):
    """At page_size 32 a paged launch runs the dense kernel's split body on
    the same rows in the same order: the outputs are bit-equal, also
    against a dense cache of another length (833 rows against the pool's
    27 pages of 32)."""
    dev = _cuda()
    N, K, h = heads
    dk, dv, kp, vp, _, _, table = _pool(dev, "bf16", store, K=K, h=h)
    q = torch.randn(8, N, h, generator=torch.Generator(
        device=dev).manual_seed(6), device=dev).bfloat16()
    idx = torch.tensor(index, dtype=torch.int32, device=dev)
    a = pg.paged_decode_attention(q, kp, vp, table, idx, window=window)
    b = da.decode_attention(q, dk[:, :length], dv[:, :length], idx,
                            window=window)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_paged_kernel_rejects_other_page_sizes_on_card():
    dev = _cuda()
    q = torch.zeros(1, 4, 16, device=dev)
    pages = torch.zeros(3, 16, 2, 16, device=dev)
    table = torch.tensor([[1, 2]], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="page_size"):
        pg.paged_decode_attention(q, pages, pages, table, 3)


STORAGES = [("bf16", "f32"), ("bf16", "bf16"), ("int8", "head"),
            ("int8", "token"), ("fp8", "head"), ("fp8", "token")]
# (B, S, start): the serving engine's 128-row chunks of a 640-position
# prompt (first, one mid-way, the last) and two slots at mixed starts
CHUNKS = [(1, 128, 0), (1, 128, 480), (1, 128, 512), (2, 96, (0, 544))]


@pytest.mark.gpu
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_paged_chunk_kernel_on_card(chunk, window, storage):
    dev = _cuda()
    B, S, start = chunk
    _, _, kp, vp, ks, vs, table = _pool(dev, *storage, B=B, npg=20,
                                        num_pages=41)
    q = torch.randn(B, S, 28, 128, generator=torch.Generator(
        device=dev).manual_seed(8), device=dev).bfloat16()
    idx = (torch.tensor(start, dtype=torch.int32, device=dev)
           if isinstance(start, tuple) else start)
    got = pcp.paged_chunk_prefill_attention(q, kp, vp, table, idx,
                                            k_scales=ks, v_scales=vs,
                                            window=window)
    want = pcp.paged_chunk_prefill_ref(q.float(), kp, vp, table, idx, ks,
                                       vs, window)
    torch.cuda.synchronize()
    assert _close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("starts", [(512, 320), (497, 33)])
@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 64])
def test_paged_chunk_kernel_bit_equal_to_dense_on_card(store, window,
                                                       starts):
    """At page_size 32 a page is one key block of the f32 body and half a
    block of the bf16 tensor-core body: a paged launch and a dense launch
    over the same rows are bit-equal (starts on and off the blocks)."""
    dev = _cuda()
    dk, dv, kp, vp, _, _, table = _pool(dev, "bf16", store, B=2, npg=20,
                                        num_pages=41)
    q = torch.randn(2, 128, 28, 128, generator=torch.Generator(
        device=dev).manual_seed(9), device=dev).bfloat16()
    idx = torch.tensor(starts, dtype=torch.int32, device=dev)
    a = pcp.paged_chunk_prefill_attention(q, kp, vp, table, idx,
                                          window=window)
    b = cp.chunk_prefill_attention(q, dk, dv, idx, window=window)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("storage", [("bf16", "f32"), ("int8", "head"),
                                     ("fp8", "token")])
def test_paged_chunk_kernel_chunking_invariance_on_card(storage):
    """A 640-row prompt run as chunks of 32, 128 and 640 rows gives the
    same rows bit for bit."""
    dev = _cuda()
    _, _, kp, vp, ks, vs, table = _pool(dev, *storage, B=1, npg=20,
                                        num_pages=21)
    q = torch.randn(1, 640, 28, 128, generator=torch.Generator(
        device=dev).manual_seed(10), device=dev).bfloat16()
    outs = []
    for c in (32, 128, 640):
        outs.append(torch.cat([pcp.paged_chunk_prefill_attention(
            q[:, s:s + c].contiguous(), kp, vp, table, s, k_scales=ks,
            v_scales=vs) for s in range(0, 640, c)], dim=1))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])


@pytest.mark.gpu
def test_paged_chunk_kernel_rejects_other_page_sizes_on_card():
    dev = _cuda()
    q = torch.zeros(1, 4, 4, 16, device=dev)
    pages = torch.zeros(3, 16, 2, 16, device=dev)
    table = torch.tensor([[1, 2]], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="page_size"):
        pcp.paged_chunk_prefill_attention(q, pages, pages, table, 3)


def _close_f32(got, want):
    """The 3xTF32 chunk body's bound: as exact as f32 sums in another
    order, 1e-4 x max(1, |plain|)."""
    return bool(((got.float() - want.float()).abs()
                 <= 1e-4 * want.float().abs().clamp(min=1)).all())


# (B, S, L, N, K, h, start, window) for the 3xTF32 body (f32 q over an
# f32 view): every head dim, G = 1, 4 and 7, S and L off its 64-row tiles
# and 64-key blocks, per-slot starts, windows across a 64-key block edge
# (100, 64) and shorter than one (48, 16)
F32_CHUNKS = [(1, 640, 640, 28, 4, 128, 0, 0),
              (2, 600, 640, 28, 4, 128, 0, 100),
              (2, 600, 640, 28, 4, 128, 0, 48),
              (2, 100, 150, 16, 4, 64, (37, 50), 0),
              (2, 100, 150, 16, 4, 64, (37, 50), 64),
              (3, 77, 200, 8, 8, 16, (0, 61, 123), 0),
              (3, 77, 200, 8, 8, 16, (0, 61, 123), 16),
              (1, 300, 300, 7, 1, 128, 0, 48),
              (1, 65, 129, 28, 4, 128, 64, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,L,N,K,h,start,window", F32_CHUNKS)
def test_f32_chunk_kernel_edges_on_card(B, S, L, N, K, h, start, window):
    """The 3xTF32 body (f32 q over an f32 view) against the plain version
    within 1e-4 x max(1, |plain|) at ragged tile and block edges; the same
    bits on two calls."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(S + L + window)
    q = torch.randn(B, S, N, h, generator=g, device=dev)
    kc = torch.randn(B, L, K, h, generator=g, device=dev)
    vc = torch.randn(B, L, K, h, generator=g, device=dev)
    idx = (torch.tensor(start, dtype=torch.int32, device=dev)
           if isinstance(start, tuple) else start)
    got = cp.chunk_prefill_attention(q, kc, vc, idx, window=window)
    again = cp.chunk_prefill_attention(q, kc, vc, idx, window=window)
    want = cp.chunk_prefill_ref(q, kc, vc, idx, window)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and _close_f32(got, want)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("S,start", [(640, 0), (100, 37)])
def test_f32_q_over_bf16_view_on_card(S, start, window):
    """An f32 q over a bf16 view takes the 3xTF32 body too: the view is
    widened exactly, so the output holds the f32 bound."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(S + window)
    q = torch.randn(2, S, 28, 128, generator=g, device=dev)
    kc = torch.randn(2, 640, 4, 128, generator=g, device=dev).bfloat16()
    vc = torch.randn(2, 640, 4, 128, generator=g, device=dev).bfloat16()
    got = cp.chunk_prefill_attention(q, kc, vc, start, window=window)
    want = cp.chunk_prefill_ref(q, kc, vc, start, window)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and _close_f32(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("split", [1, 17, 100, 320, 383])
def test_f32_chunk_kernel_chunking_invariance_on_card(split, window):
    """The 3xTF32 body: rows computed in one chunk from 0 and in a chunk at
    ``split`` (on and off the 64-row tiles and 64-key blocks) are
    bit-equal."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(1, 640, 28, 128, generator=g, device=dev)
    kc = torch.randn(1, 640, 4, 128, generator=g, device=dev)
    vc = torch.randn(1, 640, 4, 128, generator=g, device=dev)
    whole = cp.chunk_prefill_attention(q, kc, vc, 0, window=window)
    head = cp.chunk_prefill_attention(q[:, :split].contiguous(), kc, vc, 0,
                                      window=window)
    part = cp.chunk_prefill_attention(q[:, split:].contiguous(), kc, vc,
                                      split, window=window)
    assert torch.equal(whole[:, :split], head)
    assert torch.equal(whole[:, split:], part)


@pytest.mark.gpu
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_paged_chunk_kernel_f32_q_on_card(chunk, window, storage):
    """f32 q over every page type and scale mode (the 3xTF32 body): codes
    are widened and scaled in f32 as the plain version dequantizes them,
    so every type holds the f32 bound."""
    dev = _cuda()
    B, S, start = chunk
    _, _, kp, vp, ks, vs, table = _pool(dev, *storage, B=B, npg=20,
                                        num_pages=41)
    q = torch.randn(B, S, 28, 128, generator=torch.Generator(
        device=dev).manual_seed(11), device=dev)
    idx = (torch.tensor(start, dtype=torch.int32, device=dev)
           if isinstance(start, tuple) else start)
    got = pcp.paged_chunk_prefill_attention(q, kp, vp, table, idx,
                                            k_scales=ks, v_scales=vs,
                                            window=window)
    want = pcp.paged_chunk_prefill_ref(q, kp, vp, table, idx, ks, vs,
                                       window)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and _close_f32(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("starts", [(512, 320), (497, 33)])
@pytest.mark.parametrize("window", [0, 64, 48])
def test_paged_chunk_f32_bit_equal_to_dense_on_card(window, starts):
    """f32 q over f32 pages and over the dense f32 view of the same rows:
    a page is half of the 3xTF32 body's key block, and the two launches
    are bit-equal."""
    dev = _cuda()
    dk, dv, kp, vp, _, _, table = _pool(dev, "bf16", "f32", B=2, npg=20,
                                        num_pages=41)
    q = torch.randn(2, 128, 28, 128, generator=torch.Generator(
        device=dev).manual_seed(12), device=dev)
    idx = torch.tensor(starts, dtype=torch.int32, device=dev)
    a = pcp.paged_chunk_prefill_attention(q, kp, vp, table, idx,
                                          window=window)
    b = cp.chunk_prefill_attention(q, dk, dv, idx, window=window)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def _experts(dev, dtype, E=40, C=2, D=1536, F=512, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)
    return (rnd(E, C, D), rnd(E, D, F, scale=D ** -0.5),
            rnd(E, D, F, scale=D ** -0.5), rnd(E, F, D, scale=F ** -0.5))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_plain"])
@pytest.mark.parametrize("C", [2, 7, 32, 160])
def test_gmm_kernels_on_card(C, act, dtype):
    dev = _cuda()
    x, wi, wg, wo = _experts(dev, dtype, C=C)
    h = gmm.gmm_gated(x, wi, wg, act=act)
    assert _close(h, gmm.gmm_gated_ref(x, wi, wg, act))
    y = gmm.gmm_down(h, wo)
    assert _close(y, gmm.gmm_down_ref(h, wo))
    assert _close(gmm.grouped_mlp(x, wi, wg, wo, act),
                  gmm.grouped_mlp_ref(x, wi, wg, wo, act))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("C,D,F", [(1, 1536, 512), (33, 1536, 512),
                                   (161, 1536, 512), (256, 1536, 512),
                                   (300, 1536, 512), (33, 1544, 520),
                                   (7, 200, 24)])
def test_gmm_down_bf16_edges_on_card(C, D, F):
    """The tensor-core gmm_down (bf16) against its plain version at
    capacities off its 8-row tiles, one pass of 256 rows and past it, and
    widths that are multiples of 8 but not of its 64-wide tiles; two calls
    give the same bits (one block sums each output, no atomics)."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(C + D + F)
    h = torch.randn(40, C, F, generator=g, device=dev).bfloat16()
    wo = (torch.randn(40, F, D, generator=g, device=dev)
          * F ** -0.5).bfloat16()
    y = gmm.gmm_down(h, wo)
    again = gmm.gmm_down(h, wo)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (40, C, D)
    assert _close(y, gmm.gmm_down_ref(h, wo))
    assert torch.equal(y, again)


# capacities of the bf16 tensor-core gmm_gated: on and off its passes of
# 32, 64, 128, 160 and 256 rows, and past one pass
GATED_CS = [1, 2, 7, 32, 33, 64, 65, 160, 161, 256, 257]


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_plain"])
@pytest.mark.parametrize("C", GATED_CS)
def test_gmm_gated_bf16_edges_on_card(C, act):
    """The tensor-core gmm_gated (bf16) against its plain version at every
    capacity edge, with D and F multiples of 8 but not of 64 (its 64-deep
    stages and 64- or 128-column tiles); two calls give the same bits."""
    dev = _cuda()
    x, wi, wg, _ = _experts(dev, torch.bfloat16, E=8, C=C, D=1544, F=520,
                            seed=C)
    h = gmm.gmm_gated(x, wi, wg, act=act)
    again = gmm.gmm_gated(x, wi, wg, act=act)
    torch.cuda.synchronize()
    assert h.dtype == torch.bfloat16 and tuple(h.shape) == (8, C, 520)
    assert _close(h, gmm.gmm_gated_ref(x, wi, wg, act))
    assert torch.equal(h, again)


@pytest.mark.gpu
def test_gmm_kernels_count_launches_on_card():
    dev = _cuda()
    x, wi, wg, wo = _experts(dev, torch.bfloat16, E=4, C=3, D=64, F=48)
    before = (gmm.gmm_gated.launches, gmm.gmm_down.launches)
    gmm.grouped_mlp(x, wi, wg, wo)
    gmm.gmm_down(gmm.gmm_gated(x, wi, wg, act="gelu"), wo)
    torch.cuda.synchronize()
    assert (gmm.gmm_gated.launches - before[0],
            gmm.gmm_down.launches - before[1]) == (2, 2)


@pytest.mark.gpu
def test_gmm_kernels_refuse_what_they_do_not_take_on_card():
    dev = _cuda()
    x, wi, wg, _ = _experts(dev, torch.bfloat16, E=2, C=3, D=64, F=20)
    with pytest.raises(ValueError, match="multiples of 8"):
        gmm.gmm_gated(x, wi, wg)
    x, wi, wg, _ = _experts(dev, torch.float16, E=2, C=3, D=64, F=48)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gmm.gmm_gated(x, wi, wg)


def _ssd_inputs(dev, dtype, B, S, H=48, P=64, N=128):
    """Seeded SSD operands at mamba2-780m's width by default: x, B, C in
    ``dtype``; dt = softplus(normal) and A_log in [0, 1.5) in f32."""
    g = torch.Generator(device=dev).manual_seed(S + B)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    dt = torch.nn.functional.softplus(rnd(B, S, H))
    A_log = 1.5 * torch.rand(H, generator=g, device=dev)
    return (rnd(B, S, H, P).to(dtype), dt, A_log,
            rnd(B, S, 1, N, scale=0.3).to(dtype),
            rnd(B, S, 1, N, scale=0.3).to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,dtype,width", [
    (1, 640, torch.bfloat16, "full"), (1, 128, torch.bfloat16, "full"),
    (1, 64, torch.bfloat16, "full"), (2, 256, torch.float32, "full"),
    (2, 40, torch.float32, "reduced")])
def test_ssd_kernel_on_card(B, S, dtype, width):
    """The served shapes (an admission prefill of 640 rows, one chunk,
    Q = S < 128), f32, and the reduced models' width (P = N = 16, a
    ragged chunk): y and the final state against the plain version."""
    dev = _cuda()
    shape = {} if width == "full" else dict(H=8, P=16, N=16)
    args = _ssd_inputs(dev, dtype, B, S, **shape)
    y, st = ssd_ops.ssd(*args)
    yp, sp = ssd_ops.ssd_chunked(*args)
    torch.cuda.synchronize()
    assert y.dtype == dtype and st.dtype == torch.float32
    assert _close(y, yp, 1e-2 if dtype == torch.bfloat16 else TF32X3)
    assert _close(st, sp, TF32X3)


@pytest.mark.gpu
def test_ssd_kernel_counts_launches_and_refuses_on_card():
    dev = _cuda()
    args = _ssd_inputs(dev, torch.bfloat16, 1, 256, H=4)
    before = ssd_ops.ssd.launches
    ssd_ops.ssd(*args)
    cut = [a[:, :160] if a.dim() > 1 else a for a in args]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_ops.ssd(*cut)
    with pytest.raises(ValueError, match="at most 128"):
        ssd_ops.ssd(*cut, Q=160)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd_ops.ssd(*[a.half() if a.dtype == torch.bfloat16 else a
                      for a in args])
    torch.cuda.synchronize()
    assert ssd_ops.ssd.launches - before == 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,width", [(2, 128 * c, "full")
                                       for c in range(1, 7)]
                         + [(2, 40, "reduced"), (1, 9, "reduced"),
                            (2, 384, "reduced"), (1, 256, "P=96"),
                            (1, 256, "P=30 N=20")])
def test_ssd_two_pass_kernel_on_card(B, S, width, dtype):
    """The two-pass scan at 1-6 chunks, ragged and reduced widths, P past
    one 64-row block and off the vector loads: y within 1e-2 (bf16) or
    1e-4 (f32, 3xTF32) x max(1, |plain|), the final state and the chunk
    states and seg the first pass leaves in the scratch (against
    ``ssd_chunk_states``) within 1e-4, the same bits on two calls."""
    dev = _cuda()
    shape = {"full": {}, "reduced": dict(H=8, P=16, N=16),
             "P=96": dict(H=4, P=96), "P=30 N=20": dict(H=4, P=30, N=20)}
    args = _ssd_inputs(dev, dtype, B, S, **shape[width])
    y, st, scratch = ssd_ops._launch(*args, 128)
    y2, st2, scratch2 = ssd_ops._launch(*args, 128)
    N = args[3].shape[-1]
    states, segs = ssd_ops.scratch_states(scratch, args[0], N)
    states2, segs2 = ssd_ops.scratch_states(scratch2, args[0], N)
    yp, sp = ssd_ops.ssd_chunked(*args)
    ps, pseg = ssd_ops.ssd_chunk_states(*args[:4])
    torch.cuda.synchronize()
    assert _close(y, yp, 1e-2 if dtype == torch.bfloat16 else TF32X3)
    assert _close(st, sp, TF32X3)
    assert _close(states, ps, TF32X3) and _close(segs, pseg, TF32X3)
    for a, b in ((y, y2), (st, st2), (states, states2), (segs, segs2)):
        assert torch.equal(a, b)


def _qkv(dev, B, S, N, K, h, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((B, S, N, h), (B, S, K, h), (B, S, K, h))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,N,K,h,window,causal",
                         [(2, 1024, 9, 3, 64, 0, True),
                          (1, 512, 28, 4, 128, 0, True),
                          (2, 256, 9, 3, 64, 96, True),
                          (1, 256, 9, 3, 64, 0, False),
                          (2, 100, 4, 2, 16, 0, True)])
def test_flash_kernel_on_card(B, S, N, K, h, window, causal, dtype):
    dev = _cuda()
    q, k, v = _qkv(dev, B, S, N, K, h, dtype)
    got = fa.flash_attention(q, k, v, window=window, causal=causal)
    want = fa.attention_ref(q.float(), k.float(), v.float(), window, causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert _close(got, want, TF32X3 if dtype == torch.float32 else 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Sk,N,K,h,window,causal", [
    (2, 512, 512, 9, 3, 64, 0, True), (1, 256, 256, 9, 3, 64, 96, False),
    (2, 256, 128, 9, 3, 64, 0, True), (2, 128, 256, 9, 3, 64, 0, False),
    (2, 100, 100, 4, 2, 16, 0, True), (1, 384, 384, 4, 2, 16, 64, True),
    (1, 256, 256, 28, 4, 128, 0, False)])
def test_flash_kernel_and_log_sum_exp_on_card(B, S, Sk, N, K, h, window,
                                              causal, dtype):
    """The tensor-core flash bodies, causal or not, with a window, Sk != S,
    h = 16 and 128: the output and the natural log-sum-exp [B,N,S]
    against the plain version on the inputs taken to f32 (the log-sum-exp
    also against torch.logsumexp of the masked scores), f32 within 1e-4
    (3xTF32), bf16 within 1e-2 (P rounded to bf16)."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(S + Sk + h)
    q = torch.randn(B, S, N, h, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(B, Sk, K, h, generator=g, device=dev).to(dtype)
            for _ in range(2))
    out, lse = fa._launch(q, k, v, window, causal)
    want, want_lse = fa._attention_lse(q.float(), k.float(), v.float(),
                                       window, causal)
    qpos = torch.arange(S, device=dev)[:, None]
    kpos = torch.arange(Sk, device=dev)[None]
    live = (kpos <= qpos) if causal else torch.ones_like(qpos - kpos,
                                                         dtype=torch.bool)
    if window:
        live = live & (qpos - kpos < window)
    kf = k.float().repeat_interleave(N // K, dim=2)
    s = torch.einsum("bsnh,btnh->bnst", q.float(), kf) / h ** 0.5
    ref = torch.logsumexp(s.masked_fill(~live, float("-inf")), dim=-1)
    torch.cuda.synchronize()
    tol = TF32X3 if dtype == torch.float32 else 1e-2
    assert out.dtype == dtype and lse.shape == (B, N, S)
    assert _close(out, want, tol)
    assert _close(lse, want_lse, tol) and _close(lse, ref, tol)


@pytest.mark.gpu
def test_flash_backward_and_launch_count_on_card():
    """The backward from the kernel's log-sum-exp against autograd through
    the plain version; the forward launches the kernel once, the backward
    never."""
    dev = _cuda()
    q, k, v = (t.requires_grad_() for t in _qkv(dev, 2, 256, 9, 3, 64,
                                                torch.float32))
    dout = torch.randn(q.shape, device=dev)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v)
    assert fa.flash_attention.launches == before + 1
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert fa.flash_attention.launches == before + 1
    want = torch.autograd.grad(fa.attention_ref(q, k, v), (q, k, v), dout)
    for a, b in zip(got, want):
        assert bool(((a - b).abs() <= 1e-4 * b.abs().clamp(min=1)).all())


@pytest.mark.gpu
def test_flash_refusals_on_card():
    dev = _cuda()
    q, k, v = _qkv(dev, 1, 320, 9, 3, 64, torch.float32)
    with pytest.raises(ValueError, match="multiple of 128"):
        fa.flash_attention(q, k, v)
    q, k, v = _qkv(dev, 1, 128, 4, 2, 32, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, k, v)
    q, k, v = _qkv(dev, 1, 128, 4, 2, 64, torch.float32)
    with pytest.raises(TypeError, match="one type"):
        fa.flash_attention(q, k.bfloat16(), v)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "mamba2-780m"])
def test_moe_and_mamba_train_steps_on_card(name):
    """Reduced granite-moe and mamba2 (f32, B=4 x 128 tokens, remat on):
    the loss within 1e-5 relative and every gradient within 1e-5 x max|g|
    of the CPU's (the card's forward runs gmm_gated / gmm_down, or ssd,
    twice, the backward runs gmm_down's kernel for its products), and one
    train step's parameters within 1e-4 x lr (plus two f32 ulps) where
    |g| > 1e-2 x max|g| of the leaf, within 2 x lr elsewhere."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves, map_tree
    from repro_torch.training import (AdamWConfig, TrainConfig,
                                      init_train_state, lm_loss,
                                      make_train_step)
    _cuda()
    cfg = get_config(name).reduced()
    p_cpu = M.init_params(cfg, torch.Generator().manual_seed(0),
                          torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 128),
                                     generator=gen)}
    opts, lr = M.ModelOptions(), 1e-3
    grads = {}
    threads = torch.get_num_threads()
    for dev in ("cuda", "cpu"):
        live = map_tree(lambda t: t.detach().to(dev).requires_grad_(True),
                        p_cpu)
        # the CPU's sums in one order: on one thread
        torch.set_num_threads(1 if dev == "cpu" else threads)
        try:
            loss = lm_loss(cfg, opts, live, batch, 1e-4, device=dev)
            grads[dev] = (float(loss.detach()), [g.cpu() for g in
                          torch.autograd.grad(loss, [t for _, t in
                                                     leaves(live)])])
        finally:
            torch.set_num_threads(threads)
    (lg, gg), (lc, gc) = grads["cuda"], grads["cpu"]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for a, b in zip(gg, gc):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    tcfg = TrainConfig(opt=AdamWConfig(lr=lr, warmup_steps=0))
    new = {}
    for dev in ("cuda", "cpu"):
        p = map_tree(lambda t: t.to(dev), p_cpu)
        step = make_train_step(cfg, opts, tcfg, device=dev)
        new[dev] = step(p, init_train_state(cfg, tcfg, p), batch)[0]
    for ((_, a), (_, b)), g in zip(zip(leaves(new["cuda"]),
                                       leaves(new["cpu"])), gc):
        d = (a.cpu() - b).abs() - 2 * torch.finfo(torch.float32).eps \
            * b.abs()
        sure = g.abs() > 1e-2 * g.abs().max()
        assert float(d[sure].max()) <= 1e-4 * lr if sure.any() else True
        assert float(d.max()) <= 2 * lr


# ---------------------------------------------------------------------------
# decode as replayed CUDA graphs (models.graphs.StepGraph)
# ---------------------------------------------------------------------------

def _small_model(name="smollm-135m", seed=0, dtype=torch.bfloat16):
    """A reduced config with seeded weights (bf16 by default) on the
    card."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config(name).reduced()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return cfg, M.init_params(cfg, gen, dtype, device="cuda")


def _prefilled(cfg, params, B=4, S=40, max_seq=96, seed=1):
    from repro_torch.models import model as M
    from repro_torch.models.layers import ModelOptions
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    logits, caches = M.prefill(cfg, ModelOptions(), params,
                               {"tokens": tokens}, max_seq, device="cuda")
    return logits[:, -1].argmax(-1, keepdim=True), caches, S


def _clone_tree(tree):
    from repro_torch.models.params import leaves, set_leaf
    out = {}
    for p, t in leaves(tree):
        set_leaf(out, p, t.clone())
    return out


def _same_tree(a, b):
    from repro_torch.models.params import leaves
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(leaves(a),
                                                           leaves(b)))


@pytest.mark.gpu
def test_replayed_decode_equals_eager_decode_on_card():
    """``decode_loop`` replayed from its graph against the same step run
    eagerly: tokens and every cache leaf bit for bit, and the decode
    kernel's count includes the replays (one launch a layer a step)."""
    from repro_torch.models import model as M
    from repro_torch.models.layers import ModelOptions
    _cuda()
    cfg, params = _small_model()
    tok, caches, S = _prefilled(cfg, params)
    twin = _clone_tree(caches)
    before = da.decode_attention.launches
    graph = M.DecodeGraph("cuda")
    got, last, _ = M.decode_loop(cfg, ModelOptions(), params, tok, caches,
                                 S, 12, device="cuda", graph=graph)
    torch.cuda.synchronize()
    assert da.decode_attention.launches - before == cfg.num_layers * 12
    assert graph.runner.captures == 1
    want, last_e, _ = M.decode_loop(cfg, ModelOptions(), params, tok, twin,
                                    S, 12, device="cuda",
                                    graph=M.DecodeGraph("cuda", eager=True))
    assert torch.equal(got, want) and torch.equal(last, last_e)
    assert _same_tree(caches, twin)


@pytest.mark.gpu
def test_decode_graph_recaptures_for_other_caches_on_card():
    """A DecodeGraph replays for the caches it was captured on (the same
    addresses) and captures again for caches that lie elsewhere, or for a
    longer loop; each result equals the eager step's."""
    from repro_torch.models import model as M
    from repro_torch.models.layers import ModelOptions
    _cuda()
    cfg, params = _small_model()
    opts = ModelOptions()
    tok, caches, S = _prefilled(cfg, params)
    other = _clone_tree(caches)
    graph = M.DecodeGraph("cuda")
    runs = [(caches, S, 6), (caches, S + 6, 6), (other, S, 6),
            (other, S + 6, 9)]
    for n_capt, (c, start, n) in zip((1, 1, 2, 3), runs):
        twin = _clone_tree(c)
        got, _, _ = M.decode_loop(cfg, opts, params, tok, c, start, n,
                                  device="cuda", graph=graph)
        want, _, _ = M.decode_loop(cfg, opts, params, tok, twin, start, n,
                                   device="cuda",
                                   graph=M.DecodeGraph("cuda", eager=True))
        assert graph.runner.captures == n_capt
        assert torch.equal(got, want) and _same_tree(c, twin)


def _host_guarded(monkeypatch):
    """Eager runners that skip a guarded body whose guard reads false on
    the host: what a guarded graph's IF node does on the device, run
    eagerly (the oracle of the guarded graph's caches, which a masked
    step run in full writes at rows nobody reads)."""
    from repro_torch.models.graphs import StepGraph
    step = StepGraph.step

    def guarded(self, key=None):
        if self.eager and self.guard is not None \
                and not bool(self.guard()):
            return
        step(self, key)
    monkeypatch.setattr(StepGraph, "step", guarded)


def _engine_run(name: str, graphs: bool, dtype=torch.bfloat16,
                capture: bool = False, **kw):
    """Five requests through a small engine on the card; ``capture`` calls
    ``ServingEngine.capture`` first (a no-op eagerly), so that every step
    a graphed tick replays is counted by its runner's ``replays_ran``."""
    from repro_torch.models.layers import ModelOptions
    from repro_torch.serving import Request, ServingEngine
    cfg, params = _small_model(name, dtype=dtype)
    eng = ServingEngine(cfg, ModelOptions(), params, n_slots=3, max_seq=128,
                        eos=-999, tick_tokens=4, device="cuda",
                        graphs=graphs, **kw)
    if capture:
        eng.capture()
    gen = torch.Generator().manual_seed(5)
    for i, (n, m) in enumerate([(40, 30), (70, 9), (20, 41), (33, 12),
                                (64, 20)]):
        eng.submit(Request(uid=i, prompt=torch.randint(
            0, cfg.vocab_size, (n,), generator=gen).numpy(), max_tokens=m))
    done = eng.run()
    torch.cuda.synchronize()
    return eng, {r.uid: r.out_tokens for r in done}


@pytest.mark.gpu
@pytest.mark.parametrize("name,kw", [
    ("smollm-135m", {}), ("smollm-135m", dict(paged=True)),
    ("smollm-135m", dict(paged=True, kv_dtype="int8")),
    ("smollm-135m", dict(paged=True, chunked_prefill=True, chunk_size=32,
                         token_budget=40)),
    ("granite-moe-3b-a800m", dict(paged=True)), ("mamba2-780m", {})],
    ids=["dense", "paged", "paged-int8", "paged-chunked", "moe-paged",
         "ssm-dense"])
def test_graphed_engine_equals_eager_engine_on_card(name, kw, monkeypatch):
    """The engine, captured first, with its tick step replayed from one
    guarded graph (and its chunks from chunk graphs) against the same
    steps run eagerly: streams and counters equal, while slots grow into
    new pages between replays (the page table is copied into the graph's
    buffer each tick) and, chunked, the planner changes the tick's depth
    from tick to tick; the MoE dispatch and the Mamba2 states inside the
    graph. The caches equal bit for bit those of an eager engine that
    skips the steps whose guard is false, as the graph's IF node does.
    The graphed engine captures its tick once; the replays that ran its
    body are the device steps the tick counted; and its decode kernel
    launches are the eager engine's less those of the eager masked steps
    plus those of the capture's warm-up step."""
    _cuda()
    decode = pg.paged_decode_attention if kw.get("paged") \
        else da.decode_attention
    d0 = decode.launches
    eng, out = _engine_run(name, True, capture=True, **kw)
    d1 = decode.launches
    ref, want = _engine_run(name, False, capture=True, **kw)
    e1 = decode.launches
    assert out == want and len(out) == 5
    for f in ("ticks", "device_steps", "pages_hwm", "prefill_tokens",
              "decode_syncs"):
        assert getattr(eng.stats, f) == getattr(ref.stats, f), f
    g = eng._tick.graph
    assert g.captures == 1
    assert eng.masked_steps == ref.masked_steps + g.captures
    assert g.replays_ran == eng.stats.device_steps
    n_attn = sum(eng.cfg.is_attn_layer(i)
                 for i in range(eng.cfg.num_layers))
    assert d1 - d0 == (e1 - d1) - n_attn * ref.masked_steps \
        + n_attn * g.captures
    _host_guarded(monkeypatch)
    skipped, got = _engine_run(name, False, **kw)
    assert got == want
    assert _same_tree(eng.caches, skipped.caches)


@pytest.mark.gpu
def test_failed_capture_raises_on_card():
    """A body that syncs with the host raises, in the warm-up step (under
    the sync debug mode) or in the capture; the runner keeps no graph and
    never falls back to running the body eagerly."""
    from repro_torch.models.graphs import StepGraph
    dev = _cuda()
    x = torch.zeros(4, device=dev)
    calls = []

    def syncs_under_capture():
        calls.append(1)
        x.add_(1)
        if len(calls) > 1:
            x.sum().item()
    for body in (lambda: x.sum().item(), syncs_under_capture):
        runner = StepGraph(body, dev)
        with pytest.raises(RuntimeError):
            runner.step("key")
        assert runner.graph is None
    torch.cuda.synchronize()
    assert float(x.sum()) == 4.0     # the second body's warm-up step ran


@pytest.mark.gpu
def test_step_graph_keeps_several_keys_and_evicts_lru_on_card():
    """A runner keeps a graph a key up to ``max_graphs`` and replays each
    on its own buffers; past that it evicts the least recently used key,
    which captures again when it comes back. Sealed, it replays the keys
    it holds and raises on another instead of capturing it."""
    from repro_torch.models.graphs import StepGraph
    dev = _cuda()
    bufs = {k: torch.zeros(4, device=dev) for k in "abc"}
    cur = ["a"]
    runner = StepGraph(lambda: bufs[cur[0]].add_(1), dev, max_graphs=2)
    for k, n_capt in (("a", 1), ("b", 2), ("a", 2), ("c", 3), ("a", 3),
                      ("b", 4)):
        cur[0] = k
        runner.step(k)
        assert runner.captures == n_capt, k
    torch.cuda.synchronize()
    assert list(runner.graphs) == ["a", "b"]
    assert [float(bufs[k][0]) for k in "abc"] == [3.0, 2.0, 1.0]
    runner.sealed = True
    runner.step("a")
    cur[0] = "c"
    with pytest.raises(RuntimeError, match="sealed"):
        runner.step("c")
    torch.cuda.synchronize()
    assert runner.captures == 4 and list(runner.graphs) == ["b", "a"]
    assert [float(bufs[k][0]) for k in "abc"] == [4.0, 2.0, 1.0]


@pytest.mark.gpu
def test_guarded_graph_counts_only_the_replays_that_ran_on_card():
    """A guarded step (a cuBLAS GEMM and the decode kernel in its body)
    replayed with its guard true runs as the eager body does; with it
    false it runs nothing of the body; its ``ran`` counter and ``settle``
    add the decode kernel's launches for the replays that ran only."""
    from repro_torch.models.graphs import StepGraph
    dev = _cuda()
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(8, 512, device=dev, generator=gen)
    w = torch.randn(512, 256, device=dev, generator=gen)
    q = torch.randn(8, 14, 64, device=dev, generator=gen)
    kc = torch.randn(8, 96, 2, 64, device=dev, generator=gen)
    vc = torch.randn(8, 96, 2, 64, device=dev, generator=gen)
    idx = torch.full((8,), 90, dtype=torch.int32, device=dev)
    out = torch.zeros(8, 256, device=dev)
    att = torch.zeros(8, 14, 64, device=dev)
    flag = torch.ones((), dtype=torch.bool, device=dev)

    def body():
        out.add_(x @ w)
        att.copy_(da.decode_attention(q, kc, vc, idx))
    runner = StepGraph(body, dev, guard=lambda: flag.clone())
    runner.step("k")                                  # warm-up + capture
    want_o, want_a = out.clone(), att.clone()         # one eager body
    before = da.decode_attention.launches
    for on in (True, False, True, False, False):
        flag.fill_(on)
        runner.step("k")
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before     # not yet settled
    ran = int(runner.ran)
    runner.settle(ran)
    assert ran == 2 and runner.replays_ran == 2
    assert da.decode_attention.launches - before == 2
    assert torch.allclose(out, 3 * want_o) and torch.equal(att, want_a)
    assert int(runner.ran) == 0


@pytest.mark.gpu
def test_control_steps_through_kept_graphs_capture_once_on_card():
    """Three control steps of reduced molmoact-7b through one kept
    PrefillGraph (vision + prefill as one graph) and one kept DecodeGraph
    capture each once; tokens and prefill logits equal the eager graphs'
    bit for bit."""
    from repro_torch.core import vla
    from repro_torch.models import model as M
    from repro_torch.models.layers import ModelOptions
    dev = _cuda()
    cfg, params = _small_model("molmoact-7b", dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(12)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (3, 6),
                                     generator=gen, device="cuda"),
             "patches": torch.randn((3, cfg.vision.num_tokens,
                                     cfg.vision.embed_dim), generator=gen,
                                    device="cuda")}
    pre, dec = M.PrefillGraph(dev), M.DecodeGraph(dev)
    ref = vla.vla_control_step(cfg, ModelOptions(), params, batch,
                               device="cuda",
                               graph=M.DecodeGraph(dev, eager=True),
                               prefill_graph=M.PrefillGraph(dev, eager=True))
    for _ in range(3):
        out = vla.vla_control_step(cfg, ModelOptions(), params, batch,
                                   device="cuda", graph=dec,
                                   prefill_graph=pre)
        assert torch.equal(out.cot_tokens, ref.cot_tokens)
        assert torch.equal(out.action_tokens, ref.action_tokens)
    assert (pre.runner.captures, dec.runner.captures) == (1, 1)
    lg, _ = pre.run(cfg, ModelOptions(), params, batch, 64)
    le, _ = M.prefill(cfg, ModelOptions(), params, batch, 64, device="cuda")
    assert torch.equal(lg, le)


# ---------------------------------------------------------------------------
# self-speculative decode on the card (serving.engine.SpecTick)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kw", [
    {}, dict(paged=True),
    dict(paged=True, kv_dtype="int8", scale_granularity="token"),
    dict(paged=True, chunked_prefill=True, chunk_size=32, token_budget=40)],
    ids=["dense", "paged", "paged-int8-token", "paged-chunked"])
def test_graphed_spec_engine_equals_eager_and_fused_on_card(kw):
    """The speculative engine with one guarded round replayed from its
    graph against the same round run eagerly: streams, counters (the
    accept histogram, steps) and caches bit for bit; graphed, a decode
    stage replays its cap of rounds and reads back once, the eager engine
    at least as often; it captures once and its streams
    equal the plain fused engine's on the card (f32 weights, so that the
    verify chunk's and the decode step's GEMMs round alike; the full-depth
    int8 draft); a round whose body ran launches the decode kernel once a
    draft layer a draft step and the verify chunk's kernel once a
    layer; captured first, the replays that ran a round are the rounds the
    tick counted, and its decode launches are the eager engine's less
    those of the eager masked rounds plus those of the capture's warm-up
    round."""
    _cuda()
    spec = dict(kw, spec_decode=True, spec_k=4, draft_layers=4,
                draft_quant="int8")
    decode = pg.paged_decode_attention if kw.get("paged") \
        else da.decode_attention
    verify = pcp.paged_chunk_prefill_attention if kw.get("paged") \
        else cp.chunk_prefill_attention
    d0, v0 = decode.launches, verify.launches
    f32 = dict(dtype=torch.float32)
    eng, out = _engine_run("smollm-135m", True, capture=True, **f32, **spec)
    d1, v1 = decode.launches, verify.launches
    ref, want = _engine_run("smollm-135m", False, capture=True, **f32,
                            **spec)
    e1 = decode.launches
    fused, plain = _engine_run("smollm-135m", True, **f32, **kw)
    assert out == want == plain and len(out) == 5
    for f in ("ticks", "device_steps", "spec_accept_hist",
              "spec_verify_passes", "pages_hwm"):
        assert getattr(eng.stats, f) == getattr(ref.stats, f), f
    # one readback a decode stage (a chunked tick may run chunks alone)
    assert eng.stats.decode_syncs == len(eng.stats.decode_tick_s) \
        <= ref.stats.decode_syncs
    g = eng._tick.graph
    assert g.captures == 1
    assert _same_tree(eng.caches, ref.caches)
    assert g.replays_ran == eng.stats.device_steps
    rounds = g.captures + eng.stats.device_steps
    assert d1 - d0 == rounds * 3 * 4 \
        == (e1 - d1) - 3 * 4 * ref.masked_steps + 3 * 4 * g.captures
    if kw.get("paged"):       # the admission prefill runs the dense kernel
        assert v1 - v0 >= rounds * 4
    assert eng.stats.pages_in_use == 0


@pytest.mark.gpu
def test_verify_chunk_band_and_whole_view_same_bits_on_card():
    """``verify_chunk`` over the whole view (as the graphed tick runs it)
    and over the live band: the same logits and caches bit for bit, dense
    and paged, from per-slot starts with rows past the cache."""
    from repro_torch.models import model as M
    from repro_torch.models.layers import ModelOptions
    from repro_torch.models.params import leaves
    _cuda()
    cfg, params = _small_model()
    gen = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (3, 4), generator=gen,
                         device="cuda")
    for paged in (False, True):
        kw = dict(paged=True, num_pages=13, page_size=32) if paged else {}
        caches = M.init_caches(cfg, 3, 128, torch.float32, device="cuda",
                               **kw)
        for _, t in leaves(caches):
            t.normal_(generator=gen)
        table = (torch.arange(1, 13, dtype=torch.int32, device="cuda")
                 .reshape(3, 4) if paged else None)
        for start, nv, live in (([3, 40, 61], [4, 4, 4], 96),
                                ([3, 126, 61], [4, 2, 0], 128)):
            res = []
            for bound in (None, live):
                c = _clone_tree(caches)
                lg, _ = M.verify_chunk(
                    cfg, ModelOptions(), params, toks, c,
                    torch.tensor(start, dtype=torch.int32, device="cuda"),
                    n_valid=torch.tensor(nv, dtype=torch.int32,
                                         device="cuda"),
                    page_table=table, live_len=bound, device="cuda")
                res.append((lg, c))
            assert torch.equal(res[0][0], res[1][0])
            assert _same_tree(res[0][1], res[1][1])


# ---------------------------------------------------------------------------
# the DiT action head (model.DiTGraph) and replicas on threads
# ---------------------------------------------------------------------------

def _dit_model(dtype=torch.float32):
    """Reduced molmoact-7b-dit (10 denoising steps, horizon 8) with seeded
    weights on the card; the head's zero-initialised leaves (``ada``,
    ``final_ada``, ``out_proj``) set to normal x 0.02, so that the head
    changes its noise."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves
    cfg = get_config("molmoact-7b-dit").reduced()
    cfg = dataclasses.replace(cfg, n_cot_tokens=5, action=dataclasses.replace(
        cfg.action, dit_steps=10, horizon=8))
    gen = torch.Generator(device="cuda").manual_seed(4)
    params = M.init_params(cfg, gen, dtype, device="cuda")
    for path, t in leaves(params["action_dit"]):
        if path.split("/")[-1] in ("ada", "final_ada", "out_proj"):
            t.normal_(generator=gen).mul_(0.02)
    return cfg, params


@pytest.mark.gpu
def test_dit_graph_equals_eager_on_card():
    """Two control steps of reduced molmoact-7b-dit through one DiTGraph
    (and one DecodeGraph): the DiT loop captures once and replays on the
    same buffers for the second step, and each trajectory equals the same
    loop run eagerly bit for bit; the head moves the noise."""
    from repro_torch.core import vla
    from repro_torch.models import model as M
    from repro_torch.models.layers import ModelOptions
    _cuda()
    cfg, params = _dit_model()
    a = cfg.action
    gen = torch.Generator(device="cuda").manual_seed(6)
    graph, dit = M.DecodeGraph("cuda"), M.DiTGraph("cuda")
    eager = M.DiTGraph("cuda", eager=True)
    for step in range(2):
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (3, 6),
                                         generator=gen, device="cuda"),
                 "patches": torch.randn((3, cfg.vision.num_tokens,
                                         cfg.vision.embed_dim),
                                        generator=gen, device="cuda")}
        noise = torch.randn((3, a.horizon, a.action_dim), generator=gen,
                            device="cuda")
        out = vla.vla_control_step(cfg, ModelOptions(), params, batch,
                                   device="cuda", graph=graph, dit_graph=dit,
                                   noise=noise)
        ref = vla.vla_control_step(cfg, ModelOptions(), params, batch,
                                   device="cuda", dit_graph=eager,
                                   noise=noise)
        torch.cuda.synchronize()
        assert torch.equal(out.cot_tokens, ref.cot_tokens)
        assert torch.equal(out.trajectory, ref.trajectory)
        assert float((out.trajectory - noise).abs().max()) > 0.05
        assert dit.runner.captures == 1 and dit.runner.replays == step
        assert out.phase_tokens["action"] == a.dit_steps


@pytest.mark.gpu
def test_engines_ticked_from_two_threads_equal_serial_on_card():
    """Two engines behind the front end with offloaded ticks: the front
    end's start captures both tick graphs and chunk graphs, one after the
    other, and the replicas then tick side by side on two threads with
    nothing raised; each captures once and records only its own step's
    launches; their streams and the kernels' launch counts equal the same
    requests ticked serially, one engine after the other, each captured
    first as the front end does, and follow from the engines' counters
    (tick steps whose body ran, chunk runs and masked capture chunks);
    the eager oracle beside gives the same streams."""
    import asyncio
    from repro_torch.kernels.chunk_prefill.paged import (
        paged_chunk_prefill_attention as chunk)
    from repro_torch.models.layers import ModelOptions
    from repro_torch.serving import AsyncFrontend, Request, ServingEngine
    _cuda()
    cfg, params = _small_model(dtype=torch.float32)
    kw = dict(n_slots=3, max_seq=128, eos=-999, tick_tokens=4, paged=True,
              chunked_prefill=True, chunk_size=32, token_budget=64,
              device="cuda")
    gen = torch.Generator().manual_seed(8)
    reqs = [(torch.randint(0, cfg.vocab_size, (n,), generator=gen).numpy(),
             m) for n, m in [(40, 12), (70, 9), (20, 14), (33, 10)]]
    decode = pg.paged_decode_attention

    def counted(engines):
        """The launches the engines' counters imply: the decode kernel once
        a layer a tick step whose body ran (eagerly every step, masked ones
        too; graphed, the capture's warm-up and the device steps, which
        are the replays that ran), the chunk kernel once a layer a chunk
        run or masked capture chunk."""
        L = cfg.num_layers
        for e in engines:
            g = e._tick.graph
            assert g.eager or g.replays_ran == e.stats.device_steps
        bodies = sum((e.stats.device_steps + e.masked_steps)
                     if e._tick.graph.eager else
                     e._tick.graph.captures + e.stats.device_steps
                     for e in engines)
        runs = sum(e.stats.prefill_key_lanes_full // (32 * 128)
                   + e.masked_chunks for e in engines)
        return L * bodies, L * runs

    def serial(graphs):
        out, counts, engines = [], (decode.launches, chunk.launches), []
        for half in (reqs[0::2], reqs[1::2]):
            eng = ServingEngine(cfg, ModelOptions(), params, graphs=graphs,
                                **kw)
            eng.capture()
            for i, (p, m) in enumerate(half):
                eng.submit(Request(uid=i, prompt=p, max_tokens=m))
            out.append({r.uid: r.out_tokens for r in eng.run()})
            engines.append(eng)
        torch.cuda.synchronize()
        n = (decode.launches - counts[0], chunk.launches - counts[1])
        assert n == counted(engines)
        return out, n, engines

    async def threaded():
        engines = [ServingEngine(cfg, ModelOptions(), params, **kw)
                   for _ in range(2)]
        async with AsyncFrontend(engines, offload_ticks=True) as fe:
            assert [(e._tick.graph.captures, e._chunk.runner.captures)
                    for e in engines] == [(1, 1), (1, 1)]
            streams = [await fe.submit(p, m) for p, m in reqs]
            outs = [await s.tokens() for s in streams]
            await fe.drain()
        return engines, streams, outs

    want, want_n, graphed = serial(graphs=True)
    eager, eager_n, oracle = serial(graphs=False)
    assert want == eager
    L = cfg.num_layers
    assert want_n[0] == eager_n[0] - L * sum(e.masked_steps for e in oracle) \
        + L * sum(e._tick.graph.captures for e in graphed)
    assert want_n[1] == eager_n[1] + L * sum(e.masked_chunks for e in graphed)
    counts = (decode.launches, chunk.launches)
    engines, streams, outs = asyncio.run(threaded())
    torch.cuda.synchronize()
    got_n = (decode.launches - counts[0], chunk.launches - counts[1])
    assert [s.replica for s in streams] == [0, 1, 0, 1]
    assert outs == [want[i % 2][i // 2] for i in range(4)]
    assert got_n == want_n == counted(engines)
    for eng in engines:
        assert eng._tick.graph.captures == 1
        assert eng._tick.graph.recorded == {decode: cfg.num_layers}


# ---------------------------------------------------------------------------
# ring caches (gemma3-27b's local layers) and cross attention (whisper)
# ---------------------------------------------------------------------------

# (B, W, N, K, h): gemma3-27b's heads (G = 2 at h = 128) over its window
# of 1024 as a ring (the kernel's S == W), and the reduced form's ring of 32
RINGS = [(8, 1024, 32, 16, 128), (3, 32, 4, 2, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("kv", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", RINGS)
def test_ring_decode_on_card(shape, kv):
    """The ``decode_ring`` route (the split-key kernel at min(index, W - 1)
    without a window) against ``attention_decode_ring`` before, at and
    after the wrap, per slot."""
    from repro_torch.models import layers as L
    dev = _cuda()
    B, W, N, K, h = shape
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(B, 1, N, h, generator=g, device=dev).bfloat16()
    kc = torch.randn(B, W, K, h, generator=g, device=dev).to(kv)
    vc = torch.randn(B, W, K, h, generator=g, device=dev).to(kv)
    for index in ((0, 5, W - 1, W, W + 1, 2 * W - 1, 3 * W, 7 * W + 3),
                  (W - 1,), (4 * W,)):
        idx = _slots(index, B, dev)
        got = L.run_attention_core("decode_ring", q, kc, vc,
                                   opts=L.ModelOptions(), window=W,
                                   index=idx)
        want = L.attention_decode_ring(q.float(), kc.float(), vc.float(),
                                       idx)
        torch.cuda.synchronize()
        assert _close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,heads", [(1500, (12, 12, 64)),
                                     (24, (2, 2, 16))])
def test_cross_decode_on_card(T, heads, kv):
    """The ``decode_cross`` route against the reference's non-causal dense
    core: a context of 1500 rows (whisper's; not a multiple of the
    kernel's 128-key split) and the reduced form's 24."""
    from repro_torch.models import layers as L
    dev = _cuda()
    N, K, h = heads
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(4, 1, N, h, generator=g, device=dev).to(kv)
    xk = torch.randn(4, T, K, h, generator=g, device=dev).to(kv)
    xv = torch.randn(4, T, K, h, generator=g, device=dev).to(kv)
    got = L.run_attention_core("decode_cross", q, xk, xv,
                               opts=L.ModelOptions(), window=0,
                               causal=False)
    want = L.attention_dense(q.float(), xk.float(), xv.float(),
                             torch.arange(1, device=dev),
                             torch.arange(T, device=dev), 0, causal=False)
    torch.cuda.synchronize()
    assert _close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_window_of_the_whole_sequence_on_card(dtype):
    """gemma3-27b's ring prefill: S = W = 1024, its heads, causal with the
    window 1024 (which then cuts nothing), against the plain version."""
    from repro_torch.models import layers as L
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(1, 1024, 32, 128, generator=g, device=dev).to(dtype)
    k = torch.randn(1, 1024, 16, 128, generator=g, device=dev).to(dtype)
    v = torch.randn(1, 1024, 16, 128, generator=g, device=dev).to(dtype)
    got = fa.flash_attention(q, k, v, window=1024, causal=True)
    pos = torch.arange(1024, device=dev)
    want = L.attention_dense(q.float(), k.float(), v.float(), pos, pos, 1024)
    torch.cuda.synchronize()
    assert _close(got, want, 1e-2 if dtype == torch.bfloat16 else TF32X3)


def _arch_model(name, layers=None):
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config(name).reduced()
    if layers:
        import dataclasses
        cfg = dataclasses.replace(cfg, num_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(4)
    return cfg, M.init_params(cfg, gen, torch.bfloat16, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["gemma3-27b", "whisper-small"])
def test_replayed_ring_and_cross_decode_equals_eager_on_card(name):
    """``decode_loop`` replayed from its graph, across a ring's wrap
    (reduced gemma3-27b in 6 layers, window_cache) and over cached cross
    K/V (reduced whisper-small), against the same step run eagerly:
    tokens and every cache leaf bit for bit; the decode kernel launched
    once a self-attention layer a step (and once more a cross-attention
    layer)."""
    from repro_torch.models import model as M
    from repro_torch.models.layers import ModelOptions
    _cuda()
    cfg, params = _arch_model(name, 6 if name == "gemma3-27b" else None)
    opts = ModelOptions(window_cache=name == "gemma3-27b")
    gen = torch.Generator(device="cuda").manual_seed(5)
    B, S, n = 3, 20, 30
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, device="cuda")}
    if cfg.encoder is not None:
        batch["frames"] = torch.randn(
            B, cfg.encoder.num_tokens, cfg.encoder.embed_dim, generator=gen,
            device="cuda").bfloat16()
    logits, caches = M.prefill(cfg, opts, params, batch, S + n,
                               device="cuda")
    tok = logits[:, -1].argmax(-1, keepdim=True)
    twin = _clone_tree(caches)
    before = da.decode_attention.launches
    graph = M.DecodeGraph("cuda")
    got, _, _ = M.decode_loop(cfg, opts, params, tok, caches, S, n,
                              device="cuda", graph=graph)
    torch.cuda.synchronize()
    per_step = cfg.num_layers * (2 if cfg.encoder is not None else 1)
    assert da.decode_attention.launches - before == per_step * n
    assert graph.runner.captures == 1
    want, _, _ = M.decode_loop(cfg, opts, params, tok, twin, S, n,
                               device="cuda",
                               graph=M.DecodeGraph("cuda", eager=True))
    assert torch.equal(got, want)
    assert _same_tree(caches, twin)


@pytest.mark.gpu
def test_dot_flops_on_card_miss_only_the_decode_kernel():
    """``roofline.counts.dot_flops`` of a decode step on the card against
    the same step on the meta device (plain versions): lower by exactly
    the plain decode's attention products (its two ``bmm`` a layer),
    because the decode kernel is a ``ctypes`` launch that dispatches no
    aten op; every other product is counted alike."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.params import meta_params
    from repro_torch.roofline.counts import dot_flops
    _cuda()
    cfg = get_config("smollm-135m").reduced()
    B, S, index = 2, 64, 5
    opts = M.ModelOptions()
    runs = {}
    for dev in ("cuda", "meta"):
        if dev == "cuda":
            params = M.init_params(
                cfg, torch.Generator(device="cuda").manual_seed(0),
                torch.float32, device="cuda")
        else:
            params = meta_params(M.model_template(cfg), torch.float32)
        caches = M.init_caches(cfg, B, S, torch.float32, opts, device=dev)
        tok = torch.zeros(B, 1, dtype=torch.long, device=dev)
        before = da.decode_attention.launches
        runs[dev] = dot_flops(M.decode_step, cfg, opts, params, tok, caches,
                              index, device=dev)
        launched = da.decode_attention.launches - before
        assert launched == (cfg.num_layers if dev == "cuda" else 0)
    (on_card, card_items), (on_meta, meta_items) = runs["cuda"], runs["meta"]
    attn = [f for f, op in meta_items if op.startswith("aten.bmm")]
    assert len(attn) == 2 * cfg.num_layers
    assert sum(attn) == cfg.num_layers * 4 * B * cfg.num_heads * S \
        * cfg.head_dim
    assert not any(op.startswith("aten.bmm") for _, op in card_items)
    assert on_meta - on_card == sum(attn)
