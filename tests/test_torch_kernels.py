"""The port's attention kernels against the JAX reference.

On the CPU each wrapper runs its plain PyTorch version; it is held to the
reference's oracle (``ref.py``) and to the Pallas kernel in interpret mode,
on the same inputs made with numpy, with bf16 caches (the control step's)
and f32 caches (the serving engine's). Both frameworks round the caches to
bf16 the same way (round to nearest even), and q stays f32, so the
comparisons are f32 at 1e-5. The CUDA kernels themselves are held to the
plain versions on the card by ``test_torch_gpu.py``.
"""
import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.chunk_prefill import chunk_prefill_attention as jcp
from repro.kernels.chunk_prefill import ref as jcref
from repro.kernels.decode_attention import decode_attention as jda
from repro.kernels.decode_attention import ref as jdref
from repro.kernels.decode_attention.paged import \
    paged_decode_attention_kernel as jpda
from repro.models import layers as JL
from repro_torch.kernels import _build
from repro_torch.kernels.chunk_prefill import ops as cp
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.decode_attention import paged as pg
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.moe_gmm import ops as gmm
from repro_torch.models import layers as TL

TOL = dict(atol=1e-5, rtol=1e-5)


KV_TYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
            "f32": (jnp.float32, torch.float32)}


def _inputs(seed, q_shape, kv_shape, kv="bf16"):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(q_shape, dtype=np.float32)
    k = rng.standard_normal(kv_shape, dtype=np.float32)
    v = rng.standard_normal(kv_shape, dtype=np.float32)
    jt, tt = KV_TYPES[kv]
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k, jt), jnp.asarray(v, jt)
    tq, tk, tv = torch.from_numpy(q), torch.from_numpy(k).to(tt), \
        torch.from_numpy(v).to(tt)
    return (jq, jk, jv), (tq, tk, tv)


def _index(index):
    if isinstance(index, tuple):
        return jnp.asarray(index, jnp.int32), torch.tensor(index)
    return index, index


DECODE_CASES = [
    # B, S, N, K, h, index, window, bk (the Pallas kernel's key block)
    (2, 48, 4, 2, 16, 0, 0, 16),           # index 0, G=2
    (2, 45, 4, 2, 16, 44, 0, 16),          # S % bk != 0, last position
    (2, 45, 14, 2, 16, (3, 40), 0, 16),    # per-slot [B] index, G=7
    (3, 64, 14, 2, 64, (10, 63, 31), 8, 32),   # window, G=7
    (1, 40, 2, 2, 128, 25, 0, 32),         # G=1, h=128
]


@pytest.mark.parametrize("kv", ["bf16", "f32"])
@pytest.mark.parametrize("B,S,N,K,h,index,window,bk", DECODE_CASES)
def test_decode_plain_matches_reference(B, S, N, K, h, index, window, bk,
                                        kv):
    (jq, jk, jv), (tq, tk, tv) = _inputs(B * S + h, (B, N, h), (B, S, K, h),
                                         kv)
    ji, ti = _index(index)
    got = da.decode_attention(tq, tk, tv, ti, window=window).numpy()
    oracle = jdref.decode_attention_ref(jq, jk, jv, ji, window=window)
    pallas = jda(jq, jk, jv, ji, window=window, bk=bk, interpret=True)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    # the second plain version: the einsum decode core of layers
    core = TL.attention_decode(tq[:, None], tk, tv, ti, window)[:, 0]
    jcore = JL.attention_decode(jq[:, None], jk, jv, ji, window)[:, 0]
    np.testing.assert_allclose(core.numpy(), np.asarray(jcore), **TOL)
    np.testing.assert_allclose(core.numpy(), got, **TOL)


# the CUDA decode kernels' split of the key axis (SPLIT = 128 absolute
# positions a block), modelled by decode_attention_split_ref
L = da.SPLIT
SPLIT_CASES = [
    # B, S, N, K, h, index, window, split
    (1, 300, 7, 1, 16, L - 1, 0, L),           # the last key of split 0
    (1, 300, 7, 1, 16, L, 0, L),               # the first key of split 1
    (1, 300, 7, 1, 128, 2 * L - 1, 0, L),      # the last key of split 1
    (2, 300, 2, 2, 128, (150, 280), 64, L),    # windows across L and 2L, G=1
    (2, 300, 14, 2, 16, (130, 299), 16, L),    # a window shorter than a split
    (4, 260, 7, 1, 16, (0, L - 1, L, 259), 0, L),  # per-slot, with 0
    (3, 260, 4, 4, 128, (0, 200, 2 * L - 1), 100, L),  # G=1, window and 0
    (2, 100, 14, 2, 16, (31, 64), 40, 32),     # a split of one tile
]


@pytest.mark.parametrize("kv", ["bf16", "f32"])
@pytest.mark.parametrize("B,S,N,K,h,index,window,split", SPLIT_CASES)
def test_decode_split_plain_matches_reference(B, S, N, K, h, index, window,
                                              split, kv):
    """Per-split partials on absolute positions, then the combine, agree
    with the reference's oracle and its Pallas kernel (interpret mode)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(B * S + h + split, (B, N, h),
                                         (B, S, K, h), kv)
    ji, ti = _index(index)
    got = da.decode_attention_split_ref(tq, tk, tv, ti, window,
                                        split).numpy()
    oracle = jdref.decode_attention_ref(jq, jk, jv, ji, window=window)
    pallas = jda(jq, jk, jv, ji, window=window, bk=32, interpret=True)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("kv", ["bf16", "f32"])
@pytest.mark.parametrize("S,npg,index,window", [
    (120, 5, (0, 119), 0),         # one split dense, two in the pool
    (250, 9, (L - 1, 249), 64),    # a window across L
    (200, 7, (L, 199), 16),        # a window shorter than a split
])
def test_decode_split_plain_paged_gather(S, npg, index, window, kv):
    """The split model over a page pool of npg pages of 32 (npg * 32 != S
    rows, shuffled, zero past each slot's S rows) agrees with the
    reference's dense oracle and its paged Pallas kernel (interpret mode),
    and with the split model over the dense cache."""
    B, N, K, h, ps = 2, 14, 2, 16, 32
    (jq, jk, jv), (tq, tk, tv) = _inputs(S + npg, (B, N, h), (B, S, K, h),
                                         kv)
    rng = np.random.default_rng(S)
    table = (rng.permutation(B * npg) + 1).reshape(B, npg).astype(np.int32)
    pools = []
    for t in (tk, tv):
        rows = np.zeros((B, npg * ps, K, h), np.float32)
        rows[:, :S] = t.float().numpy()
        pages = np.zeros((1 + B * npg, ps, K, h), np.float32)
        pages[table.reshape(-1)] = rows.reshape(B * npg, ps, K, h)
        pools.append(pages)
    jt, tt = KV_TYPES[kv]
    (jkp, jvp), (tkp, tvp) = [[jnp.asarray(p, jt) for p in pools],
                              [torch.from_numpy(p).to(tt) for p in pools]]
    ji, ti = _index(index)
    tab = torch.from_numpy(table)
    got = da.decode_attention_split_ref(
        tq, pg.gather_pages(tkp, tab), pg.gather_pages(tvp, tab), ti,
        window).numpy()
    oracle = jdref.decode_attention_ref(jq, jk, jv, ji, window=window)
    pallas = jpda(jq, jkp, jvp, jnp.asarray(table), ji, window=window,
                  interpret=True)
    dense = da.decode_attention_split_ref(tq, tk, tv, ti, window).numpy()
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, dense, **TOL)


def test_decode_split_matches_kernel_source():
    """The wrappers size the kernels' scratch from ``SPLIT``; the C entries
    write ceil(length / SPLIT) partials a (slot, head) from the kernels'
    own SPLIT = SPLIT_TILES * TK: the two must agree."""
    src = (Path(da.__file__).parent / "csrc" / "decode_tile.cuh").read_text()
    tiles, tk = (int(re.search(rf"constexpr int {name} = (\d+);",
                               src).group(1))
                 for name in ("SPLIT_TILES", "TK"))
    assert re.search(r"constexpr int SPLIT = SPLIT_TILES \* TK;", src)
    assert tiles * tk == da.SPLIT


@pytest.mark.parametrize("C", [1, 2, 7, 32, 33, 64, 65, 128, 129, 160,
                               161, 256, 257, 600])
def test_gated_rows(C):
    """The bf16 gmm_gated's rows per pass: one of its instantiations, the
    smallest that holds C up to 256 (one pass, so each weight byte is read
    once a launch), passes of 256 past it."""
    rows = gmm.gated_rows(C)
    assert rows in gmm.GATED_ROWS
    if C <= 256:
        assert rows >= C
        assert all(r < C for r in gmm.GATED_ROWS if r < rows)
    else:
        assert rows == gmm.GATED_ROWS[-1] == 256
    assert -(-C // rows) == max(1, -(-C // 256))


def test_gated_rows_match_kernel_source():
    """The C entry instantiates exactly the rows ``gated_rows`` chooses
    from (an unknown count is refused there)."""
    src = (Path(gmm.__file__).parent / "csrc" /
           "gmm_gated_tc.cu").read_text()
    cases = re.findall(r"case (\d+): return stream<EPI, (\d+)>", src)
    assert all(a == b for a, b in cases)
    assert tuple(sorted(int(a) for a, _ in cases)) == gmm.GATED_ROWS


CHUNK_CASES = [
    # B, S, L, N, K, h, index, window
    (2, 16, 16, 4, 2, 16, 0, 0),           # chunk from 0, G=2
    (2, 12, 45, 14, 2, 16, 20, 0),         # positioned, L % 32 != 0, G=7
    (2, 8, 40, 4, 2, 64, (0, 30), 0),      # per-slot [B] starts
    (1, 24, 70, 14, 2, 16, 40, 10),        # window, G=7
    (1, 9, 32, 3, 3, 128, 5, 0),           # G=1, h=128
    # the edges of the card's bf16 tensor-core tiles (64 query rows, 64
    # keys): S off 64, G=7, every head dim, a window crossing a tile edge
    (1, 70, 100, 14, 2, 16, 0, 0),         # S=70, h=16
    (1, 67, 130, 14, 2, 64, 50, 0),        # S=67 from 50, h=64
    (1, 65, 65, 7, 1, 128, 0, 0),          # S=65, h=128
    (2, 80, 150, 14, 2, 64, (10, 60), 48),  # window 48 across 64 edges
]


@pytest.mark.parametrize("kv", ["bf16", "f32"])
@pytest.mark.parametrize("B,S,L,N,K,h,index,window", CHUNK_CASES)
def test_chunk_plain_matches_reference(B, S, L, N, K, h, index, window, kv):
    (jq, jk, jv), (tq, tk, tv) = _inputs(B * L + S, (B, S, N, h),
                                         (B, L, K, h), kv)
    ji, ti = _index(index)
    got = cp.chunk_prefill_attention(tq, tk, tv, ti, window=window).numpy()
    oracle = jcref.chunk_prefill_ref(jq, jk, jv, ji, window=window)
    pallas = jcp(jq, jk, jv, ji, window=window, bk=32, interpret=True)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    # the second plain version: the banded blockwise core of layers
    core = TL.attention_chunk_banded(tq, tk, tv, ti, window, 32)
    jcore = JL.attention_chunk_banded(jq, jk, jv, ji, window, 32)
    np.testing.assert_allclose(core.numpy(), np.asarray(jcore), **TOL)
    np.testing.assert_allclose(core.numpy(), got, **TOL)


def test_banded_core_chunking_invariance():
    """Rows computed in one chunk from 0 and in a later chunk are bit-equal
    in the port's blockwise core (the contract the CUDA kernel keeps)."""
    _, (tq, tk, tv) = _inputs(7, (2, 64, 4, 16), (2, 64, 2, 16))
    whole = TL.attention_chunk_banded(tq, tk, tv, 0, 0, 32)
    part = TL.attention_chunk_banded(tq[:, 40:], tk, tv, 40, 0, 32)
    assert torch.equal(whole[:, 40:], part)


@pytest.mark.parametrize("bad", ["head_dim", "cache_dtype", "bk", "group"])
def test_wrappers_reject_unsupported_inputs(bad):
    q = torch.zeros(1, 4, 32 if bad == "head_dim" else 16)
    kv = torch.zeros(1, 8, 2, q.shape[-1],
                     dtype=torch.float16 if bad == "cache_dtype"
                     else torch.bfloat16)
    if bad == "group":
        q, kv = torch.zeros(1, 66, 16), torch.zeros(1, 8, 2, 16).bfloat16()
    with pytest.raises((ValueError, TypeError)):
        if bad == "bk":
            cp.chunk_prefill_attention(q[:, None], kv, kv, 0, bk=16)
        else:
            da.decode_attention(q, kv, kv, 0)


def test_flash_runs_the_chunk_bodies_at_every_head_dim():
    """The flash entry instantiates the two tensor-core chunk bodies (f32:
    3xTF32, bf16: mma.sync) with its flags (causal or not, log-sum-exp
    written) at every head dim the wrapper takes, causal and not, and has
    no body of its own."""
    src = (Path(fa.__file__).parent / "csrc" /
           "flash_attention.cu").read_text()
    for hdr in ("chunk_mma.cuh", "chunk_tf32.cuh"):
        assert f'#include "../../chunk_prefill/csrc/{hdr}"' in src
    assert "chunk_tf32::chunk_rows<H, float, chunk_tf32::SCALE_NONE, " \
           "CAUSAL, true>" in src
    assert "chunk_mma::chunk_rows<H, CAUSAL, true>" in src
    assert src.count("__global__") == 2
    cases = re.findall(r"case (\d+):\s+return launch_c<(\d+), T>", src)
    assert all(a == b for a, b in cases)
    assert tuple(sorted(int(a) for a, _ in cases)) == fa.HEAD_DIMS
    assert re.search(r"return launch<H, true, T>", src)
    assert re.search(r"return launch<H, false, T>", src)
    for t in ("__nv_bfloat16", "float"):
        assert f"launch_h<{t}>(h, causal" in src


def _ctype(param: str):
    if "*" in param:
        return ctypes.c_void_p
    return ctypes.c_longlong if param.startswith("long long") \
        else ctypes.c_int


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signatures_match_the_c_entries(name):
    """``_build.SIGNATURES`` declares each C entry's arguments as its
    source does: a pointer (and the stream) as c_void_p, an int as c_int,
    a long long as c_longlong, in order."""
    text = "\n".join(p.read_text() for p in _build.sources())
    m = re.search(rf'extern "C" int {name}\((.*?)\)\s*\{{', text, re.S)
    assert m, f"no C entry {name}"
    params = [p.strip() for p in m.group(1).split(",")]
    assert [_ctype(p) for p in params] == _build.SIGNATURES[name]
