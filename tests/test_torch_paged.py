"""The port's paged KV cache against the JAX reference: quantization,
the paged write policies, the paged decode plain versions, the page pool,
prefix keys, the cache-maintenance helpers of the engine and the samplers.

Inputs are made with numpy from seeds and handed to both frameworks. Codes
must be equal and scales within 1e-7 relative (both divide and round in
f32); attention outputs agree within 1e-5 in f32 (sums in another order).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_params
from repro.kernels.decode_attention import ops as jops
from repro.kernels.decode_attention import ref as jref
from repro.models import kv_quant as jkq
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving import engine as JE
from repro.serving import sampler as JS
from repro.serving.kv_pool import KVPool as JPool
from repro.serving.kv_pool import PoolExhausted as JExhausted
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import paged as pg
from repro_torch.models import kv_quant as tkq
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import params as TP
from repro_torch.models import stacks as TS
from repro_torch.serving import engine as TE
from repro_torch.serving import sampler as TSmp
from repro_torch.serving.kv_pool import KVPool as TPool
from repro_torch.serving.kv_pool import PoolExhausted as TExhausted

TOL = dict(atol=1e-5, rtol=1e-5)
SCALE_RTOL = 1e-7
QUANT = [("int8", "head"), ("int8", "token"), ("fp8", "head"),
         ("fp8", "token")]
JDT = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}
TDT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _codes(x):
    """Codes of either framework as a comparable int/float numpy array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rand(seed, *shape, scale=1.0):
    return scale * np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32)


# ---------------------------------------------------------------------------
# kv_quant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype,gran", QUANT)
def test_quantize_page_rows_matches_reference(kv_dtype, gran):
    rows = _rand(0, 3, 8, 2, 16, scale=3.0)
    rows[1] = 0.0                                   # an all-zero page
    jc, js = jkq.quantize_page_rows(jnp.asarray(rows), JDT[kv_dtype], gran)
    tc, ts = tkq.quantize_page_rows(torch.from_numpy(rows), TDT[kv_dtype],
                                    gran)
    assert tc.dtype == TDT[kv_dtype]
    np.testing.assert_array_equal(_codes(tc), _codes(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=SCALE_RTOL,
                               atol=0)
    np.testing.assert_array_equal(
        tkq.decode(tc, ts[..., None, :, None] if gran == "head"
                   else ts[..., None]).numpy(),
        np.asarray(jkq.decode(jc, js[..., None, :, None] if gran == "head"
                              else js[..., None])))


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_encode_rounding_and_range_match_reference(kv_dtype):
    """Half-way values round to even (int8), values in range encode as in
    the reference, and scale 0 on a zero row gives code 0. Out of range,
    int8 clips as in the reference; fp8 saturates at +-448 where the
    reference's cast gives NaN (past 464; amax scales never get there)."""
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 300.0, -300.0, 460.0,
                  1e-3, 0.0], np.float32)
    jc = jkq.encode(jnp.asarray(x), np.float32(1.0), JDT[kv_dtype])
    tc = tkq.encode(torch.from_numpy(x), torch.tensor(1.0), TDT[kv_dtype])
    np.testing.assert_array_equal(_codes(tc), _codes(jc))
    zero = tkq.encode(torch.zeros(3), torch.tensor(0.0), TDT[kv_dtype])
    assert not zero.float().abs().max()
    far = tkq.encode(torch.tensor([1e4, -1e4]), torch.tensor(1.0),
                     TDT[kv_dtype]).float()
    assert far.tolist() == [tkq.qmax(TDT[kv_dtype]), -tkq.qmax(TDT[kv_dtype])]
    assert tkq.qmax(TDT[kv_dtype]) == jkq.qmax(JDT[kv_dtype])
    assert tkq.quant_dtype("bf16") is None and tkq.is_quantized(torch.int8)
    with pytest.raises(ValueError, match="kv_dtype"):
        tkq.quant_dtype("int4")


# ---------------------------------------------------------------------------
# update_cache_paged: the three write policies
# ---------------------------------------------------------------------------

def _write_sequence():
    """Writes of B=3 slots over 4 steps: slot 0 retired (null row), slots
    1 and 2 live; step 2 writes a larger token (a head scale grows) and
    step 3 a smaller one (it does not shrink)."""
    table = np.array([[0, 0, 0], [1, 2, 0], [3, 4, 5]], np.int32)
    index = [np.array([5, 2, 6]), np.array([6, 3, 7]), np.array([7, 4, 8]),
             np.array([8, 5, 9])]
    amp = [1.0, 1.0, 4.0, 0.25]
    news = [_rand(10 + i, 3, 1, 2, 16, scale=a) for i, a in enumerate(amp)]
    return table, index, news


@pytest.mark.parametrize("policy", ["f32", "int8-head", "int8-token",
                                    "fp8-head", "fp8-token"])
def test_update_cache_paged_matches_reference(policy):
    table, index, news = _write_sequence()
    P, ps, K, h = 6, 4, 2, 16
    kv_dtype, _, gran = policy.partition("-")
    quant = kv_dtype != "f32"
    jpages = jnp.zeros((P, ps, K, h), JDT[kv_dtype] if quant
                       else jnp.float32)
    tpages = torch.zeros((P, ps, K, h), dtype=TDT[kv_dtype] if quant
                         else torch.float32)
    sshape = (P, ps, K) if gran == "token" else (P, K)
    jsc = jnp.zeros(sshape, jnp.float32) if quant else None
    tsc = torch.zeros(sshape) if quant else None
    for idx, new in zip(index, news):
        jpages, jsc = JL.update_cache_paged(jpages, jnp.asarray(new),
                                            jnp.asarray(table),
                                            jnp.asarray(idx, jnp.int32), jsc)
        tpages, tsc = TL.update_cache_paged(tpages, torch.from_numpy(new),
                                            torch.from_numpy(table),
                                            torch.from_numpy(idx), tsc)
    # every page equal: the retired slot's writes sank into page 0, its
    # rows in an unquantized pool, zeros in a quantized one
    np.testing.assert_array_equal(_codes(tpages), _codes(jpages))
    assert bool(tpages[0].float().abs().max()) != quant
    if quant:
        np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc),
                                   rtol=SCALE_RTOL, atol=0)
        assert not tsc[0].abs().max()
    if gran == "head":      # the growth of step 2 requantized slot 1's page
        assert float(tsc[1].min()) > 0


def test_update_cache_paged_rewrite_is_stable():
    """An identical rewrite under an unchanged head scale leaves every code
    and scale as it was (the requantizing write always runs)."""
    table, index, news = _write_sequence()
    pages = torch.zeros(6, 4, 2, 16, dtype=torch.int8)
    scales = torch.zeros(6, 2)
    for idx, new in zip(index, news):
        TL.update_cache_paged(pages, torch.from_numpy(new),
                              torch.from_numpy(table), torch.from_numpy(idx),
                              scales)
    before = pages.clone(), scales.clone()
    TL.update_cache_paged(pages, torch.from_numpy(news[-1]),
                          torch.from_numpy(table),
                          torch.from_numpy(index[-1]), scales)
    assert torch.equal(pages, before[0]) and torch.equal(scales, before[1])


# ---------------------------------------------------------------------------
# paged decode: the plain versions against the reference
# ---------------------------------------------------------------------------

def _paged_inputs(seed, storage, gran, B=3, npg=4, ps=8, K=2, h=16, N=4):
    """A shuffled pool holding B slots' rows, null entries past each slot's
    pages; returns (j inputs, t inputs, index)."""
    rng = np.random.default_rng(seed)
    P = B * npg + 2
    table = np.zeros((B, npg), np.int32)
    perm = rng.permutation(np.arange(1, P))
    lens = [npg, npg - 1, 2]
    for b in range(B):
        table[b, :lens[b]] = perm[b * npg:b * npg + lens[b]]
    index = np.array([npg * ps - 1, (npg - 1) * ps - 3, ps + 1], np.int32)
    q = rng.standard_normal((B, N, h), dtype=np.float32)
    out = []
    for j in range(2):
        rows = rng.standard_normal((P, ps, K, h), dtype=np.float32)
        if storage == "f32":
            out.append((jnp.asarray(rows), torch.from_numpy(rows), None,
                        None))
            continue
        jc, js = jkq.quantize_page_rows(jnp.asarray(rows), JDT[storage],
                                        gran)
        tc, ts = tkq.quantize_page_rows(torch.from_numpy(rows),
                                        TDT[storage], gran)
        out.append((jc, tc, js, ts))
    (jk, tk, jks, tks), (jv, tv, jvs, tvs) = out
    return ((jnp.asarray(q), jk, jv, jks, jvs, jnp.asarray(table)),
            (torch.from_numpy(q), tk, tv, tks, tvs, torch.from_numpy(table)),
            index)


@pytest.mark.parametrize("storage,gran", [("f32", None)] + QUANT)
@pytest.mark.parametrize("window", [0, 10])
def test_paged_decode_plain_matches_reference(storage, gran, window):
    (jq, jk, jv, jks, jvs, jpt), (tq, tk, tv, tks, tvs, tpt), index = \
        _paged_inputs(3, storage, gran)
    got = pg.paged_decode_attention(tq, tk, tv, tpt, torch.from_numpy(index),
                                    k_scales=tks, v_scales=tvs,
                                    window=window).numpy()
    ji = jnp.asarray(index)
    if jks is None:
        oracle = jref.paged_decode_attention_ref(jq, jk, jv, jpt, ji, window)
    else:
        oracle = jref.paged_decode_attention_quant_ref(jq, jk, jv, jks, jvs,
                                                       jpt, ji, window)
    pallas = jops.paged_decode_attention(jq, jk, jv, jpt, ji, k_scales=jks,
                                         v_scales=jvs, window=window,
                                         interpret=True)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    # the port's plain versions, called directly
    ti = torch.from_numpy(index)
    plain = (pg.paged_decode_attention_ref(tq, tk, tv, tpt, ti, window)
             if tks is None else
             pg.paged_decode_attention_quant_ref(tq, tk, tv, tks, tvs, tpt, ti,
                                                 window))
    np.testing.assert_allclose(plain.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("bad", ["scales_missing", "one_scale",
                                 "scale_shape", "page_dtype"])
def test_paged_wrapper_rejects_bad_inputs(bad):
    (_, _, _, _, _, _), (tq, tk, tv, tks, tvs, tpt), _ = \
        _paged_inputs(4, "int8", "head")
    kw = dict(k_scales=tks, v_scales=tvs)
    if bad == "scales_missing":
        kw = {}
    elif bad == "one_scale":
        kw = dict(k_scales=tks)
    elif bad == "scale_shape":
        kw = dict(k_scales=tks[:, :1], v_scales=tvs[:, :1])
    else:
        tk, tv = tk.half(), tv.half()
    with pytest.raises((ValueError, TypeError)):
        pg.paged_decode_attention(tq, tk, tv, tpt, 3, **kw)


# ---------------------------------------------------------------------------
# the engine's f32 prefill cache through the ported kernels' plain paths
# ---------------------------------------------------------------------------

def test_engine_f32_prefill_cache_matches_reference():
    """The engine's batch-1 admission prefill keeps its cache in f32; the
    port's prefill (chunk route, f32 view) gives the reference's logits and
    cache rows."""
    jcfg, jparams = reduced_params("molmoact-7b")
    tcfg = get_config("molmoact-7b").reduced()
    tparams = TP.from_jax(TM.model_template(tcfg),
                          jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, tcfg.vocab_size, (1, 7))
    patches = rng.standard_normal((1, tcfg.vision.num_tokens,
                                   tcfg.vision.embed_dim), dtype=np.float32)
    jl, jc = JM.prefill(jcfg, JL.ModelOptions(remat=False), jparams,
                        {"tokens": jnp.asarray(tokens),
                         "patches": jnp.asarray(patches)}, 32,
                        cache_dtype=jnp.float32)
    tl, tc = TM.prefill(tcfg, TL.ModelOptions(), tparams,
                        {"tokens": tokens, "patches": patches}, 32,
                        cache_dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    jflat = {"/".join(p.key for p in path): leaf for path, leaf in
             jax.tree_util.tree_flatten_with_path(jc)[0]}
    for path, leaf in TP.leaves(tc):
        assert leaf.dtype == torch.float32
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jflat[path]),
                                   atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# cache templates, prefix keys, the pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype,gran", [("bf16", "head")] + QUANT)
def test_paged_cache_template_matches_reference(kv_dtype, gran):
    jcfg, _ = reduced_params("qwen1.5-0.5b")
    tcfg = get_config("qwen1.5-0.5b").reduced()
    jc = JM.init_caches(jcfg, 2, 32, jnp.float32, JL.ModelOptions(),
                        paged=True, num_pages=9, page_size=8,
                        kv_dtype=kv_dtype, scale_granularity=gran)
    tc = TS.init_caches(tcfg, 2, 32, torch.float32, paged=True, num_pages=9,
                        page_size=8, kv_dtype=kv_dtype,
                        scale_granularity=gran, device="cpu")
    jflat = {"/".join(p.key for p in path): leaf for path, leaf in
             jax.tree_util.tree_flatten_with_path(jc)[0]}
    tflat = dict(TP.leaves(tc))
    assert sorted(jflat) == sorted(tflat)
    for path, leaf in tflat.items():
        assert tuple(leaf.shape) == jflat[path].shape, path
        assert str(leaf.dtype).replace("torch.", "") == \
            str(jflat[path].dtype), path
        assert TS.is_paged_leaf(path) and (
            TS.is_scale_leaf(path) == path.endswith("_scale"))
        assert TS.cache_batch_axis(path) == (1 if path.startswith("blocks")
                                             else 0)
    with pytest.raises(ValueError, match="requires the paged layout"):
        TS.cache_template(tcfg, 1, 32, kv_dtype="int8")


@pytest.mark.parametrize("vision", [False, True])
def test_prefix_page_keys_are_byte_equal(vision):
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, 256, 21, dtype=np.int32)
    patches = rng.standard_normal((8, 32), dtype=np.float32) if vision \
        else None
    n_prefix = 8 if vision else 0
    for ps, kv in ((4, "bf16"), (8, "int8")):
        want = JE.prefix_page_keys("m", ps, kv, prompt, patches, n_prefix)
        got = TE.prefix_page_keys("m", ps, kv, prompt, patches, n_prefix)
        assert got == want and len(got) == (21 + n_prefix) // ps


def test_kv_pool_matches_reference_on_a_seeded_sequence():
    """One seeded sequence of admit / ensure / prepare_write / fork /
    free_slot / register calls (with prefix keys that repeat) drives both
    pools; tables, free lists, refcounts, hits and exhaustion agree."""
    rng = np.random.default_rng(7)
    pools = [JPool(14, 4, 3, 5), TPool(14, 4, 3, 5)]
    for p in pools:
        p.set_reserve(1)
    keysets = [[bytes([k]) * 4 for k in range(3)],
               [bytes([k]) * 4 for k in (0, 1, 9)], []]
    for _ in range(120):
        op = rng.integers(0, 5)
        slot = int(rng.integers(0, 3))
        arg = int(rng.integers(1, 20))
        keys = keysets[int(rng.integers(0, 3))]
        results = []
        for p, exc in zip(pools, (JExhausted, TExhausted)):
            try:
                if op == 0 and not p.slot_pages[slot]:
                    results.append(p.admit(slot, arg, keys))
                elif op == 1 and p.slot_pages[slot]:
                    results.append(p.ensure(slot, arg))
                elif op == 2 and p.slot_pages[slot]:
                    results.append(p.prepare_write(slot, 0, arg))
                elif op == 3 and p.slot_pages[slot]:
                    dst = (slot + 1) % 3
                    if not p.slot_pages[dst]:
                        p.fork(slot, dst)
                    results.append(p.can_admit(arg, keys))
                else:
                    p.free_slot(slot)
                    results.append(p.match_prefix(keys))
            except exc as e:
                results.append(type(e).__name__)
        assert results[0] == results[1]
        a, b = pools
        np.testing.assert_array_equal(a.page_table, b.page_table)
        np.testing.assert_array_equal(a.refcount, b.refcount)
        assert a._free == b._free and list(a._cached) == list(b._cached)
        assert (a.prefix_hits, a.pages_hwm, a.pages_in_use) == \
            (b.prefix_hits, b.pages_hwm, b.pages_in_use)


# ---------------------------------------------------------------------------
# the engine's cache-maintenance helpers
# ---------------------------------------------------------------------------

def _pools(kv_dtype, gran, seed=8):
    """The same filled paged caches in both frameworks (reduced qwen)."""
    jcfg, _ = reduced_params("qwen1.5-0.5b")
    tcfg = get_config("qwen1.5-0.5b").reduced()
    jc = JM.init_caches(jcfg, 2, 32, jnp.float32, JL.ModelOptions(),
                        paged=True, num_pages=7, page_size=8,
                        kv_dtype=kv_dtype, scale_granularity=gran)
    tc = TS.init_caches(tcfg, 2, 32, torch.float32, paged=True, num_pages=7,
                        page_size=8, kv_dtype=kv_dtype,
                        scale_granularity=gran, device="cpu")
    flat, treedef = jax.tree_util.tree_flatten_with_path(jc)
    rng = np.random.default_rng(seed)
    filled = []
    for path, leaf in flat:
        key = "/".join(p.key for p in path)
        vals = np.abs(rng.standard_normal(leaf.shape, dtype=np.float32)) \
            if key.endswith("_scale") else 3 * rng.standard_normal(
                leaf.shape, dtype=np.float32)
        jleaf = jnp.asarray(vals).astype(leaf.dtype)
        filled.append(jleaf)
        TP.set_leaf(tc, key, torch.from_numpy(
            np.array(jleaf.astype(jnp.float32))).to(dict(TP.leaves(tc))[
                key].dtype))
    return jcfg, tcfg, jax.tree_util.tree_unflatten(treedef, filled), tc


def _assert_caches_equal(jc, tc):
    for path, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]:
        key = "/".join(p.key for p in path)
        want, got = _codes(leaf), _codes(dict(TP.leaves(tc))[key])
        np.testing.assert_allclose(got, want, rtol=SCALE_RTOL, atol=0,
                                   err_msg=key)


@pytest.mark.parametrize("kv_dtype,gran", [("bf16", "head")] + QUANT)
def test_scatter_pages_matches_reference(kv_dtype, gran):
    jcfg, tcfg, jc, tc = _pools(kv_dtype, gran)
    cache1 = _rand(9, 1, 32, jcfg.num_kv_heads, jcfg.head_dim, scale=2.0)
    jflat, treedef = jax.tree_util.tree_flatten_with_path(
        JM.init_caches(jcfg, 1, 32, jnp.float32, JL.ModelOptions()))
    jc1 = jax.tree_util.tree_unflatten(
        treedef, [jnp.broadcast_to(jnp.asarray(cache1), leaf.shape)
                  for _, leaf in jflat])
    tc1 = {}
    for path, leaf in jflat:
        TP.set_leaf(tc1, "/".join(p.key for p in path),
                    torch.from_numpy(np.array(np.broadcast_to(
                        cache1, leaf.shape))))
    dest = np.array([0, 5, 2, 0], np.int32)   # a shared page, two fresh
    jout = JE._scatter_pages_impl(jc, jc1, jnp.asarray(dest), 8)
    TE._scatter_pages_impl(tc, tc1, dest, 8)
    # the null page too: it holds the last page routed to it
    _assert_caches_equal(jout, tc)


@pytest.mark.parametrize("kv_dtype,gran", [("bf16", "head"),
                                           ("int8", "head"),
                                           ("fp8", "token")])
def test_copy_pages_and_reset_scales_match_reference(kv_dtype, gran):
    _, _, jc, tc = _pools(kv_dtype, gran)
    src, dst = np.array([3, 0, 0], np.int32), np.array([5, 0, 0], np.int32)
    jout = JE._copy_pages_impl(jc, jnp.asarray(src), jnp.asarray(dst))
    TE._copy_pages_impl(tc, torch.from_numpy(src).long(),
                        torch.from_numpy(dst).long())
    _assert_caches_equal(jout, tc)
    ids = np.array([4, 6, 0], np.int32)
    jout = JE._reset_page_scales_impl(jout, jnp.asarray(ids))
    TE._reset_page_scales_impl(tc, torch.from_numpy(ids).long())
    _assert_caches_equal(jout, tc)


def test_scatter_slot_matches_reference():
    jcfg, _ = reduced_params("smollm-135m")
    tcfg = get_config("smollm-135m").reduced()
    big = JM.init_caches(jcfg, 3, 16, jnp.float32, JL.ModelOptions())
    small = jax.tree.map(lambda l: jnp.arange(l.size, dtype=jnp.float32)
                         .reshape(l.shape),
                         JM.init_caches(jcfg, 1, 16, jnp.float32,
                                        JL.ModelOptions()))
    tbig = TS.init_caches(tcfg, 3, 16, torch.float32, device="cpu")
    tsmall = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(small)[0]:
        TP.set_leaf(tsmall, "/".join(p.key for p in path),
                    torch.from_numpy(np.asarray(leaf)))
    TE._scatter_slot(tbig, tsmall, 1)
    _assert_caches_equal(JE._scatter_slot(big, small, 1), tbig)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.7, 0), (1.3, 5)])
def test_sampler_matches_reference_with_the_same_draw(temperature, top_k):
    """Greedy is argmax; temperature sampling is argmax(l/T + g), so
    handing the port the reference's Gumbel draw gives its tokens."""
    logits = _rand(11, 6, 1, 40, scale=2.0)
    key = jax.random.PRNGKey(3)
    want = np.asarray(JS.sample_token(jnp.asarray(logits), key, temperature,
                                      top_k))
    noise = torch.from_numpy(np.asarray(jax.random.gumbel(key, (6, 40))))
    got = TSmp.sample_token(torch.from_numpy(logits), temperature, top_k,
                            noise=noise)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampler_counter_noise_is_gumbel():
    """The counter-based noise is a function of (key, position) alone, has
    the standard Gumbel's mean and variance, and makes the Gumbel-max draw
    a categorical draw from softmax(l / T)."""
    keys, pos = torch.tensor([3, 3, 4]), torch.tensor([10, 11, 10])
    g = TSmp.gumbel(keys, pos, 50)
    assert torch.equal(g, TSmp.gumbel(keys, pos, 50))
    assert torch.equal(g[0, :20], TSmp.gumbel(keys[:1], pos[:1], 20)[0])
    assert not torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2])
    big = TSmp.gumbel(torch.arange(64), torch.full((64,), 7), 4096).double()
    assert abs(float(big.mean()) - 0.5772156649) < 0.01
    assert abs(float(big.var()) - math.pi ** 2 / 6) < 0.03
    logits = torch.tensor([[[0.0, 1.0, 2.0]]]).expand(20000, 1, 3)
    draws = TSmp.sample_token(logits, 1.5, 0, torch.arange(20000),
                              torch.zeros(20000))
    freq = torch.bincount(draws, minlength=3).double() / 20000
    want = torch.softmax(torch.tensor([0.0, 1.0, 2.0]) / 1.5, 0).double()
    assert float((freq - want).abs().max()) < 0.015
