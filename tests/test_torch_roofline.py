"""The port's dry-run arithmetic held against the reference's, on the CPU:
logical axes of every parameter and cache leaf, the rule tables and
``spec_for`` over both production meshes, the analytic cost model
(``params_bytes_per_dev``, ``kv_cache_bytes``, ``analytic_cell`` with its
breakdown, ``model_flops_for``) over all 40 (arch x shape) cells and the
option matrix, ``serving_projection``, and the roofline terms on the
reference's TPU constants and on the card's data sheet. Pure arithmetic:
every number agrees to 1e-12 relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import SHAPES as R_SHAPES
from repro.configs import get_config as ref_config
from repro.distributed import sharding as RSH
from repro.models import model as RM
from repro.models import stacks as RST
from repro.models.params import is_pspec as r_is_pspec
from repro.roofline import analytic as RA
from repro.roofline import report as RR

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, cells, get_config,
                                 list_archs, shape_supported)
from repro_torch.core.hardware import H100_SXM, TPU_V5E
from repro_torch.distributed import sharding as TSH
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models import model as TM
from repro_torch.models import stacks as TST
from repro_torch.models.params import PSpec, leaves, stack
from repro_torch.roofline import analytic as TA
from repro_torch.roofline import report as TR

REL = 1e-12
ALL_ARCHS = list(list_archs()) + ["molmoact-7b-dit"]
MESHES = {"single_pod": production_mesh_shape(False),
          "multi_pod": production_mesh_shape(True)}
RULES = {"default": "DEFAULT_RULES", "inference": "INFERENCE_RULES",
         "seq_parallel": "SEQ_PARALLEL_RULES", "serving": "SERVING_RULES"}


class FakeMesh:
    """A mesh that holds only its axis sizes (the reference's own test
    device), so no 256 devices are needed."""

    def __init__(self, shape):
        self.shape = shape


def _close(a, b):
    assert a == pytest.approx(b, rel=REL, abs=0.0), (a, b)


def _ref_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=r_is_pspec)[0]
    return {"/".join(p.key for p in path): leaf for path, leaf in flat}


def _same_leaves(ref_tree, port_tree):
    r, t = _ref_leaves(ref_tree), dict(leaves(port_tree))
    assert sorted(r) == sorted(t)
    for path in r:
        assert (t[path].shape, t[path].axes) == \
            (r[path].shape, r[path].axes), path


# ---------------------------------------------------------------------------
# configs, PSpec, axes
# ---------------------------------------------------------------------------

def test_shapes_and_cells_match_reference():
    from repro.configs import ASSIGNED_ARCHS as R_ARCHS
    from repro.configs import cells as r_cells
    from repro.configs import shape_supported as r_supported
    assert ASSIGNED_ARCHS == R_ARCHS and len(ASSIGNED_ARCHS) == 10
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in R_SHAPES.items()}
    ours = [(c.name, s.name, ok, why) for c, s, ok, why in
            cells(include_skipped=True)]
    refs = [(c.name, s.name, ok, why) for c, s, ok, why in
            r_cells(include_skipped=True)]
    assert ours == refs and len(ours) == 40
    assert len(list(cells())) == len(list(r_cells()))
    for arch in ALL_ARCHS:
        cfg = get_config(arch)
        assert cfg.sub_quadratic == ref_config(arch).sub_quadratic
        for name, shape in SHAPES.items():
            assert shape_supported(cfg, shape) == \
                r_supported(ref_config(arch), R_SHAPES[name])


def test_pspec_signature():
    s = PSpec((4, 8), ("embed", "mlp"), fan_in=4)
    assert (s.init, s.fan_in, s.stacked) == ("normal", 4, False)
    with pytest.raises(AssertionError):
        PSpec((4, 8), ("embed",))
    t = stack({"a": {"w": s}}, 3)
    assert t["a"]["w"].shape == (3, 4, 8)
    assert t["a"]["w"].axes == ("layers", "embed", "mlp")
    assert t["a"]["w"].stacked
    assert not stack({"w": s}, 3, "blocks")["w"].stacked


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_model_template_axes_match_reference(arch):
    _same_leaves(RM.model_template(ref_config(arch)),
                 TM.model_template(get_config(arch)))


CACHES = [dict(), dict(paged=True, num_pages=7, page_size=16),
          dict(paged=True, num_pages=7, page_size=16, kv_dtype="int8"),
          dict(paged=True, num_pages=7, page_size=16, kv_dtype="int8",
               scale_granularity="token"),
          dict(paged=True, num_pages=7, page_size=16, kv_dtype="fp8"),
          dict(paged=True, num_pages=7, page_size=16, kv_dtype="fp8",
               scale_granularity="token"),
          dict(window_cache=True)]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_template_axes_match_reference(arch):
    """Dense, paged, int8 and fp8 pools at head and token scales, and ring
    caches (``window_cache``), leaf by leaf."""
    from repro.models.layers import ModelOptions as RO
    from repro_torch.models.layers import ModelOptions as TO
    rcfg, tcfg = ref_config(arch), get_config(arch)
    for kw in CACHES:
        kw = dict(kw)
        ring = kw.pop("window_cache", False)
        _same_leaves(
            RST.cache_template(rcfg, 3, 96, jnp.bfloat16,
                               RO(window_cache=ring),
                               **kw),
            TST.cache_template(tcfg, 3, 96, TO(window_cache=ring), **kw))


# ---------------------------------------------------------------------------
# rule tables and spec_for
# ---------------------------------------------------------------------------

def test_rule_tables_are_the_reference_tables():
    for name in RULES.values():
        assert getattr(TSH, name) == getattr(RSH, name)
    for n in (1, 2, 3, 4, 16):
        for heads, kv in ((9, 3), (16, 4), (28, 4), (32, 8)):
            assert TSH.serving_rules(n, heads, kv) == \
                RSH.serving_rules(n, heads, kv)


def _ref_spec(shape, axes, sizes, rules):
    return tuple(RSH.spec_for(shape, axes, FakeMesh(sizes), rules))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_spec_for_matches_reference(arch):
    """Every parameter and dense-cache leaf, both production meshes, all
    four rule tables; the serving rules at model = 1, 2, 3, 4, 16."""
    cfg = get_config(arch)
    specs = [s for _, s in leaves(TM.model_template(cfg))]
    specs += [s for _, s in leaves(TST.cache_template(cfg, 32, 128))]
    for sizes in MESHES.values():
        for name in RULES.values():
            rules = getattr(TSH, name)
            for s in specs:
                ours = TSH.spec_for(s.shape, s.axes, sizes, rules)
                assert ours == _ref_spec(s.shape, s.axes, sizes, rules), \
                    (s, name)
                # a mesh given by its .shape places the same way
                assert TSH.spec_for(s.shape, s.axes, FakeMesh(sizes),
                                    rules) == ours
    for n in (1, 2, 3, 4, 16):
        rules = TSH.serving_rules(n, cfg.num_heads, cfg.num_kv_heads)
        for s in specs:
            assert TSH.spec_for(s.shape, s.axes, {"model": n}, rules) == \
                _ref_spec(s.shape, s.axes, {"model": n}, rules), (s, n)


MESH = {"data": 16, "model": 16}
MESH3 = {"pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("shape,axes,mesh,want", [
    # divisible dims shard
    ((49152, 576), ("vocab", "embed"), MESH, ("model", "data")),
    # smollm's 9 heads do not divide 16: replicate; head_dim stays None
    ((576, 9, 64), ("embed", "heads", "head_dim"), MESH,
     ("data", None, None)),
    # experts take 'model'; mlp would map to 'model' too: dropped
    ((128, 7168, 4864), ("experts", "embed", "mlp"), MESH,
     ("model", "data", None)),
    # batch over (pod, data); batch 1 replicates
    ((256, 4096), ("batch", "act_seq"), MESH3, (("pod", "data"), None)),
    ((1, 4096), ("batch", "act_seq"), MESH3, (None, None)),
    # batch 16 over pod*data = 32: trailing axes drop until it divides
    ((16, 8), ("batch", None), MESH3, ("pod", None)),
], ids=["divisible", "indivisible", "no-double-use", "batch-pod-data",
        "batch-1", "partial-divisibility"])
def test_spec_for_sanity(shape, axes, mesh, want):
    assert TSH.spec_for(shape, axes, mesh) == want


@pytest.mark.parametrize("arch", ["gemma3-27b", "arctic-480b",
                                  "jamba-1.5-large-398b"])
def test_every_arch_has_sharded_params(arch):
    """Each arch's five biggest parameters shard (storage feasibility)."""
    big = sorted((s for _, s in leaves(TM.model_template(get_config(arch)))),
                 key=lambda s: -int(np.prod(s.shape)))[:5]
    for s in big:
        assert any(e is not None for e in TSH.spec_for(s.shape, s.axes, MESH))


def test_production_mesh_shape():
    from repro_torch.launch.mesh import _validate_axes
    assert production_mesh_shape() == {"data": 16, "model": 16}
    assert production_mesh_shape(True) == {"pod": 2, "data": 16, "model": 16}
    for bad in (0, -1, 2.0, "4", True):
        with pytest.raises(ValueError):
            _validate_axes(model=bad)


# ---------------------------------------------------------------------------
# the analytic cost model
# ---------------------------------------------------------------------------

OPTIONS = [dict(), dict(causal_pairs=True), dict(window_cache=True),
           dict(remat=False), dict(infer_rules=True), dict(seq_parallel=True),
           dict(moe_gather_decode=True), dict(microbatches=4)]


def _padded(cfg, e):
    return dataclasses.replace(cfg, num_experts_padded=e)


def _same_cell(rc, tc, shape, rshape, multi_pod, **kw):
    r = RA.analytic_cell(rc, rshape, multi_pod=multi_pod, **kw)
    t = TA.analytic_cell(tc, shape, multi_pod=multi_pod, **kw)
    _close(t.flops_per_dev, r.flops_per_dev)
    _close(t.hbm_bytes_per_dev, r.hbm_bytes_per_dev)
    _close(t.coll_bytes_per_dev, r.coll_bytes_per_dev)
    assert sorted(t.breakdown) == sorted(r.breakdown)
    for k in r.breakdown:
        _close(t.breakdown[k], r.breakdown[k])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_analytic_matches_reference(arch, mesh):
    """All four shapes of the arch (supported or not), every option of the
    matrix, and the MoE archs with their experts padded to divide the
    model axis; the per-device parameter and cache bytes under every rule
    table; model_flops_for."""
    multi_pod = mesh == "multi_pod"
    sizes = RA._mesh_sizes(multi_pod)
    assert TA._mesh_sizes(multi_pod) == sizes
    variants = [(get_config(arch), ref_config(arch))]
    if get_config(arch).num_experts:
        e = -(-get_config(arch).num_experts // 16) * 16 + 16
        variants.append((_padded(get_config(arch), e),
                         _padded(ref_config(arch), e)))
    for tc, rc in variants:
        for name, shape in SHAPES.items():
            rshape = R_SHAPES[name]
            for kw in OPTIONS:
                _same_cell(rc, tc, shape, rshape, multi_pod, **kw)
            for wc in (False, True):
                _close(TA.kv_cache_bytes(tc, shape, sizes, wc),
                       RA.kv_cache_bytes(rc, rshape, sizes, wc))
            _close(TR.model_flops_for(tc, shape),
                   RR.model_flops_for(rc, rshape))
        for rule in RULES.values():
            _close(TA.params_bytes_per_dev(tc, sizes,
                                           rules=getattr(TSH, rule)),
                   RA.params_bytes_per_dev(rc, sizes,
                                           rules=getattr(RSH, rule)))


def test_one_card_mesh():
    """``mesh=`` prices one device: nothing shards, no collective bytes;
    f32 doubles every byte term but the f32 SSM state and the moments."""
    one = {"pod": 1, "data": 1, "model": 1}
    cfg, shape = get_config("granite-3-2b"), SHAPES["decode_32k"]
    c = TA.analytic_cell(cfg, shape, mesh=one)
    assert c.coll_bytes_per_dev == 0.0
    assert all(v == 0.0 for k, v in c.breakdown.items()
               if k.startswith("coll_"))
    _close(c.breakdown["flops_fwd"], sum(
        op.flops for op in TA._fwd_ops(cfg, shape, causal_half=False)))
    cfg_bytes = 2.0 * sum(np.prod(s.shape)
                          for _, s in leaves(TM.model_template(cfg)))
    _close(c.breakdown["hbm_weights"], cfg_bytes)
    f32 = TA.analytic_cell(cfg, shape, mesh=one, dtype_bytes=4)
    _close(f32.breakdown["hbm_weights"], 2 * cfg_bytes)
    for k in ("hbm_cache", "hbm_acts"):
        _close(f32.breakdown[k], 2 * c.breakdown[k])
    t = get_config("mamba2-780m")
    tr = TA.analytic_cell(t, SHAPES["train_4k"], mesh=one, dtype_bytes=4)
    n = sum(np.prod(s.shape) for _, s in leaves(TM.model_template(t)))
    _close(tr.breakdown["hbm_opt"], n * (4 * 4 + 2 * TA.MOMENT_BYTES))


MESH1 = {"pod": 1, "data": 16, "model": 16}


def test_params_bytes_sharding_sanity():
    # gemma: fully shardable -> close to total/256; smollm: heads/kv
    # replicate but big tensors (vocab, mlp) shard
    g = get_config("gemma3-27b")
    pb = TA.params_bytes_per_dev(g, MESH1)
    total = g.param_counts()["total"] * 2
    assert total / 256 * 0.8 < pb < total / 256 * 3
    s = get_config("smollm-135m")
    assert TA.params_bytes_per_dev(s, MESH1) < \
        s.param_counts()["total"] * 2 / 16


def _analytic_claim(name):
    """The reference's sanity claims on the analytic model
    (``tests/test_analytic.py``), as (value, bound) pairs that must hold
    value < bound (or value == bound for the exact ones)."""
    S = SHAPES
    if name == "inference_rules_store_more":
        g = get_config("gemma3-27b")
        return (TA.params_bytes_per_dev(g, MESH1),
                TA.params_bytes_per_dev(g, MESH1,
                                        rules=TSH.INFERENCE_RULES))
    if name == "arctic_experts_take_data_axis":
        a = get_config("arctic-480b")
        return (TA.params_bytes_per_dev(a, MESH1, rules=TSH.INFERENCE_RULES),
                16e9)
    if name == "window_cache_shrinks_kv":
        g = get_config("gemma3-27b")
        return (TA.kv_cache_bytes(g, S["decode_32k"], MESH1, True),
                0.4 * TA.kv_cache_bytes(g, S["decode_32k"], MESH1, False))
    if name == "causal_pairs_reduce_flops":
        a = get_config("arctic-480b")
        return (TA.analytic_cell(a, S["prefill_32k"],
                                 causal_pairs=True).flops_per_dev,
                0.75 * TA.analytic_cell(a, S["prefill_32k"]).flops_per_dev)
    if name == "seq_parallel_reduces_collectives":
        j = get_config("jamba-1.5-large-398b")
        return (TA.analytic_cell(j, S["train_4k"],
                                 seq_parallel=True).coll_bytes_per_dev,
                0.8 * TA.analytic_cell(j, S["train_4k"]).coll_bytes_per_dev)
    if name == "expert_padding_shards_moe":
        g = get_config("granite-moe-3b-a800m")
        return (TA.analytic_cell(_padded(g, 48), S["train_4k"]).flops_per_dev,
                0.7 * TA.analytic_cell(g, S["train_4k"]).flops_per_dev)
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "inference_rules_store_more", "arctic_experts_take_data_axis",
    "window_cache_shrinks_kv", "causal_pairs_reduce_flops",
    "seq_parallel_reduces_collectives", "expert_padding_shards_moe"])
def test_analytic_sanity(name):
    value, bound = _analytic_claim(name)
    assert value < bound


@pytest.mark.parametrize("hw", [TPU_V5E, H100_SXM], ids=lambda h: h.name)
def test_decode_is_memory_bound(hw):
    """The paper's claim, priced on the TPU constants and on the card's
    data sheet: decode intensity sits far below the ridge."""
    for arch in ("gemma3-27b", "granite-3-2b", "whisper-small"):
        c = TA.analytic_cell(get_config(arch), SHAPES["decode_32k"])
        t_c = c.flops_per_dev / (hw.bf16_tflops * 1e12)
        t_m = c.hbm_bytes_per_dev / (hw.mem_bw_gbs * 1e9)
        assert t_m > 10 * t_c, arch


def test_remat_and_multi_pod_multipliers():
    g = get_config("granite-3-2b")
    with_r = TA.analytic_cell(g, SHAPES["train_4k"], remat=True)
    without = TA.analytic_cell(g, SHAPES["train_4k"], remat=False)
    assert with_r.flops_per_dev / without.flops_per_dev == \
        pytest.approx(4.0 / 3.0, rel=1e-6)
    g = get_config("gemma3-27b")
    sp = TA.analytic_cell(g, SHAPES["train_4k"])
    mp = TA.analytic_cell(g, SHAPES["train_4k"], multi_pod=True)
    assert mp.flops_per_dev == pytest.approx(sp.flops_per_dev / 2, rel=1e-3)


# ---------------------------------------------------------------------------
# report: serving projection and roofline terms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_serving_projection_matches_reference(arch):
    for n in (1, 2, 3, 4, 16):
        for total in (0.0, 3.5e9):
            r = RR.serving_projection(ref_config(arch), n, total)
            t = TR.serving_projection(get_config(arch), n, total)
            assert (t.arch, t.mesh_model, t.heads_sharded) == \
                (r.arch, r.mesh_model, r.heads_sharded)
            for k in ("weight_bytes_per_dev", "cache_bytes_per_dev",
                      "cache_bytes_total", "t_tick_s"):
                _close(getattr(t, k), getattr(r, k))
            h = TR.serving_projection(get_config(arch), n, total,
                                      hardware=H100_SXM)
            _close(h.t_tick_s, r.t_tick_s * TPU_V5E.mem_bw_gbs
                   / H100_SXM.mem_bw_gbs)


@pytest.mark.parametrize("hw", [TPU_V5E, H100_SXM], ids=lambda h: h.name)
def test_roofline_terms_math(hw):
    """The reference's test, scaled to the hardware's constants."""
    peak, bw, link = hw.bf16_tflops * 1e12, hw.mem_bw_gbs * 1e9, \
        hw.ici_gbs * 1e9
    chips = 256
    t = TR.RooflineTerms(arch="x", shape="train_4k", mesh="single_pod",
                         flops_per_dev=peak, bytes_per_dev=bw,
                         coll_bytes_per_dev=link, model_flops=peak * chips,
                         hardware=hw)
    assert t.t_compute == pytest.approx(1.0)
    assert t.t_memory == pytest.approx(1.0)
    assert t.t_collective == pytest.approx(1.0)
    assert t.useful_flops_ratio == pytest.approx(1.0)
    assert t.roofline_fraction == pytest.approx(1.0)
    assert "train_4k" in TR.markdown_table([t])
    if hw is TPU_V5E:
        r = RR.RooflineTerms(arch="x", shape="train_4k", mesh="single_pod",
                             flops_per_dev=3e14, bytes_per_dev=2e12,
                             coll_bytes_per_dev=1e11, model_flops=7e16)
        p = TR.RooflineTerms(arch="x", shape="train_4k", mesh="single_pod",
                             flops_per_dev=3e14, bytes_per_dev=2e12,
                             coll_bytes_per_dev=1e11, model_flops=7e16)
        for k, v in r.row().items():
            assert p.row()[k] == v, k
    one = TR.RooflineTerms(arch="x", shape="s", mesh="one_card",
                           flops_per_dev=peak, bytes_per_dev=0.0,
                           coll_bytes_per_dev=0.0, model_flops=peak,
                           hardware=hw)
    assert (one.n_chips, one.dominant, one.bound_time) == (1, "compute", 1.0)
    assert one.roofline_fraction == pytest.approx(1.0)


def test_h100_is_out_of_the_catalog():
    from repro_torch.core import hardware as TH
    assert H100_SXM.name not in TH.CATALOG
    assert H100_SXM.name not in TH.TABLE1
    assert (H100_SXM.mem_bw_gbs, H100_SXM.bf16_tflops, H100_SXM.hbm_gb) == \
        (3350, 989, 80)
