"""The port's dry run, its FLOP count and its sweep, on the CPU.

- Full-size dry runs on the meta device, one cell per family and kind:
  the row carries the reference's keys and counted collectives, ``to_terms``
  reads it with either pricing, its per-device argument bytes are the
  analytic pricer's parameter bytes plus the inputs', its per-device
  FLOPs lie between the whole step's over the chips and the whole
  step's, and a forward cell's whole-step FLOPs are the analytic model's,
  re-priced where the port computes a different function.
- At reduced size the count of the port's prefill and decode step equals
  the reference's ``hlo.dot_flops`` of an ``unroll_layers=True`` compile,
  plus the vision tower layers the reference's HLO counts once.
- A refused cell, the meta routing of the kernel wrappers, and the sweep
  over one cell (one dry-run subprocess)."""
import ast
import json
import math
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import GLOBAL_WINDOW, SHAPES, get_config
from repro_torch.launch import specs as SP
from repro_torch.launch.dryrun import build_step
from repro_torch.launch.dryrun import main as dryrun_main
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.launch.sweep import main as sweep_main
from repro_torch.models import model as TM
from repro_torch.models.layers import ModelOptions
from repro_torch.models.params import leaves, meta_params
from repro_torch.roofline import analytic as TA
from repro_torch.roofline.counts import COLLECTIVES, count_ops, dot_flops
from repro_torch.roofline.report import to_terms
from repro_torch.training import AdamWConfig, TrainConfig, init_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE = {"pod": 1, "data": 1, "model": 1}
COUNT_REL = 1e-9


def _reference_row_keys():
    """The keys of the row the reference's ``run_cell`` writes, read from
    its source (importing it would ask JAX for 512 host devices)."""
    path = os.path.join(ROOT, "src", "repro", "launch", "dryrun.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "row" and \
                isinstance(node.value, ast.Dict):
            return {k.value for k in node.value.keys}
    raise AssertionError("no row dict in the reference's dryrun.py")


def _recounted(cfg, shape):
    """The analytic forward FLOPs (``flops_fwd`` at a one-device mesh,
    full-S^2 attention) re-priced op by op where the port's plain function
    computes a different set of matrix products:

    - ``lm_head``: the logits of one row per sequence (the last position
      of a prefill, the decoded token), not of every position;
    - ``moe``: every expert's whole capacity buffer, E x C rows with
      C = max(1, ceil(K*T/E_real * 1.25)), not the K*T routed rows;
    - ``conv1d``: elementwise, no matrix product;
    - ``ssd`` at decode: C . h is a product, the state update is
      elementwise (half the analytic term);
    - ``attn`` at decode in a sliding-window layer: the plain decode reads
      the whole cache under a mask, not window + 512 rows.

    Everything else is priced as the analytic model prices it."""
    B, S = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    T = B * (1 if decode else S)
    total = 0.0
    for op in TA._fwd_ops(cfg, shape, causal_half=False):
        f, name = op.flops, op.name
        if name.endswith("/lm_head"):
            f = 2.0 * B * cfg.d_model * cfg.vocab_size
        elif name.endswith("/moe"):
            E = max(cfg.num_experts_padded, cfg.num_experts)
            C = max(1, math.ceil(cfg.top_k * T / cfg.num_experts
                                 * ModelOptions().moe_capacity_factor))
            f = 2.0 * 3 * E * C * cfg.d_model * cfg.moe_d_ff
        elif name.endswith("/conv1d"):
            f = 0.0
        elif name.endswith("/ssd") and decode:
            f = f / 2
        elif name.endswith("/attn") and decode and \
                cfg.layer_window(int(name.split("/")[1][1:])) != GLOBAL_WINDOW:
            f = 2 * 2.0 * B * cfg.num_heads * S * cfg.head_dim
        total += f
    return total


# (arch, shape, the count over the analytic FLOPs at one device: over
# flops_fwd for a forward cell, over flops_per_dev for a train step; the
# raw ratio, stated for the record)
FULL_CELLS = [
    ("qwen1.5-0.5b", "train_4k", 0.953350),        # dense, train
    ("arctic-480b", "decode_32k", 1.115135),       # moe + dense residual
    ("jamba-1.5-large-398b", "long_500k", 2.786252),   # hybrid, B=1
    ("internvl2-1b", "prefill_32k", 0.928690),     # vlm
    ("whisper-small", "decode_32k", 1.0),          # encoder-decoder
]


def _step_flops(cfg, shape):
    """The whole step's matrix-product FLOPs (``dot_flops``) of the cell
    as the dry run builds it, unpartitioned on the meta device."""
    opts, tcfg = ModelOptions(), TrainConfig(opt=AdamWConfig())
    fn, order = build_step(cfg, shape, opts, tcfg)
    params = SP.model_specs_and_placements(cfg, ONE)[0]
    inputs = SP.input_specs(cfg, shape, opts)
    args = [params if n == "params" else
            init_train_state(cfg, tcfg, params) if n == "opt_state" else
            inputs[n] for n in order]
    return dot_flops(fn, *args)[0]


@pytest.mark.parametrize("arch,shape,ratio", FULL_CELLS,
                         ids=[f"{a}-{s}" for a, s, _ in FULL_CELLS])
def test_full_size_meta_dry_run(arch, shape, ratio):
    row = run_cell(arch, shape, verbose=False)
    assert set(row) == _reference_row_keys()
    assert set(row["cost"]) == {"flops"}
    assert set(row["memory"]) == {"argument_size_in_bytes",
                                  "output_size_in_bytes"}
    coll = row["collectives"]
    assert set(coll) <= set(COLLECTIVES) | {"total"}
    assert coll["total"] == sum(v for k, v in coll.items()
                                if k != "total") > 0
    assert row["t_compile_s"] > 0
    t = to_terms(row)
    assert t.flops_per_dev == row["analytic"]["flops_per_dev"] > 0
    assert t.bound_time > 0
    counted_t = to_terms(row, use_analytic=False)
    assert counted_t.coll_bytes_per_dev == coll["total"]
    assert counted_t.flops_per_dev == row["cost"]["flops"]
    assert counted_t.t_collective > 0 and counted_t.bound_time > 0
    with pytest.raises(ValueError, match="no counted collective bytes"):
        to_terms(dict(row, collectives=None), use_analytic=False)

    cfg, sh = get_config(arch), SHAPES[shape]
    mesh = production_mesh_shape()
    # per-device argument bytes: the parameters as the analytic pricer
    # shards them, plus the inputs' own placements
    params_b = TA.params_bytes_per_dev(cfg, mesh, 2)
    inputs = SP.input_specs(cfg, sh)
    places = SP.input_placements(cfg, sh, mesh)
    in_b = sum(SP.tree_bytes_per_dev(inputs[k], places[k], mesh)
               for k in inputs)
    if sh.kind == "train":   # f32 moments, an int32 step count
        in_b += 2 * TA.params_bytes_per_dev(cfg, mesh, 4) + 4
    assert row["memory"]["argument_size_in_bytes"] == \
        pytest.approx(params_b + in_b, rel=1e-12)

    counted = _step_flops(cfg, sh)
    chips = math.prod(mesh.values())
    assert counted / chips <= row["cost"]["flops"] <= counted
    one = TA.analytic_cell(cfg, sh, mesh=ONE)
    if sh.kind != "train":
        assert counted / one.breakdown["flops_fwd"] == \
            pytest.approx(ratio, rel=1e-6)
        assert counted == pytest.approx(_recounted(cfg, sh), rel=COUNT_REL)
    else:
        # the analytic step is 4 x the forward (the backward twice, remat
        # once); the count's lm_head runs 3 x (no remat) and its written-out
        # attention backward takes its own products: within 10%
        assert counted / one.flops_per_dev == pytest.approx(ratio,
                                                            rel=1e-6)
        assert 0.9 < counted / one.flops_per_dev < 1.1


def test_refused_cell_has_the_reference_reason():
    from repro.configs import SHAPES as R_SHAPES
    from repro.configs import get_config as ref_config
    from repro.configs import shape_supported as r_supported
    row = run_cell("smollm-135m", "long_500k", verbose=False)
    ok, why = r_supported(ref_config("smollm-135m"), R_SHAPES["long_500k"])
    assert not ok
    assert row == {"arch": "smollm-135m", "shape": "long_500k",
                   "skipped": why}


# ---------------------------------------------------------------------------
# the FLOP count against the reference's unrolled HLO
# ---------------------------------------------------------------------------

B, TOTAL = 2, 32


def _tower_layer_dots(cfg, B):
    """One vision-tower layer's dot FLOPs: the reference's tower is a
    ``lax.scan`` that ``unroll_layers`` leaves rolled, so its HLO counts the
    body once for all ``num_layers``."""
    v = cfg.vision
    T, d, f, n = v.num_tokens, v.d_model, v.d_ff, v.num_heads
    return (2 * B * T * d * 3 * d + 2 * B * T * d * d + 2 * 2 * B * T * d * f
            + 2 * 2 * B * n * T * T * (d // n))


@pytest.fixture(scope="module")
def ref_counts():
    """The reference's unrolled-compile dot counts of prefill and decode,
    by arch (one compile each)."""
    from repro.configs import get_config as ref_config
    from repro.models import model as RM
    from repro.models.layers import ModelOptions as RO
    from repro.models.params import param_shapes
    from repro.roofline import hlo
    out = {}
    opts = RO(unroll_layers=True)
    for arch in PARITY_ARCHS:
        cfg = ref_config(arch).reduced()
        p = param_shapes(RM.model_template(cfg), jnp.float32)
        nv = cfg.vision.num_tokens if cfg.vision else 0
        batch = {"tokens": jax.ShapeDtypeStruct((B, TOTAL - nv), jnp.int32)}
        if cfg.vision:
            batch["patches"] = jax.ShapeDtypeStruct(
                (B, nv, cfg.vision.embed_dim), jnp.float32)
        pre = jax.jit(lambda p, b: RM.prefill(
            cfg, opts, p, b, TOTAL, cache_dtype=jnp.float32)).lower(
            p, batch).compile().as_text()
        caches = jax.eval_shape(
            lambda: RM.init_caches(cfg, B, TOTAL, jnp.float32))
        dec = jax.jit(lambda p, t, c, i: RM.decode_step(
            cfg, opts, p, t, c, i)).lower(
            p, jax.ShapeDtypeStruct((B, 1), jnp.int32), caches,
            jax.ShapeDtypeStruct((), jnp.int32)).compile().as_text()
        out[arch] = {"prefill": hlo.dot_flops(pre)[0],
                     "decode": hlo.dot_flops(dec)[0]}
    return out


PARITY_ARCHS = ["molmoact-7b", "granite-moe-3b-a800m", "mamba2-780m"]


def _port_step(cfg, kind):
    p = meta_params(TM.model_template(cfg), torch.float32)
    opts = ModelOptions()
    meta = torch.device("meta")
    if kind == "prefill":
        nv = cfg.vision.num_tokens if cfg.vision else 0
        batch = {"tokens": torch.empty(B, TOTAL - nv, dtype=torch.int32,
                                       device=meta)}
        if cfg.vision:
            batch["patches"] = torch.empty(B, nv, cfg.vision.embed_dim,
                                           device=meta)
        return lambda: TM.prefill(cfg, opts, p, batch, TOTAL,
                                  cache_dtype=torch.float32, device=meta)
    caches = TM.init_caches(cfg, B, TOTAL, torch.float32, opts, device=meta)
    tok = torch.empty(B, 1, dtype=torch.int32, device=meta)
    idx = torch.empty((), dtype=torch.int32, device=meta)
    return lambda: TM.decode_step(cfg, opts, p, tok, caches, idx,
                                  device=meta)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_dot_flops_match_reference_unrolled(arch, kind, ref_counts):
    cfg = get_config(arch).reduced()
    counted, top = dot_flops(_port_step(cfg, kind), top=3)
    want = ref_counts[arch][kind]
    if kind == "prefill" and cfg.vision is not None:
        want += (cfg.vision.num_layers - 1) * _tower_layer_dots(cfg, B)
    assert counted == pytest.approx(want, rel=COUNT_REL)
    assert len(top) == 3 and top[0][0] >= top[1][0] >= top[2][0]
    assert top[0][1].startswith("aten.")
    # the same formulas as torch's own FlopCounterMode
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as m:
        _port_step(cfg, kind)()
    assert m.get_total_flops() == counted


def test_count_ops_counts_one_aten_op():
    a = torch.empty(3, 4, device="meta")
    b = torch.empty(4, 5, device="meta")

    def f():
        return a @ b, torch.einsum("ij,jk->ik", a, b), a @ b
    assert count_ops(f, opname="mm") == 2
    assert count_ops(f, opname="aten.bmm") == 1
    assert dot_flops(f)[0] == 3 * 2 * 3 * 4 * 5


# ---------------------------------------------------------------------------
# the meta device and the kernel wrappers
# ---------------------------------------------------------------------------

def test_meta_device_routing():
    from repro_torch.kernels import runs_plain
    from repro_torch.kernels.decode_attention.ops import decode_attention
    assert resolve_device("meta").type == "meta"
    with pytest.raises(ValueError):
        resolve_device("mps")
    meta = torch.device("meta")
    q = torch.empty(2, 4, 16, device=meta)
    k = torch.empty(2, 40, 2, 16, device=meta)
    out = decode_attention(q, k, k, 7)
    assert out.device.type == "meta" and out.shape == (2, 4, 16)
    assert runs_plain(q) and runs_plain(q.new_empty(1, device="cpu"))

    class Elsewhere:
        device = torch.device("xla")
    with pytest.raises(ValueError, match="unsupported device"):
        runs_plain(Elsewhere())
    params = meta_params(TM.model_template(get_config("smollm-135m")))
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
               for _, t in leaves(params))


def test_sweep_one_cell(tmp_path, capsys):
    """The sweep over one supported cell (one ``python -m
    repro_torch.launch.dryrun`` subprocess) and one refused: the row
    written, the refused cell skipped, the summary and the exit code; a
    second sweep finds the row and runs nothing; the CLI in-process gives
    the subprocess's count."""
    args = ["--out", str(tmp_path), "--meshes", "single_pod", "--archs",
            "whisper-small", "--shapes", "decode_32k,long_500k"]
    assert sweep_main(args) == 0, capsys.readouterr().out[-2000:]
    row = json.loads((tmp_path / "whisper-small__decode_32k__single_pod"
                      ".json").read_text())
    assert row["cost"]["flops"] > 0 and row["mesh"] == "single_pod"
    assert row["collectives"]["total"] > 0
    summary = json.loads((tmp_path / "_sweep_summary.json").read_text())
    assert [s[:2] for s in summary["skipped"]] == \
        [["whisper-small", "long_500k"]]
    assert summary["failed"] == [] and len(summary["ok"]) == 1
    assert sweep_main(args) == 0
    summary = json.loads((tmp_path / "_sweep_summary.json").read_text())
    assert summary["ok"] == [["whisper-small", "decode_32k", "single_pod",
                              "cached"]]
    assert dryrun_main(["--arch", "whisper-small", "--shape", "decode_32k",
                        "--out", str(tmp_path), "--tag", "again"])[
        "cost"]["flops"] == row["cost"]["flops"]
