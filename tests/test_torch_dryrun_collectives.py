"""The dry run's collective bytes (``roofline.counts.CollectiveCounter``
over a step traced as DTensors on a fake mesh), on the CPU.

- The counter on hand-placed products over a fake 2 x 4 mesh: the FSDP
  weight gathers, the row-parallel all-reduce, an all-to-all and the
  backward's reduce-scatters, by their result bytes on one device.
- Exact against the port's own sharded engine: the traced decode step of
  reduced molmoact-7b (and smollm-135m's replication fallback) on a
  ('model',) mesh with ``serving_rules`` gives the bytes that
  ``ShardGroup.counts()`` records, by ``tests/test_torch_sharded.py``'s
  formula.
- Against the reference: its ``build_step`` compiled for a 2 x 4 mesh of
  host devices in a subprocess (``hlo.collective_bytes``), with its
  layers unrolled so that its HLO holds every layer's collectives as the
  port's trace issues them (a scanned stack's body counts once), beside
  the port's trace with every floating tensor in f32, the type the
  reference's CPU compile moves its bf16 tensors in. Totals within 0.5-2x,
  the kinds both must issue non-zero.
- ``constrain`` is the identity on plain tensors and without a mesh; the
  fake mesh leaves no process group behind; placed argument bytes are the
  DTensors' local shapes.

``python tests/test_torch_dryrun_collectives.py`` prints the comparison
table: the port in bf16 and f32, the reference scanned and unrolled.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch.dryrun import (serving_decode_collectives,
                                       step_collectives)
from repro_torch.launch.mesh import (fake_device_mesh, make_serving_mesh,
                                     production_mesh_shape)
from repro_torch.roofline.counts import CollectiveCounter
from repro_torch.training import AdamWConfig, TrainConfig, init_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = {"data": 2, "model": 4}
SHAPE = {"decode": "decode_32k", "prefill": "prefill_32k",
         "train": "train_4k"}
STEPS = [("molmoact-7b", "decode"), ("molmoact-7b", "prefill"),
         ("molmoact-7b", "train"), ("granite-moe-3b-a800m", "decode")]
# kinds the port must issue beyond the FSDP weight all-gathers and the
# model-axis all-reduces that both programs issue in every step: a train
# step's gradient reductions (the reference reduces its gradients with
# all-reduces, the port its FSDP gradients with reduce-scatters) and the
# MoE step's all-to-all (both have one)
PORT_KINDS = {("molmoact-7b", "train"): ("reduce-scatter",),
              ("granite-moe-3b-a800m", "decode"): ("all-to-all",)}


def _shape(kind):
    return dataclasses.replace(SHAPES[SHAPE[kind]], seq_len=128,
                               global_batch=8)


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

def _placed(mesh, shape, placements, grad=False):
    """A DTensor of global ``shape`` (f32 shards on the meta device)."""
    from torch.distributed.tensor import DTensor
    local = list(shape)
    for m, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.size(m)
    t = DTensor.from_local(torch.empty(local, device="meta"), mesh,
                           placements, run_check=False)
    return t.detach().requires_grad_(grad)


def test_counter_on_hand_placed_products():
    """x [8, 16] batch-sharded over data; w1 [16, 32] FSDP over data and
    column-parallel over model; w2 [32, 16] row-parallel over model and
    FSDP over data on its output dim. Forward: both weights gathered over
    data ([16, 8] and [8, 16] f32), one all-reduce of the [4, 16] partial
    sums, then an all-to-all of z to its width ([8, 8]). Backward: each
    weight's gradient reduce-scattered back to its shard ([8, 8])."""
    from torch.distributed.tensor import Replicate, Shard
    with fake_device_mesh(DEV) as mesh, SH.global_mesh(mesh):
        x = _placed(mesh, (8, 16), (Shard(0), Replicate()))
        w1 = _placed(mesh, (16, 32), (Shard(0), Shard(1)), grad=True)
        w2 = _placed(mesh, (32, 16), (Shard(1), Shard(0)), grad=True)
        with CollectiveCounter() as fwd:
            z = SH.constrain(SH.dense(SH.dense(x, w1), w2), "batch",
                             "act_embed")
            assert z.placements == (Shard(0), Replicate())
            z.redistribute(placements=(Shard(1), Replicate()))
        with CollectiveCounter() as bwd:
            z.sum().backward()
        assert w1.grad.placements == w1.placements
        assert w2.grad.placements == w2.placements
    f32 = 4
    assert fwd.counts() == {"all-gather": (16 * 8 + 8 * 16) * f32,
                            "all-reduce": 4 * 16 * f32,
                            "all-to-all": 8 * 8 * f32,
                            "total": (16 * 8 + 8 * 16 + 64 + 64) * f32}
    assert bwd.bytes["reduce-scatter"] == 2 * 8 * 8 * f32
    assert [c[0] for c in fwd.calls] == ["all-gather", "all-gather",
                                         "all-reduce", "all-to-all"]


def test_counter_refuses_an_unknown_collective():
    import torch.distributed._functional_collectives as funcol
    with fake_device_mesh(DEV) as mesh:
        with CollectiveCounter() as c, pytest.raises(NotImplementedError,
                                                     match="no kind"):
            funcol.broadcast(torch.empty(4, device="meta"), 0, (mesh, 1))
    assert c.counts() == {"total": 0.0}


def test_fake_mesh_leaves_other_groups_alone():
    """A serving mesh's group (not the default group) works before and
    after a fake mesh; the fake mesh refuses a process that has a default
    group, and leaves none behind."""
    import torch.distributed as dist
    serving = make_serving_mesh(1)
    t = torch.ones(3)
    serving.group.all_reduce_sum(t)
    assert not dist.is_initialized()
    with fake_device_mesh(production_mesh_shape(multi_pod=True)) as mesh:
        assert mesh.size() == 512 and mesh.mesh_dim_names == (
            "pod", "data", "model")
        with pytest.raises(RuntimeError, match="child process"):
            with fake_device_mesh(DEV):
                pass
    assert not dist.is_initialized()
    assert torch.equal(serving.group.all_reduce_sum(t), torch.ones(3))
    assert serving.group.counts()["all-reduce"] == 2 * 3 * 4


# ---------------------------------------------------------------------------
# exact against the sharded serving engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,n", [("molmoact-7b", 2), ("smollm-135m", 4)])
def test_serving_decode_equals_shard_group_counts(name, n):
    """The bytes ``ShardGroup`` counts for one fused decode step of the
    sharded engine (``test_torch_sharded``'s formula, which its engine
    tests hold to the counts): 2 slots, f32 activations."""
    from test_torch_sharded import ENGINE, _step_formula
    cfg = get_config(name).reduced()
    got = serving_decode_collectives(cfg, n, ENGINE["n_slots"],
                                     ENGINE["max_seq"])
    want = _step_formula(cfg, ENGINE["n_slots"], n)
    assert got == {**want, "total": want["all-reduce"] + want["all-gather"]}


def test_serving_decode_at_phase_12_width():
    """molmoact-7b at full width on its first 10 layers, 8 bf16 slots on
    model=2: what chip_smoke.py's phase 12 counts on the card."""
    cfg = dataclasses.replace(get_config("molmoact-7b"), num_layers=10)
    assert serving_decode_collectives(cfg, 2, 8, 864, torch.bfloat16) == {
        "all-reduce": 1_204_224.0, "all-gather": 2_433_024.0,
        "total": 3_637_248.0}


# ---------------------------------------------------------------------------
# against the reference's compiled HLO
# ---------------------------------------------------------------------------

REF_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import jax
    jax.devices()   # 8 host devices, before the reference's dryrun module
    from repro.configs import SHAPES, get_config
    from repro.distributed.sharding import DEFAULT_RULES, global_mesh
    from repro.launch import specs as SP
    from repro.launch.dryrun import build_step
    from repro.launch.mesh import make_dev_mesh
    from repro.models.layers import ModelOptions
    from repro.roofline.hlo import collective_bytes
    from repro.training import AdamWConfig, TrainConfig, init_train_state

    def compile_step(arch, kind, unroll):
        cfg = get_config(arch).reduced()
        shape = dataclasses.replace(SHAPES[kind], seq_len=128,
                                    global_batch=8)
        opts = ModelOptions(unroll_layers=unroll)
        tcfg = TrainConfig(opt=AdamWConfig())
        mesh = make_dev_mesh(2, 4)
        with global_mesh(mesh, rules=DEFAULT_RULES):
            p, psh = SP.model_specs_and_shardings(cfg, mesh)
            ins = SP.input_specs(cfg, shape, opts)
            insh = SP.input_shardings(cfg, shape, mesh, opts)
            fn, order, donate = build_step(cfg, shape, opts, tcfg)
            args, shs = [], []
            for n in order:
                if n == "params":
                    args.append(p), shs.append(psh)
                elif n == "opt_state":
                    repl = jax.sharding.NamedSharding(
                        mesh, jax.sharding.PartitionSpec())
                    args.append(jax.eval_shape(
                        lambda q: init_train_state(cfg, tcfg, q), p))
                    shs.append({"inner": {"mu": psh, "nu": psh,
                                          "count": repl}})
                else:
                    args.append(ins[n]), shs.append(insh[n])
            hlo = jax.jit(fn, in_shardings=tuple(shs),
                          donate_argnums=donate).lower(*args).compile()
        return collective_bytes(hlo.as_text())

    steps, unrolls = json.loads(sys.argv[1]), json.loads(sys.argv[2])
    print(json.dumps([[compile_step(a, k, u) for u in unrolls]
                      for a, k in steps]))
""")


def reference_counts(unrolls=(True,)):
    """The reference's collective bytes of each of STEPS, one dict per
    entry of ``unrolls`` (``ModelOptions.unroll_layers``), compiled in a
    process of its own that asks for 8 host devices before JAX loads."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    steps = [(a, SHAPE[k]) for a, k in STEPS]
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, json.dumps(steps),
                        json.dumps(list(unrolls))], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def port_counts(arch, kind, dtype=None):
    cfg = get_config(arch).reduced()
    return step_collectives(cfg, _shape(kind), DEV, dict(SH.DEFAULT_RULES),
                            dtype=dtype)[0]


@pytest.fixture(scope="module")
def reference():
    return {s: c[0] for s, c in zip(STEPS, reference_counts())}


@pytest.mark.parametrize("arch,kind", STEPS,
                         ids=[f"{a}-{k}" for a, k in STEPS])
def test_collectives_against_reference_hlo(arch, kind, reference):
    ref = reference[(arch, kind)]
    got = port_counts(arch, kind, torch.float32)
    print(f"\n{arch} {kind}: port {got}\n  reference {ref}")
    assert 0.5 <= got["total"] / ref["total"] <= 2.0
    for k in ("all-gather", "all-reduce"):
        assert ref.get(k, 0) > 0 and got.get(k, 0) > 0, k
    for k in PORT_KINDS.get((arch, kind), ()):
        assert got.get(k, 0) > 0, k
    if (arch, kind) == ("granite-moe-3b-a800m", "decode"):
        assert ref["all-to-all"] > 0


# ---------------------------------------------------------------------------
# constrain, and the placed argument bytes
# ---------------------------------------------------------------------------

def test_constrain_is_the_identity_off_dtensors():
    """On plain tensors, with a DeviceMesh active or none; a DTensor is
    pinned to its axes' placements."""
    from torch.distributed.tensor import Replicate, Shard
    x = torch.arange(8.0).reshape(2, 4)
    assert SH.constrain(x, "batch", "act_mlp") is x
    with SH.global_mesh(DEV):
        assert SH.constrain(x, "batch", "act_mlp") is x
    with fake_device_mesh(DEV) as mesh, SH.global_mesh(mesh):
        assert SH.constrain(x, "batch", "act_mlp") is x
        d = _placed(mesh, (2, 4), (Replicate(), Replicate()))
        assert SH.constrain(d, "batch", "act_mlp").placements == (
            Shard(0), Shard(1))


def test_engine_step_unchanged_without_a_mesh():
    """A reduced serving engine's greedy streams with no mesh, where every
    ``constrain`` site and ``dense`` product is the plain op: equal to the
    reference engine's (``test_torch_serving``'s check)."""
    from test_torch_serving import (MIXED, _requests, assert_same_run,
                                    port_params, run_port, run_ref)
    assert SH.get_mesh() is None
    name = "smollm-135m"
    reqs = _requests(port_params(name)[0], 5, MIXED[:3])
    assert_same_run(run_port(name, reqs), run_ref(name, reqs))


@pytest.mark.parametrize("arch,shape", [("qwen1.5-0.5b", "train_4k"),
                                        ("jamba-1.5-large-398b",
                                         "long_500k")])
def test_argument_bytes_are_the_dtensors_local_shapes(arch, shape):
    """The dry run's per-device argument bytes (``tree_bytes_per_dev`` of
    the ``spec_for`` tuples) equal the local shapes of the DTensors its
    partitioned trace places on the production mesh."""
    cfg, sh = get_config(arch), SHAPES[shape]
    sizes = production_mesh_shape()
    rules = dict(SH.DEFAULT_RULES)
    params, params_pl = SP.model_specs_and_placements(cfg, sizes,
                                                      rules=rules)
    inputs = SP.input_specs(cfg, sh)
    in_pl = SP.input_placements(cfg, sh, sizes, rules=rules)
    want = SP.tree_bytes_per_dev(params, params_pl, sizes) + sum(
        SP.tree_bytes_per_dev(inputs[k], in_pl[k], sizes) for k in inputs)
    tcfg = TrainConfig(opt=AdamWConfig())
    if sh.kind == "train":   # f32 moments (twice bf16), an int32 count
        want += 2 * 2 * SP.tree_bytes_per_dev(params, params_pl, sizes) + 4
    with fake_device_mesh(sizes) as mesh:
        placed = [SP.as_dtensors(params, params_pl, mesh)] + [
            SP.as_dtensors(inputs[k], in_pl[k], mesh) for k in inputs]
        if sh.kind == "train":
            placed.append(init_train_state(cfg, tcfg, placed[0]))

        def local_bytes(tree):
            if isinstance(tree, dict):
                return sum(local_bytes(v) for v in tree.values())
            t = tree.to_local() if SH.is_dtensor(tree) else tree
            return t.numel() * t.element_size()
        got = sum(local_bytes(t) for t in placed)
    assert got == want


# ---------------------------------------------------------------------------

if __name__ == "__main__":
    # the comparison table: port bf16 / f32 beside the reference scanned
    # and unrolled (PYTHONPATH=src JAX_PLATFORMS=cpu python tests/...)
    ref = reference_counts((False, True))
    for (arch, kind), (scanned, unrolled) in zip(STEPS, ref):
        bf16, f32 = (port_counts(arch, kind, d)
                     for d in (None, torch.float32))
        print(json.dumps({"arch": arch, "step": kind, "port_bf16": bf16,
                          "port_f32": f32, "reference_scanned": scanned,
                          "reference_unrolled": unrolled,
                          "f32_over_unrolled": f32["total"]
                          / unrolled["total"]}))
