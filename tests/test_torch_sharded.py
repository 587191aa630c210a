"""Sharded serving of the port (``ServingEngine(mesh=...)``) on the CPU.

Every mesh here is gloo over CPU tensors, its ranks spawned processes
meeting through a ``FileStore`` under the test's temporary directory (no
TCP port, so xdist workers never collide). One 2-rank group serves every
2-rank case and one 4-rank group the replication fallback: engines follow
one another on a group (``close(workers=False)``), and the fault cases
come last, since they end their group. Each group's collectives time out
on their own (60 s), so a hung rank fails its test.

Weights are the port's seeded draw of each reduced config: smollm's drawn
by every rank (``SeededWeights``), molmoact's loaded from an ``.npz``
through ``from_jax``'s mapping (``ArrayWeights``); the reference engine
gets the same values. Requests and layouts are
``tests/test_torch_serving.py``'s.
Greedy streams must equal the port's unsharded engine (itself held to the
reference there), and the paged case also the reference's unsharded
engine; one decode step's logits agree within 1e-5 x max(1, |unsharded|);
one rank's cache bytes are half the pool's when the KV heads shard and all
of it when they replicate; a fused decode step's counted collective bytes
equal the layout's formula exactly.
"""
import asyncio
import os
import signal
import subprocess
import sys
import textwrap
import time
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import ModelOptions as JOpts
from repro.serving import Request as JReq
from repro.serving import ServingEngine as JEngine
from repro_torch.checkpoint import elastic_shrink
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.collectives import KINDS, ShardWorkerError
from repro_torch.kernels import _build
from repro_torch.launch import serve
from repro_torch.launch.mesh import (Mesh, make_dev_mesh, make_elastic_mesh,
                                     make_serving_mesh)
from repro_torch.models import model as TM
from repro_torch.models.layers import ModelOptions
from repro_torch.models.params import PSpec, map_tree
from repro_torch.roofline.report import to_terms
from repro_torch.serving import AsyncFrontend, Request, ServingEngine
from repro_torch.serving.sharded import (ArrayWeights, SeededWeights,
                                         save_arrays, spawn_mesh)
from test_torch_serving import LAYOUTS, MIXED, _requests, assert_same_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("smollm-135m", "molmoact-7b")
ENGINE = dict(n_slots=2, max_seq=48, eos=-999, tick_tokens=4)
CHUNKED = dict(paged=True, page_size=8, chunked_prefill=True, chunk_size=8,
               token_budget=24)
# (arch, engine options, vision patches with each observation twice)
CASES = {
    "smollm-dense": ("smollm-135m", {}, False),
    "smollm-paged-f32": ("smollm-135m", LAYOUTS["paged-bf16"], False),
    "smollm-int8-head": ("smollm-135m", LAYOUTS["int8-head"], False),
    "smollm-chunked-paged": ("smollm-135m", CHUNKED, False),
    "smollm-spec-int8-draft": ("smollm-135m", dict(
        LAYOUTS["paged-bf16"], spec_decode=True, spec_k=4,
        draft_quant="int8"), False),
    "molmoact-paged-f32": ("molmoact-7b", LAYOUTS["paged-bf16"], True),
    "molmoact-chunked-paged": ("molmoact-7b", CHUNKED, True),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Rank 0 on one intra-op thread, as the workers are: idle OpenMP
    threads spinning beside a rank that waits on a collective cost a
    reduced engine several times its compute."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("weights") / "molmoact.npz")
    cfg = get_config("molmoact-7b").reduced()
    save_arrays(path, SeededWeights(1)(cfg, "cpu"))
    return {"smollm-135m": SeededWeights(0),
            "molmoact-7b": ArrayWeights(path)}


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """Every group of the module, their workers started at once: the
    2-rank and 4-rank groups, and two 2-rank groups for the front end's
    replicas."""
    d = tmp_path_factory.mktemp("meshes")
    with ThreadPoolExecutor(4) as pool:
        out = list(pool.map(lambda n: spawn_mesh(n, store_dir=d,
                                                 timeout=60.0), (2, 4, 2, 2)))
    yield out
    for mesh in out:
        for p in mesh.workers:      # a fault case may have ended a worker
            if p.is_alive():
                p.kill()
            p.join()


@pytest.fixture(scope="module")
def mesh2(meshes):
    return meshes[0]


@pytest.fixture(scope="module")
def mesh4(meshes):
    return meshes[1]


def _engine(name, weights, mesh=None, **kw):
    cfg = get_config(name).reduced()
    w = weights[name]
    return ServingEngine(cfg, ModelOptions(), w if mesh else w(cfg, "cpu"),
                         mesh=mesh, device="cpu", **ENGINE, **kw)


def _serve(eng, reqs):
    for i, (prompt, m, px) in enumerate(reqs):
        eng.submit(Request(uid=i, prompt=prompt.copy(), max_tokens=m,
                           patches=px))
    done = eng.run()
    assert len(done) == len(reqs)
    return {r.uid: r.out_tokens for r in done}


def _reqs(name, patches):
    cfg = get_config(name).reduced()
    return _requests(cfg, 2, MIXED[:4] if patches else MIXED,
                     patches=patches, repeat=patches)


# ---------------------------------------------------------------- 2 ranks

@pytest.mark.parametrize("case", list(CASES))
def test_sharded_streams_equal_unsharded(case, weights, mesh2):
    name, kw, patches = CASES[case]
    reqs = _reqs(name, patches)
    want = _serve(_engine(name, weights, **kw), reqs)
    eng = _engine(name, weights, mesh2, **kw)
    try:
        got = _serve(eng, reqs)
    finally:
        eng.close(workers=False)
    assert got == want
    st = eng.stats
    assert st.mesh_shape == (("model", 2),)
    rep = st.phase_report()
    assert rep["mesh_model"] == 2.0
    if kw.get("paged"):
        # 2 KV heads over model=2: each rank holds half of every page
        assert st.cache_bytes_hwm_shard * 2 == st.cache_bytes_hwm > 0
        assert rep["cache_bytes_hwm_shard"] == float(st.cache_bytes_hwm_shard)
        assert rep["pages_in_use_shard"] == rep["pages_in_use"]


def test_sharded_paged_matches_reference(weights, mesh2):
    """The paged case held straight against the reference's unsharded
    engine on the same weights: streams and the reference's counters."""
    name, kw = "smollm-135m", LAYOUTS["paged-bf16"]
    # one prompt length: the reference compiles a prefill for each
    reqs = _requests(get_config(name).reduced(), 2,
                     [(6, m) for _, m in MIXED])
    eng = _engine(name, weights, mesh2, **kw)
    try:
        got = _serve(eng, reqs)
    finally:
        eng.close(workers=False)
    cfg = get_config(name).reduced()
    jparams = map_tree(lambda t: jnp.asarray(t.numpy()),
                       weights[name](cfg, "cpu"))
    ref = JEngine(cfg, JOpts(remat=False), jparams, **ENGINE, **kw)
    for i, (prompt, m, px) in enumerate(reqs):
        ref.submit(JReq(uid=i, prompt=prompt.copy(), max_tokens=m,
                        patches=px))
    want = {r.uid: r.out_tokens for r in ref.run()}
    assert_same_run((got, eng), (want, ref))


def _admitted(name, weights, mesh=None, **kw):
    """An engine whose two slots hold decoding requests (one tick run)."""
    eng = _engine(name, weights, mesh, **kw)
    cfg = get_config(name).reduced()
    for i, (prompt, _, px) in enumerate(_requests(
            cfg, 5, MIXED[:2], patches=cfg.vision is not None)):
        eng.submit(Request(uid=i, prompt=prompt, max_tokens=30, patches=px))
    eng.step_fused()
    return eng


def _decode(eng):
    pt = eng._decode_page_table() if eng.paged else None
    return eng._dev("decode", eng.tokens, eng.index, pt)


def test_sharded_decode_logits_match(weights, mesh2):
    want = _decode(_admitted("molmoact-7b", weights))
    eng = _admitted("molmoact-7b", weights, mesh2)
    try:
        got = _decode(eng)
    finally:
        eng.close(workers=False)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert (got - want).abs().max() <= 1e-5 * max(1.0, want.abs().max())


def _step_formula(cfg, B, n):
    """Counted bytes of one fused decode step at f32 activations and
    logits: an all-reduce of [B, 1, D] after each layer's attention when
    the heads shard and after its MLP when the width does, one after the
    embedding when the vocab shards, and one all-gather of [B, 1, V]."""
    rules = SH.serving_rules(n, cfg.num_heads, cfg.num_kv_heads)
    per_layer = ((rules["heads"] is not None)
                 + (cfg.d_ff % n == 0))
    vocab = cfg.vocab_size % n == 0
    act = B * cfg.d_model * 4
    return {"all-reduce": float(cfg.num_layers * per_layer * act
                                + vocab * act),
            "all-gather": float(B * cfg.vocab_size * 4 * vocab)}


def _tick_bytes(eng, mesh):
    """Counted bytes of a one-step fused tick on rank 0."""
    mesh.group.reset_counts()
    pt = eng._decode_page_table() if eng.paged else None
    done = np.asarray([s is None for s in eng.slots])
    eng._dev("tick", eng.tokens, eng.index, eng.budget, done, eng.keys, pt,
             1)
    return mesh.group.counts()


def test_collective_bytes_of_a_decode_step(weights, mesh2):
    cfg = get_config("molmoact-7b").reduced()
    eng = _admitted("molmoact-7b", weights, mesh2, **LAYOUTS["paged-bf16"])
    try:
        got = _tick_bytes(eng, mesh2)
        # the timing switch: seconds by kind, and the same counts
        mesh2.group.seconds = dict.fromkeys(KINDS, 0.0)
        assert _tick_bytes(eng, mesh2) == got
        timed = mesh2.group.seconds
    finally:
        mesh2.group.seconds = None
        eng.close(workers=False)
    assert all(timed[k] > 0 for k in KINDS)
    want = _step_formula(cfg, ENGINE["n_slots"], 2)
    assert want["all-reduce"] == (2 * 4 + 1) * 2 * 64 * 4
    assert got == {**want, "total": want["all-reduce"] + want["all-gather"]}
    # the counts price through the roofline as a row's collectives
    row = {"arch": cfg.name, "shape": "decode", "mesh": "model=2",
           "cost": {"flops": 1e6, "bytes accessed": 1e6},
           "collectives": got, "model_flops": 1e6, "memory": {}}
    t = to_terms(row, use_analytic=False)
    assert t.coll_bytes_per_dev == got["total"] and t.t_collective > 0
    with pytest.raises(ValueError, match="no counted collective bytes"):
        to_terms(dict(row, collectives=None), use_analytic=False)


# ---------------------------------------------------------------- 4 ranks

def test_replication_fallback_at_model_4(weights, mesh4):
    """2 KV heads over model=4 replicate (with the query heads, GQA-
    atomic); the MLP width and the vocab still shard."""
    name, kw = "smollm-135m", LAYOUTS["paged-bf16"]
    reqs = _reqs(name, False)
    want = _serve(_engine(name, weights, **kw), reqs)
    eng = _engine(name, weights, mesh4, **kw)
    try:
        got = _serve(eng, reqs)
    finally:
        eng.close(workers=False)
    assert got == want
    assert eng.stats.cache_bytes_hwm_shard == eng.stats.cache_bytes_hwm > 0
    assert eng.stats.phase_report()["mesh_model"] == 4.0
    eng = _admitted(name, weights, mesh4, **kw)
    try:
        got = _tick_bytes(eng, mesh4)
    finally:
        eng.close(workers=False)
    want = _step_formula(get_config(name).reduced(), ENGINE["n_slots"], 4)
    assert want["all-reduce"] == (4 * 1 + 1) * 2 * 64 * 4
    assert got == {**want, "total": want["all-reduce"] + want["all-gather"]}


def test_hung_worker_makes_rank_0_raise(weights, mesh4):
    """A worker that stops answering (stopped by a signal) makes rank 0's
    next collective raise within the group's timeout. Ends the group."""
    eng = _admitted("smollm-135m", weights, mesh4)
    mesh4.group.timeout = 1.0
    os.kill(mesh4.workers[-1].pid, signal.SIGSTOP)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError):
        eng.step_fused()
    assert time.perf_counter() - t0 < 30
    for p in mesh4.workers:
        p.kill()


# ------------------------------------------------------------- no group

@pytest.mark.parametrize("arch,mesh,match", [
    ("smollm-135m", Mesh({"data": 1}), "needs a 'model' axis"),
    ("smollm-135m", make_dev_mesh(2, 2), "every other mesh axis"),
    ("mamba2-780m", make_dev_mesh(1, 2), "attention-only"),
    ("granite-moe-3b-a800m", make_dev_mesh(1, 2), "MoE"),
    ("whisper-small", make_dev_mesh(1, 2), "encoder-decoder"),
    ("smollm-135m", make_dev_mesh(1, 2), "without a process group"),
], ids=["no-model-axis", "data-axis", "ssm", "moe", "encoder", "no-group"])
def test_mesh_refusals(arch, mesh, match):
    cfg = get_config(arch).reduced()
    with pytest.raises(ValueError, match=match):
        ServingEngine(cfg, ModelOptions(), SeededWeights(), mesh=mesh,
                      device="cpu")


def test_mesh_options_refused():
    cfg = get_config("smollm-135m").reduced()
    mesh = make_dev_mesh(1, 2)
    with pytest.raises(ValueError, match="captured in a CUDA graph"):
        ServingEngine(cfg, ModelOptions(), SeededWeights(), mesh=mesh,
                      device="cpu", graphs=True)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    with pytest.raises(ValueError, match="picklable function"):
        ServingEngine(cfg, ModelOptions(), params, mesh=mesh, device="cpu")


def test_mesh_factories_validate():
    with pytest.raises(ValueError, match="positive int"):
        make_serving_mesh(0)
    with pytest.raises(ValueError, match="needs a store"):
        make_serving_mesh(2)
    with pytest.raises(ValueError, match="outside a mesh"):
        make_serving_mesh(2, store="unused", rank=2)
    with pytest.raises(ValueError, match="needs 8 ranks but only 4"):
        make_elastic_mesh(4, 2, devices=4)
    mesh = make_serving_mesh(1)
    assert mesh.shape == {"model": 1} and mesh.axis_names == ("model",)
    assert SH.rank_coords(make_dev_mesh(2, 3))[5] == {"data": 1, "model": 2}


def test_sharding_helpers():
    x = torch.arange(4 * 6 * 2.0).reshape(4, 6, 2)
    mesh = {"data": 2, "model": 3}
    spec = SH.spec_for(x.shape, ("embed", "mlp", None), mesh)
    assert spec == ("data", "model", None)
    placed = SH.place(x, spec, mesh)
    assert [tuple(s.shape) for s in placed.shards] == [(2, 2, 2)] * 6
    assert torch.equal(placed.shards[4], x[2:4, 2:4])
    assert torch.equal(placed.gather(), x)
    assert SH.constrain(x, "batch") is x
    assert SH.sharding_for(x.shape, ("embed", None, None)) is None
    with SH.global_mesh(mesh):
        assert SH.get_mesh() is mesh
        assert SH.sharding_for(x.shape, ("embed", None, None)) == (
            "data", None, None)
    assert SH.get_mesh() is None


def test_elastic_shrink_single_device():
    """The reference's case: one device, nothing moves."""
    mesh = make_elastic_mesh(1, 1)
    state = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)}
    new_state, new_mesh = elastic_shrink(
        state, mesh, make_mesh=lambda d: mesh,
        sharding_fn=lambda tree, m: map_tree(lambda x: None, tree),
        lost_nodes=0)
    assert new_mesh is mesh
    for k in state:
        assert torch.equal(new_state[k], state[k])


def test_elastic_shrink_data_4_to_3():
    """A state placed over data=4 re-slices for data=3 by spec_for: a dim
    of 12 splits 3 ways, one of 8 no longer divides and replicates."""
    templ = {"w": PSpec((12, 5), ("embed", None)),
             "v": PSpec((8,), ("embed",))}
    whole = {"w": torch.randn(12, 5), "v": torch.randn(8)}

    def specs(tree, mesh):
        return map_tree(lambda s: SH.spec_for(s.shape, s.axes, mesh), templ)
    old = make_elastic_mesh(4, 1)
    state = map_tree(lambda x, s: SH.place(x, s, old), whole,
                     specs(whole, old))
    new_state, new_mesh = elastic_shrink(
        state, old, make_mesh=lambda d: make_elastic_mesh(d, 1),
        sharding_fn=specs, lost_nodes=1)
    assert new_mesh.shape == {"data": 3, "model": 1}
    w, v = new_state["w"], new_state["v"]
    assert w.spec == ("data", None) and v.spec == (None,)
    assert [tuple(s.shape) for s in w.shards] == [(4, 5)] * 3
    assert torch.equal(w.shards[1], whole["w"][4:8])
    assert all(torch.equal(s, whole["v"]) for s in v.shards)
    assert torch.equal(w.gather(), whole["w"])


# ------------------------------------------------------- the front end

# a bound on each wait of the front-end test below, which names the wait
# when it expires (the test takes ~2 s alone)
FRONT_END_WAIT_S = 300.0


async def _bounded(awaitable, what: str, meshes):
    """``awaitable`` within FRONT_END_WAIT_S, else an error that names the
    wait and carries what the meshes' workers reported."""
    try:
        return await asyncio.wait_for(awaitable, FRONT_END_WAIT_S)
    except asyncio.TimeoutError:
        raise AssertionError(
            f"{what} did not end within {FRONT_END_WAIT_S} s; workers: "
            f"{[m.worker_error() for m in meshes]}") from None


def test_two_sharded_replicas_behind_the_front_end(weights, meshes):
    """Two sharded replicas, each with its own group and worker, tick on
    two threads: the streams are one unsharded engine's, the snapshot
    carries each replica's mesh and shard figures, and ``stop()`` closes
    both and joins their workers. Each wait is bounded and named, and a
    failure reports where it happened and what the workers said."""
    name, kw = "smollm-135m", LAYOUTS["paged-bf16"]
    reqs = _reqs(name, False)
    want = _serve(_engine(name, weights, **kw), reqs)
    mine = meshes[2:]
    where = ["building the replicas' engines"]
    t0 = time.perf_counter()

    async def go(engines):
        where[0] = "starting the front end"
        async with AsyncFrontend(engines) as fe:
            streams = [await fe.submit(p, m) for p, m, _ in reqs]
            outs = []
            for i, st in enumerate(streams):
                what = f"replica {st.replica}'s stream of request {i}"
                where[0] = what
                outs.append(await _bounded(st.tokens(), what, mine))
            where[0] = "the front end's drain"
            await _bounded(fe.drain(), where[0], mine)
            where[0] = "stopping the front end (closing the replicas)"
            return outs, fe.stats_snapshot()
    try:
        engines = [_engine(name, weights, m, **kw) for m in mine]
        outs, snap = asyncio.run(go(engines))
    except Exception as e:
        raise AssertionError(
            f"two sharded replicas behind the front end: {where[0]} failed "
            f"after {time.perf_counter() - t0:.1f} s ({e!r}); workers: "
            f"{[m.worker_error() for m in mine]}") from e
    assert outs == [want[i] for i in range(len(reqs))]
    assert all(not m.workers for m in meshes[2:])
    for i in range(2):
        assert snap[f"replica{i}_mesh_model"] == 2.0
        assert snap[f"replica{i}_cache_bytes_hwm_shard"] * 2 == \
            snap[f"replica{i}_cache_bytes_hwm"]
        assert f"replica{i}_pages_in_use_shard" in snap


# ------------------------------------------------------------ the driver

def test_serve_driver_mesh(capsys):
    out = serve.main(["--device", "cpu", "--reduced", "--arch",
                      "smollm-135m", "--mesh-model", "2", "--paged",
                      "--page-size", "8", "--requests", "3",
                      "--prompt-len", "10", "--max-tokens", "5",
                      "--slots", "2"])
    assert len(out) == 3 and all(r.done for r in out)
    lines = capsys.readouterr().out
    assert "[serve] mesh: model=2 cache_bytes_hwm_shard=" in lines


# ------------------------------------------------------------- the build

STUB_NVCC = textwrap.dedent("""\
    #!{python}
    import os, sys, time
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    with open(os.environ["STUB_LOG"], "a") as log:
        log.write(out + "\\n")
    if "-c" in args:
        src = args[args.index("-c") + 1]
        body = (os.path.basename(src) * 4096).encode()
        with open(out, "wb") as f:       # written in two halves
            f.write(body[:len(body) // 2])
            f.flush()
            time.sleep(0.3)
            f.write(body[len(body) // 2:])
    else:
        with open(out, "wb") as f:
            for obj in args[args.index("-o") + 2:]:
                f.write(open(obj, "rb").read())
    """)


def test_kernel_build_is_safe_across_processes(tmp_path):
    """Two processes build at once against a stub ``nvcc`` that writes
    its objects slowly: both get the same library, every object is whole,
    and each source compiles once (the second process waits on the lock
    and finds the library)."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    stub = bindir / "nvcc"
    stub.write_text(STUB_NVCC.format(python=sys.executable))
    stub.chmod(0o755)
    env = dict(os.environ, PATH=f"{bindir}:{os.environ['PATH']}",
               STUB_LOG=str(tmp_path / "log"),
               PYTHONPATH=os.path.join(ROOT, "src"))
    # the module alone (it imports no torch), with its build root moved
    code = ("import sys, importlib.util as u; from pathlib import Path; "
            "s = u.spec_from_file_location('b', sys.argv[2]); "
            "b = u.module_from_spec(s); s.loader.exec_module(b); "
            "b.BUILD_ROOT = Path(sys.argv[1]); print(b.build())")
    root = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(root),
                               _build.__file__],
                              env=env, stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    libs = [p.communicate(timeout=60)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert libs[0] == libs[1]
    srcs = _build.sources()
    objs = sorted(root.glob("*/*.o"))
    assert len(objs) == len(srcs)
    for obj in objs:
        name = obj.stem + ".cu"
        assert obj.read_bytes() == (name * 4096).encode()
    lib = open(libs[0], "rb").read()
    assert lib == b"".join((p.name * 4096).encode() for p in
                           sorted(srcs, key=lambda p: p))
    log = (tmp_path / "log").read_text().split()
    assert len(log) == len(srcs) + 1


# ------------------------------------------------------------ a failure

def test_worker_failure_raises_on_rank_0(weights, mesh2):
    """A worker that raises (here: a stage it does not know) reports its
    traceback and exits; rank 0's next collective raises with that
    report. Ends the group."""
    eng = _engine("smollm-135m", weights, mesh2)
    with pytest.raises(ShardWorkerError, match="no attribute"):
        eng._ctl.broadcast_object(("stage", "no_such_stage", ()))
        eng._dev("decode", eng.tokens, eng.index, None)
