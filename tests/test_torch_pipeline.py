"""The port's pipeline (``core/schedules.py``, ``planner/simulator.py``'s tick
tables, the stage-stack layouts, ``core/pipeline.py``'s executor and the
pipelined train step) against the JAX package's.

Without processes: the tick tables of every shape of the JAX package's
``test_tick_table_covers_all_work`` and ``test_split_table_covers_all_work``
serialise to exactly JAX's JSON, tables load both ways, malformed tables are
refused alike, the stage-stack layouts equal JAX's, and the mixed AdamW
update equals JAX's ``adam_step(fused=is_stacked_path)``.

On gloo, stage x data x model meshes 1x1x1, 2x1x1, 4x1x1, 2x2x1, 2x1x2 and
2x2x2 (``tests/torch_pipeline_ranks.py``, every mesh spawned at once, each
joined under ``test_torch_dist``'s hang guard): gradients and loss of modular, naive, 1f1b,
interleaved, split 1f1b and split interleaved, in both layouts, against
``jax.grad`` of the JAX loss (the JAX pipeline tests' tolerance), with the
per-rank collective counts the table predicts; at 2x2x2 two cases against
JAX's own partitioned executor; at 2x2x1 a 3-step pipelined trajectory
against JAX's non-pipelined layered one; and ``launch.train --stages 2``
under ``torch.distributed.run``.
"""
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.core import pipeline as jpp
from repro.core import stepfn as jstepfn
from repro.core.accumulation import AccumConfig as JAccumConfig
from repro.core.schedules import PipeSpec as JPipeSpec
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import make_batch as jmake_batch
from repro.models import transformer as JT
from repro.models.common import AxisCtx as JAxisCtx
from repro.models.common import ModelConfig as JModelConfig
from repro.optim.adam import AdamConfig as JAdamConfig
from repro.optim.adam import adam_init as jadam_init
from repro.optim.adam import adam_step as jadam_step
from repro.planner import simulator as jsim
from repro_torch import tree
from repro_torch.convert import pipeline_storage_from_numpy
from repro_torch.core import partition as zp
from repro_torch.core import stepfn
from repro_torch.core.dist import AxisCtx
from repro_torch.core.schedules import PipeSpec
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adam import AdamConfig, adam_init, adam_step
from repro_torch.planner import simulator as sim
from test_torch_dist import ROOT, Procs, Spawn

import torch

WORKER = ROOT / "tests" / "torch_pipeline_ranks.py"

# the CFG of tests/test_pipeline.py: 8 layers, width 32, 4 q / 2 KV heads
PIPE = dict(name="p", arch_type="dense", num_layers=8, d_model=32, num_heads=4,
            num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32", param_dtype="float32")
JCFG, TCFG = dataclasses.replace(JModelConfig(**PIPE), kernels=False), ModelConfig(**PIPE)
M, L = 8, PIPE["num_layers"]
N_LAYER_LEAVES = 9
# 1x1x1: one stage, whose rings are transfers to itself (local copies on gloo)
MESHES = {"1x1x1": (1, 1, 1), "2x1x1": (2, 1, 1), "4x1x1": (4, 1, 1), "2x2x1": (2, 2, 1),
          "2x1x2": (2, 1, 2), "2x2x2": (2, 2, 2)}
SCHEDULES = [("modular", False), ("naive", False), ("1f1b", False), ("interleaved", False),
             ("1f1b", True), ("interleaved", True)]
GRAD_CASES = [dict(kind="pgrads", schedule=sc, split=sp, part=p)
              for sc, sp in SCHEDULES for p in (False, True)]
GRAD_IDS = [f"{c['schedule']}{'-split' if c['split'] else ''}-{'part' if c['part'] else 'repl'}"
            for c in GRAD_CASES]
DATA = dict(vocab_size=64, seq_len=16, global_batch=16, n_microbatches=M)
OPT = dict(lr=3e-3, warmup_steps=1, decay_steps=4)
# 2x1x2 only: one KV head, replicated over the model group, so that the
# partial wk/wv gradients are summed over it before the data-group reduction
MQA = dict(PIPE, num_kv_heads=1)
MQA_CASES = [dict(kind="pgrads", schedule=sc, split=sp, part=p, cfg=MQA)
             for sc, sp in (("modular", False), ("1f1b", True)) for p in (False, True)]
MQA_IDS = [f"{c['schedule']}{'-split' if c['split'] else ''}-{'part' if c['part'] else 'repl'}"
           for c in MQA_CASES]
TRAIN_CASES = [dict(kind="ptrain", schedule="modular", steps=3, data=DATA, opt=OPT),
               dict(kind="ptrain", schedule="1f1b", split=True, steps=3, data=DATA, opt=OPT)]
CLI_ARGV = ["--arch", "yi-6b", "--smoke", "--device", "cpu", "--steps", "2", "--seq-len", "32",
            "--global-batch", "4"]


# ---------------------------------------------------------------------------
# Tick tables (no processes)
# ---------------------------------------------------------------------------
TABLE_CASES = ([(sched, S, K, Mb, False) for sched in ("modular", "1f1b", "interleaved", "gpipe")
                for S, K, Mb in [(2, 2, 4), (4, 2, 8), (2, 4, 2)]]
               + [(sched, S, K, Mb, True) for sched in ("1f1b", "interleaved", "modular", "gpipe")
                  for S, K, Mb in [(2, 2, 4), (4, 2, 8)]])


@pytest.mark.parametrize("sched,S,K,Mb,split", TABLE_CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}x{c[3]}{'-split' if c[4] else ''}"
                              for c in TABLE_CASES])
def test_tick_table_matches_jax(sched, S, K, Mb, split):
    """The cases of JAX's test_tick_table_covers_all_work and
    test_split_table_covers_all_work: the same shapes are feasible, and the
    port's table serialises to exactly JAX's JSON, with the same residual
    slots, gather segments and predicted collectives."""
    kw = dict(n_stages=S, layers_per_stage=K, n_microbatches=Mb, schedule=sched,
              split_backward=split)
    try:
        want = JPipeSpec(**kw).tick_table()
    except AssertionError:
        with pytest.raises(AssertionError):
            PipeSpec(**kw)
        return
    got = PipeSpec(**kw).tick_table()
    assert json.dumps(got.to_json()) == json.dumps(want.to_json())
    assert got.residual_slots() == want.residual_slots()
    assert got.gather_segments() == want.gather_segments()
    for part in (False, True):
        assert (got.predicted_collectives(partitioned=part, n_layer_leaves=N_LAYER_LEAVES)
                == want.predicted_collectives(partitioned=part, n_layer_leaves=N_LAYER_LEAVES))
    assert got.timeline() == want.timeline()
    assert got.is_split == want.is_split == split
    got.validate_executable()


@pytest.mark.parametrize("sched,split", SCHEDULES, ids=[f"{s}{'-split' if p else ''}"
                                                        for s, p in SCHEDULES])
def test_tick_table_json_loads_both_ways(sched, split):
    """A JAX table's JSON loads into the port with every derived receive
    table equal, and the port's loads into JAX."""
    kw = dict(n_stages=2, layers_per_stage=4, n_microbatches=M, schedule=sched,
              split_backward=split)
    jt, pt = JPipeSpec(**kw).tick_table(), PipeSpec(**kw).tick_table()
    from_j = sim.TickTable.from_json(json.loads(json.dumps(jt.to_json())))
    from_p = jsim.TickTable.from_json(json.loads(json.dumps(pt.to_json())))
    for f in dataclasses.fields(jt):
        assert getattr(from_j, f.name) == getattr(jt, f.name), f.name
        assert getattr(from_p, f.name) == getattr(pt, f.name), f.name


def test_validate_names_unknown_kinds():
    """The port's copy of JAX's test: the refusal names the unknown kind and
    the planner flag that emits kinds 3/4."""
    doc = PipeSpec(n_stages=2, layers_per_stage=2, n_microbatches=4,
                   schedule="1f1b").tick_table().to_json()
    doc["kind"][0][0] = 7
    with pytest.raises(NotImplementedError) as ei:
        sim.TickTable.from_json(doc).validate_executable()
    assert "7" in str(ei.value) and "split_backward=True" in str(ei.value)


def test_malformed_split_pairing_rejected():
    """The port's copy of JAX's test: a split table without its wgrads, or
    with every wgrad before its dgrad, is refused."""
    doc = PipeSpec(n_stages=2, layers_per_stage=2, n_microbatches=4, schedule="1f1b",
                   split_backward=True).tick_table().to_json()
    dropped = dict(doc, kind=[[0 if k == sim.TICK_BWGRAD else k for k in row]
                              for row in doc["kind"]])
    with pytest.raises(ValueError, match="never runs"):
        sim.TickTable.from_json(dropped).validate_executable()
    swap = {sim.TICK_BDGRAD: sim.TICK_BWGRAD, sim.TICK_BWGRAD: sim.TICK_BDGRAD}
    swapped = dict(doc, kind=[[swap.get(k, k) for k in row] for row in doc["kind"]])
    with pytest.raises(ValueError):
        sim.TickTable.from_json(swapped).validate_executable()


@pytest.mark.parametrize("sched", ["modular", "naive"])
def test_closed_form_matches_jax(sched):
    for S, K, Mb in [(2, 4, 4), (4, 2, 8), (8, 1, 8)]:
        got = PipeSpec(n_stages=S, layers_per_stage=K, n_microbatches=Mb, schedule=sched)
        want = JPipeSpec(n_stages=S, layers_per_stage=K, n_microbatches=Mb, schedule=sched)
        for attr in ("total_outer_steps", "layer_ticks_per_stage", "bubble_layer_ticks",
                     "bubble_fraction", "permutes", "compute_layer_ticks",
                     "p2p_sends_per_stage", "layers_per_chunk", "n_chunks", "num_layers"):
            assert getattr(got, attr) == getattr(want, attr), (S, K, Mb, attr)
        assert got.fwd_p2p_bytes(4096.0) == want.fwd_p2p_bytes(4096.0)


# ---------------------------------------------------------------------------
# Stage-stack layouts (no processes)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def layers_np():
    params = JT.init_params(JCFG, jax.random.PRNGKey(3))
    return jax.tree.map(np.asarray, params["layers"])


def _leaf_paths(t):
    return {tuple(p.key for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(t)}


@pytest.mark.parametrize("sched", ["modular", "naive", "interleaved"])
@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("n_data", [1, 2])
def test_stage_stack_layouts_match_jax(layers_np, sched, tp, n_data):
    """``to_stage_stack`` and ``to_partitioned_stage_stack`` equal JAX's on
    the same arrays, bit for bit, and their inverses give the layers back."""
    kw = dict(n_stages=2, layers_per_stage=4, n_microbatches=M, schedule=sched)
    spec, jspec = PipeSpec(**kw), JPipeSpec(**kw)
    jl = jax.tree.map(jnp.asarray, layers_np)
    want_s = _leaf_paths(jpp.to_stage_stack(jl, jspec))
    want_p = _leaf_paths(jpp.to_partitioned_stage_stack(jl, jspec, n_data,
                                                        lspecs=JT.layer_specs(JCFG, tp), tp=tp))
    lspecs = T.layer_specs(TCFG, tp)
    got_s = zp.to_stage_stack(layers_np, spec)
    got_p = zp.to_partitioned_stage_stack(layers_np, spec, n_data, lspecs=lspecs, tp=tp)
    for path, x in tree.leaves_with_path(got_s):
        np.testing.assert_array_equal(x, want_s[path], err_msg=str(path))
    for path, x in tree.leaves_with_path(got_p):
        assert x.dtype == np.float32
        np.testing.assert_array_equal(x, want_p[path], err_msg=str(path))
    shapes = tree.tree_map(lambda a: a.shape[1:], layers_np)
    back = zp.from_partitioned_stage_stack(got_p, spec, shapes, lspecs=lspecs, tp=tp)
    for (path, x), y in zip(tree.leaves_with_path(back), tree.leaves(layers_np)):
        np.testing.assert_array_equal(x, y, err_msg=str(path))
    for (path, x), y in zip(tree.leaves_with_path(zp.from_stage_stack(got_s, spec)),
                            tree.leaves(layers_np)):
        np.testing.assert_array_equal(x, y, err_msg=str(path))


@pytest.mark.parametrize("part", [False, True])
def test_pipeline_storage_from_numpy_and_init_agree(part):
    """On every rank of a 2x2x2 grid (no groups needed: only the indices
    are read), ``init_pipeline_storage`` holds the weights ``init_storage``
    draws for the same seed, in the layout ``pipeline_storage_from_numpy``
    gives that tree."""
    spec = PipeSpec(n_stages=2, layers_per_stage=4, n_microbatches=M, schedule="modular")
    full = stepfn.init_storage(TCFG, 5, partitioned=False, device="cpu")
    full_np = {k: tree.tree_map(lambda t: t.numpy(), v) for k, v in full.items()}
    for s in range(2):
        for d in range(2):
            for m in range(2):
                axis = AxisCtx(tp=2, ndata=2, nstage=2, data_index=d, model_index=m,
                               stage_index=s)
                a = stepfn.init_pipeline_storage(TCFG, 5, spec, partitioned=part,
                                                 device="cpu", axis=axis)
                b = pipeline_storage_from_numpy(TCFG, full_np, spec, partitioned=part,
                                                axis=axis)
                for (path, x), y in zip(tree.leaves_with_path(a), tree.leaves(b)):
                    np.testing.assert_array_equal(x.numpy(), y.numpy(),
                                                  err_msg=f"{(s, d, m)} {path}")


def test_mixed_adam_step_matches_jax():
    """``adam_step(fused=<layers predicate>)``: K6's plain version on the
    chunked layer stacks, the tree-map update on the whole outer leaves,
    the clip folded in, against JAX's ``adam_step(fused=is_stacked_path)``
    (kernels in interpret mode) on the same state."""
    from repro.core.partition import is_stacked_path
    rng = np.random.default_rng(0)
    storage = {"embed": rng.standard_normal((64, 32)).astype(np.float32),
               "final_norm": {"scale": rng.standard_normal(32).astype(np.float32)},
               "layers": {"w": rng.standard_normal((4, 1, 1, 96)).astype(np.float32),
                          "b": rng.standard_normal((4, 1, 1, 40)).astype(np.float32)}}
    grads = tree.tree_map(lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32),
                          storage)
    cfg = dict(lr=1e-2, warmup_steps=1, decay_steps=10, grad_clip=0.5)
    jst, jopt = jax.tree.map(jnp.asarray, storage), jadam_init(jax.tree.map(jnp.asarray, storage))
    jg = jax.tree.map(jnp.asarray, grads)

    def sq(g):
        return sum(jnp.sum(jnp.square(x)) for x in jax.tree.leaves(g))

    for _ in range(2):
        jst, jopt, jm = jadam_step(JAdamConfig(**cfg), jst, jopt, jg, sq_reduce=sq,
                                   fused=is_stacked_path)
    tst = tree.tree_map(lambda a: torch.tensor(a), storage)
    topt = adam_init(tst)
    tg = tree.tree_map(lambda a: torch.tensor(a), grads)
    for _ in range(2):
        tst, topt, tm = adam_step(AdamConfig(**cfg), tst, topt, tg,
                                  sq_reduce=stepfn.sq_reduce,
                                  fused=lambda path: path[0] == "layers")
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    want = _leaf_paths(jst)
    for path, x in tree.leaves_with_path(tst):
        np.testing.assert_allclose(x.numpy(), want[path], rtol=1e-6, atol=1e-7,
                                   err_msg=str(path))
    for k in ("mu", "nu"):
        want = _leaf_paths(jopt[k])
        for path, x in tree.leaves_with_path(topt[k]):
            np.testing.assert_allclose(x.numpy(), want[path], rtol=1e-6, atol=1e-9,
                                       err_msg=f"{k} {path}")


# ---------------------------------------------------------------------------
# The executor on gloo
# ---------------------------------------------------------------------------
def _init_params(jcfg) -> dict:
    mesh = jax.make_mesh((2, 1), ("data", "model"))
    return jax.tree.map(np.asarray, jstepfn.init_storage(jcfg, mesh, jax.random.PRNGKey(0),
                                                         partitioned=False))


@pytest.fixture(scope="module")
def weights():
    """The JAX weights (numpy, global), the MQA variant's, and a
    micro-batched batch."""
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (M, 2, 16), 0, 64), np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=-1), "mask": np.ones_like(toks)}
    return _init_params(JCFG), _init_params(_jcfg(MQA)), batch


def _jcfg(kw: dict):
    return dataclasses.replace(JModelConfig(**kw), kernels=False)


@pytest.fixture(scope="module")
def spawns(tmp_path_factory, weights):
    tmp = tmp_path_factory.mktemp("pipe")
    params, mqa_params, batch = weights
    extra = {"2x2x1": TRAIN_CASES, "2x1x2": [dict(c, params=mqa_params) for c in MQA_CASES]}
    out = {name: Spawn(tmp, name, mesh, GRAD_CASES + extra.get(name, []), params, batch,
                       worker=WORKER, cfg=PIPE)
           for name, mesh in MESHES.items()}
    out["cli"] = Procs(tmp, "cli", [[
        sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
        "-m", "repro_torch.launch.train", *CLI_ARGV, "--stages", "2", "--mesh", "1x1"]])
    yield out
    for s in out.values():
        s.kill()


def _reference(jcfg, params, batch):
    """``jax.grad`` of the mean token loss, one device, kernels off, as
    tests/test_pipeline.py's reference."""
    flat = {k: jnp.asarray(v).reshape(M * 2, 16) for k, v in batch.items()}

    def loss(p):
        _, (nll, n) = JT.loss_fn(jcfg, p, flat, JAxisCtx(), remat=False)
        return nll / n

    p = jax.tree.map(jnp.asarray, params)
    return float(loss(p)), jax.grad(loss)(p)


@pytest.fixture(scope="module")
def reference(weights):
    params, _, batch = weights
    return _reference(JCFG, params, batch)


def _spec(mesh, case) -> PipeSpec:
    return PipeSpec(n_stages=mesh[0], layers_per_stage=L // mesh[0], n_microbatches=M,
                    schedule=case["schedule"], split_backward=case.get("split", False))


def _assemble(outs, mesh, case_i: int, case: dict, tcfg=TCFG, spec=None,
              key: str = "grads") -> dict:
    """The ranks' gradients (``results[case_i][key]``, or another tree in
    the pipeline storage's layout) -> global numpy leaves in the JAX tree's
    layout (``spec``: the case's pipeline, ``_spec``'s by default).  Ranks
    that must hold equal values are checked equal."""
    S, D, tp = mesh
    by = {(o["stage_index"], o["data_index"], o["model_index"]): o["results"][case_i][key]
          for o in outs}
    specs, lspecs = T.param_specs(tcfg, tp), T.layer_specs(tcfg, tp)
    tmpl = stepfn.full_template(tcfg)

    def get(s, d, m, path):
        t = by[s, d, m]
        for k in path:
            t = t[k]
        return t

    def outer(path, spec):
        dim = zp.model_dim(spec)
        for s in range(S):
            for d in range(D):
                for m in range(tp):
                    ref = get(0, 0, m if dim is not None else 0, path)
                    np.testing.assert_array_equal(get(s, d, m, path), ref, err_msg=str(path))
        return (np.concatenate([get(0, 0, m, path) for m in range(tp)], axis=dim)
                if dim is not None else get(0, 0, 0, path))

    def layer(lpath, lspec):
        path = ("layers", *lpath)
        dim = zp.model_dim(lspec)
        ms = range(tp) if dim is not None else [0]
        if dim is None:             # replicated over the model group: equal there
            for s in range(S):
                for d in range(D):
                    for m in range(1, tp):
                        np.testing.assert_array_equal(get(s, d, m, path), get(s, d, 0, path))
        if case["part"]:
            return np.stack([np.stack([np.stack([get(s, d, m, path) for d in range(D)], axis=1)
                                       for m in ms], axis=1) for s in range(S)])
        for s in range(S):
            for d in range(1, D):
                for m in range(tp):
                    np.testing.assert_array_equal(get(s, d, m, path), get(s, 0, m, path))
        return np.stack([np.concatenate([get(s, 0, m, path) for m in ms],
                                        axis=1 + dim if dim is not None else 0)
                         for s in range(S)])

    got = {k: tree.tree_map_with_path(lambda p, sp: outer((k, *p), sp), specs[k])
           for k in specs if k != "layers"}
    stacks = tree.tree_map_with_path(layer, lspecs)
    spec = _spec(mesh, case) if spec is None else spec
    if case["part"]:
        shapes = tree.tree_map(lambda s: s[1:], tmpl["layers"])
        got["layers"] = zp.from_partitioned_stage_stack(stacks, spec, shapes, lspecs=lspecs,
                                                        tp=tp)
    else:
        got["layers"] = zp.from_stage_stack(stacks, spec)
    return got


def _compare(got: dict, want, **tol):
    wants = _leaf_paths({k: v for k, v in want.items() if k != "shared"})
    pairs = list(tree.leaves_with_path(got))
    assert sorted(p for p, _ in pairs) == sorted(wants)
    for path, leaf in pairs:
        np.testing.assert_allclose(leaf, wants[path], err_msg=str(path), **tol)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", range(len(GRAD_CASES)), ids=GRAD_IDS)
def test_pipeline_grads_match_reference(spawns, reference, mesh, case):
    """Tolerance of tests/test_pipeline.py (rtol 5e-4, atol 5e-5; loss 1e-5)."""
    outs = spawns[mesh].result()
    ref_loss, ref_grads = reference
    _compare(_assemble(outs, MESHES[mesh], case, GRAD_CASES[case]), ref_grads, rtol=5e-4,
             atol=5e-5)
    losses = {o["results"][case]["loss"] for o in outs}
    assert len(losses) == 1
    np.testing.assert_allclose(losses.pop(), ref_loss, rtol=1e-5)
    assert all(o["results"][case]["ntok"] == M * 2 * 16 for o in outs)


@pytest.mark.parametrize("case", range(len(MQA_CASES)), ids=MQA_IDS)
def test_replicated_kv_pipeline_matches_reference(spawns, weights, case):
    """At 2x1x2 with one KV head, replicated over the model group: each
    rank's wk/wv gradient is partial and is summed over the model group
    before the data-group reduction (the reduce-scatter of its chunk, or
    the all-reduce of the replicated leaf)."""
    _, mqa_params, batch = weights
    ref_loss, ref_grads = _reference(_jcfg(MQA), mqa_params, batch)
    outs = spawns["2x1x2"].result()
    i = len(GRAD_CASES) + case
    _compare(_assemble(outs, MESHES["2x1x2"], i, MQA_CASES[case], ModelConfig(**MQA)),
             ref_grads, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(outs[0]["results"][i]["loss"], ref_loss, rtol=1e-5)
    assert outs[0]["results"][i]["counts"][("model", "all_reduce")][0] > 0


def _ring_counts(table, s: int) -> tuple[int, int]:
    """(sends, receives) of stage ``s``: the valid entries of the JAX
    table's receive rows that name it (forward ring to s+1, backward ring
    to s-1, loss ring from stage 0 to S-1)."""
    S = table.n_stages
    sends = recvs = 0
    for t in range(table.n_ticks):
        sends += table.frecv_valid[t][(s + 1) % S] + table.brecv_valid[t][(s - 1) % S]
        sends += table.hrecv_valid[t][S - 1] if s == 0 else 0
        recvs += table.frecv_valid[t][s] + table.brecv_valid[t][s] + table.hrecv_valid[t][s]
    return sends, recvs


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", range(len(GRAD_CASES)), ids=GRAD_IDS)
def test_pipeline_counts_match_table(spawns, mesh, case):
    """Per rank and pass: data-group all-gathers and reduce-scatters equal
    ``TickTable.predicted_collectives(partitioned=True, n_layer_leaves=9)``
    (none when replicated; then one data all-reduce per layer leaf), and
    stage-group sends and receives equal the table's valid ring entries,
    each one micro-batch's activation."""
    S, D, tp = MESHES[mesh]
    c = GRAD_CASES[case]
    jtable = JPipeSpec(n_stages=S, layers_per_stage=L // S, n_microbatches=M,
                       schedule=c["schedule"], split_backward=c["split"]).tick_table()
    pred = jtable.predicted_collectives(partitioned=True, n_layer_leaves=N_LAYER_LEAVES)
    act_bytes = (2 // D) * 16 * PIPE["d_model"] * 4
    for o in spawns[mesh].result():
        counts = o["results"][case]["counts"]
        ag, rs = counts.get(("data", "all_gather")), counts.get(("data", "reduce_scatter"))
        if c["part"]:
            assert ag[0] == pred["all_gather_data"] and rs[0] == pred["psum_scatter_data"]
        else:
            assert ag is None and rs is None
            # the layer leaves, the 3 outer leaves, the token count, the loss
            assert counts[("data", "all_reduce")][0] == N_LAYER_LEAVES + 3 + 2
        sends, recvs = _ring_counts(jtable, o["stage_index"])
        assert counts.get(("stage", "send"), (0, 0)) == (sends, sends * act_bytes)
        assert counts.get(("stage", "recv"), (0, 0)) == (recvs, recvs * act_bytes)


@pytest.fixture(scope="module")
def jax_executor(weights):
    """JAX's own partitioned executor (kernels off) under shard_map on the
    (stage 2, data 2, model 2) mesh, for modular and split 1f1b."""
    params, _, batch = weights
    mesh = compat.make_mesh((2, 2, 2), ("stage", "data", "model"))
    axis = JAxisCtx(data="data", model="model", tp=2, dp=2, ndata=2)
    lspecs = JT.layer_specs(JCFG, 2)
    tmpl = jax.tree.map(lambda l: jax.ShapeDtypeStruct(l.shape[1:], l.dtype),
                        jax.eval_shape(lambda: JT.init_params(JCFG, jax.random.PRNGKey(0)))
                        ["layers"])
    jp = jax.tree.map(jnp.asarray, params)
    jb = jax.tree.map(jnp.asarray, batch)
    out = {}
    for sched, split in (("modular", False), ("1f1b", True)):
        spec = JPipeSpec(n_stages=2, layers_per_stage=4, n_microbatches=M, schedule=sched,
                         split_backward=split)
        pparams = dict({k: v for k, v in jp.items() if k != "layers"},
                       layers=jpp.to_partitioned_stage_stack(jp["layers"], spec, 2,
                                                             lspecs=lspecs, tp=2))
        specs = jpp.partitioned_stage_param_specs(JCFG, 2)
        specs = {k: v for k, v in specs.items() if k in pparams}
        fn = compat.shard_map(jpp.make_partitioned_pipeline_grad_fn(JCFG, axis, spec, tmpl),
                              mesh=mesh, in_specs=(specs, {k: P(None, "data", None)
                                                           for k in jb}),
                              out_specs=(specs, {"loss": P(), "ntok": P()}))
        grads, metrics = jax.jit(fn)(pparams, jb)
        grads = dict(grads, layers=jpp.from_partitioned_stage_stack(
            grads["layers"], spec, tmpl, lspecs=lspecs, tp=2))
        out[sched, split] = (float(metrics["loss"]), grads)
    return out


@pytest.mark.parametrize("sched,split", [("modular", False), ("1f1b", True)])
def test_pipeline_matches_jax_executor(spawns, jax_executor, sched, split):
    """At 2x2x2, partitioned: the port's gradients and loss against JAX's
    ``make_partitioned_pipeline_grad_fn`` on the same weights and batch, at
    the reference's tolerance."""
    case = GRAD_CASES.index(dict(kind="pgrads", schedule=sched, split=split, part=True))
    outs = spawns["2x2x2"].result()
    want_loss, want = jax_executor[sched, split]
    _compare(_assemble(outs, MESHES["2x2x2"], case, GRAD_CASES[case]), want, rtol=5e-4,
             atol=5e-5)
    np.testing.assert_allclose(outs[0]["results"][case]["loss"], want_loss, rtol=1e-5)


@pytest.fixture(scope="module")
def jax_trajectory():
    """JAX's non-pipelined layered, partitioned trajectory on the (data 2,
    model 1) mesh, kernels off, from the weights of ``weights``."""
    mesh = jax.make_mesh((2, 1), ("data", "model"))
    step = jstepfn.build_train_step(JCFG, mesh, JAccumConfig("layered", True, M),
                                    JAdamConfig(**OPT), donate=False)
    storage = jstepfn.init_storage(JCFG, mesh, jax.random.PRNGKey(0), partitioned=True)
    opt = jadam_init(storage)
    recs = []
    for i in range(3):
        storage, opt, m = step(storage, opt, jmake_batch(JDataConfig(**DATA), i))
        recs.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
    return recs


@pytest.mark.parametrize("which", range(len(TRAIN_CASES)),
                         ids=[f"{c['schedule']}{'-split' if c.get('split') else ''}"
                              for c in TRAIN_CASES])
def test_pipelined_trajectory_matches_nonpipelined(spawns, weights, jax_trajectory, which):
    """3 pipelined steps at 2x2x1 (modular; split 1f1b) against JAX's
    non-pipelined layered trajectory: loss to 2e-4 and grad norm to 1e-3
    relative (the tolerances of JAX's own
    test_pipelined_trajectory_matches_nonpipelined), lr exactly; every rank
    reports the same; each step issues the predicted data-group gathers.
    Before the first step ``gather_pipeline_params`` gives every rank the
    JAX weights exactly."""
    params, _, _ = weights
    want = jax_trajectory
    outs = spawns["2x2x1"].result()
    case = TRAIN_CASES[which]
    jtable = JPipeSpec(n_stages=2, layers_per_stage=4, n_microbatches=M,
                       schedule=case["schedule"],
                       split_backward=case.get("split", False)).tick_table()
    pred = jtable.predicted_collectives(partitioned=True, n_layer_leaves=N_LAYER_LEAVES)
    recs = [o["results"][len(GRAD_CASES) + which]["records"] for o in outs]
    for r in recs[1:]:
        assert [x["loss"] for x in r] == [x["loss"] for x in recs[0]]
        assert [x["grad_norm"] for x in r] == [x["grad_norm"] for x in recs[0]]
    for i, (g, w) in enumerate(zip(recs[0], want)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=2e-4, err_msg=f"step {i}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-3,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-7, err_msg=f"step {i}")
        assert g["counts"][("data", "all_gather")][0] == pred["all_gather_data"]
    assert recs[0][-1]["loss"] < recs[0][0]["loss"]
    for o in outs:
        got = o["results"][len(GRAD_CASES) + which]["params"]
        want = [(path, x) for path, x in tree.leaves_with_path(params) if path[0] != "layers"]
        want += [(("layers", l, *path), x[l]) for path, x in
                 tree.leaves_with_path(params["layers"]) for l in range(L)]
        for path, x in want:
            y = got
            for k in path:
                y = y[k]
            np.testing.assert_array_equal(y, x, err_msg=str(path))


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------
def test_train_cli_stages_under_the_launcher(spawns):
    """``launch.train --stages 2 --mesh 1x1 --device cpu`` under
    torch.distributed.run (gloo, two processes): rank 0 prints two steps and
    a finite loss."""
    (stdout,) = spawns["cli"].wait()
    lines = stdout.splitlines()
    assert sum(ln.startswith("step ") for ln in lines) == 2
    got = json.loads(lines[-1])
    assert got["stages"] == 2 and got["steps"] == 2
    assert np.isfinite(got["first_loss"]) and np.isfinite(got["last_loss"])


@pytest.mark.parametrize("flags,want", [
    (["--stages", "2", "--schedule", "zigzag"], "--schedule 'zigzag' is not executable"),
    (["--stages", "3"], "--stages 3 does not divide num_layers=2"),
    (["--stages", "2", "--microbatches", "1"], "infeasible pipeline shape for schedule "
                                              "'modular'"),
    (["--stages", "2"], "2 stages of --mesh 1x1 need 2 processes: run it under "
                        "python -m torch.distributed.run --nproc_per_node 2")])
def test_train_cli_refuses_a_bad_pipeline(monkeypatch, capsys, flags, want):
    """An unknown schedule, a stage count that does not divide the layers,
    an infeasible shape, and a pipeline outside the launcher each fail with
    a message that says why, before any process group exists."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit):
        train.main(CLI_ARGV + flags)
    assert want in capsys.readouterr().err
