"""The port's pipeline for every model family and input mode against the JAX
package: the MoE stack (dbrx-132b), RWKV-6 (rwkv6-3b), the Mamba-2 hybrid
with its shared block (zamba2-7b), frame embeddings (musicgen-large) and a
vision prefix (llava-next-mistral-7b), each the smoke config at 4 layers
(zamba2's shared block after layers 1 and 3: one flagged layer a stage);
and at 2x1x1 zamba2 at 8 layers under 1f1b, whose one chunk a stage runs
the shared block twice (each use's gradient added apart, in fp32).

On gloo, stage x data x model meshes 2x1x1 and 2x2x2, and 2x1x2 for the
recurrent families (one spawn a mesh running its cases,
``tests/torch_pipeline_ranks.py``): modular and split
1f1b in both layouts, gradients and loss against ``jax.grad`` of the JAX
model's token loss over the global token count, with the router's aux loss
left out, as the pipeline (JAX's and the port's) drops it; at 2x2x2,
modular and partitioned, zamba2-7b and dbrx-132b against JAX's own
``make_partitioned_pipeline_grad_fn`` (which pins the shared block's sum
over stages and the aux drop); per-rank collective counts against the tick
table; at 2x2x2, 3 pipelined steps of zamba2-7b and dbrx-132b against
JAX's non-pipelined trainer (loss, grad norm, lr and the final weights); a
zamba2 run at 2x1x1 saved and resumed bit for bit (and, without
processes, a hybrid's state resharded between layouts with its shared
block); and
``launch.train --stages 2`` of arctic-480b and llava-next-mistral-7b under
``torch.distributed.run``.

Tolerances: the pipeline's (tests/test_pipeline.py: rtol 5e-4, atol 5e-5,
loss 1e-5); RWKV's gradients at 1.5e-2 of each leaf's scale plus 3e-5: its
group norm amplifies rounding (ROADMAP.md §3), and at 4 layers JAX's fp32
gradient and the port's each lie up to 6.5e-3 of a leaf's scale from the
float64 one, which the two packages compute alike
(``test_rwkv_tolerance_rests_on_float64``; 3e-3 held at 2 layers).  zamba2 at 8 layers
is held at its own stated 3e-4 of each leaf's scale (tests/test_torch_ssm.py,
tests/test_torch_dist.py): at that depth 4 of the embedding gradient's 131072
elements, each near zero, leave the pipeline's per-element tolerance in the
port's unpipelined layered and standard schedules alike (1.9e-4 off, of a
scale of 4.0; the pipeline's 8.8e-5).  An MoE layer's
capacity counts the tokens of one call, so the reference runs each data
rank's rows of each micro-batch as a forward of its own, as the pipeline
does.  JAX's executor is not run on musicgen-large:
in the ``embeddings`` mode its embedding's ``jax.vjp`` fails on JAX 0.9.0
(``src/repro/core/pipeline.py:634``, a vma type error; ROADMAP.md §3).
"""
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from repro import compat
from repro import configs as jconfigs
from repro.core import pipeline as jpp
from repro.core import stepfn as jstepfn
from repro.core.accumulation import AccumConfig as JAccumConfig
from repro.core.schedules import PipeSpec as JPipeSpec
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import batch_for as jbatch_for
from repro.models import transformer as JT
from repro.models.common import AxisCtx as JAxisCtx
from repro.optim.adam import AdamConfig as JAdamConfig
from repro.optim.adam import adam_init as jadam_init
from repro_torch import configs, tree
from repro_torch.core import stepfn
from repro_torch.core.schedules import PipeSpec
from repro_torch.resilience import reshard
from test_torch_dist import Procs, Spawn
from test_torch_pipeline import WORKER, _assemble, _leaf_paths, _ring_counts

AX = JAxisCtx()
FAMILIES = ("dbrx-132b", "rwkv6-3b", "zamba2-7b", "musicgen-large", "llava-next-mistral-7b")
# variant -> (arch, layers)
VARIANTS = dict({a: (a, 4) for a in FAMILIES}, **{"zamba2-7b-8": ("zamba2-7b", 8)})
M, ROWS, SEQ = 4, 2, 16                  # micro-batches, rows of each, positions
MESHES = {"2x1x1": (2, 1, 1), "2x1x2": (2, 1, 2), "2x2x2": (2, 2, 2)}
SCHEDULES = [("modular", False), ("1f1b", True)]
CASES = [dict(kind="pgrads", arch=a, schedule=sc, split=sp, part=p)
         for a in FAMILIES for sc, sp in SCHEDULES for p in (False, True)]
# 2x1x1 only, after CASES
DEEP_CASES = [dict(kind="pgrads", arch="zamba2-7b-8", schedule="1f1b", split=sp, part=p)
              for sp in (False, True) for p in (False, True)]
# 2x1x2: the recurrent families' leaves that are partial on a model rank
# (Mamba's w_B/w_C, RWKV's mix) summed over the model group alone
PARTIAL_CASES = [c for c in CASES if c["arch"] in ("rwkv6-3b", "zamba2-7b")]
MESH_CASES = {"2x1x1": CASES + DEEP_CASES, "2x1x2": PARTIAL_CASES, "2x2x2": CASES}
# 2x2x2, after CASES: 3 pipelined steps of the hybrid and the MoE stack, the
# router's aux weight 0 (the pipeline drops the aux loss)
TRAIN_ARCHS = ("zamba2-7b", "dbrx-132b")
# their final weights, leaf by leaf: |port - JAX| <= TRAJ_TOL |JAX's final -
# initial| (L2).  Rounding carried by Adam's normalised step reads up to 1%
# of that movement (zamba2's embedding; every other leaf 0.17% or less); a
# step's update lost or made twice on a leaf reads that step's share, 23% or
# more (lr 3e-3, 2.6e-3, 1.65e-3; Adam's steps are near sign-sized)
TRAJ_TOL = 0.1
TRAIN_CASES = [dict(kind="ptrain", arch=a, schedule=sc, split=sp, part=True, steps=3)
               for a in TRAIN_ARCHS for sc, sp in SCHEDULES]
GRAD_PARAMS = [(mesh, i) for mesh, cs in MESH_CASES.items() for i in range(len(cs))]


def _case_id(c: dict) -> str:
    return (f"{c['arch']}-{c['schedule']}{'-split' if c['split'] else ''}-"
            f"{'part' if c['part'] else 'repl'}")


GRAD_IDS = [f"{mesh}-{_case_id(MESH_CASES[mesh][i])}" for mesh, i in GRAD_PARAMS]


PIPE_TOL = dict(rtol=5e-4, atol=5e-5)
# of each leaf's scale, plus 3e-5: zamba2 at 8 layers at its stated 3e-4
# (tests/test_torch_dist.py's RECURRENT_TOL); rwkv6-3b at 4 layers at twice
# the largest distance of an fp32 gradient from the float64 one
# (test_rwkv_tolerance_rests_on_float64: JAX's reference 4.7e-3, the port's
# pipeline 4.2e-3 at tp 1 and 6.5e-3 at tp 2, of the leaf's scale)
SCALE_TOL = {"rwkv6-3b": 1.5e-2, "zamba2-7b-8": 3e-4}
DATA = dict(seq_len=SEQ, global_batch=M * ROWS, n_microbatches=M)
OPT = dict(lr=3e-3, warmup_steps=1, decay_steps=4)
CKPT_ARCHS = ("zamba2-7b", "dbrx-132b")     # the shared block; the expert stacks
CKPT_CASE = dict(kind="pckpt", schedule="modular", steps=4, save=2, opt=OPT)
CLI_ARCHS = ("arctic-480b", "llava-next-mistral-7b")


def _cfgs(variant: str):
    """(JAX config with its kernels off, the port's) of a variant."""
    arch, n = VARIANTS[variant]
    j = dataclasses.replace(jconfigs.get_config(arch, smoke=True), num_layers=n)
    t = dataclasses.replace(configs.get_config(arch, smoke=True), num_layers=n)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return dataclasses.replace(j, kernels=False), t


@pytest.fixture(scope="module")
def families():
    """variant -> (JAX config, port config, JAX weights as numpy, the batch
    of step 0 in the config's input mode, made by JAX's ``batch_for``)."""
    out = {}
    for i, arch in enumerate(VARIANTS):
        jcfg, tcfg = _cfgs(arch)
        params = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(50 + i)))
        data = JDataConfig(vocab_size=jcfg.vocab_size, seed=60 + i, **DATA)
        batch = {k: np.asarray(v) for k, v in jbatch_for(jcfg, data, 0).items()}
        out[arch] = (jcfg, tcfg, params, batch)
    return out


@pytest.fixture(scope="module")
def trainees(mesh22):
    """arch -> (JAX config, port config), both with the router's aux weight
    0, the weights of JAX's ``init_storage`` (numpy) and the data config of
    ``TRAIN_CASES``."""
    out = {}
    for i, arch in enumerate(TRAIN_ARCHS):
        jcfg, tcfg = (dataclasses.replace(c, router_aux_weight=0.0) for c in _cfgs(arch))
        params = jax.tree.map(np.asarray, jstepfn.init_storage(
            jcfg, mesh22, jax.random.PRNGKey(70 + i), partitioned=False))
        out[arch] = (jcfg, tcfg, params, dict(DATA, vocab_size=tcfg.vocab_size, seed=80 + i))
    return out


@pytest.fixture(scope="module")
def spawns(tmp_path_factory, families, trainees):
    tmp = tmp_path_factory.mktemp("pipefam")

    def expand(c):
        if c["kind"] == "ptrain":
            _, tcfg, params, data = trainees[c["arch"]]
            return dict(c, cfg=dataclasses.asdict(tcfg), params=params, data=data, opt=OPT)
        _, tcfg, params, batch = families[c["arch"]]
        return dict(c, cfg=dataclasses.asdict(tcfg), params=params, batch=batch)

    ckpts = [dict(CKPT_CASE, arch=a, cfg=dataclasses.asdict(families[a][1]),
                  params=families[a][2], data=dict(DATA, vocab_size=families[a][1].vocab_size),
                  dir=str(tmp / f"ckpt-{a}")) for a in CKPT_ARCHS]
    extra = {"2x1x1": ckpts, "2x2x2": [expand(c) for c in TRAIN_CASES]}
    any_cfg = dataclasses.asdict(families[FAMILIES[0]][1])
    out = {name: Spawn(tmp, name, mesh, [expand(c) for c in MESH_CASES[name]]
                       + extra.get(name, []), None, None, worker=WORKER, cfg=any_cfg)
           for name, mesh in MESHES.items()}
    for arch in CLI_ARCHS:
        out[arch] = Procs(tmp, arch, [[
            sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
            "2", "-m", "repro_torch.launch.train", "--arch", arch, "--smoke", "--device", "cpu",
            "--steps", "2", "--seq-len", "16", "--global-batch", "4", "--stages", "2",
            "--mesh", "1x1"]])
    yield out
    for s in out.values():
        s.kill()


def _reference(jcfg, params, batch, groups: int):
    """``jax.grad`` of the summed token loss over the global token count,
    one device; each micro-batch's rows split into ``groups`` runs of their
    own (the data ranks' rows: an MoE layer's capacity is per call); the
    router's aux loss left out.  Returns (loss, gradient tree as numpy)."""
    n = float(batch["mask"].sum())
    runs = {k: jnp.asarray(v.reshape(v.shape[0] * groups, v.shape[1] // groups, *v.shape[2:]))
            for k, v in batch.items()}

    def loss(p):
        def body(tot, mb):
            x, _ = JT.forward(jcfg, p, mb, AX, remat=False)
            return tot + JT.head_loss(jcfg, p, x, mb, AX), None
        tot, _ = lax.scan(body, jnp.zeros((), jnp.float32), runs)
        return tot / n

    val, grads = jax.jit(jax.value_and_grad(loss))(jax.tree.map(jnp.asarray, params))
    return float(val), jax.tree.map(np.asarray, grads)


@pytest.fixture(scope="module")
def references(families):
    """(variant, data ranks) -> the reference; the grouping matters to the
    MoE stack alone, the others' one reference serves both meshes."""
    out = {}
    for arch, (jcfg, _, params, batch) in families.items():
        out[arch, 1] = _reference(jcfg, params, batch, 1)
        out[arch, 2] = (_reference(jcfg, params, batch, 2) if jcfg.is_moe
                        else out[arch, 1])
    return out


def _spec(mesh, case, cfg) -> PipeSpec:
    return PipeSpec(n_stages=mesh[0], layers_per_stage=cfg.num_layers // mesh[0],
                    n_microbatches=M, schedule=case["schedule"],
                    split_backward=case.get("split", False))


def _want(grads) -> dict:
    """The JAX gradient tree's leaves by path, the empty ``shared`` subtree
    of the other stacks dropped."""
    return _leaf_paths({k: v for k, v in grads.items() if k != "shared" or v})


def _compare(variant: str, got: dict, want: dict, label: str) -> None:
    pairs = dict(tree.leaves_with_path(got))
    assert sorted(pairs) == sorted(want)
    for path, leaf in pairs.items():
        w = want[path]
        if variant in SCALE_TOL:
            np.testing.assert_array_less(np.abs(leaf - w),
                                         3e-5 + SCALE_TOL[variant] * np.abs(w).max(),
                                         err_msg=f"{label} {path}")
        else:
            np.testing.assert_allclose(leaf, w, err_msg=f"{label} {path}", **PIPE_TOL)


@pytest.mark.parametrize("mesh,i", GRAD_PARAMS, ids=GRAD_IDS)
def test_family_pipeline_grads_match_reference(spawns, families, references, mesh, i):
    """Every family's pipelined gradients, leaf by leaf, and loss against
    ``jax.grad``; a hybrid's ``shared`` gradient is non-zero and equal on
    every rank; musicgen's embedding gradient is exactly zero."""
    case = MESH_CASES[mesh][i]
    arch = case["arch"]
    _, tcfg, _, batch = families[arch]
    outs = spawns[mesh].result()
    ref_loss, ref_grads = references[arch, MESHES[mesh][1]]
    got = _assemble(outs, MESHES[mesh], i, case, tcfg, _spec(MESHES[mesh], case, tcfg))
    _compare(arch, got, _want(ref_grads), _case_id(case))
    losses = {o["results"][i]["loss"] for o in outs}
    assert len(losses) == 1
    np.testing.assert_allclose(losses.pop(), ref_loss, rtol=1e-5)
    assert all(o["results"][i]["ntok"] == batch["mask"].sum() for o in outs)
    if tcfg.hybrid_attn_period:
        assert all(np.abs(x).max() > 0 for x in tree.leaves(got["shared"]))
    if tcfg.input_mode == "embeddings":
        assert not np.any(got["embed"])


RWKV_CASES = [(mesh, i) for mesh, i in GRAD_PARAMS
              if MESH_CASES[mesh][i]["arch"] == "rwkv6-3b"]


def test_rwkv_tolerance_rests_on_float64(spawns, families, references, monkeypatch):
    """What ``SCALE_TOL['rwkv6-3b']`` rests on at 4 layers, read in float64
    as tests/test_torch_ssm.py's ``test_rwkv_float64_gradient_matches_jax``
    reads it at 2: the JAX reference's gradient and the port's whole-batch
    one, every fp32 cast made float64 (``jnp.float32``, ``Tensor.float``),
    agree to 1e-10 of each leaf's scale, so the port computes the JAX
    package's function; and the JAX package's fp32 reference and every
    pipelined fp32 gradient of the port (each mesh, schedule and layout)
    each lie within half of ``SCALE_TOL`` of their leaf's scale from that
    float64 gradient, so they can differ by ``SCALE_TOL`` through rounding
    alone."""
    from test_torch_ssm import _port_loss_grads

    jcfg, tcfg, params, batch = families["rwkv6-3b"]
    j64 = dataclasses.replace(jcfg, dtype="float64", param_dtype="float64")
    t64 = dataclasses.replace(tcfg, dtype="float64", param_dtype="float64")
    with jax.enable_x64(True), monkeypatch.context() as m:
        m.setattr(jnp, "float32", jnp.float64)
        _, want = _reference(j64, jax.tree.map(lambda a: a.astype(np.float64), params), batch, 1)
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "float", lambda t: t.double())
        _, got64 = _port_loss_grads(t64, params, batch)
    want = _want(want)

    def off(pairs: dict) -> dict:
        """Each leaf's largest distance from float64, of its scale."""
        assert sorted(pairs) == sorted(want)
        return {p: float(np.abs(x - want[p]).max() / np.abs(want[p]).max())
                for p, x in pairs.items()}

    assert max(off(dict(tree.leaves_with_path(got64))).values()) < 1e-10
    half = SCALE_TOL["rwkv6-3b"] / 2
    d = off(_want(references["rwkv6-3b", 1][1]))
    assert max(d.values()) < half, ("jax", max(d, key=d.get))
    for mesh, i in RWKV_CASES:
        case = MESH_CASES[mesh][i]
        got = _assemble(spawns[mesh].result(), MESHES[mesh], i, case, tcfg,
                        _spec(MESHES[mesh], case, tcfg))
        d = off(dict(tree.leaves_with_path(got)))
        assert max(d.values()) < half, (mesh, _case_id(case), max(d, key=d.get))


@pytest.mark.parametrize("mesh,i", GRAD_PARAMS, ids=GRAD_IDS)
def test_family_pipeline_counts_match_table(spawns, families, mesh, i):
    """Per rank and pass: data-group all-gathers and reduce-scatters equal
    ``TickTable.predicted_collectives`` at the config's layer-leaf count
    (partitioned), or one data all-reduce per layer and outer leaf (a
    hybrid's shared block among them) plus the token count and the loss
    (replicated); stage sends and receives equal the table's ring entries,
    each one micro-batch's activation of the whole sequence."""
    case = MESH_CASES[mesh][i]
    _, tcfg, _, _ = families[case["arch"]]
    S, D, _ = MESHES[mesh]
    tmpl = stepfn.full_template(tcfg)
    n_layer = len(tree.leaves(tmpl["layers"]))
    n_outer = len(tree.leaves(tmpl)) - n_layer
    jtable = JPipeSpec(n_stages=S, layers_per_stage=tcfg.num_layers // S, n_microbatches=M,
                       schedule=case["schedule"], split_backward=case["split"]).tick_table()
    pred = jtable.predicted_collectives(partitioned=True, n_layer_leaves=n_layer)
    act_bytes = (ROWS // D) * SEQ * tcfg.d_model * 4
    for o in spawns[mesh].result():
        counts = o["results"][i]["counts"]
        ag, rs = counts.get(("data", "all_gather")), counts.get(("data", "reduce_scatter"))
        if case["part"]:
            assert ag[0] == pred["all_gather_data"] and rs[0] == pred["psum_scatter_data"]
        else:
            assert ag is None and rs is None
            assert counts[("data", "all_reduce")][0] == n_layer + n_outer + 2
        sends, recvs = _ring_counts(jtable, o["stage_index"])
        assert counts.get(("stage", "send"), (0, 0)) == (sends, sends * act_bytes)
        assert counts.get(("stage", "recv"), (0, 0)) == (recvs, recvs * act_bytes)


EXECUTOR_ARCHS = ("zamba2-7b", "dbrx-132b")


@pytest.fixture(scope="module")
def jax_executor(families):
    """JAX's own partitioned modular executor (kernels off) under shard_map
    on the (stage 2, data 2, model 2) mesh, for the hybrid and the MoE
    stack."""
    mesh = compat.make_mesh((2, 2, 2), ("stage", "data", "model"))
    axis = JAxisCtx(data="data", model="model", tp=2, dp=2, ndata=2)
    out = {}
    for arch in EXECUTOR_ARCHS:
        jcfg, _, params, batch = families[arch]
        spec = JPipeSpec(n_stages=2, layers_per_stage=jcfg.num_layers // 2, n_microbatches=M,
                         schedule="modular")
        lspecs = JT.layer_specs(jcfg, 2)
        tmpl = jax.tree.map(lambda l: jax.ShapeDtypeStruct(l.shape[1:], l.dtype),
                            jax.eval_shape(lambda c=jcfg: JT.init_params(c, jax.random.PRNGKey(0)))
                            ["layers"])
        jp = jax.tree.map(jnp.asarray, params)
        jb = jax.tree.map(jnp.asarray, batch)
        pparams = dict({k: v for k, v in jp.items() if k != "layers"},
                       layers=jpp.to_partitioned_stage_stack(jp["layers"], spec, 2,
                                                             lspecs=lspecs, tp=2))
        specs = jpp.partitioned_stage_param_specs(jcfg, 2)
        specs = {k: v for k, v in specs.items() if k in pparams}
        fn = compat.shard_map(jpp.make_partitioned_pipeline_grad_fn(jcfg, axis, spec, tmpl),
                              mesh=mesh, in_specs=(specs, {k: P(None, "data", None)
                                                           for k in jb}),
                              out_specs=(specs, {"loss": P(), "ntok": P()}))
        grads, metrics = jax.jit(fn)(pparams, jb)
        grads = dict(grads, layers=jpp.from_partitioned_stage_stack(
            grads["layers"], spec, tmpl, lspecs=lspecs, tp=2))
        out[arch] = (float(metrics["loss"]), jax.tree.map(np.asarray, grads))
    return out


@pytest.mark.parametrize("arch", EXECUTOR_ARCHS)
def test_pipeline_matches_jax_executor(spawns, families, jax_executor, arch):
    """At 2x2x2, modular and partitioned: the port's gradients and loss
    against JAX's ``make_partitioned_pipeline_grad_fn`` on the same weights
    and batch, at the pipeline's tolerance: the shared block's gradient
    summed over the stages and the data ranks, the MoE stack's without the
    router's aux loss."""
    i = CASES.index(dict(kind="pgrads", arch=arch, schedule="modular", split=False,
                         part=True))
    _, tcfg, _, _ = families[arch]
    outs = spawns["2x2x2"].result()
    want_loss, want = jax_executor[arch]
    got = _assemble(outs, MESHES["2x2x2"], i, CASES[i], tcfg,
                    _spec(MESHES["2x2x2"], CASES[i], tcfg))
    _compare(arch, got, _want(want), "jax executor")
    np.testing.assert_allclose(outs[0]["results"][i]["loss"], want_loss, rtol=1e-5)


@pytest.fixture(scope="module")
def jax_trajectories(trainees, mesh22):
    """arch -> JAX's non-pipelined layered trajectory on the (data 2, model
    2) mesh, kernels off, from ``trainees``' weights: the records of 3 steps
    and the final fp32 weights (numpy)."""
    out = {}
    for arch, (jcfg, _, params, data) in trainees.items():
        step = jstepfn.build_train_step(jcfg, mesh22, JAccumConfig("layered", False, M),
                                        JAdamConfig(**OPT), donate=False)
        storage = jax.tree.map(jnp.asarray, params)
        opt = jadam_init(storage)
        recs = []
        for i in range(3):
            storage, opt, m = step(storage, opt, jbatch_for(jcfg, JDataConfig(**data), i))
            recs.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
        out[arch] = (recs, jax.tree.map(np.asarray, storage))
    return out


def _train_id(c: dict) -> str:
    return f"{c['arch']}-{c['schedule']}{'-split' if c['split'] else ''}"


@pytest.mark.parametrize("which", range(len(TRAIN_CASES)),
                         ids=[_train_id(c) for c in TRAIN_CASES])
def test_family_pipelined_trajectory_matches_jax(spawns, trainees, jax_trajectories, which):
    """3 pipelined, partitioned steps at 2x2x2 of the hybrid (its shared
    block) and the MoE stack, the router's aux weight 0, against JAX's
    non-pipelined layered trajectory on the (2, 2) mesh from the same
    weights and batches: loss to 2e-4, grad norm to 1e-3 and lr to 1e-7
    relative (tests/test_torch_pipeline.py's, JAX's own pipelined-trajectory
    tolerances), every rank the same; the final weights equal on every rank
    that holds them (the outer leaves, the shared block's among them, on
    every stage and data rank), each leaf within ``TRAJ_TOL`` of its own
    movement over the 3 steps from JAX's (relative L2)."""
    case = TRAIN_CASES[which]
    _, tcfg, _, _ = trainees[case["arch"]]
    want_recs, want_params = jax_trajectories[case["arch"]]
    outs = spawns["2x2x2"].result()
    i = len(MESH_CASES["2x2x2"]) + which
    recs = [o["results"][i]["records"] for o in outs]
    for r in recs[1:]:
        assert [(x["loss"], x["grad_norm"]) for x in r] == [
            (x["loss"], x["grad_norm"]) for x in recs[0]]
    for step, (g, w) in enumerate(zip(recs[0], want_recs)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=2e-4, err_msg=f"step {step}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-3,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-7, err_msg=f"step {step}")
    got = _assemble(outs, MESHES["2x2x2"], i, case, tcfg, _spec(MESHES["2x2x2"], case, tcfg),
                    key="storage")
    want = _want(want_params)
    assert sorted(p for p, _ in tree.leaves_with_path(got)) == sorted(want)
    init = _want(trainees[case["arch"]][2])
    for path, x in tree.leaves_with_path(got):
        moved = np.linalg.norm(want[path] - init[path])
        assert np.linalg.norm(x - want[path]) <= TRAJ_TOL * moved, path


@pytest.mark.parametrize("which", range(len(CKPT_ARCHS)), ids=CKPT_ARCHS)
def test_pipeline_checkpoint_resumes_bit_for_bit(spawns, which):
    """At 2x1x1, partitioned modular: 4 steps saving a params + moments
    bundle (zamba2-7b's shared block, dbrx-132b's expert stacks, the stage
    stacks) after step 2; the state zeroed and that bundle restored, steps 2
    and 3 again give the same losses and the same final storage, bit for
    bit, on both stages."""
    outs = spawns["2x1x1"].result()
    i = len(MESH_CASES["2x1x1"]) + which
    for o in outs:
        r = o["results"][i]
        assert r["start"] == CKPT_CASE["save"]
        assert r["resumed"] == r["losses"][CKPT_CASE["save"]:]
        assert ("shared" in r["storage"]) == (CKPT_ARCHS[which] == "zamba2-7b")
        for (path, a), b in zip(tree.leaves_with_path(r["storage"]),
                                tree.leaves(r["resumed_storage"])):
            np.testing.assert_array_equal(a, b, err_msg=f"stage {o['stage_index']} {path}")
    assert np.isfinite(outs[0]["results"][i]["losses"]).all()


LAYOUTS = [reshard.MeshLayout(stages=1, data=2, model=2, partitioned=True),
           reshard.MeshLayout(stages=2, data=2, model=2, partitioned=True, n_microbatches=4),
           reshard.MeshLayout(stages=2, data=1, model=2, partitioned=False,
                             n_microbatches=4)]


@pytest.mark.parametrize("src,dst", [(0, 1), (1, 2), (2, 0)],
                         ids=["flat-to-pipeline", "pipeline-partitioned-to-replicated",
                              "pipeline-to-flat"])
def test_reshard_keeps_the_shared_block(families, src, dst):
    """A hybrid's training state resharded on the host between the flat and
    the pipelined layouts keeps its ``shared`` block: the storage in
    ``dst`` holds it, and back in the full layout every leaf, the shared
    block's among them, is the original bit for bit.  (``from_full_state``
    used to drop a non-empty ``shared`` with the other stacks' empty one.)"""
    _, tcfg, params, _ = families["zamba2-7b"]
    full = {k: v for k, v in params.items() if k != "shared" or v}
    a, b = LAYOUTS[src], LAYOUTS[dst]
    moved = reshard.reshard_state(reshard.from_full_state(full, tcfg, a), tcfg, a, b)
    assert "shared" in moved
    back = reshard.to_full_state(moved, tcfg, b)
    want = _leaf_paths(full)
    got = dict(tree.leaves_with_path(back))
    assert sorted(got) == sorted(want)
    for path, x in got.items():
        np.testing.assert_array_equal(x, want[path], err_msg=str(path))


@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_train_cli_pipelines_the_family(spawns, arch):
    """``launch.train --stages 2 --mesh 1x1 --device cpu`` under
    torch.distributed.run (gloo, two processes): rank 0 prints two steps and
    finite losses."""
    (stdout,) = spawns[arch].wait()
    lines = stdout.splitlines()
    assert sum(ln.startswith("step ") for ln in lines) == 2
    got = json.loads(lines[-1])
    assert got["arch"] == arch and got["stages"] == 2 and got["steps"] == 2
    assert np.isfinite(got["first_loss"]) and np.isfinite(got["last_loss"])
