"""The pod axis (the JAX package's ``AccumConfig.span_pods``, its ``pod``
mesh axis) over a pod x data x model grid of processes on gloo, against the
JAX package on ``tests/conftest.py``'s ``mesh_pod`` (2, 2, 2), its kernels
off (its mesh paths need that, ROADMAP.md §3).

Eight ranks in one spawn (``tests/torch_dist_ranks.py``, ``pods``) run one
``make_grad_fn`` call of both schedules in the three storage layouts (the
partition over ``(pod, data)`` under ``span_pods``, over ``data`` with a pod
sum of every gradient without it, and replicated with an all-reduce over
data, then pod), and two train steps of each layered layout and of the
standard schedule under span, and the §C.3 fused step under span against
the classic one.  Gradients are held to ``jax.grad`` of the
global batch, and the layered span case also to JAX's own ``make_grad_fn``;
the loss, grad norm, lr and final weights of every train case to JAX's
``build_train_step`` under span (every layout takes the same step), at
rtol 3e-4 / atol 3e-5 (``tests/test_accumulation.py``; the final weights at
atol 1e-4, ``W_TOL``).  JAX's standard
schedule in the partitioned layout without span does not trace on a pod
mesh (ROADMAP.md §3), so that case is held to ``jax.grad`` alone.  The
collective counts of each (group, op) are checked exactly; pods with
pipeline stages and expert parallelism with pods are refused by name.

Alone, this file takes about 30 s on an 8-core host.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.core import stepfn as jstepfn
from repro.core.accumulation import AccumConfig as JAccumConfig
from repro.core.accumulation import make_grad_fn as jmake_grad_fn
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import make_batch as jmake_batch
from repro.models import transformer as JT
from repro.models.common import AxisCtx as JAxisCtx
from repro.optim.adam import AdamConfig as JAdamConfig
from repro.optim.adam import adam_init as jadam_init
from repro_torch import configs, tree
from repro_torch.core import dist, stepfn
from repro_torch.core import partition as zp
from repro_torch.core.accumulation import EP_PODS_REFUSAL, AccumConfig, make_grad_fn
from repro_torch.models import transformer as T
from test_torch_dist import ACC, JCFG, TCFG, Spawn, _global, numpy_params

M, L = 4, ACC["num_layers"]
NPOD, NDATA, TP = 2, 2, 2
N_LAYER_LEAVES, N_OUTER_LEAVES = 9, 3
TOL = dict(rtol=3e-4, atol=3e-5)
# the final weights after two AdamW steps: an element whose gradient is near
# zero (wv[2, 20, 7]: 9.5e-9 at step 0, 5e-7 of the leaf's largest) moves by
# Adam's m / (sqrt(v) + eps), whose value its gradient's rounding decides;
# there JAX's own span and non-span steps end 4.28e-5 apart (the port's
# layouts 5.6e-5 to 6.2e-5 from JAX's span step), every other element of
# every leaf within 5e-6.  tests/test_torch_moe.py's W_ATOL, for the same cause
W_TOL = dict(rtol=3e-4, atol=1e-4)
# 16 rows in 4 micro-batches: one row a micro-batch on each of the 4 (pod, data) ranks
DATA = dict(vocab_size=64, seq_len=16, global_batch=16, n_microbatches=M)
OPT = dict(lr=3e-3, warmup_steps=1, decay_steps=4)
LAYOUTS = {"span": (True, True), "pods hold the partition": (True, False),
           "replicated": (False, False)}
GRAD_CASES = [dict(kind="grads", method=m, part=p, span=s)
              for m in ("layered", "standard") for p, s in LAYOUTS.values()]
TRAIN_CASES = [dict(kind="train", fused=False, steps=2, data=DATA, opt=OPT, part=p, span=s)
               for p, s in LAYOUTS.values()]
TRAIN_CASES.append(dict(kind="train", fused=False, steps=2, data=DATA, opt=OPT, part=True,
                        span=True, method="standard"))
# the §C.3 fused step under span against the classic one, both at grad_clip=0
FUSED_CASES = [dict(kind="train", fused=f, steps=2, data=DATA, opt=dict(OPT, grad_clip=0.0),
                    part=True, span=True) for f in (False, True)]


@pytest.fixture(scope="module")
def weights():
    """The weights (numpy, global, ``numpy_params``) and a micro-batched
    batch of 4 rows a micro-batch."""
    params = numpy_params(TCFG, 2)
    toks = np.random.default_rng(3).integers(0, 64, (M, 4, 16), dtype=np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=-1), "mask": np.ones_like(toks)}
    return params, batch


@pytest.fixture(scope="module")
def spawn(tmp_path_factory, weights):
    params, batch = weights
    s = Spawn(tmp_path_factory.mktemp("pods"), "pods", (NPOD, NDATA, TP),
              GRAD_CASES + TRAIN_CASES + FUSED_CASES, params, batch, pods=True)
    yield s
    s.kill()


@pytest.fixture(scope="module")
def jax_refs(weights, mesh_pod):
    """``jax.grad`` of the global batch's loss; JAX's layered ``make_grad_fn``
    under span, gathered to full leaves; and 2 steps of JAX's
    ``build_train_step`` under span: per-step metrics, final full weights."""
    params, batch = weights
    jcfg = dataclasses.replace(JCFG, kernels=False)
    flat = {k: jnp.asarray(v).reshape(M * 4, 16) for k, v in batch.items()}

    def loss(p):
        _, (nll, n) = JT.loss_fn(jcfg, p, flat, JAxisCtx(), remat=False)
        return nll / n

    grad = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray, params)))
    axis = jstepfn.axis_ctx(mesh_pod)
    tmpl = jstepfn.full_template(jcfg)
    acc = JAccumConfig("layered", True, M, span_pods=True)
    sspecs = jstepfn.storage_specs(jcfg, axis, True, span_pods=True)
    storage = _jax_storage(jcfg, mesh_pod, params)
    fn = compat.shard_map(jmake_grad_fn(jcfg, axis, acc, tmpl), mesh=mesh_pod,
                          in_specs=(sspecs, jstepfn.batch_specs(jcfg, axis, microbatched=True)),
                          out_specs=(sspecs, {"loss": P(), "ntok": P(), "aux": P()}))
    chunks, _ = jax.jit(fn)(storage, {k: jnp.asarray(v) for k, v in batch.items()})
    span_grads = _unchunk(jax.tree.map(np.asarray, chunks))
    step = jstepfn.build_train_step(jcfg, mesh_pod, acc, JAdamConfig(**OPT), donate=False)
    opt = jadam_init(storage)
    recs = []
    for i in range(2):
        storage, opt, m = step(storage, opt, jmake_batch(JDataConfig(**DATA), i))
        recs.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
    return grad, span_grads, recs, _unchunk(jax.tree.map(np.asarray, storage))


def _jax_storage(jcfg, mesh, params):
    """The global weights in JAX's span layout, placed on ``mesh``."""
    axis = jstepfn.axis_ctx(mesh)
    specs = jstepfn.storage_specs(jcfg, axis, True, span_pods=True)
    chunked = tree.tree_map_with_path(
        lambda path, a, sp: zp.host_partition_leaf(a, TP, NPOD * NDATA,
                                                   stacked=path[0] == "layers",
                                                   model_dim=zp.model_dim(sp)),
        {k: v for k, v in params.items() if k != "shared"}, T.param_specs(TCFG, TP))
    placed = tree.tree_map(lambda a, sp: jax.device_put(a, jax.sharding.NamedSharding(mesh, sp)),
                           chunked, {k: specs[k] for k in chunked})
    return dict(placed, **{k: {} for k in specs if k not in chunked})


def _unchunk(chunks: dict) -> dict:
    """Global ``[L?, n_model, pod * data, chunk]`` leaves -> full leaves."""
    return tree.tree_map_with_path(
        lambda path, c, shape, sp: zp.host_unpartition_leaf(
            c, tuple(shape), TP, stacked=path[0] == "layers", model_dim=zp.model_dim(sp)),
        {k: v for k, v in chunks.items() if k != "shared"}, stepfn.full_template(TCFG),
        T.param_specs(TCFG, TP))


def _full(outs: list, which, part: bool, span: bool) -> dict:
    """The ranks' storage-layout trees (``which(rank's output)``) -> full
    leaves: under span the partition index is ``p * ndata + d``; otherwise
    both pods must hold the same values, and pod 0's are assembled."""
    if span:
        return _global([dict(o, data_index=o["pod_index"] * NDATA + o["data_index"])
                        for o in outs], which, TP, True)
    by_pod = {p: [o for o in outs if o["pod_index"] == p] for p in range(NPOD)}
    for a, b in zip(by_pod[0], by_pod[1]):
        assert (a["data_index"], a["model_index"]) == (b["data_index"], b["model_index"])
        for (path, x), y in zip(tree.leaves_with_path(which(a)), tree.leaves(which(b))):
            np.testing.assert_array_equal(x, y, err_msg=f"pods differ at {path}")
    return _global(by_pod[0], which, TP, part)


def _grad_index(method, part, span) -> int:
    return GRAD_CASES.index(dict(kind="grads", method=method, part=part, span=span))


@pytest.mark.parametrize("method", ["layered", "standard"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_grads_match_jax(spawn, jax_refs, method, layout):
    """Every rank's gradient, assembled, against ``jax.grad`` of the global
    batch; the layered span case also against JAX's ``make_grad_fn`` under
    span; the loss equal on every rank."""
    part, span = LAYOUTS[layout]
    grad, span_grads, _, _ = jax_refs
    outs = spawn.result()
    i = _grad_index(method, part, span)
    got = _full(outs, lambda o: o["results"][i]["grads"], part, span)
    want = {k: v for k, v in grad.items() if k != "shared"}
    for (path, a), b in zip(tree.leaves_with_path(got), tree.leaves(want)):
        np.testing.assert_allclose(a, b, err_msg=str(path), **TOL)
    if (method, span) == ("layered", True):
        for (path, a), b in zip(tree.leaves_with_path(got), tree.leaves(span_grads)):
            np.testing.assert_allclose(a, b, err_msg=str(path), **TOL)
    assert len({o["results"][i]["loss"] for o in outs}) == 1


def _leaf_bytes(n: int, size: int) -> int:
    """fp32 bytes of a leaf of ``n`` elements padded to ``size`` chunks."""
    return 4 * size * math.ceil(n / size)


def _local_numels() -> tuple[list, list]:
    """Model-local numels of the layer leaves (one layer) and outer leaves."""
    specs = T.param_specs(TCFG, TP)
    shapes = tree.tree_map(lambda s, sp: zp.local_shape(tuple(s), sp, TP),
                           stepfn.full_template(TCFG), specs)
    layer = [math.prod(s[1:]) for s in tree.leaves(shapes["layers"])]
    outer = [math.prod(s) for k, v in shapes.items() if k != "layers" for s in tree.leaves(v)]
    return layer, outer


def _want_counts(method: str, part: bool, span: bool) -> dict:
    """(group, op) -> [calls, bytes] of one ``grad_fn`` call on the data, pod
    and partition groups, from the code: a layered partitioned step gathers
    each layer leaf twice (forward, backward) and each outer leaf once, and
    reduce-scatters each once, over ``part`` under span (4 chunks), else over
    ``data`` (2 chunks) after an fp32 all-reduce of the whole gradient over
    ``pod``; the standard schedule does so once a micro-batch.  Replicated,
    every layer leaf of each layer (layered) or every stacked leaf
    (standard), and each outer leaf, is all-reduced over data, then pod.
    The token count and the metrics [nll, ntok, aux] are all-reduced over
    data, then pod, in each case."""
    layer, outer = _local_numels()
    reps = 1 if method == "layered" else M
    scalars = 4 + 12
    if not part:
        n_ar = (len(layer) * (L if method == "layered" else 1) + len(outer))
        b_ar = 4 * (L * sum(layer) + sum(outer)) + scalars
        return {("data", "all_reduce"): [n_ar + 2, b_ar], ("pod", "all_reduce"): [n_ar + 2, b_ar]}
    g, size = ("part", NPOD * NDATA) if span else ("data", NDATA)
    gathered = 2 * L * sum(_leaf_bytes(n, size) for n in layer) + sum(
        _leaf_bytes(n, size) for n in outer)
    scattered = L * sum(_leaf_bytes(n, size) for n in layer) + sum(
        _leaf_bytes(n, size) for n in outer)
    want = {(g, "all_gather"): [reps * (2 * N_LAYER_LEAVES * L + N_OUTER_LEAVES),
                                reps * gathered],
            (g, "reduce_scatter"): [reps * (N_LAYER_LEAVES * L + N_OUTER_LEAVES),
                                    reps * scattered],
            ("data", "all_reduce"): [2, scalars], ("pod", "all_reduce"): [2, scalars]}
    if not span:   # the whole gradient over pod, unpadded, once a reduce-scatter
        want[("pod", "all_reduce")] = [
            2 + reps * (N_LAYER_LEAVES * L + N_OUTER_LEAVES),
            scalars + reps * 4 * (L * sum(layer) + sum(outer))]
    return want


@pytest.mark.parametrize("method", ["layered", "standard"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_collective_counts_are_exact(spawn, method, layout):
    """Calls and bytes of every (group, op) on the data, pod and partition
    groups, on every rank, as reckoned from the code; the model group's the
    same in every layout (the pods do not touch tensor parallelism)."""
    part, span = LAYOUTS[layout]
    outs = spawn.result()
    i = _grad_index(method, part, span)
    ref = _grad_index(method, True, False)
    want = _want_counts(method, part, span)
    for o in outs:
        counts = o["results"][i]["counts"]
        got = {k: list(v) for k, v in counts.items() if k[0] != "model"}
        assert got == want, f"rank {o['rank']}"
        model = {k: v for k, v in counts.items() if k[0] == "model"}
        assert model == {k: v for k, v in o["results"][ref]["counts"].items()
                         if k[0] == "model"}


@pytest.mark.parametrize("case", range(len(TRAIN_CASES)),
                         ids=[f"{c.get('method', 'layered')}-"
                              f"{[k for k, v in LAYOUTS.items() if v == (c['part'], c['span'])][0]}"
                              for c in TRAIN_CASES])
def test_train_steps_match_jax(spawn, jax_refs, case):
    """Two steps of ``build_train_step``: loss, grad norm and lr per step on
    every rank, and the final weights (``W_TOL``), against JAX's span step
    (every layout takes the same step); under span the grad norm's square is summed over
    the pod group too, and partitioned, every rank's K6 chunk update is its
    own; the norm's pod all-reduce is the only one the update adds."""
    _, _, recs, final = jax_refs
    c = TRAIN_CASES[case]
    outs = spawn.result()
    i = len(GRAD_CASES) + case
    for o in outs:
        for s, (g, w) in enumerate(zip(o["results"][i]["records"], recs)):
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(g[k], w[k], err_msg=f"step {s} {k}", **TOL)
            pod = _want_counts(c.get("method", "layered"), c["part"], c["span"])
            assert g["counts"][("pod", "all_reduce")][0] == \
                pod[("pod", "all_reduce")][0] + (1 if c["span"] else 0), (o["rank"], s)
    got = _full(outs, lambda o: o["results"][i]["storage"], c["part"], c["span"])
    for (path, a), b in zip(tree.leaves_with_path(got), tree.leaves(final)):
        np.testing.assert_allclose(a, b, err_msg=str(path), **W_TOL)


def test_fused_step_spans_the_pods(spawn):
    """``build_fused_train_step`` under span: with grad_clip=0 its arithmetic
    is the classic step's (tests/test_torch_dist.py's fused case), so the
    same losses (1e-6) and final chunks (1e-6) on every rank, and the same
    gathers and reduce-scatters on the partition group."""
    outs = spawn.result()
    i = len(GRAD_CASES) + len(TRAIN_CASES)
    for o in outs:
        classic, fused = o["results"][i], o["results"][i + 1]
        np.testing.assert_allclose([r["loss"] for r in fused["records"]],
                                   [r["loss"] for r in classic["records"]], rtol=1e-6)
        for (path, x), y in zip(tree.leaves_with_path(classic["storage"]),
                                tree.leaves(fused["storage"])):
            np.testing.assert_allclose(y, x, rtol=0, atol=1e-6, err_msg=str(path))
        for key in (("part", "all_gather"), ("part", "reduce_scatter")):
            assert fused["records"][0]["counts"][key] == classic["records"][0]["counts"][key]


def test_storage_specs_match_jax(mesh_pod):
    """``storage_specs(span_pods=)`` names JAX's dims: ``("pod", "data")``
    in place of ``"data"`` under span on a grid with pods, ``"data"`` without
    span or without pods."""
    jaxis = jstepfn.axis_ctx(mesh_pod)
    for span in (False, True):
        want = jstepfn.storage_specs(JCFG, jaxis, True, span_pods=span)
        wants = {tuple(p.key for p in path): tuple(sp)
                 for path, sp in jax.tree_util.tree_leaves_with_path(
                     want, is_leaf=lambda x: isinstance(x, P))}
        got = stepfn.storage_specs(TCFG, dist.AxisCtx(tp=TP, ndata=NDATA, npod=NPOD), True,
                                   span_pods=span)
        assert dict(tree.leaves_with_path(got)) == wants
    flat = stepfn.storage_specs(TCFG, dist.AxisCtx(tp=TP, ndata=NDATA), True, span_pods=True)
    assert all("pod" not in str(sp) for sp in tree.leaves(flat))


def test_pods_with_stages_are_refused():
    """JAX's pipeline and tick profiler have no pod axis."""
    with pytest.raises(ValueError, match="pipeline and tick profiler have no pod axis"):
        dist.make_axis(2, 1, 2, npod=2)


def test_expert_parallel_with_pods_is_refused():
    """JAX's expert-parallel step does not trace on a pod mesh (ROADMAP.md §3)."""
    cfg = configs.get_config("dbrx-132b", smoke=True)
    axis = dist.AxisCtx(ndata=2, npod=2)
    with pytest.raises(ValueError, match="expert parallelism with pods is not ported"):
        make_grad_fn(cfg, AccumConfig(expert_parallel=True), stepfn.full_template(cfg),
                     axis=axis)
    assert "does not trace on a pod mesh" in EP_PODS_REFUSAL
