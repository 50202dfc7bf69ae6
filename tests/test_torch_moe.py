"""The port's mixture-of-experts slice against the JAX package, on the CPU,
with the same weights (converted through numpy) and the same inputs; the JAX
side runs with its kernels off (``kernels=False``), as the reference's
shard_map path needs on this JAX.

  * ``apply_moe`` (the dense one-hot dispatch) at ``tests/test_moe.py``'s
    config and the dbrx-132b and arctic-480b smoke configs, capacity factors
    0.25, 1.25 and 8.0: router ids equal, weights, aux and output to 1e-5,
    and the gradients of every input against ``jax.grad``;
  * the serving engine on one trace: greedy tokens equal;
  * both accumulation schedules, in the replicated, partitioned and
    expert-resident layouts: gradients leaf by leaf, loss and aux;
  * on gloo (``tests/torch_moe_ranks.py``): the all-to-all dispatch against
    the dense one at 2x2, and 3-step trajectories with the experts over the
    model group (1x2, 2x2, standard and layered) and resident over the data
    group (``expert_parallel``, 2x1 and 2x2, and the §C.3 fused step at
    2x1), each against JAX ``build_train_step`` on the same mesh.
"""
import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import stepfn as jstepfn
from repro.core.accumulation import AccumConfig as JAccumConfig
from repro.core.partition import host_unpartition_leaf as jhost_unpartition
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import make_batch as jmake_batch
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro.models.common import AxisCtx as JAxisCtx
from repro.models.common import ModelConfig as JModelConfig
from repro.optim.adam import AdamConfig as JAdamConfig
from repro.optim.adam import adam_init as jadam_init
from repro.serving.cache import PagedCacheConfig as JPagedCacheConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import SchedulerConfig as JSchedulerConfig
from repro_torch import configs, tree
from repro_torch.convert import params_from_numpy, storage_from_numpy
from repro_torch.core import partition as zp
from repro_torch.core import stepfn
from repro_torch.core.accumulation import AccumConfig, make_grad_fn
from repro_torch.core.dist import AxisCtx
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.serving.cache import PagedCacheConfig
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import Request, SchedulerConfig
from test_torch_dist import Spawn

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_moe_ranks.py"

# tests/test_moe.py's CFG
TINY = dict(name="m", arch_type="moe", num_layers=1, d_model=32, num_heads=4,
            num_kv_heads=4, d_ff=64, vocab_size=64, num_experts=4, experts_per_token=2,
            dtype="float32", param_dtype="float32")
SMOKES = ("dbrx-132b", "arctic-480b")
CONFIGS = {"tiny": (JModelConfig(**TINY), ModelConfig(**TINY))} | {
    f"{a}-smoke": (jconfigs.get_config(a, smoke=True), configs.get_config(a, smoke=True))
    for a in SMOKES}
FP32 = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=3e-4, atol=3e-5)        # tests/test_accumulation.py's


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's small shapes: beside the other
    test processes and the gloo ranks, more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch(tree_np) -> dict:
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree_np)


def _shapes(jcfg) -> dict:
    """The JAX parameter tree's leaf shapes by path."""
    return {tuple(p.key for p in path): tuple(leaf.shape) for path, leaf in
            jax.tree_util.tree_leaves_with_path(
                jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0))))}


def _leaves(want) -> dict:
    return {tuple(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(want)}


def _compare(got: dict, want, **tol):
    pairs, wants = list(tree.leaves_with_path(got)), _leaves(want)
    assert sorted(p for p, _ in pairs) == sorted(wants)
    for path, leaf in pairs:
        np.testing.assert_allclose(np.asarray(leaf), wants[path], err_msg=str(path), **tol)


# ---------------------------------------------------------------------------
# The MoE block
# ---------------------------------------------------------------------------
def _block(name):
    jcfg, tcfg = CONFIGS[name]
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    p = jmoe.init_moe(jcfg, jax.random.PRNGKey(0))
    x = np.random.default_rng(0).standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, p, x


@pytest.mark.parametrize("cf", [0.25, 1.25, 8.0])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_apply_moe_matches_jax(name, cf):
    """Router ids equal; combine weights, aux and the block's output to 1e-5
    (0.25 drops most assignments, 8.0 none)."""
    jcfg, tcfg, p, x = _block(name)
    tp = _torch(p)
    w, ids, aux = jmoe._router(jcfg, p, jnp.asarray(x.reshape(-1, jcfg.d_model)))
    tw, tids, taux = moe._router(tcfg, tp, torch.tensor(x.reshape(-1, tcfg.d_model)))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(w), **FP32)
    np.testing.assert_allclose(taux.item(), float(aux), **FP32)
    cap = jmoe.expert_capacity(jcfg, x.shape[0] * x.shape[1], factor=cf)
    assert moe.expert_capacity(tcfg, x.shape[0] * x.shape[1], factor=cf) == cap
    slot, keep = jmoe._slots(jcfg, ids, cap)
    tslot, tkeep = moe._slots(tcfg, tids, cap)
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(slot))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(keep))
    y, _ = jmoe.apply_moe(jcfg, p, jnp.asarray(x), JAxisCtx(), capacity_factor=cf)
    ty, taux2 = moe.apply_moe(tcfg, tp, torch.tensor(x), capacity_factor=cf)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **FP32)
    assert taux2.item() == taux.item()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_apply_moe_grads_match_jax(name):
    """The gradients of ``sum(y * r) + aux`` with respect to every parameter
    and the input against ``jax.grad`` (capacity 1.25, some drops)."""
    jcfg, tcfg, p, x = _block(name)
    r = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)

    def f(p, x):
        y, aux = jmoe.apply_moe(jcfg, p, x, JAxisCtx())
        return jnp.sum(y * r) + aux

    gp, gx = jax.grad(f, argnums=(0, 1))(p, jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a)).requires_grad_(), p)
    tx = torch.tensor(x, requires_grad=True)
    y, aux = moe.apply_moe(tcfg, tp, tx)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum() + aux,
                                [tx] + tree.leaves(tp))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx), **GRAD)
    _compare(_unflatten(tp, grads[1:]), gp, **GRAD)


def _unflatten(like: dict, leaves: list) -> dict:
    """``leaves`` (in ``tree.leaves`` order) as numpy in ``like``'s tree."""
    out: dict = {}
    for (path, _), g in zip(tree.leaves_with_path(like), leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = g.numpy()
    return out


def test_router_weights_normalised():
    """tests/test_moe.py's router check on the port: weights sum to 1, aux is
    at least 1 (Cauchy-Schwarz), ids in range."""
    jcfg, tcfg, p, _ = _block("tiny")
    x = torch.randn(16, 32, generator=torch.Generator().manual_seed(2))
    w, ids, aux = moe._router(tcfg, _torch(p), x)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert aux.item() >= 1.0 - 1e-3
    assert bool(((ids >= 0) & (ids < tcfg.num_experts)).all())


@pytest.mark.parametrize("arch", SMOKES)
def test_counts_and_specs_match_jax(arch):
    """Parameter counts (all and active), the layer's partition specs at tp
    1, 2 and 4 and the parameter tree's shapes equal the JAX package's; the
    router is fp32 in the port's parameters."""
    for smoke in (False, True):
        jcfg, tcfg = jconfigs.get_config(arch, smoke=smoke), configs.get_config(arch, smoke=smoke)
        for active in (False, True):
            assert tcfg.param_count(active_only=active) == jcfg.param_count(active_only=active)
    jcfg, tcfg = CONFIGS[f"{arch}-smoke"]
    for tp in (1, 2, 4):
        want = {tuple(p.key for p in path): tuple(sp) for path, sp in
                jax.tree_util.tree_leaves_with_path(
                    JT.layer_specs(jcfg, tp),
                    is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))}
        assert dict(tree.leaves_with_path(T.layer_specs(tcfg, tp))) == want
    assert _shapes(jcfg) == dict(tree.leaves_with_path(stepfn.full_template(tcfg)))
    params = params_from_numpy(tcfg, jax.tree.map(
        np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0))))
    assert all(lp["moe"]["router"].dtype == torch.float32 for lp in params["layers"])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", SMOKES)
def test_engine_matches_jax(arch):
    """dbrx-132b and arctic-480b smoke through the port's ServingEngine and
    JAX's on one trace (ragged prompts, staggered arrivals, idle slots): the
    greedy tokens and the stats equal."""
    jcfg, tcfg = CONFIGS[f"{arch}-smoke"]
    jcfg = dataclasses.replace(jcfg, kernels=False)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(3)
    reqs = [dict(rid=i, prompt=tuple(int(t) for t in rng.integers(0, tcfg.vocab_size, pl)),
                 max_new_tokens=mn, arrival=arr)
            for i, (pl, mn, arr) in enumerate([(5, 6, 0), (9, 5, 1), (3, 7, 2), (12, 4, 4)])]
    pool = dict(num_blocks=32, block_size=4, max_blocks_per_seq=5)
    jeng = JServingEngine(jcfg, jparams, JSchedulerConfig(cache=JPagedCacheConfig(**pool),
                                                          max_batch=3))
    teng = ServingEngine(tcfg, tparams, SchedulerConfig(cache=PagedCacheConfig(**pool),
                                                        max_batch=3))
    jeng.submit_all([JRequest(**r) for r in reqs])
    teng.submit_all([Request(**r) for r in reqs])
    want, got = jeng.run(max_steps=200), teng.run(max_steps=200)
    assert sorted(got) == list(range(len(reqs)))
    assert got == want and teng.stats == jeng.stats


def test_serve_reads_a_jax_moe_checkpoint(tmp_path):
    """A params checkpoint the JAX store writes for dbrx-132b smoke (the
    full tree, router and expert stacks included) served by the port's
    ``launch.serve --checkpoint-dir``: the same tokens as JAX's engine on
    the same weights and ``launch.serve``'s trace."""
    from repro.checkpointing import store as jstore
    from repro.serving.scheduler import poisson_trace as jpoisson_trace
    from repro_torch.launch import serve

    jcfg = dataclasses.replace(CONFIGS["dbrx-132b-smoke"][0], kernels=False)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(5))
    jstore.save_state(str(tmp_path), jparams, step=7)
    argv = ["--arch", "dbrx-132b", "--smoke", "--device", "cpu", "--requests", "4",
            "--prompt-lens", "5,9", "--max-new", "3,6", "--num-blocks", "32",
            "--checkpoint-dir", str(tmp_path)]
    got = serve.main(argv)["outputs"]
    pool = JPagedCacheConfig(num_blocks=32, block_size=8, max_blocks_per_seq=2)
    jeng = JServingEngine(jcfg, jparams, JSchedulerConfig(cache=pool, max_batch=8))
    jeng.submit_all(jpoisson_trace(np.random.default_rng(0), n_requests=4, rate=0.5,
                                   vocab=jcfg.vocab_size, prompt_lens=[5, 9],
                                   max_new=[3, 6]))
    assert got == jeng.run(max_steps=200)


# ---------------------------------------------------------------------------
# Training, one process
# ---------------------------------------------------------------------------
M = 2


@pytest.fixture(scope="module", params=SMOKES)
def reference(request):
    """The JAX weights, a batch of M micro-batches, and the JAX gradient of
    the accumulated loss: each micro-batch's summed nll over the batch's
    tokens plus ``router_aux_weight * aux / (M * L)``, its layers' summed
    aux (``repro/core/accumulation.py``'s loss at one data rank); each
    micro-batch's nll and aux beside it."""
    jcfg, tcfg = CONFIGS[f"{request.param}-smoke"]
    jcfg = dataclasses.replace(jcfg, kernels=False)
    params = JT.init_params(jcfg, jax.random.PRNGKey(1))
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (M, 2, 16)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=-1), "mask": np.ones_like(toks)}
    n, L = toks.size, jcfg.num_layers

    def loss(p):
        tot, nlls, auxs = 0.0, [], []
        for m in range(M):
            mb = {k: jnp.asarray(v[m]) for k, v in batch.items()}
            x, aux = JT.forward(jcfg, p, mb, JAxisCtx(), remat=False)
            nll = JT.head_loss(jcfg, p, x, mb, JAxisCtx())
            tot = tot + nll / n + jcfg.router_aux_weight * aux / (M * L)
            nlls.append(nll)
            auxs.append(aux)
        return tot, (jnp.stack(nlls), jnp.stack(auxs))

    (_, (nlls, auxs)), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return (tcfg, jax.tree.map(np.asarray, params), batch,
            {k: v for k, v in grads.items() if k != "shared"}, np.asarray(nlls),
            np.asarray(auxs))


def _full(cfg, storage, layout) -> dict:
    """One process's storage -> the JAX tree's full leaves (numpy)."""
    tmpl = stepfn.full_template(cfg)

    def one(path, leaf, shape):
        a = leaf.detach().numpy()
        if layout == "replicated" or (layout == "resident" and zp.is_expert_path(path)):
            return a
        return zp.host_unpartition_leaf(a, shape, 1, stacked=path[0] == "layers")
    return tree.tree_map_with_path(one, storage, tmpl)


@pytest.mark.parametrize("layout", ["replicated", "partitioned", "resident"])
@pytest.mark.parametrize("method", ["standard", "layered"])
def test_grads_match_reference(reference, method, layout):
    """Gradients leaf by leaf at 3e-4 / 3e-5 (the router's aux included), the
    loss to 1e-5 and the aux metric as the JAX schedules report it: the
    layered one the layers' mean of the micro-batches' sum, the standard one
    the micro-batches' mean of the layers' sum."""
    tcfg, params, batch, want, nlls, auxs = reference
    part = layout != "replicated"
    storage = storage_from_numpy(tcfg, params, partitioned=part,
                                 expert_resident=layout == "resident")
    acc = AccumConfig(method=method, partitioned=part, n_microbatches=M,
                      expert_parallel=layout == "resident")
    grads, m = make_grad_fn(tcfg, acc, stepfn.full_template(tcfg))(
        storage, {k: torch.from_numpy(v) for k, v in batch.items()})
    _compare(_full(tcfg, grads, layout), want, **GRAD)
    np.testing.assert_allclose(m["loss"].item(), nlls.sum() / batch["mask"].sum(), **FP32)
    aux = auxs.sum() / tcfg.num_layers if method == "layered" else auxs.mean()
    np.testing.assert_allclose(m["aux"].item(), aux, **FP32)


def test_expert_parallel_needs_the_partitioned_layout():
    tcfg = CONFIGS["dbrx-132b-smoke"][1]
    with pytest.raises(ValueError, match="partitioned"):
        make_grad_fn(tcfg, AccumConfig(partitioned=False, expert_parallel=True),
                     stepfn.full_template(tcfg))


# ---------------------------------------------------------------------------
# On gloo: the all-to-all dispatch and trajectories against JAX's steps
# ---------------------------------------------------------------------------
# tests/test_moe.py's expert-parallel config with 4 experts and arctic's
# dense residual FFN: 2 experts a rank over 2 model or 2 data ranks
GCFG = dict(name="ep", arch_type="moe", num_layers=2, d_model=32, num_heads=4,
            num_kv_heads=2, d_ff=64, vocab_size=64, num_experts=4, experts_per_token=2,
            moe_dense_residual=True, moe_dense_ff=32, dtype="float32",
            param_dtype="float32")
GDATA = dict(vocab_size=64, seq_len=16, global_batch=8, n_microbatches=M, noise=0.02)
GOPT = dict(lr=3e-3, warmup_steps=1, decay_steps=100)
STEPS = 3
# final weights: Adam normalises each element's update by its own gradient,
# so where an expert's gradient is near zero its fp32 rounding moves the
# weight by a few percent of one step (lr 3e-3); a gradient that is wrong
# moves it by the whole step
W_ATOL = 1e-4


def _train(method="layered", ep=False, fused=False):
    return dict(kind="mtrain", method=method, ep=ep, fused=fused, steps=STEPS, data=GDATA,
                opt=GOPT)


def _a2a_case(cf):
    rng = np.random.default_rng(5)
    return dict(kind="a2a", cf=cf, x=rng.standard_normal((4, 8, 32)).astype(np.float32),
                r=rng.standard_normal((4, 8, 32)).astype(np.float32))


G_CASES = {
    "1x2": [_train()],
    "2x2": [_train(), _train("standard"), _train(ep=True), _a2a_case(8.0), _a2a_case(1.25)],
    # no clipping at 2x1: the classic and the fused step then make the same
    # update, held to one JAX run
    "2x1": [dict(_train(ep=True), opt=dict(GOPT, grad_clip=0.0)),
            dict(_train(ep=True, fused=True), opt=dict(GOPT, grad_clip=0.0))],
}
G_MESHES = {"1x2": (1, 2), "2x2": (2, 2), "2x1": (2, 1)}


@pytest.fixture(scope="module")
def gweights():
    jcfg = JModelConfig(**GCFG, kernels=False)
    return jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module", autouse=True)
def gspawns(tmp_path_factory, gweights):
    """Every mesh's ranks, started with the module so that they run while
    the one-process tests do."""
    tmp = tmp_path_factory.mktemp("moe")
    out = {name: Spawn(tmp, name, G_MESHES[name], cases, gweights, None, worker=WORKER,
                       cfg=GCFG)
           for name, cases in G_CASES.items()}
    yield out
    for s in out.values():
        s.kill()


@functools.lru_cache(maxsize=None)
def _jax_run(shape, ep=False):
    """3 steps of JAX ``build_train_step``, layered and partitioned, kernels
    off, on a ``shape`` (data, model) mesh from ``gweights``' weights
    (``init_storage`` draws them from the same key), clipping as
    ``G_CASES`` does on that mesh: the records and the final full leaves."""
    mesh = jax.make_mesh(shape, ("data", "model"))
    jcfg = JModelConfig(**GCFG, kernels=False)
    acc = JAccumConfig("layered", True, M, expert_parallel=ep)
    opt = G_CASES[_name(shape)][0]["opt"]
    step = jstepfn.build_train_step(jcfg, mesh, acc, JAdamConfig(**opt), donate=False)
    storage = jstepfn.init_storage(jcfg, mesh, jax.random.PRNGKey(0), partitioned=True,
                                   expert_resident=ep)
    opt = jadam_init(storage)
    recs = []
    for i in range(STEPS):
        storage, opt, m = step(storage, opt, jmake_batch(JDataConfig(**GDATA), i))
        recs.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr", "aux")})
    tp = dict(zip(mesh.axis_names, mesh.devices.shape))["model"]
    tmpl = _shapes(jcfg)
    specs = {tuple(p.key for p in path): sp for path, sp in jax.tree_util.tree_leaves_with_path(
        JT.param_specs(jcfg, tp), is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))}
    full = {}
    for path, leaf in _leaves(storage).items():
        if ep and zp.is_expert_path(path):
            full[path] = leaf
        else:
            full[path] = jhost_unpartition(leaf, tmpl[path], specs[path], tp,
                                           stacked=path[0] == "layers")
    return recs, full


def _name(shape) -> str:
    return "x".join(map(str, shape))


def _port_full(outs, mesh, ep) -> dict:
    """Every rank's final storage -> the full leaves: ZeRO blocks into
    ``[L?, n_model, n_data, chunk]`` and out of it, resident expert blocks
    along their data and model dims."""
    nd, tp = mesh
    tcfg = ModelConfig(**GCFG)
    tmpl = stepfn.full_template(tcfg)
    specs = dict(tree.leaves_with_path(stepfn.storage_specs(
        tcfg, AxisCtx(tp=tp, ndata=nd), True, expert_resident=ep)))
    pspecs = dict(tree.leaves_with_path(T.param_specs(tcfg, tp)))
    by = {(o["data_index"], o["model_index"]): o["storage"] for o in outs}
    full = {}
    for path, shape in tree.leaves_with_path(tmpl):
        blocks = {k: _at(v, path) for k, v in by.items()}
        if ep and zp.is_expert_path(path):
            spec = specs[path]
            dd, mm = spec.index("data"), spec.index("model") if "model" in spec else None
            rows = [np.concatenate([blocks[d, m] for m in range(tp)], mm) if mm else blocks[d, 0]
                    for d in range(nd)]
            full[path] = np.concatenate(rows, dd)
        else:
            n_model = tp if "model" in pspecs[path] else 1
            chunks = np.concatenate([np.concatenate([blocks[d, m] for d in range(nd)], -2)
                                     for m in range(n_model)], -3)
            full[path] = zp.host_unpartition_leaf(chunks, shape, tp, stacked=path[0] == "layers",
                                                  model_dim=zp.model_dim(pspecs[path]))
    return full


def _at(t, path):
    for k in path:
        t = t[k]
    return t


def _results(spawn, i):
    outs = spawn.result()
    recs = [o["results"][i]["records"] for o in outs]
    for r in recs[1:]:                       # every rank reports the same metrics
        assert [x["loss"] for x in r] == [x["loss"] for x in recs[0]]
    return recs[0], [dict(o, storage=o["results"][i]["storage"]) for o in outs]


def _check_records(got, want, keys=("loss", "grad_norm", "lr", "aux"), rtol=1e-5):
    for i, (g, w) in enumerate(zip(got, want)):
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=f"step {i} {k}")


@pytest.mark.parametrize("mesh,i,method", [("1x2", 0, "layered"), ("2x2", 0, "layered"),
                                           ("2x2", 1, "standard")])
def test_experts_over_the_model_group_match_jax(gspawns, gweights, mesh, i, method):
    """The training layout, experts over the model group: 3 steps against
    JAX's layered step on the same mesh (the standard schedule's too: its
    gradients are the layered one's, and at L = M its aux metric as well):
    loss, grad norm, lr and aux to 1e-5 relative, the final weights to
    ``W_ATOL``."""
    shape = G_MESHES[mesh]
    want, wfull = _jax_run(shape)
    got, outs = _results(gspawns[mesh], i)
    _check_records(got, want)
    for path, w in _port_full(outs, shape, False).items():
        np.testing.assert_allclose(w, wfull[path], rtol=0, atol=W_ATOL, err_msg=str(path))


@pytest.mark.parametrize("mesh,i", [("2x1", 0), ("2x2", 2)])
def test_expert_parallel_matches_jax(gspawns, gweights, mesh, i):
    """Resident experts over the data group, tokens by all-to-all: 3 steps
    against JAX's step on the same mesh with the experts gathered (loss,
    grad norm, lr and aux to 1e-5, final weights to ``W_ATOL``; at 2x1
    without clipping, so the grad norm reads 0); at 2x2 also against JAX's
    own expert-parallel step (losses to 2e-4, tests/test_moe.py's tolerance;
    its grad norm counts the experts' share over the data group twice, and at
    2x1 it does not trace on this JAX: ROADMAP.md §3).  Each layered step
    sends 2 all-to-alls a layer and micro-batch in the forward, 2 in the
    recompute and 2 in the backward."""
    shape = G_MESHES[mesh]
    want, wfull = _jax_run(shape)
    got, outs = _results(gspawns[mesh], i)
    _check_records(got, want)
    if shape[1] > 1:
        want_ep, _ = _jax_run(shape, ep=True)
        _check_records(got, want_ep, keys=("loss",), rtol=2e-4)
        assert want_ep[0]["grad_norm"] > want[0]["grad_norm"] * (1 + 1e-4)
    for path, w in _port_full(outs, shape, True).items():
        np.testing.assert_allclose(w, wfull[path], rtol=0, atol=W_ATOL, err_msg=str(path))
    L = GCFG["num_layers"]
    for r in got:
        calls, nbytes = r["counts"][("expert", "all_to_all")]
        assert calls == 6 * L * M and nbytes > 0
        assert ("data", "reduce_scatter") in r["counts"]


def test_fused_expert_parallel_step_matches_jax(gspawns, gweights):
    """The §C.3 fused step with resident experts at 2x1, no clipping (a
    resident block and a chunk would clip by different norms), against JAX's
    classic step with the experts gathered, which makes the same update
    without clipping: loss, lr and aux to 1e-5 relative, grad norm 0, final
    weights to ``W_ATOL``."""
    want, wfull = _jax_run(G_MESHES["2x1"])
    got, outs = _results(gspawns["2x1"], 1)
    _check_records(got, want, keys=("loss", "lr", "aux"))
    assert all(r["grad_norm"] == 0.0 for r in got)
    for path, w in _port_full(outs, G_MESHES["2x1"], True).items():
        np.testing.assert_allclose(w, wfull[path], rtol=0, atol=W_ATOL, err_msg=str(path))


@pytest.mark.parametrize("i,cf", [(3, 8.0), (4, 1.25)])
def test_a2a_matches_dense_dispatch(gspawns, i, cf):
    """tests/test_moe.py::test_a2a_matches_dense_dispatch on gloo at 2x2: the
    experts over the data group and their hidden dim over the model group,
    the outputs and the input gradients of each rank's rows against the dense
    dispatch of the whole layer (2e-4 / 2e-5, the JAX test's tolerance); two
    all-to-alls forward, two backward."""
    for o in gspawns["2x2"].result():
        res = o["results"][i]
        np.testing.assert_allclose(res["y"], res["y_ref"], rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(res["g"], res["g_ref"], rtol=2e-4, atol=2e-5)
        assert res["counts"][("expert", "all_to_all")][0] == 4
