"""The recurrent families (RWKV-6, Mamba-2 and the Zamba2 hybrid) in the port
against the JAX package, on the CPU: the chunked linear-attention engine, each
block's forward and gradient, the loss of both smoke configs, both
accumulation schedules over both storage layouts and the fused step, the
dense-cache prefill and decode (the attention stacks' too, gemma2's ring
cache among them), and the plain flash path at head dim 112.

Inputs are drawn with numpy and the JAX weights reach the port through
``convert.py``.  Tolerances: fp32 1e-5 where one function is compared (of
the leaf's scale for a cache after several layers); gradients at rtol 3e-4
and atol 3e-5 (tests/test_accumulation.py's) with the relative part taken of
each leaf's scale (its largest |g|), as the kernel checks on the card take
theirs.  RWKV's gradients are held at 1e-3 of the scale (``GRAD_TOL``):
its per-head group norm (eps 1e-5) meets heads whose output variance at the
first position is 5.6e-6 (median 12) in the smoke model at init, where the
gradient carries the rounding of o amplified about a thousandfold.
``test_rwkv_float64_gradient_matches_jax`` holds what that rests on: in
float64 the two packages' gradients agree to 1e-10 of each leaf's scale,
and each package's fp32 gradient lies within half of ``GRAD_TOL`` from the
float64 one.  Measured besides: the JAX package's own layered train step
and its ``jax.grad`` of the whole batch differ by 0.5% in the global grad
norm (``TRAIN_TOL``).
"""
import dataclasses

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
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro.models.common import AxisCtx, ModelConfig as JModelConfig
from repro.optim.adam import AdamConfig as JAdamConfig
from repro.optim.adam import adam_init as jadam_init
from repro_torch import configs, tree
from repro_torch.convert import params_from_numpy, storage_from_numpy
from repro_torch.core import partition as zp
from repro_torch.core import dist, stepfn
from repro_torch.core.accumulation import AccumConfig, make_grad_fn
from repro_torch.data.synthetic import DataConfig, make_batch
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve, train
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adam import AdamConfig, adam_init

AX = AxisCtx()


def _cfgs(arch: str, **over):
    """(JAX, port) smoke configs of ``arch`` with ``over`` applied."""
    j = dataclasses.replace(jconfigs.get_config(arch, smoke=True), **over)
    t = dataclasses.replace(configs.get_config(arch, smoke=True), **over)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


# rwkv6-3b's smoke config (2 layers, 40 heads of 32 over d_model 256); zamba2-7b's
# at 4 layers, so that the shared block runs after layers 1 and 3
ARCHS = {"rwkv6-3b": {}, "zamba2-7b": {"num_layers": 4}}


GRAD_TOL = {"rwkv6-3b": 1e-3, "zamba2-7b": 3e-4}
# (loss after step 0, grad norm) relative tolerances of the two-step
# trajectories: Adam's first, normalised update turns the rounding of a
# near-zero gradient into a step of up to lr (measured, zamba2: 2e-5 at step
# 1); rwkv's grad norm inherits its group norm's conditioning (measured 0.95%
# at step 0, 4.1% at step 1, after an update whose signs follow step 0's fp32
# gradients, which test_rwkv_float64_gradient_matches_jax shows differ
# through rounding alone: equal in float64)
TRAIN_TOL = {"rwkv6-3b": (1e-3, 5e-2), "zamba2-7b": (1e-4, 1e-4)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's small shapes: beside the other
    test processes and the JAX package's threads, more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_scaled(got, want, err_msg="", rel=3e-4):
    """|got - want| <= 3e-5 + rel * max|want| (the module docstring)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_array_less(np.abs(got - want), 3e-5 + rel * scale + 1e-30,
                                 err_msg=err_msg)


# ---------------------------------------------------------------------------
# The chunked engine and the blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("group", [5, 2], ids=["one-group", "groups-of-2"])
@pytest.mark.parametrize("form", ["vector-bonus", "scalar"])
def test_chunked_engine_matches_jax_and_the_step_chain(form, group, monkeypatch):
    """S = 37 over chunks of 8 (padded), the 5 chunks in one group or in
    groups of 2, 2 and 1 (``ssm.GROUP_ELEMS``): the port's chunked engine
    equals the JAX package's (1e-5) and the port's own one-token steps
    chained (1e-4, tests/test_ssm.py's), output and end state, from a
    nonzero state."""
    w = 8 if form == "vector-bonus" else 1
    monkeypatch.setattr(ssm, "GROUP_ELEMS", group * 2 * 8 * 8 * 3 * w)
    rng = np.random.default_rng(3)
    B, S, H, dk, dv = 2, 37, 3, 8, 5
    q, k = (rng.standard_normal((B, S, H, dk)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((B, S, H, dv)).astype(np.float32)
    w = dk if form == "vector-bonus" else 1
    ld = -np.exp(rng.standard_normal((B, S, H, w)) - 1.5).astype(np.float32)
    s0 = rng.standard_normal((B, H, dk, dv)).astype(np.float32)
    bonus = rng.standard_normal((H, dk)).astype(np.float32) if form == "vector-bonus" else None
    t = torch.from_numpy
    o, st = ssm.linear_attention_chunked(t(q), t(k), t(v), t(ld), t(s0), chunk=8,
                                         bonus=None if bonus is None else t(bonus))
    jo, jst = jssm.linear_attention_chunked(q, k, v, ld, s0, chunk=8, bonus=bonus)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-5, atol=1e-5)
    state, outs = t(s0), []
    for i in range(S):
        oi, state = ssm.linear_attention_step(
            t(q[:, i]), t(k[:, i]), t(v[:, i]), t(ld[:, i]), state,
            bonus=None if bonus is None else t(bonus))
        outs.append(oi)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), o.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(state.numpy(), st.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_block_forward_and_gradient_match_jax(kind):
    """One block on random inputs (S = 20 over chunks of 8): the output and
    end state at 1e-5, every parameter's gradient and the input's against
    ``jax.vjp`` (``_close_scaled``)."""
    arch = "rwkv6-3b" if kind == "rwkv" else "zamba2-7b"
    jcfg, tcfg = _cfgs(arch)
    init, apply = ((jssm.init_rwkv, jssm.apply_rwkv) if kind == "rwkv"
                   else (jssm.init_mamba, jssm.apply_mamba))
    jp = init(jcfg, jax.random.PRNGKey(4))
    if kind == "mamba":    # nonzero dt_bias, A_log, D_skip
        rng0 = np.random.default_rng(9)
        jp = dict(jp, **{k: jnp.asarray(0.3 * rng0.standard_normal(jp[k].shape), jnp.float32)
                         for k in ("dt_bias", "A_log", "D_skip")})
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 20, tcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((2, 20, tcfg.d_model)).astype(np.float32)

    def jf(p, x):
        return apply(jcfg, p, x, AX, chunk=8)

    (y, jst), vjp = jax.vjp(jax.jit(jf), jp, jnp.asarray(x))
    gp, gx = vjp((jnp.asarray(ct), jax.tree.map(jnp.zeros_like, jst)))
    tp = {k: torch.tensor(np.asarray(v)).requires_grad_() for k, v in jp.items()}
    tx = torch.tensor(x).requires_grad_()
    fn = ssm.apply_rwkv if kind == "rwkv" else ssm.apply_mamba
    ty, tst = fn(tcfg, tp, tx, chunk=8)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    for got, want in zip(tree.leaves(tst if kind == "rwkv" else {"S": tst}),
                         jax.tree.leaves(jst if kind == "rwkv" else {"S": jst})):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    grads = torch.autograd.grad(ty, [tx] + list(tp.values()), torch.from_numpy(ct))
    _close_scaled(grads[0].numpy(), gx, err_msg="x")
    for (name, _), g in zip(tp.items(), grads[1:]):
        _close_scaled(g.numpy(), gp[name], err_msg=name)


# ---------------------------------------------------------------------------
# The loss and the training schedules
# ---------------------------------------------------------------------------
def _jparams(jcfg, seed=0):
    return JT.init_params(jcfg, jax.random.PRNGKey(seed))


def _compare_tree(got: dict, want, compare=_close_scaled):
    """``got`` (the port's, numpy leaves in the JAX layout) against the JAX
    tree ``want``, leaf by leaf (JAX's empty ``shared`` subtree dropped)."""
    wants = {tuple(p.key for p in path): np.asarray(leaf)
             for path, leaf in jax.tree_util.tree_leaves_with_path(want)}
    pairs = dict(tree.leaves_with_path(got))
    assert sorted(pairs) == sorted(wants)
    for path, leaf in pairs.items():
        compare(leaf, wants[path], err_msg=str(path))


def _port_loss_grads(tcfg, jparams, batch):
    """The port's whole-batch mean token loss and its gradient (numpy, in the
    JAX tree's layout) through ``transformer.loss_fn``."""
    flat_batch = {k: torch.from_numpy(v.reshape(-1, v.shape[-1])) for k, v in batch.items()}
    params = params_from_numpy(tcfg, jparams)
    if tcfg.dtype == "float64":    # the fp32 vectors too (Tensor.to takes a dtype)
        params = T.to_device(params, torch.float64)
    named = dict(T.named_parameters(params))
    for t in named.values():
        t.requires_grad_()
    _, (nll, n) = T.loss_fn(tcfg, params, flat_batch)
    loss = nll / n
    flat = {name: g.numpy() for name, g in
            zip(named, torch.autograd.grad(loss, list(named.values())))}
    got = _unflat({k: v for k, v in flat.items() if not k.startswith("layers.")}, "")
    got["layers"] = tree.tree_map(lambda *ls: np.stack(ls), *[
        _unflat(flat, f"layers.{i}.") for i in range(tcfg.num_layers)])
    return loss.item(), got


@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_fn_grads_match_jax(references, arch):
    """``transformer.loss_fn`` over the whole batch (each layer recomputed,
    each chunk too) against ``jax.grad`` of the JAX loss with its kernels on
    (Pallas interpret): the loss at 1e-6 and every gradient, the shared
    block's over the two layers it follows included."""
    jparams, batch, want = references[arch]
    _, tcfg = _cfgs(arch, **ARCHS[arch])
    loss, got = _port_loss_grads(tcfg, jparams, batch)
    np.testing.assert_allclose(loss, references[arch, "loss"], rtol=1e-6)
    _compare_tree(got, {k: v for k, v in want.items() if k != "shared" or v},
                  compare=lambda a, b, err_msg: _close_scaled(a, b, err_msg, GRAD_TOL[arch]))


def test_rwkv_float64_gradient_matches_jax(references, monkeypatch):
    """What rwkv's ``GRAD_TOL`` rests on, read in float64: the smoke model's
    whole-batch gradient (``references``' weights and batch) evaluated by
    both packages with every fp32 cast made float64 (the JAX package's
    ``jnp.float32``, the port's ``Tensor.float``; its kernels off) agrees to
    1e-10 of each leaf's scale, so the port computes the JAX package's
    function; and each package's fp32 gradient lies within half of
    ``GRAD_TOL`` of its leaf's scale from that float64 one (measured: the
    port's up to 2.5e-4, the JAX package's with its kernels on up to 4.1e-4,
    and the two float64 gradients 7.6e-13 apart), so the two fp32 gradients
    can differ by up to ``GRAD_TOL`` through rounding alone."""
    arch = "rwkv6-3b"
    jparams, batch, want32 = references[arch]
    jcfg, tcfg = _cfgs(arch, kernels=False, dtype="float64", param_dtype="float64")
    flat = {k: v.reshape(-1, v.shape[-1]) for k, v in batch.items()}

    def loss(p):
        _, (nll, n) = JT.loss_fn(jcfg, p, flat, AX, remat=False)
        return nll / n

    with jax.enable_x64(True), monkeypatch.context() as m:
        m.setattr(jnp, "float32", jnp.float64)
        want = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jparams)))
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "float", lambda t: t.double())
        _, got = _port_loss_grads(tcfg, jparams, batch)
    _, got32 = _port_loss_grads(_cfgs(arch)[1], jparams, batch)
    want = {k: v for k, v in want.items() if k != "shared" or v}
    assert all(a.dtype == np.float64 for a in jax.tree.leaves(want) + tree.leaves(got))
    _compare_tree(got, want, compare=lambda a, b, err_msg: np.testing.assert_array_less(
        np.abs(a - b), 1e-10 * np.abs(b).max(), err_msg=err_msg))
    half = GRAD_TOL[arch] / 2
    for fp32 in (got32, {k: v for k, v in want32.items() if k != "shared" or v}):
        _compare_tree(fp32, want, compare=lambda a, b, err_msg: np.testing.assert_array_less(
            np.abs(a - b), half * np.abs(b).max(), err_msg=err_msg))


def _unflat(named: dict, prefix: str) -> dict:
    out: dict = {}
    for name, g in named.items():
        if name.startswith(prefix):
            keys = name[len(prefix):].split(".")
            node = out
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = g
    return out


M = 2


def _full(cfg, storage, partitioned) -> dict:
    """Storage (or grads) -> numpy full leaves in the JAX tree's layout."""
    tmpl = stepfn.full_template(cfg)

    def one(leaf, shape, stacked):
        a = leaf.detach().float().numpy()
        return zp.host_unpartition_leaf(a, shape, 1, stacked=stacked) if partitioned else a

    out = {k: tree.tree_map(lambda l, s: one(l, s, False), storage[k], tmpl[k])
           for k in storage if k != "layers"}
    out["layers"] = tree.tree_map(lambda l, s: one(l, s, True), storage["layers"],
                                  tmpl["layers"])
    return out


@pytest.fixture(scope="module")
def references():
    """Per arch: JAX params (numpy), an [M, 2, 16] batch (2 rows of row 1
    masked past token 10) and the JAX loss and gradient of the whole batch's
    mean token loss with the kernels on."""
    out = {}
    for arch, over in ARCHS.items():
        jcfg, _ = _cfgs(arch, **over)
        params = _jparams(jcfg, 1)
        rng = np.random.default_rng(2)
        toks = rng.integers(0, jcfg.vocab_size, (M, 2, 17)).astype(np.int32)
        mask = np.ones((M, 2, 16), np.int32)
        mask[:, 1, 10:] = 0
        batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:], "mask": mask}

        def loss(p):
            flat = {k: jnp.asarray(v).reshape(M * 2, 16) for k, v in batch.items()}
            _, (nll, n) = JT.loss_fn(jcfg, p, flat, AX, remat=False)
            return nll / n

        value, grad = jax.jit(jax.value_and_grad(loss))(params)
        out[arch] = (jax.tree.map(np.asarray, params), batch, grad)
        out[arch, "loss"] = float(value)
    return out


@pytest.mark.parametrize("part", [False, True], ids=["replicated", "partitioned"])
@pytest.mark.parametrize("method", ["standard", "layered"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_schedules_grads_match_jax(references, arch, method, part):
    """``make_grad_fn`` (2 micro-batches) against ``jax.grad`` of the whole
    batch's loss: the layered schedule's shared-block accumulator, and the
    standard one's autograd sum over the checkpointed layers."""
    params, batch, want = references[arch]
    _, tcfg = _cfgs(arch, **ARCHS[arch])
    storage = storage_from_numpy(tcfg, params, partitioned=part)
    acc = AccumConfig(method=method, partitioned=part, n_microbatches=M)
    grads, metrics = make_grad_fn(tcfg, acc, stepfn.full_template(tcfg))(
        storage, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert ("shared" in grads) == (tcfg.hybrid_attn_period > 0)
    _compare_tree(_full(tcfg, grads, part), {k: v for k, v in want.items()
                                             if k != "shared" or v},
                  compare=lambda a, b, err_msg: _close_scaled(a, b, err_msg, GRAD_TOL[arch]))
    assert metrics["ntok"].item() == batch["mask"].sum()


DATA = dict(seq_len=16, global_batch=4, n_microbatches=M)


def _opt(fused: bool) -> dict:
    return dict(lr=3e-3, warmup_steps=1, decay_steps=2, **({"grad_clip": 0.0} if fused else {}))


@pytest.fixture(scope="module")
def trajectories(mesh11):
    """Per (arch, fused): the JAX package's initial weights (numpy) and its
    two steps' metrics and final full weights, from its layered partitioned
    step on a (1, 1) mesh with its kernels off (with them on its shard_map
    path does not trace on this JAX), classic or §C.3 fused."""
    out = {}
    for arch, over in ARCHS.items():
        jcfg, tcfg = _cfgs(arch, kernels=False, **over)
        key = jax.random.PRNGKey(0)
        params = jax.tree.map(np.asarray, jstepfn.init_storage(jcfg, mesh11, key,
                                                               partitioned=False))
        for fused in (False, True):
            acc = JAccumConfig(method="layered", partitioned=True, n_microbatches=M)
            build = jstepfn.build_fused_train_step if fused else jstepfn.build_train_step
            jstep = build(jcfg, mesh11, acc, JAdamConfig(**_opt(fused)), donate=False)
            jstorage = jstepfn.init_storage(jcfg, mesh11, key, partitioned=True)
            jopt, metrics = jadam_init(jstorage), []
            for i in range(2):
                jstorage, jopt, jm = jstep(jstorage, jopt, jmake_batch(
                    JDataConfig(vocab_size=tcfg.vocab_size, **DATA), i))
                metrics.append({k: float(v) for k, v in jm.items()})
            final = jax.tree_util.tree_map_with_path(
                lambda path, c, t, sp: jhost_unpartition(np.asarray(c), t.shape, sp, 1,
                                                         stacked=path[0].key == "layers"),
                jstorage, jstepfn.full_template(jcfg), JT.param_specs(jcfg, 1))
            out[arch, fused] = (params, metrics, final)
    return out


@pytest.mark.parametrize("method,part,fused", [
    ("layered", True, False), ("layered", False, False), ("standard", True, False),
    ("standard", False, False), ("layered", True, True)],
    ids=["layered-partitioned", "layered-replicated", "standard-partitioned",
         "standard-replicated", "fused"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_steps_match_jax(trajectories, arch, method, part, fused):
    """Two steps of ``build_train_step`` in each schedule and layout (and of
    the §C.3 fused step, which updates the shared block with the outer
    leaves after the step) against the JAX package's (``trajectories``):
    step 0's loss at 1e-6 relative, later losses and every grad norm at
    ``TRAIN_TOL``, lr at 1e-6.  The second step's loss is what holds the
    first update; the final weights are only bounded (4 lr apart at most:
    two Adam steps of about lr each, one way in one package and the other
    way in the other): Adam's normalised step turns the rounding of near-zero
    gradient elements into steps of up to lr, in up to 0.6% of a leaf's
    elements here (no gradient clipping in the fused step)."""
    _, tcfg = _cfgs(arch, **ARCHS[arch])
    params, jmetrics, want = trajectories[arch, fused]
    opt = _opt(fused)
    storage = storage_from_numpy(tcfg, params, partitioned=part)
    acc = AccumConfig(method=method, partitioned=part, n_microbatches=M)
    build = stepfn.build_fused_train_step if fused else stepfn.build_train_step
    step = build(tcfg, acc, AdamConfig(**opt))
    topt = adam_init(storage)
    loss_tol, norm_tol = TRAIN_TOL[arch]
    for i, jm in enumerate(jmetrics):
        storage, topt, tm = step(storage, topt, make_batch(
            DataConfig(vocab_size=tcfg.vocab_size, **DATA), i))
        tols = {"loss": 1e-6 if i == 0 else loss_tol, "lr": 1e-6}
        if not fused:
            tols["grad_norm"] = norm_tol
        for k, tol in tols.items():
            np.testing.assert_allclose(tm[k].item(), jm[k], rtol=tol, err_msg=f"step {i} {k}")

    def close_weights(a, b, err_msg):
        assert np.abs(a - b).max() <= 4 * opt["lr"], err_msg

    _compare_tree(_full(tcfg, storage, part), {k: v for k, v in want.items()
                                               if k != "shared" or v}, compare=close_weights)


# ---------------------------------------------------------------------------
# The dense-cache prefill and decode
# ---------------------------------------------------------------------------
# tests/test_models.py's families (4 layers, d_model 48)
FAMILIES = {
    "rwkv": dict(num_heads=0, num_kv_heads=0, block_kind="rwkv", ssm_head_dim=12),
    "mamba": dict(num_heads=0, num_kv_heads=0, block_kind="mamba", ssm_state=8,
                  ssm_head_dim=16),
    "hybrid": dict(num_heads=4, num_kv_heads=4, block_kind="mamba", hybrid_attn_period=2,
                   ssm_state=8, ssm_head_dim=16),
    "gemma2": dict(num_heads=4, num_kv_heads=2, sliding_window=4, local_global_period=2,
                   attn_logit_softcap=50.0, final_logit_softcap=30.0),
    "dense-mqa": dict(num_heads=4, num_kv_heads=1),
}


def _fam(fam):
    kw = dict(name=fam, arch_type="dense", num_layers=4, d_model=48, d_ff=96,
              vocab_size=53, dtype="float32", param_dtype="float32", **FAMILIES[fam])
    return JModelConfig(**kw), ModelConfig(**kw)


def _np_cache(cache) -> dict:
    return tree.tree_map(lambda v: v if isinstance(v, int) else v.numpy(), cache)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_dense_prefill_and_decode_match_jax(fam):
    """``stepfn.build_prefill_step`` over 10 tokens (past gemma2's window of
    4: the ring holds the last 4) and 4 greedy ``build_serve_step`` steps
    against ``transformer.prefill_step`` / ``decode_step`` of the JAX package
    (its kernels on): logits at 1e-5 of their scale, the greedy tokens equal,
    and every cache leaf (KV slots, rings, recurrent states, ``pos``) at
    1e-5 (of its scale, when above 1) after the prefill and after the last
    step."""
    jcfg, tcfg = _fam(fam)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(2))
    params = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    B, S, steps = 2, 10, 4
    toks = np.random.default_rng(4).integers(0, 53, (B, S)).astype(np.int32)
    jcache = JT.init_cache(jcfg, B, S + steps, AX)
    jlog, jcache = JT.prefill_step(jcfg, jparams, jcache, {"tokens": jnp.asarray(toks)}, AX)
    cache = T.init_cache(tcfg, B, S + steps)
    assert stepfn.cache_specs(tcfg).keys() == cache.keys()
    prefill, serve_step = stepfn.build_prefill_step(tcfg), stepfn.build_serve_step(tcfg)
    log, cache = prefill(params, cache, {"tokens": torch.from_numpy(toks)})

    def check(log, jlog, cache, jcache):
        scale = float(np.abs(np.asarray(jlog)).max())
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=0, atol=1e-5 * scale)
        want = {tuple(p.key for p in path): np.asarray(v)
                for path, v in jax.tree_util.tree_leaves_with_path(jcache)}
        got = dict(tree.leaves_with_path(_np_cache(cache)))
        assert sorted(got) == sorted(want)
        for path, v in got.items():
            scale = max(1.0, float(np.abs(want[path]).max()))
            np.testing.assert_allclose(v, want[path], rtol=1e-5, atol=1e-5 * scale,
                                       err_msg=str(path))

    check(log, jlog, cache, jcache)
    for _ in range(steps):
        nxt = log.argmax(-1)
        assert np.array_equal(nxt.numpy(), np.asarray(jnp.argmax(jlog, -1)))
        jlog, jcache = JT.decode_step(jcfg, jparams, jcache, jnp.asarray(nxt.numpy(), jnp.int32),
                                      AX)
        log, cache = serve_step(params, cache, nxt.int())
    check(log, jlog, cache, jcache)


def test_dense_steps_refuse_groups():
    """The dense-cache steps take a group axis and a sequence-sharded cache
    (``tests/test_torch_serve_dist.py`` holds them on gloo): a model group
    of 2 and ``seq_shard`` without a data group are accepted, the latter as
    one shard of the whole cache; the paged entry point refuses the families
    as the JAX package's does."""
    _, tcfg = _fam("hybrid")
    group = dist.AxisCtx(model=object(), tp=2)
    assert callable(stepfn.build_serve_step(tcfg, axis=group))
    assert callable(stepfn.build_serve_step(tcfg, seq_shard=True))
    assert callable(stepfn.build_prefill_step(tcfg, axis=group))
    specs = stepfn.cache_specs(tcfg, group, seq_shard=True)
    assert specs["k"] == (None, None, "model", None, None)
    assert specs["ssm"] == (None, None, "model", None, None)
    with pytest.raises(SystemExit, match="attention stack"):
        serve.main(["--arch", "zamba2-7b", "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("window", [0, 100])
def test_long_prefill_takes_the_query_chunked_path(window):
    """Past ``CHUNKED_THRESHOLD`` (S = 8200 here) the CPU takes the JAX
    package's query-chunked attention, never the S x S logits: the port's
    ``attention_train`` against JAX's (its kernels off, which takes the same
    path at this S) at 1e-5, and ``_attend_chunked`` against
    ``_attend_dense`` at S = 1024 (tests/test_models.py's check, 1e-4 /
    1e-5)."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as attn
    kw = dict(name="long", arch_type="dense", num_layers=1, d_model=32, num_heads=2,
              num_kv_heads=1, d_ff=64, vocab_size=64, dtype="float32", param_dtype="float32",
              kernels=False)
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
    rng = np.random.default_rng(7)
    S = attn.CHUNKED_THRESHOLD + 8
    p = {k: rng.standard_normal(s).astype(np.float32) / 6 for k, s in
         (("wq", (32, 32)), ("wk", (32, 16)), ("wv", (32, 16)), ("wo", (32, 32)))}
    x = rng.standard_normal((1, S, 32)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    want = jattn.attention_train(jcfg, p, x, positions=pos, window=window, axis=AX)
    got = attn.attention_train(tcfg, {k: torch.from_numpy(v) for k, v in p.items()},
                               torch.from_numpy(x), positions=torch.from_numpy(pos),
                               window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 1024, 2, 16)).astype(np.float32))
               for _ in range(3))
    p1 = torch.arange(1024)[None]
    np.testing.assert_allclose(
        attn._attend_chunked(q, k, v, p1, window, 0.0, block_q=128).numpy(),
        attn._attend_dense(q, k, v, p1, p1, window, 0.0).numpy(), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# Configs, the entry point, and the flash path at head dim 112
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,billions", [("rwkv6-3b", 3.2716), ("zamba2-7b", 13.0225)])
def test_param_count_equals_jax(arch, billions):
    jcfg, tcfg = jconfigs.get_config(arch), configs.get_config(arch)
    for active in (False, True):
        assert tcfg.param_count(active_only=active) == jcfg.param_count(active_only=active)
    assert round(tcfg.param_count() / 1e9, 4) == billions
    for tp in (2, 3, 4):
        assert dataclasses.asdict(tcfg.padded_for_tp(tp)) == \
            dataclasses.asdict(jcfg.padded_for_tp(tp))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_cli_on_cpu(arch, monkeypatch, capsys):
    """``launch.train`` trains both families on the CPU; ``--stages 2``
    outside the launcher stops at the one refusal left before any process
    group exists, the process count (the pipeline runs both families)."""
    out = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                      "--seq-len", "16", "--global-batch", "4"])
    assert out["steps"] == 2 and all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                                     for r in out["records"])
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit):
        train.main(["--arch", arch, "--smoke", "--device", "cpu", "--stages", "2"])
    assert "2 stages of --mesh 1x1 need 2 processes" in capsys.readouterr().err


def test_flash_plain_at_head_dim_112_matches_pallas():
    """``smoke_variant(zamba2, head_dim=112)``'s attention shape through the
    port's flash dispatch (the plain version here) against the JAX package's
    Pallas kernel in interpret mode: out at 1e-5 and dq, dk, dv of a random
    cotangent at 1e-5 of their scale, causal, GQA 2."""
    from repro.kernels import ops as jkops
    jcfg, tcfg = _cfgs("zamba2-7b", head_dim=112)
    assert tcfg.head_dim == 112
    rng = np.random.default_rng(6)
    B, S, Hq, Hkv, D = 1, 80, tcfg.num_heads, tcfg.num_heads // 2, tcfg.head_dim
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b, c: jkops.flash_attention(a, b, c, causal=True), q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(a).requires_grad_() for a in (q, k, v))
    tout = kops.flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out), rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad(tout, [tq, tk, tv], torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * float(np.abs(np.asarray(w)).max()))
