"""The port's training step against the JAX package's, on the CPU: both
accumulation schedules over both storage layouts, a 4-step trajectory, the
data stream and the training entry point."""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stepfn as jstepfn
from repro.core.accumulation import AccumConfig as JAccumConfig
from repro.core.partition import host_unpartition_leaf as jhost_unpartition
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import make_batch as jmake_batch
from repro.models import transformer as JT
from repro.models.common import AxisCtx, ModelConfig as JModelConfig
from repro.optim.adam import AdamConfig as JAdamConfig
from repro.optim.adam import adam_init as jadam_init
from repro_torch import tree
from repro_torch.convert import storage_from_numpy
from repro_torch.core import partition as zp
from repro_torch.core import stepfn
from repro_torch.core.accumulation import AccumConfig, make_grad_fn
from repro_torch.data.synthetic import DataConfig, make_batch
from repro_torch.kernels import adamw as aw
from repro_torch.launch import train
from repro_torch.models.common import ModelConfig
from repro_torch.obs import trace as obs_trace
from repro_torch.optim.adam import AdamConfig, adam_init, adam_step
from repro_torch.resilience.supervisor import SupervisorError

# the CFG of tests/test_accumulation.py
ACC = dict(name="t", arch_type="dense", num_layers=3, d_model=32, num_heads=4,
           num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32",
           param_dtype="float32")
JCFG, TCFG = JModelConfig(**ACC), ModelConfig(**ACC)
M = 4


def _full(cfg, storage, partitioned) -> dict:
    """Storage -> numpy full leaves in the JAX tree's layout."""
    tmpl = stepfn.full_template(cfg)

    def one(leaf, shape, stacked):
        a = leaf.detach().numpy()
        return zp.host_unpartition_leaf(a, shape, 1, stacked=stacked) if partitioned else a

    out = {k: tree.tree_map(lambda l, s: one(l, s, False), storage[k], tmpl[k])
           for k in storage if k != "layers"}
    out["layers"] = tree.tree_map(lambda l, s: one(l, s, True), storage["layers"],
                                  tmpl["layers"])
    return out


def _compare(got: dict, want, **tol):
    pairs = list(tree.leaves_with_path(got))
    wants = {tuple(p.key for p in path): np.asarray(leaf)
             for path, leaf in jax.tree_util.tree_leaves_with_path(want)}
    assert sorted(p for p, _ in pairs) == sorted(wants)
    for path, leaf in pairs:
        np.testing.assert_allclose(leaf, wants[path], err_msg=str(path), **tol)


# ---------------------------------------------------------------------------
# make_grad_fn: both schedules, both layouts, against jax.grad(loss_fn)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference():
    """JAX params, a micro-batched batch, and the JAX gradient of the mean
    token loss with the kernels on (Pallas interpret, outside shard_map)."""
    key = jax.random.PRNGKey(1)
    params = JT.init_params(JCFG, key)
    toks = np.asarray(jax.random.randint(key, (M, 2, 16), 0, 64), np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=-1),
             "mask": np.ones_like(toks)}

    def loss(p):
        flat = {k: jnp.asarray(v).reshape(M * 2, 16) for k, v in batch.items()}
        _, (nll, n) = JT.loss_fn(JCFG, p, flat, AxisCtx(), remat=False)
        return nll / n

    return jax.tree.map(np.asarray, params), batch, jax.grad(loss)(params)


@pytest.mark.parametrize("method", ["standard", "layered"])
@pytest.mark.parametrize("part", [False, True])
def test_grads_match_reference(reference, method, part):
    params, batch, want = reference
    storage = storage_from_numpy(TCFG, params, partitioned=part)
    acc = AccumConfig(method=method, partitioned=part, n_microbatches=M)
    grad_fn = make_grad_fn(TCFG, acc, stepfn.full_template(TCFG))
    grads, metrics = grad_fn(storage, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tree.leaves(grads)[0].shape == tree.leaves(storage)[0].shape
    want = {k: v for k, v in want.items() if k != "shared"}
    # the tolerance of tests/test_accumulation.py
    _compare(_full(TCFG, grads, part), want, rtol=3e-4, atol=3e-5)
    assert torch.isfinite(metrics["loss"]) and metrics["ntok"].item() == M * 2 * 16


def test_schedules_and_layouts_agree(reference):
    params, batch, _ = reference
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for method in ("standard", "layered"):
        for part in (False, True):
            storage = storage_from_numpy(TCFG, params, partitioned=part)
            acc = AccumConfig(method=method, partitioned=part, n_microbatches=M)
            grads, m = make_grad_fn(TCFG, acc, stepfn.full_template(TCFG))(storage, tb)
            out[method, part] = (_full(TCFG, grads, part), m["loss"].item())
    base_g, base_l = out["layered", True]
    for (g, l) in out.values():
        assert l == pytest.approx(base_l, rel=1e-6)
        for (path, a), (_, b) in zip(tree.leaves_with_path(g), tree.leaves_with_path(base_g)):
            np.testing.assert_allclose(a, b, rtol=3e-4, atol=3e-5, err_msg=str(path))


# ---------------------------------------------------------------------------
# The train step: a 4-step trajectory against JAX's build_train_step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method,part", [("layered", True), ("layered", False),
                                         ("standard", True), ("standard", False)])
def test_train_trajectory_matches_jax(mesh11, method, part):
    """The JAX step runs on a (1, 1) mesh with its kernels off (with them on
    its shard_map path does not trace on this JAX); the port runs its
    kernels' plain versions and, when partitioned, the fused AdamW.  Loss,
    grad norm and lr per step agree to 1e-5 relative (fp32 sums in other
    orders; measured 3e-7), the final weights to 1e-5 absolute (measured
    4e-6: Adam's normalised update turns the rounding of a tiny gradient into
    a step of up to lr, and 4 steps compound it)."""
    jcfg = dataclasses.replace(JCFG, kernels=False)
    data = dict(vocab_size=64, seq_len=16, global_batch=8, n_microbatches=M)
    opt = dict(lr=3e-3, warmup_steps=1, decay_steps=4)
    mesh = mesh11
    jstep = jstepfn.build_train_step(jcfg, mesh, JAccumConfig(
        method=method, partitioned=part, n_microbatches=M), JAdamConfig(**opt),
        donate=False)
    key = jax.random.PRNGKey(0)
    jstorage = jstepfn.init_storage(jcfg, mesh, key, partitioned=False)
    params = jax.tree.map(np.asarray, jstorage)
    if part:
        jstorage = jstepfn.init_storage(jcfg, mesh, key, partitioned=True)
    jopt = jadam_init(jstorage)

    storage = storage_from_numpy(TCFG, params, partitioned=part)
    step = stepfn.build_train_step(TCFG, AccumConfig(method=method, partitioned=part,
                                                     n_microbatches=M), AdamConfig(**opt))
    topt = adam_init(storage)
    n = aw.launches
    for i in range(4):
        jstorage, jopt, jm = jstep(jstorage, jopt, jmake_batch(JDataConfig(**data), i))
        storage, topt, tm = step(storage, topt, make_batch(DataConfig(**data), i))
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    assert aw.launches == n                   # the CPU runs the plain AdamW
    want = jax.tree.map(np.asarray, jstorage)
    if part:
        tmpl = jstepfn.full_template(jcfg)
        specs = JT.param_specs(jcfg, 1)
        want = jax.tree_util.tree_map_with_path(
            lambda path, c, t, sp: jhost_unpartition(
                c, t.shape, sp, 1, stacked=path[0].key == "layers"),
            want, tmpl, specs)
    want = {k: v for k, v in want.items() if k != "shared"}
    _compare(_full(TCFG, storage, part), want, rtol=0, atol=1e-5)


def test_bf16_train_trajectory_matches_jax(mesh11):
    """The bf16 step (yi-6b smoke, layered, partitioned) against JAX's with
    its kernels off: both gather every leaf, norm scales included, in bf16.
    Step 0 agrees to 1e-3 (bf16 products in other orders); later steps
    compound that through Adam (measured: loss 2.5e-4, grad norm 5e-3)."""
    from repro import configs as jconfigs
    from repro_torch import configs
    jcfg = dataclasses.replace(jconfigs.get_config("yi-6b", smoke=True), dtype="bfloat16",
                               kernels=False)
    tcfg = dataclasses.replace(configs.get_config("yi-6b", smoke=True), dtype="bfloat16")
    data = dict(vocab_size=tcfg.vocab_size, seq_len=32, global_batch=4, n_microbatches=2)
    opt = dict(lr=3e-3, warmup_steps=1, decay_steps=4)
    jstep = jstepfn.build_train_step(jcfg, mesh11, JAccumConfig("layered", True, 2),
                                     JAdamConfig(**opt), donate=False)
    key = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, jstepfn.init_storage(jcfg, mesh11, key,
                                                           partitioned=False))
    jstorage = jstepfn.init_storage(jcfg, mesh11, key, partitioned=True)
    jopt = jadam_init(jstorage)
    storage = storage_from_numpy(tcfg, params, partitioned=True)
    step = stepfn.build_train_step(tcfg, AccumConfig("layered", True, 2), AdamConfig(**opt))
    topt = adam_init(storage)
    for i in range(4):
        jstorage, jopt, jm = jstep(jstorage, jopt, jmake_batch(JDataConfig(**data), i))
        storage, topt, tm = step(storage, topt, make_batch(DataConfig(**data), i))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-3)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]),
                                   rtol=1e-3 if i == 0 else 2e-2)


# each schedule's spans in one step of TCFG (L = 3) over M micro-batches,
# partitioned: the layered schedule's are its layer loop's, the standard one's
# its micro-batch loop's (its reductions run inside the backward)
L3 = TCFG.num_layers
PHASES = {
    "layered": {"accum.gather": 2 * L3 + 1, "accum.forward": L3, "accum.head": 1,
                "accum.backward": L3, "accum.add": L3 * M, "accum.reduce": L3 + 1,
                "accum.embed_grad": 1, "step.update": 1},
    "standard": {"accum.gather": M, "accum.forward": M, "accum.backward": M, "accum.add": M,
                 "step.update": 1},
}


@pytest.mark.parametrize("method", list(PHASES))
def test_traced_step_records_the_schedules_phases(reference, method, monkeypatch):
    """With no tracer active a step opens no span and makes no CUDA event.
    With one active, it records each phase of its schedule as often as the
    loop runs it, each under its parent (a layer's ``accum.add`` under its
    ``accum.backward``, the rest under the caller's span), none on the
    device lane on the CPU; its gradients are bit for bit the untraced
    step's."""
    params, batch, _ = reference
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    acc = AccumConfig(method=method, partitioned=True, n_microbatches=M)
    step = stepfn.build_train_step(TCFG, acc, AdamConfig())

    def refuse(*a, **k):
        raise AssertionError("a span or CUDA event without an active tracer")

    with monkeypatch.context() as mp:
        mp.setattr(obs_trace.Tracer, "span", refuse)
        mp.setattr(torch.cuda, "Event", refuse)
        storage = storage_from_numpy(TCFG, params, partitioned=True)
        want, _ = step.grad_fn(storage, tb)
        step(storage, adam_init(storage), tb)

    storage = storage_from_numpy(TCFG, params, partitioned=True)
    tracer = obs_trace.Tracer()
    with obs_trace.active(tracer), tracer.span("test", cat="test") as top:
        got, _ = step.grad_fn(storage, tb)
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        assert torch.equal(a, b)
    tracer = obs_trace.Tracer()
    with obs_trace.active(tracer), tracer.span("test", cat="test") as top:
        step(storage, adam_init(storage), tb)
    spans = [e for e in tracer.events if e["ph"] == "X" and e["cat"] != "test"]
    assert all(e["pid"] == 0 for e in spans)
    names = [f"{e['cat']}.{e['name']}" for e in spans]
    assert {n: names.count(n) for n in set(names)} == PHASES[method]
    ids = {e["args"]["id"]: e for e in spans}
    for e in spans:
        parent = e["args"]["parent"]
        if method == "layered" and e["name"] == "add":
            assert ids[parent]["name"] == "backward"
            assert ids[parent]["args"]["layer"] == e["args"]["layer"]
        else:
            assert parent == top.id
    assert obs_trace._ACTIVE.tracer is None


def test_adam_step_fused_matches_treemap():
    """adam_step(fused=True) (the K6 path, its plain version here) and the
    tree-map update run the same float ops, clip scale included."""
    c = AdamConfig(lr=3e-4, grad_clip=1.0)
    g0 = torch.Generator().manual_seed(0)
    storage = {"layers": {"w": torch.randn(3, 1, 1, 500, generator=g0)},
               "embed": torch.randn(1, 1, 333, generator=g0)}
    grads = tree.tree_map(lambda t: 0.2 * t + 0.01, storage)
    out = {}
    for fused in (False, True):
        s = tree.tree_map(torch.clone, storage)
        s, o, m = adam_step(c, s, adam_init(s), grads, sq_reduce=stepfn.sq_reduce,
                            fused=fused)
        out[fused] = (tree.leaves(s) + tree.leaves(o["mu"]) + tree.leaves(o["nu"]),
                      m["grad_norm"].item())
    for a, b in zip(out[False][0], out[True][0]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert out[False][1] == out[True][1] > 1.0


@pytest.mark.parametrize("tp,n_data,stacked,model_dim", [
    (1, 1, True, None), (1, 3, False, None), (2, 3, True, 2), (2, 2, False, 0)])
def test_host_partition_matches_jax(tp, n_data, stacked, model_dim):
    """The numpy layout conversion is the JAX package's, bit for bit, and
    its inverse drops the chunk padding."""
    from jax.sharding import PartitionSpec as P
    from repro.core.partition import host_partition_leaf as jhost_partition
    shape = (3, 6, 10) if stacked else (10, 7)
    full = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    spec = P(*["model" if i == model_dim else None for i in range(len(shape))])
    got = zp.host_partition_leaf(full, tp, n_data, stacked=stacked, model_dim=model_dim)
    np.testing.assert_array_equal(got, jhost_partition(full, spec, tp, n_data,
                                                       stacked=stacked))
    back = zp.host_unpartition_leaf(got, shape, tp, stacked=stacked, model_dim=model_dim)
    np.testing.assert_array_equal(back, full)


def test_gather_params_gives_the_model_weights(reference):
    """Storage -> the model's parameter dict in cfg.dtype, usable by the
    forward; equal to the serving conversion of the same JAX tree."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import transformer as T
    params, batch, _ = reference
    cfg = dataclasses.replace(TCFG, dtype="bfloat16")
    got = stepfn.gather_params(cfg, storage_from_numpy(cfg, params, partitioned=True),
                               partitioned=True)
    want = params_from_numpy(cfg, params)
    pairs = dict(T.named_parameters(want))
    for name, t in T.named_parameters(got):
        assert t.dtype == torch.bfloat16            # norm scales too, as JAX gathers them
        torch.testing.assert_close(t.float(), pairs.pop(name).to(torch.bfloat16).float(),
                                   rtol=0, atol=0)
    assert not pairs
    tb = {k: torch.from_numpy(v[0]) for k, v in batch.items()}
    assert torch.isfinite(T.loss_fn(cfg, got, tb)[0])


# ---------------------------------------------------------------------------
# Data and the entry point
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 3])
def test_make_batch_bit_equal_to_jax(step):
    cfg = dict(vocab_size=300, seq_len=33, global_batch=6, n_microbatches=3, seed=7)
    got, want = make_batch(DataConfig(**cfg), step), jmake_batch(JDataConfig(**cfg), step)
    for k in ("tokens", "labels", "mask"):
        assert got[k].dtype == torch.int32 and got[k].shape == (3, 2, 33)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_train_cli_smoke_on_cpu(capsys):
    out = train.main(["--arch", "yi-6b", "--smoke", "--device", "cpu", "--steps", "3",
                      "--seq-len", "32", "--global-batch", "4"])
    assert out["steps"] == 3 and out["device"] == "cpu"
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in out["records"])
    lines = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("step ") for ln in lines) == 3
    assert '"first_loss"' in lines[-1]


PLAN_RUNS = [["--plan", "p.json", "--trace", "t.json"],
             ["--plan", "p.json", "--metrics", "m.jsonl"],
             ["--plan", "p.json", "--checkpoint-dir", "ck"],
             ["--plan", "p.json"]]


def _smoke_plan() -> None:
    """``p.json``: a one-step yi-6b smoke plan from ``launch.plan``."""
    from repro_torch.launch import plan as plan_cli
    plan_cli.main(["--arch", "yi-6b", "--smoke", "--devices", "1", "--global-batch", "4",
                   "--seq-len", "32", "--steps", "1", "--out", "p.json"])


@pytest.mark.parametrize("flags", PLAN_RUNS)
def test_train_cli_runs_a_plan_with_runtime_flags(flags, tmp_path, monkeypatch, capsys):
    """``--plan`` (a plan from ``launch.plan``) runs, with or without the
    run-time flags, and nothing is refused as not ported."""
    monkeypatch.chdir(tmp_path)
    _smoke_plan()
    res = train.main(["--device", "cpu", *flags])
    assert res["steps"] == 1 and math.isfinite(res["last_loss"])
    assert "not ported" not in capsys.readouterr().err


@pytest.mark.parametrize("flags", PLAN_RUNS)
def test_train_cli_refuses_what_is_not_ported(flags, tmp_path, monkeypatch):
    """A plan's supervised run, with each set of run-time flags, takes a
    ``lose_replica`` fault to the failure-shrink, which the one-device plan
    (data 1) refuses as the JAX supervisor does, before it takes the step;
    nothing is refused as not ported.  (``tests/test_torch_shrink.py``
    holds the shrink itself.)"""
    monkeypatch.chdir(tmp_path)
    _smoke_plan()
    with open("f.json", "w") as f:
        json.dump({"faults": [{"kind": "lose_replica", "step": 0}]}, f)
    with pytest.raises(SupervisorError, match=r"^cannot shrink below one data replica "
                                              r"\(step 0\)$"):
        train.main(["--device", "cpu", "--checkpoint-dir", "ck", "--faults", "f.json", *flags])
