"""The two input modes beside tokens in the port against the JAX package:
musicgen-large's frame embeddings (``embeddings``: the embedding table is
not used, its gradient is zero) and llava-next-mistral-7b's vision prefix
(``vlm``: projected patches before the text tokens, their labels masked).

Without processes, on the smoke configs: the synthetic batches bit for bit
(``make_audio_batch``, ``make_vlm_batch``, the ``batch_for`` dispatch, a
data rank's rows), ``embed_inputs`` and ``loss_fn`` at 1e-5, and both
accumulation schedules in both layouts against ``jax.grad`` at
tests/test_accumulation.py's rtol 3e-4 / atol 3e-5.  On gloo at 2x2
(``tests/torch_dist_ranks.py``): 3 layered, partitioned steps against JAX's
``build_train_step`` on the (2, 2) mesh, kernels off: loss, grad norm and lr
to 1e-5 relative (tests/test_torch_dist.py's), the final chunks to 2e-4:
Adam's normalised step turns the rounding of a near-zero gradient into a
share of a step (lr 3e-3), as tests/test_torch_moe.py's ``W_ATOL`` says,
and the JAX package's own runs of these 3 steps on the (2, 2) and the
(1, 1) mesh differ by up to 8.0e-5 (musicgen's ``wk``) and 1.33e-4 (llava's
``w_up``) in single elements (measured, CPU).  The entry points: ``launch.train``
trains both on the CPU, ``launch.serve`` refuses both, as JAX's does, and
``launch.plan``'s document for each equals JAX's given its constants.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import stepfn as jstepfn
from repro.core.accumulation import AccumConfig as JAccumConfig
from repro.data import synthetic as jdata
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro.models.common import AxisCtx as JAxisCtx
from repro.optim.adam import AdamConfig as JAdamConfig
from repro.optim.adam import adam_init as jadam_init
from repro.planner import plan as jplan
from repro_torch import configs, tree
from repro_torch.convert import params_from_numpy, storage_from_numpy
from repro_torch.core import partition as zp
from repro_torch.core import stepfn
from repro_torch.core.accumulation import AccumConfig, make_grad_fn
from repro_torch.core.dist import AxisCtx
from repro_torch.data import synthetic as data
from repro_torch.launch import serve, train
from repro_torch.models import transformer as T
from repro_torch.planner import plan as planlib
from test_torch_dist import Spawn, _check_chunks

AX = JAxisCtx()
ARCHS = ("musicgen-large", "llava-next-mistral-7b")
M, ROWS, SEQ = 2, 2, 24          # llava's smoke prefix: 8 of the 24 positions
FP32 = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=3e-4, atol=3e-5)
STEPS = 3
OPT = dict(lr=3e-3, warmup_steps=1, decay_steps=4)
W_ATOL = 2e-4


def _cfgs(arch: str):
    """(JAX smoke config with its kernels off, the port's)."""
    j, t = jconfigs.get_config(arch, smoke=True), configs.get_config(arch, smoke=True)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return dataclasses.replace(j, kernels=False), t


def _data(cfg, seed: int = 3, **over) -> dict:
    return dict(dict(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=M * ROWS,
                     n_microbatches=M, seed=seed), **over)


def _np(batch: dict) -> dict:
    return {k: np.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX config, port config, JAX weights as numpy, JAX's batch of
    step 0 as numpy)."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg, tcfg = _cfgs(arch)
        params = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(70 + i)))
        batch = _np(jdata.batch_for(jcfg, jdata.DataConfig(**_data(jcfg)), 0))
        out[arch] = (jcfg, tcfg, params, batch)
    return out


# ---------------------------------------------------------------------------
# Batches, the embedding and the loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 5])
@pytest.mark.parametrize("arch", ARCHS)
def test_batches_bit_equal_to_jax(arch, step):
    """``batch_for`` (and the mode's own maker) gives JAX's arrays bit for
    bit: the same keys, dtypes and values; the fp32 frames or patches
    ``[M, B/M, S|P, d_model]``; a data rank's rows keyed on the labels."""
    jcfg, tcfg = _cfgs(arch)
    want = _np(jdata.batch_for(jcfg, jdata.DataConfig(**_data(jcfg)), step))
    made = (data.make_audio_batch if arch == "musicgen-large" else data.make_vlm_batch)(
        data.DataConfig(**_data(tcfg)), tcfg, step)
    got = data.batch_for(tcfg, data.DataConfig(**_data(tcfg)), step)
    for batch in (made, got):
        assert sorted(batch) == sorted(want)
        for k, v in batch.items():
            assert v.numpy().dtype == want[k].dtype, k
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    key = "embeds" if arch == "musicgen-large" else "vision_embeds"
    width = SEQ if arch == "musicgen-large" else tcfg.vision_prefix_len
    assert got[key].shape == (M, ROWS, width, tcfg.d_model) and got[key].dtype == torch.float32
    rows = data.batch_for(tcfg, data.DataConfig(**_data(tcfg)), step,
                          AxisCtx(ndata=2, data_index=1))
    for k, v in rows.items():
        np.testing.assert_array_equal(v.numpy(), want[k][:, 1:], err_msg=k)


def test_vlm_batch_masks_the_prefix_and_needs_text():
    """llava's labels and mask are 0 over the vision prefix; a sequence no
    longer than the prefix is refused, as JAX's assertion refuses it."""
    _, tcfg = _cfgs("llava-next-mistral-7b")
    b = data.make_vlm_batch(data.DataConfig(**_data(tcfg)), tcfg, 0)
    P = tcfg.vision_prefix_len
    assert b["tokens"].shape[-1] == SEQ - P and b["labels"].shape[-1] == SEQ
    assert not b["mask"][..., :P].any() and b["mask"][..., P:].all()
    with pytest.raises(ValueError, match="leaves no text"):
        data.make_vlm_batch(data.DataConfig(**_data(tcfg, seq_len=P)), tcfg, 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_embed_inputs_and_loss_match_jax(models, arch):
    """``embed_inputs`` (x and positions over the whole sequence, the
    vision prefix included) and ``loss_fn`` (loss, nll, token count) at
    fp32 1e-5 on one micro-batch."""
    jcfg, tcfg, params, batch = models[arch]
    mb = {k: v[0] for k, v in batch.items()}
    tp = params_from_numpy(tcfg, params)
    tb = {k: torch.from_numpy(v) for k, v in mb.items()}
    jp = jax.tree.map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in mb.items()}
    wx, wpos = JT.embed_inputs(jcfg, jp, jb, AX)
    x, pos = T.embed_inputs(tcfg, tp, tb)
    assert x.dtype == tcfg.torch_dtype and x.shape == (ROWS, SEQ, tcfg.d_model)
    np.testing.assert_allclose(x.numpy(), np.asarray(wx), **FP32)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(wpos))
    wloss, (wnll, wn) = JT.loss_fn(jcfg, jp, jb, AX, remat=False)
    loss, (nll, n) = T.loss_fn(tcfg, tp, tb, remat=False)
    np.testing.assert_allclose(float(loss), float(wloss), **FP32)
    np.testing.assert_allclose(float(nll), float(wnll), **FP32)
    assert float(n) == float(wn)


# ---------------------------------------------------------------------------
# Both schedules against jax.grad
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def references(models):
    """arch -> ``jax.grad`` of the summed token loss over the batch's token
    count (one flat forward: no router), and that loss."""
    out = {}
    for arch, (jcfg, _, params, batch) in models.items():
        flat = {k: jnp.asarray(v.reshape(M * ROWS, *v.shape[2:])) for k, v in batch.items()}

        def loss(p, jcfg=jcfg, flat=flat):
            _, (nll, n) = JT.loss_fn(jcfg, p, flat, AX, remat=False)
            return nll / n

        val, g = jax.value_and_grad(loss)(jax.tree.map(jnp.asarray, params))
        out[arch] = (float(val), jax.tree.map(np.asarray, g))
    return out


def _full(cfg, storage: dict, part: bool) -> dict:
    """One process's storage (or gradient) tree -> the JAX tree's leaves."""
    def one(path, leaf, shape):
        a = leaf.detach().numpy()
        return zp.host_unpartition_leaf(a, tuple(shape), 1, stacked=path[0] == "layers") \
            if part else a
    return tree.tree_map_with_path(one, storage, stepfn.full_template(cfg))


@pytest.mark.parametrize("part", [False, True], ids=["replicated", "partitioned"])
@pytest.mark.parametrize("method", ["standard", "layered"])
@pytest.mark.parametrize("arch", ARCHS)
def test_schedule_grads_match_jax(models, references, arch, method, part):
    """Every leaf at 3e-4 / 3e-5 and the loss at 1e-5; musicgen's embedding
    gradient is exactly zero (the frames do not use it), llava's is the
    text tokens' alone."""
    _, tcfg, params, batch = models[arch]
    want_loss, want = references[arch]
    storage = storage_from_numpy(tcfg, params, partitioned=part)
    grad_fn = make_grad_fn(tcfg, AccumConfig(method=method, partitioned=part, n_microbatches=M),
                           stepfn.full_template(tcfg))
    grads, m = grad_fn(storage, {k: torch.from_numpy(v) for k, v in batch.items()})
    got = _full(tcfg, grads, part)
    wants = {tuple(p.key for p in path): np.asarray(x)
             for path, x in jax.tree_util.tree_leaves_with_path(
                 {k: v for k, v in want.items() if k != "shared"})}
    pairs = dict(tree.leaves_with_path(got))
    assert sorted(pairs) == sorted(wants)
    for path, leaf in pairs.items():
        np.testing.assert_allclose(leaf, wants[path], err_msg=str(path), **GRAD)
    np.testing.assert_allclose(m["loss"].item(), want_loss, **FP32)
    if arch == "musicgen-large":
        assert not np.any(got["embed"])
    else:
        assert np.abs(got["embed"]).max() > 0


# ---------------------------------------------------------------------------
# A gloo 2x2 trajectory against JAX's trainer on the (2, 2) mesh
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trajectories(tmp_path_factory, mesh22):
    """The port's ranks (started first) and JAX's layered, partitioned
    trajectory of each arch, from the same weights and batches."""
    tmp = tmp_path_factory.mktemp("modes")
    key = jax.random.PRNGKey(0)
    cases, jcfgs = [], {}
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        jcfgs[arch] = jcfg
        params = jax.tree.map(np.asarray, jstepfn.init_storage(jcfg, mesh22, key,
                                                               partitioned=False))
        cases.append(dict(kind="train", fused=False, steps=STEPS, data=_data(tcfg, seed=9),
                          opt=OPT, cfg=dataclasses.asdict(tcfg), params=params))
    spawn = Spawn(tmp, "2x2", (2, 2), cases, None, None, cfg=cases[0]["cfg"])
    want = {}
    for arch, c in zip(ARCHS, cases):
        jcfg = jcfgs[arch]
        step = jstepfn.build_train_step(jcfg, mesh22, JAccumConfig("layered", True, M),
                                        JAdamConfig(**OPT), donate=False)
        storage = jstepfn.init_storage(jcfg, mesh22, key, partitioned=True)
        opt = jadam_init(storage)
        recs = []
        for i in range(STEPS):
            batch = jdata.batch_for(jcfg, jdata.DataConfig(**c["data"]), i)
            storage, opt, m = step(storage, opt, batch)
            recs.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
        want[arch] = (recs, jax.tree.map(np.asarray, storage))
    yield spawn, want
    spawn.kill()


@pytest.mark.parametrize("which", range(len(ARCHS)), ids=ARCHS)
def test_gloo_trajectory_matches_jax(trajectories, which):
    """3 layered, partitioned steps at 2x2: every rank reports the same
    losses; loss, grad norm and lr per step to 1e-5 relative of JAX's; the
    final chunks, rank by rank, to ``W_ATOL`` of JAX's (musicgen's
    embedding moved by weight decay alone, in both)."""
    spawn, want = trajectories
    arch = ARCHS[which]
    outs = spawn.result()
    recs = [o["results"][which]["records"] for o in outs]
    for r in recs[1:]:
        assert [x["loss"] for x in r] == [x["loss"] for x in recs[0]]
    want_recs, want_storage = want[arch]
    for i, (g, w) in enumerate(zip(recs[0], want_recs)):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=f"step {i} {k}")
    _check_chunks([dict(o, _storage=o["results"][which]["storage"]) for o in outs],
                  want_storage, atol=W_ATOL)


# ---------------------------------------------------------------------------
# The entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_on_cpu(arch):
    """``launch.train --smoke --device cpu`` trains the arch: finite losses,
    and the throughput counts every position of the sequence (the vision
    prefix too)."""
    out = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                      "--seq-len", "16", "--global-batch", "4"])
    assert out["steps"] == 2
    for r in out["records"]:
        assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
        np.testing.assert_allclose(r["tokens_per_s"] * r["step_time_s"], 4 * 16, rtol=1e-9)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_refuses_like_jax(arch):
    """Paged serving needs token inputs: ``launch.serve`` exits with the
    input mode named, as JAX's ``launch.serve`` exits, before any weights
    are made."""
    with pytest.raises(SystemExit) as want:
        jserve.main(["--arch", arch, "--smoke"])
    assert "token-input" in str(want.value)
    with pytest.raises(SystemExit) as got:
        serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert "needs token inputs" in str(got.value)
    assert configs.get_config(arch).input_mode in str(got.value)


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_document_matches_jax(arch):
    """``launch.plan`` on two devices, one and two stages: given the JAX
    roofline's TPU constants the port's document is JAX's (rows, scores,
    winner, embedded tick table)."""
    kw = dict(devices=2, stage_options=(1, 2), seq_len=SEQ)
    got = planlib.smoke_plan_document(arch, **kw, peak_flops=197e12, link_bw=50e9)
    want = jplan.smoke_plan_document(arch, **kw)
    assert json.loads(json.dumps(got, default=str)) == json.loads(json.dumps(want, default=str))
