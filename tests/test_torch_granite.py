"""granite-20b's shapes on the CPU: MQA at rep 48 and head dim 128 (48 query
heads on one KV head), LayerNorm and a plain GELU MLP.  The plain K3, K4 and
K5 against the JAX package's Pallas kernels in interpret mode, the plain K7
against its Pallas decode kernel, and a granite-like model's layered train
step against the JAX package's gradients.  The CUDA kernels at these shapes
are held against the same plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.  About 25 s alone."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_bwd as jax_flash_bwd
from repro.kernels.flash_attention import flash_attention_fwd as jax_flash_fwd
from repro.models import transformer as JT
from repro.models.common import AxisCtx, ModelConfig as JModelConfig
from repro_torch import tree
from repro_torch.convert import storage_from_numpy
from repro_torch.core import partition as zp
from repro_torch.core import stepfn
from repro_torch.core.accumulation import AccumConfig, make_grad_fn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.models.common import ModelConfig

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
HQ, HKV, D = 48, 1, 128                      # granite-20b's attention heads


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_at_granite_heads(dtype):
    """K3's plain version against the Pallas forward at q [1, 64, 48, 128],
    k/v [1, 64, 1, 128], causal; then K4's and K5's, fed the same out and
    lse, against the Pallas backward (dq, dk, dv): K5 sums 48 query heads
    into the one KV head."""
    B, S = 1, 64
    rng = np.random.default_rng(48 + len(dtype))
    q, do = (rng.standard_normal((B, S, HQ, D), np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, HKV, D), np.float32) for _ in range(2))
    qj, kj, vj, doj = (jnp.asarray(a).astype(JDT[dtype]) for a in (q, k, v, do))
    qt, kt, vt, dot = (torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v, do))
    out_j, lse_j = jax_flash_fwd(qj, kj, vj, block_q=64, block_k=64, interpret=True)
    out_t, lse_t = fa.plain(qt, kt, vt)
    # the JAX package's own tolerances: fp32 summation order; bf16 its forward
    # and backward tolerance (tests/test_kernels.py), 2e-2
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=tol, atol=tol)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=1e-5, atol=1e-5)

    dq_j, dk_j, dv_j = jax_flash_bwd(qj, kj, vj, out_j, lse_j, doj, block_q=64, block_k=64,
                                     interpret=True)
    dq_t, delta = fa.plain_bwd_dq(qt, kt, vt, out_t, lse_t, dot)
    dk_t, dv_t = fa.plain_bwd_dkv(qt, kt, vt, dot, lse_t, delta)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for name, got, want in (("dq", dq_t, dq_j), ("dk", dk_t, dk_j), ("dv", dv_t, dv_j)):
        assert got.dtype == TDT[dtype] and got.shape == tuple(want.shape)
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol, err_msg=name)


def test_paged_plain_matches_pallas_at_granite_heads():
    """K7's plain version against the Pallas paged decode kernel (interpret
    mode) at 48 query heads on one KV head of 128, 16-token blocks: ragged
    contexts, one of a single token, one idle slot (zeros)."""
    rng = np.random.default_rng(7)
    R, bs, N, maxb = 4, 16, 10, 3
    q = rng.standard_normal((R, HQ, D), np.float32)
    kp, vp = (rng.standard_normal((N, HKV, bs, D), np.float32) for _ in range(2))
    bt = rng.integers(0, N, (R, maxb)).astype(np.int32)
    lens = np.array([37, 1, 48, 0], np.int32)
    want = jops.paged_attention(*(jnp.asarray(a) for a in (q, kp, vp, bt, lens)),
                                interpret=True)
    got = pa.plain(*(torch.from_numpy(a) for a in (q, kp, vp, bt, lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert not got[3].any()


# a granite-like stack: 2 layers, LayerNorm with bias, a plain GELU MLP (no
# GLU), 12 query heads on one KV head, untied embeddings
GRANITE = dict(name="gr", arch_type="dense", num_layers=2, d_model=96, num_heads=12,
               num_kv_heads=1, head_dim=16, d_ff=192, vocab_size=64, hidden_act="gelu",
               glu=False, norm="layernorm", dtype="float32", param_dtype="float32")
M, ROWS, SEQ = 2, 2, 24


def _full_leaf(leaf: torch.Tensor, shape, stacked: bool) -> np.ndarray:
    """A partitioned storage leaf of one data rank as the full array."""
    return zp.host_unpartition_leaf(leaf.numpy(), shape, 1, stacked=stacked)


def test_granite_like_layered_step_matches_jax():
    """The port's layered, partitioned gradient of the mean token loss
    against ``jax.grad`` of the JAX package's ``loss_fn`` (its kernels off),
    on the same weights and batch, at the tolerance of
    ``tests/test_accumulation.py``; every leaf, the LayerNorm biases
    included."""
    jcfg = JModelConfig(**GRANITE, kernels=False)
    tcfg = ModelConfig(**GRANITE)
    key = jax.random.PRNGKey(6)
    params = JT.init_params(jcfg, key)
    toks = np.asarray(jax.random.randint(key, (M, ROWS, SEQ), 0, 64), np.int32)
    mask = np.ones_like(toks)
    mask[1, 0, -5:] = 0                              # a few masked tokens
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=-1), "mask": mask}

    def loss(p):
        flat = {k: jnp.asarray(v).reshape(M * ROWS, SEQ) for k, v in batch.items()}
        _, (nll, n) = JT.loss_fn(jcfg, p, flat, AxisCtx(), remat=False)
        return nll / n

    want = jax.jit(jax.grad(loss))(params)
    params = jax.tree.map(np.asarray, params)
    storage = storage_from_numpy(tcfg, params, partitioned=True)
    acc = AccumConfig(method="layered", partitioned=True, n_microbatches=M)
    tmpl = stepfn.full_template(tcfg)
    grads, metrics = make_grad_fn(tcfg, acc, tmpl)(
        storage, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert torch.isfinite(metrics["loss"]) and metrics["ntok"].item() == mask.sum()
    full = {k: tree.tree_map(functools.partial(_full_leaf, stacked=k == "layers"), grads[k],
                             tmpl[k]) for k in grads}
    wants = {tuple(p.key for p in path): np.asarray(leaf)
             for path, leaf in jax.tree_util.tree_leaves_with_path(want)}
    pairs = list(tree.leaves_with_path(full))
    assert sorted(p for p, _ in pairs) == sorted(wants)
    assert any("bias" in p for p, _ in pairs)
    for path, g in pairs:
        np.testing.assert_allclose(g, wants[path], rtol=3e-4, atol=3e-5, err_msg=str(path))
