"""Head dim 256 (both gemma configs) on the CPU: the plain K3, K4 and K5
against the JAX package's Pallas kernels in interpret mode, under MQA and
GQA with softcap 50 and a window that cuts; the plain dq with ds rounded to
bf16, as the tensor-core K4 forms it, against the Pallas dq kernel; and a
gemma2-like model's layered train step against the JAX package's gradients.
The CUDA kernels at this head dim are held against the same plain versions
on the card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from repro_torch.models.common import ModelConfig


JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# (B, S, Hq, Hkv), window, dtype: MQA at rep 8 (gemma-2b's heads) and GQA at
# rep 2 (gemma2-9b's), both with gemma2's softcap 50 and a window that cuts
CASES = [((1, 96, 8, 1), 40, "float32"),
         ((1, 128, 4, 2), 48, "float32"),
         ((1, 96, 8, 1), 40, "bfloat16")]


@pytest.mark.parametrize("shape,window,dtype", CASES)
def test_flash_plain_matches_pallas_at_hd256(shape, window, dtype):
    """K3's plain version against the Pallas forward, then K4's and K5's,
    fed the same out and lse, against the Pallas backward (dq, dk, dv)."""
    B, S, Hq, Hkv = shape
    D, cap = 256, 50.0
    rng = np.random.default_rng(S + window + Hq)
    q, do = (rng.standard_normal((B, S, Hq, D), np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, Hkv, D), np.float32) for _ in range(2))
    qj, kj, vj, doj = (jnp.asarray(a).astype(JDT[dtype]) for a in (q, k, v, do))
    qt, kt, vt, dot = (torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v, do))
    kw = dict(causal=True, window=window, softcap=cap)
    out_j, lse_j = jax_flash_fwd(qj, kj, vj, block_q=32, block_k=32, interpret=True, **kw)
    out_t, lse_t = fa.plain(qt, kt, vt, **kw)
    # the JAX package's own tolerances: fp32 summation order; bf16 its forward
    # and backward tolerance (tests/test_kernels.py), 2e-2
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=tol, atol=tol)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=1e-5, atol=1e-5)

    dq_j, dk_j, dv_j = jax_flash_bwd(qj, kj, vj, out_j, lse_j, doj, block_q=32, block_k=32,
                                     interpret=True, **kw)
    dq_t, delta = fa.plain_bwd_dq(qt, kt, vt, out_t, lse_t, dot, **kw)
    dk_t, dv_t = fa.plain_bwd_dkv(qt, kt, vt, dot, lse_t, delta, **kw)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for name, got, want in (("dq", dq_t, dq_j), ("dk", dk_t, dk_j), ("dv", dv_t, dv_j)):
        assert got.dtype == TDT[dtype]
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("shape,window", [((1, 96, 8, 1), 40), ((1, 128, 4, 2), 48)],
                         ids=["mqa-rep8", "gemma2-rep2"])
def test_dq_with_ds_rounded_to_bf16_matches_pallas_at_hd256(shape, window):
    """The tensor-core K4 at head dim 256 rounds ds to bf16 before dS K (the
    plain version keeps it fp32 unless asked with ``round_ds``); that dq
    stays within the JAX package's bf16 tolerance (2e-2, tests/test_kernels.py)
    of the Pallas ``_attn_bwd_dq_kernel`` in interpret mode, fed the Pallas
    forward's out and lse, with softcap 50 and a window that cuts.  This is
    the tolerance ``chip_smoke.py`` and ``tests/test_torch_gpu.py`` hold the
    kernel to, and the plain version they hold its rows against."""
    B, S, Hq, Hkv = shape
    D, cap = 256, 50.0
    rng = np.random.default_rng(S + window + Hq + 1)
    q, do = (rng.standard_normal((B, S, Hq, D), np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, Hkv, D), np.float32) for _ in range(2))
    qj, kj, vj, doj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v, do))
    kw = dict(causal=True, window=window, softcap=cap)
    out_j, lse_j = jax_flash_fwd(qj, kj, vj, block_q=32, block_k=32, interpret=True, **kw)
    dq_j, _, _ = jax_flash_bwd(qj, kj, vj, out_j, lse_j, doj, block_q=32, block_k=32,
                               interpret=True, **kw)
    qt, kt, vt, dot = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    out_t = torch.tensor(_np(out_j)).bfloat16()
    lse_t = torch.tensor(np.asarray(lse_j))
    got, _ = fa.plain_bwd_dq(qt, kt, vt, out_t, lse_t, dot, round_ds=True, **kw)
    # the rounding is real: the fp32-ds plain version differs from it
    plain, _ = fa.plain_bwd_dq(qt, kt, vt, out_t, lse_t, dot, **kw)
    assert got.dtype == torch.bfloat16 and not torch.equal(got, plain)
    np.testing.assert_allclose(_np(got), _np(dq_j), rtol=2e-2, atol=2e-2)


# a gemma2-like stack at head dim 256: 2 layers (one local, one global),
# narrow width, GQA at rep 2, gemma's GeGLU, (1 + scale) norms, tied and
# scaled embeddings, both softcaps and a window of 8 over 24 positions
GEMMA = dict(name="g", arch_type="dense", num_layers=2, d_model=64, num_heads=4,
             num_kv_heads=2, head_dim=256, d_ff=128, vocab_size=64, hidden_act="gelu",
             glu=True, norm="rmsnorm_p1", tie_embeddings=True, embed_scale=True,
             sliding_window=8, local_global_period=2, attn_logit_softcap=50.0,
             final_logit_softcap=30.0, dtype="float32", param_dtype="float32")
M, ROWS, SEQ = 2, 2, 24


def _full_leaf(leaf: torch.Tensor, shape, stacked: bool) -> np.ndarray:
    """A partitioned storage leaf of one data rank as the full array."""
    return zp.host_unpartition_leaf(leaf.numpy(), shape, 1, stacked=stacked)


def test_gemma2_like_layered_step_matches_jax_at_hd256():
    """The port's layered, partitioned gradient of the mean token loss
    against ``jax.grad`` of the JAX package's ``loss_fn`` (its kernels off),
    on the same weights and batch, at the tolerance of
    ``tests/test_accumulation.py``."""
    jcfg = JModelConfig(**GEMMA, kernels=False)
    tcfg = ModelConfig(**GEMMA)
    assert tcfg.layer_windows() == [8, 0]
    key = jax.random.PRNGKey(5)
    params = JT.init_params(jcfg, key)
    toks = np.asarray(jax.random.randint(key, (M, ROWS, SEQ), 0, 64), np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=-1),
             "mask": np.ones_like(toks)}

    def loss(p):
        flat = {k: jnp.asarray(v).reshape(M * ROWS, SEQ) for k, v in batch.items()}
        _, (nll, n) = JT.loss_fn(jcfg, p, flat, AxisCtx(), remat=False)
        return nll / n

    want = jax.grad(loss)(params)
    params = jax.tree.map(np.asarray, params)
    storage = storage_from_numpy(tcfg, params, partitioned=True)
    acc = AccumConfig(method="layered", partitioned=True, n_microbatches=M)
    grads, metrics = make_grad_fn(tcfg, acc, stepfn.full_template(tcfg))(
        storage, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert torch.isfinite(metrics["loss"]) and metrics["ntok"].item() == M * ROWS * SEQ
    tmpl = stepfn.full_template(tcfg)
    full = {k: tree.tree_map(functools.partial(_full_leaf, stacked=k == "layers"), grads[k],
                             tmpl[k]) for k in grads}
    wants = {tuple(p.key for p in path): np.asarray(leaf)
             for path, leaf in jax.tree_util.tree_leaves_with_path(want)}
    pairs = list(tree.leaves_with_path(full))
    assert sorted(p for p, _ in pairs) == sorted(wants)
    for path, g in pairs:
        np.testing.assert_allclose(g, wants[path], rtol=3e-4, atol=3e-5, err_msg=str(path))
