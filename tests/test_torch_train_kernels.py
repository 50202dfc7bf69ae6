"""The training slice's kernels, CPU side: the plain versions of K2 (RMSNorm
backward), K4/K5 (flash-attention backward) and K6 (AdamW) against the JAX
package's Pallas kernels in interpret mode, and the port's differentiable
``ops.rmsnorm`` / ``ops.flash_attention`` against ``jax.vjp`` of the JAX
custom-VJP ops.  The CUDA kernels are held against these plain versions on
the card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.adamw import adamw_update as jax_adamw
from repro.kernels.rmsnorm import rmsnorm_bwd as jax_rmsnorm_bwd
from repro_torch.kernels import adamw as aw
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels.ref import adamw_ref, rmsnorm_bwd_ref

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a: np.ndarray, dtype: str):
    return jnp.asarray(a).astype(JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# K2 RMSNorm backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm_bwd_plain_matches_pallas(dtype, plus_one):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 9, 256), np.float32) * 2
    g = rng.standard_normal((4, 9, 256), np.float32)
    s = rng.standard_normal(256, np.float32)
    (xj, xt), (gj, gt) = _both(x, dtype), _both(g, dtype)
    dx_j, ds_j = jax_rmsnorm_bwd(xj, jnp.asarray(s), gj, plus_one=plus_one,
                                 block_rows=8, interpret=True)
    dx_t, ds_t = rmsnorm_bwd_ref(xt, torch.from_numpy(s), gt, plus_one=plus_one)
    assert dx_t.dtype == TDT[dtype] and ds_t.dtype == torch.float32
    # fp32: summation order only; bf16: dx is rounded to bf16 (one ulp,
    # 2^-8 relative), dscale sums fp32 products of the same bf16 inputs
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(dx_t), _np(dx_j), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(ds_t), _np(ds_j), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm_op_grads_match_jax_vjp(dtype, plus_one):
    """The differentiable op (K1 forward, K2 backward; plain versions here)
    against ``jax.vjp`` of the JAX custom VJP, with the scale in the compute
    dtype as the training path gathers it: dscale comes back rounded to it."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 7, 128), np.float32)
    s = rng.standard_normal(128, np.float32) * 0.5
    ct = rng.standard_normal((3, 7, 128), np.float32)
    (xj, xt), (sj, st), (cj, cgt) = _both(x, dtype), _both(s, dtype), _both(ct, dtype)
    out_j, vjp = jax.vjp(lambda a, b: jops.rmsnorm(a, b, plus_one=plus_one), xj, sj)
    dx_j, ds_j = vjp(cj)
    xt.requires_grad_()
    st.requires_grad_()
    out_t = ops.rmsnorm(xt, st, plus_one=plus_one)
    dx_t, ds_t = torch.autograd.grad(out_t, [xt, st], cgt)
    assert out_t.dtype == dx_t.dtype == ds_t.dtype == TDT[dtype]
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    for got, want in ((out_t, out_j), (dx_t, dx_j), (ds_t, ds_j)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# K4/K5 flash-attention backward, through the differentiable op
# ---------------------------------------------------------------------------
# the cases of tests/test_kernels.py's VJP parity test, plus bf16
GRAD_CASES = [
    ((2, 64, 4, 2, 32), 0, 0.0, True, "float32"),
    ((1, 96, 6, 3, 16), 24, 50.0, True, "float32"),     # window + softcap + GQA
    ((2, 48, 4, 1, 32), 16, 0.0, True, "float32"),      # MQA
    ((1, 80, 4, 4, 32), 0, 30.0, False, "float32"),     # non-causal + softcap
    ((1, 50, 2, 1, 16), 12, 0.0, False, "float32"),     # odd S, windowed
    ((1, 64, 4, 2, 32), 16, 0.0, True, "bfloat16"),
]


@pytest.mark.parametrize("shape,window,cap,causal,dtype", GRAD_CASES)
def test_flash_op_grads_match_jax_vjp(shape, window, cap, causal, dtype):
    B, S, Hq, Hkv, D = shape
    rng = np.random.default_rng(S + window)
    arrays = [rng.standard_normal(sh, np.float32)
              for sh in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, Hq, D))]
    (qj, qt), (kj, kt), (vj, vt), (cj, ct) = (_both(a, dtype) for a in arrays)
    kw = dict(causal=causal, window=window, softcap=cap)
    out_j, vjp = jax.vjp(lambda q, k, v: jops.flash_attention(
        q, k, v, block_q=32, block_k=32, **kw), qj, kj, vj)
    grads_j = vjp(cj)
    for t in (qt, kt, vt):
        t.requires_grad_()
    before = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
    out_t = ops.flash_attention(qt, kt, vt, **kw)
    grads_t = torch.autograd.grad(out_t, [qt, kt, vt], ct)
    assert (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == before
    # fp32: summation order only; bf16: one ulp of the bf16 outputs
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=tol, atol=tol)
    for name, got, want in zip("qkv", grads_t, grads_j):
        assert got.dtype == TDT[dtype]
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                                   err_msg=f"d{name}")


def test_flash_bwd_plain_pieces_are_the_ops_backward():
    """K4's and K5's plain versions, called one after the other with K4's
    delta, give the op's gradients; dead pad rows (lse NEG_INF) give 0."""
    rng = np.random.default_rng(9)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(sh, np.float32))
                   for sh in ((1, 40, 4, 16), (1, 40, 2, 16), (1, 40, 2, 16),
                              (1, 40, 4, 16)))
    kw = dict(causal=True, window=6, kv_len=33)
    out, lse = fa.plain(q, k, v, **kw)
    dq, delta = fa.plain_bwd_dq(q, k, v, out, lse, do, **kw)
    dk, dv = fa.plain_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.testing.assert_close(delta, (do * out).sum(-1).transpose(1, 2))
    dead = lse[0, 0] <= -1e37                   # rows whose window holds no live key
    assert dead.any() and torch.all(dq[0, dead] == 0)
    assert torch.all(dk[0, 33:] == 0) and torch.all(dv[0, 33:] == 0)
    for t in (q, k, v):
        t.requires_grad_()
    want = torch.autograd.grad(ops.flash_attention(q, k, v, **kw), [q, k, v], do)
    for got, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K6 AdamW
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,block_rows", [((3, 1, 1, 500), None), ((1, 1, 333), 2),
                                              ((4, 1, 1, 1024), 4)])
def test_adamw_plain_matches_pallas(moment_dtype, shape, block_rows):
    rng = np.random.default_rng(len(shape) + (block_rows or 0))
    p = rng.standard_normal(shape, np.float32)
    g = rng.standard_normal(shape, np.float32) * 0.3
    m = rng.standard_normal(shape, np.float32) * 0.1
    v = np.abs(rng.standard_normal(shape, np.float32)) * 0.01
    sc = np.array([3e-4, 1 - 0.9 ** 3, 1 - 0.95 ** 3, 0.7], np.float32)
    hyper = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
    (mj, mt), (vj, vt) = _both(m, moment_dtype), _both(v, moment_dtype)
    want = jax_adamw(jnp.asarray(p), mj, vj, jnp.asarray(g), jnp.asarray(sc),
                     block_rows=block_rows, interpret=True, **hyper)
    got = adamw_ref(torch.from_numpy(p), mt, vt, torch.from_numpy(g),
                    torch.from_numpy(sc), **hyper)
    for name, a, b in zip(("p", "m", "v"), got, want):
        assert a.dtype == (torch.float32 if name == "p" else TDT[moment_dtype])
        # fp32: the same float ops up to FMA contraction; bf16 moments are
        # rounded once to bf16 (2^-8 relative)
        tol = 1e-6 if name == "p" or moment_dtype == "float32" else 4e-3
        np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol, err_msg=name)
    # the op updates in place on the CPU too, and launches nothing here
    pt, n = torch.from_numpy(p.copy()), aw.launches
    ops.fused_adamw(pt, mt, vt, torch.from_numpy(g), torch.from_numpy(sc), **hyper)
    for a, b in zip((pt, mt, vt), got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert aw.launches == n


def test_backward_wrappers_refuse_cpu_tensors():
    x = torch.randn(2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm_bwd_cuda(x, torch.ones(64), x)
    q = torch.randn(1, 8, 2, 64)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd_dq_cuda(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd_dkv_cuda(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        aw.adamw_cuda(x, x, x, x, torch.zeros(4), b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
