"""The port's kernels' plain versions against the JAX package's Pallas
kernels (interpret mode on the CPU), and the device dispatch.  The CUDA
kernels themselves are held against the plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_fwd as jax_flash_fwd
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels.ref import (NEG_INF, flash_attention_fwd_ref,
                                     paged_attention_ref, paged_attention_split_ref,
                                     rmsnorm_ref)

DT = {"float32": (np.float32, jnp.float32, torch.float32),
      "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    _, jdt, tdt = DT[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# K1 RMSNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm_plain_matches_pallas(dtype, plus_one):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 256), np.float32) * 3
    s = rng.standard_normal(256, np.float32)
    xj, xt = _both(x, dtype)
    want = jax_rmsnorm(xj, jnp.asarray(s), plus_one=plus_one, interpret=True)
    got = rmsnorm_ref(xt, torch.from_numpy(s), plus_one=plus_one)
    assert got.dtype == DT[dtype][2] and got.shape == xt.shape
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# K3 flash-attention forward (out and lse)
# ---------------------------------------------------------------------------
SHAPES = [(2, 64, 4, 2, 32), (1, 128, 8, 8, 64), (2, 48, 4, 1, 32),
          (1, 96, 6, 3, 16)]
VARIANTS = [(0, 0.0), (16, 0.0), (0, 30.0), (24, 50.0)]
FLASH_CASES = (
    [(shape, w, cap, True, 0, "float32") for shape in SHAPES for w, cap in VARIANTS]
    + [((1, 48, 2, 2, 16), w, 0.0, False, 40, "float32") for w in (0, 12)]  # non-causal, padded keys
    + [((1, 64, 2, 1, 16), 12, 0.0, True, 50, "float32"),   # windowed pad rows see no key
       ((2, 64, 4, 2, 32), 0, 0.0, True, 0, "bfloat16")])


def _live_rows(S, kv_len, causal, window):
    q = np.arange(S)[:, None]
    k = np.arange(S)[None, :]
    mask = (k < kv_len) & (q >= k if causal else True)
    if window > 0:
        mask = mask & (q - k < window)
    return np.broadcast_to(mask, (S, S)).any(-1)


@pytest.mark.parametrize("shape,window,cap,causal,kv_len,dtype", FLASH_CASES)
def test_flash_plain_matches_pallas(shape, window, cap, causal, kv_len, dtype):
    B, S, Hq, Hkv, D = shape
    rng = np.random.default_rng(B * S + window)
    q = rng.standard_normal((B, S, Hq, D), np.float32)
    k = rng.standard_normal((B, S, Hkv, D), np.float32)
    v = rng.standard_normal((B, S, Hkv, D), np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    out_j, lse_j = jax_flash_fwd(qj, kj, vj, causal=causal, window=window,
                                 softcap=cap, kv_len=kv_len, block_q=16,
                                 block_k=16, interpret=True)
    out_t, lse_t = flash_attention_fwd_ref(qt, kt, vt, causal=causal, window=window,
                                           softcap=cap, kv_len=kv_len)
    assert out_t.dtype == qt.dtype and lse_t.dtype == torch.float32
    live = _live_rows(S, kv_len or S, causal, window)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(out_t)[:, live], _np(out_j)[:, live],
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(lse_t.numpy()[..., live], np.asarray(lse_j)[..., live],
                               rtol=1e-5, atol=1e-5)
    # a row that sees no key: out 0 and lse NEG_INF (the TPU kernel gives
    # NEG_INF too; its out there depends on which tiles its loop visits)
    assert np.all(_np(out_t)[:, ~live] == 0)
    assert np.all(lse_t.numpy()[..., ~live] == NEG_INF)
    assert np.all(np.asarray(lse_j)[..., ~live] == NEG_INF)


# The tensor-core K3 rounds p to bf16 before P*V (``round_p``): over the
# cases of tests/test_kernels.py in bf16, that stays inside the JAX package's
# bf16 forward tolerance (2e-2, test_flash_attention_dtypes) of its Pallas
# kernel, which keeps p in fp32.
ROUND_P_CASES = (
    [(shape, w, cap, True, 0) for shape in SHAPES for w, cap in VARIANTS]
    + [((1, 40, 2, 2, 16), w, 0.0, False, 0) for w in (0, 12)]   # non-causal, padded
    + [((1, 64, 4, 2, 32), 0, 0.0, True, 0)])


@pytest.mark.parametrize("shape,window,cap,causal,kv_len", ROUND_P_CASES)
def test_flash_plain_round_p_within_bf16_tolerance(shape, window, cap, causal, kv_len):
    B, S, Hq, Hkv, D = shape
    rng = np.random.default_rng(B * S + window + 1)
    q = rng.standard_normal((B, S, Hq, D), np.float32)
    k = rng.standard_normal((B, S, Hkv, D), np.float32)
    v = rng.standard_normal((B, S, Hkv, D), np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, "bfloat16") for a in (q, k, v))
    want = jops.flash_attention(qj, kj, vj, causal=causal, window=window, softcap=cap,
                                block_q=16, block_k=16)
    kw = dict(causal=causal, window=window, softcap=cap, kv_len=kv_len)
    got, lse = flash_attention_fwd_ref(qt, kt, vt, round_p=True, **kw)
    _, lse_plain = flash_attention_fwd_ref(qt, kt, vt, **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)
    # the option moves only the P*V operand: lse is the default path's
    torch.testing.assert_close(lse, lse_plain, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K7 paged decode
# ---------------------------------------------------------------------------
def _paged_inputs(R, hq, hkv, D, bs, N, maxb, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((R, hq, D), np.float32)
    kp = rng.standard_normal((N, hkv, bs, D), np.float32)
    vp = rng.standard_normal((N, hkv, bs, D), np.float32)
    bt = rng.integers(0, N, (R, maxb)).astype(np.int32)
    return q, kp, vp, bt


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 0.0), (0, 20.0), (7, 30.0)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (4, 1)], ids=["mha", "gqa", "mqa"])
def test_paged_plain_matches_pallas(window, softcap, hq, hkv):
    q, kp, vp, bt = _paged_inputs(5, hq, hkv, 16, 8, 12, 4, seed=hq * 10 + hkv)
    lens = np.array([1, 5, 17, 23, 32], np.int32)   # partial tails, one token, full table
    want = jops.paged_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                jnp.asarray(bt), jnp.asarray(lens), window=window,
                                softcap=softcap)
    got = paged_attention_ref(*(torch.from_numpy(a) for a in (q, kp, vp, bt, lens)),
                              window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_paged_plain_idle_rows_zero():
    q, kp, vp, bt = _paged_inputs(4, 4, 2, 16, 8, 6, 2, seed=1)
    lens = np.array([0, 3, 0, 9], np.int32)
    want = jops.paged_attention(*(jnp.asarray(a) for a in (q, kp, vp, bt, lens)))
    got = paged_attention_ref(*(torch.from_numpy(a) for a in (q, kp, vp, bt, lens))).numpy()
    assert np.all(got[[0, 2]] == 0) and np.any(got[[1, 3]] != 0)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


# The split-and-merge the K7 kernel performs, in plain PyTorch, against the
# Pallas kernel: splits shorter and longer than the contexts, idle rows,
# window, softcap, MQA and block size 8, at the JAX test's tolerance.
@pytest.mark.parametrize("keys_per_split", [4, 16, 64])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 0.0), (0, 20.0), (7, 30.0)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (4, 1)], ids=["mha", "gqa", "mqa"])
def test_paged_split_plain_matches_pallas(keys_per_split, window, softcap, hq, hkv):
    q, kp, vp, bt = _paged_inputs(6, hq, hkv, 16, 8, 12, 4, seed=hq * 10 + hkv + 1)
    lens = np.array([0, 1, 5, 17, 23, 32], np.int32)
    want = jops.paged_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                jnp.asarray(bt), jnp.asarray(lens), window=window,
                                softcap=softcap)
    got = paged_attention_split_ref(*(torch.from_numpy(a) for a in (q, kp, vp, bt, lens)),
                                    keys_per_split=keys_per_split, window=window,
                                    softcap=softcap)
    assert np.all(got.numpy()[0] == 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_split_plain_matches_plain_at_serving_shape(dtype):
    """Yi-6B's decode shape (32 q / 4 KV heads, hd 128, 16-token blocks),
    contexts up to 700 keys over 64-key splits, against the unsplit plain
    version: the split changes only the order of the sums."""
    q, kp, vp, bt = _paged_inputs(8, 32, 4, 128, 16, 400, 45, seed=3)
    lens = np.array([577, 65, 301, 512, 130, 0, 96, 700], np.int32)
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt, lens)]
    args[:3] = [a.to(DT[dtype][2]) for a in args[:3]]
    for kw in ({}, dict(window=100, softcap=50.0)):
        got = paged_attention_split_ref(*args, keys_per_split=64, **kw)
        want = paged_attention_ref(*args, **kw)
        tol = 2e-2 if dtype == "bfloat16" else 1e-5
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
        assert np.all(_np(got)[5] == 0)


# ---------------------------------------------------------------------------
# Dispatch: CPU tensors take the plain versions and launch nothing
# ---------------------------------------------------------------------------
def test_cpu_dispatch_runs_plain_versions():
    before = (rn.launches, fa.launches, pa.launches)
    x = torch.randn(4, 64)
    s = torch.rand(64)
    torch.testing.assert_close(ops.rmsnorm(x, s), rmsnorm_ref(x, s), rtol=0, atol=0)
    q, k = torch.randn(1, 8, 4, 16), torch.randn(1, 8, 2, 16)
    torch.testing.assert_close(ops.flash_attention(q, k, k, window=3),
                               flash_attention_fwd_ref(q, k, k, window=3)[0],
                               rtol=0, atol=0)
    kp = torch.randn(3, 2, 4, 16)
    bt = torch.tensor([[0, 2], [1, 0]], dtype=torch.int32)
    ctx = torch.tensor([5, 0], dtype=torch.int32)
    torch.testing.assert_close(ops.paged_attention(q[0, :2], kp, kp, bt, ctx),
                               paged_attention_ref(q[0, :2], kp, kp, bt, ctx),
                               rtol=0, atol=0)
    assert (rn.launches, fa.launches, pa.launches) == before


def test_dispatch_rejects_other_devices():
    """A ``meta`` tensor (shapes only, the planner's counter) goes to the
    plain version, which computes nothing; a device with neither a kernel
    nor a plain version is refused."""
    x = torch.empty(2, 8, device="meta")
    out = ops.rmsnorm(x, torch.empty(8, device="meta"))
    assert out.device.type == "meta" and out.shape == x.shape
    other = types.SimpleNamespace(is_cuda=False, device=torch.device("xpu"))
    with pytest.raises(ValueError, match="device"):
        ops.paged_attention(other, None, None, None, None)


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.randn(2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm_cuda(x, torch.ones(64))
    q = torch.randn(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention_cuda(q[0], q, q, torch.zeros(8, 1, dtype=torch.int32),
                                torch.ones(8, dtype=torch.int32))


# ---------------------------------------------------------------------------
# The build: no nvcc, or a failing nvcc, raises; nothing falls back
# ---------------------------------------------------------------------------
def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(_build.KernelError, match="nvcc not found"):
        _build.build()


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(_build.KernelError, match="no sm_90a here"):
        _build.build()
    assert list((tmp_path / "build").iterdir()) == []      # no library, no leftovers
