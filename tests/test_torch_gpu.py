"""On the card only (marker ``gpu``): each CUDA kernel against its plain
version, and the serving engine on the card against the same engine on the
CPU.  Imports neither JAX nor ``repro``, so it runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels.ref import (flash_attention_fwd_ref, paged_attention_ref,
                                     rmsnorm_ref)
from repro_torch.models import transformer as T
from repro_torch.serving.cache import PagedCacheConfig
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import SchedulerConfig, poisson_trace


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the card: python -m "
                    "pytest --noconftest -m gpu tests/test_torch_gpu.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 1e-4   # fp32: summation order only


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, plus_one):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(37, 4096, generator=g, device=cuda).to(dtype)
    s = torch.randn(4096, generator=g, device=cuda)
    n = rn.launches
    got = rn.rmsnorm_cuda(x, s, plus_one=plus_one)
    torch.cuda.synchronize()
    assert rn.launches == n + 1
    torch.testing.assert_close(got.float(), rmsnorm_ref(x, s, plus_one=plus_one).float(),
                               rtol=_tol(dtype), atol=_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,window,cap,causal,kv_len", [
    ((2, 200, 8, 2, 128), 0, 0.0, True, 0),
    ((1, 77, 4, 1, 64), 16, 0.0, True, 70),
    ((1, 96, 4, 4, 256), 24, 50.0, True, 0),
    ((2, 50, 4, 2, 64), 12, 0.0, False, 41),
])
def test_flash_kernel_matches_plain(cuda, dtype, shape, window, cap, causal, kv_len):
    B, S, Hq, Hkv, D = shape
    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn(B, S, Hq, D, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=g, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window, softcap=cap, kv_len=kv_len)
    out, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    out_p, lse_p = flash_attention_fwd_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), out_p.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))
    torch.testing.assert_close(lse, lse_p, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,D,bs,window,cap", [
    (32, 4, 128, 16, 0, 0.0), (8, 1, 256, 8, 0, 0.0), (4, 2, 64, 16, 20, 30.0),
    (48, 1, 128, 16, 0, 0.0)])
def test_paged_kernel_matches_plain(cuda, dtype, hq, hkv, D, bs, window, cap):
    R, N, maxb = 6, 64, 40
    g = torch.Generator(device=cuda).manual_seed(hq + D)
    q = torch.randn(R, hq, D, generator=g, device=cuda).to(dtype)
    kp = torch.randn(N, hkv, bs, D, generator=g, device=cuda).to(dtype)
    vp = torch.randn(N, hkv, bs, D, generator=g, device=cuda).to(dtype)
    bt = torch.randint(0, N, (R, maxb), generator=g, device=cuda, dtype=torch.int32)
    ctx = torch.tensor([0, 1, 17, 33, 200, maxb * bs], dtype=torch.int32, device=cuda)
    out = pa.paged_attention_cuda(q, kp, vp, bt, ctx, window=window, softcap=cap)
    want = paged_attention_ref(q, kp, vp, bt, ctx, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert torch.all(out[0] == 0)
    torch.testing.assert_close(out.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["yi-6b", "gemma2-9b"])
def test_engine_on_card_matches_cpu(cuda, arch):
    """fp32 smoke configs: the card (kernels) and the CPU (plain versions)
    emit the same greedy tokens for the same weights and trace."""
    cfg = configs.get_config(arch, smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pcfg = PagedCacheConfig(num_blocks=64, block_size=8, max_blocks_per_seq=6)
    out = {}
    for dev in ("cpu", cuda):
        eng = ServingEngine(cfg, T.to_device(params, dev),
                            SchedulerConfig(cache=pcfg, max_batch=4))
        eng.submit_all(poisson_trace(np.random.default_rng(0), n_requests=6, rate=1.0,
                                     vocab=cfg.vocab_size, prompt_lens=[5, 19, 33],
                                     max_new=[6, 9]))
        out[str(dev)] = eng.run()
    assert out["cpu"] == out[str(cuda)]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(12))
def test_kernels_match_plain_on_random_shapes(cuda, seed):
    """A seeded sweep over the shapes, masks and dtypes both attention
    kernels take."""
    import random
    rnd = random.Random(seed)
    dtype = rnd.choice([torch.float32, torch.bfloat16])
    D = rnd.choice([64, 128, 256])
    hkv = rnd.choice([1, 2, 4])
    hq = hkv * rnd.choice([1, 2, 3, 8, 12])
    window, cap = rnd.choice([0, 0, 1, 7, 33]), rnd.choice([0.0, 0.0, 30.0])
    g = torch.Generator(device=cuda).manual_seed(seed)

    B, S = rnd.randint(1, 3), rnd.randint(1, 150)
    kw = dict(causal=rnd.random() < 0.8, window=window, softcap=cap,
              kv_len=rnd.randint(1, S))
    q = torch.randn(B, S, hq, D, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, S, hkv, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, S, hkv, D, generator=g, device=cuda).to(dtype)
    out, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    out_p, lse_p = flash_attention_fwd_ref(q, k, v, **kw)
    torch.testing.assert_close(out.float(), out_p.float(), rtol=_tol(dtype), atol=_tol(dtype))
    torch.testing.assert_close(lse, lse_p, rtol=1e-4, atol=1e-4)

    R, bs, N = rnd.randint(1, 9), rnd.choice([1, 4, 8, 16, 32, 64]), 97
    maxb = rnd.randint(1, 12)
    ctx = torch.tensor([rnd.randint(0, maxb * bs) for _ in range(R)], dtype=torch.int32,
                       device=cuda)
    qd = torch.randn(R, hq, D, generator=g, device=cuda).to(dtype)
    kp = torch.randn(N, hkv, bs, D, generator=g, device=cuda).to(dtype)
    vp = torch.randn(N, hkv, bs, D, generator=g, device=cuda).to(dtype)
    bt = torch.randint(0, N, (R, maxb), generator=g, device=cuda, dtype=torch.int32)
    got = pa.paged_attention_cuda(qd, kp, vp, bt, ctx, window=window, softcap=cap)
    want = paged_attention_ref(qd, kp, vp, bt, ctx, window=window, softcap=cap)
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype), atol=_tol(dtype))
