"""On the card only (marker ``gpu``): each CUDA kernel against its plain
version, gradients through the kernels' autograd Functions, and the serving
engine and the train step on the card against the same on the CPU.  Imports
neither JAX nor ``repro``, so it runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, tree
from repro_torch.core import stepfn
from repro_torch.core.accumulation import AccumConfig
from repro_torch.data.synthetic import DataConfig, make_batch
from repro_torch.kernels import adamw as aw
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels.ref import (adamw_ref, flash_attention_bwd_dkv_ref,
                                     flash_attention_bwd_dq_ref, flash_attention_fwd_ref,
                                     paged_attention_ref, paged_attention_split_ref,
                                     rmsnorm_bwd_ref, rmsnorm_ref)
from repro_torch.models import transformer as T
from repro_torch.optim.adam import AdamConfig, adam_init
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
    pytest.param((2, 200, 8, 2, 112), 0, 0.0, True, 0, id="hd112-gqa"),
    pytest.param((1, 77, 4, 4, 112), 16, 30.0, True, 70, id="hd112-window-cap"),
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
@pytest.mark.parametrize("shape,window,cap,causal,kv_len", [
    ((2, 2048, 32, 4, 128), 0, 0.0, True, 0),     # the training path's micro-batch
    ((8, 512, 32, 4, 128), 0, 0.0, True, 0),      # a serving prefill bucket
    ((3, 77, 6, 2, 128), 0, 0.0, True, 70),       # odd S, kv_len < S, rep 3
    ((2, 300, 8, 2, 64), 40, 30.0, True, 0),      # window, softcap, hd 64
    ((1, 130, 4, 1, 128), 1, 0.0, True, 0),       # a window of one key
    ((2, 50, 4, 2, 64), 12, 0.0, False, 41),      # non-causal, padded keys
    ((2, 1024, 48, 8, 128), 0, 0.0, True, 0),     # rep 6 (dbrx-132b)
    ((1, 1024, 56, 8, 128), 0, 0.0, True, 0),     # rep 7 (arctic-480b): odd rep
    # zamba2-7b's shared attention (hd 112) at the training and prefill
    # shapes, and at rep 4 with a ragged S
    pytest.param((2, 2048, 32, 32, 112), 0, 0.0, True, 0, id="hd112-train"),
    pytest.param((8, 512, 32, 32, 112), 0, 0.0, True, 0, id="hd112-prefill"),
    pytest.param((1, 300, 32, 8, 112), 40, 30.0, True, 290, id="hd112-gqa4"),
])
def test_flash_tensor_core_kernel_matches_plain(cuda, shape, window, cap, causal, kv_len):
    """bf16 K3 at head dim 64, 112 and 128 runs on the tensor cores and rounds p to
    bf16 before P V: within the JAX package's bf16 forward tolerance (2e-2) of
    the output scale, lse within 1e-4, and every row within two bf16 ulps of
    its own scale (its largest |out|) of the plain version with p rounded the
    same way; a row with no live key exactly zero."""
    B, S, Hq, Hkv, D = shape
    g = torch.Generator(device=cuda).manual_seed(S + D)
    q = torch.randn(B, S, Hq, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=cap, kv_len=kv_len)
    n = fa.launches
    out, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    assert fa.launches == n + 1
    out_p, lse_p = flash_attention_fwd_ref(q, k, v, **kw)
    out_r, _ = flash_attention_fwd_ref(q, k, v, round_p=True, **kw)
    torch.cuda.synchronize()
    tol = 2e-2 * max(1.0, out_p.float().abs().max().item())
    assert (out.float() - out_p.float()).abs().max().item() <= tol
    err = (out.float() - out_r.float()).abs().amax(-1)
    scale = out_r.float().abs().amax(-1)
    ulp = torch.ldexp(torch.ones_like(scale), torch.frexp(scale).exponent - 8)
    assert bool((err <= torch.where(scale > 0, 2 * ulp, torch.zeros_like(ulp))).all())
    torch.testing.assert_close(lse, lse_p, rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ctx,window,cap", [
    ([8191, 4096, 0, 40, 63, 64, 65], 0, 0.0),    # up to 128 splits, idle, split edges
    ([8191, 2000, 1, 0], 1000, 50.0),
])
def test_paged_kernel_long_contexts(cuda, dtype, ctx, window, cap):
    """K7 over many 64-key splits merged in one launch: the plain version's
    tolerance (the split only reorders the sums), idle rows exactly zero."""
    R, hq, hkv, D, bs = len(ctx), 32, 4, 128, 16
    maxb = -(-max(ctx) // bs) + 1
    N = R * maxb + 1
    g = torch.Generator(device=cuda).manual_seed(len(ctx))
    q = torch.randn(R, hq, D, generator=g, device=cuda).to(dtype)
    kp, vp = (torch.randn(N, hkv, bs, D, generator=g, device=cuda).to(dtype) for _ in range(2))
    bt = torch.randperm(N - 1, generator=g, device=cuda)[:R * maxb].view(R, maxb).int()
    cl = torch.tensor(ctx, dtype=torch.int32, device=cuda)
    n = pa.launches
    out = pa.paged_attention_cuda(q, kp, vp, bt, cl, window=window, softcap=cap)
    assert pa.launches == n + 1
    want = paged_attention_ref(q, kp, vp, bt, cl, window=window, softcap=cap)
    split = paged_attention_split_ref(q, kp, vp, bt, cl, keys_per_split=pa.KEYS_PER_SPLIT,
                                      window=window, softcap=cap)
    torch.cuda.synchronize()
    assert torch.all(out[cl == 0] == 0)
    for ref in (want, split):
        torch.testing.assert_close(out.float(), ref.float(), rtol=_tol(dtype), atol=_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_is_deterministic(cuda, dtype):
    """The last split block to finish merges the partials in split order, so
    two launches give bit-identical outputs whichever block finishes last."""
    ctx = [577, 65, 301, 512, 130, 449, 96, 260, 4000, 0]
    R, hq, hkv, D, bs = len(ctx), 32, 4, 128, 16
    maxb = -(-max(ctx) // bs) + 1
    N = R * maxb + 1
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(R, hq, D, generator=g, device=cuda).to(dtype)
    kp, vp = (torch.randn(N, hkv, bs, D, generator=g, device=cuda).to(dtype) for _ in range(2))
    bt = torch.randperm(N - 1, generator=g, device=cuda)[:R * maxb].view(R, maxb).int()
    cl = torch.tensor(ctx, dtype=torch.int32, device=cuda)
    first = pa.paged_attention_cuda(q, kp, vp, bt, cl)
    for _ in range(5):
        assert torch.equal(pa.paged_attention_cuda(q, kp, vp, bt, cl), first)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,D,bs,window,cap", [
    (32, 4, 128, 16, 0, 0.0), (8, 1, 256, 8, 0, 0.0), (4, 2, 64, 16, 20, 30.0),
    (48, 1, 128, 16, 0, 0.0), (48, 8, 128, 16, 0, 0.0), (56, 8, 128, 16, 0, 0.0)])
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
@pytest.mark.parametrize("arch", ["yi-6b", "gemma2-9b", "dbrx-132b", "arctic-480b"])
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


# ---------------------------------------------------------------------------
# The training slice: K2, K4/K5, K6, and gradients through the Functions
# ---------------------------------------------------------------------------
def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,D,plus_one", [(37, 4096, False), (300, 2048, True),
                                             (1, 3584, False), (4096, 256, True)])
def test_rmsnorm_bwd_kernel_matches_plain(cuda, dtype, rows, D, plus_one):
    g = torch.Generator(device=cuda).manual_seed(rows)
    x = torch.randn(rows, D, generator=g, device=cuda).to(dtype)
    dy = torch.randn(rows, D, generator=g, device=cuda).to(dtype)
    s = torch.randn(D, generator=g, device=cuda)
    n = rn.bwd_launches
    dx, ds = rn.rmsnorm_bwd_cuda(x, s, dy, plus_one=plus_one)
    dx_p, ds_p = rmsnorm_bwd_ref(x, s, dy, plus_one=plus_one)
    torch.cuda.synchronize()
    assert rn.bwd_launches == n + 1 and ds.dtype == torch.float32
    _close(dx, dx_p, dtype)
    torch.testing.assert_close(ds, ds_p, rtol=1e-4, atol=1e-3)   # sums of `rows` terms


def _flash_bwd_case(cuda, B, S, Hq, Hkv, D, dtype, kw, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, S, Hq, D, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=g, device=cuda).to(dtype)
    do = torch.randn(B, S, Hq, D, generator=g, device=cuda).to(dtype)
    out, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do, **kw)
    dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
    dq_p, delta_p = flash_attention_bwd_dq_ref(q, k, v, out, lse, do, **kw)
    dk_p, dv_p = flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta_p, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(delta, delta_p, rtol=1e-4, atol=1e-4)
    for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
        assert got.dtype == dtype and got.shape == want.shape
        _close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,window,cap,causal,kv_len", [
    ((2, 200, 8, 2, 128), 0, 0.0, True, 0),
    ((1, 77, 4, 1, 64), 16, 0.0, True, 70),
    ((1, 96, 4, 4, 256), 24, 50.0, True, 0),
    ((2, 50, 4, 2, 64), 12, 0.0, False, 41),
    ((1, 300, 32, 4, 128), 0, 0.0, True, 0),
    ((2, 2048, 32, 4, 128), 0, 0.0, True, 0),     # the training path's micro-batch
    ((1, 512, 48, 8, 128), 0, 0.0, True, 0),      # rep 6 (dbrx-132b)
    ((1, 512, 56, 8, 128), 0, 0.0, True, 0),      # rep 7 (arctic-480b)
    pytest.param((2, 2048, 32, 32, 112), 0, 0.0, True, 0, id="hd112-train"),
    pytest.param((1, 300, 32, 8, 112), 40, 30.0, True, 290, id="hd112-gqa4"),
])
def test_flash_bwd_kernels_match_plain(cuda, dtype, shape, window, cap, causal, kv_len):
    n = (fa.bwd_dq_launches, fa.bwd_dkv_launches)
    _flash_bwd_case(cuda, *shape, dtype, dict(causal=causal, window=window, softcap=cap,
                                              kv_len=kv_len), seed=shape[1])
    assert (fa.bwd_dq_launches, fa.bwd_dkv_launches) == (n[0] + 1, n[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,window,cap", [
    ((2, 2048, 32, 4, 128), 0, 0.0),
    ((2, 300, 16, 1, 128), 40, 30.0),
    ((1, 200, 12, 4, 64), 0, 0.0),
    pytest.param((1, 300, 32, 8, 112), 0, 0.0, id="hd112"),
    pytest.param((2, 2048, 8, 1, 256), 0, 0.0, id="hd256-gemma-2b"),
    pytest.param((1, 8192, 16, 8, 256), 4096, 50.0, id="hd256-gemma2-9b"),
])
def test_flash_bwd_kernels_are_deterministic(cuda, shape, window, cap):
    """bf16 K4 and K5 (the tensor-core instances): two launches on the same
    inputs give bit-identical dq, delta, dk and dv.  K5 sums the GQA heads
    and its two warpgroups' partials inside the block, in a fixed order (at
    head dim 256 its blocks' fp32 partials too); K4 sums nothing across
    blocks or warpgroups."""
    B, S, Hq, Hkv, D = shape
    g = torch.Generator(device=cuda).manual_seed(S)
    q, do = (torch.randn(B, S, Hq, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    kw = dict(window=window, softcap=cap)
    out, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    runs = []
    for _ in range(2):
        dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do, **kw)
        runs.append((dq, delta, *fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)))
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "delta", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


# head dim 256 in bf16: gemma-2b's training micro-batch (MQA, rep 8) and
# gemma2-9b's (rep 2, softcap 50, a 4096 window that cuts)
HD256 = [pytest.param((2, 2048, 8, 1), 0, 0.0, id="gemma-2b"),
         pytest.param((1, 8192, 16, 8), 4096, 50.0, id="gemma2-9b")]


def _instances(prof) -> dict:
    """Launches by flash kernel instance in a ``torch.profiler`` run."""
    import re
    out = {}
    for e in prof.key_averages():
        hit = re.search(r"flash_\w*kernel\w*<[^>]*>", e.key)
        if hit and e.device_type == torch.autograd.DeviceType.CUDA:
            out[hit.group(0)] = out.get(hit.group(0), 0) + e.count
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("shape,window,cap", HD256)
def test_hd256_tensor_core_kernels_match_plain(cuda, shape, window, cap):
    """bf16 K3, K4 and K5 at head dim 256 run their tensor-core instances
    (``flash_fwd_kernel_tc<256, 256>``, ``flash_bwd_dq_kernel_tc_split<256>``,
    ``flash_bwd_dkv_kernel_tc_split<256>``) and agree with the plain versions
    within the JAX package's bf16 tolerance (2e-2) of each output's scale;
    lse and delta within 1e-4.  Every dq row is within four bf16 ulps of its
    own scale (its largest |dq|, at least 2^-10 of the output's) of the plain
    version with ds rounded to bf16 as the kernel rounds it, so that the
    rows that see a thousand keys, whose dq is far below the scale of the
    first rows', are held too."""
    from torch.profiler import ProfilerActivity, profile

    B, S, Hq, Hkv = shape
    D = 256
    g = torch.Generator(device=cuda).manual_seed(S + Hq)
    q, do = (torch.randn(B, S, Hq, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    kw = dict(window=window, softcap=cap)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
        dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do, **kw)
        dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
    launched = _instances(prof)
    assert launched == {"flash_fwd_kernel_tc<256, 256>": 1,
                        "flash_bwd_dq_kernel_tc_split<256>": 1,
                        "flash_bwd_dkv_kernel_tc_split<256>": 1}, launched
    out_p, lse_p = flash_attention_fwd_ref(q, k, v, **kw)
    dq_p, delta_p = flash_attention_bwd_dq_ref(q, k, v, out, lse, do, **kw)
    dk_p, dv_p = flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta_p, **kw)
    dq_r, _ = flash_attention_bwd_dq_ref(q, k, v, out, lse, do, round_ds=True, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, lse_p, rtol=0, atol=1e-4)
    torch.testing.assert_close(delta, delta_p, rtol=1e-4, atol=1e-4)
    err = (dq.float() - dq_r.float()).abs().amax(-1)
    scale = dq_r.float().abs().amax(-1)
    scale = scale.clamp(min=2.0 ** -10 * max(1.0, scale.max().item()))
    ulp = torch.ldexp(torch.ones_like(scale), torch.frexp(scale).exponent - 8)
    assert bool((err <= 4 * ulp).all()), (err / ulp).max().item()
    for name, got, want in (("out", out, out_p), ("dq", dq, dq_p), ("dk", dk, dk_p),
                            ("dv", dv, dv_p)):
        tol = 2e-2 * max(1.0, want.float().abs().max().item())
        err = (got.float() - want.float()).abs().max().item()
        assert got.dtype == torch.bfloat16 and err <= tol, (name, err, tol)


@pytest.mark.gpu
def test_hd256_dkv_is_deterministic_with_the_head_split(cuda):
    """bf16 K5 at gemma-2b's shape splits each KV head's 8 query heads over
    several blocks and sums their fp32 partials in a fixed order: five calls
    give the same bits."""
    B, S, Hq, Hkv, D = 2, 2048, 8, 1, 256
    assert fa.dkv_split(B, S, Hq, Hkv, D, fa.DTYPES[torch.bfloat16]) > 1
    g = torch.Generator(device=cuda).manual_seed(3)
    q, do = (torch.randn(B, S, Hq, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    out, lse = fa.flash_attention_fwd_cuda(q, k, v)
    _, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do)
    runs = [fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta) for _ in range(5)]
    torch.cuda.synchronize()
    for r in runs[1:]:
        assert torch.equal(r[0], runs[0][0]) and torch.equal(r[1], runs[0][1])


# granite-20b's training micro-batch (one KV head of 48 query heads: 64 key
# tiles for 132 SMs) and the split K5 keeps there (PERF.md, PR 27)
GRANITE_K5 = (2, 2048, 48, 1, 128)
GRANITE_SPLIT = 4


@pytest.mark.gpu
def test_dkv_splits_granite_heads_and_not_yi(cuda):
    """bf16 K5 at head dim 128 splits granite-20b's 48 query heads over
    ``GRANITE_SPLIT`` blocks a key tile and sums their fp32 partials in a
    fixed order: five calls give the same bits, within the plain version's
    2e-2 of each output's scale.  At Yi-6B's training micro-batch the key
    tiles alone give every SM a block, and K5 does not split."""
    from torch.profiler import ProfilerActivity, profile

    bf16 = fa.DTYPES[torch.bfloat16]
    assert fa.dkv_split(2, 2048, 32, 4, 128, bf16) == 1
    B, S, Hq, Hkv, D = GRANITE_K5
    assert fa.dkv_split(B, S, Hq, Hkv, D, bf16) == GRANITE_SPLIT
    g = torch.Generator(device=cuda).manual_seed(5)
    q, do = (torch.randn(B, S, Hq, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    out, lse = fa.flash_attention_fwd_cuda(q, k, v)
    _, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        runs = [fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta) for _ in range(5)]
        torch.cuda.synchronize()
    assert _instances(prof) == {"flash_bwd_dkv_kernel_tc_grouped<128>": 5}, _instances(prof)
    for r in runs[1:]:
        assert torch.equal(r[0], runs[0][0]) and torch.equal(r[1], runs[0][1])
    want = flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta)
    for name, got, w in zip(("dk", "dv"), runs[0], want):
        tol = 2e-2 * max(1.0, w.float().abs().max().item())
        err = (got.float() - w.float()).abs().max().item()
        assert err <= tol, (name, err, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("D,split,dtype", [(256, 3, torch.bfloat16), (128, 3, torch.bfloat16),
                                           (112, 2, torch.bfloat16), (128, 2, torch.float32)])
def test_dkv_refuses_a_split_it_cannot_take(cuda, monkeypatch, D, split, dtype):
    """K5's C entry takes the split its wrapper sized the workspace for and
    refuses one that does not divide a KV head's query heads (8 / 3), or one
    above 1 for an instance that does not split (head dim 112, whose tiles
    are wider than its rows, and fp32)."""
    from repro_torch.kernels._build import KernelError
    B, S, Hq, Hkv = 1, 256, 8, 1
    g = torch.Generator(device=cuda).manual_seed(4)
    q, do = (torch.randn(B, S, Hq, D, generator=g, device=cuda).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device=cuda).to(dtype) for _ in range(2))
    out, lse = fa.flash_attention_fwd_cuda(q, k, v)
    _, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do)
    monkeypatch.setattr(fa, "dkv_split", lambda *args: split)
    with pytest.raises(KernelError):
        fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta)


@pytest.mark.gpu
def test_bf16_grads_through_flash_match_plain_at_training_shape(cuda):
    """ops.flash_attention in bf16 at the training path's micro-batch: the
    gradients autograd gets from K3 then K4 + K5 equal the plain forward and
    backward's, at the JAX package's bf16 backward tolerance."""
    B, S, Hq, Hkv, D = 2, 2048, 32, 4, 128
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(B, S, Hq, D, generator=g, device=cuda).bfloat16().requires_grad_()
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device=cuda).bfloat16().requires_grad_()
            for _ in range(2))
    do = torch.randn(B, S, Hq, D, generator=g, device=cuda).bfloat16()
    n = (fa.bwd_dq_launches, fa.bwd_dkv_launches)
    grads = torch.autograd.grad(ops.flash_attention(q, k, v), [q, k, v], do)
    assert (fa.bwd_dq_launches, fa.bwd_dkv_launches) == (n[0] + 1, n[1] + 1)
    with torch.no_grad():
        out, lse = flash_attention_fwd_ref(q, k, v)
        dq, delta = flash_attention_bwd_dq_ref(q, k, v, out, lse, do)
        want = (dq, *flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta))
    torch.cuda.synchronize()
    for got, w in zip(grads, want):
        assert got.dtype == torch.bfloat16 and got.shape == w.shape
        _close(got, w, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("moment_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 1, 1, 4099), (1, 1, 4096 * 11), (5,)])
def test_adamw_kernel_matches_plain(cuda, moment_dtype, shape):
    g = torch.Generator(device=cuda).manual_seed(len(shape))
    p = torch.randn(shape, generator=g, device=cuda)
    grad = torch.randn(shape, generator=g, device=cuda) * 0.3
    m = (torch.randn(shape, generator=g, device=cuda) * 0.1).to(moment_dtype)
    v = (torch.rand(shape, generator=g, device=cuda) * 0.01).to(moment_dtype)
    sc = torch.tensor([3e-4, 1 - 0.9 ** 3, 1 - 0.95 ** 3, 0.7], device=cuda)
    hyper = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
    want = adamw_ref(p, m, v, grad, sc, **hyper)
    n = aw.launches
    aw.adamw_cuda(p, m, v, grad, sc, **hyper)            # in place
    torch.cuda.synchronize()
    assert aw.launches == n + 1
    for got, w in zip((p, m, v), want):
        assert got.dtype == w.dtype
        # fp32: FMA contraction only; bf16 moments: one rounding to bf16
        torch.testing.assert_close(got.float(), w.float(), rtol=1e-5 if got.dtype ==
                                   torch.float32 else 8e-3, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(8))
def test_backward_kernels_match_plain_on_random_shapes(cuda, seed):
    """A seeded sweep over the shapes, masks and dtypes K2 and K4/K5 take."""
    import random
    rnd = random.Random(100 + seed)
    dtype = rnd.choice([torch.float32, torch.bfloat16])
    D = rnd.choice([64, 128, 256])
    hkv = rnd.choice([1, 2, 4])
    hq = hkv * rnd.choice([1, 2, 3, 8])
    B, S = rnd.randint(1, 3), rnd.randint(1, 180)
    kw = dict(causal=rnd.random() < 0.8, window=rnd.choice([0, 0, 1, 7, 33]),
              softcap=rnd.choice([0.0, 0.0, 30.0]), kv_len=rnd.randint(1, S))
    _flash_bwd_case(cuda, B, S, hq, hkv, D, dtype, kw, seed)
    rows, Dn = rnd.randint(1, 700), rnd.choice([256, 2048, 4096])
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(rows, Dn, generator=g, device=cuda).to(dtype)
    dy = torch.randn(rows, Dn, generator=g, device=cuda).to(dtype)
    s = torch.randn(Dn, generator=g, device=cuda)
    dx, ds = rn.rmsnorm_bwd_cuda(x, s, dy)
    dx_p, ds_p = rmsnorm_bwd_ref(x, s, dy)
    _close(dx, dx_p, dtype)
    torch.testing.assert_close(ds, ds_p, rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
def test_grads_through_the_kernels_match_cpu(cuda):
    """A loss through ops.rmsnorm and ops.flash_attention keeps every
    gradient on the card (the Functions' backward launches K2, K4 and K5)
    and equals the same loss on the CPU (plain versions), fp32."""
    g = torch.Generator().manual_seed(0)
    x0 = torch.randn(2, 96, 256, generator=g)
    leaves = {"x": x0, "scale": torch.randn(256, generator=g) * 0.3 + 1,
              "wq": torch.randn(256, 4 * 64, generator=g) / 16,
              "wkv": torch.randn(256, 2 * 64, generator=g) / 16}
    grads = {}
    for dev in ("cpu", cuda):
        t = {k: v.to(dev).requires_grad_() for k, v in leaves.items()}
        h = ops.rmsnorm(t["x"], t["scale"])
        q = (h @ t["wq"]).view(2, 96, 4, 64)
        kv = (h @ t["wkv"]).view(2, 96, 2, 64)
        y = ops.flash_attention(q, kv, kv * 0.5, window=40)
        loss = (y * torch.linspace(-1, 1, 64, device=dev)).square().sum()
        n = (rn.bwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
        grads[str(dev)] = dict(zip(t, torch.autograd.grad(loss, list(t.values()))))
        if dev != "cpu":
            assert (rn.bwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == \
                (n[0] + 1, n[1] + 1, n[2] + 1)
    for k in leaves:
        got, want = grads[str(cuda)][k], grads["cpu"][k]
        assert got.is_cuda and float(got.abs().max()) > 0
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5, msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("method,part", [("layered", True), ("standard", False)])
def test_train_step_on_card_matches_cpu(cuda, method, part):
    """fp32 yi-6b smoke config: three steps of build_train_step on the card
    (K1-K6) and on the CPU (plain versions) from the same weights.  Adam's
    eps is 1e-3 here: with the default 1e-8 the update lr * g / (|g| + eps)
    turns the rounding of a near-zero gradient element (card vs CPU) into a
    difference of up to lr in its weight; a larger eps keeps the update a
    smooth function of g, so the weights can be held to fp32 noise."""
    _train_on_card_and_cpu(cuda, configs.get_config("yi-6b", smoke=True),
                           AccumConfig(method=method, partitioned=part, n_microbatches=2))


@pytest.mark.gpu
@pytest.mark.parametrize("ep", [False, True], ids=["chunked", "resident"])
def test_moe_train_step_on_card_matches_cpu(cuda, ep):
    """The same for dbrx-132b smoke (4 experts, top 2), layered and
    partitioned, its expert stacks chunked or resident."""
    _train_on_card_and_cpu(cuda, configs.get_config("dbrx-132b", smoke=True),
                           AccumConfig(partitioned=True, n_microbatches=2, expert_parallel=ep))


def _train_on_card_and_cpu(cuda, cfg, acc):
    part = acc.partitioned
    step = stepfn.build_train_step(cfg, acc, AdamConfig(lr=1e-3, eps=1e-3, warmup_steps=1,
                                                        decay_steps=3))
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=48, global_batch=4,
                      n_microbatches=2)
    cpu = stepfn.init_storage(cfg, 0, partitioned=part, device="cpu",
                              expert_resident=acc.expert_parallel)
    runs = {}
    for dev in ("cpu", cuda):
        storage = tree.tree_map(lambda t: t.to(dev, copy=True), cpu)
        opt = adam_init(storage)
        losses = []
        for i in range(3):
            storage, opt, m = step(storage, opt, make_batch(data, i))
            losses.append((m["loss"].item(), m["grad_norm"].item()))
        runs[str(dev)] = (losses, storage)
    np.testing.assert_allclose(runs[str(cuda)][0], runs["cpu"][0], rtol=1e-4)
    for a, b in zip(tree.leaves(runs[str(cuda)][1]), tree.leaves(runs["cpu"][1])):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_train_cli_on_card(cuda, capsys):
    """The training entry point on the card: finite losses and the device's
    peak memory in every step's record."""
    from repro_torch.launch import train
    out = train.main(["--arch", "yi-6b", "--smoke", "--steps", "2", "--seq-len", "32",
                      "--global-batch", "4"])
    assert out["device"] == "cuda" and out["steps"] == 2
    assert all(np.isfinite(r["loss"]) and r["peak_mem_gb"] > 0 for r in out["records"])
    assert '"first_loss"' in capsys.readouterr().out.splitlines()[-1]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["dbrx-132b", "arctic-480b"])
def test_apply_moe_on_card_matches_cpu(cuda, arch):
    """One MoE block (fp32 smoke config) on the card and on the CPU with the
    same weights: the router's expert ids equal, the output and aux to 1e-4
    (fp32 sums in other orders)."""
    from repro_torch.models import moe
    cfg = configs.get_config(arch, smoke=True)
    p = moe.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", cuda):
        pd = tree.tree_map(lambda t: t.to(dev), p)
        _, ids, _ = moe._router(cfg, pd, x.to(dev).reshape(-1, cfg.d_model))
        y, aux = moe.apply_moe(cfg, pd, x.to(dev))
        out[str(dev)] = (ids.cpu(), y.cpu(), aux.cpu())
    (ids_c, y_c, a_c), (ids_g, y_g, a_g) = out["cpu"], out[str(cuda)]
    assert torch.equal(ids_c, ids_g)
    torch.testing.assert_close(y_g, y_c, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(a_g, a_c, rtol=1e-4, atol=1e-4)


# (losses after step 0, grad norms) relative tolerances, card against CPU:
# tests/test_torch_ssm.py's TRAIN_TOL (RWKV's group norm at init amplifies
# the rounding of its output; the JAX package disagrees with itself as much),
# zamba2's grad norm at 1e-3 (measured on an H100: 8.7e-6 at step 0, 2.8e-4
# at step 2, after two of Adam's normalised steps)
RECURRENT_TOL = {"rwkv6-3b": (1e-3, 5e-2), "zamba2-7b": (1e-4, 1e-3)}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b"])
def test_recurrent_train_step_on_card_matches_cpu(cuda, arch):
    """fp32 smoke configs (zamba2-7b at 4 layers: the shared block twice),
    layered and partitioned: three steps on the card (K1-K6; K3-K5 at the
    shared block's head dim) and on the CPU from the same weights.  Step 0's
    loss at 1e-5, later losses and every grad norm at ``RECURRENT_TOL``; the
    weights at 1e-5 (zamba2-7b) or within 4 lr (rwkv6-3b: two Adam steps
    each way), Adam's eps 1e-3 as in ``_train_on_card_and_cpu``."""
    cfg = configs.get_config(arch, smoke=True)
    if arch == "zamba2-7b":
        cfg = dataclasses.replace(cfg, num_layers=4)
    lr = 1e-3
    step = stepfn.build_train_step(cfg, AccumConfig("layered", True, 2),
                                   AdamConfig(lr=lr, eps=1e-3, warmup_steps=1, decay_steps=3))
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=80, global_batch=4, n_microbatches=2)
    cpu = stepfn.init_storage(cfg, 0, partitioned=True, device="cpu")
    runs = {}
    for dev in ("cpu", cuda):
        storage = tree.tree_map(lambda t: t.to(dev, copy=True), cpu)
        opt = adam_init(storage)
        recs = []
        for i in range(3):
            storage, opt, m = step(storage, opt, make_batch(data, i))
            recs.append((m["loss"].item(), m["grad_norm"].item()))
        runs[str(dev)] = (recs, storage)
    (got, sg), (want, sc) = runs[str(cuda)], runs["cpu"]
    loss_tol, norm_tol = RECURRENT_TOL[arch]
    for i, ((lg, ng), (lc, nc)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(lg, lc, rtol=1e-5 if i == 0 else loss_tol,
                                   err_msg=f"step {i} loss")
        np.testing.assert_allclose(ng, nc, rtol=norm_tol, err_msg=f"step {i} grad norm")
    atol = 1e-5 if arch == "zamba2-7b" else 4 * lr
    for a, b in zip(tree.leaves(sg), tree.leaves(sc)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b"])
def test_dense_prefill_decode_on_card_matches_cpu(cuda, arch):
    """The dense-cache steps, fp32 smoke configs (zamba2-7b at 4 layers, the
    shared attention at its smoke head dim): a 37-token prefill and 4 greedy
    decode steps on the card and on the CPU with the same weights; logits at
    1e-4 of their scale, the greedy tokens and the final recurrent states
    (1e-4 of their scale) equal."""
    cfg = configs.get_config(arch, smoke=True)
    if arch == "zamba2-7b":
        cfg = dataclasses.replace(cfg, num_layers=4)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (3, 37), generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", cuda):
        p = T.to_device(params, dev)
        cache = T.init_cache(cfg, 3, 41, device=dev)
        lg, cache = stepfn.build_prefill_step(cfg)(p, cache, {"tokens": toks.to(dev)})
        logits, greedy = [lg.cpu()], [lg.argmax(-1).cpu()]
        for _ in range(4):
            lg, cache = stepfn.build_serve_step(cfg)(p, cache, greedy[-1].to(dev).int())
            logits.append(lg.cpu())
            greedy.append(lg.argmax(-1).cpu())
        out[str(dev)] = (torch.stack(logits), torch.stack(greedy),
                         tree.tree_map(lambda t: t.float().cpu(), cache["ssm"]))
    (lc, tc, sc), (lg, tg, sg) = out["cpu"], out[str(cuda)]
    assert torch.equal(tc, tg)
    torch.testing.assert_close(lg, lc, rtol=0, atol=1e-4 * max(1.0, float(lc.abs().max())))
    for a, b in zip(tree.leaves(sg), tree.leaves(sc)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * max(1.0, float(b.abs().max())))
