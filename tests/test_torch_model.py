"""The port's paged prefill and decode steps against the JAX package's, on the
CPU, with the same weights (converted through numpy) and the same inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.models.common import AxisCtx, ModelConfig as JModelConfig
from repro.serving import steps as jsteps
from repro.serving.cache import PagedCacheConfig as JPagedCacheConfig
from repro.serving.cache import init_paged_cache as jinit_cache
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.models.common import ModelConfig
from repro_torch.serving import steps
from repro_torch.serving.cache import PagedCacheConfig, init_paged_cache

AXIS = AxisCtx()
# the CFG of tests/test_serving.py
SV = dict(name="sv", arch_type="dense", num_layers=3, d_model=32, num_heads=4,
          num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32",
          param_dtype="float32")
CASES = {
    "sv": (JModelConfig(**SV), ModelConfig(**SV)),
    "yi-6b-smoke": (jconfigs.get_config("yi-6b", smoke=True),
                    configs.get_config("yi-6b", smoke=True)),
    # window + softcaps + rmsnorm_p1 + tied and scaled embeddings + GeGLU
    "gemma2-9b-smoke": (jconfigs.get_config("gemma2-9b", smoke=True),
                        configs.get_config("gemma2-9b", smoke=True)),
    # MQA (4 query heads on one KV head), LayerNorm with bias, plain GELU MLP
    "granite-20b-smoke": (jconfigs.get_config("granite-20b", smoke=True),
                          configs.get_config("granite-20b", smoke=True)),
}
TOL = dict(rtol=1e-5, atol=1e-5)


def _models(name):
    jcfg, tcfg = CASES[name]
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


def _pools_equal(jcache, tcache, trash):
    for kv in ("k", "v"):
        want = np.asarray(jcache[kv])
        got = tcache[kv].numpy()
        keep = np.arange(want.shape[1]) != trash      # the trash block takes any write
        np.testing.assert_allclose(got[:, keep], want[:, keep], **TOL, err_msg=kv)


@pytest.mark.parametrize("name", list(CASES))
def test_paged_prefill_matches_jax(name):
    jcfg, jparams, tcfg, tparams = _models(name)
    lens = np.array([5, 11, 16], np.int32)           # ragged, right-padded to S
    B, S, bs, maxb = 3, 16, 4, 5
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    tables = np.arange(B * maxb, dtype=np.int32).reshape(B, maxb)
    jp = JPagedCacheConfig(num_blocks=B * maxb, block_size=bs, max_blocks_per_seq=maxb)
    pre = jsteps.build_paged_prefill_fn(jcfg, AXIS, donate=False)
    want, jcache = pre(jparams, jinit_cache(jcfg, jp, AXIS),
                       {"tokens": jnp.asarray(toks), "lens": jnp.asarray(lens)},
                       jnp.asarray(tables))
    tp = PagedCacheConfig(num_blocks=B * maxb, block_size=bs, max_blocks_per_seq=maxb)
    got, tcache = steps.paged_prefill_step(
        tcfg, tparams, init_paged_cache(tcfg, tp, "cpu"),
        {"tokens": torch.from_numpy(toks), "lens": torch.from_numpy(lens)},
        torch.from_numpy(tables))
    assert got.dtype == torch.float32 and got.shape == (B, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _pools_equal(jcache, tcache, tp.trash_block)


@pytest.mark.parametrize("name", list(CASES))
def test_paged_decode_chain_matches_jax(name):
    """Ten decode steps from an empty cache, with one slot idle (len -1)
    throughout, through both packages."""
    jcfg, jparams, tcfg, tparams = _models(name)
    R, n, bs, maxb = 3, 10, 4, 3
    toks = np.random.default_rng(2).integers(0, tcfg.vocab_size, (R, n)).astype(np.int32)
    tables = np.arange(R * maxb, dtype=np.int32).reshape(R, maxb)
    tables[2] = R * maxb                             # the idle slot points at trash
    jp = JPagedCacheConfig(num_blocks=R * maxb, block_size=bs, max_blocks_per_seq=maxb)
    tp = PagedCacheConfig(num_blocks=R * maxb, block_size=bs, max_blocks_per_seq=maxb)
    dec = jsteps.build_paged_decode_fn(jcfg, AXIS, donate=False)
    jcache = jinit_cache(jcfg, jp, AXIS)
    tcache = init_paged_cache(tcfg, tp, "cpu")
    for t in range(n):
        lens = np.array([t, t, -1], np.int32)
        want, jcache = dec(jparams, jcache, jnp.asarray(tables), jnp.asarray(lens),
                           jnp.asarray(toks[:, t]))
        got, tcache = steps.paged_decode_step(
            tcfg, tparams, tcache, torch.from_numpy(tables), torch.from_numpy(lens),
            torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2], **TOL,
                                   err_msg=f"step {t}")
    _pools_equal(jcache, tcache, tp.trash_block)


def test_converted_params_follow_the_jax_tree():
    jcfg, jparams, tcfg, tparams = _models("gemma2-9b-smoke")
    from repro_torch.models import transformer as T
    names = dict(T.named_parameters(tparams))
    assert "head" not in names                       # tied embeddings
    assert names["layers.1.attn.wq"].dtype == torch.float32
    assert names["layers.0.ln1.scale"].dtype == torch.float32
    np.testing.assert_array_equal(names["layers.1.mlp.w_gate"].numpy(),
                                  np.asarray(jparams["layers"]["mlp"]["w_gate"][1]))
    n_jax = sum(np.size(x) for x in jax.tree.leaves(jparams))
    assert sum(t.numel() for t in names.values()) == n_jax
