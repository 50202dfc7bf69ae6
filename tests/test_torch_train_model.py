"""The port's training forward and loss against the JAX package's, on the
CPU: the same weights (converted through numpy) and batch give the same loss
and the same gradient for every parameter.  The JAX side is
``jax.grad(repro.models.transformer.loss_fn)`` with its kernels on (Pallas in
interpret mode, outside ``shard_map``); the port's side runs its kernels'
plain versions through the same autograd Functions the card uses."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.models.common import AxisCtx, ModelConfig as JModelConfig
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig

# the CFG of tests/test_accumulation.py
ACC = dict(name="t", arch_type="dense", num_layers=3, d_model=32, num_heads=4,
           num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32",
           param_dtype="float32")
CASES = {
    "accumulation-cfg": (JModelConfig(**ACC), ModelConfig(**ACC)),
    # rmsnorm_p1, tied and scaled embeddings, MQA, GeGLU
    "gemma-2b-smoke": (jconfigs.get_config("gemma-2b", smoke=True),
                       configs.get_config("gemma-2b", smoke=True)),
    # sliding window on alternate layers, attention and final softcaps
    "gemma2-9b-smoke": (jconfigs.get_config("gemma2-9b", smoke=True),
                        configs.get_config("gemma2-9b", smoke=True)),
    # LayerNorm and a plain GELU MLP: no RMSNorm kernel on the path
    "paper-x32-smoke": (jconfigs.get_config("paper-x32", smoke=True),
                        configs.get_config("paper-x32", smoke=True)),
    # MQA (4 query heads on one KV head), LayerNorm with bias, plain GELU MLP
    "granite-20b-smoke": (jconfigs.get_config("granite-20b", smoke=True),
                          configs.get_config("granite-20b", smoke=True)),
}


def _batch(vocab: int, B: int = 2, S: int = 24, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, -5:] = 0                          # a few masked tokens
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}


@pytest.mark.parametrize("name", list(CASES))
def test_loss_fn_grads_match_jax(name):
    jcfg, tcfg = CASES[name]
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch(tcfg.vocab_size)

    def jloss(p):
        _, (nll, n) = JT.loss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()},
                                 AxisCtx(), remat=False)
        return nll / n

    want_loss, want = jax.value_and_grad(jloss)(jparams)

    params = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    named = dict(T.named_parameters(params))
    for t in named.values():
        t.requires_grad_()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, (nll, n) = T.loss_fn(tcfg, params, tbatch, remat=True)
    loss = nll / n
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))

    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    # fp32 throughout; the two packages sum in different orders (the tolerance
    # of tests/test_accumulation.py)
    for path, g in jax.tree_util.tree_leaves_with_path(want):
        keys = [p.key for p in path]
        if keys[0] == "layers":
            for i in range(tcfg.num_layers):
                got = grads[".".join(["layers", str(i)] + keys[1:])]
                np.testing.assert_allclose(got.numpy(), np.asarray(g)[i], rtol=3e-4,
                                           atol=3e-5, err_msg=f"{keys} layer {i}")
        else:
            got = grads[".".join(keys)]
            np.testing.assert_allclose(got.numpy(), np.asarray(g), rtol=3e-4,
                                       atol=3e-5, err_msg=str(keys))
