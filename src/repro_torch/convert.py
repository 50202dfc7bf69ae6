"""JAX parameter pytree -> the port's parameters, through numpy.

The JAX tree (``repro.models.transformer.init_params``) stacks the layers on
a leading ``[L, ...]`` dim; pass it with numpy leaves (for example
``jax.tree.map(np.asarray, params)``).  ``params_from_numpy`` makes the
serving parameters: matrices in ``cfg.dtype``, norm parameters fp32, as
``transformer.init_params`` makes them.  ``storage_from_numpy`` makes the
fp32 training storage.  The tests use these to give both packages the same
weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as ptree
from repro_torch.core.stepfn import storage_from_params
from repro_torch.models.common import ModelConfig


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32)).to(device=device, dtype=dtype)


def params_from_numpy(cfg: ModelConfig, tree: dict, device="cpu") -> dict:
    dt = cfg.torch_dtype

    def norm(p):
        return {k: _tensor(v, torch.float32, device) for k, v in p.items()}

    def layer(i):
        lp = tree["layers"]
        return {
            "ln1": norm({k: v[i] for k, v in lp["ln1"].items()}),
            "attn": {k: _tensor(v[i], dt, device) for k, v in lp["attn"].items()},
            "ln2": norm({k: v[i] for k, v in lp["ln2"].items()}),
            "mlp": {k: _tensor(v[i], dt, device) for k, v in lp["mlp"].items()},
        }

    params = {
        "embed": _tensor(tree["embed"], dt, device),
        "layers": [layer(i) for i in range(cfg.num_layers)],
        "final_norm": norm(tree["final_norm"]),
    }
    if not cfg.tie_embeddings:
        params["head"] = _tensor(tree["head"], dt, device)
    return params


def storage_from_numpy(cfg: ModelConfig, tree: dict, *, partitioned: bool,
                       device="cpu") -> dict:
    """The JAX parameter tree -> the port's fp32 training storage (the chunk
    layout when ``partitioned``), so both packages start a step from the same
    weights.  The dense stacks' empty ``shared`` subtree is dropped."""
    if tree.get("shared"):
        raise NotImplementedError("hybrid shared-attention blocks are not ported yet")
    params = {k: ptree.tree_map(lambda a: _tensor(a, torch.float32, device), v)
              for k, v in tree.items() if k != "shared"}
    return storage_from_params(params, partitioned=partitioned)
