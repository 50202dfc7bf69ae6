"""AdamW on the training-state storage (counterpart of
``repro/optim/adam.py``).

The update is elementwise, so it runs on either layout: full fp32 leaves or
the flat fp32 chunks of ``core/partition.py``.  Everything stays on the
storage's device: the step count, the learning rate, the bias corrections
and the clip scale are device scalars, so a step never waits on the host.
Unlike the JAX package's functional update, this one writes p, m and v in
place (no second copy of the state).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch import tree
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0        # 0 disables clipping
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"   # "bfloat16" halves optimizer-state memory


def schedule(c: AdamConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, in fp32."""
    step = step.float()
    warm = torch.clamp(step / max(c.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - c.warmup_steps) / max(c.decay_steps, 1), 0.0, 1.0)
    cos = c.min_lr_ratio + (1 - c.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return c.lr * warm * cos


def adam_init(storage: dict, *, moment_dtype: str = "float32") -> dict:
    dt = getattr(torch, moment_dtype)
    zeros = lambda t: tree.tree_map(lambda l: torch.zeros(l.shape, dtype=dt,  # noqa: E731
                                                          device=l.device), t)
    device = tree.leaves(storage)[0].device
    return {"mu": zeros(storage), "nu": zeros(storage),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def step_scalars(c: AdamConfig, step: torch.Tensor):
    """(lr, 1 - b1^t, 1 - b2^t) for step count ``step`` (a device int)."""
    t = step.float()
    return schedule(c, step), 1 - c.b1 ** t, 1 - c.b2 ** t


def leaf_update(c: AdamConfig, p, m, v, g, scalars: torch.Tensor) -> None:
    """The update of one leaf (or one layer's slice of a stacked leaf) the
    moment its gradient is known, in place, through the one-pass kernel:
    the fused step's (§C.3) ``upd``.  ``scalars`` fp32 [4] = (lr, 1 - b1^t,
    1 - b2^t, 1), made once per step.  The global norm is not known yet, so
    ``grad_clip`` clips by this gradient's own norm, as the JAX package's
    fused step does."""
    if c.grad_clip > 0:
        n = torch.sqrt(g.float().square().sum() + 1e-16)
        scalars = torch.cat([scalars[:3], torch.clamp(c.grad_clip / n, max=1.0)[None]])
    kops.fused_adamw(p, m, v, g, scalars, b1=c.b1, b2=c.b2, eps=c.eps, wd=c.weight_decay)


def global_norm(c: AdamConfig, grads: dict, *,
                sq_reduce: Callable[[dict], torch.Tensor] | None = None,
                device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The global gradient norm and the clip scale ``min(1, clip / norm)``,
    device scalars (the norm is 0 and the scale 1 without clipping)."""
    if c.grad_clip > 0 and sq_reduce is not None:
        gnorm = torch.sqrt(sq_reduce(grads) + 1e-16)
        return gnorm, torch.clamp(c.grad_clip / gnorm, max=1.0)
    device = device if device is not None else tree.leaves(grads)[0].device
    return torch.zeros((), device=device), torch.ones((), device=device)


def adam_update(c: AdamConfig, storage: dict, opt: dict, grads: dict, gscale: torch.Tensor,
                *, fused: bool | Callable[[tuple], bool] = False) -> tuple[dict, dict, dict]:
    """The AdamW update itself, in place, with the clip scale ``gscale``.

    ``fused=True`` sends each leaf to the one-pass kernel (K6 on the card,
    its plain version on the CPU): the clip scale goes into the kernel's
    scalars ``(lr, 1 - b1^t, 1 - b2^t, gscale)``, a device fp32 [4], instead
    of being applied to the gradient tree.  ``fused`` may also be a
    predicate on a leaf's key path, for mixed storage (the pipeline's
    chunked layer stacks beside whole outer leaves), as in the JAX
    package.  Returns (storage, opt with the new step, {"lr"})."""
    step = opt["step"] + 1
    lr, b1c, b2c = step_scalars(c, step)
    paths = [path for path, _ in tree.leaves_with_path(storage)]
    flat = zip(paths, tree.leaves(storage), tree.leaves(opt["mu"]), tree.leaves(opt["nu"]),
               tree.leaves(grads))
    scalars = torch.stack([lr, b1c, b2c, gscale]).float() if fused else None
    for path, p, m, v, g in flat:
        if fused if isinstance(fused, bool) else fused(path):
            kops.fused_adamw(p, m, v, g, scalars, b1=c.b1, b2=c.b2, eps=c.eps,
                             wd=c.weight_decay)
            continue
        g = g * gscale
        m32 = c.b1 * m.float() + (1 - c.b1) * g
        v32 = c.b2 * v.float() + (1 - c.b2) * g.square()
        mh = m32 / b1c
        vh = v32 / b2c
        p.copy_(p - lr * (mh / (torch.sqrt(vh) + c.eps) + c.weight_decay * p))
        m.copy_(m32)
        v.copy_(v32)
    return storage, dict(opt, step=step), {"lr": lr}


def adam_step(c: AdamConfig, storage: dict, opt: dict, grads: dict, *,
              sq_reduce: Callable[[dict], torch.Tensor] | None = None,
              fused: bool | Callable[[tuple], bool] = False) -> tuple[dict, dict, dict]:
    """One AdamW update, in place: ``global_norm`` then ``adam_update``.
    All trees share the storage layout.  Returns (storage, opt, {"lr",
    "grad_norm"})."""
    gnorm, gscale = global_norm(c, grads, sq_reduce=sq_reduce,
                                device=opt["step"].device)
    storage, opt, om = adam_update(c, storage, opt, grads, gscale, fused=fused)
    return storage, opt, dict(om, grad_norm=gnorm)
