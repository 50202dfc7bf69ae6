"""Device dispatch for the kernels the model and optimizer code call.

A tensor on the CPU goes to the kernel's plain version (the CPU tests); a
tensor on the card goes to the hand-written kernel, which launches or
raises.  There is no fallback from one to the other.

``rmsnorm`` and ``flash_attention`` are ``torch.autograd.Function``s whose
backward is a kernel too (K2; K4 and K5), as the JAX package's custom VJPs
are: a raw ctypes launch has no autograd rule, so without them a loss on the
card would lose every gradient upstream of a norm or an attention.

A ``meta`` tensor (shapes only) goes to the plain version too, which then
computes nothing: the kernel's output shapes, as a ``pallas_call``'s
abstract evaluation gives them.  Every kernel's work, launch or plain
version, runs inside ``_kernel(name)``, so that ``core/roofline.py`` can
see it as one opaque call: its counters leave out the plain version's
matrix products, as the JAX walk never enters a ``pallas_call``, and its
memory tracker the plain version's temporaries, which the kernel does not
form.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.kernels import adamw as _aw
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import rmsnorm as _rn


_scope = threading.local()


@contextlib.contextmanager
def _kernel(name: str):
    """Marks the work of kernel ``name`` (on this thread) while it runs."""
    outer = getattr(_scope, "name", None)
    _scope.name = name
    try:
        yield
    finally:
        _scope.name = outer
        if outer is None:
            for f in exit_hooks():
                f()


def exit_hooks() -> list:
    """This thread's callables, each called with no argument when a marked
    kernel's work ends."""
    hooks = getattr(_scope, "exits", None)
    if hooks is None:
        hooks = _scope.exits = []
    return hooks


def current_kernel() -> str | None:
    """The kernel whose work this thread is running, if any."""
    return getattr(_scope, "name", None)


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    if t.is_cuda:
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{name}: no kernel or plain version for device {t.device}")


class _RMSNorm(torch.autograd.Function):
    """K1 forward, K2 backward.  The kernels read the scale in fp32: a bf16
    scale (the training path gathers every leaf in ``cfg.dtype``, as the JAX
    package does) is widened exactly, and dscale is rounded back to the
    scale's dtype, as the JAX custom VJP rounds it."""

    @staticmethod
    def forward(ctx, x, scale, eps, plus_one):
        s32 = scale.float()
        fn = _rn.rmsnorm_cuda if _on_cuda(x, "rmsnorm") else _rn.plain
        with _kernel("rmsnorm"):
            out = fn(x, s32, eps=eps, plus_one=plus_one)
        ctx.save_for_backward(x, s32)
        ctx.eps, ctx.plus_one, ctx.scale_dtype = eps, plus_one, scale.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        x, s32 = ctx.saved_tensors
        fn = _rn.rmsnorm_bwd_cuda if x.is_cuda else _rn.plain_bwd
        g = g.contiguous()
        with _kernel("rmsnorm"):
            dx, ds = fn(x, s32, g, eps=ctx.eps, plus_one=ctx.plus_one)
        return dx, ds.to(ctx.scale_dtype), None, None


def rmsnorm(x, scale, *, eps: float = 1e-6, plus_one: bool = False):
    """x: [..., D]; scale: [D] (fp32, or bf16 on the training path).
    ``plus_one`` is the ``rmsnorm_p1`` (gemma ``1 + scale``) variant.
    Differentiable in x and scale."""
    return _RMSNorm.apply(x, scale, float(eps), bool(plus_one))


class _Flash(torch.autograd.Function):
    """K3 forward (saving q, k, v, out and lse); K4 then K5 backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, kv_len):
        fn = _fa.flash_attention_fwd_cuda if _on_cuda(q, "flash_attention") else _fa.plain
        with _kernel("flash_attention"):
            out, lse = fn(q, k, v, causal=causal, window=window, softcap=softcap,
                          kv_len=kv_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.spec = dict(causal=causal, window=window, softcap=softcap, kv_len=kv_len)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        with _kernel("flash_attention"):
            if q.is_cuda:
                dq, delta = _fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do, **ctx.spec)
                dk, dv = _fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, **ctx.spec)
            else:
                dq, delta = _fa.plain_bwd_dq(q, k, v, out, lse, do, **ctx.spec)
                dk, dv = _fa.plain_bwd_dkv(q, k, v, do, lse, delta, **ctx.spec)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, kv_len: int = 0):
    """q: [B, S, Hq, D]; k, v: [B, S, Hkv, D] -> out [B, S, Hq, D].
    Differentiable in q, k and v."""
    return _Flash.apply(q, k, v, bool(causal), int(window), float(softcap), int(kv_len))


def paged_attention(q, k_pool, v_pool, block_tables, context_lens, *,
                    window: int = 0, softcap: float = 0.0):
    """Single-token decode attention over a paged KV cache.  q: [R, Hq, D];
    pools: [N, Hkv, bs, D]; block_tables: [R, max_blocks]; context_lens: [R].
    Rows with ``context_lens == 0`` return zeros (idle serving slots)."""
    fn = _pa.paged_attention_cuda if _on_cuda(q, "paged_attention") else _pa.plain
    with _kernel("paged_attention"):
        return fn(q, k_pool, v_pool, block_tables, context_lens, window=window,
                  softcap=softcap)


def fused_adamw(p, m, v, g, scalars, *, b1: float, b2: float, eps: float,
                wd: float) -> None:
    """One-pass AdamW on a storage leaf, in place (p, m and v are
    overwritten).  ``scalars`` fp32 [4] = (lr, 1 - b1^t, 1 - b2^t, grad
    scale), on the leaf's device."""
    fn = _aw.adamw_cuda if _on_cuda(p, "fused_adamw") else _plain_adamw
    with _kernel("fused_adamw"):
        fn(p, m, v, g, scalars, b1=b1, b2=b2, eps=eps, wd=wd)


def _plain_adamw(p, m, v, g, scalars, **hyper) -> None:
    """The plain version, written back in place (its temporaries die with
    this call)."""
    for dst, new in zip((p, m, v), _aw.plain(p, m, v, g, scalars, **hyper)):
        dst.copy_(new)
