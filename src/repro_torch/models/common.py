"""Shared model components: config, norms, RoPE, activations, the Megatron
tensor-parallel functions, embeddings and the LM head (counterpart of
``repro/models/common.py``).

Layer code takes an ``AxisCtx`` (``core/dist.py``): its model group is the
tensor-parallel axis.  With no model group (``LOCAL``) no collective runs.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core.dist import LOCAL, AxisCtx
from repro_torch.kernels import ops as kops


# ---------------------------------------------------------------------------
# Model configuration (field-for-field copy of the JAX ModelConfig)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description covering dense / MoE / SSM / hybrid models.

    The fields equal the JAX package's so a config round-trips through
    ``dataclasses.asdict``.  ``kernels`` is kept for that equality only: the
    port picks the kernel or the plain version from the tensor's device.
    """

    name: str
    arch_type: str               # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    hidden_act: str = "silu"     # silu | gelu
    glu: bool = True             # gated (SwiGLU/GeGLU) vs plain 2-layer MLP
    norm: str = "rmsnorm"        # rmsnorm | rmsnorm_p1 | layernorm
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    embed_scale: bool = False    # gemma-style sqrt(d_model) embedding scaling
    # --- attention extras -------------------------------------------------
    sliding_window: int = 0              # >0: window size used by "local" layers
    local_global_period: int = 0         # 0: all global. k>0: layer is global iff (i % k == k-1)
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_dense_residual: bool = False
    moe_dense_ff: int = 0
    router_aux_weight: float = 0.01
    # --- SSM / hybrid ------------------------------------------------------
    block_kind: str = "attn"             # attn | mamba | rwkv
    hybrid_attn_period: int = 0
    ssm_state: int = 0
    ssm_head_dim: int = 64
    rwkv_heads: int = 0
    # --- modality frontend stubs -------------------------------------------
    input_mode: str = "tokens"           # tokens | embeddings | vlm
    vision_prefix_len: int = 0
    # --- numerics ----------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    kernels: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        if self.block_kind == "rwkv" and self.rwkv_heads == 0:
            object.__setattr__(self, "rwkv_heads",
                               self.d_model // self.ssm_head_dim)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def rwkv_inner(self) -> int:
        return self.rwkv_heads * self.ssm_head_dim

    # -- per-layer static tables (plain Python: torch needs no traced form) --
    def layer_windows(self) -> list[int]:
        """Per-layer attention window (0 = full/global attention)."""
        k = self.local_global_period
        if k <= 0 or self.sliding_window <= 0:
            return [0] * self.num_layers
        return [0 if i % k == k - 1 else self.sliding_window
                for i in range(self.num_layers)]

    def attn_layer_flags(self) -> list[int]:
        """Hybrid models: 1 where the shared attention block runs after the layer."""
        k = self.hybrid_attn_period
        if k <= 0:
            return [0] * self.num_layers
        return [int(i % k == k - 1) for i in range(self.num_layers)]

    def attn_slot_index(self) -> list[int]:
        """KV-cache slot for each layer (0 where the layer has no KV cache)."""
        if self.block_kind == "attn":
            return list(range(self.num_layers))
        out, n = [], 0
        for f in self.attn_layer_flags():
            out.append(n if f else 0)
            n += f
        return out

    def num_attn_slots(self) -> int:
        if self.block_kind == "attn":
            return self.num_layers
        if self.hybrid_attn_period > 0:
            return self.num_layers // self.hybrid_attn_period
        return 0

    # -- the windowed (ring) KV cache of the dense serving steps -----------
    @property
    def has_window_cache(self) -> bool:
        return (self.block_kind == "attn" and self.sliding_window > 0
                and self.local_global_period > 0)

    def window_cache_tables(self) -> tuple[list[int], list[int]]:
        """(is_win [L], slot [L]): a ring-buffer or a full-cache slot per layer."""
        is_win = [int(w > 0) for w in self.layer_windows()]
        slot, n_w, n_g = [], 0, 0
        for f in is_win:
            slot.append(n_w if f else n_g)
            n_w, n_g = n_w + f, n_g + 1 - f
        return is_win, slot

    def num_window_slots(self) -> tuple[int, int]:
        """(windowed slots, global slots)."""
        if not self.has_window_cache:
            return 0, self.num_attn_slots()
        k = self.local_global_period
        n_w = sum(1 for i in range(self.num_layers) if i % k != k - 1)
        return n_w, self.num_layers - n_w

    # -- parameter counting (the MFU numerator) ---------------------------
    def attn_block_params(self) -> int:
        d, h = self.d_model, self.head_dim
        return d * h * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * h * d

    def params_per_layer(self, *, active_only: bool = False) -> int:
        """One layer's parameters (matrices only, as the JAX package counts
        them); ``active_only`` counts the experts a token runs
        (``experts_per_token`` of them) and the whole router."""
        d = self.d_model
        mult = 3 if self.glu else 2
        if self.block_kind == "mamba":
            heads = self.d_ff // self.ssm_head_dim
            # in-proj (x, z), B/C (shared across heads), dt proj, out-proj
            return d * self.d_ff * 2 + d * (2 * self.ssm_state + heads) + self.d_ff * d
        if self.block_kind == "rwkv":
            # r, k, v, g, w and time_out; the channel mix's cm_k, cm_v, cm_r
            return 6 * d * self.rwkv_inner + 2 * d * self.d_ff + d * d
        n = self.attn_block_params()
        if self.is_moe:
            e = self.experts_per_token if active_only else self.num_experts
            n += e * mult * d * self.d_ff + d * self.num_experts
            if self.moe_dense_residual:
                n += mult * d * (self.moe_dense_ff or self.d_ff)
            return n
        return n + mult * d * self.d_ff

    def param_count(self, *, active_only: bool = False) -> int:
        n = self.num_layers * self.params_per_layer(active_only=active_only)
        if self.hybrid_attn_period > 0:     # the shared attention + MLP block, once
            n += self.attn_block_params() + (3 if self.glu else 2) * self.d_model * self.d_ff
        return n + self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)

    # -- tensor-parallel head padding (the JAX ModelConfig's, copied) -------
    def padded_for_tp(self, tp: int) -> "ModelConfig":
        """Head counts (and d_ff) padded so they divide the tensor-parallel
        width; the planner costs a model-sharded candidate on this config."""
        nh = self.num_heads
        if nh % tp != 0:
            nh = ((nh + tp - 1) // tp) * tp
        dff = ((self.d_ff + tp - 1) // tp) * tp
        changes = {}
        if nh != self.num_heads:
            changes["num_heads"] = nh
        if dff != self.d_ff:
            changes["d_ff"] = dff
        if self.block_kind == "mamba":
            heads = self.d_ff // self.ssm_head_dim
            if heads % tp != 0:
                heads = ((heads + tp - 1) // tp) * tp
                changes["d_ff"] = heads * self.ssm_head_dim
        if self.block_kind == "rwkv":
            heads = self.rwkv_heads
            if heads % tp != 0:
                changes["rwkv_heads"] = ((heads + tp - 1) // tp) * tp
        if not changes:
            return self
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------
def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """The plain RMSNorm (no kernel): RWKV's own block norms, which the JAX
    package computes outside its kernel too."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    s = 1.0 + scale.float() if plus_one else scale.float()
    return (y * s).to(x.dtype)


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm goes through the differentiable kernel dispatch (K1 forward,
    K2 backward); LayerNorm has no kernel in either package."""
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return kops.rmsnorm(x, p["scale"], plus_one=cfg.norm == "rmsnorm_p1")


def init_norm(cfg: ModelConfig, d: int, device) -> dict:
    """Norm parameters stay fp32: the kernel reads the scale in fp32."""
    kw = dict(dtype=torch.float32, device=device)
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(d, **kw), "bias": torch.zeros(d, **kw)}
    if cfg.norm == "rmsnorm_p1":
        return {"scale": torch.zeros(d, **kw)}
    return {"scale": torch.ones(d, **kw)}


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split, computed in fp32)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] (broadcastable)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None, None].float() * freqs      # [..., S, 1, D/2]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------
def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu
    raise ValueError(f"unknown activation {name!r}")


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap > 0 else x


# ---------------------------------------------------------------------------
# Megatron's f and g over the model group
# ---------------------------------------------------------------------------
class _CopyToModel(torch.autograd.Function):
    """f: identity forward, all-reduce over the model group backward (the
    JAX package's ``compat.tp_entry_mark``).  It marks where a replicated
    activation enters a model-sharded block, whose per-rank input gradients
    are partial."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        ctx.axis.all_reduce(g, "model")
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """g: all-reduce over the model group forward (in place), identity
    backward (the JAX package's ``axis.psum_model``)."""

    @staticmethod
    def forward(ctx, x, axis):
        axis.all_reduce(x, "model")
        ctx.mark_dirty(x)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, axis: AxisCtx) -> torch.Tensor:
    return x if axis.model is None else _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: AxisCtx) -> torch.Tensor:
    """Sum over the model group; ``x`` must be a fresh tensor (it is
    reduced in place)."""
    return x if axis.model is None else _ReduceFromModel.apply(x.contiguous(), axis)


# ---------------------------------------------------------------------------
# Embedding / LM head (vocab sharded over the model group)
# ---------------------------------------------------------------------------
def _vocab_slice(ids: torch.Tensor, vocab_local: int, axis: AxisCtx):
    """Global ids -> (clamped local ids, in-this-shard mask) for the vocab
    rows ``[m * vocab_local, (m + 1) * vocab_local)`` this rank holds."""
    local = ids.long() - axis.model_index * vocab_local
    inside = (local >= 0) & (local < vocab_local)
    return local.clamp(0, vocab_local - 1), inside


def embed_tokens(cfg: ModelConfig, embed: torch.Tensor, tokens: torch.Tensor,
                 axis: AxisCtx = LOCAL) -> torch.Tensor:
    """embed: [V_local, D] (vocab-sharded over the model group); tokens:
    [..., S] -> [..., S, D] in ``cfg.dtype``.  Each rank looks up the tokens
    in its rows, zeroes the rest, and the model group sums."""
    if axis.model is not None:
        ids, inside = _vocab_slice(tokens, embed.shape[0], axis)
        x = reduce_from_model(embed[ids] * inside[..., None].to(embed.dtype), axis)
    else:
        x = embed[tokens.long()]
    x = x.to(cfg.torch_dtype)
    if cfg.embed_scale:
        # the factor is rounded to x's dtype first, as the JAX package does
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def lm_head_loss(cfg: ModelConfig, head: torch.Tensor, x: torch.Tensor,
                 labels: torch.Tensor, mask: torch.Tensor,
                 axis: AxisCtx = LOCAL) -> torch.Tensor:
    """Summed (not averaged) softmax cross-entropy over a vocab-sharded
    head: head [V_local, D]; x [B, S, D]; labels/mask [B, S].  The logits
    are a product in x's dtype, then fp32 and the final softcap; per token
    the loss is ``m + log(sum(exp(logits - m))) - logits[label]``.  The
    stabiliser m is detached (its gradient cancels exactly) and, over a
    model group, the max of the ranks' maxima; the sum of exponentials and
    the picked logit are summed over the group.  Every rank of the group
    returns the same value."""
    sharded = axis.model is not None
    if sharded:
        x = copy_to_model(x, axis)
    logits = lm_logits(cfg, head, x)
    m = logits.detach().amax(-1)
    if sharded:
        axis.all_reduce(m, "model", op="max")
        ids, inside = _vocab_slice(labels, head.shape[0], axis)
        se = reduce_from_model(torch.exp(logits - m[..., None]).sum(-1), axis)
        picked = logits.gather(-1, ids[..., None])[..., 0]
        picked = reduce_from_model(picked * inside.float(), axis)
    else:
        se = torch.exp(logits - m[..., None]).sum(-1)
        picked = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = (m + torch.log(se) - picked) * mask.float()
    return nll.sum()


def lm_logits(cfg: ModelConfig, head: torch.Tensor, x: torch.Tensor,
              axis: AxisCtx = LOCAL) -> torch.Tensor:
    """[..., D] -> fp32 logits: the product in x's dtype, then the final
    softcap in fp32.  ``head`` is this rank's ``[V_local, D]`` rows; over a
    model group the ranks' ``[..., V_local]`` blocks are gathered into the
    whole ``[..., V]`` (the serving steps' logits).  Without ``axis`` the
    logits stay this rank's block (``lm_head_loss``)."""
    logits = softcap((x @ head.to(x.dtype).t()).float(), cfg.final_logit_softcap)
    return logits if axis.model is None else axis.gather_last(logits, "model")


# ---------------------------------------------------------------------------
# Initialisation helpers
# ---------------------------------------------------------------------------
def dense_init(generator: torch.Generator, shape, dtype, device, *,
               scale: float | None = None) -> torch.Tensor:
    s = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return (w * s).to(dtype)
