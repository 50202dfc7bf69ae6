"""The paper's X_[x] transformer family (appendix B, eq. 1).

  d_a = x/2 heads, d_h = 2x head size, d_l = x layers,
  d_s = 16x sequence length, d_m = x^2 width, d_I = 4x^2 FFN.
Critical batch size b_c ~= 82 x^(2/3)  (eq. 2).

The one LayerNorm, plain-GELU (no GLU) configuration the port has: its
training path runs no RMSNorm kernel.
"""
from repro_torch.configs.base import smoke_variant
from repro_torch.models.common import ModelConfig


def x_family(x: int, vocab: int = 32000) -> ModelConfig:
    return ModelConfig(
        name=f"paper-x{x}", arch_type="dense",
        num_layers=x, d_model=x * x, num_heads=x // 2, num_kv_heads=x // 2,
        d_ff=4 * x * x, vocab_size=vocab, head_dim=2 * x,
        hidden_act="gelu", glu=False, norm="layernorm",
    )


def seq_len(x: int) -> int:
    return 16 * x


def critical_batch(x: int) -> float:
    return 82.0 * x ** (2.0 / 3.0)


CONFIG = x_family(32)          # ~400M
SMOKE = smoke_variant(CONFIG)
