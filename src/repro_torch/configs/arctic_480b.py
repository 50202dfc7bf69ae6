"""Snowflake Arctic: 480B MoE, 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.configs.base import smoke_variant
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", arch_type="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000, head_dim=128,
    num_experts=128, experts_per_token=2,
    moe_dense_residual=True, moe_dense_ff=4864,
    hidden_act="silu", glu=True,
)
SMOKE = smoke_variant(CONFIG, moe_dense_ff=256)
