"""DBRX-base: 132B fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base]."""
from repro_torch.configs.base import smoke_variant
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", arch_type="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=10752, vocab_size=100352, head_dim=128,
    num_experts=16, experts_per_token=4,
    rope_theta=500_000.0, hidden_act="silu", glu=True,
)
SMOKE = smoke_variant(CONFIG)
