"""Granite-20B-code: MQA (kv=1) dense decoder for code [arXiv:2405.04324]."""
from repro_torch.configs.base import smoke_variant
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", arch_type="dense",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128,
    hidden_act="gelu", glu=False, norm="layernorm",
)
SMOKE = smoke_variant(CONFIG)
