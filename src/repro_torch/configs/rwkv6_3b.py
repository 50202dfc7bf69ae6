"""RWKV-6 (Finch) 3B: attention-free, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.configs.base import smoke_variant
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", arch_type="ssm",
    num_layers=32, d_model=2560, num_heads=0, num_kv_heads=0,
    d_ff=8960, vocab_size=65536,
    block_kind="rwkv", ssm_head_dim=64,
)
SMOKE = smoke_variant(CONFIG)
