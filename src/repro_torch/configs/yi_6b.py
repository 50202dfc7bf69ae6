"""Yi-6B: llama-architecture dense decoder with GQA [arXiv:2403.04652]."""
from repro_torch.configs.base import smoke_variant
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", arch_type="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000, head_dim=128,
    rope_theta=5_000_000.0, hidden_act="silu", glu=True,
)
SMOKE = smoke_variant(CONFIG)
