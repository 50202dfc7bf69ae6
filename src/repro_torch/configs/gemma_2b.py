"""Gemma-2B: GeGLU, head_dim 256, MQA, tied + scaled embeddings [arXiv:2403.08295]."""
from repro_torch.configs.base import smoke_variant
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", arch_type="dense",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
    d_ff=16384, vocab_size=256000, head_dim=256,
    hidden_act="gelu", glu=True, norm="rmsnorm_p1",
    tie_embeddings=True, embed_scale=True,
)
SMOKE = smoke_variant(CONFIG, head_dim=64)
