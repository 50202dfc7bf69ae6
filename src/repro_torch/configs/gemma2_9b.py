"""Gemma2-9B: alternating local/global attention + logit softcaps [arXiv:2408.00118]."""
from repro_torch.configs.base import smoke_variant
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", arch_type="dense",
    num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8,
    d_ff=14336, vocab_size=256000, head_dim=256,
    hidden_act="gelu", glu=True, norm="rmsnorm_p1",
    tie_embeddings=True, embed_scale=True,
    sliding_window=4096, local_global_period=2,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
)
SMOKE = smoke_variant(CONFIG, head_dim=64)
