"""MusicGen-large language-model backbone over EnCodec tokens [arXiv:2306.05284].

The mel/EnCodec frontend is a stub per the assignment carve-out:
``input_specs`` supplies precomputed frame embeddings of shape
[B, S, d_model]; the decoder predicts codec tokens (vocab 2048).
"""
from repro_torch.configs.base import smoke_variant
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", arch_type="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048, head_dim=64,
    hidden_act="gelu", glu=False, norm="layernorm",
    input_mode="embeddings",
)
SMOKE = smoke_variant(CONFIG)
