"""Zamba2-7B: Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

81 Mamba2 layers; the shared attention(+MLP) block (one parameter set,
reused) runs after every 6th layer — modeled via hybrid_attn_period with a
single `shared` parameter group (true weight sharing, as in the paper).
"""
from repro_torch.configs.base import smoke_variant
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", arch_type="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000, head_dim=112,
    block_kind="mamba", hybrid_attn_period=6,
    ssm_state=64, ssm_head_dim=64,
    hidden_act="silu", glu=True,
)
SMOKE = smoke_variant(CONFIG)
