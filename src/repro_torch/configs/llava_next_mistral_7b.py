"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

The SigLIP/CLIP vision tower + projector are stubbed per the assignment
carve-out: ``input_specs`` supplies projected patch embeddings
[B, P, d_model] with P = 2880 (anyres: 5 tiles x 576 patches), interleaved
as a prefix to the text tokens.
"""
from repro_torch.configs.base import smoke_variant
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", arch_type="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000, head_dim=128,
    rope_theta=1_000_000.0, hidden_act="silu", glu=True,
    input_mode="vlm", vision_prefix_len=2880,
)
SMOKE = smoke_variant(CONFIG)
