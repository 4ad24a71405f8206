"""Llama-3.2-Vision-11B [hf:meta-llama/Llama-3.2-11B-Vision] — VLM backbone.

Decoder with a cross-attention image layer after every 5 self-attention
layers (8 cross blocks across 40 self layers, as in the HF checkpoint).  The
vision frontend is a STUB: the input spec provides precomputed patch
embeddings [B, n_patches, d_model].
"""
from repro_torch.configs.base import CrossAttnConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    act="swiglu",
    norm="rmsnorm",
    rope=True,
    rope_theta=5e5,
    cross_attn=CrossAttnConfig(n_context_tokens=1600, every=5),
))
