"""Granite-3.0-1B-A400M [hf:ibm-granite] — MoE, 32 experts top-8, GQA kv=8."""
from repro_torch.configs.base import MoEConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,  # per-expert ffn dim
    vocab_size=49155,
    head_dim=64,
    act="swiglu",
    norm="rmsnorm",
    rope=True,
    rope_theta=1e4,
    tie_embeddings=True,
    moe=MoEConfig(num_experts=32, top_k=8, d_ff_expert=512),
))
