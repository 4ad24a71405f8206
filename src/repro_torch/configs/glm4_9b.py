"""GLM4-9B [hf:THUDM/glm-4-9b] — dense, GQA kv=2, partial RoPE, SwiGLU."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    head_dim=128,
    act="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope=True,
    rope_theta=1e4,
    rope_fraction=0.5,
))
