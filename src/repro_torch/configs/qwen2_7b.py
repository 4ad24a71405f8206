"""Qwen2-7B [arXiv:2407.10671; hf] — dense, GQA kv=4, QKV bias, SwiGLU."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    act="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope=True,
    rope_theta=1e6,
))
