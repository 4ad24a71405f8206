"""StarCoder2-3B [arXiv:2402.19173; hf] — dense, GQA kv=2, RoPE, GELU MLP."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    head_dim=128,
    act="gelu",       # non-gated
    norm="layernorm",
    qkv_bias=True,
    mlp_bias=True,
    rope=True,
    rope_theta=1e5,
))
