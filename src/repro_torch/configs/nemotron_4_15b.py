"""Nemotron-4-15B [arXiv:2402.16819] — dense, GQA kv=8, squared-ReLU MLP."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    head_dim=128,
    act="relu2",       # squared ReLU, non-gated
    norm="layernorm",  # nemotron layernorm1p ~ layernorm
    rope=True,
    rope_theta=1e4,
))
