"""Zamba2-7B [arXiv:2411.15242] — hybrid: Mamba2 mixers + shared attention block.

81 mixer layers; a single *shared* (weight-tied) attention+MLP block is applied
after every 6 Mamba2 layers (14 applications, last group ghost-padded).
ssm_state=64 per the brief.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,   # 3584 / 32 for the shared attention block
    act="swiglu",
    norm="rmsnorm",
    rope=True,
    rope_theta=1e4,
    ssm=SSMConfig(kind="mamba2", d_state=64, head_dim=64, expand=2),
    shared_attn_every=6,
))
