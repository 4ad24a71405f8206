"""RWKV6-3B "Finch" [arXiv:2404.05892; hf] — attention-free, data-dependent decay."""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,        # head size 64
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    head_dim=64,
    act="relu2",       # rwkv channel-mix uses squared relu
    norm="layernorm",
    rope=False,
    pos_emb="none",
    ssm=SSMConfig(kind="rwkv6", d_state=64, head_dim=64),
))
