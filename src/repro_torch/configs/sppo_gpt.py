"""The paper's own GPT configs (Table 2): GPT-7B / GPT-13B / GPT-65B.

These are the models SPPO evaluates on (512K–4M token sequences).  They are
registered alongside the assigned architectures so the paper's tables can be
reproduced by the benchmark harness.
"""
from repro_torch.configs.base import ModelConfig, register

GPT_7B = register(ModelConfig(
    name="sppo-gpt-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=16384,
    vocab_size=51200,
    head_dim=128,
    act="gelu",
    norm="layernorm",
    rope=True,
))

GPT_13B = register(ModelConfig(
    name="sppo-gpt-13b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=20480,
    vocab_size=51200,
    head_dim=128,
    act="gelu",
    norm="layernorm",
    rope=True,
))

GPT_65B = register(ModelConfig(
    name="sppo-gpt-65b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=64,
    d_ff=32768,
    vocab_size=51200,
    head_dim=128,
    act="gelu",
    norm="layernorm",
    rope=True,
))
