"""Whisper-tiny [arXiv:2212.04356] — enc-dec backbone, conv frontend STUB.

Input spec provides precomputed frame embeddings [B, n_frames, d_model]
(the mel+conv frontend is stubbed).  4 encoder layers (bidirectional) + 4
decoder layers (causal self-attn + cross-attn), learned positions.
"""
from repro_torch.configs.base import CrossAttnConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,            # decoder layers
    encoder_layers=4,
    n_frames=1500,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    head_dim=64,
    act="gelu",
    norm="layernorm",
    qkv_bias=True,
    mlp_bias=True,
    rope=False,
    pos_emb="learned",
    max_position=1 << 16,
    cross_attn=CrossAttnConfig(n_context_tokens=1500, every=1),
))
