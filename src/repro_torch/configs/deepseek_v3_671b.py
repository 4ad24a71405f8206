"""DeepSeek-V3-671B [arXiv:2412.19437; hf] — MLA + MoE 256e top-8 + 1 shared.

61 layers, d_model=7168, 128 heads, MoE with 1 shared + 256 routed experts
(top-8), per-expert d_ff=2048, MLA latent attention with kv_lora_rank=512
and rope / nope split head dims (the reference's config: every layer is
MoE, the MTP head is omitted).  The attention kernels see q_eff [.., 128,
576] against the latent [.., 1, 576] with v its first 512 columns.
Optimizer moments are bf16 (``parallel/plans.py``), as in the report.
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,  # per-expert ffn dim
    vocab_size=129280,
    act="swiglu",
    norm="rmsnorm",
    rope=True,
    rope_theta=1e4,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1),
))
