"""Config system: model configs, input-shape configs, parallel plans, registry.

A copy of ``repro/configs/base.py`` (the JAX package) so the port never
imports the reference.  The registry holds the dense architectures the port
runs: ``qwen2-7b``, the paper's ``sppo-gpt`` family, ``glm4-9b`` (partial
RoPE), ``nemotron-4-15b`` (squared ReLU, LayerNorm), ``starcoder2-3b``
(GeLU with MLP bias), the MoE ``granite-moe-1b-a400m`` (32 experts,
top-8, a tied embedding) and ``deepseek-v3-671b`` (MLA), and the SSM
family: ``rwkv6-3b`` (attention-free RWKV6) and ``zamba2-7b`` (Mamba2
mixers with a weight-shared attention block), the VLM
``llama-3.2-vision-11b`` (a gated cross-attention layer after every 5
self-attention layers) and the encoder-decoder ``whisper-tiny`` (a
bidirectional encoder, cross-attention in every decoder layer, learned
positions).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

# ---------------------------------------------------------------------------
# Sub-configs for family-specific blocks
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"  # "mamba2" | "rwkv6"
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4  # mamba2 short conv (stubbed as identity-free conv)


@dataclass(frozen=True)
class CrossAttnConfig:
    """VLM / enc-dec cross-attention frontends (stub embeddings)."""

    n_context_tokens: int = 1600  # patches (vlm) or frames (audio)
    every: int = 0  # insert a cross-attn block after every `every` self blocks
    context_dim: Optional[int] = None  # None -> d_model (stub pre-projected)


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | vlm | audio | hybrid | moe | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    act: str = "swiglu"  # swiglu | gelu | relu2 | geglu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    qkv_bias: bool = False
    mlp_bias: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0  # glm4 uses partial rotary
    pos_emb: str = "rope"  # rope | learned | none
    max_position: int = 1 << 20
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    cross_attn: Optional[CrossAttnConfig] = None
    # zamba2-style shared attention block applied after every k mixer layers
    shared_attn_every: int = 0
    # whisper-style encoder (frames already embedded by the stub frontend)
    encoder_layers: int = 0
    n_frames: int = 0
    # squared-relu etc. keep the attention softmax in fp32 regardless
    attn_softmax_fp32: bool = True
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True when long_500k decode is runnable (SSM state / linear attn)."""
        return self.family in ("ssm", "hybrid")

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            max_position=4096,
        )
        if self.moe is not None:
            small["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=2, d_ff_expert=32)
        if self.mla is not None:
            small["mla"] = MLAConfig(
                q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
                nope_head_dim=16, v_head_dim=16)
            small["head_dim"] = None
        if self.ssm is not None:
            small["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=16)
        if self.cross_attn is not None:
            small["cross_attn"] = dataclasses.replace(
                self.cross_attn, n_context_tokens=8)
        if self.encoder_layers:
            small["encoder_layers"] = 2
            small["n_frames"] = 16
        if self.shared_attn_every:
            small["shared_attn_every"] = 2
        small["name"] = self.name + "-reduced"
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# Shapes — LM shapes are seq_len x global_batch
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


# ---------------------------------------------------------------------------
# Parallel plan — how a cell maps onto the production mesh
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParallelPlan:
    dp: int = 16          # data-parallel groups on the 'data' axis
    pp: int = 1           # SPPO pipeline stages on the 'data' axis (dp*pp == data)
    sp: int = 16          # sequence/model parallel width == 'model' axis size
    n_chunks: int = 1     # N subsequences (SPPO)
    partition: str = "flops"   # flops | length  (SPPO sequence partitioning)
    offload: bool = True       # adaptive activation offload to pinned_host
    # offload execution form (DESIGN.md §10): "explicit" places act_off rows
    # via memory-kind device_puts in the tick loop (staged-copy emulation on
    # backends without host memory kinds); "xla" delegates placement to the
    # remat offload policy (save_and_offload_only_these_names)
    offload_mode: str = "explicit"
    # backward-reload placement on the explicit path (DESIGN.md §12):
    # "ahead" = tick-level custom_vjp seam issuing chunk i's H2D one event
    # ahead, overlapped with chunk i+1's backward (the simulator's
    # memory-mirror rule, executed); "sync" = autodiff placement — the
    # checkpoint remat replays each chunk's reload at its own backward
    prefetch: str = "ahead"
    msp: bool = False          # multiplexed sequence partitioning (ramp chunks)
    msp_split: int = 2         # sub-chunks per ramp chunk (DESIGN.md §2)
    remat: str = "sppo"        # sppo | full | none
    zero1: bool = True         # shard optimizer states over dp (and pod)
    opt_dtype: str = "float32"  # moment dtype; deepseek uses bfloat16
    # executed optimizer-state offload (DESIGN.md §11): AdamW m/v live in
    # host memory kinds between steps.  moments_mode "explicit" stages one
    # H2D per moment leaf into the device update and one D2H back;
    # "xla" (legacy) keeps host-committed shardings and lets XLA stream.
    offload_moments: bool = False
    moments_mode: str = "explicit"
    # compressed host residency (DESIGN.md §14): quantize the executed
    # offload channels across the host link — act_off rows (offload_dtype)
    # and the AdamW m/v moments (moments_dtype) — as fp8_e4m3 or int8 wire
    # payloads with per-row fp32 scales; "none" keeps raw bf16/fp32 bytes
    offload_dtype: str = "none"
    moments_dtype: str = "none"
    grad_accum: int = 1
    # decode-only: microbatch pipeline over batch dim when pp > 1
    decode_microbatch: int = 1
    # --- beyond-paper perf knobs (§Perf hillclimb; baseline keeps defaults)
    # attn_mode, the attention schedule over the model axis at sp > 1
    # (models/attention.py):
    #            "gather_q" (paper-faithful flash-decoding merge: all-gather
    #              the chunk's queries, attend the local KV shard, merge the
    #              partials with a pmax and two reduce-scatters) |
    #            "gather_kv" (all-gather the KV shard, no merge collectives)
    #            | "auto" (byte-count switch per call site)
    #            | "ring" (rotate KV blocks around the model axis via
    #              ppermute, fold per-hop partials in canonical source order
    #              — DESIGN.md §15; KV working set stays at two blocks, so
    #              chunks whose visible KV exceeds one stage's HBM admit;
    #              parallel/ring.py)
    #            | "local" (no attention collectives at all — executed only
    #              at sp == 1; in the cost model it prices full visible-KV
    #              residency per device, the mode the §15 memory model
    #              rejects for beyond-one-stage contexts)
    attn_mode: str = "gather_q"
    # cast the attention softmax-merge partials to bf16 before reduction
    # (gather_q at sp > 1; no CLI flag: a plan override, as in the reference)
    merge_bf16: bool = False
    # reduce-scatter weight gradients in bf16 (the backward of the weights'
    # all-gather at sp > 1; a plan override, as merge_bf16)
    grad_compress: bool = False

    def validate(self, data_size: int, model_size: int) -> None:
        assert self.dp * self.pp == data_size, (
            f"dp({self.dp}) * pp({self.pp}) must equal data axis ({data_size})")
        assert self.sp == model_size, (
            f"sp({self.sp}) must equal model axis ({model_size})")
        assert not self.msp or self.msp_split >= 2, (
            f"msp_split({self.msp_split}) must be >= 2 (sub-chunks per ramp)")
        assert self.offload_mode in ("explicit", "xla"), (
            f"offload_mode({self.offload_mode!r}) must be explicit|xla")
        assert self.prefetch in ("ahead", "sync"), (
            f"prefetch({self.prefetch!r}) must be ahead|sync")
        assert self.moments_mode in ("explicit", "xla"), (
            f"moments_mode({self.moments_mode!r}) must be explicit|xla")
        assert self.offload_dtype in ("none", "fp8", "int8"), (
            f"offload_dtype({self.offload_dtype!r}) must be none|fp8|int8")
        assert self.moments_dtype in ("none", "fp8", "int8"), (
            f"moments_dtype({self.moments_dtype!r}) must be none|fp8|int8")
        assert self.moments_dtype == "none" or (
            self.offload_moments and self.moments_mode == "explicit"), (
            "moments_dtype compression requires offload_moments with "
            "moments_mode='explicit' (there is no host channel to compress "
            "otherwise)")
        assert self.attn_mode in ("gather_q", "gather_kv", "auto", "ring",
                                  "local"), (
            f"attn_mode({self.attn_mode!r}) must be "
            "gather_q|gather_kv|auto|ring|local")
        assert self.attn_mode != "local" or model_size == 1, (
            "attn_mode='local' runs attention without any cross-device KV "
            "movement, which is only executable at model_size == 1 — on a "
            "wider mesh pick ring/gather_q/gather_kv (DESIGN.md §15)")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def _load_all() -> None:
    import importlib

    for mod in ("qwen2_7b", "sppo_gpt", "glm4_9b", "nemotron_4_15b", "starcoder2_3b",
                "granite_moe_1b_a400m", "deepseek_v3_671b", "rwkv6_3b", "zamba2_7b",
                "llama_3_2_vision_11b", "whisper_tiny"):
        importlib.import_module(f"repro_torch.configs.{mod}")
