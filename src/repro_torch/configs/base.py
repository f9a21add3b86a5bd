"""Config system: model configs, input-shape sets, and the arch registry."""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class MoECfg:
    num_experts: int                 # routed experts
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    every: int = 1                   # MoE layer every N layers
    first_dense: int = 1             # leading dense layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # the top-k gates divided by their sum (True, the JAX package's router)
    # or left as the softmax's probabilities (DeepSeek-V2's published
    # ``norm_topk_prob: false``)
    norm_topk_prob: bool = True


@dataclass(frozen=True)
class MLACfg:
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128


@dataclass(frozen=True)
class MambaCfg:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_dim: int = 4


@dataclass(frozen=True)
class AttnCfg:
    rope_theta: float = 10000.0
    use_rope: bool = True
    window: Optional[int] = None         # sliding-window size for local layers
    # layer pattern, cycled: "g"=global, "l"=local(window). gemma3 = 5 local : 1 global
    pattern: tuple[str, ...] = ("g",)
    mrope_sections: Optional[tuple[int, int, int]] = None   # qwen2-vl M-RoPE
    qk_norm: bool = False
    logit_soft_cap: Optional[float] = None
    # YaRN rope scaling (DeepSeek-V2's ``rope_scaling``, type "yarn"); off
    # at factor 1.0, the JAX package's plain rope
    yarn_factor: float = 1.0
    yarn_original_max_pos: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                          # dense | moe | vlm | hybrid | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                    # 0 -> d_model // n_heads
    mlp: str = "swiglu"                  # swiglu | geglu | relu2 | gelu
    norm: str = "rms"                    # rms | ln
    attn: AttnCfg = field(default_factory=AttnCfg)
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    mamba: Optional[MambaCfg] = None
    # hybrid (jamba): layer kinds cycled over n_layers, "a"=attention, "m"=mamba
    hybrid_pattern: Optional[tuple[str, ...]] = None
    # enc-dec (whisper)
    enc_dec: bool = False
    enc_layers: int = 0
    enc_frames: int = 1500               # stub frontend output length
    # vlm (qwen2-vl): number of stub patch embeddings prepended to the sequence
    vlm_patches: int = 0
    tie_embeddings: bool = False
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(1, self.n_heads))

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def layer_kinds(self) -> tuple[str, ...]:
        """Per-layer kind: 'a' (attention), 'm' (mamba)."""
        if self.family == "ssm":
            return tuple("m" for _ in range(self.n_layers))
        if self.hybrid_pattern:
            pat = self.hybrid_pattern
            return tuple(pat[i % len(pat)] for i in range(self.n_layers))
        return tuple("a" for _ in range(self.n_layers))

    def attn_kinds(self) -> tuple[str, ...]:
        """Per-attention-layer local/global pattern ('l' or 'g')."""
        pat = self.attn.pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    def moe_layers(self) -> tuple[bool, ...]:
        if self.moe is None:
            return tuple(False for _ in range(self.n_layers))
        m = self.moe
        return tuple(
            (i >= m.first_dense) and ((i - m.first_dense) % m.every == 0)
            for i in range(self.n_layers))


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode
    sub_quadratic_required: bool = False


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode", sub_quadratic_required=True)

SHAPES: dict[str, ShapeSpec] = {s.name: s for s in
                                (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

ARCH_IDS = (
    "nemotron_4_15b",
    "deepseek_7b",
    "phi3_mini_3p8b",
    "gemma3_27b",
    "deepseek_moe_16b",
    "deepseek_v2_lite_16b",
    "qwen2_vl_7b",
    "jamba_v0_1_52b",
    "whisper_medium",
    "mamba2_1p3b",
)


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "p")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "p")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.smoke_config()


def supports_shape(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell; (False, reason) when skipped.

    Skip rules (recorded in DESIGN.md §Arch-applicability):
      * long_500k needs sub-quadratic attention — run only for SSM / hybrid /
        local:global archs; skip for pure full-attention LMs.
      * whisper's decoder is bounded by its 1500-frame encoder; decode_32k is
        lowered with a 32k self-attention KV for comparability, but long_500k
        is architecturally meaningless for a 30s-audio enc-dec model.
    """
    if shape.sub_quadratic_required:
        if cfg.family in ("ssm", "hybrid"):
            return True, ""
        if any(k == "l" for k in cfg.attn.pattern) and cfg.attn.window:
            return True, "local:global attention keeps per-step work sub-quadratic-dominated"
        return False, "pure full-attention arch: 500k decode requires sub-quadratic attention"
    if cfg.enc_dec and shape.kind == "train" and shape.seq_len > 8192:
        return False, "whisper enc-dec trains on <=1500-frame windows"
    return True, ""
