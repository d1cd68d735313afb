"""Config system: dataclass model/shape configs + registry.

The port's own copy of ``repro.configs`` (which imports no JAX), kept so
that ``repro_torch`` imports nothing of ``repro``; only the import paths
differ. Every assigned architecture gets a module
``src/repro_torch/configs/<id>.py`` exporting ``CONFIG`` (full production
config) and ``SMOKE`` (reduced config of the same family for CPU smoke
tests). The registry maps ``--arch`` ids to
those modules.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A single config type covering every supported family.

    ``family`` selects the block layout:
      - ``dense``   decoder-only transformer (GQA, optional QKV bias)
      - ``moe``     dense attention + mixture-of-experts FFN
      - ``ssm``     Mamba-2 SSD (attention-free)
      - ``hybrid``  RecurrentGemma: RG-LRU blocks + local attention 1:2
      - ``audio``   Whisper-style encoder-decoder (stub conv frontend)
      - ``vlm``     Llama-vision: self-attn decoder + interleaved cross-attn
                    image layers (stub patch-embed frontend)
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm

    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # --- hybrid (RecurrentGemma) ---
    attn_window: int = 0        # local attention window; 0 -> global
    hybrid_pattern: Tuple[str, ...] = ()  # e.g. ("rglru","rglru","attn")
    rglru_width: int = 0        # recurrent width (0 -> d_model)

    # --- encoder-decoder (audio) ---
    encoder_layers: int = 0
    encoder_seq: int = 0        # stub frontend frame count

    # --- vlm ---
    cross_attn_every: int = 0   # insert a cross-attn layer after every N self layers
    num_patches: int = 0        # stub patch-embed token count

    # --- numerics / training ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    # "full": recompute the whole layer in backward (min memory, +1 fwd of
    # recompute). "dots": save matmul outputs, recompute elementwise only
    # (jax.checkpoint dots_with_no_batch_dims_saveable) — fewer recompute
    # FLOPs and less recompute HBM traffic for more stash memory.
    remat_policy: str = "full"
    # Megatron-style sequence parallelism: residual stream + norms sharded
    # over the model axis along seq; all-gather before attention/MLP,
    # reduce-scatter after. Same collective bytes as the plain TP
    # all-reduce, but the per-token chain (norms, residual adds, RoPE)
    # touches 1/model_parallel of the bytes.
    seq_parallel: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """True if long-context decode (500k) is feasible for this family."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs decode (whisper via its decoder)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, dff, v = self.d_model, self.d_ff, self.vocab_size
        nh, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        if self.family in ("dense", "moe", "vlm"):
            attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
            if self.qkv_bias:
                attn += (nh + 2 * nkv) * hd
            if self.family == "moe":
                ffn = self.num_experts * 3 * d * dff + d * self.num_experts
            else:
                ffn = 3 * d * dff
            per_layer = attn + ffn + 2 * d
            total += self.num_layers * per_layer
            if self.family == "vlm" and self.cross_attn_every:
                n_cross = self.num_layers // self.cross_attn_every
                cross = d * nh * hd + 2 * d * nkv * hd + nh * hd * d + 3 * d * dff + 2 * d
                total += n_cross * cross
        elif self.family == "ssm":
            di, ns = self.d_inner, self.ssm_state
            per_layer = (
                d * (2 * di + 2 * ns + self.ssm_heads)  # in_proj(x,z) + B,C + dt
                + self.ssm_conv_width * (di + 2 * ns)
                + self.ssm_heads * 2                    # A_log, D
                + di * d + d                            # out_proj + norm
            )
            total += self.num_layers * per_layer
        elif self.family == "hybrid":
            w = self.rglru_width or self.d_model
            rec = d * 3 * w + 2 * w + w * d + 3 * d * dff + 2 * d
            attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d + 3 * d * dff + 2 * d
            pat = self.hybrid_pattern or ("rglru", "rglru", "attn")
            n_attn = sum(1 for i in range(self.num_layers) if pat[i % len(pat)] == "attn")
            total += n_attn * attn + (self.num_layers - n_attn) * rec
        elif self.family == "audio":
            attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
            enc_layer = attn + 2 * d * dff + d * dff + 2 * d  # self + mlp(gelu->2 mats? use 3)
            dec_layer = 2 * attn + 3 * d * dff + 3 * d
            total += self.encoder_layers * enc_layer + self.num_layers * dec_layer
        return total


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


ARCH_IDS = (
    "qwen1_5_110b",
    "codeqwen1_5_7b",
    "llama3_2_1b",
    "granite_3_2b",
    "mamba2_130m",
    "recurrentgemma_2b",
    "dbrx_132b",
    "grok_1_314b",
    "whisper_tiny",
    "llama3_2_vision_90b",
)

# Dashes as they appear in the assignment, mapped to module names.
_ALIASES = {
    "qwen1.5-110b": "qwen1_5_110b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "llama3.2-1b": "llama3_2_1b",
    "granite-3-2b": "granite_3_2b",
    "mamba2-130m": "mamba2_130m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "dbrx-132b": "dbrx_132b",
    "grok-1-314b": "grok_1_314b",
    "whisper-tiny": "whisper_tiny",
    "llama-3.2-vision-90b": "llama3_2_vision_90b",
}


def canonical_arch(arch: str) -> str:
    arch = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    return arch


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical_arch(arch)}")
    return mod.SMOKE if smoke else mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells. ``long_500k`` only for sub-quadratic
    families unless include_skipped."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            skipped = shape.name == "long_500k" and not cfg.subquadratic
            if skipped and not include_skipped:
                continue
            out.append((arch, shape.name))
    return out
