"""DBRX-132B [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, MoE 16 experts top-4 (fine-grained). [hf:databricks/dbrx-base;
unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    num_experts_per_tok=4,
    rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="dbrx-132b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    num_experts=4,
    num_experts_per_tok=2,
)
