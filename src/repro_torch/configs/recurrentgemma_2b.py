"""RecurrentGemma-2B [hybrid]: 26L d_model=2560 10H (GQA kv=1, MQA)
d_ff=7680 vocab=256000 — RG-LRU + local attention, pattern 1 attn : 2 rglru,
window 2048. [arXiv:2402.19427; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    attn_window=2048,
    hybrid_pattern=("rglru", "rglru", "attn"),
    rglru_width=2560,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke",
    family="hybrid",
    num_layers=3,
    d_model=64,
    num_heads=2,
    num_kv_heads=1,
    d_ff=128,
    vocab_size=256,
    head_dim=32,
    attn_window=16,
    hybrid_pattern=("rglru", "rglru", "attn"),
    rglru_width=64,
    tie_embeddings=True,
)
