"""Llama-3.2-Vision-90B [vlm]: 100L (80 self + 20 cross-attn image layers,
one cross after every 4 self) d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256; patch-embed frontend STUB. [hf:meta-llama/Llama-3.2-11B-Vision;
unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=80,           # self-attn layers; + 80//4 = 20 cross layers = 100L
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=4,
    num_patches=1024,
    rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama-3.2-vision-90b-smoke",
    family="vlm",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    cross_attn_every=2,
    num_patches=16,
)
