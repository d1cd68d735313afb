"""Mamba2-130M [ssm]: 24L d_model=768 attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    head_dim=64,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-130m-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=256,
    head_dim=16,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_conv_width=4,
    ssm_chunk=32,
    tie_embeddings=True,
)
