"""Granite-4.0-H-Small [hybrid_moe]: 40L d_model=4096, 36 Mamba-2 layers
(128 heads of 64, d_state 128, expand 2, chunk 256) and 4 NoPE attention
layers (32H, GQA kv=8, head dim 128, scores times 1/128) at 5, 15, 25, 35;
every layer's FFN 72 SwiGLU experts of 768 top-10 beside a shared SwiGLU
expert of 1536; embedding x12, each branch x0.22, logits /16; vocab=100352,
tied. [hf:ibm-granite/granite-4.0-h-small config.json]"""
from repro_torch.configs.base import ModelConfig

PATTERN = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    family="hybrid_moe",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=768,
    vocab_size=100352,
    head_dim=128,
    tie_embeddings=True,
    norm_eps=1e-5,
    num_experts=72,
    router_experts=72,
    num_experts_per_tok=10,
    shared_d_ff=1536,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=256,
    hybrid_pattern=PATTERN,
    use_rope=False,
    attn_scale=0.0078125,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
)

# 4 layers (attention at index 2), 8 experts of which this device holds 2
SMOKE = ModelConfig(
    name="granite-4.0-h-small-smoke",
    family="hybrid_moe",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=32,
    vocab_size=256,
    head_dim=16,
    tie_embeddings=True,
    num_experts=2,
    router_experts=8,
    num_experts_per_tok=3,
    shared_d_ff=48,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_conv_width=4,
    ssm_chunk=32,
    hybrid_pattern=("mamba", "mamba", "attention", "mamba"),
    use_rope=False,
    attn_scale=0.0625,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
)
