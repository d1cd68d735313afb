"""AI21-Jamba2-3B [jamba]: 28L d_model=2560, 26 Mamba-1 layers (d_state 16,
expand 2 so d_inner 5120, dt rank 160, conv 4 with bias, the dt, B and C
norms, no projection bias) and 2 attention layers (20H over 1 kv head of
128, no positional embedding) at 7 and 21 (attn_layer_period 14, offset 7);
every layer's FFN a SwiGLU MLP of 8192 (num_experts 1); vocab=65536, tied;
rms eps 1e-6. [hf:ai21labs/AI21-Jamba2-3B config.json]"""
from repro_torch.configs.base import ModelConfig

PATTERN = ("mamba1",) * 7 + ("attention",) + ("mamba1",) * 6

CONFIG = ModelConfig(
    name="jamba2-3b",
    family="jamba",
    num_layers=28,
    d_model=2560,
    num_heads=20,
    num_kv_heads=1,
    d_ff=8192,
    vocab_size=65536,
    head_dim=128,
    tie_embeddings=True,
    norm_eps=1e-6,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_dt_rank=160,
    hybrid_pattern=PATTERN,
    use_rope=False,
)

# 4 layers (attention at index 2); d_inner 128, dt rank 8
SMOKE = ModelConfig(
    name="jamba2-3b-smoke",
    family="jamba",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    d_ff=96,
    vocab_size=256,
    head_dim=16,
    tie_embeddings=True,
    norm_eps=1e-6,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_dt_rank=8,
    hybrid_pattern=("mamba1", "mamba1", "attention", "mamba1"),
    use_rope=False,
)
