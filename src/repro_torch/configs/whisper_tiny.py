"""Whisper-tiny [audio]: enc-dec, 4L each, d_model=384 6H (kv=6) d_ff=1536
vocab=51865, conv frontend STUB (input_specs provides precomputed frame
embeddings). [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    encoder_layers=4,
    encoder_seq=1500,
)

SMOKE = ModelConfig(
    name="whisper-tiny-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=2,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    encoder_layers=2,
    encoder_seq=32,
)
