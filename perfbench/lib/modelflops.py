"""The model FLOPs of one optimizer step, frozen here: 6 x the matmul
parameters a token passes through x the step's tokens, plus 3 x the
forward FLOPs of the sequence mixer (causal attention scores and values,
or the SSD scan), as the forward and a backward of twice its cost count
them. For a mixture of experts the nominal top-k experts count and
dropped choices are ignored. Recomputation (remat), the optimizer and the
elementwise work do not count. The output head counts over the padded
vocabulary, which the program multiplies."""
from __future__ import annotations

from perfbench.lib import catalog


def padded_vocab(vocab: int) -> int:
    return (vocab + 255) // 256 * 256


def matmul_params(m: dict) -> int:
    """Parameters of the products one token passes through (the embedding
    lookup is not a product)."""
    d, L = m["d_model"], m["num_layers"]
    head = d * padded_vocab(m["vocab_size"])
    if m["family"] == "ssm":
        di, N = m["ssm_expand"] * d, m["ssm_state"]
        H = di // m["ssm_head_dim"]
        return L * (d * (2 * di + 2 * N + H) + di * d) + head
    H, KV, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    attn = 2 * d * H * hd + 2 * d * KV * hd
    if m["family"] == "moe":
        ffn = d * m["num_experts"] + m["num_experts_per_tok"] * 3 * d * m["d_ff"]
    else:
        ffn = 3 * d * m["d_ff"]
    return L * (attn + ffn) + head


def mixer_flops(m: dict, batch: int, seq: int) -> int:
    """Forward FLOPs of the sequence mixers of all layers on (batch, seq)."""
    if m["family"] == "ssm":
        di = m["ssm_expand"] * m["d_model"]
        P = m["ssm_head_dim"]
        work = catalog.module("metrics", "ssd_scan_work").work
        _, ops = work(batch, seq, di // P, P, m["ssm_state"],
                      min(m["ssm_chunk"], seq), 2)
    else:
        work = catalog.module("metrics", "flash_attention_work").work
        _, ops = work(batch, seq, m["num_heads"], m["num_kv_heads"],
                      m["head_dim"], 2)
    return m["num_layers"] * ops


def step_flops(m: dict, traffic: dict) -> int:
    B, S = traffic["global_batch"], traffic["seq_len"]
    return 6 * matmul_params(m) * B * S + 3 * mixer_flops(m, B, S)
