"""The model FLOPs of one optimizer step of the ``hybrid_moe`` family
(Granite-4.0-H), frozen here: 6 x the matmul parameters a token passes
through x the step's tokens, plus 3 x the forward FLOPs of the sequence
mixers (the SSD scan of each Mamba layer, causal attention's scores and
values in each attention layer), as the forward and a backward of twice
its cost count them.

The matmul parameters are each Mamba layer's projections (x, z, B, C, dt
in and the output), each attention layer's q, k, v and output, every
layer's router and shared expert, the routed experts a token reaches on
this device (k x held / router experts of them: the choices that fall on
held experts; dropped choices ignored), and the head over the padded
vocabulary. Recomputation (remat), the convolution, the norms, the
optimizer and the elementwise work do not count."""
from __future__ import annotations

from perfbench.lib import catalog
from perfbench.lib.modelflops import padded_vocab


def kinds(m: dict) -> list:
    pat = m["hybrid_pattern"]
    return [pat[i % len(pat)] for i in range(m["num_layers"])]


def matmul_params(m: dict) -> float:
    """Parameters of the products one token passes through (the routed
    experts' share may be a fraction)."""
    d = m["d_model"]
    di, N = m["ssm_expand"] * d, m["ssm_state"]
    Hs = di // m["ssm_head_dim"]
    H, KV, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    E = m.get("router_experts") or m["num_experts"]
    mamba = d * (2 * di + 2 * N + Hs) + di * d
    attn = 2 * d * H * hd + 2 * d * KV * hd
    routed = m["num_experts_per_tok"] * m["num_experts"] * 3 * d * m["d_ff"]
    ffn = d * E + 3 * d * m["shared_d_ff"] + routed / E
    layers = kinds(m)
    n_attn = layers.count("attention")
    return (n_attn * attn + (len(layers) - n_attn) * mamba
            + len(layers) * ffn + d * padded_vocab(m["vocab_size"]))


def mixer_flops(m: dict, batch: int, seq: int) -> int:
    """Forward FLOPs of the sequence mixers of all layers on (batch, seq)."""
    di = m["ssm_expand"] * m["d_model"]
    P = m["ssm_head_dim"]
    ssd = catalog.module("metrics", "ssd_scan_work").work
    flash = catalog.module("metrics", "flash_attention_work").work
    _, ssd_ops = ssd(batch, seq, di // P, P, m["ssm_state"],
                     min(m["ssm_chunk"], seq), 2)
    _, att_ops = flash(batch, seq, m["num_heads"], m["num_kv_heads"],
                       m["head_dim"], 2)
    layers = kinds(m)
    n_attn = layers.count("attention")
    return n_attn * att_ops + (len(layers) - n_attn) * ssd_ops


def step_flops(m: dict, traffic: dict) -> float:
    B, S = traffic["global_batch"], traffic["seq_len"]
    return 6 * matmul_params(m) * B * S + 3 * mixer_flops(m, B, S)
