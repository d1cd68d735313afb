"""Bytes and operations of one causal attention call, a frozen copy of
``repro_torch.kernels.flash_attention.work``: q, k, v read once and the
output written once; 4 D operations for each (query, key <= query) pair
of a head (q.k and p.v)."""


def work(B: int, S: int, H: int, KV: int, D: int, itemsize: int) -> tuple:
    """(bytes, operations) for q (B, S, H, D) and k, v (B, S, KV, D)."""
    nbytes = (2 * B * S * H * D + 2 * B * S * KV * D) * itemsize
    return nbytes, 4 * D * B * H * S * (S + 1) // 2
