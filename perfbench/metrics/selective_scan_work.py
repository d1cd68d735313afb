"""Bytes and operations of one selective-scan call (its three launches
together), a frozen copy of ``repro_torch.kernels.selective_scan.work``:
what the scan itself must move, whatever the kernel keeps for its
backward: u, delta_raw and z read once and y written once (the
activations' dtype), B and C read once, A, D and the delta bias read once
(float32); 7 operations per (step, channel, state) (delta A, its exp
counted as one, the decayed state, delta u B and the sum, C s and the sum
into y) and 11 per (step, channel) (the softplus, delta u, the D skip,
the gate's SiLU and product)."""

STATE_OPS, CHANNEL_OPS = 7, 11


def work(B: int, S: int, Dc: int, N: int, itemsize: int) -> tuple:
    """(bytes, operations) for u, delta_raw, z (B, S, Dc) and B, C (B, S,
    N)."""
    nbytes = (4 * B * S * Dc + 2 * B * S * N) * itemsize \
        + 4 * (Dc * N + 2 * Dc)
    return nbytes, B * S * Dc * (N * STATE_OPS + CHANNEL_OPS)
