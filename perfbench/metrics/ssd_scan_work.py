"""Bytes and operations of one chunked SSD scan call (its three passes
together), a frozen copy of ``repro_torch.kernels.ssd_scan.work``: X, Adt
(float32), Bc, Cc read once and Y written once; per (b, h, chunk) C.B^T
(2 N) and scores.X (2 P) for each (position, position j <= it) pair of the
chunk, plus C.S^T and the state update (2 Q N P each)."""


def work(B: int, S: int, H: int, P: int, N: int, chunk: int,
         itemsize: int) -> tuple:
    """(bytes, operations) for X (B, S, H, P), Bc and Cc (B, S, N)."""
    nbytes = (2 * B * S * H * P + 2 * B * S * N) * itemsize + B * S * H * 4
    per_chunk = chunk * (chunk + 1) * (N + P) + 4 * chunk * N * P
    return nbytes, B * H * (S // chunk) * per_chunk
