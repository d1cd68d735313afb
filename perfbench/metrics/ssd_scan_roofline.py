"""The SSD scan kernel's share of its roofline (%): the least time the
card could take for one call at the train step's shapes, the larger of
its operations over the bf16 peak and its bytes over the HBM bandwidth
(``ssd_scan_work.py``), over the mean device time of the kernels (its
three passes) launched inside the registered op ``repro_torch::ssd_scan``."""
from perfbench.lib import catalog, peaks

OP = "repro_torch::ssd_scan"


def read(run):
    t, m = run.trace, run.model
    if t is None or OP not in t.spans:
        return None
    device_s, calls = t.spans[OP]
    if not calls or device_s <= 0:
        return None
    B = run.traffic["global_batch"] // run.traffic["microbatches"]
    S = run.traffic["seq_len"]
    di = m["ssm_expand"] * m["d_model"]
    P = m["ssm_head_dim"]
    nbytes, ops = catalog.module("metrics", "ssd_scan_work").work(
        B, S, di // P, P, m["ssm_state"], min(m["ssm_chunk"], S),
        run.itemsize)
    bound = max(ops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_S)
    return 100.0 * bound / (device_s / calls)
