"""The selective-scan kernel's share of its roofline (%): the least time
the card could take for one call at the train step's shapes, the larger of
its float32 operations over the float32 peak and its bytes over the HBM
bandwidth (``selective_scan_work.py``), over the mean device time of the
kernels (its three launches) under the registered op
``repro_torch::selective_scan``. None where the run has no such op."""
from perfbench.lib import catalog, peaks

OP = "repro_torch::selective_scan"


def read(run):
    t, m = run.trace, run.model
    if t is None or OP not in t.spans:
        return None
    device_s, calls = t.spans[OP]
    if not calls or device_s <= 0:
        return None
    B = run.traffic["global_batch"] // run.traffic["microbatches"]
    nbytes, ops = catalog.module("metrics", "selective_scan_work").work(
        B, run.traffic["seq_len"], m["ssm_expand"] * m["d_model"],
        m["ssm_state"], run.itemsize)
    bound = max(ops / peaks.FP32_FLOPS, nbytes / peaks.HBM_BYTES_S)
    return 100.0 * bound / (device_s / calls)
