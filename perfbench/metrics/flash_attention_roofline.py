"""The attention kernel's share of its roofline (%): the least time the
card could take for one call at the train step's shapes, the larger of
its operations over the bf16 peak and its bytes over the HBM bandwidth
(``flash_attention_work.py``), over the mean device time of the kernels
launched inside the registered op ``repro_torch::flash_attention``. The
kernels are found through the op, whatever their names."""
from perfbench.lib import catalog, peaks

OP = "repro_torch::flash_attention"


def read(run):
    t, m = run.trace, run.model
    if t is None or OP not in t.spans:
        return None
    device_s, calls = t.spans[OP]
    if not calls or device_s <= 0:
        return None
    B = run.traffic["global_batch"] // run.traffic["microbatches"]
    nbytes, ops = catalog.module("metrics", "flash_attention_work").work(
        B, run.traffic["seq_len"], m["num_heads"], m["num_kv_heads"],
        m["head_dim"], run.itemsize)
    bound = max(ops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_S)
    return 100.0 * bound / (device_s / calls)
