"""Kernels: the flash-attention forward's share of its roofline over the
profiled steps' prefill calls: for each call the larger of its operations
over the card's bf16 rate and its bytes over the HBM rate (the padded
queries and keys it is given, causal, a prefix-cache hit's queries at
their offset), summed, over the profiled time of the kernel.  A kernel
event the profiler lost is made up at the mean of those it kept."""

KERNEL = "flash_wgmma_kernel"


def read(rec):
    prof, c = rec.profile, rec.counts
    fl, bw = rec.peak.get("bf16_flop_s"), rec.peak.get("hbm_byte_s")
    if prof is None or not prof.prefill or not fl or not bw:
        return None
    times = [d for n, _s, d in prof.kernels if KERNEL in n]
    if not times:
        return None
    bt = rec.layout["block_tokens"]
    layers = c.attn_layers(rec.model)
    bound = 0.0
    for prompt, prefix in prof.prefill:
        keys = -(-prompt // bt) * bt
        rows = -(-(prompt - prefix) // bt) * bt
        f, b = c.flash_cost(rec.model, rows, keys, prefix)
        bound += max(f / fl, b / bw) * layers
    t = sum(times) / len(times) * len(prof.prefill) * layers / 1e9
    return 100.0 * bound / t
