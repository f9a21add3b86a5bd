"""Kernels: the paged-decode kernel's share of its roofline in the
profiled steps: the byte bound of its calls (K and V of the valid tokens
of the distinct blocks read, a block shared through the prefix cache
once; queries, outputs, heat and table; over the card's HBM rate)
over the profiled time of its two kernels (split and combine).  A kernel
event the profiler lost is made up at the mean of those it kept."""

SPLIT, COMBINE = "paged_split_kernel", "paged_combine_kernel"


def read(rec):
    prof, c = rec.profile, rec.counts
    bw = rec.peak.get("hbm_byte_s")
    if prof is None or not prof.decode or not bw:
        return None
    split = [d for n, _s, d in prof.kernels if SPLIT in n]
    comb = [d for n, _s, d in prof.kernels if COMBINE in n]
    if not split or not comb:
        return None
    calls = len(prof.decode) * c.attn_layers(rec.model)
    t = (sum(split) / len(split) + sum(comb) / len(comb)) * calls / 1e9
    byts = sum(c.paged_bytes(rec.model, d["kv_tokens"], rec.rows,
                             rec.layout["max_blocks"])
               for d in prof.decode) * c.attn_layers(rec.model)
    return 100.0 * byts / bw / t
