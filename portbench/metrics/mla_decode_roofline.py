"""Kernels: the paged MLA decode kernel's share of its roofline in the
profiled steps: the byte bound of its calls (the latents of the valid
tokens of the distinct blocks read, a block shared through the prefix
cache once; the queries, outputs, heat and table; over the card's HBM
rate) over the profiled time of its two kernels (split and combine).  A
kernel event the profiler lost is made up at the mean of those it kept.
A program without the kernel (its decode gathers the latents in torch
ops) has nothing to read."""

SPLIT, COMBINE = "mla_decode_split_kernel", "mla_decode_combine_kernel"


def read(rec):
    prof, c = rec.profile, rec.counts
    bw = rec.peak.get("hbm_byte_s")
    if prof is None or not prof.decode or not bw:
        return None
    split = [d for n, _s, d in prof.kernels if SPLIT in n]
    comb = [d for n, _s, d in prof.kernels if COMBINE in n]
    if not split or not comb:
        return None
    layers = c.attn_layers(rec.model)
    t = (sum(split) / len(split) + sum(comb) / len(comb)) \
        * len(prof.decode) * layers / 1e9
    byts = sum(c.mla_bytes(rec.model, d["kv_tokens"], rec.rows,
                           rec.layout["max_blocks"])
               for d in prof.decode) * layers
    return 100.0 * byts / bw / t
