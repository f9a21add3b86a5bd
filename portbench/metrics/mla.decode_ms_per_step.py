"""Kernels: the paged MLA decode kernel's device milliseconds in a decode
step, every layer's call (split and combine), from the kernels' profiled
times in the profiled steps.  A kernel event the profiler lost is made up
at the mean of those it kept.  A program without the kernel has nothing
to read."""

SPLIT, COMBINE = "mla_decode_split_kernel", "mla_decode_combine_kernel"


def read(rec):
    prof = rec.profile
    if prof is None or not prof.decode:
        return None
    split = [d for n, _s, d in prof.kernels if SPLIT in n]
    comb = [d for n, _s, d in prof.kernels if COMBINE in n]
    if not split or not comb:
        return None
    per_call = sum(split) / len(split) + sum(comb) / len(comb)
    return per_call * rec.counts.attn_layers(rec.model) / 1e6
