"""Device: the traced window's model flops over the window times the
card's bf16 peak, in percent.  Model flops count useful work only: the
decode rows and the prompt tokens each prefill ran (the benchmark's own
counts, ``portbench/counts``), top-k and shared experts for a MoE, no
padding and no unused expert capacity."""


def read(rec):
    peak, c, m = rec.peak.get("bf16_flop_s"), rec.counts, rec.model
    if not peak or rec.window_s <= 0 or not rec.decode:
        return None
    flops = sum(c.decode_flops(m, d["contexts"]) for d in rec.decode)
    flops += sum(c.prefill_flops(m, p["prompt"] - p["prefix"], p["prefix"])
                 for p in rec.prefill)
    return 100.0 * flops / (rec.window_s * peak)
