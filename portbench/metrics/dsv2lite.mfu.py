"""Device: the traced window's model flops over the window times the
card's bf16 peak, in percent, in ``dsv2lite.longdoc``: ``mfu``'s reading,
with that configuration's counts (``portbench/counts/mla_moe.py``: the
decode rows with absorbed latent attention, the prompt tokens each prefill
ran with expanded attention, top-6 and shared experts, no padding and no
unused expert capacity).  The whole step's share."""

from portbench import manifest

read = manifest.reader("mfu")
