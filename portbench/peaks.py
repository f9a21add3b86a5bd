"""Published peaks of the cards the benchmark runs on (dense rates, no
sparsity), by the name ``torch.cuda.get_device_name()`` gives.

NVIDIA H100 SXM5 data sheet: 989 TFLOP/s in bf16 on the tensor cores,
3.35 TB/s of HBM3, 80 GB; rates at the full 700 W power limit.
"""

from __future__ import annotations

H100_SXM = {"bf16_flop_s": 989e12, "hbm_byte_s": 3.35e12}

PEAKS = {
    "NVIDIA H100 80GB HBM3": H100_SXM,
}


def peaks(kind: str) -> dict:
    """The peaks of the card named ``kind``; a card not in the table has
    none, and the metrics that need them read nothing."""
    return PEAKS.get(kind, {})
