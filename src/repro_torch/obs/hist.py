"""Log2-bucketed histograms, bpftool-profile style.

Bucket ``k`` holds values whose bit length is ``k`` — i.e. bucket 0 is
``v <= 0``, bucket 1 is ``v == 1``, bucket k is ``2^(k-1) <= v < 2^k``
(clamped at 63).  That is exactly the layout ``bpftool prog profile`` and
the classic bcc latency tools print, and it makes observation O(1) with no
preset range.
"""

from __future__ import annotations

import numpy as np

NUM_BUCKETS = 64


class Log2Hist:
    __slots__ = ("counts", "count", "total")

    def __init__(self) -> None:
        self.counts = np.zeros(NUM_BUCKETS, np.int64)
        self.count = 0       # observations
        self.total = 0       # sum of observed values

    @staticmethod
    def bucket(v: int) -> int:
        if v <= 0:
            return 0
        return min(int(v).bit_length(), NUM_BUCKETS - 1)

    @staticmethod
    def bucket_hi(k: int) -> int:
        """Inclusive upper bound of bucket ``k`` (0 for the <=0 bucket)."""
        return 0 if k == 0 else (1 << k) - 1

    def observe(self, v: int, n: int = 1) -> None:
        """``n`` observations of the value ``v``."""
        self.counts[self.bucket(v)] += n
        self.count += n
        self.total += int(v) * n

    def observe_many(self, values) -> None:
        values = np.asarray(values, np.int64)
        if values.size == 0:
            return
        pos = np.maximum(values, 1)
        idx = np.minimum(np.floor(np.log2(pos)).astype(np.int64) + 1,
                         NUM_BUCKETS - 1)
        idx = np.where(values <= 0, 0, idx)
        np.add.at(self.counts, idx, 1)
        self.count += int(values.size)
        self.total += int(values.sum())

    def percentile(self, p: float) -> int:
        """Upper bound of the bucket holding the p-th percentile (the
        resolution a log2 histogram offers — same convention bpftool uses
        when summarizing)."""
        if self.count == 0:
            return 0
        target = max(1, int(np.ceil(self.count * p / 100.0)))
        cum = 0
        for k in range(NUM_BUCKETS):
            cum += int(self.counts[k])
            if cum >= target:
                return self.bucket_hi(k)
        return self.bucket_hi(NUM_BUCKETS - 1)

    def snapshot(self) -> dict:
        """Stable export shape: count/sum/percentiles + sparse buckets."""
        return {
            "count": int(self.count),
            "sum": int(self.total),
            "p50": self.percentile(50),
            "p99": self.percentile(99),
            "buckets": {str(k): int(c) for k, c in enumerate(self.counts)
                        if c},
        }
