"""Engine loop: the 95th percentile, in milliseconds, of the program's
``queue rid=N`` spans in the window — a request's wait from its submit
(or its requeue after a preemption) to the start of its prefill,
behind the prefills admitted before it in the same step included."""

import numpy as np


def read(rec):
    waits = [d for name, d in rec.spans if name.startswith("queue rid=")]
    if not waits:
        return None
    return float(np.percentile(np.asarray(waits, np.float64), 95)) / 1e6
