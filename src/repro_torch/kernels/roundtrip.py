"""One host-card round trip of a device entry.

The decode graph, the prefill graphs and the policy kernel's batches each
run the same way: the host writes the inputs into pinned memory, one
asynchronous copy takes them up, the entry runs, one asynchronous copy
brings the outputs down to pinned memory, and the host waits once.
:class:`RoundTrip` owns those buffers and steps.  On the CPU each pinned
mirror is its device buffer itself and nothing is copied.
"""

from __future__ import annotations

import torch

from ..obs.telemetry import NO_SPAN


class RoundTrip:
    """``dev_in`` / ``dev_out``: the zeroed device buffers an entry reads
    and writes (a graph reads them by address, a kernel's launch arguments
    point at them); ``pin_in`` / ``pin_out``: their pinned host mirrors;
    ``host_in`` / ``host_out``: numpy views of the mirrors.

    ``rt(run, tel)``: :meth:`stage`, ``run()`` (the entry, on the current
    stream), the outputs down in one copy, one wait on the current stream.
    With ``tel`` (a tracing telemetry hub) the copies and the run are its
    device span ``dev <name>``, ended before the wait, and its pending
    device spans are resolved after it."""

    def __init__(self, in_shape, in_dtype, out_shape, out_dtype, device,
                 name: str):
        self.device = torch.device(device)
        self.span = f"dev {name}"
        self.pinned = self.device.type == "cuda"
        self.dev_in = torch.zeros(in_shape, dtype=in_dtype,
                                  device=self.device)
        self.dev_out = torch.zeros(out_shape, dtype=out_dtype,
                                   device=self.device)
        if self.pinned:
            self.pin_in = torch.zeros(in_shape, dtype=in_dtype,
                                      pin_memory=True)
            self.pin_out = torch.zeros(out_shape, dtype=out_dtype,
                                       pin_memory=True)
        else:
            self.pin_in, self.pin_out = self.dev_in, self.dev_out
        self.host_in = self.pin_in.numpy()
        self.host_out = self.pin_out.numpy()

    def stage(self) -> None:
        """The inputs to the card: one copy from pinned memory."""
        if self.pinned:
            self.dev_in.copy_(self.pin_in, non_blocking=True)

    def __call__(self, run, tel=None) -> None:
        with (tel.device_span(self.span, self.device) if tel is not None
              else NO_SPAN):
            self.stage()
            run()
            if self.pinned:             # the outputs down: one copy ...
                self.pin_out.copy_(self.dev_out, non_blocking=True)
        if self.pinned:                 # ... and one wait
            torch.cuda.current_stream(self.device).synchronize()
        if tel is not None:
            tel.resolve_device()
