"""The engine's compiled decode entry: one CUDA graph per engine.

The counterpart of the reference's ``self._decode =
jax.jit(_decode_entry)`` (``repro/serving/engine.py``), which runs a decode
step as one executable.  Here the step (:func:`decode_entry`: embedding,
every layer with its KV append and paged-attention kernel, the final norm
and the float32 logits) is captured once into a CUDA graph when the engine
is built and replayed every decode step.

What the graph reads by address lives as long as the engine: the params,
the cache's pools and per-slot state, the persistent ``[B, MB]`` block
table (its dirty rows are installed in place before each replay), and one
static ``[3, B]`` int32 input buffer whose rows are the tokens, the
lengths and the active flags (0/1), filled by one copy from pinned host
memory.  ``B`` is the engine's ``max_batch`` and ``MB`` the layout's
``max_blocks``, so one graph serves every step.  The logits ``[B, V_pad]``
and the heat ``[B, MB]`` land side by side in one static float32 buffer,
which comes back to pinned host memory in one copy and one sync.

Capture: a first eager call on a side stream builds what the step keeps
between calls (the RoPE and sinusoid tables out to the layout's length,
the rounded constants, M-RoPE's channel index, the kernels' libraries and
launch attributes); two more eager calls run under
``torch.cuda.set_sync_debug_mode("error")`` and :class:`HostSyncGuard`,
so an op that syncs with the host fails there and is named; then the
capture, into the graph's private memory pool.  A failed capture raises,
naming the last op dispatched; nothing falls back to eager calls.  The
warm-up calls run with every row inactive, which writes no KV; the
per-slot state they advance (mamba's) is put back.

A replay calls no kernel wrapper, so the wrappers' launch counts
(``paged_decode_attention.launches`` and the others) would stop: the
capture records how much each count grew while the step was captured and
each replay adds that again.

On the CPU the same object calls :func:`decode_entry` eagerly on the same
buffers: the code the CPU tests hold to the reference.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..models import common
from ..models.decode import PagedLayout, decode_step

Pytree = Any
aten = torch.ops.aten

# ops that wait for the device or read device memory on the host
_SYNCING = {aten.nonzero, aten._local_scalar_dense, aten.masked_select,
            aten._unique, aten._unique2, aten.unique_dim,
            aten.unique_consecutive, aten.unique_dim_consecutive,
            aten.bincount, aten.equal, aten.is_nonzero}
# a tensor made from host data (torch.tensor, torch.from_numpy): a copy
# from pageable host memory once it moves to the card
_HOST_DATA = {aten.lift_fresh, aten.lift_fresh_copy}
_INDEXING = {aten.index, aten.index_put, aten.index_put_,
             aten._index_put_impl_}


def _host_sync_reason(func, args, kwargs) -> str | None:
    """Why ``func(*args, **kwargs)`` would sync with the host on the card
    (None when it would not)."""
    op = func.overloadpacket
    if op in _SYNCING:
        return "waits for the device"
    if op in _HOST_DATA:
        return "makes a tensor from host data (a pageable copy to the card)"
    if op in _INDEXING and len(args) > 1:
        idx = args[1] if isinstance(args[1], (list, tuple)) else ()
        if any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool,
                                                           torch.uint8)
               for i in idx):
            return "indexes with a mask (a nonzero inside)"
    if op is aten.repeat_interleave and func is not \
            aten.repeat_interleave.self_int and \
            kwargs.get("output_size") is None:
        return "repeats by a tensor without output_size"
    if op in (aten._to_copy, aten.copy_):
        src = args[1] if op is aten.copy_ else args[0]
        dst = args[0].device if op is aten.copy_ \
            else torch.device(kwargs.get("device") or src.device)
        if isinstance(src, torch.Tensor) and src.device.type != dst.type:
            return f"copies {src.device.type} -> {dst.type}"
    return None


class HostSyncGuard(TorchDispatchMode):
    """Fails on every op that syncs with the host (see
    :func:`_host_sync_reason`), naming it; remembers the last op
    dispatched (``last``), which names the op where a capture fails."""

    def __init__(self):
        super().__init__()
        self.last = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.last = func
        why = _host_sync_reason(func, args, kwargs)
        if why is not None:
            raise RuntimeError(f"{func} {why}: the decode step must not "
                               f"sync with the host")
        return func(*args, **kwargs)


def decode_entry(params: Pytree, cfg, cache: Pytree, table: torch.Tensor,
                 layout: PagedLayout, tokens: torch.Tensor,
                 lengths: torch.Tensor, active: torch.Tensor):
    """One decode step of the gather path: ``decode_step`` with M-RoPE's
    three position streams all ``lengths`` (as the reference's engine
    feeds them).  Returns (logits [B, V_pad] f32, heat [B, MB] f32)."""
    B = tokens.shape[0]
    pos3d = lengths[None, :, None].expand(3, B, 1) \
        if cfg.vlm_patches else None
    logits, _, heat = decode_step(params, cfg, cache, tokens, lengths, table,
                                  layout, active=active, pos3d=pos3d)
    return logits, heat


def _launch_counters() -> list:
    """(wrapper, attribute) of every kernel wrapper's launch count."""
    from ..kernels.block_copy import ops as bc
    from ..kernels.flash_attention import ops as fa
    from ..kernels.paged_attention import ops as pa
    from ..kernels.policy_exec import ops as pe
    seen: dict = {}
    for mod in (bc, fa, pa, pe):
        for fn in vars(mod).values():
            for name, v in getattr(fn, "__dict__", {}).items():
                if name.endswith("launches") and isinstance(v, int):
                    seen[(id(fn), name)] = (fn, name)
    return list(seen.values())


def _slot_state(cache: Pytree) -> list[torch.Tensor]:
    """The per-slot leaves a decode step writes (mamba's state), as
    :func:`~repro_torch.models.decode.pool_leaves` walks the cache."""
    out = []
    for key, seg in cache.items():
        for mem in (seg.values() if key.startswith("s") else [seg]):
            out.extend(leaf for name, leaf in mem.items()
                       if name in ("ssm", "conv"))
    return out


class DecodeGraph:
    """One engine's decode entry (see the module's docstring).

    ``graph(tokens, lengths, active)`` with host arrays of ``B`` rows
    returns (logits [B, V_pad], heat [B, MB]) as float32 numpy views of a
    pinned buffer, valid until the next call; ``calls`` counts them (the
    engine's decode steps).  Attributes after a capture: ``graph`` (the
    ``torch.cuda.CUDAGraph``; None on the CPU), ``capture_s`` (warm-up and
    capture, seconds), ``pool_bytes`` (the memory the capture reserved),
    ``per_replay`` ({(wrapper, count): n} added to the counts each
    replay)."""

    def __init__(self, cfg, params: Pytree, cache: Pytree,
                 table: torch.Tensor, layout: PagedLayout):
        self.cfg, self.params, self.cache = cfg, params, cache
        self.table, self.layout = table, layout
        B, MB = table.shape
        dev = table.device
        self.device = dev
        on_card = dev.type == "cuda"
        V = (params["embed"].shape[0] if cfg.tie_embeddings
             else params["lm_head"].shape[1])
        self.vocab_cols = V
        self.io = torch.zeros((3, B), dtype=torch.int32, device=dev)
        self.host = (torch.zeros((3, B), dtype=torch.int32, pin_memory=True)
                     if on_card else self.io)
        self.out = torch.zeros((B, V + MB), dtype=torch.float32, device=dev)
        self.out_host = (torch.zeros((B, V + MB), dtype=torch.float32,
                                     pin_memory=True)
                         if on_card else self.out)
        self._host_np = self.host.numpy()
        self._out_np = self.out_host.numpy()
        self.graph = None
        self.calls = 0
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.per_replay: dict = {}
        self._held: list = []
        if on_card:
            self._capture()

    def _entry(self):
        io = self.io
        return decode_entry(self.params, self.cfg, self.cache, self.table,
                            self.layout, io[0], io[1], io[2] != 0)

    def _write_out(self) -> None:
        logits, heat = self._entry()
        self.out[:, :self.vocab_cols].copy_(logits)
        self.out[:, self.vocab_cols:].copy_(heat)

    def _capture(self) -> None:
        t0 = time.perf_counter()
        dev = self.device
        self.io.zero_()                         # every row inactive
        state = [(leaf, leaf.clone()) for leaf in _slot_state(self.cache)]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        guard = HostSyncGuard()
        mode = torch.cuda.get_sync_debug_mode()
        try:
            with torch.cuda.stream(side):
                self._write_out()               # builds the kept tables
                torch.cuda.set_sync_debug_mode("error")
                with guard:
                    for _ in range(2):
                        self._write_out()
        except RuntimeError as e:
            raise RuntimeError(f"the decode step syncs with the host at "
                               f"{guard.last}: {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream(dev).wait_stream(side)
        for leaf, saved in state:
            leaf.copy_(saved)
        # tables a later, longer call may replace in their caches: the
        # graph reads these by address
        self._held = [*common._ROPE_TABLES.values(),
                      *common._SINUSOID_TABLES.values()]
        counters = _launch_counters()
        before = [getattr(fn, name) for fn, name in counters]
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        guard = HostSyncGuard()
        try:
            with torch.cuda.graph(graph):
                with guard:
                    self._write_out()
        except RuntimeError as e:
            raise RuntimeError(f"capturing the decode step failed at "
                               f"{guard.last}: {e}") from e
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        for (fn, name), n0 in zip(counters, before):
            if getattr(fn, name) != n0:
                self.per_replay[(fn, name)] = getattr(fn, name) - n0
                setattr(fn, name, n0)           # the capture launched none
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def __call__(self, tokens: np.ndarray, lengths: np.ndarray,
                 active: np.ndarray):
        h = self._host_np
        h[0], h[1], h[2] = tokens, lengths, active
        self.calls += 1
        self._stage()
        self._run()
        self._fetch()
        return self._out_np[:, :self.vocab_cols], \
            self._out_np[:, self.vocab_cols:]

    def _stage(self) -> None:
        """The inputs to the card: one copy from pinned memory."""
        if self.host is not self.io:
            self.io.copy_(self.host, non_blocking=True)

    def _run(self) -> None:
        """The step: a replay on the card, an eager call on the CPU."""
        if self.graph is None:
            self._write_out()
            return
        self.graph.replay()
        for (fn, name), n in self.per_replay.items():
            setattr(fn, name, getattr(fn, name) + n)

    def _fetch(self) -> None:
        """Logits and heat to pinned host memory: one copy, one sync."""
        if self.out_host is not self.out:
            self.out_host.copy_(self.out, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
