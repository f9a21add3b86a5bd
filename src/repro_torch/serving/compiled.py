"""The engine's compiled step entries: CUDA graphs.

The counterparts of the reference's ``jax.jit`` entries
(``repro/serving/engine.py``): ``_decode_entry``, compiled once, and
``_prefill_entry`` / ``_prefill_sfx_entry``, which XLA compiles once per
padded prompt shape (``key_blocks`` is static in the suffix entry).  Here:

* :class:`DecodeGraph`: the decode step (:func:`decode_entry`: embedding,
  every layer with its KV append and paged-attention kernel, the final norm
  and the float32 logits), captured once into a CUDA graph when the engine
  is built and replayed every decode step;
* :class:`PrefillGraphs`: one admission's prefill, captured lazily the
  first time a shape is seen, as XLA compiles lazily per shape: one graph
  per padded block count ``nb`` for the full prefill
  (:func:`prefill_entry`), one per ``(suffix blocks, key_blocks)`` for the
  prefix-cache suffix prefill (:func:`prefill_suffix_entry`, whose prefix
  length the flash kernel reads from device memory).

What a graph reads by address lives as long as the engine: the params,
the cache's pools and per-slot state, and each entry's static input and
output buffers.  Decode: the persistent ``[B, MB]`` block table (its dirty
rows are installed in place before each replay) and one static ``[3, B]``
int32 input buffer whose rows are the tokens, the lengths and the active
flags (0/1), filled by one copy from pinned host memory; ``B`` is the
engine's ``max_batch`` and ``MB`` the layout's ``max_blocks``, so one graph
serves every step.  The logits ``[B, V_pad]`` and the heat ``[B, MB]`` land
side by side in one static float32 buffer, which comes back to pinned host
memory in one copy and one sync.  Prefill: one static int32 input buffer
(the last real token's index, the slot, the prefix length, then the padded
tokens), filled by one copy from pinned host memory; a static ``[1, MB]``
table row, which the engine's table fills by a device-to-device copy
before each replay (a view of the slot's row would bake one slot into the
graph); static ``[1, ...]`` buffers for the per-slot state (mamba's, and
Whisper's cross-attention K/V), written into the slot with ``index_copy_``
on the slot's index tensor; the logits ``[1, V_pad]`` float32, back to
pinned host memory in one copy and one sync.  Each entry's inputs and
outputs and its round trip through them are a
:class:`~repro_torch.kernels.roundtrip.RoundTrip`, as the policy kernel's
batches' are.

Capture (:func:`capture_graph`, shared by every entry): a first eager call
on a side stream builds what the step keeps between calls (the RoPE and
sinusoid tables, the rounded constants, M-RoPE's channel index, the
kernels' libraries and launch attributes, the modality inputs); two more
eager calls run under ``torch.cuda.set_sync_debug_mode("error")`` and
:class:`HostSyncGuard`, so an op that syncs with the host fails there and
is named; then the capture (the decode graph into a memory pool of its own,
an engine's prefill graphs into one pool they share).  A failed capture
raises, naming the last op
dispatched; nothing falls back to eager calls.  The warm-up calls change
nothing: decode's run with every row inactive and prefill's with an all
``-1`` table row, so every KV write drops, and the per-slot state they
write is put back.

A replay calls no kernel wrapper, so the wrappers' launch counts
(``paged_decode_attention.launches``, ``flash_attention.launches``, the LM
head's ``head_logits.launches`` and the others) would stop: the capture
records how much each count grew while the step was captured and each
replay adds that again.  The capture itself, its eager warm-up calls
included, is set-up and leaves the counts as it found them, so a serving
run's counts are its replays' (a prefill graph captured at a run's first
admission of a shape included).

On the CPU the same objects call the entry functions eagerly on the same
buffers: the code the CPU tests hold to the reference.

With a tracing telemetry hub (``telemetry=``, ``trace_enabled``) each call
records its device work as a device span (``dev decode``, ``dev
prefill``: from before the input copy to after the output copy, the
synchronise after it) and resolves the hub's pending device spans after
that synchronise; a capture records ``setup`` spans: ``capture``, with
``capture-warm`` (the eager warm-up calls, up to the synchronise after
them) and ``capture-graph`` (the capture) inside it; between the two, the
collection and ``empty_cache``.
"""

from __future__ import annotations

import gc
import time
from typing import Any

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels.roundtrip import RoundTrip
from ..models import common, moe
from ..models.decode import (SLOT_KEYS, PagedLayout, decode_step,
                             prefill_step, prefill_suffix_step)
from ..obs.telemetry import NO_SPAN

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
    :func:`_host_sync_reason`), naming it and ``what`` runs (the entry
    being captured); remembers the last op dispatched (``last``), which
    names the op where a capture fails."""

    def __init__(self, what: str = "a captured step"):
        super().__init__()
        self.what = what
        self.last = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.last = func
        why = _host_sync_reason(func, args, kwargs)
        if why is not None:
            raise RuntimeError(f"{func} {why}: {self.what} must not sync "
                               f"with the host")
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
    """(wrapper, attribute) of every kernel wrapper's launch count, of the
    LM head's card route (``common.head_logits.launches``) and of the
    expert layer's row counts (``moe.moe_apply.routed_rows`` /
    ``computed_rows``)."""
    from ..kernels.block_copy import ops as bc
    from ..kernels.flash_attention import ops as fa
    from ..kernels.mla_decode import ops as ma
    from ..kernels.paged_attention import ops as pa
    from ..kernels.policy_exec import ops as pe
    seen: dict = {}
    for mod in (bc, fa, ma, pa, pe, common, moe):
        for fn in vars(mod).values():
            for name, v in getattr(fn, "__dict__", {}).items():
                if name.endswith(("launches", "_rows")) and \
                        isinstance(v, int):
                    seen[(id(fn), name)] = (fn, name)
    return list(seen.values())


def _slot_state(cache: Pytree, names=("ssm", "conv")) -> list[torch.Tensor]:
    """The per-slot leaves of ``cache`` named ``names`` (by default the
    ones a decode step writes: mamba's state), as
    :func:`~repro_torch.models.decode.pool_leaves` walks the cache."""
    out = []
    for key, seg in cache.items():
        for mem in (seg.values() if key.startswith("s") else [seg]):
            out.extend(leaf for name, leaf in mem.items() if name in names)
    return out


class Captured:
    """One captured entry: ``graph`` (a ``torch.cuda.CUDAGraph``),
    ``per_replay`` ({(wrapper, count): n} added to the launch counts each
    replay), ``pool_bytes`` (the memory the capture reserved),
    ``capture_s`` (warm-up and capture, seconds), ``calls`` (replays).
    With an enabled ``telemetry`` each replay also adds its counts to the
    hub's counters, as ``"<wrapper>.<count>"`` (``paged_decode_mla.
    launches``, ``moe_apply.routed_rows``, ...)."""

    def __init__(self, graph, per_replay: dict, held: list,
                 pool_bytes: int, capture_s: float, telemetry=None):
        self.graph, self.per_replay = graph, per_replay
        self.pool_bytes, self.capture_s = pool_bytes, capture_s
        self._held = held
        self.calls = 0
        self._tel = telemetry if telemetry is not None and \
            telemetry.enabled else None
        self._names = {key: f"{key[0].__name__}.{key[1]}"
                       for key in per_replay}

    def replay(self) -> None:
        self.graph.replay()
        self.calls += 1
        for (fn, name), n in self.per_replay.items():
            setattr(fn, name, getattr(fn, name) + n)
        if self._tel is not None:
            for key, n in self.per_replay.items():
                self._tel.inc(self._names[key], n)


def capture_graph(run, device, what: str, *, state=(), pool=None,
                  telemetry=None) -> Captured:
    """Capture ``run()`` (which writes its outputs into static buffers and
    returns nothing) into a CUDA graph on ``device``: one eager call on a
    side stream, two under ``set_sync_debug_mode("error")`` and
    :class:`HostSyncGuard`, then the capture, into ``pool`` (a
    ``torch.cuda.graph_pool_handle()`` the graph shares with others) or a
    private pool.  ``state``: tensors the eager calls may write and that
    are put back after them.  ``what`` names the entry in the errors: a
    failed capture raises, naming the last op dispatched.  ``telemetry``:
    the engine's hub, which records the capture's ``setup`` spans when it
    traces."""
    tel = telemetry
    traced = tel is not None and tel.trace_enabled

    def setup(name):
        return tel.span(name, "setup", "setup") if traced else NO_SPAN
    with setup("capture"):
        return _capture_graph(run, device, what, state, pool, setup, tel)


def _capture_graph(run, device, what, state, pool, setup, tel) -> Captured:
    t0 = time.perf_counter()
    counters = _launch_counters()
    start = [getattr(fn, name) for fn, name in counters]
    saved = [(leaf, leaf.clone()) for leaf in state]
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    guard = HostSyncGuard(what)
    mode = torch.cuda.get_sync_debug_mode()
    with setup("capture-warm"):
        try:
            with torch.cuda.stream(side):
                run()                           # builds the kept tables
                torch.cuda.set_sync_debug_mode("error")
                with guard:
                    for _ in range(2):
                        run()
        except RuntimeError as e:
            raise RuntimeError(f"{what} syncs with the host at "
                               f"{guard.last}: {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream(device).wait_stream(side)
        for leaf, old in saved:
            leaf.copy_(old)
        # tables a later, longer call may replace in their caches: the
        # graph reads these by address
        held = [*common._ROPE_TABLES.values(),
                *common._SINUSOID_TABLES.values()]
        before = [getattr(fn, name) for fn, name in counters]
        torch.cuda.synchronize(device)
    # no garbage collection inside the capture: a collection that frees a
    # dropped engine's graphs frees their memory pool, a cudaFree, which a
    # capture does not allow (the process aborts)
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()
    guard = HostSyncGuard(what)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with setup("capture-graph"), torch.cuda.graph(graph, pool=pool):
            with guard:
                run()
    except RuntimeError as e:
        raise RuntimeError(f"capturing {what} failed at {guard.last}: "
                           f"{e}") from e
    finally:
        if collecting:
            gc.enable()
    pool_bytes = torch.cuda.memory_reserved(device) - reserved
    # the capture, its eager warm-up calls included, is set-up: it adds
    # nothing to the counts, and each replay adds what one call launches
    per_replay = {}
    for (fn, name), n0, n in zip(counters, start, before):
        if getattr(fn, name) != n:
            per_replay[(fn, name)] = getattr(fn, name) - n
        setattr(fn, name, n0)
    return Captured(graph, per_replay, held, pool_bytes,
                    time.perf_counter() - t0, tel)


class DecodeGraph:
    """One engine's decode entry (see the module's docstring).

    ``graph(tokens, lengths, active)`` with host arrays of ``B`` rows
    returns (logits [B, V_pad], heat [B, MB]) as float32 numpy views of a
    pinned buffer, valid until the next call; ``calls`` counts them (the
    engine's decode steps).  Attributes after a capture: ``graph`` (the
    ``torch.cuda.CUDAGraph``; None on the CPU), ``capture_s`` (warm-up and
    capture, seconds), ``pool_bytes`` (the memory the capture reserved),
    ``per_replay`` ({(wrapper, count): n} added to the counts each
    replay).  ``telemetry``: the engine's hub (spans when it traces).
    ``trip``: the :class:`~repro_torch.kernels.roundtrip.RoundTrip` of the
    ``[3, B]`` inputs and the ``[B, V_pad + MB]`` outputs."""

    def __init__(self, cfg, params: Pytree, cache: Pytree,
                 table: torch.Tensor, layout: PagedLayout, *,
                 telemetry=None):
        self.cfg, self.params, self.cache = cfg, params, cache
        self.table, self.layout = table, layout
        self.telemetry = telemetry
        B, MB = table.shape
        dev = table.device
        self.device = dev
        V = (params["embed"].shape[0] if cfg.tie_embeddings
             else params["lm_head"].shape[1])
        self.vocab_cols = V
        self.trip = RoundTrip((3, B), torch.int32, (B, V + MB),
                              torch.float32, dev, "decode")
        self.graph = None
        self.calls = 0
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.per_replay: dict = {}
        self._captured: Captured | None = None
        if dev.type == "cuda":
            self._capture()

    def _entry(self):
        io = self.trip.dev_in
        return decode_entry(self.params, self.cfg, self.cache, self.table,
                            self.layout, io[0], io[1], io[2] != 0)

    def _write_out(self) -> None:
        logits, heat = self._entry()
        out = self.trip.dev_out
        out[:, :self.vocab_cols].copy_(logits)
        out[:, self.vocab_cols:].copy_(heat)

    def _capture(self) -> None:
        self.trip.dev_in.zero_()                # every row inactive
        c = capture_graph(self._write_out, self.device, "the decode step",
                          state=_slot_state(self.cache),
                          telemetry=self.telemetry)
        tel = self.telemetry
        if self.cfg.moe is not None and tel is not None and tel.enabled:
            count = moe.dropped_rows(self.device)
            tel.probes["moe.dropped_rows"] = lambda: int(count)
        self._captured = c
        self.graph, self.per_replay = c.graph, c.per_replay
        self.pool_bytes, self.capture_s = c.pool_bytes, c.capture_s

    def __call__(self, tokens: np.ndarray, lengths: np.ndarray,
                 active: np.ndarray):
        h = self.trip.host_in
        h[0], h[1], h[2] = tokens, lengths, active
        self.calls += 1
        tel = self.telemetry
        self.trip(self._run, tel if tel is not None and tel.trace_enabled
                  else None)
        out = self.trip.host_out
        return out[:, :self.vocab_cols], out[:, self.vocab_cols:]

    def _run(self) -> None:
        """The step: a replay on the card, an eager call on the CPU."""
        if self._captured is None:
            self._write_out()
            return
        self._captured.replay()


# ---------------------------------------------------------------------------
# The prefill entries
# ---------------------------------------------------------------------------

def _slot_axis(key: str) -> int:
    """The slot axis of a per-slot leaf: 1 in a scan segment's
    ``[reps, B, ...]``, 0 in a plain layer's ``[B, ...]`` (as
    :func:`~repro_torch.models.decode.slot_cache_view` narrows)."""
    return 1 if key.startswith("s") else 0


def stage_cache(cache: Pytree) -> Pytree:
    """``cache`` with every per-slot leaf (mamba ``ssm``/``conv``,
    Whisper's ``xk``/``xv``) replaced by a zeroed buffer of one slot, and
    the pools whole: what a one-sequence prefill writes its per-slot state
    into before :func:`write_slot` puts it in the slot."""
    def stage(key, mem):
        ax = _slot_axis(key)
        return {name: (torch.zeros_like(leaf.narrow(ax, 0, 1))
                       if name in SLOT_KEYS else leaf)
                for name, leaf in mem.items()}
    return {key: ({j: stage(key, mem) for j, mem in seg.items()}
                  if key.startswith("s") else stage(key, seg))
            for key, seg in cache.items()}


def write_slot(cache: Pytree, staged: Pytree, slot: torch.Tensor) -> None:
    """Write the per-slot leaves of ``staged`` (:func:`stage_cache`) into
    ``cache`` at ``slot`` (a one-element long tensor), in place, with
    ``index_copy_`` along the slot axis: no slot address is baked in."""
    for key, seg in cache.items():
        pairs = ([(seg[j], staged[key][j]) for j in seg]
                 if key.startswith("s") else [(seg, staged[key])])
        for mem, st in pairs:
            for name in SLOT_KEYS:
                if name in mem:
                    mem[name].index_copy_(_slot_axis(key), slot, st[name])


def prefill_entry(params: Pytree, cfg, cache: Pytree, staged: Pytree,
                  row: torch.Tensor, layout: PagedLayout,
                  tokens: torch.Tensor, last_index: torch.Tensor,
                  slot: torch.Tensor, **modal) -> torch.Tensor:
    """One admission's full prefill, the reference's ``_prefill_entry``:
    ``prefill_step`` over the table row ``row`` ([1, MB]) with the pools of
    ``cache`` and the per-slot leaves of ``staged`` (:func:`stage_cache`),
    which then go into ``cache`` at ``slot`` ([1] long).  ``tokens`` [1, S]
    (block-padded), ``last_index`` [1] the last real token's index,
    ``modal`` the modality inputs (Whisper's frames, a VLM's patches and
    M-RoPE positions).  Returns the logits [1, V_pad] float32."""
    logits, _ = prefill_step(params, cfg, staged, tokens, row, layout,
                             chunk=256, last_index=last_index, **modal)
    write_slot(cache, staged, slot)
    return logits


def prefill_suffix_entry(params: Pytree, cfg, cache: Pytree,
                         row: torch.Tensor, layout: PagedLayout,
                         tokens: torch.Tensor, last_index: torch.Tensor,
                         prefix_len: torch.Tensor, *,
                         key_blocks: int) -> torch.Tensor:
    """A prefix-cache hit's suffix prefill, the reference's
    ``_prefill_sfx_entry``: ``prefill_suffix_step`` over the table row
    ``row`` ([1, MB]) with the suffix ``tokens`` [1, SB], ``prefix_len``
    a one-element int32 tensor (read by the flash kernel from device
    memory) and ``key_blocks`` the whole prompt's padded block count, the
    shape's static part.  Returns the logits [1, V_pad] float32."""
    logits, _ = prefill_suffix_step(params, cfg, cache, tokens, row, layout,
                                    prefix_len=prefix_len,
                                    key_blocks=key_blocks, chunk=256,
                                    last_index=last_index)
    return logits


class PrefillGraphs:
    """One engine's prefill entries (see the module's docstring).

    ``full(prompt, slot)`` prefills a whole prompt (host int array) into
    ``slot`` through the graph of its padded block count;
    ``suffix(prompt, slot, prefix_len)`` prefills the tokens past
    ``prefix_len`` of a prefix-cache hit through the graph of its
    ``(suffix blocks, key_blocks)``.  Each returns the last real token's
    logits [V_pad] as a float32 numpy view of a pinned buffer, valid until
    the next call, and reads the slot's row of ``table`` (the engine's
    persistent block table, synced before the call).  ``graphs`` maps
    ``("full", nb)`` and ``("suffix", sb, kb)`` to each shape's
    :class:`Captured` (None on the CPU, where the entry runs eagerly);
    ``calls`` counts the admissions.

    All of an engine's prefill graphs share one memory pool (``pool``): a
    private pool per graph would keep each graph's largest intermediates
    (a 7B model's MLP activations of the padded prompt) once per padded
    length.  Sharing is safe in any replay order because every graph's
    outputs go to the static buffers here, allocated outside the pool:
    every block a graph takes from the pool is dead when its replay ends,
    so another graph may take it.  A model with an expert layer on the
    card captures, before its first capture, the longest full prefill
    (``max_blocks``) into the pool and keeps it (``primer``, never
    replayed): every later capture is of a shape no longer, so it carves
    its intermediates from the blocks that one freed, and the pool holds
    one longest prefill's intermediates however many shapes follow, in
    whatever order.  Without it a capture of a longer shape than any before
    takes new segments: with a dropless expert layer each 8,000-token
    shape's capacity-padded buffers are gigabytes, where a dense model's
    intermediates grow by tens of megabytes a shape and its primer would
    cost a capture its traffic may never need.  ``telemetry``: the
    engine's hub (spans when it traces).  ``trip``: the
    :class:`~repro_torch.kernels.roundtrip.RoundTrip` of the inputs (the
    last real token's index, the slot, the prefix length, then the padded
    tokens) and the ``[1, V_pad]`` logits."""

    def __init__(self, cfg, params: Pytree, cache: Pytree,
                 table: torch.Tensor, layout: PagedLayout, modal=None, *,
                 telemetry=None):
        self.cfg, self.params, self.cache = cfg, params, cache
        self.table, self.layout = table, layout
        self.telemetry = telemetry
        self.modal = modal or (lambda seq_len: {})
        dev = table.device
        self.device = dev
        self.on_card = dev.type == "cuda"
        MB, bt = layout.max_blocks, layout.block_tokens
        V = (params["embed"].shape[0] if cfg.tie_embeddings
             else params["lm_head"].shape[1])
        self.trip = RoundTrip(3 + MB * bt, torch.int32, (1, V),
                              torch.float32, dev, "prefill")
        self.row = torch.full((1, MB), -1, dtype=torch.int32, device=dev)
        self.staged = stage_cache(cache)
        self.pool = torch.cuda.graph_pool_handle() if self.on_card else None
        self.graphs: dict = {}
        self.primer: Captured | None = None
        self._primes = self.on_card and cfg.moe is not None
        self.calls = 0

    def _inputs(self, n: int):
        io = self.trip.dev_in
        return io[3:3 + n].view(1, n), io[0:1], io[1:2], io[2:3]

    def _full_out(self, n: int) -> None:
        tokens, last, slot, _ = self._inputs(n)
        self.trip.dev_out.copy_(prefill_entry(
            self.params, self.cfg, self.cache, self.staged, self.row,
            self.layout, tokens, last, slot.long(), **self.modal(n)))

    def _suffix_out(self, n: int, key_blocks: int) -> None:
        tokens, last, _, plen = self._inputs(n)
        self.trip.dev_out.copy_(prefill_suffix_entry(
            self.params, self.cfg, self.cache, self.row, self.layout, tokens,
            last, plen, key_blocks=key_blocks))

    def full(self, prompt: np.ndarray, slot: int) -> np.ndarray:
        bt = self.layout.block_tokens
        nb = -(-len(prompt) // bt)
        return self._call(("full", nb), slot, prompt, len(prompt) - 1, 0,
                          lambda: self._full_out(nb * bt))

    def suffix(self, prompt: np.ndarray, slot: int,
               prefix_len: int) -> np.ndarray:
        bt = self.layout.block_tokens
        if not 1 <= prefix_len < len(prompt):
            raise ValueError(f"suffix prefill: prefix {prefix_len} of a "
                             f"{len(prompt)}-token prompt")
        kb = -(-len(prompt) // bt)
        sb = -(-(len(prompt) - prefix_len) // bt)
        return self._call(("suffix", sb, kb), slot, prompt[prefix_len:],
                          len(prompt) - prefix_len - 1, prefix_len,
                          lambda: self._suffix_out(sb * bt, kb))

    def _call(self, key, slot: int, tokens: np.ndarray, last: int,
              prefix_len: int, run) -> np.ndarray:
        self.calls += 1
        n = 3 + len(tokens)
        h = self.trip.host_in
        h[:3] = last, slot, prefix_len
        h[3:n] = tokens
        h[n:] = 0
        if key not in self.graphs:
            if self._primes and self.primer is None:
                self.primer = self._prime()
            # the capture's eager warm-up calls read these inputs
            self.trip.stage()
            self.graphs[key] = self._capture(key, run) \
                if self.on_card else None
        g = self.graphs[key]

        def entry():
            self.row.copy_(self.table[slot:slot + 1])
            if g is None:
                run()
            else:
                g.replay()
        tel = self.telemetry
        self.trip(entry, tel if tel is not None and tel.trace_enabled
                  else None)
        return self.trip.host_out[0]

    def _prime(self) -> Captured:
        """Capture the full prefill of ``max_blocks`` blocks into the
        shared pool (see the class's docstring), the call's own inputs put
        back after it."""
        n = self.layout.max_blocks * self.layout.block_tokens
        h = self.trip.host_in
        saved = h.copy()
        h[:3] = n - 1, 0, 0
        h[3:] = 0
        self.trip.stage()
        c = self._capture(("full", self.layout.max_blocks),
                          lambda: self._full_out(n))
        h[:] = saved
        return c

    def _capture(self, key, run) -> Captured:
        """Capture ``run`` for shape ``key`` with the table row all -1, so
        the warm-up's KV writes drop, and every slot's per-slot state put
        back after it."""
        self.row.fill_(-1)
        what = (f"the prefill entry at {key[1]} blocks" if key[0] == "full"
                else f"the suffix prefill entry at {key[1]} suffix blocks "
                     f"of {key[2]}")
        return capture_graph(run, self.device, what,
                             state=_slot_state(self.cache, SLOT_KEYS),
                             pool=self.pool, telemetry=self.telemetry)
