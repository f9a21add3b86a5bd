"""Quickest proof that the PyTorch port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``).  Phases, each fatal
on failure:

  1. build every kernel of the serving path from ``src/repro_torch/csrc``;
  2. hold each kernel against its plain PyTorch version on the card at the
     serving path's shapes (decode B in {2, 4}, 32 heads x 128, 16-token
     blocks, up to 512 tokens; prefill 448 tokens; suffix prefill with a
     query offset, prefix 256 + suffix 192 and prefix 208 + suffix 240 over
     448 keys; the prefix-256 case also with the offset read from device
     memory, bit-equal to the host int, as the suffix prefill graph
     launches it), and a small model run through the kernels against the
     same run on the plain versions;
  2b. run the policy-program kernel (``csrc/policy_exec.cu``: one launch
     per batch) on both executors' code, the predicated route's unroll and
     the pc walk's looped code, against the host interpreter
     (``PolicyVM``) and against its plain version on the same CUDA inputs,
     bit for bit (decisions, ring events, drops, every output word), for
     the Figure-1 program at 8 and 64 regions and traced, ``tier_damon``,
     ``evict_lru``, ``profile_wss`` and ``alu_edges`` (every ALU op over
     int64 extremes); then a profile reload (a map write) between two
     ``run_batch`` calls, after which the kernel's decisions on both
     routes must follow the new map.  Printed first: ptxas's line for
     each instance of the kernel (registers, stack frame, spills; any
     stack frame or spill fails the phase), the maps' bytes and the
     shared-memory layout of the main path's batches;
  3. serve 4 requests (prompt 448, 64 new tokens) with ``policy="ebpf"``
     and khugepaged at the full width of deepseek-7b (30 layers, d_model
     4096, 32 heads, d_ff 11008, vocab 102400; random bf16 weights from a
     seed) on the default batched fault route, counting each kernel's
     launches over that run only and printing each hook's batch calls and
     invocations; then the same requests on the scalar route
     (``batch_faults=False``), whose greedy tokens must equal, and on the
     batched route once more (its warm serve wall);
  3b. tiered serving at full width: 128 HBM blocks of 16 tokens plus a
     384-block host tier (``ebpf-tier``), 6 requests of prompt 448 + 128
     new with a hot/cold profile — HBM is overcommitted (6 x 36 blocks >
     128), so the run must complete all 6 with demotions and no
     preemption; block copies move blocks across the combined pool; the
     same requests on the scalar route must give equal tokens and equal
     engine, mm and tier stats;
  3c. prefix-cache serving at full width: 6 requests sharing a 256-token
     system prompt plus 192 tokens of their own, submitted one after
     another; the cache must hit (>= 3) and each suffix prefill must
     launch flash with a query offset once per layer, through the suffix
     graphs (their count printed); a hit's last-token logits are held to a
     full prefill of the same prompt;
  3d. phase 3's requests with telemetry and the Chrome trace on
     (``trace=True``): the trace is written, loaded back and checked; the
     span totals by name, each hook's invocation-latency p50/p99, TTFT and
     per-token decode latency p50/p99 and the ring's events by tag are
     printed; the tokens must equal phase 3's;
  3e. phase 3b's tiered workload under seeded chaos: copy errors and hook
     runtime errors (seed 1, rate 0.05, one injector per route) on both
     fault routes, which must give equal tokens, engine, mm and tier
     stats, ``injector.fired`` and every KV pool leaf bit for bit, with
     ``migrate_copy`` and ``hook_run`` fired; then every failure site armed
     (``chaos=1``, rate 0.05) on the batched route.  In each run every
     supervisor strike must be an injected ``hook_run`` failure and the
     tokens must equal phase 3b's clean run (failures change placement,
     never data);
  3f. phase 3's requests with online profiling (``profile="auto"``), the
     last two submitted 8 steps after the first two so that their
     admissions fault after the first profile reload: at least one reload,
     hinted faults, no strike or detach, tokens equal to phase 3's; the
     synthesized regions and the huge-page share of faulted blocks are
     printed beside phase 3's offline profile's;
  3h. the decode entry (``serving/compiled.py``): every engine decodes
     through one CUDA graph, captured when the engine is built and
     replayed each step, so each serving phase's paged launches must equal
     its attention layers times its decode steps (the replays add the
     counts the capture recorded).  Phase 3's requests with ``trace=True``
     on the graph: serve wall, decode ms a step (the decode span over the
     steps) and per-token p50; tokens and MMStats equal to phase 3's, one
     LM head launch for each decode step and admission.  Then one replay's
     device time by CUDA events against the weight-read bound, the
     capture's time and graph pool, and the LM head's product beside its
     byte bound;
  3i. the prefill entries (``serving/compiled.py``): every admission
     prefills through a CUDA graph, one per padded block count (one per
     suffix and key block count for a prefix-cache hit), captured at the
     shape's first admission into one pool shared by the engine's prefill
     graphs and replayed after, so each serving phase's flash launches
     must equal its attention layers times its admissions.  deepseek-7b,
     ``max_batch=4``, two rounds on one engine of 4 requests of 448, 300,
     130 and 16 tokens + 8 new (round 1 captures four graphs, round 2 only
     replays): prefill ms per admission in each round (the capture apart),
     TTFT p50 per round.  Then per length one replay's device time by CUDA
     events beside the flops and bytes bound, the capture's time and the
     reserved memory it added (a graph after the first must add under
     0.25 GB);
  4. time each kernel, its plain version and a yardstick PyTorch call, next
     to the least time the card could take for the same work, and print
     each one's share of that bound.  Paged decode is timed L2-cold: the
     launches walk the serving engine's 30 per-layer KV pools in turn, as
     the decode step does, so no launch finds its K/V in the 50 MB L2.  Also
     printed: the two-class paged decode (``paged_decode_multi``), the
     device kernels one paged call launches (``torch.profiler``), and the
     count of ``HGMMA`` (tensor-core) instructions in the flash library
     (``cuobjdump -sass``), and per program and batch bucket the
     policy-program kernel's device time (CUDA events around a CUDA graph
     of calls) and wall per ``run_batch`` beside the eager body's and its
     earlier time, with an empty kernel's launch on the same stream as the
     latency floor; what one interpreted row costs by kind; and where the
     main path's ``run_batch`` wall goes, from ``torch.profiler``'s trace
     of real calls.  Nothing is profiled before the serving phases, whose
     walls are printed.
  5. with deepseek-7b freed, serve deepseek-moe-16b at full width and full
     depth (28 layers, d_model 2048, MHA 16 x 128, 64 routed experts of
     d_ff 1408 top-6 + 2 shared, vocab 102400; ~33 GB of random bf16
     weights): 4 requests of prompt 448 + 64 new, ``max_batch=4``, 512
     blocks, ``policy="ebpf"`` with the demo profile and khugepaged, on the
     batched route and then the scalar route, which must give equal
     tokens, ``MMStats`` and drained moves; paged decode must launch 28
     times per decode step and flash 28 times per admission;
  5b. the same for gemma-3-27b (6 layers, one 5:1 local:global cycle,
     window 1024, head_dim 168, 2 x (1200 + 32)), qwen2-VL-7b (4 layers,
     M-RoPE, 1024 stub patches, GQA 28:4, 2 x (1100 + 32)), nemotron-4-15b
     (4 layers, LayerNorm, squared ReLU, GQA 48:8, 2 x (448 + 32)) and
     phi-3-mini (4 layers, head_dim 96, 2 x (448 + 32)), at full width
     with depth cut;
  5c. hold and time the kernels at those families' new shapes: flash at
     head_dim 168 with GQA 2 and window 1024 over 1200 tokens, flash at
     GQA 7 over 1104, and paged decode at G = 6, G = 7 and head_dim 168
     with the window (L2-cold), each beside its plain version, its bound
     and one PyTorch call (SDPA, the window as a mask) where there is one.
  6. with those freed, serve deepseek-v2-lite-16b at full width and depth
     (27 layers, MLA with kv_lora 512 and q/k heads of 128 + 64 against v
     heads of 128, 64 routed experts top-6 + 2 shared; ~31 GB of bf16
     weights) on phase 5's protocol on both routes (equal tokens,
     ``MMStats`` and moves): flash 27 times per admission at q/k 192 and v
     128, 27 launches of MLA's latent-decode kernel (``paged_decode_mla``)
     per decode step and no paged-decode launch, block copies over the
     latent pools; then phase 3c's prefix-cache
     stream on it (16 new tokens each), whose suffix prefills must launch
     flash with a query offset; the hit is held to a full prefill at the
     second layer's pool rows (MoE capacity counts the rows prefilled, so
     later layers may route other tokens, in the reference too);
  6b. mamba2-1.3b (48 layers, 4 x (512 + 64)), jamba-v0.1 (8 of 32 layers:
     one hybrid cycle, 4 of them MoE with 16 experts of d_ff 14336, 4 x
     (512 + 64)) and whisper-medium (24 + 24 layers, 1500 stub frames, 4 x
     (192 + 64)) at full width on both routes.  mamba2's and jamba's "m"
     layers serve as attention layers, as in the reference (its mamba
     branch tests a plan kind no config has);
  6c. hold and time the kernels at those shapes: flash at MLA's prefill
     (H 16, q/k 192, v 128, S 448) and suffix prefill (query offset 256),
     at Whisper's encoder (1500 x 1500, non-causal) and cross-attention (192
     prompt rows against 1500 frames), paged decode at jamba's G 4
     (L2-cold), MLA's latent decode at phase 6's decode shape (batch 4,
     29-32 blocks a row, 576-wide latents, the YaRN-scaled softmax scale;
     L2-cold) against the gather it replaces, and block copy over the 27
     latent pools; the library call is SDPA with the same value width, on
     whichever backend takes it.  ``python3 chip_smoke.py --phase 6`` runs
     phases 1, 6 and 6c's MLA rows alone.
  7. with those freed, train deepseek-7b at full width with its depth cut to
     8 of 30 layers (2.46 B float32 params drawn from a seed on the card,
     AdamW's float32 moments beside them: 39 GB of state; bf16 compute,
     remat on) through ``make_train_step``: ``TRAIN_STEPS`` steps on
     synthetic bigram batches of 4 x (1024 + 1) tokens.  Every loss must be
     finite and the last three steps' mean below the first three's; each
     step must launch the flash forward 8 x 2 times (remat recomputes each
     layer) and each backward kernel 8 times; one layer's attention
     backward, run twice on its saved inputs, must give the same bits.
     Prints the step wall p50, the peak of allocated memory, and the device
     time by kernel of one more step (``torch.profiler``, after the timed
     steps), with the flash backward's time in that step also from CUDA
     events around its calls, and the card's SM clock.  Then a gradient
     check at full width with 2 layers, 1 x 1024
     tokens: the loss and every leaf's gradient through the kernels against
     the same with the plain attention, both on the card, to 2e-2 of each
     leaf's largest gradient;
  7b. the backward kernels (bf16: the ``wgmma`` route; each shape's route
     and the backward library's ``HGMMA`` count are printed) against
     ``flash_attention_bwd_plain`` and against
     autograd of ``flash_attention_plain`` on the card, and timed beside
     their bounds, the plain versions and SDPA's backward (the library
     yardstick), at the main path's shape (4 x 1024, 32 x 128, causal),
     nemotron-4's GQA (G 6), gemma-3's window (1024, hd 168, 2048 tokens),
     MLA's q/k 192 and v 128, and Whisper's encoder (1500 x 1500) and
     cross-attention (448 x 1500), non-causal; the forward with LSE at each;
     and the serving forward at phase 2's shape timed with the LSE pointer
     null and set, in turns;
  7c. the fault-tolerant ``Trainer`` on the card: deepseek-7b smoke, 30
     steps, a checkpoint every 10 in a temporary directory, a simulated
     failure at step 12: one restart, final step 30, the loss down by more
     than 0.2 (the reference's own trainer test).
  8. (run after 6c and before 7, with the parent's cached HBM freed) the
     distributed serve path: 4 ranks spawned on the one card
     (``torch.multiprocessing``, "spawn"; a ``gloo`` group through a
     ``FileStore``: NCCL puts no two ranks on one device; the kernels
     built by the parent), each a rank of a 2 x 2 mesh, then:
     8a. the sharded attention against the gather kernel on one query
         batch over layer 0's pools, in bf16 (2e-2, phase 2's tolerance)
         and float32 (1e-4, the GPU tests'), then
         8 teacher-forced decode steps of deepseek-7b at full width (8 of
         30 layers, params whole on every rank, pools drawn from a seed, 8
         sequences of 449-512 tokens in 16-token blocks, 64 of the 256
         blocks on each rank) with ``attn_impl="flashdecode"`` (2 x 2) and
         ``"flashdecode_blocksharded"`` (4 shards), each step's logits rows
         held to a one-process ``decode_step(attn_impl="gather")`` over the
         global pool (2e-2 x max(1, largest |logit|): phase 3c's full-width
         bf16 tolerance), layer 0's
         pool rows equal bit for bit (every later layer's written rows
         counted where they differ), and every ``paged_decode_partials``
         call held to its plain version (heat, m, l 1e-5 relative, acc
         1e-4);
     8b. ``moe_apply_ep`` on a 1 x 4 mesh (16 experts a rank) at
         deepseek-moe-16b's widths, T 512 and 8, against the local
         ``moe_apply`` at the same capacity (2e-2 x max(1, largest |y|);
         aux 1e-6);
     8c. the int8 compressed mean of 4 float32 leaves of 4096 x 11008
         against the exact mean (relative error < 0.02), its bytes on the
         wire beside float32's;
     8d. 8a's batch-sharded decode (2 steps) and 8c's mean on one rank of
         an NCCL group: the gather path's logits, mean + feedback equal to
         the input.
     A rank that fails fails the phase; then ``paged_decode_partials`` is
     held to its plain version and timed in the parent at one rank's 8a
     shape.  ``python3 chip_smoke.py --phase 8`` runs phases 1 and 8
     alone.
  9. the dry-run's sharded programs (``repro_torch.launch.dryrun``):
     9a. 4 gloo ranks on the card as a 2 x 2 ("data", "model") mesh run
         deepseek-7b (8 of 30 layers, full width, weights from one seed
         split by the sharding rules) as DTensor programs: a [2, 448]
         prefill, one decode step through ``gather`` and through
         ``flashdecode``, and one train step at 2 x 1024 (ZeRO-1 moments);
         DTensor's all-gathers staged through the host (gloo's
         functional all-gather on CUDA tensors ends a rank with SIGSEGV);
         rank 0 then runs the one-process programs on the same weights:
         logits within 2e-2 x max(1, largest |logit|), the loss within
         2e-2 relative, each updated leaf within 5e-2 of its largest
         |update| (``SHARD``), while a control (the one-process step on
         the batch's first sequence alone) must exceed that limit; the
         same train step in float32, sharded against one process, is held
         to the same limits and its worst leaf printed beside bf16's; every
         rank must launch the flash forward and backward, the paged
         split/combine and ``paged_decode_partials``.  ``--phase 9a
         [--seed N]`` runs phases 1 and 9a alone, on another seed's
         weights and inputs;
     9b. rank 0 of the 256-rank production mesh on a fake world: deepseek-7b
         at full width and depth, ``decode_32k`` (flashdecode) and
         ``train_4k`` on rank 0's real shards; peak HBM, the step's wall
         (twice), the collectives by kind and bytes, which must equal the
         ``meta`` trace of the same cell; the device's busy time in a
         third, profiled step against the warm step's wall, and the
         kernels that took most of it; the card's name, power limit and
         clocks beside them;
     9c. the flash forward and backward at ``train_4k``'s rank-local shape
         and ``paged_decode_partials`` at ``decode_32k``'s, held to their
         plain versions and timed (launches from 9b).
     ``python3 chip_smoke.py --phase 9`` runs phases 1 and 9 alone.

Each serving phase sets the launch counts to 0 just before its run, reads
and prints them just after, and fails if the policy supervisor struck or
detached any program (a batch executor that raises on the card) — except
the chaos phase, where every strike must be an injected one.  Phases 3-3f
(and 6's prefix run) also fail unless ``policy_exec`` launched once per
hook batch call of the run, and at least once on the batched route.
Prints one JSON line with the kernels' numbers (launches from phase 3,
``policy_exec``'s two rows with phase 3's launches by route: the kernel
counts the JIT route's apart, in ``policy_exec.pc_walk_launches``; each
row's error is its timed executor's against the plain version on the
same rows; the q_offset
flash case as a row of its own, its launches from phase 3c; the rows of
phases 5c and 6c with the launches of their family's batched run, the MLA
suffix row with phase 6's query-offset launches; the training rows
of phase 7b with phase 7's launches, 0 at the shapes no phase trains; the
shard partials row with phase 8a's launches summed over the ranks; the
rank-local rows of 9c with 9b's launches), the card's
name and power limit, and last ``{"ok": true, "device": {...}}``.  Imports
nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12           # dense bf16 tensor-core peak
SEED = 0
# policy_exec launches of each serving run (phases 3-3f, 6's prefix run)
EXEC_RUNS: dict = {}
# the policy kernel's device ms before its redesign, by (program, bucket),
# on an H100 (PERF.md's policy_exec rows, "earlier ms")
EXEC_EARLIER = {("main", 4): 0.02048, ("pc_walk", 64): 0.03786,
                ("fig1_r8", 4): 0.02253, ("fig1_r8", 8): 0.02696,
                ("fig1_r8", 16): 0.03518, ("fig1_r8", 32): 0.03888,
                ("fig1_r8", 64): 0.03917, ("fig1_r64", 4): 0.03022,
                ("fig1_r64", 16): 0.06630, ("fig1_r64", 64): 0.09335}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fns, iters: int = 60, warmup: int = 5, *, what: str = "",
              capture: bool = True) -> float:
    """Device time per call of ``fns[i % len(fns)]()``: from the device
    kernels and copies that ``iters`` calls launch, as ``torch.profiler``
    (CUPTI) records them, so the host's pace between launches does not
    count.  A session can lose a few events (57 flash kernels recorded for
    60 calls, on an H100), so the time is taken per kernel name: its
    mean duration times its launches per call (its count over ``iters``,
    rounded), summed over the names that run at least once per two
    calls.  Some sessions record none of the calls' kernels (SDPA on its
    cuDNN backend after phase 4; late in the run, after the training
    phases, any kernel, on an H100); then :func:`event_ms` times them."""
    for i in range(warmup):
        fns[i % len(fns)]()
    _device_kernels(fns[0])          # a throwaway session first
    by_name: dict = {}
    for name, t in _device_kernels(
            lambda: [fns[i % len(fns)]() for i in range(iters)]):
        by_name.setdefault(name, []).append(t)
    us = sum(sum(ts) / len(ts) * round(len(ts) / iters)
             for ts in by_name.values())
    if us > 0:
        return us / 1e3
    print(f"  (torch.profiler recorded no device time{what})", flush=True)
    return event_ms(lambda: [f() for f in fns], len(fns), capture=capture)


def event_ms(fn, calls: int = 1, *, capture: bool = True) -> float:
    """Time per call of ``fn`` (which makes ``calls`` calls) from CUDA
    events: around replays of a CUDA graph of captured rounds of ``fn``, so
    the host's launch time does not count (the device's gaps between the
    calls do); where ``fn`` cannot be captured, or ``capture`` is False (an
    autograd backward, which runs on the autograd engine's own thread: its
    failed capture left later profiler sessions empty, on an H100), around
    eager rounds, the host's launch gaps included."""
    rounds = max(1, 20 // calls)
    if capture:
        fn()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                for _ in range(rounds):
                    fn()
        except RuntimeError as e:             # the calls cannot be captured
            print(f"  (not captured: {str(e)[:120]})", flush=True)
        else:
            ms = cuda_ms(graph.replay, iters=10, warmup=2) / (rounds * calls)
            print(f"  ({ms:.4f} ms per call from CUDA events around a CUDA "
                  f"graph of {rounds * calls} calls)", flush=True)
            return ms
    ms = cuda_ms(fn, iters=max(1, 60 // calls)) / calls
    print(f"  ({ms:.4f} ms per call from CUDA events around eager calls, "
          f"host launch time included)", flush=True)
    return ms


def library_ms(fn, iters: int = 60) -> float:
    """Device time per call of a PyTorch yardstick call (``device_ms``)."""
    return device_ms([fn], iters=iters, what=" for a library call")


def max_err(a, b) -> float:
    e = (a.float() - b.float()).abs().max().item()
    return e if math.isfinite(e) else float("inf")


def check(name: str, err: float, tol: float) -> float:
    print(f"  {name}: max_abs_err={err:.3e} (tol {tol:g})", flush=True)
    if not err <= tol:
        fail(f"{name} disagrees with its plain version: {err} > {tol}")
    return err


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script measures the "
              "GPU port and has nothing to run on the CPU", file=sys.stderr)
        sys.exit(2)
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    try:
        from repro_torch.configs.base import get_config, get_smoke_config
        from repro_torch.core import Profile, ProfileRegion
        from repro_torch.kernels import build
        from repro_torch.kernels.block_copy import ops as bc
        from repro_torch.kernels.flash_attention import ops as fa
        from repro_torch.kernels.paged_attention import ops as pa
        from repro_torch.kernels.policy_exec import ops as pe
        from repro_torch.models import (PagedLayout, cache_init, decode_step,
                                        materialize, model_spec, prefill_step)
        from repro_torch.models.common import F32
        from repro_torch.serving import Request, ServingEngine
        from repro_torch.serving import engine as engine_mod
    except ImportError as e:
        fail(f"the port is not next to this script ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    # what sets the precision of float32 products here: phase 2's float32
    # checks have read 10-50x their usual errors on one H100 machine
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"driver {driver}; TF32 in float32 products "
          f"{torch.backends.cuda.matmul.allow_tf32}; TF32 environment "
          f"{ {k: v for k, v in os.environ.items() if 'TF32' in k} }",
          flush=True)

    # ---------------------------------------------------------------- 1
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"[1] built {sorted(built)} in {time.perf_counter() - t0:.2f}s "
          f"(one nvcc per source, in parallel)", flush=True)
    if sys.argv[1:] == ["--phase", "8"]:       # phase 8 alone
        _finish(_phase8(gen, dev, pa), card)
        return
    if sys.argv[1:] == ["--phase", "9"]:       # phase 9 alone
        _finish(_phase9(gen, dev, fa, pa), card)
        return
    if sys.argv[1:] == ["--phase", "6"]:       # phases 6 and 6c's MLA rows
        _finish(_mla_phase(gen, dev, fa, pa, bc, engine_mod), card)
        return
    if sys.argv[1:3] == ["--phase", "9a"]:     # 9a's readings for a seed
        _sharded_phase(int(sys.argv[4]) if sys.argv[3:4] == ["--seed"]
                       else SEED)
        _finish([], card)
        return

    cfg = get_config("deepseek_7b")
    H, KVH, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    bt, NB, MB = 16, 512, 32
    bf16 = torch.bfloat16

    def rn(*shape, dtype=bf16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # ---------------------------------------------------------------- 2
    print("[2] kernels vs plain versions on the card", flush=True)
    errs = {"paged_decode_attention": 0.0, "flash_attention": 0.0,
            "block_copy": 0.0}
    pool_k, pool_v = rn(NB, bt, KVH, hd), rn(NB, bt, KVH, hd)
    decode_cases = {}
    for B in (2, 4):
        q = rn(B, H, hd)
        table = torch.stack([torch.randperm(NB, generator=gen, device=dev)[:MB]
                             for _ in range(B)]).int()
        lengths = torch.randint(449, 513, (B,), generator=gen,
                                device=dev).int()
        lengths[0] = 512
        table[-1, 20:] = -1                 # a row with unmapped tail blocks
        lengths[-1] = 20 * bt
        out, heat = pa.paged_decode_attention(q, pool_k, pool_v, table,
                                              lengths, block_tokens=bt)
        torch.cuda.synchronize()
        ref_out, ref_heat = pa.paged_decode_plain(q, pool_k, pool_v, table,
                                                  lengths, block_tokens=bt)
        e = max(check(f"paged decode B={B} out (bf16)", max_err(out, ref_out),
                      2e-2),
                check(f"paged decode B={B} heat", max_err(heat, ref_heat),
                      1e-4))
        errs["paged_decode_attention"] = max(errs["paged_decode_attention"], e)
        decode_cases[B] = (q, table, lengths)
    multi = _two_class_case(gen, dev, B=4, NB=NB)
    mq = rn(4, H, hd)
    out, heats = pa.paged_decode_multi(mq, pool_k, pool_v, *multi,
                                       block_tokens=bt, orders=(0, 1))
    torch.cuda.synchronize()
    ref_out, ref_heats = pa.paged_decode_multi_plain(
        mq, pool_k, pool_v, *multi, block_tokens=bt, orders=(0, 1))
    errs["paged_decode_attention"] = max(
        errs["paged_decode_attention"],
        check("paged decode, two size classes, out (bf16)",
              max_err(out, ref_out), 2e-2),
        check("paged decode, two size classes, heat",
              max(max_err(a, b) for a, b in zip(heats, ref_heats)), 1e-4))
    S = 448
    qf, kf, vf = rn(1, S, H, hd), rn(1, S, KVH, hd), rn(1, S, KVH, hd)
    o = fa.flash_attention(qf, kf, vf, causal=True)
    torch.cuda.synchronize()
    errs["flash_attention"] = check(
        "flash prefill S=448 (bf16)",
        max_err(o, fa.flash_attention_plain(qf, kf, vf, causal=True,
                                            chunk=256)), 2e-2)
    errs["flash_attention_q_offset"] = 0.0
    suffix = {}
    for pre in (256, 208):
        qs = rn(1, S - pre, H, hd)
        o = fa.flash_attention(qs, kf, vf, causal=True, q_offset=pre)
        torch.cuda.synchronize()
        errs["flash_attention_q_offset"] = max(
            errs["flash_attention_q_offset"],
            check(f"flash suffix prefill q_offset={pre} Sq={S - pre} Sk={S} "
                  f"(bf16)", max_err(o, fa.flash_attention_plain(
                      qs, kf, vf, causal=True, chunk=256, q_offset=pre)),
                  2e-2))
        suffix[pre] = qs
    # the suffix prefill graph's launch: the offset read from device memory
    dev_off = torch.tensor([256], dtype=torch.int32, device=dev)
    n_off = fa.flash_attention.offset_launches
    o_dev = fa.flash_attention(suffix[256], kf, vf, causal=True,
                               q_offset=dev_off)
    o_host = fa.flash_attention(suffix[256], kf, vf, causal=True,
                                q_offset=256)
    torch.cuda.synchronize()
    same = torch.equal(o_dev, o_host)
    print(f"  flash suffix prefill q_offset=256 from device memory vs the "
          f"host int: bit-equal={same}, offset launches counted "
          f"{fa.flash_attention.offset_launches - n_off} of 2", flush=True)
    if not same or fa.flash_attention.offset_launches != n_off + 2:
        fail("flash with a device-side q_offset differs from the host int "
             "offset, or was not counted as an offset launch")

    # one apply_moves call (a plan of two runs, padded with self-copies)
    plan = [(3, 40, 1), (100, 7, 0)]
    msrc, mdst = bc.expand_moves(plan, pad_to=8)
    mpool = rn(128, bt, KVH, hd)
    mwant = mpool.clone()
    bc.block_copy_plain([mwant[None]], msrc[msrc != mdst],
                        mdst[msrc != mdst])
    before = bc.block_copy.launches
    bc.apply_moves(mpool, msrc, mdst)
    torch.cuda.synchronize()
    if bc.block_copy.launches != before + 1:
        fail("apply_moves did not launch the block copy kernel")
    errs["block_copy"] = check(
        f"apply_moves {plan} padded to 8 rows vs the plain copy (bf16, "
        f"exact)", max_err(mpool, mwant), 0.0)
    del mpool, mwant

    # small model through the kernels vs the plain versions (float32)
    small = get_smoke_config("deepseek_7b")
    sp = materialize(gen, model_spec(small), device=dev)
    lay = PagedLayout(num_blocks=64, block_tokens=4, max_blocks=16)
    outs = {}
    for where in ("cuda", "cpu"):
        p = sp if where == "cuda" else _to(sp, "cpu")
        cache = cache_init(small, lay, 2, F32, device=where)
        tbl = torch.full((2, 16), -1, dtype=torch.int32, device=where)
        tbl[0, :10] = torch.arange(10)
        tbl[1, :10] = torch.arange(20, 30)
        toks = torch.arange(1, 33, device=where).reshape(2, 16) * 7
        logits = [prefill_step(p, small, cache, toks[i:i + 1], tbl[i:i + 1],
                               lay, compute_dtype=F32)[0] for i in range(2)]
        lens = torch.tensor([16, 16], dtype=torch.int32, device=where)
        heats = []
        for step in range(6):
            lg, _, h = decode_step(p, small, cache, toks[:, step] + 1, lens,
                                   tbl, lay, compute_dtype=F32,
                                   active=torch.tensor([True, step % 2 == 0],
                                                       device=where))
            logits.append(lg)
            heats.append(h)
            lens = lens + 1
        outs[where] = (torch.cat(logits).cpu(), torch.stack(heats).cpu(),
                       cache["s0"]["m0"]["pool_k"].cpu())
    check("small model logits (f32, kernels vs plain)",
          max_err(outs["cuda"][0], outs["cpu"][0]), 1e-3)
    check("small model heat", max_err(outs["cuda"][1], outs["cpu"][1]), 1e-4)
    check("small model KV pool", max_err(outs["cuda"][2], outs["cpu"][2]),
          1e-4)
    del sp

    # --------------------------------------------------------------- 2b
    exec_timed = _executor_phase()

    # ---------------------------------------------------------------- 3
    print("[3] serve deepseek-7b at full width (30 layers, random bf16 "
          "weights), batched fault route (the default)", flush=True)
    t0 = time.perf_counter()
    params = materialize(gen, model_spec(cfg), device=dev, dtype=bf16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  params: {n_params / 1e9:.2f}B in bf16 "
          f"({n_params * 2 / 1e9:.1f} GB) in {time.perf_counter() - t0:.1f}s",
          flush=True)
    layout = PagedLayout(num_blocks=NB, block_tokens=bt, max_blocks=MB)
    profile = Profile("chat", [
        ProfileRegion(0, 8, (0, 150_000, 600_000, 2_500_000)),  # hot prefix
        ProfileRegion(8, 32, (0, 0, 0, 0)),                     # cold tail
    ])
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab, 448).tolist() for _ in range(4)]
    wrappers = {"paged_decode_attention": pa.paged_decode_attention,
                "flash_attention": fa.flash_attention,
                "block_copy": bc.block_copy}

    def serve_main(stagger: int = 0, label: str = "3", check: bool = True,
                   **kw):
        """Phase 3's requests on a fresh engine with ``kw``, the last two
        submitted ``stagger`` steps after the first two; the kernel
        launches are counted over this run alone (``label`` names it;
        ``check`` holds policy_exec's to the hook batch calls)."""
        what = f"phase {label}"
        e = ServingEngine(cfg, params, layout, max_batch=4, policy="ebpf",
                          profile=kw.pop("profile", profile), seed=SEED,
                          **kw)
        for w in wrappers.values():
            w.launches = 0
        _zero_exec()                       # after the engine's warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        for rid in range(4):
            if rid == 2:
                for _ in range(stagger):
                    e.step()
            e.submit(Request(rid=rid, prompt=prompts[rid],
                             max_new_tokens=64, app="chat"))
        o = e.run(max_steps=400)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        return e, o, wall, {
            **{k: w.launches for k, w in wrappers.items()},
            "policy_exec": _exec_launches(
                e.mm.hooks, what, batched=kw.get("batch_faults", True))
            if check else 0}

    moves_seen: list = []
    real_block_copy = engine_mod.block_copy

    def recording_block_copy(leaves, src, dst, **kw):
        moves_seen.append((np.array(src), np.array(dst)))
        real_block_copy(leaves, src, dst, **kw)
    engine_mod.block_copy = recording_block_copy
    eng, out, wall, launches = serve_main()
    engine_mod.block_copy = real_block_copy
    if not eng.batch_faults:
        fail("the engine's default fault route is not the batched one")
    st = out["engine"]
    print(f"  completed={st['completed']} decode_tokens={st['decode_tokens']}"
          f" prefills={st['prefills']} steps={st['steps']} wall={wall:.2f}s",
          flush=True)
    print(f"  khugepaged={out.get('khugepaged')}", flush=True)
    print(f"  mm={json.dumps(out['mm'])}", flush=True)
    print(f"  launches={launches} move batches={len(moves_seen)}", flush=True)
    hooks = eng.mm.hooks
    print(f"  hooks: batch_calls={_nonzero(hooks.batch_calls)} "
          f"invocations={_nonzero(hooks.invocations)} "
          f"calls={_nonzero(hooks.calls)}", flush=True)
    if st["completed"] != 4:
        fail(f"{st['completed']} of 4 requests completed")
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the serving path")
    _graph_launches(eng, launches, cfg.n_layers, "phase 3", cfg.n_layers)
    if out["khugepaged"]["collapsed"] <= 0:
        fail("khugepaged collapsed nothing")
    if hooks.batch_calls["mm_fault"] <= 0:
        fail("the batched route ran no HOOK_FAULT batch")
    _contained(hooks, "serving run, batched route")
    toks = [t for seq in eng.finished.values() for t in seq]
    if len(toks) != 4 * 64 or not all(0 <= t < cfg.vocab for t in toks):
        fail("generated tokens outside the vocabulary or missing")

    # the same requests on the scalar route, in the same call
    sc, sc_out, sc_wall, sc_launches = serve_main(label="3, scalar route",
                                                   batch_faults=False)
    print(f"  scalar route: completed={sc_out['engine']['completed']} "
          f"wall={sc_wall:.2f}s launches={sc_launches} hooks calls="
          f"{_nonzero(sc.mm.hooks.calls)}", flush=True)
    # the batched route once more, now that the scalar run has warmed the
    # process as the first run warmed it for the scalar one
    again, _, again_wall, _ = serve_main(label="3, batched route again")
    print(f"  serve wall: batched route {wall:.2f}s (first run), scalar "
          f"route {sc_wall:.2f}s, batched route again {again_wall:.2f}s",
          flush=True)
    _contained(again.mm.hooks, "serving run, batched route again")
    _contained(sc.mm.hooks, "serving run, scalar route")
    if again.finished != eng.finished:
        fail("two runs of the batched route sampled different tokens")
    del again
    if sc.finished != eng.finished:
        fail("the batched and scalar fault routes sampled different tokens")
    if sc_out["mm"] != out["mm"]:
        fail("the batched and scalar fault routes left different MMStats")
    print("  batched and scalar routes: equal tokens and MMStats", flush=True)
    del sc

    # ---------------------------------------------------------------- 3d
    _telemetry_phase(serve_main, eng, wall)

    # ---------------------------------------------------------------- 3f
    _auto_profile_phase(serve_main, eng, out)

    # ---------------------------------------------------------------- 3b
    tier_launches, tier_finished = _tiered_phase(cfg, params, wrappers,
                                                 engine_mod)

    # ---------------------------------------------------------------- 3e
    _chaos_phase(cfg, params, wrappers, tier_finished)

    # ---------------------------------------------------------------- 3c
    offset_launches = _prefix_phase(cfg, params, profile, wrappers, fa)

    # ---------------------------------------------------------------- 3h
    _graph_phase(serve_main, eng, out, params)

    # ---------------------------------------------------------------- 3i
    _prefill_graph_phase(cfg, params, layout, profile)

    # block copy on the engine's own pools with the serving path's moves
    leaves, ptrs = eng._pool_leaves, eng._pool_ptrs
    src, dst = max(moves_seen, key=lambda m: len(m[0]))
    copies = [leaf.clone() for leaf in leaves]
    bc.block_copy(leaves, src, dst, ptrs=ptrs)
    torch.cuda.synchronize()
    bc.block_copy_plain(copies, src, dst)
    errs["block_copy"] = check(
        f"block copy {len(src)} rows x {len(leaves)} leaves x "
        f"{leaves[0].shape[0]} layers",
        max(max_err(a, b) for a, b in zip(leaves, copies)), 0.0)
    del copies

    # ---------------------------------------------------------------- 4
    print("[4] timing: device time per call from torch.profiler (CUPTI) over "
          "10-60 calls after 5 warm-up; eager wall per call from CUDA events",
          flush=True)
    rows = []
    q, table, lengths = decode_cases[4]
    n_tok = int(lengths.sum())
    kv_bytes = n_tok * KVH * hd * 2 * 2
    byts = kv_bytes + q.numel() * 2 * 2 + table.numel() * 4 + 4 * 4 \
        + 4 * MB * 4
    flops = 4 * n_tok * H * hd
    pools = list(zip(leaves[0], leaves[1]))      # the 30 layers' (K, V)
    print(f"  paged decode timed L2-cold: each launch reads the next of the "
          f"engine's {len(pools)} per-layer pools ({kv_bytes / 1e6:.1f} MB "
          f"of K/V each, {len(pools) * kv_bytes / 1e6:.0f} MB per round "
          f"against a 50 MB L2)", flush=True)

    def per_layer(fn):
        return [lambda pk=pk, pv=pv: fn(pk, pv) for pk, pv in pools]
    paged_kernel = per_layer(lambda pk, pv: pa.paged_decode_attention(
        q, pk, pv, table, lengths, block_tokens=bt))
    paged_plain = per_layer(lambda pk, pv: pa.paged_decode_plain(
        q, pk, pv, table, lengths, block_tokens=bt))
    rows.append(_row(
        "paged_decode_attention", "src/repro_torch/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention/kernel.py:99",
        launches, errs, byts, flops,
        lambda: device_ms(paged_kernel),
        lambda: device_ms(paged_plain, iters=30), None))

    def one_pool():
        return pa.paged_decode_attention(q, pool_k, pool_v, table, lengths,
                                         block_tokens=bt)
    print(f"  paged decode on one pool, L2-warm: {device_ms([one_pool]):.4f} "
          f"ms device (not the serving path's case; for comparison only)",
          flush=True)
    print(f"  paged decode, eager wall per call over the 30 pools: "
          f"{cuda_ms(lambda: [f() for f in paged_kernel], iters=2) / 30:.4f}"
          f" ms (host-paced where above the device time)", flush=True)
    kernels = _device_kernels(one_pool)
    print(f"  paged decode device kernels per call: {len(kernels)} "
          + ", ".join(f"{n} {t:.1f} us" for n, t in kernels), flush=True)

    kr = kf.repeat_interleave(H // KVH, dim=2)
    vr = vf.repeat_interleave(H // KVH, dim=2)
    qt, kt, vt = (x.transpose(1, 2) for x in (qf, kr, vr))
    pairs = S * (S + 1) // 2

    def flash():
        return fa.flash_attention(qf, kf, vf, causal=True)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)
    rows.append(_row(
        "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:90",
        launches, errs, 4 * S * H * hd * 2, 4 * pairs * H * hd,
        lambda: device_ms([flash]),
        lambda: device_ms([lambda: fa.flash_attention_plain(
            qf, kf, vf, causal=True, chunk=256)], iters=10),
        lambda: library_ms(sdpa)))
    print(f"  flash prefill, eager wall per call: {cuda_ms(flash):.4f} ms; "
          f"SDPA {cuda_ms(sdpa):.4f} ms", flush=True)

    # the suffix prefill of phase 3c: 192 query rows at offset 256
    pre = 256
    qs = suffix[pre]
    Sq = S - pre
    s_pairs = Sq * pre + Sq * (Sq + 1) // 2
    qst = qs.transpose(1, 2)
    # query i sees keys j <= i + (S - Sq): SDPA's lower-right causal bias,
    # which its flash backend takes as it takes is_causal
    from torch.nn.attention.bias import causal_lower_right
    offset_bias = causal_lower_right(Sq, S)

    def flash_sfx():
        return fa.flash_attention(qs, kf, vf, causal=True, q_offset=pre)

    def sdpa_sfx():
        return torch.nn.functional.scaled_dot_product_attention(
            qst, kt, vt, attn_mask=offset_bias)
    launches["flash_attention_q_offset"] = offset_launches
    rows.append(_row(
        "flash_attention_q_offset", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:90",
        launches, errs, (2 * Sq * H + 2 * S * KVH) * hd * 2,
        4 * s_pairs * H * hd,
        lambda: device_ms([flash_sfx]),
        lambda: device_ms([lambda: fa.flash_attention_plain(
            qs, kf, vf, causal=True, chunk=256, q_offset=pre)], iters=10),
        lambda: library_ms(sdpa_sfx)))
    print(f"  flash suffix prefill (Sq={Sq}, Sk={S}, q_offset={pre}), eager "
          f"wall per call: {cuda_ms(flash_sfx):.4f} ms; SDPA with "
          f"causal_lower_right {cuda_ms(sdpa_sfx):.4f} ms", flush=True)
    for what, fn in (("is_causal", sdpa), ("causal_lower_right", sdpa_sfx)):
        print(f"  SDPA ({what}) device kernels: " + ", ".join(
            f"{n} {t:.1f} us" for n, t in _device_kernels(fn)), flush=True)
    print(f"  block copy launches on the tiered path (3b): {tier_launches}",
          flush=True)
    row_bytes = leaves[0][0, 0].numel() * leaves[0].element_size()
    moved = len(src) * len(leaves) * leaves[0].shape[0]
    si = torch.from_numpy(src).to(dev).long()
    di = torch.from_numpy(dst).to(dev).long()

    def index_copy():
        for leaf in leaves:
            leaf.index_copy_(1, di, leaf.index_select(1, si))
    rows.append(_row(
        "block_copy", "src/repro_torch/csrc/block_copy.cu",
        "src/repro/kernels/block_copy/kernel.py:26",
        launches, errs, 2 * moved * row_bytes, 0,
        lambda: device_ms([lambda: bc.block_copy(leaves, src, dst,
                                                 ptrs=ptrs)], iters=50),
        lambda: device_ms([lambda: bc.block_copy_plain(leaves, src, dst)],
                          iters=10),
        lambda: device_ms([index_copy], iters=50)))
    for r in rows:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, yardstick {r['library_ms']} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), roofline "
              f"share {r['bound_ms'] / r['ms']:.1%}", flush=True)

    # two size classes at the serving width, L2-cold over the same pools
    m_tok = int(multi[2].sum())
    m_bytes = m_tok * KVH * hd * 2 * 2 + mq.numel() * 2 * 2 \
        + sum(t.numel() * 8 for t in multi[0]) + 4 * 4 + 4 * 14 * 4
    m_ms = device_ms(per_layer(lambda pk, pv: pa.paged_decode_multi(
        mq, pk, pv, *multi, block_tokens=bt, orders=(0, 1))))
    m_plain = device_ms(per_layer(
        lambda pk, pv: pa.paged_decode_multi_plain(
            mq, pk, pv, *multi, block_tokens=bt, orders=(0, 1))), iters=30)
    m_bound = m_bytes / HBM_BYTES_PER_S * 1e3
    print(f"  paged_decode_multi (B=4, 8 one-block + 6 four-block pages per "
          f"row, {m_tok} tokens; 3 kernels): {m_ms:.4f} ms L2-cold, "
          f"plain {m_plain:.4f} ms, bound {m_bound:.4f} ms (bytes), roofline "
          f"share {m_bound / m_ms:.1%}", flush=True)
    print(f"  flash library SASS: "
          f"{_sass_count(build, 'flash_attention', 'HGMMA')} "
          f"HGMMA instructions (cuobjdump -sass)", flush=True)
    main_exec = EXEC_RUNS["phase 3"]
    rows.extend(_executor_timing(*exec_timed, eng.mm.hooks._hooks[
        "mm_fault"].pred, {"policy_exec": main_exec["predicated"],
                           "policy_exec_pc_walk": main_exec["pc_walk"]}))

    # ------------------------------------------------------------ 5, 5b
    # free deepseek-7b (13.8 GB of weights, its engines' pools) before the
    # 33 GB MoE model
    del params, eng, leaves, ptrs, pools, paged_kernel, paged_plain
    del index_copy, serve_main
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[5] model families at full width; {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated "
          f"from phases 1-4", flush=True)
    fam = _families_phase(gen, wrappers, engine_mod)
    rows.extend(_family_rows(gen, dev, fam, pa, fa))
    _print_rows(rows[-5:])

    # ------------------------------------------------------------ 6, 6b
    def mla_prefix(arch, cfg, params):
        return _prefix_phase(cfg, params, profile, wrappers, fa, tag="6",
                             new=16)
    fam = _families_phase(gen, wrappers, engine_mod, MLA_FAMILY,
                          after=mla_prefix)
    fam.update(_families_phase(gen, wrappers, engine_mod, ZOO_FAMILIES))
    rows.extend(_zoo_rows(gen, dev, fam, pa, fa, bc))
    _print_rows(rows[-6:])

    # ------------------------------------------------------------ 8
    del fam
    gc.collect()
    rows.extend(_phase8(gen, dev, pa))

    # ------------------------------------------------------------ 7, 7b, 7c
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = _training_phase(gen, dev, fa)
    bwd_rows = _bwd_rows(gen, dev, fa, train_launches)
    _print_rows(bwd_rows)
    rows.extend(bwd_rows)
    _trainer_phase(dev)

    # ------------------------------------------------------------ 9
    rows.extend(_phase9(gen, dev, fa, pa))
    _finish(rows, card)


# ---------------------------------------------------------------------------
# Phase 9: the dry-run's sharded programs (repro_torch.launch.dryrun)
# ---------------------------------------------------------------------------

# 9a: deepseek-7b at its widths, 8 of 30 layers (phase 7's cut), 4 gloo
# ranks on the card as a 2 x 2 ("data", "model") mesh: a [2, 448] prefill
# into a 512-token layout, one decode step per mode, one train step at
# 2 x 1024 from a resumed AdamW state (step 1, second moments nu0: the
# update stays linear in the gradient, so two runs' updates compare leaf
# by leaf), the learning rate 5e-4.  The update's limit (max |dP -
# dP_ref| / max |dP_ref| per leaf) lies between the sound readings and
# the control's on an H100 (seeds 0-3: worst leaf 1.806e-2, 1.940e-2,
# 2.311e-2, 1.947e-2, always in layer 0, the embedding 1.74-1.81e-2; the
# same again in a second process, and 0 between two one-process runs;
# the control 0.891-1.020): bf16 rounding of the two programs, not noise
# between runs.  The float32 run of the same step reads how much of that
# is bf16's.
SHARD = dict(layers=8, world=4, mesh=(2, 2), B=2, prompt=448, seq=512,
             train_batch=2, train_seq=1024, nu0=1e-4, base_lr=5e-4,
             update_tol=5e-2)
# 9b: rank 0 of the 256-rank production mesh, at full width and depth
PRODUCTION_CELLS = (("decode_32k", "flashdecode"), ("train_4k", "gather"))
# the kernels 9a's deepseek-7b must launch on every rank (MLA's latent
# decode, counted beside them, has no layer there)
KERNEL_COUNTERS = ("flash_attention", "flash_bwd_preprocess",
                   "flash_bwd_dkdv", "flash_bwd_dq", "paged_decode_attention",
                   "paged_decode_partials")


def _counters(fa, pa) -> dict:
    from repro_torch.kernels.mla_decode import ops as ma
    return {"flash_attention": fa.flash_attention,
            "flash_bwd_preprocess": fa.flash_bwd_preprocess,
            "flash_bwd_dkdv": fa.flash_bwd_dkdv,
            "flash_bwd_dq": fa.flash_bwd_dq,
            "paged_decode_attention": pa.paged_decode_attention,
            "paged_decode_partials": pa.paged_decode_partials,
            "paged_decode_mla": ma.paged_decode_mla}


def _zero_counts(fa, pa) -> None:
    for fn in _counters(fa, pa).values():
        fn.launches = 0


def _read_counts(fa, pa) -> dict:
    return {k: fn.launches for k, fn in _counters(fa, pa).items()}


def _sharded_params(spec, shardings, mesh, seed, dev):
    """``materialize(seed, spec)``'s float32 weights, each leaf drawn whole
    on this rank in materialize's order, cut to its DTensor shard (no
    communication: every rank draws the same leaf) and freed."""
    import math as m_
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.common import ParamSpec
    gen = torch.Generator(device=dev).manual_seed(seed)

    def leaf(p: ParamSpec, sh):
        if p.init in ("zeros", "ones"):
            full = (torch.zeros if p.init == "zeros" else torch.ones)(
                p.shape, dtype=torch.float32, device=dev)
        else:
            std = p.scale if p.scale is not None else 1.0 / m_.sqrt(max(
                1, m_.prod(p.shape[:-1]) if len(p.shape) > 1 else p.shape[0]))
            full = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                               device=dev).mul_(std)
        return distribute_tensor(full, mesh, sh.placements, src_data_rank=None)

    def walk(node, sh):
        if isinstance(node, ParamSpec):
            return leaf(node, sh)
        if isinstance(node, list):
            return [walk(n, s) for n, s in zip(node, sh)]
        return {k: walk(node[k], sh[k]) for k in sorted(node)}
    return walk(spec, shardings)


def _host_staged_all_gather(key: str = "CUDA"):
    """Route the functional all-gather (what DTensor issues to gather a
    shard) on ``key`` tensors through the host: the operand is copied to
    the CPU, gathered there on the same group (gloo on CPU tensors) and
    copied back.  Phase 9a's 4 ranks share one card over gloo (NCCL puts
    no two ranks on one device), and gloo's functional all-gather on CUDA
    tensors ends a rank with SIGSEGV on an H100 machine with torch 2.11
    (its all-reduce, reduce-scatter and all-to-all do not).  A gather
    delivers the same values either way.  Returns the library that
    holds the registration."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    def all_gather(x, n, name):
        g = _resolve_process_group(name) if isinstance(name, str) else name
        h = x.detach().to("cpu", copy=True).contiguous()
        out = h.new_empty((n * h.shape[0],) + tuple(h.shape[1:]))
        dist.all_gather_into_tensor(out, h, group=g)
        return out.to(x.device)

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", all_gather, key)
    return lib


def _shard_rank(rank: int, world: int, tmp: str, seed: int) -> None:
    """One rank of 9a; rank 0 then runs the unsharded programs alone and
    writes the comparison to ``tmp/9a.json``; every rank writes its kernel
    launch counts."""
    import dataclasses
    import datetime
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import Cell, make_cell, named
    from repro_torch.models import model_spec
    from repro_torch.optim.adamw import AdamWState, tree_leaves, tree_map
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    staged = _host_staged_all_gather()
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store9"), world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=300))
    mesh = init_device_mesh("cuda", SHARD["mesh"],
                            mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(get_config("deepseek_7b"),
                              n_layers=SHARD["layers"])
    B, S = SHARD["B"], SHARD["prompt"]
    dec = ShapeSpec("decode", SHARD["seq"], B, "decode")
    fd_cell = make_cell(cfg, dec, mesh, "flashdecode")
    g_cell = make_cell(cfg, dec, mesh, "gather")
    t_cell = make_cell(cfg, ShapeSpec("train", SHARD["train_seq"],
                                      SHARD["train_batch"], "train"), mesh)
    layout = fd_cell.layout
    rng = np.random.default_rng(seed)
    tabs = dryrun.placement_tables(fd_cell, mesh, B)
    host = {"prompt": rng.integers(1, cfg.vocab, (B, S)),
            "next": rng.integers(1, cfg.vocab, B),
            "train": rng.integers(1, cfg.vocab, (SHARD["train_batch"],
                                                 SHARD["train_seq"] + 1)),
            "table": tabs["block_table"], "sharded": tabs["sharded"],
            "logical": tabs["logical"],
            "lengths": np.full((B,), S, np.int64)}
    t = {k: torch.from_numpy(np.asarray(v).astype(np.int32)).to(dev)
         for k, v in host.items()}

    def shard(x, sh):
        return distribute_tensor(x, mesh, sh.placements, src_data_rank=None)

    def cache_of(cell):
        return dryrun.to_dtensors(cell.args[1], cell.in_shardings[1], mesh,
                                  lambda leaf, local: torch.zeros(
                                      local, dtype=leaf.dtype, device=dev))
    out = {"rank": rank, "stage_s": {}}
    t_last = [time.perf_counter()]

    def clock(stage):
        torch.cuda.synchronize()
        now = time.perf_counter()
        out["stage_s"][stage] = round(now - t_last[0], 3)
        t_last[0] = now
    spec = model_spec(cfg)
    params = _sharded_params(spec, fd_cell.in_shardings[0], mesh, seed, dev)
    clock("weights")
    _zero_counts(fa, pa)
    tsh = fd_cell.in_shardings[4]
    prefill = Cell(kind="prefill", args=(), in_shardings=(),
                   out_shardings=(named(mesh), fd_cell.in_shardings[1]),
                   layout=layout, meta={"extras": {}})
    (logits, cache), _ = dryrun.run_program(
        cfg, prefill, mesh, (params, cache_of(fd_cell),
                             shard(t["prompt"], tsh), shard(t["table"], tsh)))
    res = {"prefill": logits.full_tensor().float().cpu()}
    clock("prefill")
    for mode, cell in (("gather", g_cell), ("flashdecode", fd_cell)):
        sh = cell.in_shardings
        args = [params, tree_map(lambda c: c.clone(), cache)] + [
            shard(v, s) for v, s in zip(
                (t["next"], t["lengths"], t["table"], t["sharded"],
                 t["logical"]), sh[2:])]
        (logits, _, _), tr = dryrun.run_program(cfg, cell, mesh, tuple(args))
        res[mode] = logits.full_tensor().float().cpu()
        out[f"{mode}_collectives"] = tr.summary()["count_by_kind"]
    clock("decode x 2")
    del cache, args
    pt, ot, bt = t_cell.in_shardings
    step_kw = dict(base_lr=SHARD["base_lr"], warmup_steps=1)

    def train_step(params, dtype):
        """One train step at ``dtype`` from ``params`` (updated in place)
        and the resumed AdamW state: (params, loss, collectives)."""
        zeros = dryrun.to_dtensors(t_cell.args[1].mu, ot.mu, mesh,
                                   lambda leaf, local: torch.zeros(
                                       local, dtype=leaf.dtype, device=dev))
        nu = dryrun.to_dtensors(t_cell.args[1].nu, ot.nu, mesh,
                                lambda leaf, local: torch.full(
                                    local, SHARD["nu0"], dtype=leaf.dtype,
                                    device=dev))
        opt = AdamWState(step=shard(torch.ones((), dtype=torch.int32,
                                               device=dev), ot.step),
                         mu=zeros, nu=nu)
        batch = {"tokens": shard(t["train"], bt["tokens"])}
        (params, opt, metrics), tr = dryrun.run_program(
            cfg, t_cell, mesh, (params, opt, batch), compute_dtype=dtype,
            **step_kw)
        loss = metrics["loss"].full_tensor().item()
        torch.cuda.synchronize()
        return params, loss, tr.summary()["count_by_kind_and_axes"]

    def gather_update(params) -> list:
        """Each updated leaf, whole, to rank 0's host: the params replicate
        over "data", so the data-0 ranks gather their "model" shards
        alone."""
        updated = []
        if mesh.get_local_rank("data") != 0:
            return updated
        group = mesh.get_group("model")
        for p in tree_leaves(params):
            local = p.to_local().contiguous()
            dim = next((q.dim for n, q in zip(mesh.mesh_dim_names,
                                              p.placements)
                        if n == "model" and q.is_shard()), None)
            if dim is not None:
                m = mesh.size(1)
                whole = local.new_empty((m * local.shape[0],)
                                        + tuple(local.shape[1:]))
                dist.all_gather_into_tensor(whole, local, group=group)
                local = torch.cat(whole.chunk(m), dim=dim)
            updated.append(local.cpu() if rank == 0 else None)
            del local
        return updated

    params, res["loss"], out["train_collectives"] = train_step(
        params, torch.bfloat16)
    out["launches"] = _read_counts(fa, pa)
    clock("train step")
    updated = gather_update(params)
    clock("gather the update")
    # the float32 control: the same step on the same weights in float32
    del params
    torch.cuda.empty_cache()
    params = _sharded_params(spec, pt, mesh, seed, dev)
    params, res["loss_f32"], _ = train_step(params, torch.float32)
    updated_f32 = gather_update(params)
    clock("float32 train step")
    del params
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        out.update(_unsharded_9a(cfg, spec, layout, t, res, updated,
                                 updated_f32, step_kw, dev, seed))
        clock("one-process runs")
    Path(tmp, f"9a-{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()
    del staged


def _unsharded_9a(cfg, spec, layout, t, res, updated, updated_f32, step_kw,
                  dev, seed) -> dict:
    """Rank 0, the other ranks' memory freed: the one-process programs on
    the same weights and inputs, and the sharded results held to them.
    The update is read per leaf as max |dP - dP_ref| / max |dP_ref| (dP:
    the step's change of the params) for the sharded step, for the
    one-process step run again (its own run-to-run spread), for a
    control that must fail: the one-process step on the batch's first
    sequence alone (the update had one data shard's gradients been
    lost), and for the same sharded step in float32 against the
    one-process float32 step (how much of the bf16 reading is bf16's)."""
    from repro_torch.models import (cache_init, decode_step, materialize,
                                    prefill_step)
    from repro_torch.optim.adamw import AdamWState, tree_leaves, tree_map
    from repro_torch.training import make_train_step
    params = materialize(torch.Generator(device=dev).manual_seed(seed), spec,
                         device=dev)
    B = SHARD["B"]
    cache = cache_init(cfg, layout, B, torch.bfloat16, device=dev)
    logits, cache = prefill_step(params, cfg, cache, t["prompt"], t["table"],
                                 layout)
    out = {}

    def held(name, got, want):
        scale = max(1.0, want.abs().max().item())
        err = (got.float().to(dev) - want.float()).abs().max().item()
        out[name] = {"max_abs_err": err, "scale": scale,
                     "ok": bool(err <= 2e-2 * scale)}
    held("prefill logits", res["prefill"], logits)
    want, _, _ = decode_step(params, cfg, cache, t["next"], t["lengths"],
                             t["table"], layout)
    for mode in ("gather", "flashdecode"):
        held(f"decode logits ({mode})", res[mode], want)
    del cache
    names = _leaf_names(params)
    p0 = [x.clone() for x in tree_leaves(params)]
    train = make_train_step(cfg, **step_kw)

    def step(tokens, train=train):
        """One step from p0 and the resumed state; (loss, the leaves)."""
        for p, x in zip(tree_leaves(params), p0):
            p.copy_(x)
        opt = AdamWState(step=torch.ones((), dtype=torch.int32, device=dev),
                         mu=tree_map(torch.zeros_like, params),
                         nu=tree_map(lambda x: torch.full_like(
                             x, SHARD["nu0"]), params))
        _, _, metrics = train(params, opt, {"tokens": tokens})
        return metrics["loss"].item(), tree_leaves(params)

    loss, leaves = step(t["train"])
    d_ref = [(a - b).float() for a, b in zip(leaves, p0)]
    out["loss"] = {"sharded": res["loss"], "unsharded": loss,
                   "ok": bool(abs(res["loss"] - loss) <= 2e-2 * abs(loss))}

    def readings(new, d_ref=d_ref) -> list:
        return [((a.to(dev).float() - b.float()) - d).abs().max().item()
                / max(d.abs().max().item(), 1e-30)
                for a, b, d in zip(new, p0, d_ref)]
    rel = readings(updated)
    worst = max(range(len(rel)), key=rel.__getitem__)
    top = sorted(zip(rel, names), reverse=True)[:4]
    # where the worst leaf's worst element is, and (an embedding row) how
    # often its token occurs in the step's inputs
    diff = ((updated[worst].to(dev).float() - p0[worst].float())
            - d_ref[worst]).abs()
    at = np.unravel_index(int(diff.argmax()), tuple(diff.shape))
    where = {"leaf": names[worst], "index": [int(i) for i in at]}
    if names[worst] == "embed":
        where["token_count"] = int((t["train"][:, :-1] == int(at[0])).sum())
    again = max(readings(step(t["train"])[1]))
    c_loss, c_leaves = step(t["train"][:1])
    control = max(readings(c_leaves))
    tol = SHARD["update_tol"]
    out["update"] = {"leaves": len(p0), "worst_rel": rel[worst],
                     "top": top, "where": where, "again": again,
                     "control": control, "tol": tol,
                     "bad": [(n, r) for r, n in zip(rel, names)
                             if not r <= tol],
                     "ok": all(r <= tol for r in rel)}
    del d_ref, c_leaves, diff
    loss, leaves = step(t["train"], make_train_step(
        cfg, compute_dtype=torch.float32, **step_kw))
    d_ref = [(a - b).float() for a, b in zip(leaves, p0)]
    out["loss_f32"] = {"sharded": res["loss_f32"], "unsharded": loss,
                       "ok": bool(abs(res["loss_f32"] - loss)
                                  <= 2e-2 * abs(loss))}
    rel = readings(updated_f32, d_ref)
    out["update_f32"] = {"worst_rel": max(rel),
                         "top": sorted(zip(rel, names), reverse=True)[:4],
                         "bad": [(n, r) for r, n in zip(rel, names)
                                 if not r <= tol],
                         "ok": all(r <= tol for r in rel)}
    return out


def _sharded_phase(seed: int = SEED) -> dict:
    """9a (module docstring): spawn the ranks, read and check what they
    wrote; weights and inputs from ``seed``.  Returns rank 0's record."""
    import torch.multiprocessing as mp
    print(f"[9a] the sharded programs on a 2 x 2 mesh: {SHARD['world']} gloo "
          f"ranks on the one card; deepseek-7b {SHARD['layers']} of 30 layers "
          f"at full width; prefill [{SHARD['B']}, {SHARD['prompt']}], one "
          f"decode step per mode, one train step at {SHARD['train_batch']} x "
          f"{SHARD['train_seq']}; held to the one-process programs on the "
          f"same weights; seed {seed}", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.start_processes(_shard_rank, args=(SHARD["world"], tmp, seed),
                               nprocs=SHARD["world"], start_method="spawn")
        except Exception as e:          # a rank raised or died
            fail(f"phase 9a: {e}")
        recs = [json.loads(Path(tmp, f"9a-{r}.json").read_text())
                for r in range(SHARD["world"])]
    wall = time.perf_counter() - t0
    r0 = recs[0]
    for name in ("prefill logits", "decode logits (gather)",
                 "decode logits (flashdecode)"):
        v = r0[name]
        print(f"  {name}: max_abs_err {v['max_abs_err']:.4e} (tol 2e-2 x "
              f"{v['scale']:.3f})", flush=True)
        if not v["ok"]:
            fail(f"phase 9a: sharded {name} disagree with the unsharded")
    v = r0["loss"]
    print(f"  train loss: sharded {v['sharded']:.6f}, unsharded "
          f"{v['unsharded']:.6f} (tol 2e-2 relative)", flush=True)
    u = r0["update"]
    print(f"  train update: {u['leaves']} leaves, worst max|dP - dP_ref| / "
          f"max|dP_ref| {u['worst_rel']:.4e} (tol {u['tol']:g}); the worst "
          f"leaves {[(n, float(f'{r:.4e}')) for r, n in u['top']]}; the "
          f"worst element {u['where']}; the one-process step again "
          f"{u['again']:.4e}; the control (one data shard's gradients "
          f"lost) {u['control']:.4e}", flush=True)
    v32, u32 = r0["loss_f32"], r0["update_f32"]
    top32 = [(n, float(f"{r:.4e}")) for r, n in u32["top"]]
    print(f"  train update, float32 control of the same step: worst "
          f"{u32['worst_rel']:.4e} (tol {u['tol']:g}; bf16 "
          f"{u['worst_rel']:.4e}); the worst leaves {top32}; loss sharded "
          f"{v32['sharded']:.6f}, unsharded {v32['unsharded']:.6f}",
          flush=True)
    if not (v["ok"] and u["ok"]):
        fail(f"phase 9a: the sharded train step disagrees ({v}, {u['bad']})")
    if not (v32["ok"] and u32["ok"]):
        fail(f"phase 9a: the sharded float32 train step disagrees ({v32}, "
             f"{u32['bad']})")
    if not u["control"] > u["tol"]:
        fail(f"phase 9a: the control update passes the limit "
             f"({u['control']} <= {u['tol']}): the check cannot fail")
    print(f"  collectives (rank 0): gather decode "
          f"{r0['gather_collectives']}, flashdecode "
          f"{r0['flashdecode_collectives']}, train "
          f"{r0['train_collectives']}", flush=True)
    for r in recs:
        n = r["launches"]
        print(f"  rank {r['rank']} launches: {n}", flush=True)
        missing = [k for k in KERNEL_COUNTERS if n[k] <= 0]
        if missing:
            fail(f"phase 9a: rank {r['rank']} launched no {missing}")
    print(f"  phase 9a wall {wall:.1f}s (4 ranks sharing one card); rank "
          f"0's stages (s): {r0['stage_s']}", flush=True)
    return r0


def _production_phase(fa, pa) -> dict:
    """9b (module docstring).  Returns the launches and the local shapes of
    the cells' kernels."""
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.fakeworld import fake_world
    cfg = get_config("deepseek_7b")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[9b] rank 0 of the 256-rank production mesh (16 x 16), a fake "
          f"world (its collectives move nothing); deepseek-7b at full width "
          f"and depth; {card}", flush=True)
    launches = {}
    with fake_world() as mesh:
        for shape, attn in PRODUCTION_CELLS:
            meta = dryrun.trace_cell(cfg, SHAPES[shape], mesh, attn, "meta")
            torch.cuda.empty_cache()
            _zero_counts(fa, pa)
            rec = dryrun.trace_cell(cfg, SHAPES[shape], mesh, attn, "cuda",
                                    SEED)
            n = _read_counts(fa, pa)
            again = dryrun.trace_cell(cfg, SHAPES[shape], mesh, attn, "cuda",
                                      SEED)
            torch.cuda.empty_cache()
            prof = {}
            kernels = _device_kernels(lambda: prof.update(dryrun.trace_cell(
                cfg, SHAPES[shape], mesh, attn, "cuda", SEED)))
            torch.cuda.empty_cache()
            launches[shape] = n
            c, m = rec["collectives"], meta["collectives"]
            print(f"  {shape} ({attn}): peak HBM "
                  f"{rec['memory_analysis']['max_memory_allocated_bytes'] / 2**30:.2f} "
                  f"GiB; step wall {rec['trace_s']:.3f} s, again "
                  f"{again['trace_s']:.3f} s; clocks (SM, max SM, power, "
                  f"temperature) {_clocks()}", flush=True)
            print(f"    collectives by kind: counts {c['count_by_kind']}, "
                  f"bytes {c['bytes_by_kind']} (total "
                  f"{c['total_bytes'] / 1e9:.3f} GB per device per step); "
                  f"by kind and axis {c['count_by_kind_and_axes']}",
                  flush=True)
            print(f"    the meta trace: counts "
                  f"{m['count_by_kind_and_axes']}, bytes "
                  f"{m['bytes_by_kind']}; flops {rec['cost_analysis']['flops']:.4g} "
                  f"per device; launches {_nonzero(n)}", flush=True)
            print(f"    {_busy(kernels, again['trace_s'])} (the profiled "
                  f"step's wall {prof['trace_s']:.3f} s)", flush=True)
            if c["count_by_kind_and_axes"] != m["count_by_kind_and_axes"] or \
                    c["bytes_by_kind"] != m["bytes_by_kind"]:
                fail(f"phase 9b: {shape}'s collectives on the card differ "
                     f"from its meta trace")
            kern = ("paged_decode_partials",) if attn == "flashdecode" else \
                ("flash_attention", "flash_bwd_dkdv", "flash_bwd_dq")
            for k in kern:
                if n[k] <= 0:
                    fail(f"phase 9b: {shape} launched no {k}")
    return launches


def _rank_rows(gen, dev, fa, pa, launches) -> list:
    """The kernels at rank 0's local shapes of 9b's cells: flash forward
    (with LSE) and backward at train_4k's (B 16, S 4096, 2 of 32 heads x
    128), paged_decode_partials at decode_32k's (B 8 of 128, 32 x 128, 128
    slots of 16 tokens over a 1024-block shard)."""
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.distributed.flashdecode import owned_blocks
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import make_cell
    print("[9c] the kernels at rank 0's local shapes of 9b", flush=True)
    tr = launches["train_4k"]
    rows = _bwd_shape_rows(
        gen, dev, fa, "_rank_train_4k", (16, 4096, 4096, 2, 2, 128, 128,
                                         True, None),
        {"flash_bwd_preprocess": tr["flash_bwd_preprocess"],
         "flash_bwd_dkdv": tr["flash_bwd_dkdv"],
         "flash_bwd_dq": tr["flash_bwd_dq"],
         "flash_attention": tr["flash_attention"]})
    cfg = get_config("deepseek_7b")
    stub = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(16, 16))
    cell = make_cell(cfg, SHAPES["decode_32k"], stub, "flashdecode")
    tabs = dryrun.placement_tables(cell, stub, SHAPES["decode_32k"].global_batch)
    nb_loc = cell.layout.num_blocks // 256
    Bl, MBl = 8, cell.meta["sharded_tables"][1]
    table = owned_blocks(torch.from_numpy(tabs["sharded"][:Bl, 0]).to(dev), 0,
                         nb_loc)
    logical = torch.from_numpy(np.ascontiguousarray(
        tabs["logical"][:Bl, 0])).to(dev)
    lengths = torch.full((Bl,), SHAPES["decode_32k"].seq_len, dtype=torch.int32,
                         device=dev)
    rows.append(_partials_shape_row(
        gen, dev, pa, "paged_decode_partials_rank_decode_32k", table, logical,
        lengths, nb_loc, launches["decode_32k"]["paged_decode_partials"],
        layers=4, what="decode_32k"))
    _print_rows(rows)
    return rows


def _phase9(gen, dev, fa, pa) -> list:
    """Phase 9 with the parent's cached HBM freed first; its kernel rows."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _sharded_phase()
    launches = _production_phase(fa, pa)
    rows = _rank_rows(gen, dev, fa, pa, launches)
    print(f"  phase 9 wall {time.perf_counter() - t0:.1f}s", flush=True)
    return rows


def _finish(rows, card: str) -> None:
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _phase8(gen, dev, pa) -> list:
    """Phase 8 with the parent's cached HBM freed first, then its kernel
    row."""
    torch.cuda.empty_cache()
    launches = _dist_phase()
    if launches <= 0:
        fail("paged_decode_partials was not launched in phase 8a")
    rows = [_partials_row(gen, dev, pa, launches)]
    _print_rows(rows)
    return rows


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _ctx_rows(n: int, seed: int) -> np.ndarray:
    """Seeded policy ctx rows, every column in its real domain (the fault,
    tier and evict programs each read their own columns)."""
    from repro_torch.core.context import CTX, CTX_LEN
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 1000, (n, CTX_LEN)).astype(np.int64)

    def ri(lo, hi):
        return rng.integers(lo, hi, n)
    m[:, CTX.ADDR] = ri(0, 256)
    m[:, CTX.VMA_START] = 0
    m[:, CTX.VMA_END] = ri(8, 257)
    m[:, CTX.FAULT_MAX_ORDER] = ri(0, 4)
    m[:, CTX.HAS_PROFILE] = ri(0, 2)
    m[:, CTX.PROFILE_MAP_ID] = 0
    m[:, CTX.PROFILE_NREGIONS] = ri(0, 9)
    for o in range(4):
        m[:, CTX.FREE_BLOCKS_O0 + o] = ri(0, 3) * ri(0, 200)
    m[:, CTX.KTIME_NS] = ri(0, 10 ** 9)
    m[:, CTX.MEM_PRESSURE] = ri(0, 1001)
    m[:, CTX.NTIERS] = ri(1, 5)
    m[:, CTX.PAGE_TIER] = ri(0, 4) % m[:, CTX.NTIERS]
    m[:, CTX.PAGE_ORDER] = ri(0, 4)
    m[:, CTX.PAGE_AGE] = ri(0, 10)
    m[:, CTX.PAGE_HEAT] = ri(0, 3) * ri(0, 6000)
    m[:, CTX.TIER_FREE_BLOCKS] = ri(0, 3) * ri(0, 256)
    for t in range(4):
        m[:, CTX.MIG_CUM_SETUP_T0 + t] = t * ri(0, 5000)
        m[:, CTX.MIG_CUM_NS_T0 + t] = t * ri(100, 3000)
    m[:, CTX.CACHE_REFCOUNT] = ri(0, 3)
    m[:, CTX.CACHE_BLOCKS] = 1
    m[:, CTX.CACHE_CAP_BLOCKS] = ri(0, 16)
    m[:, CTX.CACHE_USED_BLOCKS] = ri(0, 32)
    m[:, CTX.PROF_REGION_START] = ri(0, 200)
    m[:, CTX.PROF_REGION_END] = m[:, CTX.PROF_REGION_START] + ri(1, 40)
    m[:, CTX.PROF_REGION_HEAT] = ri(0, 3) * ri(0, 9000)
    m[:, CTX.PROF_REGION_AGE] = ri(0, 12)
    m[:, CTX.PROF_MAPPED_BLOCKS] = ri(0, 257)
    m[:, CTX.PROF_WINDOW] = ri(0, 20)
    return m


def _edge_rows(seed: int) -> np.ndarray:
    """16 ctx rows of raw int64 extremes (INT64_MIN / MAX, 0, +-1, -7,
    shift counts, wide values) in every column but the promotion-cost
    helper's calibrated constants, which keep their real domain (its
    product would pass 2^63, where the interpreter's Python ints and every
    int64 executor part)."""
    from repro_torch.core.context import CTX, CTX_LEN
    rng = np.random.default_rng(seed)
    lo, hi = -(1 << 63), (1 << 63) - 1
    pool = np.array([lo, lo + 1, hi, hi - 1, 0, 1, -1, -7, 7, 63, 64, 65,
                     -64, 1 << 40, -(1 << 40)], dtype=np.int64)
    m = pool[rng.integers(0, len(pool), (16, CTX_LEN))]
    m[:4] = rng.integers(-(1 << 62), 1 << 62, (4, CTX_LEN))
    m[:, CTX.ZERO_NS_PER_BLOCK] = rng.integers(100, 2000, 16)
    m[:, CTX.COMPACT_NS_PER_BLOCK] = rng.integers(100, 4000, 16)
    for o in range(4):
        m[:, CTX.FRAG_O0 + o] = rng.integers(0, 1001, 16)
    return m


def _alu_edge_program():
    """Every ALU op, reg and imm forms, over ctx operands the edge rows set
    to the int64 extremes, folded into r0 and emitted as a ring event."""
    from repro_torch.core import CTX, HELPER_TRACE, Asm
    a = Asm()
    a.ldctx("r6", CTX.ADDR)
    a.ldctx("r7", CTX.PID)
    a.movi("r0", 0)
    for op in ("add", "sub", "mul", "div", "mod", "and_", "or_", "xor",
               "lsh", "rsh", "min_", "max_"):
        name = op.rstrip("_")
        for imm in (-7, 13, -1 if name in ("div", "mod") else 0):
            a.mov("r1", "r6")
            getattr(a, op)("r1", "r7")
            a.xor("r0", "r1")
            a.mov("r2", "r6")
            getattr(a, name + "i")("r2", imm)
            a.add("r0", "r2")
    a.mov("r1", "r6")
    a.neg("r1")
    a.xor("r0", "r1")
    a.mov("r1", "r0")
    a.call(HELPER_TRACE)
    a.exit()
    return a.build("alu_edges")


def _executor_phase() -> tuple:
    """The policy-program kernel on both routes (the predicated executor's
    unroll, the pc walk's looped code) against the host interpreter and
    against its plain version on the same CUDA inputs, bit for bit, and
    profile reloads between batches.  Returns the executors phase 4 times
    and the rows."""
    from repro_torch.core import (ArrayMap, JitPolicy, MapRegistry, PolicyVM,
                                  PredicatedPolicy, Profile, ProfileRegion,
                                  ebpf_mm_program, evict_lru_program,
                                  profile_wss_program, tier_damon_program)
    from repro_torch.core.profiles import MAX_PROFILE_REGIONS
    from repro_torch.kernels.policy_exec import ops as pe
    print("[2b] the policy-program kernel (csrc/policy_exec.cu, one launch "
          "a batch) on both routes vs the host interpreter PolicyVM and vs "
          "its plain version on the card", flush=True)
    maps = MapRegistry()
    m = ArrayMap(MAX_PROFILE_REGIONS * 6)
    bounds = np.linspace(0, 256, 9).astype(int)
    Profile("chat", [ProfileRegion(int(a), int(b), (0, 150_000, 600_000, 0)
                                   if i % 2 == 0 else (0, 0, 0, 0))
                     for i, (a, b) in enumerate(zip(bounds, bounds[1:]))]
            ).load_into(m)
    maps.register(m)
    progs = {"fig1_r8": ebpf_mm_program(max_regions=8),
             "fig1_r64": ebpf_mm_program(max_regions=64),
             "fig1_r8_traced": ebpf_mm_program(max_regions=8, trace=True),
             "tier_damon": tier_damon_program(),
             "evict_lru": evict_lru_program(),
             "profile_wss": profile_wss_program(),
             "alu_edges": _alu_edge_program()}
    rows = _ctx_rows(64, SEED + 1)
    edges = np.concatenate([rows, _edge_rows(SEED + 2)])
    _ptxas_check()
    flat, meta = pe.DeviceMaps(maps, torch.device("cuda")).flat()
    print(f"  maps: {meta.shape[1]} map, {flat.numel() * 8} bytes of values "
          f"and {meta.numel() * 8} of offsets and lengths (phases 3-3f load "
          f"profiles of this size)", flush=True)

    def interpreted(prog, mat):
        vm = PolicyVM(prog, maps)
        res = [vm.run(r) for r in mat]
        return (np.asarray([r.ret for r in res], np.int64),
                [e for r in res for e in r.events],
                sum(r.dropped for r in res))
    timed = {}
    for name, prog in progs.items():
        mat = edges if name == "alu_edges" else rows
        want, want_ev, want_drops = interpreted(prog, mat)
        ctx = torch.from_numpy(mat).cuda()
        for route, cls in (("predicated", PredicatedPolicy),
                           ("pc walk", JitPolicy)):
            ex = cls(prog, maps, device="cuda")
            out = ex._launch(ctx)
            flat, meta = ex._maps_dev.flat()
            kw = dict(rb_cap=ex.rb_cap, fuel=ex._fuel,
                      halt_returns_r0=ex._halt_returns_r0)
            plain = pe.policy_exec_plain(ex._table, ctx, flat, meta, **kw)
            torch.cuda.synchronize()
            n = pe.policy_exec.launches
            got = ex.run_batch(mat)
            events, drops = ex.take_events(len(mat))
            bad = int((got != want).sum())
            plan = pe.stage_plan(ex._table.shape[0], len(mat), flat.numel(),
                                 meta.shape[1])
            print(f"  {name}, {route}: {ex._table.shape[0]} insns, "
                  f"{len(mat)} rows ({plan.smem_bytes} bytes of shared "
                  f"memory a block, the table "
                  f"{'staged' if plan.table >= 0 else 'in place'}, the maps "
                  f"{'staged' if plan.maps >= 0 else 'in place'}): "
                  f"{len(mat) - bad}/{len(mat)} decisions, "
                  f"{len(events)} ring events and {drops} drops equal the "
                  f"interpreter's; every output word equals the plain "
                  f"version's: {torch.equal(out, plain)}; "
                  f"launches per run_batch {pe.policy_exec.launches - n}",
                  flush=True)
            if (bad or list(events) != list(want_ev) or drops != want_drops
                    or not torch.equal(out, plain)
                    or pe.policy_exec.launches != n + 1):
                fail(f"the policy_exec kernel disagrees on {name} "
                     f"({route})")
            if route == "predicated" and name in ("fig1_r8", "fig1_r64",
                                                  "profile_wss"):
                timed[name] = ex
            elif name == "fig1_r8":
                timed["fig1_r8_pc_walk"] = ex
    _reload_check()
    return timed, rows


def _ptxas_check() -> None:
    """Print ptxas's report for each instance of the policy kernel (table
    staged, maps staged) from the build log; fail on a stack frame or a
    spill."""
    from repro_torch.kernels import build
    log = (build._build_dir() / "policy_exec.log").read_text().splitlines()
    seen = 0
    for i, line in enumerate(log):
        m = re.search(r"Function properties for (\w*policy_exec_kernel\w*)",
                      line)
        if m:
            name = m[1]
            frame = [int(x) for x in re.findall(r"(\d+) bytes",
                                                   log[i + 1])]
            used = next((ln for ln in log[i + 1:i + 4] if "Used" in ln), "")
            flags = re.search(r"ILb(\d)ELb(\d)E", name)
            print(f"  ptxas, policy_exec_kernel<table staged {flags[1]}, maps "
                  f"staged {flags[2]}>: {log[i + 1].strip()}; "
                  f"{used.split(':', 1)[-1].strip()}", flush=True)
            if any(frame):
                fail(f"ptxas: {name} has a stack frame or spills "
                     f"({log[i + 1].strip()})")
            seen += 1
    if seen != 4:
        fail(f"ptxas reported {seen} of the policy kernel's 4 instances")


def _reload_check() -> None:
    """Profile reloads (``mm.load_profile``: a map write, the path the
    online profiler's hot reloads take) between ``run_batch`` calls: the
    CUDA executors' device copies of the maps must follow each reload."""
    from repro_torch.core import (FaultKind, HWSpec, JitPolicy,
                                  MemoryManager, PolicyVM, Profile,
                                  ProfileRegion, ebpf_mm_program,
                                  make_cost_model)
    from repro_torch.core.hooks import HOOK_FAULT
    mm = MemoryManager(256, make_cost_model(HWSpec(), kv_heads=32,
                                            head_dim=128), device="cuda")
    mm.load_profile(Profile("chat", []))
    prog = ebpf_mm_program(max_regions=8)
    mm.attach_fault_program(prog)
    mm.create_process(1, app="chat", vma_blocks=64)
    jit = JitPolicy(prog, mm.maps, device="cuda")
    reqs = [(1, a, FaultKind.FIRST_TOUCH) for a in range(0, 64, 3)]
    seen = []
    from repro_torch.kernels.policy_exec import ops as pe
    launched = pe.policy_exec.launches
    for hot in (None, (0, 24), (32, 64)):
        if hot is not None:
            mm.load_profile(Profile("chat", [ProfileRegion(
                *hot, (0, 150_000, 600_000, 2_500_000))]))
        mat = mm._build_ctx_batch(reqs)
        vm = PolicyVM(prog, mm.maps)
        want = np.asarray([vm.run(r).ret for r in mat], np.int64)
        got = mm.hooks.run_batch(HOOK_FAULT, mat)
        if (got != want).any() or (jit.run_batch(mat) != want).any():
            fail(f"after reload {hot}, the CUDA executors' fault decisions "
                 f"differ from the interpreter's")
        seen.append(want.tolist())
    if seen[0] == seen[1] or seen[1] == seen[2]:
        fail("the profile reloads changed no fault decision")
    if pe.policy_exec.launches != launched + 6:
        fail("the reload check's batches did not each launch policy_exec")
    print(f"  two profile reloads between run_batch calls: the kernel on "
          f"both routes follows each ({len(reqs)} "
          f"faults, decisions {seen[0][:6]} -> {seen[1][:6]} -> "
          f"{seen[2][:6]} ...)", flush=True)


def _executor_timing(timed: dict, rows, main_exec, launches: dict) -> list:
    """Phase 4's executor rows: per program and batch bucket, the kernel's
    device time (CUDA events around a CUDA graph of 20 calls) and wall per
    ``run_batch`` (numpy in, numpy out), beside the eager body's device
    time (``torch.profiler``) and wall on the same CUDA inputs; an empty
    kernel's launch on the same stream as the latency floor.  Returns the
    kernel's JSON rows: the main path's fault executor at phase 3's bucket
    (predicated route) and the pc walk at bucket 64, each with its
    difference from the plain version on the executor and rows it
    times (fails unless 0)."""
    from repro_torch.kernels.policy_exec import ops as pe
    print("  policy_exec: an empty kernel on the same stream (the latency "
          "floor):", flush=True)
    floor = event_ms(pe.empty_launch)
    floor_eager = cuda_ms(pe.empty_launch, iters=200)
    print(f"    empty kernel {floor:.5f} ms device (graph), {floor_eager:.5f}"
          f" ms per eager launch", flush=True)

    def eager_batch(ex, mat):
        r0, rb = ex._run_eager(torch.from_numpy(mat).cuda())
        return r0.cpu().numpy(), rb and [t.cpu() for t in rb]

    def wall(fn, n: int = 20) -> float:
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3

    def one(ex, mat, what: str, earlier=None) -> dict:
        ctx = torch.from_numpy(mat).cuda()
        t = {"kernel_ms": event_ms(lambda: ex.run_batch_device(ctx)),
             "kernel_wall_ms": wall(lambda: ex.run_batch(mat)),
             "eager_ms": device_ms([lambda: ex._run_eager(ctx)], iters=10,
                                   warmup=2),
             "eager_wall_ms": wall(lambda: eager_batch(ex, mat), 5)}
        print(f"    {what} bucket {len(mat)}: kernel {t['kernel_ms']:.5f} ms "
              f"device (earlier {earlier or '-'} ms), "
              f"{t['kernel_wall_ms']:.4f} ms wall per run_batch; "
              f"eager body {t['eager_ms']:.4f} ms device, "
              f"{t['eager_wall_ms']:.3f} ms wall", flush=True)
        return t
    print("  policy_exec per run_batch (device ms, wall ms), and the eager "
          "body's; earlier: the kernel before its redesign, on an H100 "
          "(PERF.md)", flush=True)
    for name, ex in timed.items():
        for bucket in ((4, 8, 16, 32, 64) if name == "fig1_r8"
                       else (4, 16, 64)):
            one(ex, rows[:bucket], f"{name} ({ex._table.shape[0]} insns)",
                EXEC_EARLIER.get((name, bucket)))
    _step_cost(rows)

    def row(name, replaces, ex, mat, t) -> dict:
        ctx = torch.from_numpy(mat).cuda()
        flat, meta = ex._maps_dev.flat()
        got = ex._launch(ctx)
        plain = pe.policy_exec_plain(ex._table, ctx, flat, meta,
                                     rb_cap=ex.rb_cap, fuel=ex._fuel,
                                     halt_returns_r0=ex._halt_returns_r0)
        err = int((got - plain).abs().max())
        print(f"  {name}: {len(mat)} rows, every output word vs the plain "
              f"version: max |d| {err}", flush=True)
        if err:
            fail(f"{name}: the kernel differs from its plain version on the "
                 f"executor it times")
        byts = 8 * (mat.size + flat.numel() + meta.numel()
                    + ex._table.numel()
                    + len(mat) * (3 + 5 * ex.rb_cap))
        # the int64 instructions the lanes run over any peak rate are
        # under a nanosecond: the bound is the bytes
        return _row(name, "src/repro_torch/csrc/policy_exec.cu", replaces,
                    launches, {name: float(err)}, byts, 0,
                    lambda: t["kernel_ms"], lambda: t["eager_ms"], None)
    main_rows = _ctx_rows(4, SEED + 5)
    print("  the main path's fault executor (phase 3's program and maps):",
          flush=True)
    t = one(main_exec, main_rows, "phase 3's mm_fault",
            EXEC_EARLIER[("main", 4)])
    _wall_trace(main_exec, main_rows)
    out = [row("policy_exec", "src/repro/core/predicate.py:297", main_exec,
               main_rows, t)]
    jit = timed["fig1_r8_pc_walk"]
    t = one(jit, rows, "fig1_r8 pc walk", EXEC_EARLIER[("pc_walk", 64)])
    out.append(row("policy_exec_pc_walk", "src/repro/core/jit.py:49", jit,
                   rows, t))
    for r in out:
        print(f"  {r['name']}: kernel {r['ms']:.5f} ms, bound "
              f"{r['bound_ms']:.6f} ms (bytes), {r['bound_ms'] / r['ms']:.2%}"
              f" of it; the empty launch {floor:.5f} ms", flush=True)
    print(f"  policy_exec launches by run: {json.dumps(EXEC_RUNS)}",
          flush=True)
    return out


def _wall_trace(ex, mat, n: int = 100) -> None:
    """Where a ``run_batch`` wall goes, from ``torch.profiler``'s trace of
    ``n`` real calls (CPU and CUDA activity): per call, the host's time in
    each CUDA runtime call the trace shows, the rest of the host's time
    (Python, numpy, the pinned-buffer copies; a runtime call the trace
    misses), which add up to the profiled wall, and the device's copies
    and kernel."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        ex.run_batch(mat)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            ex.run_batch(mat)
        wall = (time.perf_counter() - t0) / n * 1e3
    host: dict = {}
    dev: dict = {}
    for e in prof.events():
        us = e.time_range.elapsed_us()
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = re.sub(r"^void |\(anonymous namespace\)::", "",
                          e.name).split("<")[0].split("(")[0]
            dev[name] = dev.get(name, 0.0) + us
        elif e.name.startswith("cuda") and not e.cpu_children:
            host[e.name] = host.get(e.name, 0.0) + us
    host = {k: v / n / 1e3 for k, v in sorted(host.items())}
    dev = {k: v / n / 1e3 for k, v in sorted(dev.items())}
    rest = wall - sum(host.values())
    print(f"    run_batch's wall under torch.profiler, mean of {n} calls: "
          f"{wall:.4f} ms = CUDA runtime calls "
          f"{ {k: round(v, 4) for k, v in host.items()} } + the rest of "
          f"the host's time {rest:.4f} ms; on the device "
          f"{ {k: round(v, 4) for k, v in dev.items()} or 'not measured'}",
          flush=True)


def _step_cost(rows) -> None:
    """What one interpreted step costs: programs of 400 rows of one kind
    (ADDI and JEQI, which the kernel's straight inner loop runs; LDCTXR, a
    rare row, which the outer loop runs) at bucket 4: device ms per launch
    (CUDA events around a CUDA graph) and ns per row over the same program
    with no rows."""
    from repro_torch.core import CTX, Asm, MapRegistry, lower
    from repro_torch.kernels.policy_exec import ops as pe
    maps = MapRegistry()
    flat, meta = pe.DeviceMaps(maps, torch.device("cuda")).flat()
    ctx = torch.from_numpy(rows[:4]).cuda()
    step = {"addi": lambda a: a.addi("r1", 3),
            "jeqi": lambda a: a.jeqi("r1", -5, "end"),
            "ldctxr": lambda a: a.ldctxr("r1", "r2")}

    def chain(kind: str, n: int):
        a = Asm()
        a.ldctx("r1", CTX.ADDR)
        a.movi("r2", 7)
        for _ in range(n):
            step[kind](a)
        a.label("end")
        a.mov("r0", "r1")
        a.exit()
        return pe.pack_code(lower(a.build(f"{kind}_{n}"), maps).insns).cuda()

    def ms(table) -> float:
        return event_ms(lambda: pe.policy_exec(
            table, ctx, flat, meta, rb_cap=0, fuel=table.shape[0],
            halt_returns_r0=True))
    print("  policy_exec step cost, 400 rows of one kind at bucket 4:",
          flush=True)
    base = ms(chain("addi", 0))
    for kind in step:
        t = ms(chain(kind, 400))
        print(f"    {kind}: {t:.5f} ms, {(t - base) / 400 * 1e6:.1f} ns a "
              f"row (no rows: {base:.5f} ms)", flush=True)


def _recording(engine_mod, moves: list):
    real = engine_mod.block_copy

    def rec(leaves, src, dst, **kw):
        moves.append(len(src))
        real(leaves, src, dst, **kw)
    engine_mod.block_copy = rec
    return real


def _zero_exec() -> None:
    """Set policy_exec's launch counts (all, and the JIT route's) to 0."""
    from repro_torch.kernels.policy_exec import ops as pe
    pe.policy_exec.launches = pe.policy_exec.pc_walk_launches = 0


def _exec_launches(hooks, what: str, *, batched: bool = True) -> int:
    """The policy_exec launches of a serving run, counted from just after
    its engine's construction (whose warm-up batches are no hook batch
    calls): fail unless there is one per hook batch call, and at least one
    on the batched fault route.  Records them by route in ``EXEC_RUNS``."""
    from repro_torch.kernels.policy_exec import ops as pe
    n, walk = pe.policy_exec.launches, pe.policy_exec.pc_walk_launches
    calls = sum(hooks.batch_calls.values())
    print(f"  {what}: {n} policy_exec launches ({walk} on the JIT route) "
          f"for {calls} hook batch calls ({_nonzero(hooks.batch_calls)})",
          flush=True)
    if n != calls or (batched and n == 0):
        fail(f"{what}: {n} policy_exec launches for {calls} hook batch "
             f"calls")
    EXEC_RUNS[what] = {"predicated": n - walk, "pc_walk": walk}
    return n


def _contained(hooks, what: str) -> None:
    """Fail when the policy supervisor struck or detached any program: a
    batch executor that raises on the card costs a strike and falls the
    whole batch back to the default, which the run would otherwise hide."""
    snap = hooks.supervisor.snapshot()
    bad = {h: (v["strikes"], v["detaches"]) for h, v in snap.items()
           if isinstance(v, dict) and (v["strikes"] or v["detaches"])}
    if bad or snap["detaches"]:
        fail(f"{what}: policy supervisor (strikes, detaches) {bad}")


def _serve_tiered(cfg, params, check: bool = True, **kw):
    """Phase 3b's workload: 128 HBM + 384 host blocks of 16 tokens
    (``ebpf-tier``), 6 requests of prompt 448 + 128 new, ``max_batch`` 6,
    served on a fresh engine with ``kw``.  Returns (engine, run() output,
    serve wall)."""
    from repro_torch.core import Profile, ProfileRegion
    from repro_torch.models import PagedLayout
    from repro_torch.serving import Request, ServingEngine
    layout = PagedLayout(num_blocks=128, block_tokens=16, max_blocks=48)
    profile = Profile("chat", [
        ProfileRegion(0, 8, (0, 150_000, 600_000, 2_500_000)),   # hot
        ProfileRegion(8, 48, (0, 0, 0, 0))])                      # cold
    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(1, cfg.vocab, 448).tolist() for _ in range(6)]
    batched = kw.get("batch_faults", True)
    what = (f"phase {'3e' if 'chaos' in kw else '3b'}, "
            f"{'batched' if batched else 'scalar'} route"
            + (f", chaos rate {kw['chaos_rate']}" if "chaos_rate" in kw
               else ""))
    eng = ServingEngine(cfg, params, layout, max_batch=6, policy="ebpf",
                        profile=profile, seed=SEED, host_blocks=384,
                        tier_policy="ebpf-tier", **kw)
    _zero_exec()                           # after the engine's warm-up
    for rid in range(6):
        eng.submit(Request(rid=rid, prompt=prompts[rid],
                           max_new_tokens=128, app="chat"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run(max_steps=1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if check:
        _exec_launches(eng.mm.hooks, what, batched=batched)
    return eng, out, wall


def _graph_launches(eng, launches: dict, per_step: int, what: str,
                    per_adm: int | None = None, per_step_mla: int = 0
                    ) -> None:
    """The engine decoded through its captured graph, and each decode step
    (a replay, which calls no wrapper) added ``per_step`` paged launches
    and ``per_step_mla`` latent-decode launches (``paged_decode_mla``); it
    prefilled through its prefill graphs (one per padded shape, each
    captured at its first admission), and with ``per_adm`` each admission
    added that many flash launches."""
    if eng._decode.graph is None:
        fail(f"{what}: the engine decoded without its CUDA graph")
    steps = eng._decode.calls
    paged = launches["paged_decode_attention"]
    if steps <= 0 or paged != per_step * steps:
        fail(f"{what}: {paged} paged launches over {steps} decode steps, "
             f"not {per_step} a step")
    latent = launches.get("paged_decode_mla", 0)
    if latent != per_step_mla * steps:
        fail(f"{what}: {latent} latent-decode launches over {steps} decode "
             f"steps, not {per_step_mla} a step")
    graphs = eng._prefill.graphs
    if not graphs or any(g is None for g in graphs.values()):
        fail(f"{what}: the engine prefilled without its CUDA graphs "
             f"({graphs})")
    admissions = eng._prefill.calls
    flash = launches["flash_attention"]
    if per_adm is not None and flash != per_adm * admissions:
        fail(f"{what}: {flash} flash launches over {admissions} admissions, "
             f"not {per_adm} an admission")
    print(f"  {what}: paged launches {paged} = {per_step} x {steps} decode "
          f"steps (graph replays), latent-decode launches {latent} = "
          f"{per_step_mla} x {steps}; {admissions} admissions through "
          f"{len(graphs)} prefill graphs {sorted(graphs)}, flash launches "
          f"{flash}", flush=True)


def _graph_phase(serve_main, eng, out, params) -> None:
    """[3h] Phase 3's requests with ``trace=True`` through the captured
    decode graph: serve wall, decode ms a step (the decode span over the
    steps), per-token p50; tokens and MMStats equal phase 3's.  Then one
    replay's device time by CUDA events against the weight-read bound, the
    capture's time and pool, and the LM head's product
    (:func:`_head_times`)."""
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    bound = weights / HBM_BYTES_PER_S * 1e3
    print("[3h] the decode entry: one CUDA graph per engine, phase 3's "
          "requests with trace=True", flush=True)
    from repro_torch.models.common import head_logits
    head_logits.launches = 0
    e, o, wall, launches = serve_main(label="3h", trace=True)
    steps = e._decode.calls
    if head_logits.launches != steps + e._prefill.calls:
        fail(f"3h: {head_logits.launches} LM head launches, not one for "
             f"each of {steps} decode steps and {e._prefill.calls} "
             f"admissions")
    tot = _span_totals(e.telemetry.spans)
    p50 = e.telemetry.snapshot()["decode_token_ns"]["p50"]
    print(f"  serve wall {wall:.4f} s, decode "
          f"{tot['decode'] * 1e3 / steps:.4f} ms a step ({steps} steps, "
          f"span total {tot['decode']:.4f} s of step {tot['step']:.4f} s), "
          f"per-token p50 {p50 / 1e6:.4f} ms", flush=True)
    if e.finished != eng.finished or o["mm"] != out["mm"]:
        fail("3h: tokens or MMStats differ from phase 3's")
    if e._decode.graph is None or any(
            g is None for g in e._prefill.graphs.values()):
        fail("3h: the entries did not run as CUDA graphs")
    if launches["paged_decode_attention"] != 30 * steps:
        fail(f"3h: {launches['paged_decode_attention']} paged launches, not "
             f"30 x {steps}")
    g = e._decode
    replay = cuda_ms(g.graph.replay, iters=20, warmup=3)
    print(f"  one replay (the last step's inputs: 4 rows of 510 tokens) "
          f"{replay:.4f} ms by CUDA events over 20 replays; weight-read "
          f"bound {bound:.4f} ms ({weights / 1e9:.2f} GB over 3.35 TB/s); "
          f"capture {g.capture_s:.4f} s (3 warm-up calls and the capture), "
          f"graph pool {g.pool_bytes / 1e9:.3f} GB; launches per replay "
          f"{_per_replay(g)}", flush=True)
    del e, g
    _head_times(params)
    print("  tokens and MMStats equal phase 3's, 30 paged launches a decode "
          "step", flush=True)


def _head_times(params) -> None:
    """The LM head's product at a full decode batch's 32 rows and at an
    admission's one (``common.head_logits``: one bf16 product, float32 out)
    beside its byte bound (the bf16 head read once) and the float32 route
    (``x.float() @ head.float()``: the head cast to a float32 copy, then a
    float32 product), by CUDA events around a graph of 20 calls."""
    from repro_torch.models.common import head_logits
    head = params["lm_head"]
    bound = head.numel() * head.element_size() / HBM_BYTES_PER_S * 1e3
    g = torch.Generator(device=head.device).manual_seed(SEED)
    for M in (32, 1):
        x = torch.randn(M, head.shape[0], generator=g,
                        device=head.device).to(head.dtype)
        ms = event_ms(lambda: head_logits(x, head))
        f32 = event_ms(lambda: x.float() @ head.float())
        print(f"  LM head product, {M} row(s) x {tuple(head.shape)} "
              f"{head.dtype}: {ms:.4f} ms, {bound / ms:.1%} of its "
              f"{bound:.4f} ms byte bound ({head.numel() * 2 / 1e9:.4f} GB "
              f"over 3.35 TB/s); the float32 route (cast and product) "
              f"{f32:.4f} ms", flush=True)


# phase 3i: prompt lengths of one round (28, 19, 9 and 1 blocks of 16) and
# each request's new tokens
PREFILL_ROUND = (448, 300, 130, 16)
PREFILL_NEW = 8


def _prefill_bound(cfg, params, S: int) -> tuple[float, float]:
    """(flops, bytes) one prefill of ``S`` tokens needs at least: the
    layers' products (2 x params x S), causal attention (4 x S(S+1)/2 x H x
    hd a layer) and the last row's head product; each layer weight and the
    head read once (the head's product reads it in bf16 and writes no
    float32 copy of it: ``common.head_logits``)."""
    layer = sum(t.numel() for t in _leaves(params["blocks"]))
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    n_attn = sum(1 for k in cfg.layer_kinds() if k == "a")
    flops = (2 * layer * S + 4 * S * (S + 1) // 2 * cfg.n_heads
             * cfg.head_dim * n_attn + 2 * head.numel())
    byts = 2 * layer + 2 * head.numel()
    return flops, byts


def _prefill_graph_phase(cfg, params, layout, profile) -> None:
    """[3i] The prefill entries: deepseek-7b, ``max_batch=4``, ``policy=
    "ebpf"`` with khugepaged, two rounds on one engine of four requests of
    PREFILL_ROUND's prompt lengths, so round 1 captures one graph per
    length and round 2 only replays.  Prints, per length, the prefill ms
    per admission in each round (round 1's capture apart) and each round's
    TTFT p50; then per length one replay's device time by CUDA events
    beside the bound, the capture's time and the reserved memory it added
    (an engine's prefill graphs share one pool)."""
    from repro_torch.serving import Request, ServingEngine
    print(f"[3i] the prefill entries: one CUDA graph per padded length, two "
          f"rounds of prompts {PREFILL_ROUND} + {PREFILL_NEW} new on one "
          f"engine", flush=True)
    rng = np.random.default_rng(SEED + 6)
    rounds = [[rng.integers(1, cfg.vocab, n).tolist() for n in PREFILL_ROUND]
              for _ in range(2)]
    e = ServingEngine(cfg, params, layout, max_batch=4, policy="ebpf",
                      profile=profile, seed=SEED)
    timed: list = []
    real_full, real_run = e._prefill.full, e._run_prefill

    def full(prompt, slot):
        t = time.perf_counter()
        logits = real_full(prompt, slot)
        timed.append((len(prompt), time.perf_counter() - t))
        return logits
    e._prefill.full = full
    ttft: dict = {}
    t_round = [0.0]

    def run_prefill(seq):
        real_run(seq)
        ttft[seq.req.rid] = time.perf_counter() - t_round[0]
    e._run_prefill = run_prefill
    captured = set()
    for rnd, prompts in enumerate(rounds):
        torch.cuda.synchronize()
        t_round[0] = time.perf_counter()
        for i, p in enumerate(prompts):
            e.submit(Request(rid=4 * rnd + i, prompt=p,
                             max_new_tokens=PREFILL_NEW, app="chat"))
        o = e.run(max_steps=200)
        line = []
        for n, sec in timed[4 * rnd:4 * rnd + 4]:
            key = ("full", -(-n // layout.block_tokens))
            g = e._prefill.graphs.get(key)
            cap = g.capture_s if (g is not None and key not in captured) \
                else 0.0
            captured.add(key)
            line.append(f"{n}: {(sec - cap) * 1e3:.4f} ms"
                        + (f" (+ capture {cap:.4f} s)" if cap else ""))
        p50 = float(np.median([ttft[4 * rnd + i] for i in range(4)]))
        print(f"  round {rnd + 1}: prefill per admission "
              + ", ".join(line) + f"; TTFT p50 {p50 * 1e3:.4f} ms",
              flush=True)
    if o["engine"]["completed"] != 8 or e._prefill.calls != 8:
        fail(f"3i: {o['engine']['completed']} completed, "
             f"{e._prefill.calls} admissions, not 8")
    if any(g is None for g in e._prefill.graphs.values()):
        fail("3i: the prefill entries did not run as CUDA graphs")
    pg = e._prefill
    order = [("full", -(-n // layout.block_tokens)) for n in PREFILL_ROUND]
    for i, key in enumerate(order):
        g = pg.graphs[key]
        S = key[1] * layout.block_tokens
        # inputs of this length with the row all -1 (every write drops)
        h = pg.trip.host_in
        h[:] = 0
        h[0] = S - 1
        pg.trip.stage()
        pg.row.fill_(-1)
        replay = cuda_ms(g.graph.replay, iters=20, warmup=3)
        flops, byts = _prefill_bound(cfg, params, S)
        t_ops, t_bytes = flops / BF16_FLOP_PER_S * 1e3, \
            byts / HBM_BYTES_PER_S * 1e3
        print(f"  {S} tokens ({key[1]} blocks): one replay {replay:.4f} ms by "
              f"CUDA events over 20 replays; bound {max(t_ops, t_bytes):.4f} "
              f"ms ({'operations' if t_ops >= t_bytes else 'bytes'}: "
              f"{flops:.3e} flops {t_ops:.4f} ms, {byts / 1e9:.2f} GB "
              f"{t_bytes:.4f} ms), {max(t_ops, t_bytes) / replay:.1%} of it; "
              f"capture {g.capture_s:.4f} s; reserved memory added "
              f"{g.pool_bytes / 1e9:.4f} GB; launches per replay "
              f"{_per_replay(g)}", flush=True)
        if i > 0 and g.pool_bytes >= 0.25e9:
            fail(f"3i: the {S}-token prefill graph added "
                 f"{g.pool_bytes / 1e9:.3f} GB to the shared pool")
    del e, pg


def _per_replay(g) -> dict:
    """A capture's launches per replay by wrapper and count name."""
    return {f"{fn.__name__}.{name}": n
            for (fn, name), n in g.per_replay.items()}


def _span_totals(spans) -> dict:
    """Seconds of host wall per span kind: the name up to its first space
    or '=' ("step 12" -> "step", "prefill rid=0" -> "prefill")."""
    tot: dict = {}
    for name, _cat, _tid, _t0, dur in spans:
        key = re.split(r"[ =]", name)[0]
        tot[key] = tot.get(key, 0.0) + dur / 1e9
    return tot


def _telemetry_phase(serve_main, eng, wall) -> None:
    """Phase 3's requests with telemetry and the Chrome trace on."""
    from repro_torch.obs import tag_name
    print("[3d] telemetry + Chrome trace (trace=True) on phase 3's requests",
          flush=True)
    tel_eng, out, tel_wall, launches = serve_main(label="3d", trace=True)
    print(f"  launches={launches} serve wall {tel_wall:.2f}s (phase 3, "
          f"telemetry off: {wall:.2f}s)", flush=True)
    tel = tel_eng.telemetry
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        tel_eng.write_trace(path)
        size = path.stat().st_size
        doc = json.loads(path.read_text())
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        fail("the Chrome trace has no traceEvents")
    procs = {e["args"]["name"] for e in events
             if e["ph"] == "M" and e["name"] == "process_name"}
    host = [e for e in events if e["ph"] == "X" and e["pid"] == 1]
    ring = [e for e in events if e["ph"] == "i" and e["pid"] == 2]
    dev = [e for e in events if e["ph"] == "X" and e["pid"] == 3
           and e["tid"] == 1]
    n_dev = sum(1 for s in tel.spans if s[1] == "device")
    kinds = {re.split(r"[ =]", e["name"])[0] for e in host}
    if procs != {"host", "modeled", "device"} or not {
            "step", "decode", "mm-tick", "prefill", "req", "admit", "graph",
            "sample", "access", "queue", "capture"} <= kinds:
        fail(f"the Chrome trace lacks tracks or spans: {procs} {kinds}")
    if len(host) != len(tel.spans) - n_dev or len(dev) != n_dev or \
            len(ring) != len(tel.ring.peek()):
        fail("the Chrome trace does not hold every span and ring event")
    if any(e["dur"] < 0 for e in host + dev):
        fail("a span of negative duration")
    print(f"  trace: {size} bytes, {len(host)} host spans, {len(dev)} "
          f"device spans, {len(ring)} ring events, loads back", flush=True)
    print("  span totals (host wall, s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(_span_totals(tel.spans).items())),
        flush=True)
    snap = tel.snapshot()
    for hook, h in sorted(snap["hooks"].items()):
        print(f"  {hook}: invoke p50 {h['invoke_ns']['p50']} ns, p99 "
              f"{h['invoke_ns']['p99']} ns over {h['invoke_ns']['count']} "
              f"calls; batch p50 {h['batch_size']['p50']}", flush=True)
    for name in ("request_ttft_ns", "decode_token_ns", "mgmt_step_ns"):
        h = snap[name]
        print(f"  {name}: p50 {h['p50']} p99 {h['p99']} count {h['count']}",
              flush=True)
    tags: dict = {}
    for t in tel.ring.peek()[:, 1]:
        tags[tag_name(int(t))] = tags.get(tag_name(int(t)), 0) + 1
    print(f"  ring: {json.dumps(tags)} dropped={snap['ring']['dropped']}",
          flush=True)
    _contained(tel_eng.mm.hooks, "telemetry run")
    if tel_eng.finished != eng.finished:
        fail("telemetry on sampled other tokens than phase 3")
    if out["mm"] != eng.mm.stats.snapshot():
        fail("telemetry on left other MMStats than phase 3")
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the telemetry run")
    print("  tokens and MMStats equal phase 3's", flush=True)


def _huge_share(out) -> float:
    """Share of the blocks a run faulted in that it mapped as huge pages
    (order >= 1) at fault time, from ``MMStats.pages_per_order``.  (The
    engine's ``huge_fraction`` reads 0 after a run: every sequence has
    been freed by then.)"""
    per = out["mm"]["pages_per_order"]
    blocks = [n * 4 ** o for o, n in enumerate(per)]
    return sum(blocks[1:]) / max(1, sum(blocks))


def _auto_profile_phase(serve_main, eng, out) -> None:
    """Phase 3's requests with online profiling (profile="auto")."""
    print("[3f] online profiling (profile=\"auto\") on phase 3's requests, "
          "the last two submitted 8 steps after the first two (a prompt's "
          "faults come at its admission, so these fault after the first "
          "profile reload)", flush=True)
    auto, aout, awall, launches = serve_main(stagger=8, label="3f",
                                            profile="auto")
    prof = aout["profiler"]
    print(f"  launches={launches} serve wall {awall:.2f}s", flush=True)
    print(f"  profiler: scans={prof['scans']} reloads={prof['reloads']} "
          f"apps={json.dumps(prof['apps'])}", flush=True)
    print(f"  huge-page share of faulted blocks {_huge_share(aout):.4f} "
          f"(offline profile, phase 3: {_huge_share(out):.4f}); "
          f"pages_per_order {aout['mm']['pages_per_order']} (phase 3: "
          f"{out['mm']['pages_per_order']}); hinted_faults "
          f"{aout['mm']['hinted_faults']} (phase 3: "
          f"{out['mm']['hinted_faults']}); khugepaged "
          f"{aout.get('khugepaged')} (phase 3: {out.get('khugepaged')})",
          flush=True)
    _contained(auto.mm.hooks, "auto-profile run")
    if prof["reloads"] < 1:
        fail("online profiling reloaded no profile")
    if aout["mm"]["hinted_faults"] <= 0:
        fail("no fault took a hint from a synthesized profile")
    if auto.finished != eng.finished:
        fail("profile='auto' sampled other tokens than phase 3")
    for k in ("paged_decode_attention", "flash_attention"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the auto-profile run")
    print("  tokens equal phase 3's", flush=True)


def _strikes_explained(eng, what: str) -> None:
    """Under chaos: fail unless every supervisor strike is an injected
    hook_run failure (each hook's strikes all runtime errors, adding up
    to the injector's hook_run fires).  A strike no injection explains
    means an executor failed on the card."""
    snap = eng.mm.hooks.supervisor.snapshot()
    hooks = {h: v for h, v in snap.items() if isinstance(v, dict)}
    odd = {h: v["strikes"] for h, v in hooks.items()
           if v["strikes"] != v["runtime_error"]}
    injected = eng.injector.fired["hook_run"]
    errors = sum(v["runtime_error"] for v in hooks.values())
    if odd or errors != injected:
        fail(f"{what}: strikes not explained by injections: {odd}, "
             f"{errors} runtime errors vs {injected} hook_run fires")
    print(f"  {what}: {errors} strikes, all injected hook_run failures; "
          f"detaches {snap['detaches']}", flush=True)


def _chaos_run(cfg, params, wrappers, route: str, **kw):
    """One phase-3b workload under chaos on ``route``; prints its numbers
    and checks its kernels launched and its strikes were injected."""
    for w in wrappers.values():
        w.launches = 0
    e, o, wall = _serve_tiered(cfg, params, batch_faults=route == "batched",
                               **kw)
    launches = {k: w.launches for k, w in wrappers.items()}
    st, mm = o["engine"], o["mm"]
    print(f"  {route} route: launches={launches} completed="
          f"{st['completed']} preemptions={st['preemptions']} "
          f"demotions={mm['demotions']} promotions={mm['tier_promotions']} "
          f"migrate_retries={mm['migrate_retries']} migrate_aborts="
          f"{mm['migrate_aborts']} tier_alloc_failures="
          f"{mm['tier_alloc_failures']} wall={wall:.2f}s", flush=True)
    print(f"  {route} route: fired={e.injector.fired}", flush=True)
    _strikes_explained(e, f"chaos run, {route} route")
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the chaos run")
    return e, o


def _chaos_phase(cfg, params, wrappers, clean_finished) -> None:
    """Phase 3b's tiered workload under seeded chaos.  Copy errors and
    hook runtime errors on both routes, held to each other bit for bit;
    then every failure site armed, on the batched route.  With allocation
    failures and link flaps armed, HBM can fill with no demotion possible,
    and there the two routes part by design (the batched route preempts at
    most once per step, the scalar route once per faulting sequence), so
    only the data is compared there."""
    from repro_torch.resilience import FailureInjector
    rates = {"migrate_copy": 0.05, "hook_run": 0.05}
    print(f"[3e] tiered serving under chaos: seed 1, {rates} on the batched "
          f"and the scalar route (one injector each)", flush=True)
    (a, ao), (b, bo) = [
        _chaos_run(cfg, params, wrappers, route,
                   chaos=FailureInjector(1, dict(rates)))
        for route in ("batched", "scalar")]
    fired = a.injector.fired
    if fired["migrate_copy"] <= 0 or fired["hook_run"] <= 0:
        fail(f"chaos injected no migrate_copy or no hook_run failure: "
             f"{fired}")
    if a.injector.fired != b.injector.fired:
        fail("chaos: the routes saw different injections")
    if a.finished != b.finished:
        fail("chaos: the batched and scalar routes sampled different tokens")
    for key in ("engine", "mm", "tier"):
        x, y = dict(ao[key]), dict(bo[key])
        x.pop("wall_host_s", None)
        y.pop("wall_host_s", None)
        if x != y:
            fail(f"chaos: the routes left different {key} stats")
    bad = [i for i, (x, y) in enumerate(zip(a._pool_leaves, b._pool_leaves))
           if not torch.equal(x, y)]
    if bad:
        fail(f"chaos: KV pool leaves {bad} differ between the routes")
    print(f"  routes: equal tokens, engine, mm and tier stats, injections, "
          f"and all {len(a._pool_leaves)} KV pool leaves bit for bit",
          flush=True)
    if a.finished != clean_finished:
        fail("chaos changed the tokens of phase 3b's clean run")
    print("  tokens equal phase 3b's clean run", flush=True)
    del a, b
    print("  every failure site armed (chaos=1, chaos_rate=0.05):",
          flush=True)
    u, _ = _chaos_run(cfg, params, wrappers, "batched", chaos=1,
                      chaos_rate=0.05)
    if u.finished != clean_finished:
        fail("chaos at every site changed the tokens of phase 3b's clean "
             "run")
    print("  tokens equal phase 3b's clean run", flush=True)


def _tiered_phase(cfg, params, wrappers, engine_mod) -> tuple:
    """Full-width tiered serving over an overcommitted HBM pool, on the
    batched route and held to the scalar route; returns the block-copy
    launches of the batched run and its tokens."""
    print("[3b] tiered serving: 128 HBM blocks + 384 host blocks "
          "(ebpf-tier), 6 x (448 + 128) tokens, max_batch 6, batched route "
          "then scalar route", flush=True)
    def serve(batch_faults: bool):
        return _serve_tiered(cfg, params, batch_faults=batch_faults)

    moves: list = []
    real = _recording(engine_mod, moves)
    for w in wrappers.values():
        w.launches = 0
    eng, out, wall = serve(True)
    launches = {k: w.launches for k, w in wrappers.items()}
    engine_mod.block_copy = real
    pool_gb = sum(t.numel() * t.element_size() for t in eng._pool_leaves)
    print(f"  combined pool {eng._pool_leaves[0].shape[1]} blocks, "
          f"{pool_gb / 1e9:.2f} GB", flush=True)
    st, mm = out["engine"], out["mm"]
    print(f"  completed={st['completed']} preemptions={st['preemptions']} "
          f"tier_reliefs={st['tier_reliefs']} demotions={mm['demotions']} "
          f"promotions={mm['tier_promotions']} steps={st['steps']} "
          f"fallback_faults={mm['fallback_faults']} wall={wall:.2f}s",
          flush=True)
    print(f"  tier={json.dumps(out['tier'])}", flush=True)
    print(f"  launches={launches} block-copy moves: {sum(moves)} block rows "
          f"in {len(moves)} launches", flush=True)
    hooks = eng.mm.hooks
    print(f"  hooks: batch_calls={_nonzero(hooks.batch_calls)} "
          f"invocations={_nonzero(hooks.invocations)}", flush=True)
    if st["completed"] != 6:
        fail(f"tiered run completed {st['completed']} of 6")
    if mm["demotions"] <= 0:
        fail("tiered run demoted nothing: HBM was not overcommitted")
    if st["preemptions"] != 0:
        fail(f"tiered run preempted {st['preemptions']} times")
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the tiered path")
    for h in ("mm_fault", "mm_tier"):
        if hooks.batch_calls[h] <= 0:
            fail(f"the tiered run ran no {h} batch")
    _contained(hooks, "tiered run, batched route")
    finished = eng.finished
    del eng
    sc, sc_out, sc_wall = serve(False)
    print(f"  scalar route: completed={sc_out['engine']['completed']} "
          f"demotions={sc_out['mm']['demotions']} wall={sc_wall:.2f}s; "
          f"serve wall batched {wall:.2f}s, scalar {sc_wall:.2f}s",
          flush=True)
    _contained(sc.mm.hooks, "tiered run, scalar route")
    if sc.finished != finished:
        fail("tiered run: the batched and scalar routes sampled different "
             "tokens")
    for key in ("engine", "mm", "tier"):
        a, b = dict(out[key]), dict(sc_out[key])
        a.pop("wall_host_s", None)
        b.pop("wall_host_s", None)
        if a != b:
            fail(f"tiered run: the batched and scalar routes left different "
                 f"{key} stats")
    print("  batched and scalar routes: equal tokens, engine, mm and tier "
          "stats", flush=True)
    del sc
    return launches["block_copy"], finished


def _prefix_phase(cfg, params, profile, wrappers, fa, *,
                  tag: str = "3c", new: int = 64) -> int:
    """Full-width prefix-cache serving; returns the flash launches with a
    query offset of its run."""
    from repro_torch.models import PagedLayout, cache_init, prefill_step
    from repro_torch.serving import Request, ServingEngine
    print(f"[{tag}] prefix cache on {cfg.name}: 6 requests of a shared "
          f"256-token system prompt + 192 own tokens, {new} new each, one "
          f"after another", flush=True)
    layout = PagedLayout(num_blocks=512, block_tokens=16, max_blocks=32)
    eng = ServingEngine(cfg, params, layout, max_batch=6, policy="ebpf",
                        profile=profile, seed=SEED, prefix_cache=True)
    rng = np.random.default_rng(SEED + 4)
    shared = rng.integers(1, cfg.vocab, 256).tolist()
    prompts = [shared + rng.integers(1, cfg.vocab, 192).tolist()
               for _ in range(6)]
    hit: dict = {}
    suffix_calls = []
    real_sfx = eng._prefill.suffix

    def spy(prompt, slot, prefix_len):
        logits = real_sfx(prompt, slot, prefix_len)
        suffix_calls.append(prefix_len)
        if "logits" not in hit:
            hit.update(logits=torch.from_numpy(logits.copy()).to("cuda")[None],
                       prefix_len=prefix_len, rid=len(eng.finished),
                       layer1=_layer1_rows(cfg, params, eng.cache,
                                           eng._table_buf[slot:slot + 1],
                                           prefix_len, 448))
        return logits
    eng._prefill.suffix = spy
    for w in wrappers.values():
        w.launches = 0
    _zero_exec()                           # after the engine's warm-up
    fa.flash_attention.offset_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rid in range(6):
        eng.submit(Request(rid=rid, prompt=prompts[rid], max_new_tokens=new,
                           app="chat"))
        out = eng.run(max_steps=400)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    offset = fa.flash_attention.offset_launches
    pc, st = out["prefix_cache"], out["engine"]
    graphs = eng._prefill.graphs
    sfx_graphs = sorted(k for k in graphs if k[0] == "suffix")
    print(f"  completed={st['completed']} prefill_tokens="
          f"{st['prefill_tokens']} wall={wall:.2f}s", flush=True)
    print(f"  prefix_cache={json.dumps(pc)}", flush=True)
    print(f"  launches={launches} flash launches with q_offset>0: {offset} "
          f"over {len(suffix_calls)} suffix prefills (prefix lengths "
          f"{suffix_calls}); suffix graphs captured: {len(sfx_graphs)} "
          f"{sfx_graphs}; prefill graphs in all: {sorted(graphs)}",
          flush=True)
    print(f"  hooks: batch_calls={_nonzero(eng.mm.hooks.batch_calls)} "
          f"fallback_faults={out['mm']['fallback_faults']}", flush=True)
    _exec_launches(eng.mm.hooks, f"phase {tag} prefix run")
    if st["completed"] != 6:
        fail(f"prefix run completed {st['completed']} of 6")
    if pc["hits"] < 3:
        fail(f"prefix cache hit {pc['hits']} times (< 3)")
    if offset <= 0:
        fail("no suffix prefill launched flash with a query offset")
    n_attn = sum(1 for k in cfg.layer_kinds() if k == "a")
    if offset != n_attn * len(suffix_calls):
        fail(f"{offset} flash launches with a query offset over "
             f"{len(suffix_calls)} suffix prefills, not {n_attn} each")
    if not sfx_graphs or any(g is None for g in graphs.values()):
        fail(f"the prefix run prefilled without its CUDA graphs ({graphs})")
    _contained(eng.mm.hooks, "prefix run")
    # the first hit's last-token logits against a full prefill of its prompt
    prompt = prompts[hit["rid"]]
    nb = len(prompt) // 16
    lay = PagedLayout(num_blocks=nb, block_tokens=16, max_blocks=32)
    cache = cache_init(cfg, lay, 1, device="cuda")
    tbl = torch.full((1, 32), -1, dtype=torch.int32, device="cuda")
    tbl[0, :nb] = torch.arange(nb, device="cuda")
    full, _ = prefill_step(params, cfg, cache,
                           torch.tensor([prompt], device="cuda"), tbl, lay,
                           chunk=256, last_index=torch.tensor(
                               [len(prompt) - 1], device="cuda"))
    err = max_err(hit["logits"], full)
    scale = full.abs().max().item()
    tol = 2e-2 * max(1.0, scale)          # the flash tolerance, scaled
    print(f"  hit rid={hit['rid']} (prefix {hit['prefix_len']} tokens): "
          f"last-token logits vs a full prefill: max_abs_err={err:.3e} "
          f"(tol {tol:.3g} = 2e-2 x max(1, |logits| max {scale:.3f})), "
          f"bit-equal={torch.equal(hit['logits'], full)}", flush=True)
    # a MoE layer's expert capacity counts the rows it is given (the
    # suffix's 192, not the prompt's 448), so past the first MoE layer the
    # hit may drop other tokens than the full prefill, in the reference as
    # here: a MoE model's suffix path is held at the latents the suffix
    # wrote into the second layer's pool (after the dense first layer's
    # suffix attention over the gathered prefix)
    ref1 = _layer1_rows(cfg, params, cache, tbl, hit["prefix_len"], 448)
    err1 = max_err(hit["layer1"], ref1)
    tol1 = 2e-2 * max(1.0, ref1.abs().max().item())
    print(f"  layer 1 pool rows of the suffix vs a full prefill: "
          f"max_abs_err={err1:.3e} (tol {tol1:.3g}), bit-equal="
          f"{torch.equal(hit['layer1'], ref1)}", flush=True)
    if not err1 <= tol1:
        fail(f"suffix-prefill layer-1 pool rows differ from the full "
             f"prefill's: {err1}")
    if cfg.moe is None and not err <= tol:
        fail(f"suffix-prefill logits differ from the full prefill's: {err}")
    del eng, cache
    return offset


def _mla_phase(gen, dev, fa, pa, bc, engine_mod) -> list:
    """Phase 6 with the MLA rows of 6c, alone (``--phase 6``):
    deepseek-v2-lite-16b served on both fault routes and through the prefix
    cache, as in the whole run, then its kernels against their plain
    versions."""
    from repro_torch.core import Profile, ProfileRegion
    wrappers = {"paged_decode_attention": pa.paged_decode_attention,
                "flash_attention": fa.flash_attention,
                "block_copy": bc.block_copy}
    profile = Profile("chat", [
        ProfileRegion(0, 8, (0, 150_000, 600_000, 2_500_000)),  # hot prefix
        ProfileRegion(8, 32, (0, 0, 0, 0))])                    # cold tail

    def mla_prefix(arch, cfg, params):
        return _prefix_phase(cfg, params, profile, wrappers, fa, tag="6",
                             new=16)
    fam = _families_phase(gen, wrappers, engine_mod, MLA_FAMILY,
                          after=mla_prefix)
    rows = _zoo_rows(gen, dev, fam, pa, fa, bc)
    _print_rows(rows)
    return rows


def _layer1_rows(cfg, params, cache, table, start: int, end: int):
    """The pool rows (K, or MLA's latents) that positions [start, end) of
    the sequence behind ``table`` ([1, MB]) hold in the second layer."""
    from repro_torch.models.decode import _layers
    _, _, c = list(_layers(params, cache, cfg))[1]
    pool = c["pool_ckv" if cfg.mla is not None else "pool_k"]
    bt = pool.shape[1]
    pos = torch.arange(start, end, device=pool.device)
    return pool[table[0, pos // bt].long(), pos % bt].float()


# Phases 5 / 5b / 6 / 6b: arch -> (phase; layers kept, or None for the full
# depth; requests; prompt tokens; new tokens; max_blocks).  Depth is cut
# where a model would not fit the card or would make the command long;
# widths are the published ones.  gemma-3's prompts pass its 1024-token
# window; qwen2-VL's 1100 cover its 1024 stub patches plus text; mamba2's
# and jamba's 512 pad to a multiple of the SSD chunk (256); Whisper's 192 +
# 64 stay inside its decoder's 448 tokens.
FAMILIES = {
    "deepseek_moe_16b": ("5", None, 4, 448, 64, 32),
    "gemma3_27b": ("5b", 6, 2, 1200, 32, 80),
    "qwen2_vl_7b": ("5b", 4, 2, 1100, 32, 80),
    "nemotron_4_15b": ("5b", 4, 2, 448, 32, 32),
    "phi3_mini_3p8b": ("5b", 4, 2, 448, 32, 32),
}
MLA_FAMILY = {"deepseek_v2_lite_16b": ("6", None, 4, 448, 64, 32)}
ZOO_FAMILIES = {
    "mamba2_1p3b": ("6b", None, 4, 512, 64, 40),
    "jamba_v0_1_52b": ("6b", 8, 4, 512, 64, 40),
    "whisper_medium": ("6b", None, 4, 192, 64, 32),
}


def _expected_launches(cfg) -> tuple[int, int, int]:
    """(flash launches per admission, paged-decode launches per decode
    step, latent-decode launches per decode step) of ``cfg``'s serving
    path: one flash per attention layer (mamba and jamba serve attention at
    every layer, as the reference does: no plan has the kind its mamba
    branch tests), and for Whisper also one per encoder layer and one per
    cross-attention; one paged decode per attention layer, or for MLA one
    call of its latent kernel (``paged_decode_mla``) per layer instead."""
    from repro_torch.models import build_layer_plans
    n_attn = sum(1 for p in build_layer_plans(cfg) if p.kind != "mamba")
    flash = n_attn + (cfg.enc_layers + cfg.n_layers if cfg.enc_dec else 0)
    if cfg.mla is not None:
        return flash, 0, n_attn
    return flash, n_attn, 0


def _serve_family(cfg, params, n_req, prompt, new, max_blocks, wrappers,
                  batch_faults: bool):
    """One family's requests on a fresh engine (``policy="ebpf"``, the
    demo profile, khugepaged on, 512 blocks of 16 tokens) on one fault
    route.  Returns (engine, run() output, wall, launches, drained moves);
    the launches are counted over this run alone."""
    from repro_torch.core import Profile, ProfileRegion
    from repro_torch.kernels.mla_decode import ops as ma
    from repro_torch.models import PagedLayout
    from repro_torch.serving import Request, ServingEngine
    wrappers = {**wrappers, "paged_decode_mla": ma.paged_decode_mla}
    layout = PagedLayout(num_blocks=512, block_tokens=16,
                         max_blocks=max_blocks)
    profile = Profile("chat", [
        ProfileRegion(0, 8, (0, 150_000, 600_000, 2_500_000)),   # hot
        ProfileRegion(8, max_blocks, (0, 0, 0, 0))])              # cold
    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(1, cfg.vocab, prompt).tolist()
               for _ in range(n_req)]
    eng = ServingEngine(cfg, params, layout, max_batch=n_req, policy="ebpf",
                        profile=profile, seed=SEED,
                        batch_faults=batch_faults)
    moves: list = []
    drain = eng.mm.drain_moves

    def logged_drain():
        mv = drain()
        moves.extend(tuple(m) for m in mv)
        return mv
    eng.mm.drain_moves = logged_drain
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rid in range(n_req):
        eng.submit(Request(rid=rid, prompt=prompts[rid], max_new_tokens=new,
                           app="chat"))
    out = eng.run(max_steps=1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, out, wall, {k: w.launches for k, w in wrappers.items()}, \
        moves


def _families_phase(gen, wrappers, engine_mod, families=FAMILIES,
                    after=None) -> dict:
    """Phase 5 (deepseek-moe-16b at full width and depth) and 5b (gemma-3,
    qwen2-VL, nemotron-4, phi-3 at full width, depth cut), or the phases of
    another ``families`` table: each served on the batched route, then the
    scalar route, which must give equal tokens, ``MMStats`` and drained
    moves.  ``after(arch, cfg, params)``, when given, runs with the
    family's params still on the card.  Returns arch -> {"launches": the
    batched run's kernel launches, "moves": its drained moves, "after":
    what ``after`` returned}."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models import materialize, model_spec
    launches_by_arch = {}
    for arch, (tag, layers, n_req, prompt, new, mb) in families.items():
        full = get_config(arch)
        cfg = full if layers is None else dataclasses.replace(
            full, n_layers=layers)
        depth = "full depth" if layers is None else \
            f"depth cut from {full.n_layers}"
        print(f"[{tag}] {arch}: {cfg.n_layers} layers ({depth}), d_model "
              f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.kv_heads} kv x "
              f"{cfg.head_dim}, mlp {cfg.mlp}, norm {cfg.norm}"
              + (f", MLA (kv_lora {cfg.mla.kv_lora}, q/k heads "
                 f"{cfg.mla.qk_nope} + {cfg.mla.qk_rope}, v heads "
                 f"{cfg.mla.v_head})" if cfg.mla else "")
              + (f", layer kinds {''.join(cfg.layer_kinds()[:8])}.. (served "
                 f"as attention, as the reference serves them)"
                 if cfg.mamba else "")
              + (f", encoder {cfg.enc_layers} layers over {cfg.enc_frames} "
                 f"stub frames" if cfg.enc_dec else "")
              + (f", MoE {cfg.moe.num_experts} routed top-{cfg.moe.top_k} "
                 f"(d_ff {cfg.moe.d_ff_expert}) + {cfg.moe.num_shared} "
                 f"shared" if cfg.moe else "")
              + (f", window {cfg.attn.window} on {cfg.attn_kinds().count('l')}"
                 f" of {cfg.n_layers} layers" if cfg.attn.window else "")
              + (f", M-RoPE {cfg.attn.mrope_sections}, {cfg.vlm_patches} "
                 f"stub patches" if cfg.vlm_patches else "")
              + f"; {n_req} x ({prompt} + {new}) tokens, max_batch {n_req}",
              flush=True)
        t0 = time.perf_counter()
        params = materialize(gen, model_spec(cfg), device="cuda",
                             dtype=torch.bfloat16)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        print(f"  params: {n_params / 1e9:.2f}B in bf16 "
              f"({n_params * 2 / 1e9:.1f} GB) in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        runs = {}
        for route, batch in (("batched", True), ("scalar", False)):
            eng, out, wall, launches, moves = _serve_family(
                cfg, params, n_req, prompt, new, mb, wrappers, batch)
            st = out["engine"]
            print(f"  {route} route: completed={st['completed']} "
                  f"steps={st['steps']} decode_tokens={st['decode_tokens']} "
                  f"prefill_tokens={st['prefill_tokens']} wall={wall:.2f}s "
                  f"launches={launches} moves={len(moves)} "
                  f"khugepaged={out.get('khugepaged')}", flush=True)
            _contained(eng.mm.hooks, f"{arch}, {route} route")
            if st["completed"] != n_req:
                fail(f"{arch} {route} route completed {st['completed']} of "
                     f"{n_req}")
            toks = [t for seq in eng.finished.values() for t in seq]
            if len(toks) != n_req * new or not all(
                    0 <= t < cfg.vocab for t in toks):
                fail(f"{arch}: generated tokens outside the vocabulary or "
                     f"missing")
            per_adm, per_step, per_mla = _expected_launches(cfg)
            if launches["flash_attention"] != per_adm * st["prefills"]:
                fail(f"{arch}: {launches['flash_attention']} flash launches, "
                     f"not {per_adm} per admission")
            _graph_launches(eng, launches, per_step, f"{arch}, {route}",
                            per_adm, per_mla)
            runs[route] = (dict(eng.finished), out["mm"], moves, launches)
            del eng
        (tok_b, mm_b, mv_b, launches), (tok_s, mm_s, mv_s, _) = \
            runs["batched"], runs["scalar"]
        print(f"  paged launches {launches['paged_decode_attention']} = "
              f"{per_step} x {launches['paged_decode_attention'] // max(1, per_step)} "
              f"decode steps; latent-decode launches "
              f"{launches['paged_decode_mla']} = {per_mla} x "
              f"{launches['paged_decode_mla'] // max(1, per_mla)}; flash {launches['flash_attention']} = "
              f"{per_adm} x {launches['flash_attention'] // per_adm}"
              f" admissions; block copy {launches['block_copy']}", flush=True)
        if tok_b != tok_s:
            fail(f"{arch}: the batched and scalar routes sampled different "
                 f"tokens")
        if mm_b != mm_s:
            fail(f"{arch}: the batched and scalar routes left different "
                 f"MMStats")
        if mv_b != mv_s:
            fail(f"{arch}: the batched and scalar routes drained different "
                 f"moves")
        print("  batched and scalar routes: equal tokens, MMStats and "
              "moves", flush=True)
        launches_by_arch[arch] = {
            "launches": launches, "moves": mv_b,
            "after": after(arch, cfg, params) if after else None}
        del params
        torch.cuda.empty_cache()
    return launches_by_arch


def _family_rows(gen, dev, launches_by_arch, pa, fa) -> list:
    """Kernel rows at the families' new full-width shapes, each held to its
    plain version and timed beside its bound and a PyTorch call; launches
    are those of the family's batched run in phase 5b."""
    print("[5c] kernels at the families' shapes vs plain versions; device "
          "time per call (torch.profiler), paged L2-cold", flush=True)
    bf16 = torch.bfloat16
    rows = []

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf16)

    # flash prefill: (name, arch, S, H, KVH, hd, window)
    for name, arch, S, H, KVH, hd, window in (
            ("flash_attention_hd168_window", "gemma3_27b", 1200, 32, 16, 168,
             1024),
            ("flash_attention_g7", "qwen2_vl_7b", 1104, 28, 4, 128, None)):
        q, k, v = rn(1, S, H, hd), rn(1, S, KVH, hd), rn(1, S, KVH, hd)

        def flash(q=q, k=k, v=v, window=window):
            return fa.flash_attention(q, k, v, causal=True, window=window)

        def plain(q=q, k=k, v=v, window=window):
            return fa.flash_attention_plain(q, k, v, causal=True,
                                            window=window, chunk=256)
        o = flash()
        torch.cuda.synchronize()
        err = check(f"{name}: flash S={S} H={H} KVH={KVH} hd={hd} window="
                    f"{window} (bf16)", max_err(o, plain()), 2e-2)
        G = H // KVH
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
        i = torch.arange(S, device=dev)
        if window is None:
            mask = None
            pairs = S * (S + 1) // 2
        else:
            mask = (i[None, :] <= i[:, None]) & \
                (i[None, :] > i[:, None] - window)
            pairs = int(mask.sum())

        def sdpa(qt=qt, kt=kt, vt=vt, mask=mask):
            if mask is None:
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True)
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask)
        lib_err = max_err(sdpa().transpose(1, 2), o)
        print(f"  SDPA vs kernel: max_abs_err={lib_err:.3e}", flush=True)
        rows.append(_row(
            name, "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:90",
            {name: launches_by_arch[arch]["launches"]["flash_attention"]},
            {name: err},
            (2 * H + 2 * KVH) * S * hd * 2, 4 * pairs * H * hd,
            lambda: device_ms([flash]),
            lambda: device_ms([plain], iters=10),
            lambda: library_ms(sdpa)))

    # paged decode: (name, arch, H, KVH, hd, max_blocks, lengths, window)
    bt = 16
    for name, arch, H, KVH, hd, MB, lo, hi, window in (
            ("paged_decode_g6", "nemotron_4_15b", 48, 8, 128, 32, 449, 481,
             None),
            ("paged_decode_g7", "qwen2_vl_7b", 28, 4, 128, 80, 1101, 1133,
             None),
            ("paged_decode_hd168_window", "gemma3_27b", 32, 16, 168, 80, 1201,
             1233, 1024)):
        B = 2
        NB = B * MB
        q = rn(B, H, hd)
        table = torch.randperm(NB, generator=gen, device=dev)[:NB] \
            .reshape(B, MB).int()
        lengths = torch.randint(lo, hi, (B,), generator=gen,
                                device=dev).int()
        pool_bytes = NB * bt * KVH * hd * 2 * 2
        n_pools = max(2, -(-200_000_000 // pool_bytes))   # > 4x the L2
        pools = [(rn(NB, bt, KVH, hd), rn(NB, bt, KVH, hd))
                 for _ in range(n_pools)]
        kw = dict(block_tokens=bt, window=window)
        out, heat = pa.paged_decode_attention(q, *pools[0], table, lengths,
                                              **kw)
        torch.cuda.synchronize()
        ref_out, ref_heat = pa.paged_decode_plain(q, *pools[0], table,
                                                  lengths, **kw)
        err = max(check(f"{name}: paged B={B} H={H} KVH={KVH} hd={hd} "
                        f"window={window} out (bf16)",
                        max_err(out, ref_out), 2e-2),
                  check(f"{name}: heat", max_err(heat, ref_heat), 1e-4))
        valid = lengths.clamp(max=window) if window else lengths
        n_tok = int(valid.sum())
        byts = n_tok * KVH * hd * 2 * 2 + B * H * hd * 2 * 2 \
            + table.numel() * 4 + B * 4 + B * MB * 4
        print(f"  {name}: {n_tok} valid tokens; timed over {n_pools} pools "
              f"of {pool_bytes / 1e6:.1f} MB", flush=True)
        rows.append(_row(
            name, "src/repro_torch/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention/kernel.py:99",
            {name: launches_by_arch[arch]["launches"][
                "paged_decode_attention"]},
            {name: err}, byts, 4 * n_tok * H * hd,
            lambda: device_ms([lambda pk=pk, pv=pv: pa.paged_decode_attention(
                q, pk, pv, table, lengths, **kw) for pk, pv in pools]),
            lambda: device_ms([lambda pk=pk, pv=pv: pa.paged_decode_plain(
                q, pk, pv, table, lengths, **kw) for pk, pv in pools],
                iters=max(10, n_pools)),
            None))
        del pools
    return rows


def _zoo_rows(gen, dev, fam, pa, fa, bc) -> list:
    """Phase 6c: the kernels at the last four families' shapes, each held
    to its plain version and timed beside its bound and one PyTorch call;
    launches are those of the family's batched run in phase 6 / 6b (the MLA
    suffix row: the flash launches with a query offset of phase 6's
    prefix-cache run)."""
    from torch.nn.attention.bias import causal_lower_right
    print("[6c] kernels at the MLA, jamba and Whisper shapes vs plain "
          "versions; device time per call (torch.profiler), paged L2-cold",
          flush=True)
    bf16 = torch.bfloat16
    rows = []

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf16)

    def flash_launches(run):
        return run["launches"]["flash_attention"]

    mla = fam["deepseek_v2_lite_16b"]
    whisper = fam.get("whisper_medium")
    # flash: (name, Sq, Sk, H, hd, hdv, causal, q_offset, launches)
    flash_cases = [
        ("flash_attention_mla", 448, 448, 16, 192, 128, True, 0,
         flash_launches(mla)),
        ("flash_attention_mla_q_offset", 192, 448, 16, 192, 128, True, 256,
         mla["after"])]
    if whisper is not None:
        flash_cases += [
            ("flash_attention_whisper_encoder", 1500, 1500, 16, 64, 64,
             False, 0, flash_launches(whisper)),
            ("flash_attention_whisper_cross", 192, 1500, 16, 64, 64, False,
             0, flash_launches(whisper))]
    for name, Sq, Sk, H, hd, hdv, causal, off, n in flash_cases:
        q, k, v = rn(1, Sq, H, hd), rn(1, Sk, H, hd), rn(1, Sk, H, hdv)
        kw = dict(causal=causal, q_offset=off)

        def flash(q=q, k=k, v=v, kw=kw):
            return fa.flash_attention(q, k, v, **kw)

        def plain(q=q, k=k, v=v, kw=kw):
            return fa.flash_attention_plain(q, k, v, chunk=256, **kw)
        o = flash()
        torch.cuda.synchronize()
        err = check(f"{name}: flash Sq={Sq} Sk={Sk} H={H} hd={hd} hdv={hdv} "
                    f"causal={causal} q_offset={off} (bf16)",
                    max_err(o, plain()), 2e-2)
        pairs = (Sq * off + Sq * (Sq + 1) // 2) if causal else Sq * Sk
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = (None if not causal else
                causal_lower_right(Sq, Sk) if off else None)

        def sdpa(qt=qt, kt=kt, vt=vt, mask=mask, causal=causal, off=off):
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and not off)
        try:
            lib_out = sdpa().transpose(1, 2)
        except RuntimeError as e:          # no SDPA backend takes the shape
            print(f"  SDPA refused the shape: {str(e)[:200]}", flush=True)
            lib_out = None
        library = None
        if lib_out is not None:
            library = lambda: library_ms(sdpa)  # noqa: E731
            try:
                choice = torch._fused_sdp_choice(qt, kt, vt, mask, 0.0,
                                                 causal and not off)
            except (AttributeError, RuntimeError, TypeError):
                choice = "not known"
            print(f"  SDPA vs kernel: max_abs_err={max_err(lib_out, o):.3e}; "
                  f"SDPA backend choice {choice}; "
                  f"SDPA device kernels: " + ", ".join(
                      f"{kn} {t:.1f} us" for kn, t in _device_kernels(sdpa))
                  + f"; eager wall per call: kernel {cuda_ms(flash):.4f} ms,"
                  f" SDPA {cuda_ms(sdpa):.4f} ms", flush=True)
        if hdv < hd and not off:
            # the alternative design: V zero-padded to q/k's width in a copy
            # (one copy of V per layer per admission), the output sliced
            def padded_v(q=q, k=k, v=v, kw=kw):
                vp = torch.nn.functional.pad(v, (0, hd - hdv))
                return fa.flash_attention(q, k, vp, **kw)[..., :hdv]
            print(f"  V loaded at its own width: {device_ms([flash]):.4f} ms;"
                  f" V zero-padded to {hd} in a copy, output sliced: "
                  f"{device_ms([padded_v]):.4f} ms (device, both)",
                  flush=True)
        rows.append(_row(
            name, "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:90",
            {name: n}, {name: err},
            (Sq * H * (hd + hdv) + Sk * H * (hd + hdv)) * 2,
            2 * pairs * H * (hd + hdv),
            lambda: device_ms([flash]), lambda: device_ms([plain], iters=10),
            library))

    rows.append(_mla_decode_row(gen, dev, mla))
    if "jamba_v0_1_52b" not in fam:
        return rows + [_block_copy_latent_row(gen, dev, mla, bc)]

    # paged decode at jamba's GQA (G = 4): B 4, 32 / 8 heads x 128, prompts
    # 512 + up to 64 new tokens, L2-cold over pools > 4x the L2
    name, B, H, KVH, hd, bt, MB = "paged_decode_g4", 4, 32, 8, 128, 16, 40
    NB = B * MB
    q = rn(B, H, hd)
    table = torch.randperm(NB, generator=gen, device=dev).reshape(B, MB).int()
    lengths = torch.randint(513, 577, (B,), generator=gen, device=dev).int()
    pool_bytes = NB * bt * KVH * hd * 2 * 2
    pools = [(rn(NB, bt, KVH, hd), rn(NB, bt, KVH, hd))
             for _ in range(max(2, -(-200_000_000 // pool_bytes)))]
    out, heat = pa.paged_decode_attention(q, *pools[0], table, lengths,
                                          block_tokens=bt)
    torch.cuda.synchronize()
    ref_out, ref_heat = pa.paged_decode_plain(q, *pools[0], table, lengths,
                                              block_tokens=bt)
    err = max(check(f"{name}: paged B={B} H={H} KVH={KVH} hd={hd} out "
                    f"(bf16)", max_err(out, ref_out), 2e-2),
              check(f"{name}: heat", max_err(heat, ref_heat), 1e-4))
    n_tok = int(lengths.sum())
    rows.append(_row(
        name, "src/repro_torch/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention/kernel.py:99",
        {name: fam["jamba_v0_1_52b"]["launches"]["paged_decode_attention"]},
        {name: err},
        n_tok * KVH * hd * 2 * 2 + B * H * hd * 2 * 2 + table.numel() * 4
        + B * 4 + B * MB * 4, 4 * n_tok * H * hd,
        lambda: device_ms([lambda pk=pk, pv=pv: pa.paged_decode_attention(
            q, pk, pv, table, lengths, block_tokens=bt) for pk, pv in pools]),
        lambda: device_ms([lambda pk=pk, pv=pv: pa.paged_decode_plain(
            q, pk, pv, table, lengths, block_tokens=bt) for pk, pv in pools],
            iters=max(10, len(pools))), None))
    del pools
    rows.append(_block_copy_latent_row(gen, dev, mla, bc))
    return rows


def _mla_decode_row(gen, dev, mla) -> dict:
    """6c's latent-decode row: ``paged_decode_mla`` at phase 6's decode
    shape (batch 4, prompts of 448 + up to 64 new tokens: 29-32 blocks of
    16 per row, 576-wide latents, 16 heads, the model's YaRN-scaled softmax
    scale) held to the gather it replaces (o_lat within 4e-3 of the largest
    |o_lat|: P enters the value product in bf16; heat within 1e-4, the GPU
    tests' limits), and timed L2-cold over pools > 4x the L2 beside its
    byte bound (each valid latent read once, q in float32, o_lat, heat and
    the table) and the gather."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.mla_decode import ops as ma
    from repro_torch.models.transformer import mla_scale
    cfg = get_config("deepseek_v2_lite_16b")
    m = cfg.mla
    name, B, H, bt, MB = "paged_decode_mla", 4, cfg.n_heads, 16, 32
    L, D = m.kv_lora, m.kv_lora + m.qk_rope
    NB = B * MB
    q_eff = torch.randn(B, H, L, generator=gen, device=dev) * 0.5
    q_rope = (torch.randn(B, H, m.qk_rope, generator=gen, device=dev)
              * 0.5).to(torch.bfloat16)
    table = torch.randperm(NB, generator=gen, device=dev).reshape(B, MB).int()
    lengths = torch.randint(449, 513, (B,), generator=gen, device=dev).int()
    pool_bytes = NB * bt * D * 2
    pools = [torch.randn(NB, bt, D, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(max(2, -(-200_000_000 // pool_bytes)))]
    kw = dict(block_tokens=bt, kv_lora=L, scale=mla_scale(cfg))
    print(f"  {name}: B={B} H={H} latents {D} wide, lengths "
          f"{lengths.tolist()}, scale {kw['scale']:.5f}; timed over "
          f"{len(pools)} pools of {pool_bytes / 1e6:.1f} MB", flush=True)
    o, heat = ma.paged_decode_mla(q_eff, q_rope, pools[0], table, lengths,
                                  **kw)
    torch.cuda.synchronize()
    ref_o, ref_heat = ma.paged_decode_mla_plain(q_eff, q_rope, pools[0],
                                                table, lengths, **kw)
    err = max(check(f"{name}: o_lat (bf16 latents)", max_err(o, ref_o),
                    4e-3 * max(float(ref_o.abs().max()), 1e-6)),
              check(f"{name}: heat", max_err(heat, ref_heat), 1e-4))
    n_tok = int(lengths.sum())
    byts = n_tok * D * 2 + B * H * D * 4 + B * H * L * 4 + 2 * B * MB * 4 \
        + B * 4
    row = _row(
        name, "src/repro_torch/csrc/mla_decode.cu",
        "src/repro/models/decode.py:153 (paged_decode_attention_mla_gather, "
        "jnp)", {name: mla["launches"]["paged_decode_mla"]}, {name: err},
        byts, 2 * n_tok * H * (D + L),
        lambda: device_ms([lambda p=p: ma.paged_decode_mla(
            q_eff, q_rope, p, table, lengths, **kw) for p in pools]),
        lambda: device_ms([lambda p=p: ma.paged_decode_mla_plain(
            q_eff, q_rope, p, table, lengths, **kw) for p in pools],
            iters=max(10, len(pools))), None)
    print(f"  {name}: kernel {row['ms']:.4f} ms, the gather (plain) "
          f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}), roofline share "
          f"{row['bound_ms'] / row['ms']:.1%}", flush=True)
    del pools
    return row


def _block_copy_latent_row(gen, dev, mla, bc) -> dict:
    """6c's block-copy row over MLA's latent pools."""
    from repro_torch.core.buddy import order_blocks
    from repro_torch.serving.engine import split_move_batches

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    # block copy over MLA's latent pools: 27 layers of [NB, 16, 576] bf16,
    # the largest concurrent batch of phase 6's drained moves.  Its rows
    # (~13 MB) fit the 50 MB L2, so the launches rotate over five pool
    # sets, as the engine's next drain finds its rows cold
    name = "block_copy_pool_ckv"
    batches = split_move_batches(mla["moves"]) if mla["moves"] else []
    if batches:
        batch = max(batches, key=len)
        src = np.concatenate([np.arange(s_, s_ + order_blocks(o))
                              for s_, _, o in batch]).astype(np.int32)
        dst = np.concatenate([np.arange(d_, d_ + order_blocks(o))
                              for _, d_, o in batch]).astype(np.int32)
    else:            # no collapse in phase 6: one order-2 page's worth
        print("  phase 6 drained no move; timing 16 rows 0..15 -> 256..271",
              flush=True)
        src = np.arange(16, dtype=np.int32)
        dst = src + 256
    sets = [[rn(1, 512, 16, 576) for _ in range(27)] for _ in range(5)]
    leaves = sets[0]
    copies = [x.clone() for x in leaves]
    ptrs = [bc.pool_pointers(x) for x in sets]
    bc.block_copy(leaves, src, dst, ptrs=ptrs[0])
    bc.block_copy_plain(copies, src, dst)
    torch.cuda.synchronize()
    err = check(f"{name}: {len(src)} rows x 27 latent pools",
                max(max_err(a, b) for a, b in zip(leaves, copies)), 0.0)
    del copies
    row_bytes = 16 * 576 * 2
    si = torch.from_numpy(src).to(dev).long()
    di = torch.from_numpy(dst).to(dev).long()

    def index_copy(leaves):
        for leaf in leaves:
            leaf.index_copy_(1, di, leaf.index_select(1, si))
    row = _row(
        name, "src/repro_torch/csrc/block_copy.cu",
        "src/repro/kernels/block_copy/kernel.py:26",
        {name: mla["launches"]["block_copy"]}, {name: err},
        2 * len(src) * 27 * row_bytes, 0,
        lambda: device_ms([lambda x=x, p=p: bc.block_copy(x, src, dst, ptrs=p)
                           for x, p in zip(sets, ptrs)], iters=50),
        lambda: device_ms([lambda x=x: bc.block_copy_plain(x, src, dst)
                           for x in sets], iters=10),
        lambda: device_ms([lambda x=x: index_copy(x) for x in sets],
                          iters=50))
    del sets
    return row


# Phase 8: the distributed serve path.  4 ranks share the one card
# (torch.multiprocessing, "spawn") and reduce over gloo: NCCL refuses two
# ranks on one device.  gloo takes every collective the port issues (all-
# reduce MAX / SUM, all_gather_into_tensor, all_to_all_single) on CUDA
# tensors as they are (an H100 machine's gloo took each one): no host
# staging in the port.  deepseek-7b at its published widths with 8 of 30
# layers (TRAIN's cut); B = 8 sequences in 16-token blocks, max_blocks 32,
# lengths drawn in 449..504 so that 8 decode steps stay inside 512 tokens;
# the pool holds B * max_blocks blocks, 64 on each rank.
DIST = dict(layers=8, B=8, bt=16, max_blocks=32, steps=8, world=4,
            moe_tokens=(512, 8), grad_shape=(4096, 11008))
DIST_MODES = {"flashdecode": (2, 2), "flashdecode_blocksharded": (2, 2)}


def _dist_tables(mode: str, world: int, mesh_shape, lengths) -> tuple:
    """The global block table of ``mode``'s placement and its sharded
    table and logical index (numpy): batch-sharded, sequence b on data
    shard b // (B / D) and its logical block lb on model rank lb % M
    (``tests/test_shardmap_paths.py``'s placement); block-sharded, block lb
    of every sequence on shard lb % world."""
    from repro_torch.convert import sharded_tables
    B, MB = DIST["B"], DIST["max_blocks"]
    nb_loc = B * MB // world
    D, M = mesh_shape
    tbl = np.full((B, MB), -1, np.int32)
    for b in range(B):
        for lb in range(MB):
            if mode == "flashdecode":
                Bl = B // D
                tbl[b, lb] = ((b // Bl) * M + lb % M) * nb_loc + b % Bl \
                    + (lb // M) * Bl
            else:
                tbl[b, lb] = (lb % world) * nb_loc + b + (lb // world) * B
    slots = M if mode == "flashdecode" else world
    return (tbl,) + sharded_tables(tbl, nb_loc=nb_loc, num_slots=slots)


def _dist_rank(rank: int, world: int, tmp: str, backend: str) -> None:
    """One rank of phase 8 (8a-8c with 4 gloo ranks, 8d alone on NCCL);
    writes its numbers to ``tmp/<backend><rank>.json``; raises on any
    disagreement, which fails the phase."""
    import datetime
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(tmp, f"store-{backend}"), world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        dev = torch.device("cuda", 0)
        res: dict = {"rank": rank}
        if world > 1:
            res.update(_dist_decode(rank, world, dev, DIST_MODES,
                                    DIST["steps"]))
            res.update(_dist_moe(rank, world, dev))
        else:
            res.update(_dist_decode(rank, 1, dev, {"flashdecode": (1, 1)},
                                    2))
        res.update(_dist_compress(rank, world, dev))
        Path(tmp, f"{backend}{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def _mesh(shape, names=("data", "model")):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cuda", torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=names)


def _pools_map(cache, fn):
    """``cache`` with ``fn(leaf, block axis)`` applied to every leaf (a
    scan segment's leaves are ``[reps, NB, ...]``, a plain layer's
    ``[NB, ...]``)."""
    def walk(node, axis):
        return {k: walk(v, axis) if isinstance(v, dict) else fn(v, axis)
                for k, v in node.items()}
    return {k: walk(v, 1 if k.startswith("s") else 0)
            for k, v in cache.items()}


def _dist_decode(rank, world, dev, modes, steps) -> dict:
    """8a: each mode's decode steps on this rank against one-process
    ``decode_step(attn_impl="gather")`` over the global pool on the same
    card; every ``paged_decode_partials`` call held to its plain version."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import flashdecode as fd
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.models import (PagedLayout, cache_init, decode_step,
                                    materialize, model_spec)
    from repro_torch.models.decode import pool_leaves
    cfg = dataclasses.replace(get_config("deepseek_7b"),
                              n_layers=DIST["layers"])
    B, bt, MB = DIST["B"], DIST["bt"], DIST["max_blocks"]
    layout = PagedLayout(num_blocks=B * MB, block_tokens=bt, max_blocks=MB)
    nb_loc = B * MB // world
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = materialize(gen, model_spec(cfg), device=dev,
                         dtype=torch.bfloat16)
    rng = np.random.default_rng(SEED)
    start = torch.from_numpy(rng.integers(449, 505, B).astype(np.int32))
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab, (steps, B)))
    drawn = cache_init(cfg, layout, B, torch.bfloat16, device=dev)
    for leaf in pool_leaves(drawn):
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device=dev))
    real = pa.paged_decode_partials
    worst = {"m": 0.0, "l": 0.0, "acc": 0.0, "heat": 0.0}

    def checked(*a, **kw):
        got = real(*a, **kw)
        want = pa.paged_decode_partials_plain(*a, **kw)
        for name, x, y in zip(worst, got, want):
            worst[name] = max(worst[name], max_err(x, y) / max(
                y.abs().max().item(), 1e-30))
        return got
    # flashdecode reaches the kernel through its module handle; the real
    # wrapper keeps its own name (and its launch count)
    fd.paged_ops = types.SimpleNamespace(paged_decode_partials=checked)
    real.launches = 0
    out: dict = {}
    try:
        for mode, shape in modes.items():
            mesh = _mesh(shape)
            fd.set_decode_mesh(mesh)
            shard, slot, _ = fd.shard_layout(mesh, mode == "flashdecode")
            rows = (slice(mesh.get_local_rank("data") * B // shape[0],
                          (mesh.get_local_rank("data") + 1) * B // shape[0])
                    if mode == "flashdecode" else slice(None))
            tbl, sh, sl = (torch.from_numpy(t).to(dev) for t in
                           _dist_tables(mode, world, shape, start))
            ref = _pools_map(drawn, lambda v, ax: v.clone())
            own = _pools_map(drawn, lambda v, ax: v.narrow(
                ax, shard * nb_loc, nb_loc).clone())
            # the sharded attention alone against the gather kernel on one
            # query batch over layer 0's pools (a comparison: its launch
            # is taken back off the count)
            # (in float32 too, where only the sharding's own arithmetic
            # parts the two)
            n = real.launches
            lens = (start + 1).to(dev)[rows].int()
            q = torch.randn(lens.shape[0], cfg.n_heads, cfg.head_dim,
                            generator=gen, device=dev)
            (pk, pv), (gk, gv) = (pool_leaves(c)[:2] for c in (own, ref))
            attn_err = {}
            for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
                got, _ = fd.paged_decode_attention_sharded(
                    q.to(dt), pk[0].to(dt), pv[0].to(dt), sh[rows, slot],
                    sl[rows, slot], lens, block_tokens=bt,
                    batch_sharded=mode == "flashdecode")
                want, _ = pa.paged_decode_attention(
                    q.to(dt), gk[0].to(dt), gv[0].to(dt),
                    tbl[rows].contiguous(), lens, block_tokens=bt)
                err = attn_err[str(dt)[6:]] = max_err(got, want)
                if not err <= tol:             # phase 2's / the GPU tests'
                    raise RuntimeError(f"8a {mode} rank {rank}: sharded "
                                       f"attention ({dt}) off by {err:.3e}")
            real.launches = n
            err = scale = 0.0
            for i in range(steps):
                lens = (start + i).to(dev)
                tok = tokens[i].to(dev)
                logits, _, heat = decode_step(
                    params, cfg, own, tok[rows], lens[rows], tbl[rows],
                    layout, attn_impl=mode, sharded_table=sh[rows, slot],
                    sharded_logical=sl[rows, slot])
                fd.set_decode_mesh(None)
                want, _, _ = decode_step(params, cfg, ref, tok, lens, tbl,
                                         layout)
                fd.set_decode_mesh(mesh)
                torch.cuda.synchronize()
                err = max(err, max_err(logits, want[rows]))
                scale = max(scale, want[rows].abs().max().item())
                # phase 3c's full-width bf16 logits tolerance
                if not err <= 2e-2 * max(1.0, scale):
                    raise RuntimeError(f"8a {mode} rank {rank} step {i}: "
                                       f"logits off by {err:.3e} (largest "
                                       f"|logit| {scale:.3f})")
            # pools: every row this rank owns against the global pool's
            mine, theirs = pool_leaves(own), pool_leaves(ref)
            diff = [int((a != b[:, shard * nb_loc:(shard + 1) * nb_loc])
                        .sum()) for a, b in zip(mine, theirs)]
            layer0 = all(bool(torch.equal(
                a[0], b[0, shard * nb_loc:(shard + 1) * nb_loc]))
                for a, b in zip(mine, theirs))
            out[mode] = {"attn_max_abs_err": attn_err,
                         "logits_max_abs_err": err, "logits_scale": scale,
                         "pool_diff": diff,
                         "layer0_pools_equal": layer0}
            if not layer0:
                raise RuntimeError(f"8a {mode} rank {rank}: layer 0's pool "
                                   "rows differ from the gather path's")
            fd.set_decode_mesh(None)
    finally:
        fd.paged_ops = pa
    out["partials_rel_err"] = worst
    out["partials_launches"] = real.launches
    if worst["heat"] > 1e-5 or worst["m"] > 1e-5 or worst["l"] > 1e-5 \
            or worst["acc"] > 1e-4:
        raise RuntimeError(f"8a rank {rank}: paged_decode_partials vs its "
                           f"plain version: {worst}")
    return {"decode": out}


def _dist_moe(rank, world, dev) -> dict:
    """8b: ``moe_apply_ep`` on a 1 x 4 mesh (E_loc 16) against the local
    ``moe_apply`` at the same capacity, on one MoE layer of
    deepseek-moe-16b."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import flashdecode as fd
    from repro_torch.models import materialize
    from repro_torch.models import moe as moe_mod
    cfg = get_config("deepseek_moe_16b")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    layer = materialize(gen, moe_mod.moe_spec(cfg.d_model, cfg.moe,
                                              cfg.mlp),
                        device=dev, dtype=torch.bfloat16)
    mesh = _mesh((1, world))
    part = moe_mod.moe_rank_params(layer, mesh.get_local_rank("model"),
                                   world)
    out = {}
    for T in DIST["moe_tokens"]:
        x = torch.randn(T, cfg.d_model, generator=gen, device=dev).to(
            torch.bfloat16)
        want, want_aux = moe_mod.moe_apply(layer, x, cfg.moe, cfg.mlp)
        fd.set_decode_mesh(mesh)
        try:
            got, aux = moe_mod.moe_apply(part, x, cfg.moe, cfg.mlp)
        finally:
            fd.set_decode_mesh(None)
        torch.cuda.synchronize()
        res = out[f"T{T}"] = {"max_abs_err": max_err(got, want),
                              "scale": want.abs().max().item(),
                              "aux_err": abs(aux.item() - want_aux.item())}
        if not (res["max_abs_err"] <= 2e-2 * max(1.0, res["scale"])
                and res["aux_err"] <= 1e-6):
            raise RuntimeError(f"8b T={T} rank {rank}: {out[f'T{T}']}")
    return {"moe": out}


def _dist_compress(rank, world, dev) -> dict:
    """8c: every rank's float32 leaf of deepseek-7b's MLP shape, its int8
    compressed mean over the data axis against the exact mean."""
    from repro_torch.distributed.compression import (compressed_psum_mean,
                                                     wire_bytes)
    shape = DIST["grad_shape"]

    def leaf(r):
        g = torch.Generator(device=dev).manual_seed(SEED + 1 + r)
        return torch.randn(shape, generator=g, device=dev)
    g = leaf(rank)
    mesh = _mesh((world, 1))
    mean, new_err = compressed_psum_mean(g, mesh, "data")
    exact = sum(leaf(r) for r in range(world)) / world
    rel = max_err(mean, exact) / exact.abs().max().item()
    if not rel < 0.02:
        raise RuntimeError(f"8c rank {rank}: relative error {rel}")
    if world == 1 and not torch.equal(mean + new_err, g):
        raise RuntimeError("8d: the mean of one rank plus its error "
                           "feedback is not its input")
    return {"compress": {"rel_err": rel, "wire_bytes": wire_bytes(g),
                         "f32_bytes": 4 * g.numel()}}


def _dist_phase() -> int:
    """Phase 8 (module docstring).  Returns ``paged_decode_partials``'
    launches in 8a, summed over the ranks."""
    import torch.multiprocessing as mp
    print(f"[8] distributed serve path: {DIST['world']} ranks on the one "
          f"card over gloo (NCCL puts no two ranks on one device; gloo "
          f"takes all-reduce MAX/SUM, all_gather_into_tensor and "
          f"all_to_all_single on the CUDA tensors as they are, no host "
          f"staging in the port); deepseek-7b {DIST['layers']} of 30 "
          f"layers at full width, B {DIST['B']}, {DIST['steps']} steps per "
          f"mode", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for backend, world in (("gloo", DIST["world"]), ("nccl", 1)):
            try:
                mp.start_processes(_dist_rank, args=(world, tmp, backend),
                                   nprocs=world, start_method="spawn")
            except Exception as e:     # a rank raised or died
                fail(f"phase 8 ({backend}, {world} ranks): {e}")
        res = {b: [json.loads(Path(tmp, f"{b}{r}.json").read_text())
                   for r in range(w)]
               for b, w in (("gloo", DIST["world"]), ("nccl", 1))}
    wall = time.perf_counter() - t0
    for r in res["gloo"]:
        dec = r["decode"]
        print(f"  [8a] rank {r['rank']}: " + "; ".join(
            f"{m}: attention vs the gather kernel max_abs_err "
            f"{dec[m]['attn_max_abs_err']}, logits max_abs_err "
            f"{dec[m]['logits_max_abs_err']:.3e} "
            f"(largest |logit| {dec[m]['logits_scale']:.3f}), "
            f"pool elements differing per leaf {dec[m]['pool_diff']} "
            f"(layer 0 equal: {dec[m]['layer0_pools_equal']})"
            for m in DIST_MODES) + f"; partials vs plain (relative) "
            f"{dec['partials_rel_err']}, launches "
            f"{dec['partials_launches']}", flush=True)
    for r in res["gloo"]:
        print(f"  [8b] rank {r['rank']}: moe_apply_ep (1 x 4, E_loc 16) vs "
              f"local moe_apply: {r['moe']}", flush=True)
    c = res["gloo"][0]["compress"]
    print(f"  [8c] int8 compressed mean of 4 x {list(DIST['grad_shape'])} "
          f"float32: relative error "
          f"{max(r['compress']['rel_err'] for r in res['gloo']):.4e} (< "
          f"0.02); {c['wire_bytes']} bytes on the wire per rank against "
          f"{c['f32_bytes']} in float32 ({c['f32_bytes'] / c['wire_bytes']:.2f}x)",
          flush=True)
    n = res["nccl"][0]
    print(f"  [8d] NCCL, world size 1: decode logits max_abs_err "
          f"{n['decode']['flashdecode']['logits_max_abs_err']:.3e} vs the "
          f"gather path, compressed mean relative error "
          f"{n['compress']['rel_err']:.4e}, mean + feedback == input",
          flush=True)
    print(f"  phase 8 wall {wall:.1f}s (4 ranks sharing one card: not the "
          f"times of 4 cards)", flush=True)
    return sum(r["decode"]["partials_launches"] for r in res["gloo"])


def _partials_row(gen, dev, pa, launches: int) -> dict:
    """``paged_decode_partials`` at one rank's 8a shape (rank 0 of the
    batch-sharded mode: B 4, 32 x 128, 16 slots of 16 tokens), L2-cold over
    8 layers' pools, beside its plain version and its byte bound."""
    from repro_torch.distributed.flashdecode import owned_blocks
    B, MB, world = DIST["B"], DIST["max_blocks"], DIST["world"]
    nb_loc = B * MB // world
    rng = np.random.default_rng(SEED)
    start = rng.integers(449, 505, B).astype(np.int32)
    tbl, sh, sl = _dist_tables("flashdecode", world, (2, 2), start)
    rows = slice(0, B // 2)
    table = owned_blocks(torch.from_numpy(sh[rows, 0]).to(dev), 0, nb_loc)
    logical = torch.from_numpy(np.ascontiguousarray(sl[rows, 0])).to(dev)
    lengths = torch.from_numpy(start[rows] + 1).to(dev)
    return _partials_shape_row(gen, dev, pa, "paged_decode_partials", table,
                               logical, lengths, nb_loc, launches,
                               layers=DIST["layers"], what="8a")


def _partials_shape_row(gen, dev, pa, name, table, logical, lengths, nb_loc,
                        launches: int, *, layers: int, what: str) -> dict:
    """``paged_decode_partials`` on one rank's shard (deepseek-7b's 32 x
    128 heads, 16-token blocks, ``nb_loc`` pool rows, this ``table`` of
    local rows), L2-cold over ``layers`` layers' pools, beside its plain
    version and its byte bound; the row is named ``name``."""
    bt, H, KVH, hd = DIST["bt"], 32, 32, 128
    Bl = table.shape[0]
    q = torch.randn(Bl, H, hd, generator=gen, device=dev).bfloat16()
    pools = [tuple(torch.randn(nb_loc, bt, KVH, hd, generator=gen,
                               device=dev).bfloat16() for _ in range(2))
             for _ in range(layers)]
    got = pa.paged_decode_partials(q, *pools[0], table, lengths,
                                   block_tokens=bt, logical=logical)
    torch.cuda.synchronize()
    want = pa.paged_decode_partials_plain(q, *pools[0], table, lengths,
                                          block_tokens=bt, logical=logical)
    abs_err = 0.0
    for part, a, b, tol in zip(("m", "l", "acc", "heat"), got, want,
                               (1e-5, 1e-5, 1e-4, 1e-5)):
        scale = max(b.abs().max().item(), 1e-30)
        check(f"{name} {part} (f32, relative to its largest magnitude "
              f"{scale:.3g})", max_err(a, b) / scale, tol)
        abs_err = max(abs_err, max_err(a, b))
    errs = {name: abs_err}
    pos = (logical.clamp_min(0).long()[:, :, None] * bt
           + torch.arange(bt, device=dev))
    n_tok = int(((table >= 0)[:, :, None] & (pos < lengths[:, None, None]))
                .sum())
    byts = n_tok * KVH * hd * 2 * 2 + q.numel() * 2 + 2 * table.numel() * 4 \
        + lengths.numel() * 4 + Bl * H * (hd + 2) * 4 + table.numel() * 4
    print(f"  {name} at one rank's {what} shape: B {Bl}, {H} x {hd}, "
          f"{table.shape[1]} slots of {bt} tokens, {n_tok} valid tokens, "
          f"{n_tok * KVH * hd * 4 / 1e6:.1f} MB of K/V read per layer "
          f"(L2-cold: {len(pools)} layers' pools in turn)", flush=True)

    def per_layer(fn):
        return [lambda pk=pk, pv=pv: fn(pk, pv) for pk, pv in pools]
    return _row(
        name, "src/repro_torch/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention/kernel.py:99",
        {name: launches}, errs, byts, 4 * n_tok * H * hd,
        lambda: device_ms(per_layer(lambda pk, pv: pa.paged_decode_partials(
            q, pk, pv, table, lengths, block_tokens=bt, logical=logical))),
        lambda: device_ms(per_layer(
            lambda pk, pv: pa.paged_decode_partials_plain(
                q, pk, pv, table, lengths, block_tokens=bt,
                logical=logical)), iters=16),
        None)


# Phase 7: deepseek-7b at its published widths, depth cut to 8 of 30 layers
# (at full depth the float32 weights, gradients and AdamW moments, 16 bytes
# per param, would take 110.6 GB), 4 x (1024 + 1) tokens a step; the
# learning rate warms up over 2 steps to 5e-4 and decays by cosine over 12.
TRAIN = dict(layers=8, batch=4, seq=1024, steps=12, base_lr=5e-4, warmup=2)


def _kernel_times(fn) -> dict:
    """name -> (launches, total microseconds) of every device kernel one call
    of ``fn`` launches, as ``torch.profiler`` records them (full names)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, t = out.get(e.name, (0, 0.0))
            out[e.name] = (n + 1, t + e.time_range.elapsed_us())
    return out


def _training_phase(gen, dev, fa) -> dict:
    """Phase 7 (see the module docstring).  Returns the flash forward and
    backward kernels' launches over the timed steps."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.data import make_batch_iter, synthetic_batch
    from repro_torch.models import lm_loss, materialize, model_spec
    from repro_torch.models import transformer
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.training import make_train_step
    from repro_torch.training import train_step as train_step_mod
    full = get_config("deepseek_7b")
    cfg = dataclasses.replace(full, n_layers=TRAIN["layers"])
    B, S, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    print(f"[7] train deepseek-7b at full width: {cfg.n_layers} of "
          f"{full.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} x "
          f"{cfg.head_dim} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"{B} x ({S} + 1) tokens a step, {steps} steps, bf16 compute over "
          f"float32 master weights, remat on; lr {TRAIN['base_lr']} after "
          f"{TRAIN['warmup']} warm-up steps, cosine over {steps}",
          flush=True)
    t0 = time.perf_counter()
    params = materialize(gen, model_spec(cfg), device=dev)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  params: {n_params / 1e9:.3f}B in float32; weights, gradients "
          f"and AdamW's two moments {16 * n_params / 1e9:.1f} GB; drawn in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    step_fn = make_train_step(cfg, base_lr=TRAIN["base_lr"],
                              warmup_steps=TRAIN["warmup"], total_steps=steps,
                              chunk=1024)
    data = make_batch_iter(cfg, B, S, device=dev)
    bwd = (fa.flash_bwd_preprocess, fa.flash_bwd_dkdv, fa.flash_bwd_dq)
    real_bwd = fa.flash_attention_bwd
    saved: dict = {}

    def keep_first(*a, **kw):
        """The backward of the last step's first attention call, with its
        inputs, for the bit-for-bit repeat below."""
        grads = real_bwd(*a, **kw)
        if not saved:
            saved.update(args=a, kw=kw, grads=[g.clone() for g in grads])
        return grads

    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    totals = {"flash_attention": 0, **{f.__name__: 0 for f in bwd}}
    for step in range(steps):
        batch = next(data)
        fa.flash_attention.launches = 0
        for f in bwd:
            f.launches = 0
        if step == steps - 1:
            fa.flash_attention_bwd = keep_first
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        loss = m["loss"].item()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        fa.flash_attention_bwd = real_bwd
        per = {"flash_attention": fa.flash_attention.launches,
               **{f.__name__: f.launches for f in bwd}}
        for k, n in per.items():
            totals[k] += n
        losses.append(loss)
        print(f"  step {step}: loss {loss:.4f} lr {m['lr'].item():.3e} "
              f"grad_norm {m['grad_norm'].item():.4f} wall {walls[-1]:.3f}s "
              f"launches {per}", flush=True)
        if per["flash_attention"] != 2 * cfg.n_layers:
            fail(f"step {step}: {per['flash_attention']} flash forward "
                 f"launches, not {2 * cfg.n_layers} (each layer's forward "
                 f"and its remat recompute)")
        for f in bwd:
            if per[f.__name__] != cfg.n_layers:
                fail(f"step {step}: {per[f.__name__]} {f.__name__} "
                     f"launches, not {cfg.n_layers}")
    peak = torch.cuda.max_memory_allocated()
    print(f"  clocks after the timed steps (SM, max SM, power, temperature): "
          f"{_clocks()}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"a training loss is not finite: {losses}")
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    print(f"  loss mean of the first 3 steps {first:.4f}, of the last 3 "
          f"{last:.4f}; step wall p50 {float(np.median(walls[1:])):.4f}s "
          f"(steps 1..{steps - 1}; step 0 {walls[0]:.3f}s); peak allocated "
          f"{peak / 1e9:.2f} GB; launches over the {steps} steps {totals}",
          flush=True)
    if not last < first:
        fail(f"the loss did not fall: first 3 steps {first}, last 3 {last}")
    again = [real_bwd(*saved["args"], **saved["kw"]) for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for run in again
               for a, b in zip(run, saved["grads"])):
        fail("the attention backward on one layer's saved inputs gave other "
             "bits when run again")
    print("  the attention backward, run twice more on the last step's first "
          "layer's saved inputs: dQ, dK and dV bit-identical", flush=True)
    del saved, again

    # one more step under the profiler, after the timed ones; AdamW's time
    # from CUDA events around it
    events = []
    real_update = train_step_mod.adamw_update

    def timed_update(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real_update(*a, **kw)
        ev[1].record()
        events.append(ev)
        return out
    bwd_events = []

    def timed_bwd(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real_bwd(*a, **kw)
        ev[1].record()
        bwd_events.append(ev)
        return out
    train_step_mod.adamw_update = timed_update
    fa.flash_attention_bwd = timed_bwd
    batch = next(data)
    times = _kernel_times(lambda: step_fn(params, opt, batch))
    train_step_mod.adamw_update = real_update
    fa.flash_attention_bwd = real_bwd
    torch.cuda.synchronize()
    total = sum(t for _, t in times.values())
    fwd = sum(t for k, (_, t) in times.items()
              if "flash_wgmma_kernel" in k or "flash_f32_kernel" in k)
    bwd_t = sum(t for k, (_, t) in times.items() if "flash_bwd" in k)
    adamw_ms = events[0][0].elapsed_time(events[0][1])
    bwd_ev = sum(a.elapsed_time(b) for a, b in bwd_events)
    print(f"  profiled step: device busy {total / 1e3:.2f} ms over "
          f"{sum(n for n, _ in times.values())} kernels; flash forward "
          f"{fwd / 1e3:.3f} ms, AdamW (norm, clip, moments, update) "
          f"{adamw_ms:.2f} ms (CUDA events)", flush=True)
    print(f"  flash backward a step ({len(bwd_events)} calls of preprocess, "
          f"dkdv and dq): {bwd_t / 1e3:.3f} ms of kernels (torch.profiler), "
          f"{bwd_ev:.3f} ms between CUDA events around the calls", flush=True)
    for name, (n, t) in sorted(times.items(), key=lambda kv: -kv[1][1])[:14]:
        print(f"    {t / 1e3:9.3f} ms  {n:5d} x  {name[:110]}", flush=True)
    del params, opt, step_fn, data, batch
    gc.collect()
    torch.cuda.empty_cache()

    # gradient check at full width, 2 layers, 1 x 1024 tokens: the kernels
    # against the plain attention, both on the card (bf16 compute)
    cfg2 = dataclasses.replace(full, n_layers=2)
    params = materialize(gen, model_spec(cfg2), device=dev)
    batch = synthetic_batch(cfg2, 1, S, 1000, device=dev)
    kernel_flash = transformer.flash_attention

    def plain_flash(q, k, v, **kw):
        return fa.flash_attention_plain(q, k, v, **kw)

    res = {}
    for route in ("kernels", "plain"):
        transformer.flash_attention = (kernel_flash if route == "kernels"
                                       else plain_flash)
        n = fa.flash_bwd_dq.launches
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = lm_loss(p, cfg2, batch, chunk=1024)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        torch.cuda.synchronize()
        res[route] = (loss.item(), grads, fa.flash_bwd_dq.launches - n)
        del p, grads, loss
    transformer.flash_attention = kernel_flash
    if res["kernels"][2] != cfg2.n_layers or res["plain"][2] != 0:
        fail(f"gradient check: backward launches {res['kernels'][2]} on the "
             f"kernel route, {res['plain'][2]} on the plain one")
    names = _leaf_names(params)
    worst = max((max_err(a, b) / max(b.float().abs().max().item(), 1e-30),
                 name) for name, a, b in zip(names, res["kernels"][1],
                                             res["plain"][1]))
    dl = abs(res["kernels"][0] - res["plain"][0])
    print(f"  gradient check (2 layers, 1 x {S} tokens, bf16 compute): loss "
          f"{res['kernels'][0]:.5f} through the kernels, "
          f"{res['plain'][0]:.5f} through the plain attention; worst of "
          f"{len(names)} leaves {worst[1]}: max|d|/max|g| = "
          f"{worst[0]:.3e} (tol 2e-2)", flush=True)
    if not (worst[0] <= 2e-2 and dl <= 2e-2 * abs(res["plain"][0])):
        fail(f"gradient check: worst leaf {worst}, loss difference {dl}")
    del params, res
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def _leaf_names(tree, prefix: str = "") -> list:
    """The paths of a dict/list tree's leaves, in ``_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def _pairs(Sq: int, Sk: int, causal: bool, window) -> int:
    """The (query, key) pairs one head attends."""
    i = np.arange(Sq)
    hi = np.minimum(i + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(0, i - window + 1) if window is not None else 0
    return int(np.maximum(hi - lo, 0).sum())


def _bwd_rows(gen, dev, fa, train_launches) -> list:
    """Phase 7b (see the module docstring)."""
    from repro_torch.configs.base import get_config
    print("[7b] training kernels vs plain versions on the card; device time "
          "per call (torch.profiler); SDPA's backward as the yardstick",
          flush=True)
    bf16 = torch.bfloat16
    nem, gem = get_config("nemotron_4_15b"), get_config("gemma3_27b")
    m = get_config("deepseek_v2_lite_16b").mla
    B7, S7 = TRAIN["batch"], TRAIN["seq"]
    # (suffix, B, Sq, Sk, H, KVH, hd, hdv, causal, window, trained)
    shapes = (
        ("", B7, S7, S7, 32, 32, 128, 128, True, None, True),
        ("_gqa6", 2, 1024, 1024, nem.n_heads, nem.kv_heads, nem.head_dim,
         nem.head_dim, True, None, False),
        ("_gemma3_window", 1, 2048, 2048, gem.n_heads, gem.kv_heads,
         gem.head_dim, gem.head_dim, True, gem.attn.window, False),
        ("_mla", 2, 1024, 1024, 16, 16, m.qk_nope + m.qk_rope, m.v_head,
         True, None, False),
        ("_whisper_encoder", 2, 1500, 1500, 16, 16, 64, 64, False, None,
         False),
        ("_whisper_cross", 2, 448, 1500, 16, 16, 64, 64, False, None, False))
    from repro_torch.kernels import build
    print(f"  backward library SASS: "
          f"{_sass_count(build, 'flash_attention_bwd', 'HGMMA')} HGMMA "
          f"instructions (cuobjdump -sass)", flush=True)
    rows = []
    for sfx, *shape, trained in shapes:
        counts = {k: train_launches[k] if trained else 0 for k in
                  ("flash_bwd_preprocess", "flash_bwd_dkdv", "flash_bwd_dq",
                   "flash_attention")}
        rows.extend(_bwd_shape_rows(gen, dev, fa, sfx, shape, counts))

    # serving pays nothing for the LSE: the forward at phase 2's shape with
    # the LSE pointer null (the serving call) and set, in turns, each timed
    # over a CUDA graph (profiler sessions this late lose events)
    S = 448
    q, k, v = (torch.randn(1, S, 32, 128, generator=gen, device=dev).to(bf16)
               for _ in range(3))

    def off():
        return fa.flash_attention(q, k, v, causal=True)

    def on():
        return fa._forward(q, k, v, causal=True, window=None, soft_cap=None,
                           chunk=1024, return_lse=True)
    print(f"  clocks after the backward rows (SM, max SM, power, "
          f"temperature): {_clocks()}", flush=True)
    t = [event_ms(f) for f in (off, on, on, off)]
    print(f"  serving forward at S={S} (phase 2's shape), ms in turns LSE "
          f"off / on / on / off: {t[0]:.5f} / {t[1]:.5f} / {t[2]:.5f} / "
          f"{t[3]:.5f} (off mean {(t[0] + t[3]) / 2:.5f}, on mean "
          f"{(t[1] + t[2]) / 2:.5f})", flush=True)
    return rows


def _bwd_shape_rows(gen, dev, fa, sfx, shape, counts) -> list:
    """The flash backward's three kernels and the forward with LSE at one
    ``shape`` (B, Sq, Sk, H, KVH, hd, hdv, causal, window), each held to
    its plain version and timed beside SDPA; ``counts``: their launches on
    a path (keys ``flash_bwd_preprocess``, ``flash_bwd_dkdv``,
    ``flash_bwd_dq``, ``flash_attention``)."""
    B, Sq, Sk, H, KVH, hd, hdv, causal, window = shape
    bf16 = torch.bfloat16
    rows = []
    replaces_bwd = "src/repro/models/attention.py:33"
    src_bwd = "src/repro_torch/csrc/flash_attention_bwd.cu"
    plan = fa._bwd_plan(hd, hdv, bf16)
    print(f"  backward{sfx or '_main'}: route {plan.route} (kernel "
          f"widths {plan.hd} / {plan.hdv})", flush=True)
    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf16)
    q, k, v, dout = (rn(B, Sq, H, hd), rn(B, Sk, KVH, hd),
                     rn(B, Sk, KVH, hdv), rn(B, Sq, H, hdv))
    opts = dict(causal=causal, window=window, soft_cap=None)
    out, lse = fa._forward(q, k, v, chunk=1024, return_lse=True, **opts)
    got = fa.flash_attention_bwd(q, k, v, out, dout, lse, **opts)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, out, dout, lse,
                                        chunk=1024, **opts)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(fa.flash_attention_plain(
        *leaves, chunk=1024, **opts), leaves, dout)
    del leaves
    what = (f"B={B} Sq={Sq} Sk={Sk} H={H} KVH={KVH} hd={hd} hdv={hdv} "
            f"causal={causal} window={window} (bf16)")
    errs = {}
    for name, g, w, a in zip(("dq", "dk", "dv"), got, want, auto):
        scale = w.float().abs().max().item()
        errs[name] = check(f"flash backward{sfx} {name} vs "
                           f"flash_attention_bwd_plain, {what}, "
                           f"max|d| / max|g| (max|g| {scale:.3g})",
                           max_err(g, w) / scale, 2e-2) * scale
        check(f"flash backward{sfx} {name} vs autograd of "
              f"flash_attention_plain, max|d| / max|g|",
              max_err(g, a) / a.float().abs().max().item(), 2e-2)
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, chunk=1024,
                                                return_lse=True, **opts)
    lse_err = check(f"flash forward{sfx} LSE vs plain",
                    max_err(lse, ref_lse), 1e-3)
    check(f"flash forward{sfx} output vs plain", max_err(out, ref_out),
          2e-2)
    D = fa.flash_bwd_preprocess(out, dout)
    del auto, want, ref_out, ref_lse, got
    pairs = B * H * _pairs(Sq, Sk, causal, window)
    n_q, n_k = B * Sq * H, B * Sk * KVH
    launches = {}
    for kname in ("flash_bwd_preprocess", "flash_bwd_dkdv",
                  "flash_bwd_dq"):
        launches[kname + sfx] = counts[kname]
    launches["flash_attention_lse" + sfx] = counts["flash_attention"]
    errs_row = {"flash_bwd_preprocess" + sfx: 0.0,
                "flash_bwd_dkdv" + sfx: max(errs["dk"], errs["dv"]),
                "flash_bwd_dq" + sfx: errs["dq"],
                "flash_attention_lse" + sfx: lse_err}

    # SDPA on the same inputs, heads expanded to H for GQA, the window
    # as a boolean mask: its backward is the library yardstick
    G = H // KVH
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k.repeat_interleave(G, dim=2),
                            v.repeat_interleave(G, dim=2)))
    mask = None
    if window is not None:
        i = torch.arange(Sq, device=dev)[:, None]
        j = torch.arange(Sk, device=dev)[None, :]
        mask = (j <= i) & (j > i - window)
    dot = dout.transpose(1, 2)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask,
            is_causal=causal and mask is None)
    try:
        o_lib = sdpa()
        torch.autograd.grad(o_lib, (qt, kt, vt), dot, retain_graph=True)
    except RuntimeError as e:       # no SDPA backend takes the shape
        print(f"  SDPA refused{sfx}: {str(e)[:200]}", flush=True)
        o_lib = None

    def sdpa_bwd():
        return torch.autograd.grad(o_lib, (qt, kt, vt), dot,
                                   retain_graph=True)
    lib_bwd = None if o_lib is None else device_ms(
        [sdpa_bwd], iters=30, what=" for SDPA's backward", capture=False)
    bound = 2 * pairs * (3 * hd + 2 * hdv) / BF16_FLOP_PER_S * 1e3
    if lib_bwd is not None and lib_bwd < bound:
        # late in the run the profiler can record a small kernel of the
        # call and none of cuDNN's: a time the card cannot reach
        print(f"  (SDPA's backward read {lib_bwd:.4f} ms, under the card's "
              f"least time {bound:.4f} ms: the profiler missed its "
              f"kernels)", flush=True)
        lib_bwd = event_ms(sdpa_bwd, capture=False)
    lib_fwd = None if o_lib is None else library_ms(
        lambda: sdpa().detach())
    plain_bwd = device_ms([lambda: fa.flash_attention_bwd_plain(
        q, k, v, out, dout, lse, chunk=1024, **opts)], iters=3,
        warmup=1)
    byts = {"in_q": n_q * hd * 2, "in_k": n_k * hd * 2,
            "in_v": n_k * hdv * 2, "o": n_q * hdv * 2,
            "rows": B * H * Sq * 4}
    common = dict(source=src_bwd, replaces=replaces_bwd)
    rows.append(_row(
        "flash_bwd_preprocess" + sfx, common["source"],
        common["replaces"], launches, errs_row,
        2 * byts["o"] + byts["rows"], 2 * n_q * hdv,
        lambda: device_ms([lambda: fa.flash_bwd_preprocess(out, dout)]),
        lambda: device_ms([lambda: (dout.float() * out.float()).sum(-1)],
                          iters=10),
        # one library call of the same row sums; it writes bf16 [B, Sq, H]
        # where the kernel writes float32 [B, H, Sq]
        lambda: library_ms(lambda: torch.linalg.vecdot(dout, out))))
    rows.append(_row(
        "flash_bwd_dkdv" + sfx, common["source"], common["replaces"],
        launches, errs_row,
        byts["in_q"] + 2 * byts["in_k"] + 2 * byts["in_v"] + byts["o"]
        + 2 * byts["rows"], 2 * pairs * (2 * hd + 2 * hdv),
        lambda: device_ms([lambda: fa.flash_bwd_dkdv(
            q, k, v, dout, lse, D, **opts)], iters=10, warmup=2),
        lambda: plain_bwd, None if lib_bwd is None else lambda: lib_bwd))
    rows.append(_row(
        "flash_bwd_dq" + sfx, common["source"], common["replaces"],
        launches, errs_row,
        2 * byts["in_q"] + byts["in_k"] + byts["in_v"] + byts["o"]
        + 2 * byts["rows"], 2 * pairs * (2 * hd + hdv),
        lambda: device_ms([lambda: fa.flash_bwd_dq(
            q, k, v, dout, lse, D, **opts)], iters=10, warmup=2),
        lambda: plain_bwd, None if lib_bwd is None else lambda: lib_bwd))
    rows.append(_row(
        "flash_attention_lse" + sfx,
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:90", launches,
        errs_row, byts["in_q"] + byts["in_k"] + byts["in_v"] + byts["o"]
        + byts["rows"], 2 * pairs * (hd + hdv),
        lambda: device_ms([lambda: fa._forward(
            q, k, v, chunk=1024, return_lse=True, **opts)]),
        lambda: device_ms([lambda: fa.flash_attention_plain(
            q, k, v, chunk=1024, return_lse=True, **opts)], iters=3,
            warmup=1),
        None if lib_fwd is None else lambda: lib_fwd))
    whole = sum(r["ms"] for r in rows[-4:-1])
    print(f"  backward{sfx} ({what}): the three kernels {whole:.4f} ms "
          f"against a bound of {bound:.4f} ms (operations: 2.5x the "
          f"forward's at hd = hdv) and SDPA's backward {lib_bwd} ms",
          flush=True)
    del q, k, v, dout, out, lse, D, qt, kt, vt, o_lib, mask
    torch.cuda.empty_cache()
    return rows


def _trainer_phase(dev) -> None:
    """Phase 7c (see the module docstring)."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data import make_batch_iter
    from repro_torch.distributed import SimulatedFailure
    from repro_torch.models import materialize, model_spec
    from repro_torch.training import Trainer, TrainerConfig
    print("[7c] the fault-tolerant Trainer on the card: deepseek-7b smoke, 30 "
          "steps of 8 x 32 tokens, a checkpoint every 10, a simulated "
          "failure at step 12", flush=True)
    cfg = get_smoke_config("deepseek_7b")
    params = materialize(torch.Generator(device=dev).manual_seed(SEED),
                         model_spec(cfg), device=dev)
    crash = {"armed": True}

    def failure_hook(step):
        if step == 12 and crash["armed"]:
            crash["armed"] = False
            raise SimulatedFailure()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        store = CheckpointStore(tmp)
        out = Trainer(TrainerConfig(num_steps=30, checkpoint_every=10,
                                    log_every=5, base_lr=1e-3, chunk=16),
                      cfg, params, make_batch_iter(cfg, 8, 32, device=dev),
                      store, failure_hook=failure_hook).run()
        wall = time.perf_counter() - t0
        kept = store.all_steps()
    losses = [(m["step"], round(m["loss"], 4)) for m in out["metrics"]]
    print(f"  restarts {out['restarts']}, final step {out['final_step']}, "
          f"checkpoints kept {kept}, {wall:.1f}s; logged (step, loss) "
          f"{losses}", flush=True)
    if out["restarts"] != 1 or out["final_step"] != 30:
        fail(f"Trainer: {out['restarts']} restarts, final step "
             f"{out['final_step']}")
    if not losses[-1][1] < losses[0][1] - 0.2:
        fail(f"Trainer: the loss fell by less than 0.2: {losses}")


def _print_rows(rows) -> None:
    for r in rows:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), roofline "
              f"share {r['bound_ms'] / r['ms']:.1%}", flush=True)


def _row(name, source, replaces, launches, errs, byts, flops, time_kernel,
         time_plain, time_library) -> dict:
    """One kernel's line; ``time_*`` return milliseconds."""
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": time_kernel(),
            "plain_ms": time_plain(),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if time_library is None else time_library()}


def _two_class_case(gen, dev, *, B, NB):
    """Tables of two page-size classes per row: 8 one-block pages (logical
    0..7) from the low half of the pool and 6 four-block pages (logical
    2..7, blocks 8..31) from the high half; lengths 449..512."""
    t0 = torch.stack([torch.randperm(NB // 2, generator=gen, device=dev)[:8]
                      for _ in range(B)]).int()
    t1 = torch.stack([NB // 2 + 4 * torch.randperm(NB // 8, generator=gen,
                                                   device=dev)[:6]
                      for _ in range(B)]).int()
    l0 = torch.arange(8, device=dev).int().expand(B, 8).contiguous()
    l1 = (2 + torch.arange(6, device=dev)).int().expand(B, 6).contiguous()
    lengths = torch.randint(449, 513, (B,), generator=gen, device=dev).int()
    return (t0, t1), (l0, l1), lengths


def _device_kernels(fn) -> list:
    """(name, microseconds) of each device kernel or copy that one call of
    ``fn`` launches, as ``torch.profiler`` records them."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(re.sub(r"^void |\(anonymous namespace\)::", "", e.name)
             .split("<")[0].split("(")[0], e.time_range.elapsed_us())
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _busy(kernels, wall: float) -> str:
    """The device's busy time in a profiled step, from the kernels and
    copies :func:`_device_kernels` recorded, against the ``wall`` seconds
    of the same step unprofiled, and the five names that took most of
    it."""
    busy = sum(us for _, us in kernels) / 1e6
    if busy <= 0:
        return "device busy: not measured (the profiler recorded nothing)"
    by_name: dict = {}
    for name, us in kernels:
        by_name[name] = by_name.get(name, 0.0) + us / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return (f"device busy {busy:.4f} s of the warm step's {wall:.3f} s "
            f"wall (idle {100 * (1 - busy / wall):.1f}%), "
            f"{len(kernels)} kernels and copies; most time: "
            f"{[(k, round(v, 4)) for k, v in top]}")


def _clocks() -> str:
    """The card's SM clock (and its maximum), power draw and temperature
    now, as ``nvidia-smi`` reads them: compute-bound times scale with the
    clock, which a card may lower under load."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def _sass_count(build, lib: str, opcode: str) -> str:
    """How often ``opcode`` occurs in the SASS of a built kernel library."""
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "cuobjdump"
    if not tool.exists():
        return "not measured (no cuobjdump)"
    sass = subprocess.run([str(tool), "-sass",
                           str(build._build_dir() / f"lib{lib}.so")],
                          capture_output=True, text=True).stdout
    return str(sum(any(tok.split(".")[0] == opcode for tok in line.split())
                   for line in sass.splitlines()))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


if __name__ == "__main__":
    main()
