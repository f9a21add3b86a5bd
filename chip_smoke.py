"""Quickest proof that the PyTorch port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``).  Phases, each fatal
on failure:

  1. build every kernel of the serving path from ``src/repro_torch/csrc``;
  2. hold each kernel against its plain PyTorch version on the card at the
     serving path's shapes (decode B in {2, 4}, 32 heads x 128, 16-token
     blocks, up to 512 tokens; prefill 448 tokens; suffix prefill with a
     query offset, prefix 256 + suffix 192 and prefix 208 + suffix 240 over
     448 keys), and a small model run through the kernels against the same
     run on the plain versions;
  2b. run the batched policy executor on the card: the predicated
     executor on CUDA tensors against the host interpreter (``PolicyVM``),
     bit for bit (decisions, and ring events where the program emits
     them), for the Figure-1 program at 8 and 64 regions, ``tier_damon``,
     ``evict_lru`` and ``profile_wss`` (timed in phase 4); then a profile
     reload (a map write) between two ``run_batch`` calls, after which the
     CUDA executors' decisions must follow the new map;
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
     another; the cache must hit (>= 3) and the suffix prefills must launch
     flash with a query offset; a hit's last-token logits are held to a
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
  4. time each kernel, its plain version and a yardstick PyTorch call, next
     to the least time the card could take for the same work, and print
     each one's share of that bound.  Paged decode is timed L2-cold: the
     launches walk the serving engine's 30 per-layer KV pools in turn, as
     the decode step does, so no launch finds its K/V in the 50 MB L2.  Also
     printed: the two-class paged decode (``paged_decode_multi``), the
     device kernels one paged call launches (``torch.profiler``), and the
     count of ``HGMMA`` (tensor-core) instructions in the flash library
     (``cuobjdump -sass``), and the Figure-1 and ``profile_wss`` executors'
     time per ``run_batch`` at buckets 4, 16 and 64 (device and wall).
     Nothing is profiled before the serving phases, whose walls are
     printed.

Each serving phase sets the launch counts to 0 just before its run, reads
and prints them just after, and fails if the policy supervisor struck or
detached any program (a batch executor that raises on the card) — except
the chaos phase, where every strike must be an injected one.  Prints one
JSON line with the kernels' numbers (launches from phase 3; the q_offset
flash case as a row of its own, its launches from phase 3c), the card's
name and power limit, and last ``{"ok": true, "device": {...}}``.  Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12           # dense bf16 tensor-core peak
SEED = 0


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


def device_ms(fns, iters: int = 60, warmup: int = 5) -> float:
    """Device time per call of ``fns[i % len(fns)]()``: the summed
    durations of the device kernels and copies that ``iters`` calls launch,
    as ``torch.profiler`` (CUPTI) records them, so the host's pace between
    launches does not count."""
    for i in range(warmup):
        fns[i % len(fns)]()
    us = sum(t for _, t in _device_kernels(
        lambda: [fns[i % len(fns)]() for i in range(iters)]))
    if us <= 0:
        fail("torch.profiler recorded no device time")
    return us / iters / 1e3


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

    # ---------------------------------------------------------------- 1
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"[1] built {sorted(built)} in {time.perf_counter() - t0:.2f}s "
          f"(one nvcc per source, in parallel)", flush=True)

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

    def serve_main(stagger: int = 0, **kw):
        """Phase 3's requests on a fresh engine with ``kw``, the last two
        submitted ``stagger`` steps after the first two; the kernel
        launches are counted over this run alone."""
        e = ServingEngine(cfg, params, layout, max_batch=4, policy="ebpf",
                          profile=kw.pop("profile", profile), seed=SEED,
                          **kw)
        for w in wrappers.values():
            w.launches = 0
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
        return e, o, time.perf_counter() - t, \
            {k: w.launches for k, w in wrappers.items()}

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
    if out["khugepaged"]["collapsed"] <= 0:
        fail("khugepaged collapsed nothing")
    if hooks.batch_calls["mm_fault"] <= 0:
        fail("the batched route ran no HOOK_FAULT batch")
    _contained(hooks, "serving run, batched route")
    toks = [t for seq in eng.finished.values() for t in seq]
    if len(toks) != 4 * 64 or not all(0 <= t < cfg.vocab for t in toks):
        fail("generated tokens outside the vocabulary or missing")

    # the same requests on the scalar route, in the same call
    sc, sc_out, sc_wall, sc_launches = serve_main(batch_faults=False)
    print(f"  scalar route: completed={sc_out['engine']['completed']} "
          f"wall={sc_wall:.2f}s launches={sc_launches} hooks calls="
          f"{_nonzero(sc.mm.hooks.calls)}", flush=True)
    # the batched route once more, now that the scalar run has warmed the
    # process as the first run warmed it for the scalar one
    again, _, again_wall, _ = serve_main()
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
    offset_launches = _prefix_phase(cfg, params, profile, wrappers,
                                    engine_mod, fa)

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
        lambda: device_ms([sdpa])))
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
        lambda: device_ms([sdpa_sfx])))
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
    _executor_timing(*exec_timed)

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


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


def _executor_phase() -> tuple:
    """The predicated policy executor on CUDA tensors against the host
    interpreter, bit for bit, and profile reloads between batches.
    Returns the timed executors and the rows for
    :func:`_executor_timing`."""
    from repro_torch.core import (ArrayMap, MapRegistry, PolicyVM,
                                  PredicatedPolicy, Profile, ProfileRegion,
                                  ebpf_mm_program, evict_lru_program,
                                  profile_wss_program, tier_damon_program)
    from repro_torch.core.profiles import MAX_PROFILE_REGIONS
    print("[2b] the batched policy executor on the card (predicated, int64 "
          "lanes) vs the host interpreter PolicyVM", flush=True)
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
             "tier_damon": tier_damon_program(),
             "evict_lru": evict_lru_program(),
             "profile_wss": profile_wss_program()}
    rows = _ctx_rows(64, SEED + 1)

    def interpreted(prog):
        vm = PolicyVM(prog, maps)
        res = [vm.run(r) for r in rows]
        return (np.asarray([r.ret for r in res], np.int64),
                [e for r in res for e in r.events])
    timed = {}
    for name, prog in progs.items():
        want, want_ev = interpreted(prog)
        pol = PredicatedPolicy(prog, maps, device="cuda")
        got = pol.run_batch(rows)
        events, _ = pol.take_events(len(rows))
        bad = int((got != want).sum())
        print(f"  {name}: {pol.unrolled_len} unrolled insns: "
              f"{64 - bad}/64 decisions and {len(events)} ring events equal "
              f"the interpreter's", flush=True)
        if bad or list(events) != list(want_ev):
            fail(f"CUDA executor disagrees with PolicyVM on {name}")
        if name.startswith("fig1") or name == "profile_wss":
            timed[name] = pol
    _reload_check()
    return timed, rows


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
    print(f"  two profile reloads between run_batch calls: the predicated "
          f"and pc-walk executors on the card follow each ({len(reqs)} "
          f"faults, decisions {seen[0][:6]} -> {seen[1][:6]} -> "
          f"{seen[2][:6]} ...)", flush=True)


def _executor_timing(timed: dict, rows) -> None:
    """Time per run_batch of the Figure-1 and profile_wss executors at
    buckets 4, 16, 64: device time (torch.profiler) and wall time (numpy
    in, numpy out)."""
    print("  batched policy executor (eager), time per run_batch:",
          flush=True)
    for name, pol in timed.items():
        for bucket in (4, 16, 64):
            ctx = torch.from_numpy(rows[:bucket]).cuda()
            dev_ms = device_ms([lambda: pol.run_batch_device(ctx)],
                               iters=10, warmup=2)
            pol.run_batch(rows[:bucket])
            t0 = time.perf_counter()
            for _ in range(10):
                pol.run_batch(rows[:bucket])
            wall_ms = (time.perf_counter() - t0) / 10 * 1e3
            print(f"    {name} bucket {bucket}: device {dev_ms:.4f} ms, "
                  f"wall {wall_ms:.3f} ms", flush=True)


def _recording(engine_mod, moves: list):
    real = engine_mod.block_copy

    def rec(leaves, src, dst, **kw):
        moves.append(len(src))
        real(leaves, src, dst, **kw)
    engine_mod.block_copy = rec
    return real


def _contained(hooks, what: str) -> None:
    """Fail when the policy supervisor struck or detached any program: a
    batch executor that raises on the card costs a strike and falls the
    whole batch back to the default, which the run would otherwise hide."""
    snap = hooks.supervisor.snapshot()
    bad = {h: (v["strikes"], v["detaches"]) for h, v in snap.items()
           if isinstance(v, dict) and (v["strikes"] or v["detaches"])}
    if bad or snap["detaches"]:
        fail(f"{what}: policy supervisor (strikes, detaches) {bad}")


def _serve_tiered(cfg, params, **kw):
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
    eng = ServingEngine(cfg, params, layout, max_batch=6, policy="ebpf",
                        profile=profile, seed=SEED, host_blocks=384,
                        tier_policy="ebpf-tier", **kw)
    for rid in range(6):
        eng.submit(Request(rid=rid, prompt=prompts[rid],
                           max_new_tokens=128, app="chat"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run(max_steps=1000)
    torch.cuda.synchronize()
    return eng, out, time.perf_counter() - t0


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
    tel_eng, out, tel_wall, launches = serve_main(trace=True)
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
    kinds = {re.split(r"[ =]", e["name"])[0] for e in host}
    if procs != {"host", "modeled"} or not {"step", "decode", "mm-tick",
                                            "prefill", "req"} <= kinds:
        fail(f"the Chrome trace lacks tracks or spans: {procs} {kinds}")
    if len(host) != len(tel.spans) or len(ring) != len(tel.ring.peek()):
        fail("the Chrome trace does not hold every span and ring event")
    if any(e["dur"] < 0 for e in host):
        fail("a span of negative duration")
    print(f"  trace: {size} bytes, {len(host)} host spans, {len(ring)} ring "
          f"events, loads back", flush=True)
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
    auto, aout, awall, launches = serve_main(stagger=8, profile="auto")
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


def _prefix_phase(cfg, params, profile, wrappers, engine_mod, fa) -> int:
    """Full-width prefix-cache serving; returns the flash launches with a
    query offset of its run."""
    from repro_torch.models import PagedLayout, cache_init, prefill_step
    from repro_torch.serving import Request, ServingEngine
    print("[3c] prefix cache: 6 requests of a shared 256-token system prompt "
          "+ 192 own tokens, 64 new each, one after another", flush=True)
    layout = PagedLayout(num_blocks=512, block_tokens=16, max_blocks=32)
    eng = ServingEngine(cfg, params, layout, max_batch=6, policy="ebpf",
                        profile=profile, seed=SEED, prefix_cache=True)
    rng = np.random.default_rng(SEED + 4)
    shared = rng.integers(1, cfg.vocab, 256).tolist()
    prompts = [shared + rng.integers(1, cfg.vocab, 192).tolist()
               for _ in range(6)]
    hit: dict = {}
    real_sfx = engine_mod.prefill_suffix_step

    def spy(*a, **kw):
        logits, cache = real_sfx(*a, **kw)
        hit.setdefault("logits", logits.clone())
        hit.setdefault("prefix_len", kw["prefix_len"])
        hit.setdefault("rid", len(eng.finished))
        return logits, cache
    engine_mod.prefill_suffix_step = spy
    for w in wrappers.values():
        w.launches = 0
    fa.flash_attention.offset_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rid in range(6):
        eng.submit(Request(rid=rid, prompt=prompts[rid], max_new_tokens=64,
                           app="chat"))
        out = eng.run(max_steps=400)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    offset = fa.flash_attention.offset_launches
    engine_mod.prefill_suffix_step = real_sfx
    pc, st = out["prefix_cache"], out["engine"]
    print(f"  completed={st['completed']} prefill_tokens="
          f"{st['prefill_tokens']} wall={wall:.2f}s", flush=True)
    print(f"  prefix_cache={json.dumps(pc)}", flush=True)
    print(f"  launches={launches} flash launches with q_offset>0: {offset}",
          flush=True)
    print(f"  hooks: batch_calls={_nonzero(eng.mm.hooks.batch_calls)} "
          f"fallback_faults={out['mm']['fallback_faults']}", flush=True)
    if st["completed"] != 6:
        fail(f"prefix run completed {st['completed']} of 6")
    if pc["hits"] < 3:
        fail(f"prefix cache hit {pc['hits']} times (< 3)")
    if offset <= 0:
        fail("no suffix prefill launched flash with a query offset")
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
    if not err <= tol:
        fail(f"suffix-prefill logits differ from the full prefill's: {err}")
    del eng, cache
    return offset


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
