"""Quickest proof that the PyTorch port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``).  Phases, each fatal
on failure:

  1. build every kernel of the serving path from ``src/repro_torch/csrc``;
  2. hold each kernel against its plain PyTorch version on the card at the
     serving path's shapes (decode B in {2, 4}, 32 heads x 128, 16-token
     blocks, up to 512 tokens; prefill 448 tokens), and a small model run
     through the kernels against the same run on the plain versions;
  3. serve 4 requests (prompt 448, 64 new tokens) with ``policy="ebpf"``
     and khugepaged at the full width of deepseek-7b (30 layers, d_model
     4096, 32 heads, d_ff 11008, vocab 102400; random bf16 weights from a
     seed), counting each kernel's launches over that run only;
  4. time each kernel, its plain version and a yardstick PyTorch call, next
     to the least time the card could take for the same work.

Prints one JSON line with the kernels' numbers, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
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
    S = 448
    qf, kf, vf = rn(1, S, H, hd), rn(1, S, KVH, hd), rn(1, S, KVH, hd)
    o = fa.flash_attention(qf, kf, vf, causal=True)
    torch.cuda.synchronize()
    errs["flash_attention"] = check(
        "flash prefill S=448 (bf16)",
        max_err(o, fa.flash_attention_plain(qf, kf, vf, causal=True,
                                            chunk=256)), 2e-2)

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

    # ---------------------------------------------------------------- 3
    print("[3] serve deepseek-7b at full width (30 layers, random bf16 "
          "weights)", flush=True)
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
    eng = ServingEngine(cfg, params, layout, max_batch=4, policy="ebpf",
                        profile=profile, seed=SEED)
    rng = np.random.default_rng(SEED)
    for rid in range(4):
        eng.submit(Request(rid=rid, prompt=rng.integers(
            1, cfg.vocab, 448).tolist(), max_new_tokens=64, app="chat"))
    moves_seen: list = []
    real_block_copy = engine_mod.block_copy

    def recording_block_copy(leaves, src, dst, **kw):
        moves_seen.append((np.array(src), np.array(dst)))
        real_block_copy(leaves, src, dst, **kw)
    engine_mod.block_copy = recording_block_copy
    wrappers = {"paged_decode_attention": pa.paged_decode_attention,
                "flash_attention": fa.flash_attention,
                "block_copy": bc.block_copy}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run(max_steps=400)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    engine_mod.block_copy = real_block_copy
    st = out["engine"]
    print(f"  completed={st['completed']} decode_tokens={st['decode_tokens']}"
          f" prefills={st['prefills']} steps={st['steps']} wall={wall:.2f}s",
          flush=True)
    print(f"  khugepaged={out.get('khugepaged')}", flush=True)
    print(f"  mm={json.dumps(out['mm'])}", flush=True)
    print(f"  launches={launches} move batches={len(moves_seen)}", flush=True)
    if st["completed"] != 4:
        fail(f"{st['completed']} of 4 requests completed")
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the serving path")
    if out["khugepaged"]["collapsed"] <= 0:
        fail("khugepaged collapsed nothing")
    toks = [t for seq in eng.finished.values() for t in seq]
    if len(toks) != 4 * 64 or not all(0 <= t < cfg.vocab for t in toks):
        fail("generated tokens outside the vocabulary or missing")

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
    print("[4] timing (CUDA events, mean of 50 after 5 warm-up)", flush=True)
    rows = []
    q, table, lengths = decode_cases[4]
    n_tok = int(lengths.sum())
    kv_bytes = n_tok * KVH * hd * 2 * 2
    byts = kv_bytes + q.numel() * 2 * 2 + table.numel() * 4 + 4 * 4 \
        + 4 * MB * 4
    flops = 4 * n_tok * H * hd
    rows.append(_row(
        "paged_decode_attention", "src/repro_torch/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention/kernel.py:99",
        launches, errs, byts, flops,
        lambda: pa.paged_decode_attention(q, pool_k, pool_v, table, lengths,
                                          block_tokens=bt),
        lambda: pa.paged_decode_plain(q, pool_k, pool_v, table, lengths,
                                      block_tokens=bt),
        None))
    kr = kf.repeat_interleave(H // KVH, dim=2)
    vr = vf.repeat_interleave(H // KVH, dim=2)
    qt, kt, vt = (x.transpose(1, 2) for x in (qf, kr, vr))
    pairs = S * (S + 1) // 2
    rows.append(_row(
        "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:90",
        launches, errs, 4 * S * H * hd * 2, 4 * pairs * H * hd,
        lambda: fa.flash_attention(qf, kf, vf, causal=True),
        lambda: fa.flash_attention_plain(qf, kf, vf, causal=True, chunk=256),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)))
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
        lambda: bc.block_copy(leaves, src, dst, ptrs=ptrs),
        lambda: bc.block_copy_plain(leaves, src, dst), index_copy))
    for r in rows:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, yardstick {r['library_ms']} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _row(name, source, replaces, launches, errs, byts, flops, kernel, plain,
         library) -> dict:
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(plain, iters=10),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if library is None else cuda_ms(library)}


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
