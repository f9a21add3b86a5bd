"""One run of a cell through ``repro_torch``'s ``ServingEngine``: weights
from the seed, the engine in the configuration's deployment, every prefill
shape of the traffic warmed, the loop brought to steady state, the window
measured from the client's side, then the output check.

With ``trace`` the engine's telemetry is on and every device entry of the
window is bracketed by CUDA events (the decode graph's call, each prefill
call, each block copy); after the window a few steady steps run under
``torch.profiler`` (CUDA activity only), read for kernel time by name.
"""

from __future__ import annotations

import gc
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import check, manifest, timeline
from .peaks import peaks
from .traffic import SEED_MASK, Traffic, prompt_shapes, rng_for
from .weights import make_params

BAD_MODULES = {"jax", "jaxlib", "flax", "repro"}


def process_age() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in BAD_MODULES)


def model_config(m: dict):
    """The program's ``ModelConfig`` for a configuration's ``model``
    block."""
    from repro_torch.configs import base
    sub = {"attn": base.AttnCfg, "moe": base.MoECfg, "mla": base.MLACfg,
           "mamba": base.MambaCfg}

    def tup(v):
        return tuple(v) if isinstance(v, list) else v
    kw = {}
    for k, v in m.items():
        if k in sub and v is not None:
            v = sub[k](**{kk: tup(vv) for kk, vv in v.items()})
        kw[k] = tup(v)
    return base.ModelConfig(**kw)


def app_profiles(mix: dict):
    """The frozen profile of every app of the mix ("auto": online
    profiling)."""
    from repro_torch.core import Profile
    from repro_torch.core.profiles import ProfileRegion
    profs = []
    for name, app in sorted(mix["apps"].items()):
        p = app.get("profile")
        if p == "auto":
            return "auto"
        if p:
            profs.append(Profile(name, [ProfileRegion(int(a), int(b),
                                                      tuple(ben))
                                        for a, b, ben in p]))
    return profs or None


class Marks:
    """Device-time marks: CUDA events on the card, the host clock on the
    CPU (where the plain versions run synchronously)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


class Entries:
    """Brackets the engine's device entries while installed: the decode
    graph's call, the prefill calls and the engine module's block copy.
    Each call appends (kind, start mark, end mark, step, info)."""

    def __init__(self, eng, marks: Marks, *, tables: bool = False):
        self.eng, self.marks, self.tables = eng, marks, tables
        self.calls: list = []
        self.step = 0
        self._saved = None

    def _wrap(self, fn, kind, info):
        def run(*a, **kw):
            m0 = self.marks.mark()
            out = fn(*a, **kw)
            self.calls.append((kind, m0, self.marks.mark(), self.step,
                               info(*a)))
            return out
        return run

    def install(self) -> None:
        from repro_torch.serving import engine as engine_mod
        eng, pf = self.eng, self.eng._prefill
        self._saved = (eng._decode, engine_mod.block_copy)
        eng._decode = self._wrap(eng._decode, "decode", self._decode_info)
        pf.full = self._wrap(pf.full, "prefill",
                             lambda prompt, slot: (len(prompt), 0))
        pf.suffix = self._wrap(pf.suffix, "prefill",
                               lambda prompt, slot, plen: (len(prompt),
                                                           int(plen)))
        engine_mod.block_copy = self._wrap(
            engine_mod.block_copy, "copy",
            lambda leaves, src, dst, **kw: len(src))

    def _decode_info(self, tokens, lengths, active) -> dict:
        """The active rows' contexts (keys their new tokens see) and, with
        ``tables``, the KV tokens of the distinct pool blocks they read (a
        block shared through the prefix cache counts once)."""
        act = np.asarray(active, bool)
        ctx = np.asarray(lengths)[act] + 1
        info = {"contexts": ctx}
        if self.tables:
            bt = self.eng.layout.block_tokens
            tab = self.eng._tables.host[act]
            cols = np.arange(tab.shape[1])
            valid = np.clip(ctx[:, None] - cols[None, :] * bt, 0, bt)
            blk, val = tab[valid > 0], valid[valid > 0]
            order = np.lexsort((-val, blk))
            first = np.r_[True, blk[order][1:] != blk[order][:-1]]
            info["kv_tokens"] = int(val[order][first].sum())
        return info

    def remove(self) -> None:
        from repro_torch.serving import engine as engine_mod
        eng, pf = self.eng, self.eng._prefill
        eng._decode, engine_mod.block_copy = self._saved
        del pf.full, pf.suffix


class Client:
    """The clients: a closed loop (``clients`` requests in flight, each
    followed by the next as soon as it finished) or an open loop (each
    request sent when it is due, timed from when it was due)."""

    def __init__(self, eng, stream: Traffic, mix: dict, Request):
        self.eng, self.stream, self.mix = eng, stream, mix
        self.Request = Request
        self.tl = timeline.Timeline()
        self.reqs: dict = {}            # rid -> Req
        self.pending: list = []         # (time to send, Req)
        self._done = 0
        self.closed = mix["loop"] == "closed"
        self.t_open = None

    def start(self, now: float) -> None:
        self.t_open = now
        if self.closed:
            for _ in range(int(self.mix["clients"])):
                self.pending.append((now, self.stream.next()))
        else:
            self._schedule()

    def _schedule(self) -> None:
        while not self.pending or self.pending[-1][0] <= \
                time.perf_counter() + 1.0:
            r = self.stream.next()
            self.pending.append((self.t_open + r.due, r))

    def send_due(self, now: float) -> None:
        keep = []
        for t, r in self.pending:
            if t <= now:
                self.reqs[r.rid] = r
                self.tl.send(r.rid, t)
                self.eng.submit(self.Request(rid=r.rid, prompt=r.prompt,
                                             max_new_tokens=r.max_new,
                                             app=r.app))
            else:
                keep.append((t, r))
        self.pending = keep
        if not self.closed:
            self._schedule()

    def collect(self, now: float) -> int:
        """Records the tokens the last step returned; returns how many."""
        eng, tl, new = self.eng, self.tl, 0
        for seq in eng.active.values():
            rid = seq.req.rid
            if rid in self.reqs:
                new += tl.tokens(rid, len(seq.generated), now)
        fin = list(eng.finished)
        for rid in fin[self._done:]:
            if rid in self.reqs:
                new += tl.tokens(rid, len(eng.finished[rid]), now)
                tl.finish(rid, now)
                if self.closed:
                    self.pending.append((now, self.stream.next()))
        self._done = len(fin)
        return new

    def idle(self) -> bool:
        return not self.eng.active and not self.eng.waiting


class Pool:
    """The paged pool's fill over the window: the most blocks in use at
    once (live sequences' and the prefix cache's), and the preemptions."""

    def __init__(self, eng):
        self.eng, self.peak, self.cached = eng, 0, 0
        self.total = eng.layout.num_blocks
        self.preempt0 = eng.stats.preemptions

    def look(self) -> None:
        used = self.total - self.eng.mm.buddy.free_blocks_total()
        if used > self.peak:
            self.peak = used
            pc = self.eng.prefix_cache
            self.cached = pc.used_blocks(0) if pc is not None else 0

    def __str__(self) -> str:
        return (f"pool peak {self.peak} of {self.total} blocks in use "
                f"({self.peak - self.cached} live, {self.cached} cached), "
                f"{self.eng.stats.preemptions - self.preempt0} preemptions")


def warm_shapes(eng, mix: dict, Request, rng, *, vocab: int, bt: int,
                app: str) -> None:
    """One untimed admission for every padded prefill shape the mix can
    make, and prefix-cache hits until every (suffix, prompt) pair is
    captured."""
    full, suffix = prompt_shapes(mix, bt)
    graphs = eng._prefill.graphs
    rid = [-1]

    def serve(prompts):
        for p in prompts:
            eng.submit(Request(rid=rid[0], prompt=p, max_new_tokens=1,
                               app=app))
            rid[0] -= 1
        while eng.step():
            pass

    def ids(n):
        return rng.integers(1, vocab, n).tolist()
    serve([ids(nb * bt) for nb in sorted(full)
           if ("full", nb) not in graphs])
    docs: dict = {}
    for sb, kb in sorted(suffix):
        doc = docs.setdefault(kb - sb, ids((kb - sb) * bt))
        for _ in range(4):
            if ("suffix", sb, kb) in graphs:
                break
            serve([doc + ids(sb * bt)])
        if ("suffix", sb, kb) not in graphs:
            raise RuntimeError(f"warm-up: no prefix-cache hit made the "
                               f"suffix shape ({sb}, {kb})")


def run_cell(conf: dict, mix: dict, limits: dict, *, seed: int,
             seconds: float, trace: bool, device: str = "cuda",
             e2e: list = (), layer_metrics: list = (),
             readers: dict | None = None, patch=None,
             control: bool = False) -> dict:
    """One run; returns the contract's result line as a dict.

    ``conf``: the configuration file; ``mix``: the traffic file;
    ``limits``: the cell's limits file; ``e2e`` / ``layer_metrics``: the
    cell's metric entries of BENCHMARK.json; ``readers``: metric name ->
    read function; ``patch(eng)``: called on the built engine (tests break
    the timed path with it); ``control``: also read the float8 control on
    the same sample (under ``readings``, with the program's, not judged)."""
    from repro_torch.models import PagedLayout, model_spec
    from repro_torch.serving import Request, ServingEngine
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    seed = int(seed) & SEED_MASK
    dep = conf["deployment"]
    cfg = model_config(conf["model"])
    dtype = getattr(torch, dep.get("dtype", "bfloat16"))
    layout = PagedLayout(**dep["layout"])
    bt = layout.block_tokens

    marks_s = [("start", process_age())]
    if on_card:
        from repro_torch.kernels import build
        build.build_all()
        torch.cuda.reset_peak_memory_stats()
    marks_s.append(("kernels", process_age()))
    params = make_params(model_spec(cfg), seed, device=dev, dtype=dtype)
    marks_s.append(("weights", process_age()))
    eng = ServingEngine(cfg, params, layout, max_batch=dep["max_batch"],
                        profile=app_profiles(mix), seed=seed % (1 << 32),
                        trace=trace, device=dev, **dep.get("engine", {}))
    if patch is not None:
        patch(eng)
    stream = Traffic(mix, seed, vocab=cfg.vocab, block_tokens=bt)
    warm_app = sorted(mix["apps"])[0]
    marks_s.append(("engine", process_age()))
    warm_shapes(eng, mix, Request, rng_for(seed, 3), vocab=cfg.vocab, bt=bt,
                app=warm_app)
    marks_s.append(("warm-up", process_age()))
    marks = Marks(dev)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    client = Client(eng, stream, mix, Request)
    sync()
    client.start(time.perf_counter())
    for _ in range(int(mix["ramp_steps"])):
        client.send_due(time.perf_counter())
        eng.step()
        sync()
        client.collect(time.perf_counter())

    # ------------------------------------------------------------ window
    entries = Entries(eng, marks) if trace else None
    tel = eng.telemetry
    if entries is not None:
        entries.install()
        hook0 = _hook(tel)
        prefill_tok0 = eng.stats.prefill_tokens
    shapes0 = len(eng._prefill.graphs)
    steps: list = []
    setup_s = process_age()
    marks_s.append(("ramp", setup_s))
    t0 = time.perf_counter()
    tel0 = tel.now() if tel is not None else 0
    in_flight = set(client.tl.sent) - set(client.tl.done)
    pool = Pool(eng)
    while True:
        now = time.perf_counter()
        if now - t0 >= seconds:
            break
        client.send_due(now)
        if client.idle():
            time.sleep(0.0005)
            continue
        if entries is not None:
            entries.step = len(steps)
        eng.step()
        sync()
        t_b = time.perf_counter()
        client.collect(t_b)
        steps.append((now, t_b))
        pool.look()
    t1 = steps[-1][1] if steps else time.perf_counter()
    tel1 = tel.now() if tel is not None else 0
    if len(eng._prefill.graphs) != shapes0:
        raise RuntimeError("a prefill shape was captured inside the window: "
                           "the warm-up missed a shape of the traffic")
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    tl = client.tl
    metrics: dict = {}
    result = {"correct": False, "attempted": 0, "failed": 0,
              "metrics": metrics, "device": {
                  "platform": "gpu" if on_card else dev.type,
                  "kind": torch.cuda.get_device_name(0) if on_card
                  else dev.type,
                  "count": 1, "memory_peak_bytes": int(memory_peak)}}
    sent_in = {r for r, t in tl.sent.items() if t0 <= t <= t1} | in_flight
    live = {s.req.rid for s in eng.active.values()} | \
        {r.rid for r in eng.waiting}
    result["attempted"] = len(sent_in)
    result["failed"] = len([r for r in sent_in
                            if r not in tl.done and r not in live])
    print("set-up " + ", ".join(f"{k} {t:.3f}" for k, t in marks_s)
          + f" s; window {t1 - t0:.3f} s, {len(steps)} steps, attempted "
          f"{result['attempted']}; {pool}", file=sys.stderr, flush=True)

    if not trace:
        e = timeline.end_to_end(tl, t0, t1)
        e["setup_s"] = setup_s
        print(f"samples {e['samples']}", file=sys.stderr, flush=True)
        for m in e2e:
            if e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e[m["name"]],
                                      "unit": m["unit"]}
    else:
        entries.remove()
        rec = _record(eng, entries, marks, conf, steps, t0, t1, hook0,
                      prefill_tok0, tel0, tel1, result)
        prof = _profile(eng, client, marks, on_card, sync)
        rec.profile = prof
        if prof is not None:
            result["device"]["busy_s"] = prof.busy_s
            result["device"]["window_s"] = prof.window_s
        for m in layer_metrics:
            v = readers[m["name"]](rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["breakdown"] = {
            "device_ops": prof.top if prof is not None else [],
            "idle_gaps": rec.idle_top}

    # ------------------------------------------------------------ check
    finished = {r: (client.reqs[r].prompt, eng.finished[r])
                for r, t in tl.done.items() if t0 <= t <= t1}
    del eng, entries, client, pool
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = served_check(params, conf, finished, seed, control=control)
    ok, shown = check.judge(numbers, limits)
    result["correct"] = bool(ok)
    result["check"] = shown
    if control:
        result["readings"] = numbers
    return result


def served_check(params, conf, finished, seed, *,
                 control: bool = False) -> dict:
    """The reference over a seeded sample of the finished requests: the
    served-token gaps' widest (``served_gap_max``), 99th percentile and
    mean (nothing when nothing finished); with ``control`` the same of the
    tokens the reference on float8 weights puts first at the same
    positions (``control_gap_*``)."""
    rids = check.sample(finished, seed)
    if not rids:
        return {}
    seqs, starts, served = check.reference_inputs(finished, rids)
    ref = manifest.module("reference", conf["reference"])
    t = time.perf_counter()
    logits = ref.logits_at(params, conf["model"], seqs, starts)
    out = check.summary("served", check.gaps(logits, served))
    print(f"reference over {len(rids)} requests, {sum(map(len, served))} "
          f"served tokens (longest {len(served[0])}), "
          f"{time.perf_counter() - t:.3f} s; {out}", file=sys.stderr,
          flush=True)
    if control:
        low = ref.logits_at(params, conf["model"], seqs, starts,
                            quant=ref.fp8_weights)
        out.update(check.summary("control", check.control_gaps(logits,
                                                                 low)))
    return out


def _hook(tel) -> tuple[int, int]:
    h = tel.hook_invoke_ns.get("mm_fault") if tel is not None else None
    return (h.total, h.count) if h is not None else (0, 0)


def _record(eng, entries, marks, conf, steps, t0, t1, hook0, prefill_tok0,
            tel0, tel1, result) -> SimpleNamespace:
    """What the per-layer readers read, from the traced window."""
    if marks.cuda:
        torch.cuda.synchronize()
    per_step = [0.0] * len(steps)
    decode, prefill, gaps = [], [], {}
    prev = None
    for kind, m0, m1, step, info in entries.calls:
        ms = marks.ms(m0, m1)
        if step < len(per_step):
            per_step[step] += ms
        if kind == "decode":
            decode.append({"ms": ms, "contexts": info["contexts"]})
        elif kind == "prefill":
            prefill.append({"ms": ms, "prompt": info[0], "prefix": info[1]})
        if prev is not None:
            label = f"host between {prev[0]} and {kind}"
            gaps[label] = gaps.get(label, 0.0) + marks.ms(prev[2], m0) / 1e3
        prev = (kind, m0, m1)
    tel = eng.telemetry
    h1 = _hook(tel)
    spans = [(name, dur) for name, _c, _t, ts, dur in tel.spans
             if tel0 <= ts and ts + dur <= tel1]
    return SimpleNamespace(
        model=conf["model"], layout=conf["deployment"]["layout"],
        rows=conf["deployment"]["max_batch"],
        counts=manifest.module("counts", conf["counts"]),
        peak=peaks(result["device"]["kind"]), window_s=t1 - t0,
        steps=[{"wall_ms": (b - a) * 1e3, "device_ms": d}
               for (a, b), d in zip(steps, per_step)],
        decode=decode, prefill=prefill, spans=spans,
        hook_fault=(h1[0] - hook0[0], h1[1] - hook0[1]),
        prefill_tokens=eng.stats.prefill_tokens - prefill_tok0,
        idle_top=sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
        profile=None)


def _profile(eng, client, marks, on_card, sync, *, min_steps: int = 16,
             min_prefills: int = 2, max_steps: int = 400):
    """A few steady steps after the window under ``torch.profiler``
    (CUDA activity): kernels by name with start and duration, the decode
    rows' contexts and the prefill shapes of those steps, the device's busy
    time (the union of kernels and copies) and the sub-window's length."""
    if not on_card:
        return None
    from torch.profiler import ProfilerActivity, profile
    entries = Entries(eng, marks, tables=True)
    entries.install()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        n = 0
        while n < max_steps and (n < min_steps or sum(
                c[0] == "prefill" for c in entries.calls) < min_prefills):
            client.send_due(time.perf_counter())
            eng.step()
            sync()
            client.collect(time.perf_counter())
            n += 1
        w1 = time.perf_counter()
    entries.remove()
    kernels = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            kernels.append((ev.name(), ev.start_ns(), ev.duration_ns()))
    busy, end = 0, 0
    for _n, a, d in sorted(kernels, key=lambda k: k[1]):
        busy += max(0, a + d - max(a, end))
        end = max(end, a + d)
    by_name: dict = {}
    for name, _a, d in kernels:
        by_name[name] = by_name.get(name, 0) + d
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return SimpleNamespace(
        kernels=kernels,
        decode=[c[4] for c in entries.calls if c[0] == "decode"],
        prefill=[c[4] for c in entries.calls if c[0] == "prefill"],
        window_s=w1 - w0, busy_s=busy / 1e9,
        top=[[name[:120], d / 1e9] for name, d in top])
