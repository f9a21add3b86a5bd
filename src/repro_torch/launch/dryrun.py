"""Multi-pod dry-run: run every (architecture x input-shape) cell as a
DTensor program on the production meshes and record roofline inputs (the
counterpart of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch all --shape all --mesh single,multi --attn gather \\
        --out results/dryrun_torch

The reference lowers and compiles each cell for 256 or 512 forced host
devices; here one process is rank 0 of a fake ``torch.distributed`` world
of that size (:func:`~repro_torch.launch.fakeworld.fake_world`) and runs
rank 0's program: the port's own ``prefill_step`` / ``decode_step`` /
``make_train_step`` on DTensors that carry the cell's placements
(:mod:`repro_torch.launch.specs`).  DTensor propagates them and inserts the
collectives (GSPMD's part); the kernels and the per-rank distributed code
run on the local shards (:mod:`repro_torch.distributed.spmd`).  The
returned state is redistributed to the cell's ``out_shardings``.

``--device meta`` (the default) runs on shape-only ``meta`` tensors: no
memory, no kernels, the collectives of the fake backend move nothing.
Either way the mesh is of device type ``"cuda"`` (on any host), so the
collectives are those a card's program issues.
``--device cuda`` runs rank 0's real program on the card, on valid inputs
drawn from ``--seed`` (tables in range, real token ids); what other ranks
would send arrives uninitialised.

Per cell: the trace must finish; we record its wall time (``trace_s``),
the floating-point operations of rank 0 (``cost_analysis.flops``: every
``aten`` op counted on rank 0's LOCAL tensors, plus the bridged kernels'
analytic counts on their local shapes), every collective rank 0 issues (kind, mesh axes, dtype
and operand bytes: ``collectives``), the analytic per-device argument
bytes, and with ``--device cuda`` the card's peak memory.  The port's
layers are Python loops, not a ``scan``, so the counts are per step
already: ``body_weight`` is 1 and the weighted totals equal the raw ones.
Failures are bugs in the framework: the run exits nonzero listing them.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs.base import (ARCH_IDS, SHAPES, get_config, get_smoke_config,
                            supports_shape)
from ..distributed import spmd
from ..distributed.collectives import axis_sizes
from ..distributed.flashdecode import set_decode_mesh
from ..models.decode import decode_step, prefill_step
from ..optim.adamw import AdamWState
from ..training.train_step import make_train_step
from .fakeworld import fake_world
from .specs import Cell, make_cell

# collective op name -> the reference's HLO kind
_KINDS = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "_allgather_base_": "all-gather",
    "allgather_": "all-gather", "all_gather_into_tensor_coalesced":
        "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    # DTensor's Shard(i) -> Shard(j) on a mesh of device type "cuda" (a
    # "cpu" mesh all-gathers instead)
    "shard_dim_alltoall": "all-to-all",
}


# ---------------------------------------------------------------------------
# Trees of args and shardings
# ---------------------------------------------------------------------------

def tree_pairs(tree, shard, fn):
    """``fn(leaf, sharding)`` over the leaves of ``tree`` and the matching
    shardings of ``shard`` (dicts, lists, tuples and NamedTuples)."""
    if isinstance(tree, dict):
        return {k: tree_pairs(v, shard[k], fn) for k, v in tree.items()}
    if isinstance(tree, AdamWState):
        return AdamWState(*(tree_pairs(a, b, fn)
                            for a, b in zip(tree, shard)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_pairs(a, b, fn) for a, b in zip(tree, shard))
    return fn(tree, shard)


def local_shape(shape, placements, mesh) -> tuple:
    """Rank 0's shard shape of a ``shape`` tensor with ``placements`` (the
    rules split every sharded dim evenly)."""
    out = list(shape)
    for n, p in zip(mesh.shape, placements):
        if isinstance(p, Shard):
            out[p.dim] //= n
    return tuple(out)


def arg_bytes_per_device(cell: Cell, mesh) -> int:
    """Analytic per-device input footprint: each leaf's local shard."""
    total = [0]

    def one(leaf, sh):
        n = math.prod(local_shape(leaf.shape, sh.placements, mesh))
        total[0] += n * leaf.element_size()
    tree_pairs(cell.args, cell.in_shardings, one)
    return total[0]


def to_dtensors(args, shardings, mesh, make_local):
    """The cell's args as DTensors: ``make_local(path-free leaf, local
    shape)`` gives rank 0's shard of each leaf."""
    def one(leaf, sh):
        loc = make_local(leaf, local_shape(leaf.shape, sh.placements, mesh))
        return DTensor.from_local(loc, mesh, sh.placements, run_check=False,
                                  shape=leaf.shape,
                                  stride=torch.empty(leaf.shape,
                                                     device="meta").stride())
    return tree_pairs(args, shardings, one)


def redistribute_to(out, shardings):
    """Every DTensor leaf of ``out`` redistributed to its entry of the
    cell's ``out_shardings`` (a plain tensor is replicated)."""
    def one(x, sh):
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(sh.mesh, sh.placements)
    return tree_pairs(out, shardings, one)


# ---------------------------------------------------------------------------
# The trace: collectives and flops of rank 0
# ---------------------------------------------------------------------------

def _reduce_op(args) -> str | None:
    """An all-reduce's or reduce-scatter's op ("sum", "max", ...)."""
    for a in args[1:3]:
        if isinstance(a, str) and a in ("sum", "avg", "max", "min",
                                        "product"):
            return a
        if isinstance(a, torch.ScriptObject) and a._has_method("op"):
            return dist.ReduceOp.RedOpType(a.op()).name.lower()
    return None


def _where() -> str:
    """The innermost frame of the port's model code that led to a
    collective (file:line), for reading a trace."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if "repro_torch" in fn and not fn.endswith(
                ("dryrun.py", "spmd.py", "collectives.py")):
            return f"{fn.split('repro_torch/')[-1]}:{f.f_lineno}"
        f = f.f_back
    return "?"


class StepTrace(TorchDispatchMode):
    """Records every ``_c10d_functional`` / ``c10d`` collective rank 0
    issues (kind, mesh axes, dtype, operand bytes) and counts the flops
    of every ``aten`` op rank 0 runs on its local tensors (DTensor ops are
    let through to desugar first, as ``CommDebugMode`` does); the bridged
    kernels report theirs through
    :func:`repro_torch.distributed.spmd.note_flops`."""

    def __init__(self, mesh):
        super().__init__()
        self.axis_of = {}
        for i, name in enumerate(mesh.mesh_dim_names):
            self.axis_of[mesh.get_group(i).group_name] = name
        self.calls: list = []
        self.flops = 0.0
        self.kernel_flops: dict = {}

    def _note(self, kind, flops):
        self.kernel_flops[kind] = self.kernel_flops.get(kind, 0.0) + flops
        self.flops += flops

    def __enter__(self):
        spmd.listen(self._note)
        return super().__enter__()

    def __exit__(self, *exc):
        spmd.unlisten(self._note)
        return super().__exit__(*exc)

    def _group(self, args) -> str:
        for a in args:
            if isinstance(a, str) and a in self.axis_of:
                return self.axis_of[a]
            if isinstance(a, torch.ScriptObject) and \
                    not a._has_method("op"):            # not a ReduceOp
                name = dist.ProcessGroup.unbox(a).group_name
                return self.axis_of.get(name, name)
        return "?"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            # let DTensor desugar the op into its collectives and its local
            # op first (both come back here, on local tensors)
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator) or \
                any(issubclass(t, FakeTensor) for t in types):
            # DTensor's shape propagation on global fake tensors: no work
            return out
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d", "_dtensor"):
            kind = _KINDS.get(func._opname)
            if kind is not None:
                tensors = [t for a in args[:1] for t in
                           (a if isinstance(a, (list, tuple)) else [a])
                           if isinstance(t, torch.Tensor)]
                if ns == "c10d" and kind == "all-gather":
                    tensors = [t for t in args[1:2]
                               if isinstance(t, torch.Tensor)]
                nbytes = sum(t.numel() * t.element_size() for t in tensors)
                self.calls.append({
                    "kind": kind, "axes": self._group(args),
                    "op": _reduce_op(args),
                    "where": _where(),
                    "dtype": str(tensors[0].dtype).replace("torch.", "")
                    if tensors else "?", "bytes": int(nbytes)})
            return out
        fl = flop_registry.get(func.overloadpacket)
        if fl is not None:
            self.flops += fl(*args, **kwargs, out_val=out)
        return out

    def summary(self) -> dict:
        out: dict = {}
        count: dict = {}
        by_axes: dict = {}
        for c in self.calls:
            out[c["kind"]] = out.get(c["kind"], 0) + c["bytes"]
            count[c["kind"]] = count.get(c["kind"], 0) + 1
            key = f'{c["kind"]}@{c["axes"]}'
            by_axes[key] = by_axes.get(key, 0) + 1
        total = sum(out.values())
        return {"bytes_by_kind": out, "count_by_kind": count,
                "total_bytes": total,
                "weighted_bytes_by_kind": {k: float(v)
                                           for k, v in out.items()},
                "weighted_total_bytes": float(total), "body_weight": 1,
                "count_by_kind_and_axes": by_axes, "calls": self.calls}


# ---------------------------------------------------------------------------
# The cell's program
# ---------------------------------------------------------------------------

def build_fn(cfg, cell: Cell, **step_kw):
    """The cell's step function of positional DTensor args; ``step_kw``
    goes to the step (``compute_dtype``, and the train step's schedule)."""
    if cell.kind == "train":
        return make_train_step(cfg, num_micro=1, chunk=1024, remat=True,
                               **step_kw)
    if cell.kind == "prefill":
        extras = list(cell.meta["extras"].keys())

        def prefill(params, cache, tokens, tbl, *rest):
            kw = dict(zip(extras, rest))
            return prefill_step(params, cfg, cache, tokens, tbl, cell.layout,
                                chunk=1024, **kw, **step_kw)
        return prefill

    attn_impl = cell.meta["attn_impl"]
    has_st = "sharded_tables" in cell.meta
    has_pos3d = cell.meta.get("pos3d", False)

    def serve(params, cache, tokens, lengths, tbl, *rest):
        rest = list(rest)
        st = sl = pos3d = None
        if has_st:
            st = rest.pop(0)
            sl = rest.pop(0)
        if has_pos3d:
            pos3d = rest.pop(0)
        return decode_step(params, cfg, cache, tokens, lengths, tbl,
                           cell.layout, pos3d=pos3d, attn_impl=attn_impl,
                           sharded_table=st, sharded_logical=sl, **step_kw)
    return serve


def run_program(cfg, cell: Cell, mesh, args, **step_kw):
    """Run the cell's program on the DTensor ``args`` under a
    :class:`StepTrace`; returns (outputs at ``out_shardings``, trace)."""
    fn = build_fn(cfg, cell, **step_kw)
    from torch.distributed.tensor.experimental import implicit_replication
    set_decode_mesh(mesh)
    try:
        with StepTrace(mesh) as tr, implicit_replication():
            out = fn(*args)
            out = redistribute_to(out, cell.out_shardings)
    finally:
        set_decode_mesh(None)
    return out, tr


# ---------------------------------------------------------------------------
# Valid inputs for a run on the card (rank 0's shards)
# ---------------------------------------------------------------------------

def placement_tables(cell: Cell, mesh, batch: int) -> dict:
    """GLOBAL tables that keep every block where a sharded decode looks for
    it: sequence b's logical block lb on shard s(b, lb) of the cell's
    layout, at a row of that shard unique to (b, lb).  Returns numpy
    ``block_table`` [B, MB] and, for a flashdecode cell, ``sharded`` and
    ``logical`` [B, NS, MBl]."""
    sizes = axis_sizes(mesh)
    layout = cell.layout
    MB = layout.max_blocks
    chips = math.prod(sizes.values())
    nb_loc = layout.num_blocks // chips
    M = sizes["model"]
    D = chips // M
    blocksharded = cell.meta.get("attn_impl", "").endswith("blocksharded")
    NS = chips if blocksharded else M
    MBl = -(-MB // NS)
    b = np.arange(batch)[:, None]
    lb = np.arange(MB)[None, :]
    if cell.meta.get("attn_impl") != "flashdecode":
        # a gather decode or a prefill reads any block: spread them all
        NS, MBl = chips, -(-MB // chips)
        blocksharded = True
    if blocksharded:
        shard = lb % NS + 0 * b
        row = b * MBl + lb // NS
    else:
        Bl = -(-batch // D)
        shard = (b // Bl) * M + lb % M
        row = (b % Bl) * MBl + lb // M
    if (row >= nb_loc).any():
        raise ValueError("placement: a shard's rows do not hold its blocks")
    table = (shard * nb_loc + row).astype(np.int32)
    out = {"block_table": table}
    if "sharded_tables" in cell.meta:
        st = np.full((batch, NS, MBl), -1, np.int32)
        lg = np.full((batch, NS, MBl), -1, np.int32)
        for j in range(MB):
            s = j % NS
            st[:, s, j // NS] = table[:, j]
            lg[:, s, j // NS] = j
        out["sharded"], out["logical"] = st, lg
    return out


def card_inputs(cfg, cell: Cell, mesh, shape, *, seed: int, device):
    """Rank 0's shards of valid inputs: weights ~ N(0, 0.02) drawn on the
    card from ``seed``, zero moments and caches, token ids below the
    vocab, decode lengths of ``seq_len - 1`` and tables from
    :func:`placement_tables`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    B = shape.global_batch

    def rand(local, dtype):
        x = torch.randn(local, generator=gen, device=device,
                        dtype=torch.float32)
        return x.mul_(0.02).to(dtype)

    def ints(local, hi):
        return torch.randint(0, hi, local, generator=gen, device=device,
                             dtype=torch.int32)

    def const(arr):
        def make(leaf, local):
            sl = tuple(slice(0, n) for n in local)
            return torch.from_numpy(np.ascontiguousarray(arr[sl])).to(device)
        return make

    def weights(leaf, local):
        return rand(local, leaf.dtype)

    def zeros(leaf, local):
        return torch.zeros(local, dtype=leaf.dtype, device=device)

    def tokens(leaf, local):
        return ints(local, cfg.vocab)

    def positions(leaf, local):
        S = local[-1]
        return torch.arange(S, device=device, dtype=leaf.dtype).expand(
            local).contiguous()

    def batch_leaf(key):
        return {"tokens": tokens, "pos3d": positions}.get(key, weights)

    if cell.kind == "train":
        params, opt, batch = cell.args
        makers = (weights, zeros, {k: batch_leaf(k) for k in batch})
        return _make(cell, mesh, makers)
    makers = [weights, zeros, tokens]
    if cell.kind == "prefill":
        tabs = placement_tables(cell, mesh, B)
        makers.append(const(tabs["block_table"]))
        makers += [batch_leaf(k) for k in cell.meta["extras"]]
        return _make(cell, mesh, makers)
    tabs = placement_tables(cell, mesh, B)
    lens = np.full((B,), shape.seq_len - 1, np.int32)
    makers += [const(lens), const(tabs["block_table"])]
    if "sharded_tables" in cell.meta:
        makers += [const(tabs["sharded"]), const(tabs["logical"])]
    if cell.meta.get("pos3d"):
        makers.append(const(np.full((3, B, 1), shape.seq_len - 1,
                                    np.float32)))
    return _make(cell, mesh, makers)


def _make(cell, mesh, makers):
    out = []
    for arg, sh, mk in zip(cell.args, cell.in_shardings, makers):
        if isinstance(mk, dict):
            out.append({k: to_dtensors(arg[k], sh[k], mesh, mk[k])
                        for k in arg})
        else:
            out.append(to_dtensors(arg, sh, mesh, mk))
    return tuple(out)


def meta_inputs(cell: Cell, mesh):
    return to_dtensors(cell.args, cell.in_shardings, mesh,
                       lambda leaf, local: torch.empty(
                           local, dtype=leaf.dtype, device="meta"))


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, mesh_name: str, attn_impl: str,
             out_dir: Path, *, force: bool = False, device: str = "meta",
             smoke: bool = False, seed: int = 0, mesh=None) -> dict:
    """Trace one cell and write its record.  ``mesh``: run on this mesh
    (an open fake world of the right size) instead of opening one."""
    tag = f"{arch}.{shape_name}.{mesh_name}.{attn_impl}"
    if smoke:
        tag += ".smoke"
    if device != "meta":
        tag += f".{device}"
    out_path = out_dir / f"{tag}.json"
    if out_path.exists() and not force:
        rec = json.loads(out_path.read_text())
        # a record traced on a "cpu" mesh counts other collectives
        if (rec.get("ok") or rec.get("skipped")) and \
                rec.get("mesh_device") == "cuda":
            print(f"[cached ] {tag}")
            return rec

    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    shape = SHAPES[shape_name]
    ok_shape, reason = supports_shape(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "attn_impl": attn_impl, "kind": shape.kind, "device": device,
           "mesh_device": "cuda", "smoke": smoke}
    if not ok_shape:
        rec.update(skipped=True, reason=reason, ok=False)
        out_path.write_text(json.dumps(rec, indent=1))
        print(f"[SKIP   ] {tag}: {reason}")
        return rec

    try:
        if mesh is None:
            with fake_world(multi_pod=(mesh_name == "multi")) as m:
                rec.update(trace_cell(cfg, shape, m, attn_impl, device,
                                      seed))
        else:
            rec.update(trace_cell(cfg, shape, mesh, attn_impl, device, seed))
        coll = rec["collectives"]
        print(f"[OK     ] {tag}: trace {rec['trace_s']:.1f}s "
              f"flops={rec['cost_analysis']['flops']:.3g} "
              f"coll={coll['total_bytes'] / 1e6:.1f}MB/dev "
              f"args={rec['arg_bytes_per_device'] / 1e9:.2f}GB/dev")
    except Exception as e:   # noqa: BLE001 — record and continue
        rec.update(ok=False, skipped=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[FAIL   ] {tag}: {type(e).__name__}: {e}")
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def trace_cell(cfg, shape, mesh, attn_impl: str, device: str = "meta",
               seed: int = 0) -> dict:
    """Build the cell on ``mesh``, run its program once on rank 0's shards
    and return the record's fields."""
    cuda = device != "meta"
    t0 = time.monotonic()
    cell = make_cell(cfg, shape, mesh, attn_impl=attn_impl)
    if cuda:
        args = card_inputs(cfg, cell, mesh, shape, seed=seed, device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
    else:
        args = meta_inputs(cell, mesh)
    out, tr = run_program(cfg, cell, mesh, args)
    if cuda:
        torch.cuda.synchronize()
    trace_s = time.monotonic() - t0
    mem = None
    if cuda:
        mem = {"max_memory_allocated_bytes":
               int(torch.cuda.max_memory_allocated()),
               "device_name": torch.cuda.get_device_name()}
    del out
    return dict(ok=True, skipped=False, trace_s=round(trace_s, 3),
                cost_analysis={"flops": float(tr.flops),
                               "kernel_flops": tr.kernel_flops,
                               "counts": "rank 0's local ops (per device)"},
                memory_analysis=mem,
                arg_bytes_per_device=arg_bytes_per_device(cell, mesh),
                collectives=tr.summary(), meta=_jsonable(cell.meta),
                mesh_device=mesh.device_type,
                devices=int(math.prod(axis_sizes(mesh).values())))


def _jsonable(x):
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


def cell_attn(shape_name: str, attn: str) -> str:
    """The reference's fallbacks: flashdecode applies to decode only, and a
    batch of one decodes block-sharded."""
    if SHAPES[shape_name].kind != "decode" and attn != "gather":
        attn = "gather"
    if attn.startswith("flashdecode") and \
            SHAPES[shape_name].global_batch == 1:
        attn = "flashdecode_blocksharded"
    return attn


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--attn", default="gather",
                    help="gather | flashdecode | flashdecode_blocksharded")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="meta", help="meta | cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' reduced configs")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = args.mesh.split(",")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.device != "meta" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device")

    failures = []
    t0 = time.monotonic()
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                rec = run_cell(arch, shape, mesh_name,
                               cell_attn(shape, args.attn), out_dir,
                               force=args.force, device=args.device,
                               smoke=args.smoke, seed=args.seed)
                if not rec.get("ok") and not rec.get("skipped"):
                    failures.append(f"{arch}.{shape}.{mesh_name}")
    if failures:
        print(f"\n{len(failures)} FAILED cells:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"\nAll dry-run cells traced ({time.monotonic() - t0:.1f} s).")


if __name__ == "__main__":
    main()
