"""The dry-run as DTensor programs (``repro_torch.launch.dryrun``).

(a) The trace on a fake 256-rank world (``fake_world``), shape-only
    ``meta`` tensors, in this process: the smoke config of every arch at
    the four shapes on the single-pod mesh (decode also through
    ``flashdecode``), and deepseek-7b's full config at ``decode_32k`` and
    ``train_4k`` on both production meshes.  Each cell is ``ok`` or skipped
    for the reference's reason; a ``flashdecode`` decode issues exactly one
    MAX and one SUM all-reduce per attention layer from the partials'
    combine (``distributed/flashdecode.py``), a block-sharded one one of
    each per mesh axis; a train step reduces its gradients over the data
    axes; no default process group outlives a trace; the CLI writes records
    with the reference's keys.

(b) Real values on 4 gloo CPU ranks (a 2 x 2 ("data", "model") mesh,
    spawned once for the file, one torch thread each, a ``FileStore`` under
    the test's tmp dir), float32: deepseek-7b smoke and deepseek-moe-16b
    smoke (its MoE layers expert-parallel: 4 experts over "model" = 2) run
    the sharded prefill, the decode (``gather`` and ``flashdecode``) and one
    train step as DTensor programs with the cells' placements
    (``dryrun.run_program``); the gathered outputs (logits, heat, the
    prefilled pools, the loss, the updated params and AdamW moments) are
    held to the REFERENCE's unsharded ``prefill_step`` / ``decode_step`` /
    ``make_train_step``, run in one child process, on the same weights
    (drawn here with numpy in the reference's layout and converted).  The
    MoE configs take capacity factor 8 on both sides, as
    ``tests/test_torch_distributed.py`` does: expert parallelism sizes
    each expert's capacity by the rank's tokens, the unsharded path by
    all of them, and no token may drop on either side for the two to be
    the same function.  Both subprocesses start with the file and run
    while (a) does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
ARCHS = ("nemotron_4_15b", "deepseek_7b", "phi3_mini_3p8b", "gemma3_27b",
         "deepseek_moe_16b", "deepseek_v2_lite_16b", "qwen2_vl_7b",
         "jamba_v0_1_52b", "whisper_medium", "mamba2_1p3b")
RANK_ARCHS = ("deepseek_7b", "deepseek_moe_16b")
# 8 query / 2 KV heads on a 1 x 4 mesh: each rank's 2 query heads split
# over "model" and read one KV head of K/V replicated over it
GQA_ARCH = "nemotron_4_15b"
MESH_SHAPES = {**{a: (2, 2) for a in RANK_ARCHS}, GQA_ARCH: (1, 4)}
WORLD = 4
B, PROMPT, SEQ = 4, 32, 64          # prefill [4, 32] into a 64-token layout
MOE_CAPACITY = 8.0


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) the fake 256-rank world
# ---------------------------------------------------------------------------

def _combines(rec: dict) -> dict:
    """All-reduces issued by the flash-decoding combine, by op."""
    out: dict = {}
    for c in rec["collectives"]["calls"]:
        if c["kind"] == "all-reduce" and \
                c["where"].startswith("distributed/flashdecode.py"):
            out[c["op"]] = out.get(c["op"], 0) + 1
    return out


def _trace(cfg, shape_name, mesh, attn):
    from repro_torch.configs.base import SHAPES, supports_shape
    from repro_torch.launch import dryrun
    ok, reason = supports_shape(cfg, SHAPES[shape_name])
    if not ok:
        return {"skipped": True, "reason": reason}
    return dryrun.trace_cell(cfg, SHAPES[shape_name], mesh,
                             dryrun.cell_attn(shape_name, attn))


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cells_trace_on_the_fake_world(arch):
    import torch.distributed as dist
    from repro_torch.configs.base import SHAPES, get_smoke_config
    from repro_torch.launch.fakeworld import fake_world
    cfg = get_smoke_config(arch)
    with fake_world() as mesh:
        for shape_name in SHAPES:
            for attn in (("gather", "flashdecode")
                         if SHAPES[shape_name].kind == "decode"
                         else ("gather",)):
                rec = _trace(cfg, shape_name, mesh, attn)
                if rec.get("skipped"):
                    assert "full-attention" in rec["reason"] or \
                        "whisper" in rec["reason"]
                    continue
                assert rec["ok"] and rec["devices"] == 256
                assert rec["collectives"]["total_bytes"] > 0
                assert rec["cost_analysis"]["flops"] > 0
                if attn == "flashdecode":
                    axes = 2 if shape_name == "long_500k" else 1
                    want = cfg.n_layers * axes
                    assert _combines(rec) == {"max": want, "sum": want}, \
                        (shape_name, _combines(rec))
    assert not dist.is_initialized()


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_deepseek_7b_full_width_cells(mesh_name):
    """decode_32k through flashdecode (30 layers: 30 MAX + 30 SUM combine
    all-reduces over "model") and train_4k, whose gradients reduce over
    every data axis."""
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.launch.fakeworld import fake_world
    cfg = get_config("deepseek_7b")
    multi = mesh_name == "multi"
    with fake_world(multi_pod=multi) as mesh:
        dec = _trace(cfg, "decode_32k", mesh, "flashdecode")
        train = _trace(cfg, "train_4k", mesh, "gather")
    assert not dist.is_initialized()
    assert dec["ok"] and dec["devices"] == (512 if multi else 256)
    assert _combines(dec) == {"max": 30, "sum": 30}
    assert all(c["axes"] == "model" for c in dec["collectives"]["calls"]
               if c["where"].startswith("distributed/flashdecode.py"))
    # the pools are read where they lie: nothing gathers a pool
    assert max(c["bytes"] for c in dec["collectives"]["calls"]) < 2 ** 24
    assert train["ok"]
    data_axes = ("pod", "data") if multi else ("data",)
    grads = {}
    for c in train["collectives"]["calls"]:
        if c["where"].startswith("optim/adamw.py") and \
                c["kind"] in ("all-reduce", "reduce-scatter"):
            grads[c["axes"]] = grads.get(c["axes"], 0) + c["bytes"]
    for ax in data_axes:
        assert grads.get(ax, 0) > 0, grads
    coll = train["collectives"]
    assert train["mesh_device"] == dec["mesh_device"] == "cuda"
    # the residual stream's gradient is reduced once over "model" at each
    # layer boundary (spmd.rows' backward): no product gathers a weight,
    # and no Shard -> Shard redistribution is left in the step
    assert coll["count_by_kind_and_axes"].get("all-to-all@model", 0) == 0
    assert coll["total_bytes"] <= 90e9
    assert coll["body_weight"] == 1
    assert coll["weighted_total_bytes"] == coll["total_bytes"]
    _near_analytic(train, "deepseek_7b")


def _analytic(arch: str, shape_name: str, devices: int) -> float:
    """The reference's analytic flops of a cell per device, remat
    included (``benchmarks/flops_model.py``, loaded by path: the
    benchmarks are not a package on the tests' path)."""
    import importlib.util
    from repro.configs.base import SHAPES, get_config
    spec = importlib.util.spec_from_file_location(
        "flops_model", HERE.parent / "benchmarks" / "flops_model.py")
    fm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fm)
    return fm.cell_flops(get_config(arch),
                         SHAPES[shape_name])["hlo_equiv"] / devices


def _near_analytic(rec: dict, arch: str) -> None:
    """Rank 0 does one device's share of the step: its flops within 10%
    of the reference's analytic count per device."""
    want = _analytic(arch, "train_4k", rec["devices"])
    got = rec["cost_analysis"]["flops"]
    assert abs(got / want - 1) <= 0.10, (arch, got, want)


def _train_4k(arch: str) -> dict:
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.launch.fakeworld import fake_world
    with fake_world() as mesh:
        rec = _trace(get_config(arch), "train_4k", mesh, "gather")
    assert not dist.is_initialized()
    assert rec["ok"], rec
    return rec


@pytest.mark.parametrize("arch", ["phi3_mini_3p8b", "mamba2_1p3b",
                                  "gemma3_27b", "whisper_medium"])
def test_train_4k_flops_are_one_devices_share(arch):
    """Dense archs whose heads split over "model": rank 0's train_4k flops
    on the single-pod mesh match the analytic count per device (MoE archs
    are out: the reference's expert parallelism does M-fold expert work
    by design)."""
    _near_analytic(_train_4k(arch), arch)


def _local_flash_flops(cfg, heads: int, kv_heads: int, devices: int,
                       model: int) -> float:
    """One train_4k step's flash forward flops on rank 0's shapes: every
    layer's call and its remat recompute."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.distributed.spmd import flash_flops
    shape = SHAPES["train_4k"]
    B, S, hd = shape.global_batch * model // devices, shape.seq_len, \
        cfg.head_dim
    q = torch.empty(B, S, heads, hd, device="meta")
    kv = torch.empty(B, S, kv_heads, hd, device="meta")
    return 2 * cfg.n_layers * flash_flops(q, kv, kv, causal=True)


def test_nemotron_splits_q_heads_over_unsplit_kv_heads():
    """nemotron-4's 48 query heads split over the 16-wide "model" axis
    while its 8 KV heads do not: rank 0 attends with its 3 query heads,
    which read one KV head of K/V replicated over "model"."""
    from repro_torch.configs.base import get_config
    cfg = get_config("nemotron_4_15b")
    assert (cfg.n_heads, cfg.kv_heads) == (48, 8)
    rec = _train_4k("nemotron_4_15b")
    fl = rec["cost_analysis"]["kernel_flops"]
    want = _local_flash_flops(cfg, 3, 1, rec["devices"], 16)
    assert fl["flash_attention"] == want
    assert fl["flash_attention_bwd"] == 2.5 * want / 2


def test_qwen2_vl_replicates_heads_that_do_not_divide():
    """qwen2-VL's 28 query heads do not divide over 16: they replicate
    over "model", as the reference's rule leaves them, and the step's
    backward gathers the attention output's gradient before the heads
    unflatten (``common.merge_heads``)."""
    from repro_torch.configs.base import get_config
    cfg = get_config("qwen2_vl_7b")
    rec = _train_4k("qwen2_vl_7b")
    fl = rec["cost_analysis"]["kernel_flops"]
    assert fl["flash_attention"] == _local_flash_flops(
        cfg, 28, 4, rec["devices"], 16)
    assert rec["collectives"]["count_by_kind_and_axes"].get(
        "all-to-all@model", 0) == 0


def test_step_trace_counts_a_shard_to_shard_redistribute_as_all_to_all():
    """On the fake world's "cuda" mesh DTensor turns Shard(0) -> Shard(1)
    into ``_dtensor.shard_dim_alltoall``: one all-to-all on its axis."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch import dryrun
    from repro_torch.launch.fakeworld import fake_world
    with fake_world() as mesh:
        assert mesh.device_type == "cuda"
        x = DTensor.from_local(torch.empty(2, 256, device="meta"), mesh,
                               (Replicate(), Shard(0)), run_check=False,
                               shape=(32, 256), stride=(256, 1))
        with dryrun.StepTrace(mesh) as tr:
            y = x.redistribute(mesh, (Replicate(), Shard(1)))
        assert tuple(y.to_local().shape) == (32, 16)
        s = tr.summary()
    assert not dist.is_initialized()
    assert s["count_by_kind_and_axes"] == {"all-to-all@model": 1}
    assert s["calls"][0]["bytes"] == 2 * 256 * 4


def test_fake_world_closes_on_error_and_refuses_nesting():
    import torch.distributed as dist
    from repro_torch.launch.fakeworld import fake_world
    with pytest.raises(RuntimeError, match="already initialised"):
        with fake_world() as mesh:
            assert dist.get_world_size() == 256
            assert tuple(mesh.shape) == (16, 16)
            with fake_world():
                pass
    assert not dist.is_initialized()
    with pytest.raises(KeyError):
        with fake_world(multi_pod=True) as mesh:
            assert tuple(mesh.shape) == (2, 16, 16)
            raise KeyError("inside")
    assert not dist.is_initialized()


def test_cli_records_have_the_reference_keys(tmp_path):
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    dryrun.main(["--arch", "deepseek_7b,mamba2_1p3b", "--shape",
                 "decode_32k,long_500k", "--mesh", "single", "--attn",
                 "flashdecode", "--smoke", "--out", str(tmp_path)])
    assert not dist.is_initialized()
    recs = {p.name: json.loads(p.read_text())
            for p in tmp_path.glob("*.json")}
    assert sorted(recs) == [
        "deepseek_7b.decode_32k.single.flashdecode.smoke.json",
        "deepseek_7b.long_500k.single.flashdecode_blocksharded.smoke.json",
        "mamba2_1p3b.decode_32k.single.flashdecode.smoke.json",
        "mamba2_1p3b.long_500k.single.flashdecode_blocksharded.smoke.json"]
    skip = recs["deepseek_7b.long_500k.single.flashdecode_blocksharded"
                ".smoke.json"]
    assert skip["skipped"] and not skip["ok"] and "reason" in skip
    rec = recs["mamba2_1p3b.long_500k.single.flashdecode_blocksharded"
               ".smoke.json"]
    for key in ("ok", "skipped", "cost_analysis", "memory_analysis",
                "arg_bytes_per_device", "collectives", "meta", "devices",
                "trace_s"):
        assert key in rec, key
    assert rec["ok"] and rec["memory_analysis"] is None
    assert rec["meta"]["sharded_tables"] == [256, 128]
    layers = 4                      # mamba2 smoke: two mesh axes each
    assert _combines(rec) == {"max": 2 * layers, "sum": 2 * layers}
    # a second run takes the finished records
    dryrun.main(["--arch", "mamba2_1p3b", "--shape", "long_500k", "--mesh",
                 "single", "--attn", "flashdecode", "--smoke", "--out",
                 str(tmp_path)])


# ---------------------------------------------------------------------------
# (b) inputs, drawn once with numpy in the reference's layout
# ---------------------------------------------------------------------------

def _ref_cfg(arch):
    from repro.configs.base import get_smoke_config
    cfg = get_smoke_config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=MOE_CAPACITY))
    return cfg


def _port_cfg(arch):
    from repro_torch.configs.base import get_smoke_config
    cfg = get_smoke_config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=MOE_CAPACITY))
    return cfg


def _cells(cfg, mesh):
    """(decode cell through flashdecode, through gather, the train cell)
    of a [4, 64] decode and a [4, 32] train step on ``mesh``."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.specs import make_cell
    dec = ShapeSpec("decode", SEQ, B, "decode")
    return (make_cell(cfg, dec, mesh, "flashdecode"),
            make_cell(cfg, dec, mesh, "gather"),
            make_cell(cfg, ShapeSpec("train", PROMPT, B, "train"), mesh))


def _make_inputs(out: Path) -> None:
    import jax
    from repro.models.common import ParamSpec
    from repro.models.transformer import model_spec
    from repro_torch.launch.dryrun import placement_tables
    rng = np.random.default_rng(0)
    arrays = {}
    for arch in MESH_SHAPES:
        stub = SimpleNamespace(mesh_dim_names=("data", "model"),
                               shape=MESH_SHAPES[arch])
        leaves = jax.tree_util.tree_flatten_with_path(
            model_spec(_ref_cfg(arch)),
            is_leaf=lambda x: isinstance(x, ParamSpec))[0]
        for path, p in leaves:
            key = "/".join(str(e.key) for e in path)
            if p.init in ("zeros", "ones"):
                v = np.full(p.shape, 0.0 if p.init == "zeros" else 1.0)
            else:
                std = p.scale if p.scale is not None else \
                    1.0 / np.sqrt(max(1, int(np.prod(p.shape[:-1]))
                                      if len(p.shape) > 1 else p.shape[0]))
                v = rng.normal(size=p.shape) * std
            arrays[f"{arch}/params/{key}"] = v.astype(np.float32)
        cfg = _port_cfg(arch)
        cell = _cells(cfg, stub)[0]
        tabs = placement_tables(cell, stub, B)
        arrays[f"{arch}/table"] = tabs["block_table"]
        arrays[f"{arch}/sharded"] = tabs["sharded"]
        arrays[f"{arch}/logical"] = tabs["logical"]
        arrays[f"{arch}/prompt"] = rng.integers(
            0, cfg.vocab, (B, PROMPT)).astype(np.int32)
        arrays[f"{arch}/next"] = rng.integers(0, cfg.vocab, B).astype(
            np.int32)
        arrays[f"{arch}/train"] = rng.integers(
            0, cfg.vocab, (B, PROMPT + 1)).astype(np.int32)
    np.savez(out / "inputs.npz", **arrays)
    (out / "layout.json").write_text(json.dumps(
        dataclasses.asdict(cell.layout)))


def _unflat(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node = tree
        parts = k[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _flat(tree, prefix: str) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, dtype=np.float32)
    return out


# one step from a resumed AdamW state (step 1, first moments 0, second
# moments NU0 > 0): an element's update is then a smooth function of its
# gradient (at nu 0 it is +-lr for any gradient, float noise included), so
# the sharded and the unsharded updates compare leaf by leaf; the learning
# rate makes the update far larger than float32 rounding of the params
NU0 = 1e-6
TRAIN_KW = dict(base_lr=3e-2, warmup_steps=1)
# max |dP - dP_ref| / max |dP_ref| per leaf (dP = the step's change of the
# params): the sound program reads at most 1.8e-5 (deepseek-moe-16b's
# embedding; deepseek-7b 7.0e-6); an update without its gradient term, or
# with one rank's part of each moment shard left out, reads 0.82-1.0
UPDATE_TOL = 1e-4


def _reference_main(out: Path) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.distributed.flashdecode import set_decode_mesh
    from repro.models.decode import (PagedLayout, cache_init, decode_step,
                                     prefill_step)
    from repro.optim.adamw import adamw_init
    from repro.training.train_step import make_train_step
    x = dict(np.load(out / "inputs.npz"))
    layout = PagedLayout(**json.loads((out / "layout.json").read_text()))
    res = {}
    f32 = jnp.float32
    mesh22 = Mesh(np.array(jax.devices()[:WORLD]).reshape(2, 2),
                  ("data", "model"))
    for arch in MESH_SHAPES:
        cfg = _ref_cfg(arch)
        params = jax.tree.map(jnp.asarray, _unflat(x, f"{arch}/params/"))
        table = jnp.asarray(x[f"{arch}/table"])
        cache = cache_init(cfg, layout, B, f32)
        logits, cache = prefill_step(params, cfg, cache,
                                     jnp.asarray(x[f"{arch}/prompt"]), table,
                                     layout, compute_dtype=f32)
        res[f"{arch}/prefill/logits"] = np.asarray(logits)
        res.update(_flat(cache, f"{arch}/prefill/cache/"))
        logits, _, heat = decode_step(
            params, cfg, cache, jnp.asarray(x[f"{arch}/next"]),
            jnp.full((B,), PROMPT, jnp.int32), table, layout,
            compute_dtype=f32)
        res[f"{arch}/decode/logits"] = np.asarray(logits)
        res[f"{arch}/decode/heat"] = np.asarray(heat)
        if arch != GQA_ARCH:
            # the reference's own flash-decoding on a 2 x 2 mesh: its heat
            # is per shard, against the shard's local max
            set_decode_mesh(mesh22)
            logits, _, heat = jax.jit(
                lambda p, c, t, n, tb, st, sl, cfg=cfg: decode_step(
                    p, cfg, c, t, n, tb, layout, compute_dtype=f32,
                    attn_impl="flashdecode", sharded_table=st,
                    sharded_logical=sl))(
                params, cache, jnp.asarray(x[f"{arch}/next"]),
                jnp.full((B,), PROMPT, jnp.int32), table,
                jnp.asarray(x[f"{arch}/sharded"]),
                jnp.asarray(x[f"{arch}/logical"]))
            set_decode_mesh(None)
            res[f"{arch}/flashdecode/logits"] = np.asarray(logits)
            res[f"{arch}/flashdecode/heat"] = np.asarray(heat)
        # a MoE layer trains expert-parallel on the 2 x 2 mesh, as the
        # ranks do: its load-balancing loss is then the mean of the data
        # shards' (the reference's moe_apply_ep), not the whole batch's
        set_decode_mesh(mesh22 if cfg.moe is not None else None)
        step = jax.jit(make_train_step(cfg, compute_dtype=f32, **TRAIN_KW))
        opt = adamw_init(params)._replace(
            step=jnp.ones((), jnp.int32),
            nu=jax.tree.map(lambda a: jnp.full(a.shape, NU0, f32), params))
        p, s, m = step(params, opt,
                       {"tokens": jnp.asarray(x[f"{arch}/train"])})
        set_decode_mesh(None)
        res[f"{arch}/train/loss"] = np.asarray(m["loss"])
        res.update(_flat(p, f"{arch}/train/params/"))
        res.update(_flat(s.mu, f"{arch}/train/mu/"))
        res.update(_flat(s.nu, f"{arch}/train/nu/"))
    np.savez(out / "reference.npz", **res)


# ---------------------------------------------------------------------------
# (b) the port's side: 4 gloo ranks, each rank 0 of nothing but its shards
# ---------------------------------------------------------------------------

def _rank_worker(rank: int, world: int, out: Path) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.convert import params_from_jax, params_to_numpy
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import Cell, named
    from repro_torch.models.common import F32
    from repro_torch.models.decode import cache_init
    from repro_torch.optim.adamw import adamw_init, tree_map
    dist.init_process_group("gloo", store=dist.FileStore(
        str(out / "store"), world), rank=rank, world_size=world)
    # every rank builds every mesh, in the same order
    meshes = {shape: init_device_mesh("cpu", shape,
                                      mesh_dim_names=("data", "model"))
              for shape in sorted(set(MESH_SHAPES.values()))}
    x = dict(np.load(out / "inputs.npz"))
    res, counts = {}, {}

    def dt(tree, shard):
        return dryrun.tree_pairs(tree, shard, lambda t, sh: distribute_tensor(
            t, mesh, sh.placements))

    def full(tree):
        return dryrun.tree_pairs(tree, tree, lambda t, _: t.full_tensor())

    for arch in MESH_SHAPES:
        mesh = meshes[MESH_SHAPES[arch]]
        cfg = _port_cfg(arch)
        fd_cell, g_cell, t_cell = _cells(cfg, mesh)
        layout = fd_cell.layout
        host = params_from_jax(_unflat(x, f"{arch}/params/"), device="cpu")
        pshard, cshard = fd_cell.in_shardings[0], fd_cell.in_shardings[1]
        tbl_sh = fd_cell.in_shardings[4]
        t = {k: torch.from_numpy(x[f"{arch}/{k}"]) for k in
             ("table", "sharded", "logical", "prompt", "next", "train")}
        params = dt(host, pshard)
        cache = dt(cache_init(cfg, layout, B, F32, device="cpu"), cshard)
        prefill = Cell(kind="prefill", args=(), in_shardings=(),
                       out_shardings=(named(mesh), cshard), layout=layout,
                       meta={"extras": {}})
        (logits, cache), tr = dryrun.run_program(
            cfg, prefill, mesh, (params, cache, distribute_tensor(
                t["prompt"], mesh, tbl_sh.placements), distribute_tensor(
                t["table"], mesh, tbl_sh.placements)), compute_dtype=F32)
        res[f"{arch}/prefill/logits"] = logits.full_tensor()
        counts[f"{arch}/prefill"] = tr.summary()["count_by_kind"]
        res.update({f"{arch}/prefill/cache/{k}": v for k, v in _flat(
            tree_map(lambda c: c.full_tensor().numpy(), cache), "").items()})
        for mode, cell in (("gather", g_cell), ("flashdecode", fd_cell)):
            if arch == GQA_ARCH and mode == "flashdecode":
                continue
            sh = cell.in_shardings
            args = [params, tree_map(lambda c: c.clone(), cache)] + [
                distribute_tensor(v, mesh, s.placements) for v, s in zip(
                    (t["next"], torch.full((B,), PROMPT, dtype=torch.int32),
                     t["table"], t["sharded"], t["logical"]), sh[2:])]
            (logits, _, heat), tr = dryrun.run_program(
                cfg, cell, mesh, tuple(args), compute_dtype=F32)
            res[f"{arch}/{mode}/logits"] = logits.full_tensor()
            res[f"{arch}/{mode}/heat"] = heat.full_tensor()
            counts[f"{arch}/{mode}"] = tr.summary()["count_by_kind"]
        pt, ot, bt = t_cell.in_shardings
        p0 = dt(host, pt)
        opt = adamw_init(host)
        opt = type(opt)(step=distribute_tensor(torch.ones_like(opt.step),
                                               mesh, ot.step.placements),
                        mu=dt(opt.mu, ot.mu),
                        nu=dt(tree_map(lambda a: torch.full_like(a, NU0),
                                       opt.nu), ot.nu))
        batch = {"tokens": distribute_tensor(t["train"], mesh,
                                             bt["tokens"].placements)}
        (p1, s1, m), tr = dryrun.run_program(
            cfg, t_cell, mesh, (p0, opt, batch), compute_dtype=F32,
            **TRAIN_KW)
        counts[f"{arch}/train"] = tr.summary()["count_by_kind_and_axes"]
        counts[f"{arch}/train/kernel_flops"] = tr.kernel_flops
        res[f"{arch}/train/loss"] = m["loss"].full_tensor()
        for name, tree in (("params", p1), ("mu", s1.mu), ("nu", s1.nu)):
            res.update(_flat(params_to_numpy(full(tree)),
                             f"{arch}/train/{name}/"))
    if rank == 0:
        np.savez(out / "ranks.npz", **{k: np.asarray(v) for k, v in
                                       res.items()})
        (out / "counts.json").write_text(json.dumps(counts))
    dist.destroy_process_group()


def _ranks_main(out: Path) -> None:
    import torch.multiprocessing as mp
    mp.start_processes(_rank_worker, args=(WORLD, out), nprocs=WORLD,
                       start_method="spawn")


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Start the reference's child and the ranks with the file; (a)'s
    tests run meanwhile."""
    out = tmp_path_factory.mktemp("dryrun")
    _make_inputs(out)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), str(HERE),
                                         env.get("PYTHONPATH", "")])
    ref_env = dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        env.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={WORLD}"
        + " --xla_cpu_multi_thread_eigen=false").strip())
    procs = []
    for what, e in (("reference", ref_env), ("ranks", env)):
        log = open(out / f"{what}.log", "w")
        procs.append((what, log, subprocess.Popen(
            [sys.executable, __file__, what, str(out)], env=e,
            stdout=log, stderr=subprocess.STDOUT)))
    yield out, procs
    for _, log, proc in procs:
        if proc.poll() is None:
            proc.kill()
        log.close()


@pytest.fixture(autouse=True, scope="module")
def _start(launched):
    return launched


@pytest.fixture(scope="module")
def runs(launched):
    out, procs = launched
    for what, log, proc in procs:
        proc.wait(timeout=600)
        log.flush()
        assert proc.returncode == 0, \
            f"{what}:\n" + (out / f"{what}.log").read_text()[-4000:]
    return (dict(np.load(out / "reference.npz")),
            dict(np.load(out / "ranks.npz")),
            json.loads((out / "counts.json").read_text()))


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("arch", list(MESH_SHAPES))
def test_sharded_prefill_matches_reference(runs, arch):
    ref, got, counts = runs
    _close(got[f"{arch}/prefill/logits"], ref[f"{arch}/prefill/logits"],
           1e-4, 1e-5, "logits")
    pools = [k for k in ref if k.startswith(f"{arch}/prefill/cache/")]
    assert pools
    for k in pools:
        _close(got[k], ref[k], 1e-4, 1e-5, k)
    assert counts[f"{arch}/prefill"].get("all-reduce", 0) > 0


@pytest.mark.parametrize("arch,mode", [
    (a, m) for a in MESH_SHAPES for m in ("gather", "flashdecode")
    if (a, m) != (GQA_ARCH, "flashdecode")])
def test_sharded_decode_matches_reference(runs, arch, mode):
    """Logits against the reference's unsharded decode (and against its
    own flash-decoding on a 2 x 2 mesh); the heat against the reference's
    heat of the same mode: [B, MB] for gather, the shard-major
    [B, NS * MBl] of per-shard masses for flashdecode."""
    ref, got, _ = runs
    logits = got[f"{arch}/{mode}/logits"]
    _close(logits, ref[f"{arch}/decode/logits"], 1e-4, 1e-5, "logits")
    if mode == "flashdecode":
        _close(logits, ref[f"{arch}/flashdecode/logits"], 1e-4, 1e-5,
               "logits vs the reference's flashdecode")
    want = ref[f"{arch}/{'decode' if mode == 'gather' else mode}/heat"]
    _close(got[f"{arch}/{mode}/heat"], want, 1e-4, 1e-6, "heat")


@pytest.fixture(scope="module")
def inputs(launched):
    return dict(np.load(launched[0] / "inputs.npz"))


@pytest.mark.parametrize("arch", list(MESH_SHAPES))
def test_sharded_train_step_matches_reference(runs, inputs, arch):
    """Loss, the step's change of every param and both AdamW moments after
    one step (params split by the TP rules, moments by ZeRO-1)."""
    ref, got, counts = runs
    _close(got[f"{arch}/train/loss"], ref[f"{arch}/train/loss"], 1e-4, 0,
           "loss")
    bad = {}
    keys = [k for k in ref if k.startswith(f"{arch}/train/params/")]
    assert keys and all(k in got for k in keys)
    for k in keys:
        p0 = inputs[f"{arch}/params/" + k.split("/train/params/")[1]]
        d_ref = ref[k] - p0
        scale = float(np.abs(d_ref).max())
        assert scale > 0, k
        err = float(np.abs((got[k] - p0) - d_ref).max()) / scale
        if not err <= UPDATE_TOL:
            bad[k] = err
    for part in ("mu", "nu"):
        keys = [k for k in ref if k.startswith(f"{arch}/train/{part}/")]
        assert keys and all(k in got for k in keys)
        for k in keys:
            scale = max(float(np.abs(ref[k]).max()), 1e-30)
            err = float(np.abs(got[k] - ref[k]).max()) / scale
            if not err <= 1e-4:
                bad[k] = err
    assert not bad, sorted(bad.items(), key=lambda kv: kv[0].split("/")[2])
    c = counts[f"{arch}/train"]
    if MESH_SHAPES[arch][0] > 1:            # the gradients reduce over data
        assert c.get("reduce-scatter@data", 0) + \
            c.get("all-reduce@data", 0) > 0


def test_gqa_ranks_attend_with_their_own_heads(runs):
    """On the 1 x 4 mesh each rank's flash calls take its 2 of 8 query
    heads and the one KV head they read (K/V replicated over "model"):
    the train step's flash flops are those of 2 heads a rank."""
    from repro_torch.distributed.spmd import flash_flops
    cfg = _port_cfg(GQA_ARCH)
    assert (cfg.n_heads, cfg.kv_heads) == (8, 2)
    _, _, counts = runs
    q = torch.empty(B, PROMPT, 2, cfg.head_dim, device="meta")
    kv = torch.empty(B, PROMPT, 1, cfg.head_dim, device="meta")
    one = cfg.n_layers * flash_flops(q, kv, kv, causal=True)
    fl = counts[f"{GQA_ARCH}/train/kernel_flops"]
    # each layer's call and its remat recompute; one backward
    assert fl == {"flash_attention": 2 * one,
                  "flash_attention_bwd": 2.5 * one}


def test_moe_runs_expert_parallel(runs):
    _, _, counts = runs
    assert counts["deepseek_moe_16b/train"].get("all-to-all@model", 0) > 0
    assert counts["deepseek_7b/train"].get("all-to-all@model", 0) == 0


if __name__ == "__main__":
    {"reference": _reference_main, "ranks": _ranks_main}[sys.argv[1]](
        Path(sys.argv[2]))
