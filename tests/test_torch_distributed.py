"""The port's distributed paths against the reference's, on CPU ranks.

The port's side runs as 8 ``torch.distributed`` ranks (gloo, one torch
thread each, a ``FileStore`` under the test's tmp dir), spawned once for
the whole file: every case runs in them and each rank writes its results
to an ``.npz``.  The reference's side runs in ONE child process with 8
forced host devices (``--xla_force_host_platform_device_count=8``), as its
own ``tests/test_shardmap_paths.py`` does, and with XLA's excess precision
off (bf16 parity, ``tests/test_torch_engine.py``).  Both read the same
inputs, drawn here with numpy from a seed.  The two run at once; the ranks
wait for the reference's prefilled pools before their decode case.

Cases (port vs reference, tolerance):
  * ``paged_decode_partials_plain`` with a window and a soft cap vs
    ``flashdecode._partials`` (f32, 2e-5: m, l, acc, heat);
  * ``paged_decode_attention_sharded`` batch-sharded on 2 x 4 and
    block-sharded over all 8 ranks (with a window and a soft cap), and
    ``paged_mla_decode_sharded`` on 2 x 4, vs the reference's same
    function and layout (f32, 2e-5, the heat too: each rank's columns of
    the reference's shard-major heat);
  * ``decode_step(attn_impl="flashdecode" | "flashdecode_blocksharded")``
    on deepseek-7b smoke, a 2 x 2 mesh (ranks 0-3), bf16, 3 steps from the
    reference's prefilled pools, vs the reference's ``decode_step`` in the
    same mode under ``jit``: logits 2e-2, pools bit-identical, heat 1e-2
    relative;
  * ``moe_apply_ep`` on 2 x 4 with ``MoECfg(8, 2, 16, 1, 8.0)`` (f32, 1e-4)
    and deepseek-moe smoke's MoE (bf16, 2e-2), aux within 1e-6, vs the
    reference's ``moe_apply_ep``; ``moe_apply``'s choice of it vs the
    reference's condition (exact);
  * ``compressed_psum_mean`` on 8 ranks vs numpy's mean of the reference's
    per-shard ``compress_residual`` (1e-6 relative; the error feedback
    equal), and its tree form;
  * the host mesh on 8 ranks, and the production mesh's refusal.
Single-process cases (int8 quantization, the sharding rules on all ten
archs) run in this process.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
WORLD = 8
ARCHS = ("deepseek_7b", "deepseek_moe_16b", "deepseek_v2_lite_16b",
         "gemma3_27b", "jamba_v0_1_52b", "mamba2_1p3b", "nemotron_4_15b",
         "phi3_mini_3p8b", "qwen2_vl_7b", "whisper_medium")
# (mesh shape, axis names or None for no mesh, experts, tokens)
CHOICES = [((2, 4), ("data", "model"), 8, 16), ((2, 4), ("data", "model"),
                                                6, 16),
           ((2, 4), ("data", "model"), 8, 15), ((8, 1), ("data", "model"),
                                                8, 16),
           ((1, 8), ("data", "model"), 8, 16), ((2, 2, 2),
                                                ("pod", "data", "model"),
                                                4, 12),
           ((2, 2, 2), ("pod", "data", "model"), 4, 6), ((8,), ("data",),
                                                         8, 16),
           ((4, 2), ("data", "model"), 2, 4), (None, None, 8, 16)]
DECODE = dict(B=4, bt=4, MB=8, NB=32, prompts=(13, 20, 9, 24), S=24,
              steps=3)
MODES = ("flashdecode", "flashdecode_blocksharded")


# ---------------------------------------------------------------------------
# Inputs, drawn once with numpy
# ---------------------------------------------------------------------------

def _placement_batch_sharded(lengths, B, MB, bt, D, M, NB_loc):
    """``tests/test_shardmap_paths.py``'s placement: sequence b on data
    shard b // (B / D), its logical block lb on model rank lb % M, rows
    unique inside the shard."""
    Bl = B // D
    tbl = np.full((B, MB), -1, np.int32)
    sh_tbl = np.full((B, M, MB // M), -1, np.int32)
    sh_log = np.full((B, M, MB // M), -1, np.int32)
    for b in range(B):
        d = b // Bl
        for lb in range(-(-int(lengths[b]) // bt)):
            m = lb % M
            phys = (d * M + m) * NB_loc + b % Bl + (lb // M) * Bl
            tbl[b, lb] = phys
            sh_tbl[b, m, lb // M] = phys
            sh_log[b, m, lb // M] = lb
    return tbl, sh_tbl, sh_log


def _placement_block_sharded(B, MB, NS, NB_loc):
    """Logical block lb of every sequence on shard lb % NS."""
    tbl = np.full((B, MB), -1, np.int32)
    for b in range(B):
        for lb in range(MB):
            tbl[b, lb] = (lb % NS) * NB_loc + b + (lb // NS) * B
    return tbl


def make_inputs(out: Path) -> None:
    from repro_torch.convert import params_to_numpy, sharded_tables
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import materialize, model_spec
    from repro_torch.models.moe import moe_spec
    rng = np.random.default_rng(0)
    f32 = np.float32
    x = {}
    # paged partials on one shard: B 3, G 4, a window and a soft cap
    x["p_q"] = rng.normal(size=(3, 8, 16)).astype(f32)
    x["p_pk"] = rng.normal(size=(12, 4, 2, 16)).astype(f32)
    x["p_pv"] = rng.normal(size=(12, 4, 2, 16)).astype(f32)
    perm = rng.permutation(12)
    x["p_table"] = np.stack([perm[:5], np.r_[perm[5:8], -1, -1],
                             np.full(5, -1)]).astype(np.int32)   # row 2 empty
    x["p_logical"] = np.stack([np.arange(5) * 2, np.arange(5) * 2 + 1,
                               np.arange(5)]).astype(np.int32)
    x["p_lengths"] = np.array([37, 30, 9], np.int32)
    # sharded GQA / MLA decode on 2 x 4 (B 4, NB 64, 8 blocks of 4 tokens)
    B, H, KVH, hd, bt, NB, MB = 4, 8, 4, 16, 4, 64, 8
    x["g_q"] = rng.normal(size=(B, H, hd)).astype(f32)
    x["g_pk"] = rng.normal(size=(NB, bt, KVH, hd)).astype(f32)
    x["g_pv"] = rng.normal(size=(NB, bt, KVH, hd)).astype(f32)
    x["g_lengths"] = np.array([9, 17, 25, 32], np.int32)
    x["g_tbl"], x["g_sh"], x["g_sl"] = _placement_batch_sharded(
        x["g_lengths"], B, MB, bt, 2, 4, NB // 8)
    x["k_tbl"] = _placement_block_sharded(B, MB, 8, NB // 8)
    x["k_sh"], x["k_sl"] = sharded_tables(x["k_tbl"], nb_loc=NB // 8,
                                          num_slots=8)
    x["m_pool"] = rng.normal(size=(NB, bt, 32 + 8)).astype(f32)
    x["m_qe"] = rng.normal(size=(B, H, 32)).astype(f32)
    x["m_qr"] = rng.normal(size=(B, H, 8)).astype(f32)
    # MoE: the EP test's layer (f32) and deepseek-moe smoke's (bf16)
    gen = torch.Generator().manual_seed(1)
    from repro_torch.configs.base import MoECfg
    cfg8 = MoECfg(num_experts=8, top_k=2, d_ff_expert=16, num_shared=1,
                  capacity_factor=8.0)
    for tag, cfg, d in (("e", cfg8, 32),
                        ("eb", get_smoke_config("deepseek_moe_16b").moe,
                         64)):
        layer = materialize(gen, moe_spec(d, cfg, "swiglu"), device="cpu")
        for k, v in layer.items():
            x[f"{tag}_w_{k}"] = v.numpy()
        x[f"{tag}_x"] = rng.normal(size=(16, d)).astype(f32)
    # gradient compression: 8 shards' gradients and residuals
    x["c_g"] = rng.normal(size=(WORLD, 4, 32)).astype(f32)
    x["c_err"] = (0.01 * rng.normal(size=(WORLD, 4, 32))).astype(f32)
    # decode_step on deepseek-7b smoke, 2 x 2
    cfg = get_smoke_config("deepseek_7b")
    p = params_to_numpy(materialize(gen, model_spec(cfg), device="cpu"))
    x.update({f"params/{k}": v for k, v in _flat(p).items()})
    dd = DECODE
    x["d_tokens"] = rng.integers(1, cfg.vocab, (dd["B"], dd["S"])
                                 ).astype(np.int32)
    x["d_steps"] = rng.integers(1, cfg.vocab, (dd["steps"], dd["B"])
                                ).astype(np.int32)
    nb_loc = dd["NB"] // 4
    x["d_tbl_flashdecode"], x["d_sh_flashdecode"], \
        x["d_sl_flashdecode"] = _placement_batch_sharded(
            np.full(dd["B"], dd["MB"] * dd["bt"]), dd["B"], dd["MB"],
            dd["bt"], 2, 2, nb_loc)
    t = _placement_block_sharded(dd["B"], dd["MB"], 4, nb_loc)
    x["d_tbl_flashdecode_blocksharded"] = t
    x["d_sh_flashdecode_blocksharded"], \
        x["d_sl_flashdecode_blocksharded"] = sharded_tables(
            t, nb_loc=nb_loc, num_slots=4)
    np.savez(out / "inputs.npz", **x)


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _unflat(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, arr in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    return tree


def _load(path: Path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _save(path: Path, arrays: dict) -> None:
    """Write atomically: a reader polling for ``path`` never sees half."""
    tmp = path.with_name(path.name + ".tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# The reference's side: one child process, 8 forced host devices
# ---------------------------------------------------------------------------

def _reference_main(out: Path) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs.base import MoECfg, get_smoke_config
    from repro.distributed import compression as cmp
    from repro.distributed import flashdecode as fd
    from repro.models import moe as moe_mod
    from repro.models.decode import (PagedLayout, cache_init, decode_step,
                                     prefill_step)
    x = _load(out / "inputs.npz")
    r = {}
    devs = np.array(jax.devices())
    mesh24 = Mesh(devs.reshape(2, 4), ("data", "model"))
    mesh22 = Mesh(devs[:4].reshape(2, 2), ("data", "model"))

    # the decode case first: the ranks wait for its prefilled pools
    cfg = get_smoke_config("deepseek_7b")
    params = jax.tree.map(jnp.asarray, _unflat(x, "params/"))
    dd = DECODE
    layout = PagedLayout(num_blocks=dd["NB"], block_tokens=dd["bt"],
                         max_blocks=dd["MB"])
    prompts = np.array(dd["prompts"], np.int32)
    caches, pre = {}, {}
    for mode in MODES:
        tbl = jnp.asarray(x[f"d_tbl_{mode}"])
        cache = cache_init(cfg, layout, dd["B"])
        _, cache = prefill_step(params, cfg, cache,
                                jnp.asarray(x["d_tokens"]), tbl, layout,
                                last_index=jnp.asarray(prompts - 1))
        caches[mode] = cache
        pre.update({f"{mode}/{k}": v for k, v in _flat(cache).items()})
    _save(out / "prefill.npz", pre)
    fd.set_decode_mesh(mesh22)
    for mode in MODES:
        step = jax.jit(lambda p, c, t, n, tb, st, sl, mode=mode: decode_step(
            p, cfg, c, t, n, tb, layout, attn_impl=mode, sharded_table=st,
            sharded_logical=sl))
        cache = caches[mode]
        for i in range(dd["steps"]):
            logits, cache, heat = step(
                params, cache, jnp.asarray(x["d_steps"][i]),
                jnp.asarray(prompts + i), jnp.asarray(x[f"d_tbl_{mode}"]),
                jnp.asarray(x[f"d_sh_{mode}"]),
                jnp.asarray(x[f"d_sl_{mode}"]))
            r[f"dec/{mode}/logits{i}"] = np.asarray(logits)
            r[f"dec/{mode}/heat{i}"] = np.asarray(heat)
        r.update({f"dec/{mode}/cache/{k}": v
                  for k, v in _flat(cache).items()})

    # the shard partials
    q, pk, pv = x["p_q"], x["p_pk"], x["p_pv"]
    table = x["p_table"]
    ok = table >= 0
    safe = np.clip(table, 0, None)
    m, l, acc, heat = fd._partials(
        jnp.asarray(q), jnp.asarray(pk[safe]), jnp.asarray(pv[safe]),
        jnp.asarray(x["p_logical"]), jnp.asarray(ok),
        jnp.asarray(x["p_lengths"]), bt=4, window=7, soft_cap=15.0, KVH=2,
        G=4)
    r["p/m"], r["p/l"] = np.asarray(m).reshape(3, 8), \
        np.asarray(l).reshape(3, 8)
    r["p/acc"], r["p/heat"] = np.asarray(acc).reshape(3, 8, 16), \
        np.asarray(heat)

    # sharded GQA (both layouts) and MLA on 2 x 4
    fd.set_decode_mesh(mesh24)
    g = [jnp.asarray(x[k]) for k in ("g_q", "g_pk", "g_pv")]
    out_b, heat_b = jax.jit(lambda *a: fd.paged_decode_attention_sharded(
        *a, block_tokens=4))(*g, x["g_sh"], x["g_sl"], x["g_lengths"])
    out_k, heat_k = jax.jit(lambda *a: fd.paged_decode_attention_sharded(
        *a, block_tokens=4, window=5, soft_cap=20.0,
        batch_sharded=False))(*g, x["k_sh"], x["k_sl"], x["g_lengths"])
    o_lat, m_heat = jax.jit(lambda *a: fd.paged_mla_decode_sharded(
        *a, block_tokens=4, kv_lora=32, qk_nope=16))(
            x["m_qe"], x["m_qr"], x["m_pool"], x["g_sh"], x["g_sl"],
            x["g_lengths"])
    r.update({"g/out": out_b, "g/heat": heat_b, "k/out": out_k,
              "k/heat": heat_k, "m/out": o_lat, "m/heat": m_heat})

    # EP MoE on 2 x 4
    cfg8 = MoECfg(num_experts=8, top_k=2, d_ff_expert=16, num_shared=1,
                  capacity_factor=8.0)
    for tag, mcfg, dtype in (("e", cfg8, jnp.float32),
                             ("eb", get_smoke_config(
                                 "deepseek_moe_16b").moe, jnp.bfloat16)):
        layer = {k[len(tag) + 3:]: jnp.asarray(v) for k, v in x.items()
                 if k.startswith(f"{tag}_w_")}
        out_e, aux = jax.jit(lambda p, v, c=mcfg: moe_mod.moe_apply_ep(
            p, v, c, "swiglu", mesh24))(
                layer, jnp.asarray(x[f"{tag}_x"]).astype(dtype))
        r[f"{tag}/out"] = np.asarray(out_e.astype(jnp.float32))
        r[f"{tag}/aux"] = np.asarray(aux)

    # moe_apply's choice of the EP path
    chose = []
    moe_mod.moe_apply_ep = lambda *a, **k: ("ep", None)
    moe_mod._moe_apply_local = lambda *a, **k: ("local", None)
    for shape, names, E, T in CHOICES:
        fd.set_decode_mesh(None if shape is None else
                           Mesh(devs.reshape(shape), names))
        choice, _ = moe_mod.moe_apply(
            {}, jnp.zeros((T, 4)), MoECfg(num_experts=E, top_k=1,
                                          d_ff_expert=4), "swiglu")
        chose.append(choice == "ep")
    r["choice"] = np.array(chose)
    fd.set_decode_mesh(None)

    # compression: each shard's compress_residual, then numpy's mean
    deq, errs = [], []
    for i in range(WORLD):
        q8, s8, e8 = cmp.compress_residual(jnp.asarray(x["c_g"][i]),
                                           jnp.asarray(x["c_err"][i]))
        deq.append(np.asarray(cmp.dequantize_int8(q8, s8)).reshape(4, 32))
        errs.append(np.asarray(e8))
    r["c/mean"] = np.mean(np.stack(deq), axis=0)
    r["c/err"] = np.stack(errs)
    _save(out / "reference.npz", r)


# ---------------------------------------------------------------------------
# The port's side: 8 gloo ranks
# ---------------------------------------------------------------------------

def _wait_for(path: Path, timeout: float = 300.0) -> None:
    t0 = time.monotonic()
    while not path.exists():
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.2)


def _rank_worker(rank: int, world: int, out: Path) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs.base import MoECfg, get_smoke_config
    from repro_torch.convert import (cache_from_jax, params_from_jax,
                                     rank_params_from_jax)
    from repro_torch.distributed import compression as cmp
    from repro_torch.distributed import flashdecode as fd
    from repro_torch.launch import make_host_mesh, make_production_mesh
    from repro_torch.models import PagedLayout, decode_step
    from repro_torch.models import moe as moe_mod
    dist.init_process_group("gloo", store=dist.FileStore(
        str(out / "store"), world), rank=rank, world_size=world)
    x = _load(out / "inputs.npz")
    t = {k: torch.from_numpy(v) for k, v in x.items()
         if not k.startswith("params/")}
    r = {}
    mesh = make_host_mesh(model=4, device_type="cpu")
    mesh22 = DeviceMesh("cpu", [[0, 1], [2, 3]],
                        mesh_dim_names=("data", "model"))
    r["mesh/shape"] = np.array(mesh.shape)
    r["mesh/coord"] = np.array([mesh.get_local_rank("data"),
                                mesh.get_local_rank("model")])
    try:
        make_production_mesh(device_type="cpu")
    except ValueError:
        r["mesh/production_refused"] = np.array(True)
    d, m = rank // 4, rank % 4
    rows = slice(2 * d, 2 * d + 2)

    # sharded GQA and MLA decode
    fd.set_decode_mesh(mesh)
    nb_loc = t["g_pk"].shape[0] // world
    own = slice(rank * nb_loc, (rank + 1) * nb_loc)
    out_b, heat_b = fd.paged_decode_attention_sharded(
        t["g_q"][rows], t["g_pk"][own], t["g_pv"][own], t["g_sh"][rows, m],
        t["g_sl"][rows, m], t["g_lengths"][rows], block_tokens=4)
    out_k, heat_k = fd.paged_decode_attention_sharded(
        t["g_q"], t["g_pk"][own], t["g_pv"][own], t["k_sh"][:, rank],
        t["k_sl"][:, rank], t["g_lengths"], block_tokens=4, window=5,
        soft_cap=20.0, batch_sharded=False)
    o_lat, m_heat = fd.paged_mla_decode_sharded(
        t["m_qe"][rows], t["m_qr"][rows], t["m_pool"][own],
        t["g_sh"][rows, m], t["g_sl"][rows, m], t["g_lengths"][rows],
        block_tokens=4, kv_lora=32, qk_nope=16)
    r.update({"g/out": out_b, "g/heat": heat_b, "k/out": out_k,
              "k/heat": heat_k, "m/out": o_lat, "m/heat": m_heat})

    # EP MoE: this rank's data shard of the tokens and its experts
    cfg8 = MoECfg(num_experts=8, top_k=2, d_ff_expert=16, num_shared=1,
                  capacity_factor=8.0)
    for tag, mcfg, dtype in (("e", cfg8, torch.float32),
                             ("eb", get_smoke_config(
                                 "deepseek_moe_16b").moe, torch.bfloat16)):
        layer = {k[len(tag) + 3:]: v for k, v in x.items()
                 if k.startswith(f"{tag}_w_")}
        params = rank_params_from_jax(layer, model_index=m, model_size=4,
                                      device="cpu")
        xs = t[f"{tag}_x"][8 * d:8 * d + 8].to(dtype)
        out_e, aux = moe_mod.moe_apply(params, xs, mcfg, "swiglu")
        r[f"{tag}/out"], r[f"{tag}/aux"] = out_e.float(), aux
        # the whole layer's params take the same path
        r[f"{tag}/out_whole"] = moe_mod.moe_apply_ep(
            {k: torch.from_numpy(v) for k, v in layer.items()}, xs, mcfg,
            "swiglu", mesh)[0].float()
    fd.set_decode_mesh(None)

    # compression over an 8-way data axis: this rank's gradient, every
    # mode, and the tree form
    data8 = make_host_mesh(model=1, device_type="cpu")
    g, err = t["c_g"][rank], t["c_err"][rank]
    r["c/mean"], r["c/err"] = cmp.compressed_psum_mean(g, data8, err=err)
    r["c/none"] = cmp.compressed_psum_mean(g, data8, mode="none")[0]
    r["c/bf16"] = cmp.compressed_psum_mean(g, data8, mode="bf16")[0]
    tree_mean, tree_err = cmp.compressed_grad_mean_tree(
        {"a": g, "b": [g[0], 2 * g]}, data8)
    r["c/tree_a"], r["c/tree_b1"] = tree_mean["a"], tree_mean["b"][1]
    r["c/tree_err_b0"] = tree_err["b"][0]

    # decode_step on the 2 x 2 sub-mesh of ranks 0-3
    _wait_for(out / "prefill.npz")
    pre = _load(out / "prefill.npz")
    cfg = get_smoke_config("deepseek_7b")
    dd = DECODE
    layout = PagedLayout(num_blocks=dd["NB"], block_tokens=dd["bt"],
                         max_blocks=dd["MB"])
    if rank < 4:
        fd.set_decode_mesh(mesh22)
        params = params_from_jax(_unflat(x, "params/"), device="cpu")
        d2, m2 = rank // 2, rank % 2
        prompts = torch.tensor(dd["prompts"], dtype=torch.int32)
        for mode in MODES:
            bsh = mode == "flashdecode"
            rows2 = slice(2 * d2, 2 * d2 + 2) if bsh else slice(None)
            slot = m2 if bsh else rank
            cache = cache_from_jax(_unflat(pre, f"{mode}/"), device="cpu",
                                   dtype=torch.bfloat16, shard=rank,
                                   num_shards=4)
            for i in range(dd["steps"]):
                logits, cache, heat = decode_step(
                    params, cfg, cache, t["d_steps"][i][rows2],
                    (prompts + i)[rows2], t[f"d_tbl_{mode}"][rows2], layout,
                    attn_impl=mode,
                    sharded_table=t[f"d_sh_{mode}"][rows2, slot],
                    sharded_logical=t[f"d_sl_{mode}"][rows2, slot])
                r[f"dec/{mode}/logits{i}"] = logits
                r[f"dec/{mode}/heat{i}"] = heat
            for k, v in _leaf_items(cache):
                r[f"dec/{mode}/cache/{k}"] = v
        fd.set_decode_mesh(None)
    dist.barrier()
    _save(out / f"rank{rank}.npz", {k: _np(v) for k, v in r.items()})
    dist.destroy_process_group()


def _leaf_items(cache, prefix=""):
    for k, v in cache.items():
        if isinstance(v, dict):
            yield from _leaf_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy() if v.dtype == torch.bfloat16 \
            else v.detach().numpy()
    return np.asarray(v)


def _ranks_main(out: Path) -> None:
    import torch.multiprocessing as mp
    mp.start_processes(_rank_worker, args=(WORLD, out), nprocs=WORLD,
                       start_method="spawn")


# ---------------------------------------------------------------------------
# Both sides at once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("distributed")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        make_inputs(out)
    finally:
        torch.set_num_threads(n)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), str(HERE),
                                         env.get("PYTHONPATH", "")])
    ref_env = dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        env.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
        + " --xla_allow_excess_precision=false").strip())
    procs = []
    for what, e in (("reference", ref_env), ("ranks", env)):
        log = open(out / f"{what}.log", "w")
        procs.append((what, log, subprocess.Popen(
            [sys.executable, __file__, what, str(out)], env=e,
            stdout=log, stderr=subprocess.STDOUT)))
    for what, log, proc in procs:
        proc.wait(timeout=600)
        log.close()
        assert proc.returncode == 0, \
            f"{what}:\n" + (out / f"{what}.log").read_text()[-4000:]
    return (_load(out / "reference.npz"),
            [_load(out / f"rank{r}.npz") for r in range(WORLD)], out)


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_partials_plain_matches_reference_partials(runs):
    from repro_torch.kernels.paged_attention.ops import \
        paged_decode_partials_plain
    ref, _, out = runs
    x = _load(out / "inputs.npz")
    got = paged_decode_partials_plain(
        *(torch.from_numpy(x[k]) for k in ("p_q", "p_pk", "p_pv", "p_table",
                                           "p_lengths")),
        block_tokens=4, logical=torch.from_numpy(x["p_logical"]), window=7,
        soft_cap=15.0)
    for name, g in zip(("m", "l", "acc", "heat"), got):
        _close(g.numpy(), ref[f"p/{name}"], 2e-5, name)
    assert (got[0][2] == -1e30).all() and not got[3][2].any()


@pytest.mark.parametrize("case", ["g", "k", "m"])
def test_sharded_decode_matches_reference(runs, case):
    """g: GQA batch-sharded on 2 x 4; k: GQA block-sharded over all 8
    ranks (window 5, soft cap 20); m: MLA batch-sharded on 2 x 4."""
    ref, ranks, _ = runs
    for rank, r in enumerate(ranks):
        d, m = rank // 4, rank % 4
        rows = slice(None) if case == "k" else slice(2 * d, 2 * d + 2)
        slot = rank if case == "k" else m
        mbl = r[f"{case}/heat"].shape[1]
        _close(r[f"{case}/out"], ref[f"{case}/out"][rows], 2e-5,
               f"rank {rank} out")
        _close(r[f"{case}/heat"],
               ref[f"{case}/heat"][rows, slot * mbl:(slot + 1) * mbl], 2e-5,
               f"rank {rank} heat")


@pytest.mark.parametrize("mode", MODES)
def test_decode_step_sharded_matches_reference(runs, mode):
    """deepseek-7b smoke on 2 x 2, bf16, 3 steps from the reference's
    prefilled pools: each rank's logits rows, its heat columns and its
    pool rows."""
    ref, ranks, _ = runs
    mbl = DECODE["MB"] // (2 if mode == "flashdecode" else 4)
    nb_loc = DECODE["NB"] // 4
    for rank, r in enumerate(ranks[:4]):
        d2, m2 = rank // 2, rank % 2
        bsh = mode == "flashdecode"
        rows = slice(2 * d2, 2 * d2 + 2) if bsh else slice(None)
        slot = m2 if bsh else rank
        for i in range(DECODE["steps"]):
            want = ref[f"dec/{mode}/logits{i}"][rows]
            _close(r[f"dec/{mode}/logits{i}"], want, 2e-2,
                   f"rank {rank} step {i} logits")
            heat = ref[f"dec/{mode}/heat{i}"][rows,
                                              slot * mbl:(slot + 1) * mbl]
            assert _rel(r[f"dec/{mode}/heat{i}"], heat) < 1e-2
        pools = [k for k in r if k.startswith(f"dec/{mode}/cache/")
                 and k.rsplit("/", 1)[1] in ("pool_k", "pool_v")]
        assert len(pools) == 2
        for k in pools:
            want = ref[k]
            own = slice(rank * nb_loc, (rank + 1) * nb_loc)
            want = want[:, own] if want.ndim == 5 else want[own]
            np.testing.assert_array_equal(r[k], want, err_msg=k)


@pytest.mark.parametrize("tag,tol", [("e", 1e-4), ("eb", 2e-2)])
def test_moe_apply_ep_matches_reference(runs, tag, tol):
    ref, ranks, _ = runs
    for rank, r in enumerate(ranks):
        rows = slice(8 * (rank // 4), 8 * (rank // 4) + 8)
        _close(r[f"{tag}/out"], ref[f"{tag}/out"][rows], tol,
               f"rank {rank}")
        np.testing.assert_array_equal(r[f"{tag}/out_whole"], r[f"{tag}/out"])
        np.testing.assert_allclose(r[f"{tag}/aux"], ref[f"{tag}/aux"],
                                   rtol=0, atol=1e-6)


def test_moe_apply_chooses_ep_as_reference(runs):
    from repro_torch.models.moe import ep_applies

    class Stand:
        def __init__(self, shape, names):
            self.axis_names = names
            self.shape = dict(zip(names, shape))
    ref, _, _ = runs
    got = [ep_applies(None if shape is None else Stand(shape, names), E, T)
           for shape, names, E, T in CHOICES]
    assert got == ref["choice"].tolist()
    assert any(got) and not all(got)


def test_compressed_psum_mean_matches_reference(runs):
    ref, ranks, out = runs
    x = _load(out / "inputs.npz")
    exact = x["c_g"].mean(0)
    for rank, r in enumerate(ranks):
        assert _rel(r["c/mean"], ref["c/mean"]) < 1e-6
        np.testing.assert_array_equal(r["c/err"], ref["c/err"][rank])
        assert _rel(r["c/mean"], exact) < 0.02
        assert _rel(r["c/none"], exact) < 1e-6
        bf = x["c_g"].astype(np.float32)
        bf16 = torch.from_numpy(bf).bfloat16().float().numpy().mean(0)
        assert _rel(r["c/bf16"], bf16) < 1e-6
    # the tree form: each leaf its own compressed mean, with no feedback
    from repro_torch.distributed.compression import (compress_residual,
                                                     dequantize_int8)
    g = torch.from_numpy(x["c_g"])

    def mean_of(leaves):
        return torch.stack([dequantize_int8(*compress_residual(
            v, torch.zeros(v.shape))[:2]).reshape(v.shape)
            for v in leaves]).mean(0).numpy()
    for r in ranks:
        assert _rel(r["c/tree_a"], mean_of(g)) < 1e-6
        assert _rel(r["c/tree_b1"], mean_of(2 * g)) < 1e-6
    b0 = g[0][0]
    np.testing.assert_array_equal(
        ranks[0]["c/tree_err_b0"],
        compress_residual(b0, torch.zeros(b0.shape))[2].numpy())


def test_host_mesh_on_eight_ranks(runs):
    _, ranks, _ = runs
    for rank, r in enumerate(ranks):
        assert r["mesh/shape"].tolist() == [2, 4]
        assert r["mesh/coord"].tolist() == [rank // 4, rank % 4]
        assert bool(r["mesh/production_refused"])


def test_int8_quantization_bit_identical():
    import jax.numpy as jnp
    from repro.distributed import compression as ref
    from repro_torch.distributed import compression as port
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6, 48)).astype(np.float32)
    x[0] = np.r_[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, np.zeros(42)]  # halves
    x[1] = 0.0                                                     # amax 0
    err = (0.05 * rng.normal(size=x.shape)).astype(np.float32)
    q, s = port.quantize_int8(torch.from_numpy(x))
    rq, rs = ref.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert q[0, :6].tolist() == [127, 0, 2, 2, 0, -2]
    for shape in ((6, 48), (2, 3, 48), (48,)):
        xs, es = x.reshape(-1)[:np.prod(shape)].reshape(shape), \
            err.reshape(-1)[:np.prod(shape)].reshape(shape)
        got = port.compress_residual(torch.from_numpy(xs),
                                     torch.from_numpy(es))
        want = ref.compress_residual(jnp.asarray(xs), jnp.asarray(es))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(
            port.dequantize_int8(got[0], got[1]).numpy(),
            np.asarray(ref.dequantize_int8(want[0], want[1])))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_sharding_rules_match_reference(multi_pod):
    """spec_for / zero1_spec / batch_spec for every leaf of all ten archs'
    model_spec at (16, 16) and (2, 16, 16), on an abstract mesh."""
    import jax
    from jax.sharding import AbstractMesh
    from repro.configs.base import get_config as ref_config
    from repro.distributed import sharding as ref
    from repro.models.common import ParamSpec as RefSpec
    from repro.models.transformer import model_spec as ref_model_spec
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as port
    from repro_torch.models import model_spec
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = AbstractMesh(shape, names)
    assert port.batch_spec(mesh) == tuple(ref.batch_spec(mesh))
    n = 0
    for arch in ARCHS:
        leaves = jax.tree.leaves(ref_model_spec(ref_config(arch)),
                                 is_leaf=lambda v: isinstance(v, RefSpec))
        for leaf in leaves:
            for fn in ("spec_for", "zero1_spec"):
                want = tuple(getattr(ref, fn)(leaf.shape, leaf.axes, mesh))
                assert getattr(port, fn)(leaf.shape, leaf.axes, mesh) == \
                    want, (arch, fn, leaf.shape, leaf.axes)
            n += 1
        # the port's own (per-layer) leaves: trees of specs and placements
        spec = model_spec(get_config(arch))
        specs = port.specs_for_tree(spec, _axes_tree(spec), mesh)
        shard = port.shardings_for_tree(spec, _axes_tree(spec), mesh)
        emb = shard["embed"]
        assert emb.spec == specs["embed"] == ("model",)
        assert [str(p) for p in emb.placements] == \
            ["R"] * (len(names) - 1) + ["S(0)"]
    assert n > 300


def _axes_tree(spec):
    if isinstance(spec, dict):
        return {k: _axes_tree(v) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_axes_tree(v) for v in spec]
    return spec.axes


if __name__ == "__main__":
    {"reference": _reference_main, "ranks": _ranks_main}[sys.argv[1]](
        Path(sys.argv[2]))
