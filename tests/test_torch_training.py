"""The port's training slice against the reference, on the CPU: the
learning-rate schedule and AdamW, the synthetic data, the attention
backward, deepseek-7b smoke's loss and gradients, the train step with
microbatches, the checkpoint store and the fault-tolerant Trainer.

Tolerances: float32 results to 1e-6 relative (schedule, AdamW) or 1e-4 of
each gradient leaf's largest magnitude (the model, whose float32 sums run in
another order); bf16 compute to 2e-2 (``tests/test_kernels.py``'s bf16
tolerance); the data bit for bit.  The reference's bf16 runs (the loss and
gradients, and the Trainer's crash/restart run) go to a child process with
``--xla_allow_excess_precision=false``, as ``test_torch_engine``'s engine
runs do: without it XLA keeps bf16 intermediates in float32 and MoE routing
and gradients part by far more.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.data import pipeline as jax_pipeline
from repro.models import attention as jax_attention
from repro.models import lm_loss as jax_lm_loss
from repro.models import materialize as jax_materialize
from repro.models import model_spec as jax_model_spec
from repro.optim import adamw as jax_adamw
from repro.optim import schedule as jax_schedule
from repro.training.train_step import make_train_step as jax_make_train_step

from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import (opt_state_from_jax, params_from_jax,
                                 params_to_numpy)
from repro_torch.data import make_batch_iter, synthetic_batch
from repro_torch.distributed import SimulatedFailure
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import lm_loss
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               cosine_schedule, linear_warmup_cosine)
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.training import Trainer, TrainerConfig, make_train_step

from test_torch_engine import _converted_params
from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

F32, BF16 = torch.float32, torch.bfloat16
ARCH = "deepseek_7b"
TRAINER = dict(num_steps=30, checkpoint_every=10, log_every=5, base_lr=1e-3,
               chunk=16)


def flat(tree, prefix="") -> dict:
    """{"a/b/c": array} of a nested dict of arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def assert_grads_close(ref: dict, port_grads, tol: float) -> None:
    """Every leaf of the port's gradient tree (in the reference's layout)
    within ``tol`` of the reference's largest magnitude in that leaf."""
    got = flat(params_to_numpy(port_grads))
    assert sorted(got) == sorted(ref)
    worst = {}
    for key, want in ref.items():
        assert got[key].shape == want.shape, key
        scale = max(float(np.abs(want).max()), 1e-30)
        worst[key] = float(np.abs(got[key] - want).max()) / scale
    bad = {k: e for k, e in worst.items() if not e <= tol}
    assert not bad, bad


def loss_and_grads(params, cfg, batch, **kw):
    """(loss, parts, grads) of the port's ``lm_loss``."""
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss, parts = lm_loss(p, cfg, batch, **kw)
    grads = iter(torch.autograd.grad(loss, tree_leaves(p), allow_unused=True,
                                     materialize_grads=True))
    return loss, parts, tree_map(lambda _: next(grads), p)


# ---------------------------------------------------------------------------
# The reference's bf16 side, in a child process
# ---------------------------------------------------------------------------

def _reference_main(out_dir: str) -> None:
    """Child-process entry: deepseek-7b smoke's params, its bf16 loss and
    gradients on batch 0, and the reference Trainer's crash/restart run
    (a failure at step 12) with its logged metrics."""
    from repro.checkpoint.store import CheckpointStore as JaxStore
    from repro.distributed.fault import SimulatedFailure as JaxFailure
    from repro.training.trainer import Trainer as JaxTrainer
    from repro.training.trainer import TrainerConfig as JaxTrainerConfig
    out = Path(out_dir)
    cfg = jax_smoke_config(ARCH)
    params = jax_materialize(jax.random.PRNGKey(0), jax_model_spec(cfg))
    np.savez(out / f"params-{ARCH}.npz", **flat(params))
    batch = jax_pipeline.synthetic_batch(cfg, 2, 32, 0)
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_lm_loss(p, cfg, b, compute_dtype=jnp.bfloat16,
                                 chunk=16), has_aux=True))(params, batch)
    np.savez(out / "grads-bf16.npz", **flat(grads))
    crash = {"armed": True}

    def failure_hook(step):
        if step == 12 and crash["armed"]:
            crash["armed"] = False
            raise JaxFailure()
    run = JaxTrainer(JaxTrainerConfig(**TRAINER), cfg, params,
                     jax_pipeline.make_batch_iter(cfg, batch=8, seq_len=32),
                     JaxStore(out / "ckpt"), failure_hook=failure_hook).run()
    (out / "reference.json").write_text(json.dumps({
        "loss": float(loss), "parts": {k: float(v) for k, v in parts.items()},
        "trainer": {"final_step": run["final_step"],
                    "restarts": run["restarts"],
                    "metrics": [{k: m[k] for k in ("step", "loss",
                                                   "grad_norm", "lr")}
                                for m in run["metrics"]]}}))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("reference")
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false"
                        + " --xla_cpu_multi_thread_eigen=false").strip()
    env["JAX_PLATFORMS"] = "cpu"
    here = Path(__file__).resolve().parent
    env["PYTHONPATH"] = os.pathsep.join(
        [str(here.parent / "src"), str(here), env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = json.loads((out / "reference.json").read_text())
    with np.load(out / "grads-bf16.npz") as z:
        ref["grads_bf16"] = {k: z[k] for k in z.files}
    ref["params"] = out / f"params-{ARCH}.npz"
    return ref


def port_params(reference):
    """A fresh conversion of the reference's smoke params (the port's
    train step updates its params in place)."""
    return _converted_params(reference["params"])


# ---------------------------------------------------------------------------
# Schedule and AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 17, 29, 30, 45])
def test_schedule_matches_reference(step):
    kw = dict(base_lr=1e-3, warmup_steps=10, total_steps=30)
    want = jax_schedule.linear_warmup_cosine(jnp.int32(step), **kw)
    got = linear_warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
    assert got.dtype == F32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    want = jax_schedule.cosine_schedule(jnp.int32(step), base_lr=3e-4,
                                        total_steps=30, final_frac=0.2)
    got = cosine_schedule(torch.tensor(step, dtype=torch.int32), base_lr=3e-4,
                          total_steps=30, final_frac=0.2)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("clip_norm", [1.0, None], ids=["clip", "noclip"])
def test_adamw_update_matches_reference(clip_norm):
    rng = np.random.default_rng(3)
    shapes = {"w": (6, 5), "blocks": {"b": (7,), "c": (2, 3, 4)}}

    def draw(scale):
        return jax.tree.map(lambda s: (rng.normal(size=s) * scale)
                            .astype(np.float32), shapes,
                            is_leaf=lambda x: isinstance(x, tuple))
    params = draw(1.0)
    ref_p, ref_s = params, jax_adamw.adamw_init(params)
    port_p = params_from_jax(params, device="cpu")
    port_s = adamw_init(port_p)
    for step in range(3):
        grads = draw(2.0)                      # global norm well above 1
        lr = jax_schedule.linear_warmup_cosine(ref_s.step, base_lr=1e-2,
                                               warmup_steps=2, total_steps=10)
        ref_p, ref_s, ref_m = jax_adamw.adamw_update(
            ref_p, grads, ref_s, lr=lr, clip_norm=clip_norm)
        port_lr = linear_warmup_cosine(port_s.step, base_lr=1e-2,
                                       warmup_steps=2, total_steps=10)
        port_p, port_s, port_m = adamw_update(
            port_p, params_from_jax(grads, device="cpu"), port_s,
            lr=port_lr, clip_norm=clip_norm)
        assert int(port_s.step) == int(ref_s.step) == step + 1
        np.testing.assert_allclose(port_m["grad_norm"].item(),
                                   float(ref_m["grad_norm"]), rtol=1e-6)
        for want, got in ((ref_p, port_p), (ref_s.mu, port_s.mu),
                          (ref_s.nu, port_s.nu)):
            got = flat(params_to_numpy(got))
            for key, w in flat(want).items():
                np.testing.assert_allclose(got[key], w, rtol=2e-6,
                                           atol=1e-7, err_msg=key)


def test_opt_state_from_jax_round_trip():
    cfg = jax_smoke_config(ARCH)
    params = jax_materialize(jax.random.PRNGKey(1), jax_model_spec(cfg))
    state = jax_adamw.adamw_init(params)
    state = state._replace(step=jnp.int32(7), mu=jax.tree.map(
        lambda x: x + 1, state.mu))
    port = opt_state_from_jax(state, device="cpu")
    assert isinstance(port, AdamWState) and int(port.step) == 7
    assert port.step.dtype == torch.int32
    for want, got in ((state.mu, port.mu), (state.nu, port.nu)):
        got = flat(params_to_numpy(got))
        for key, w in flat(want).items():
            np.testing.assert_array_equal(got[key], w, err_msg=key)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek_7b", "whisper_medium",
                                  "qwen2_vl_7b"])
def test_synthetic_batch_bit_identical(arch):
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    for step in (0, 3):
        want = jax_pipeline.synthetic_batch(jcfg, 3, 24, step, seed=5)
        got = synthetic_batch(cfg, 3, 24, step, seed=5, device="cpu")
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            w = np.asarray(w)
            assert got[k].numpy().dtype == w.dtype, k
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    it, jit_ = (make_batch_iter(cfg, 2, 16, device="cpu"),
                jax_pipeline.make_batch_iter(jcfg, 2, 16))
    for _ in range(2):
        np.testing.assert_array_equal(next(it)["tokens"].numpy(),
                                      np.asarray(next(jit_)["tokens"]))


# ---------------------------------------------------------------------------
# The attention backward
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, KVH, D, Dv, causal, window, soft cap)
BWD_CASES = {
    "causal": (2, 40, 40, 4, 4, 16, 16, True, None, None),
    "window": (1, 48, 48, 4, 2, 16, 16, True, 9, None),
    "gqa": (2, 33, 33, 6, 2, 8, 8, True, None, None),
    "dv_lt_d": (1, 36, 36, 4, 4, 24, 16, True, None, None),
    "noncausal_sq_ne_sk": (2, 20, 45, 4, 2, 16, 16, False, None, None),
    "soft_cap": (1, 30, 30, 2, 1, 16, 16, True, None, 5.0),
}


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_bwd_plain_matches_autograd_and_reference(case):
    B, Sq, Sk, H, KVH, D, Dv, causal, window, cap = BWD_CASES[case]
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((B, Sq, H, D), (B, Sk, KVH, D), (B, Sk, KVH, Dv)))
    do = rng.normal(size=(B, Sq, H, Dv)).astype(np.float32)
    kw = dict(causal=causal, window=window, soft_cap=cap, chunk=16)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = fa.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, out, torch.from_numpy(do),
                                       lse, **kw)
    # autograd of the plain forward
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    want = torch.autograd.grad(fa.flash_attention_plain(*leaves, **kw),
                               leaves, torch.from_numpy(do))
    # the reference's jnp attention, differentiated by jax.vjp
    ref_out, vjp = jax.vjp(lambda a, b, c: jax_attention.flash_attention(
        a, b, c, causal=causal, window=window, chunk=16, soft_cap=cap),
        q, k, v)
    ref = vjp(jnp.asarray(do))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=2e-6)
    for g, w, r in zip(got, want, ref):
        scale = float(np.abs(np.asarray(r)).max())
        assert float((g - w).abs().max()) <= 1e-5 * scale
        assert float(np.abs(g.numpy() - np.asarray(r)).max()) <= 1e-5 * scale
    # the wrapper takes the same path when an input requires grad
    routed = fa.flash_attention(*leaves, **kw)
    assert routed.grad_fn is not None
    for g, w in zip(torch.autograd.grad(routed, leaves, torch.from_numpy(do)),
                    got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_flash_grad_with_q_offset_raises():
    q = torch.zeros(1, 4, 2, 8, requires_grad=True)
    k = v = torch.zeros(1, 8, 2, 8)
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention(q, k, v, q_offset=4)
    with torch.no_grad():                  # no grad: the serving path
        assert fa.flash_attention(q, k, v, q_offset=4).shape == (1, 4, 2, 8)


# ---------------------------------------------------------------------------
# The model's loss and gradients
# ---------------------------------------------------------------------------

def check_loss_and_grads_f32(arch: str) -> None:
    """``arch``'s smoke ``lm_loss`` (ce, z-loss, aux) and every gradient
    leaf against ``jax.value_and_grad`` of the reference at float32
    compute, on batch 0 of the synthetic data (2 x 32 tokens)."""
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    params = jax_materialize(jax.random.PRNGKey(0), jax_model_spec(jcfg))
    batch = jax_pipeline.synthetic_batch(jcfg, 2, 32, 0)
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_lm_loss(p, jcfg, b, compute_dtype=jnp.float32,
                                 chunk=16), has_aux=True))(params, batch)
    port = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    got, got_parts, got_grads = loss_and_grads(
        port, cfg, synthetic_batch(cfg, 2, 32, 0, device="cpu"),
        compute_dtype=F32, chunk=16)
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    for k in ("ce", "z_loss", "aux"):
        np.testing.assert_allclose(got_parts[k].item(), float(parts[k]),
                                   rtol=1e-5, atol=1e-7)
    assert_grads_close(flat(grads), got_grads, 1e-4)


def test_lm_loss_and_grads_match_reference_f32():
    check_loss_and_grads_f32(ARCH)


def test_lm_loss_and_grads_match_reference_bf16(reference):
    cfg = get_smoke_config(ARCH)
    got, _, got_grads = loss_and_grads(
        port_params(reference), cfg,
        synthetic_batch(cfg, 2, 32, 0, device="cpu"), compute_dtype=BF16,
        chunk=16)
    np.testing.assert_allclose(got.item(), reference["loss"], rtol=2e-3)
    assert_grads_close(reference["grads_bf16"], got_grads, 2e-2)


def test_remat_changes_nothing():
    cfg = get_smoke_config(ARCH)
    params = params_from_jax(jax.tree.map(np.asarray, jax_materialize(
        jax.random.PRNGKey(0), jax_model_spec(jax_smoke_config(ARCH)))),
        device="cpu")
    batch = synthetic_batch(cfg, 2, 16, 1, device="cpu")
    a = loss_and_grads(params, cfg, batch, compute_dtype=F32, chunk=8)
    b = loss_and_grads(params, cfg, batch, compute_dtype=F32, chunk=8,
                       remat=False)
    assert a[0].item() == b[0].item()
    for x, y in zip(tree_leaves(a[2]), tree_leaves(b[2])):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_train_step_microbatches_match_reference():
    """make_train_step with num_micro=2 over 3 steps (float32 compute)."""
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    params = jax_materialize(jax.random.PRNGKey(2), jax_model_spec(jcfg))
    kw = dict(num_micro=2, base_lr=1e-3, warmup_steps=1, total_steps=3,
              chunk=16)
    ref_step = jax.jit(jax_make_train_step(jcfg, compute_dtype=jnp.float32,
                                           **kw))
    port_step = make_train_step(cfg, compute_dtype=F32, **kw)
    ref_p, ref_s = params, jax_adamw.adamw_init(params)
    port_p = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    port_s = adamw_init(port_p)
    for step in range(3):
        ref_p, ref_s, ref_m = ref_step(
            ref_p, ref_s, jax_pipeline.synthetic_batch(jcfg, 4, 16, step))
        port_p, port_s, port_m = port_step(
            port_p, port_s, synthetic_batch(cfg, 4, 16, step, device="cpu"))
        for k in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(port_m[k].item(), float(ref_m[k]),
                                       rtol=1e-5, err_msg=k)
    assert int(port_s.step) == 3
    got = flat(params_to_numpy(port_p))
    for key, want in flat(ref_p).items():
        np.testing.assert_allclose(got[key], want, rtol=1e-4, atol=1e-6,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _tree():
    return {"params": {"a": torch.arange(10, dtype=F32),
                       "s": [{"w": torch.ones(2, 3)},
                             {"w": torch.zeros(2, 3)}],
                       "h": torch.tensor([1.5, -2.25], dtype=BF16)},
            "opt": AdamWState(step=torch.tensor(4, dtype=torch.int32),
                              mu={"x": torch.full((3,), 0.5)},
                              nu={"x": torch.full((3,), 0.25)})}


def _assert_same_tree(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    else:
        assert a.dtype == b.dtype and a.device == b.device
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_checkpoint_round_trip_and_gc(tmp_path):
    store = CheckpointStore(tmp_path, num_shards=3)
    tree = _tree()
    for step in (5, 10, 15, 20):
        store.save(tree, step=step, keep=2)
    assert store.all_steps() == [15, 20]
    path = tmp_path / "step_000000020"
    assert sorted(p.name for p in path.iterdir()) == [
        "_COMMITTED", "manifest.json", "shard_0.npz", "shard_1.npz",
        "shard_2.npz"]
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["step"] == 20 and manifest["num_leaves"] == 7
    got, meta = store.restore(20, device="cpu")
    assert meta == {"step": 20}
    _assert_same_tree(tree, got)
    # a fresh store needs the structure
    fresh = CheckpointStore(tmp_path)
    with pytest.raises(ValueError, match="like"):
        fresh.restore(20, device="cpu")
    _assert_same_tree(tree, fresh.restore(15, like=tree, device="cpu")[0])


def test_checkpoint_uncommitted_and_async(tmp_path):
    store = CheckpointStore(tmp_path)
    tree = {"a": torch.arange(4)}
    store.save(tree, step=1)
    bad = tmp_path / "step_000000099"      # a crash mid-write: no marker
    bad.mkdir()
    (bad / "manifest.json").write_text("{}")
    assert store.latest_step() == 1
    with pytest.raises(FileNotFoundError):
        store.restore(99, device="cpu")
    store.save({"a": torch.arange(100)}, step=7, blocking=False)
    store.wait()
    assert store.all_steps() == [1, 7]
    np.testing.assert_array_equal(
        store.restore(7, device="cpu")[0]["a"].numpy(), np.arange(100))


# ---------------------------------------------------------------------------
# The Trainer
# ---------------------------------------------------------------------------

def test_trainer_crash_restart_matches_reference(reference, tmp_path):
    cfg = get_smoke_config(ARCH)
    crash = {"armed": True}

    def failure_hook(step):
        if step == 12 and crash["armed"]:
            crash["armed"] = False
            raise SimulatedFailure()
    out = Trainer(TrainerConfig(**TRAINER), cfg, port_params(reference),
                  make_batch_iter(cfg, batch=8, seq_len=32, device="cpu"),
                  CheckpointStore(tmp_path),
                  failure_hook=failure_hook).run()
    ref = reference["trainer"]
    assert out["restarts"] == ref["restarts"] == 1
    assert out["final_step"] == ref["final_step"] == 30
    losses = [m["loss"] for m in out["metrics"]]
    assert losses[-1] < losses[0] - 0.2, losses
    # steps 0, 5, 10, then 10 again after the restore from step 10 (on the
    # batches that come next: the data iterator is not rewound), 15, ...
    assert [m["step"] for m in out["metrics"]] == \
        [m["step"] for m in ref["metrics"]]
    for m, r in zip(out["metrics"], ref["metrics"]):
        np.testing.assert_allclose(m["loss"], r["loss"], rtol=2e-2)
        np.testing.assert_allclose(m["lr"], r["lr"], rtol=1e-6)
        np.testing.assert_allclose(m["grad_norm"], r["grad_norm"], rtol=0.1)


def test_trainer_resume_from_checkpoint(tmp_path):
    arch = "mamba2_1p3b"
    cfg = get_smoke_config(arch)

    def fresh():
        return params_from_jax(jax.tree.map(np.asarray, jax_materialize(
            jax.random.PRNGKey(0), jax_model_spec(jax_smoke_config(arch)))),
            device="cpu")
    data = make_batch_iter(cfg, batch=4, seq_len=16, device="cpu")
    store = CheckpointStore(tmp_path)
    t1 = Trainer(TrainerConfig(num_steps=10, checkpoint_every=5, chunk=8),
                 cfg, fresh(), data, store)
    t1.run()
    # a new trainer on the same directory resumes at step 10
    t2 = Trainer(TrainerConfig(num_steps=15, checkpoint_every=5, chunk=8),
                 cfg, fresh(), data, CheckpointStore(tmp_path))
    assert t2.start_step == 10
    _assert_same_tree(t1.state, t2.state)
    out = t2.run()
    assert out["final_step"] == 15
    assert store.all_steps() == [5, 10, 15]


# ---------------------------------------------------------------------------
# The CPU-only guard
# ---------------------------------------------------------------------------

def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    cfg = get_smoke_config(ARCH)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        synthetic_batch(cfg, 2, 8, 0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_batch_iter(cfg, 2, 8)
    store = CheckpointStore(tmp_path)
    store.save({"a": torch.ones(2)}, step=1)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        store.restore(1)
    assert synthetic_batch(cfg, 2, 8, 0, device="cpu")["tokens"].device \
        == torch.device("cpu")


if __name__ == "__main__":
    _reference_main(sys.argv[1])
