"""The port's dry-run cells (``repro_torch.launch.specs``) held exactly to
the reference's (``repro.launch.specs``) on all 10 archs x 4 shapes x 2
production meshes (80 cells): every argument leaf's shape and dtype, the
in and out shardings as spec tuples, the paged layout, the meta dict, the
skip set with its reasons, and ``arg_bytes_per_device`` to the byte.

The reference's side needs 512 devices, so it runs in ONE child process
with 512 forced host devices: it builds every cell with ``make_cell`` and
``arg_bytes_per_device`` (no lowering, no compile) and writes JSON.  The
port's side builds its cells on a fake 256- or 512-rank world
(:func:`repro_torch.launch.fakeworld.fake_world`), closed after each mesh.
The port keeps a scan segment's params as a list with one subtree per
repetition where the reference stacks them on a leading ``[reps, ...]``
axis; the comparison stacks the port's lists (shape ``(reps,) + shape``,
spec ``(None,) + spec``, the reference's rule for the unsharded "layers"
axis).

Single-process cases: ``cache_spec``, ``batch_specs_for``, ``abstract``,
``logical_axes`` and ``param_count`` against the reference's on all ten
archs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
ARCHS = ("nemotron_4_15b", "deepseek_7b", "phi3_mini_3p8b", "gemma3_27b",
         "deepseek_moe_16b", "deepseek_v2_lite_16b", "qwen2_vl_7b",
         "jamba_v0_1_52b", "whisper_medium", "mamba2_1p3b")
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = ("single", "multi")


def _attn(shape_name: str) -> str:
    # decode cells with the sharded tables: flashdecode, and the reference's
    # fallback to block-sharded for a batch of one
    return {"decode_32k": "flashdecode",
            "long_500k": "flashdecode_blocksharded"}.get(shape_name, "gather")


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


# ---------------------------------------------------------------------------
# The reference's side (child process, 512 host devices)
# ---------------------------------------------------------------------------

def _ref_key(entry) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    return str(entry)


def _reference_main(out: Path) -> None:
    import dataclasses

    import jax
    from repro.configs.base import SHAPES, get_config, supports_shape
    from repro.launch.dryrun import arg_bytes_per_device
    from repro.launch.mesh import make_production_mesh
    from repro.launch.specs import make_cell

    def flat(tree, leaf):
        paths = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: hasattr(x, "spec"))[0]
        return {"/".join(_ref_key(e) for e in p): leaf(v) for p, v in paths}

    res = {}
    meshes = {m: make_production_mesh(multi_pod=(m == "multi"))
              for m in MESHES}
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape_name in SHAPE_NAMES:
            shape = SHAPES[shape_name]
            ok, reason = supports_shape(cfg, shape)
            for mesh_name, mesh in meshes.items():
                tag = f"{arch}.{shape_name}.{mesh_name}"
                if not ok:
                    res[tag] = {"skipped": reason}
                    continue
                cell = make_cell(cfg, shape, mesh, attn_impl=_attn(shape_name))
                res[tag] = {
                    "kind": cell.kind,
                    "args": flat(cell.args, lambda s: [list(s.shape),
                                                       str(s.dtype)]),
                    "in": flat(cell.in_shardings,
                               lambda s: _jsonable(tuple(s.spec))),
                    "out": flat(cell.out_shardings,
                                lambda s: _jsonable(tuple(s.spec))),
                    "layout": None if cell.layout is None
                    else dataclasses.asdict(cell.layout),
                    "meta": _jsonable(cell.meta),
                    "arg_bytes": int(arg_bytes_per_device(cell, mesh)),
                }
    (out / "reference.json").write_text(json.dumps(res))


# ---------------------------------------------------------------------------
# The port's side, in the reference's tree structure
# ---------------------------------------------------------------------------

def _port_flat(tree, leaf, prefix="") -> dict:
    """Flatten a port tree to the reference's paths: dicts by key, tuples
    and NamedTuples by index or field name, and a list of subtrees (a scan
    segment's repetitions) stacked into one subtree whose leaves are
    ``[leaf(x) for x in reps]``."""
    from repro_torch.optim.adamw import AdamWState
    sep = "/" if prefix else ""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, leaf, f"{prefix}{sep}{k}"))
        return out
    if isinstance(tree, AdamWState):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(_port_flat(v, leaf, f"{prefix}{sep}{k}"))
        return out
    if isinstance(tree, tuple):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_flat(v, leaf, f"{prefix}{sep}{i}"))
        return out
    if isinstance(tree, list):
        reps = [_port_flat(v, leaf, prefix) for v in tree]
        return {k: ("stack", [r[k] for r in reps]) for k in reps[0]}
    return {prefix: leaf(tree)}


def _stack_shape(v):
    if isinstance(v, tuple) and v[0] == "stack":
        shapes = [_stack_shape(x) for x in v[1]]
        assert all(s == shapes[0] for s in shapes)
        return [[len(shapes)] + shapes[0][0], shapes[0][1]]
    return v


def _stack_spec(v):
    if isinstance(v, tuple) and v[0] == "stack":
        specs = [_stack_spec(x) for x in v[1]]
        assert all(s == specs[0] for s in specs)
        return [None] + specs[0] if specs[0] else []
    return v


def _port_cells() -> dict:
    import dataclasses

    from repro_torch.configs.base import SHAPES, get_config, supports_shape
    from repro_torch.launch.dryrun import arg_bytes_per_device
    from repro_torch.launch.fakeworld import fake_world
    from repro_torch.launch.specs import make_cell

    res = {}
    for mesh_name in MESHES:
        with fake_world(multi_pod=(mesh_name == "multi")) as mesh:
            for arch in ARCHS:
                cfg = get_config(arch)
                for shape_name in SHAPE_NAMES:
                    shape = SHAPES[shape_name]
                    ok, reason = supports_shape(cfg, shape)
                    tag = f"{arch}.{shape_name}.{mesh_name}"
                    if not ok:
                        res[tag] = {"skipped": reason}
                        continue
                    cell = make_cell(cfg, shape, mesh,
                                     attn_impl=_attn(shape_name))
                    args = _port_flat(cell.args, lambda t: [
                        list(t.shape), str(t.dtype).replace("torch.", "")])
                    ins = _port_flat(cell.in_shardings,
                                     lambda s: _jsonable(s.spec))
                    outs = _port_flat(cell.out_shardings,
                                      lambda s: _jsonable(s.spec))
                    res[tag] = {
                        "kind": cell.kind,
                        "args": {k: _stack_shape(v) for k, v in args.items()},
                        "in": {k: _stack_spec(v) for k, v in ins.items()},
                        "out": {k: _stack_spec(v) for k, v in outs.items()},
                        "layout": None if cell.layout is None
                        else dataclasses.asdict(cell.layout),
                        "meta": _jsonable(cell.meta),
                        "arg_bytes": arg_bytes_per_device(cell, mesh),
                    }
    return res


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("specs")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), str(HERE),
                                         env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=512"
                        ).strip()
    log = open(out / "reference.log", "w")
    proc = subprocess.Popen([sys.executable, __file__, str(out)], env=env,
                            stdout=log, stderr=subprocess.STDOUT)
    try:
        port = _port_cells()
    finally:
        proc.wait(timeout=600)
        log.close()
    assert proc.returncode == 0, (out / "reference.log").read_text()[-4000:]
    return json.loads((out / "reference.json").read_text()), port


def test_eighty_cells_and_the_skip_set(cells):
    ref, port = cells
    assert len(ref) == len(port) == 80
    assert sorted(ref) == sorted(port)
    skipped = {k: v["skipped"] for k, v in ref.items() if "skipped" in v}
    assert skipped == {k: v["skipped"] for k, v in port.items()
                       if "skipped" in v}
    assert len(skipped) == 14       # 7 full-attention archs x 2 meshes


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_equal_the_reference(cells, arch):
    """Shapes, dtypes, in/out specs, layout, meta and per-device argument
    bytes of every cell of ``arch``, on both meshes."""
    ref, port = cells
    for tag in sorted(k for k in ref if k.startswith(arch + ".")):
        r, p = ref[tag], port[tag]
        if "skipped" in r:
            assert p == r, tag
            continue
        assert p["kind"] == r["kind"], tag
        assert p["args"] == r["args"], tag
        assert p["in"] == r["in"], tag
        assert p["out"] == r["out"], tag
        assert p["layout"] == r["layout"], tag
        assert p["meta"] == r["meta"], tag
        assert p["arg_bytes"] == r["arg_bytes"], tag


# ---------------------------------------------------------------------------
# Shape-only helpers against the reference's, in this process
# ---------------------------------------------------------------------------

def _ref_tree(tree) -> dict:
    import jax
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(_ref_key(e) for e in p): v for p, v in paths}


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_helpers_match_reference(arch):
    """``abstract``, ``logical_axes``, ``param_count``, ``cache_spec`` and
    ``batch_specs_for`` of the full config, shape for shape and dtype for
    dtype."""
    import jax
    from repro.configs.base import get_config as ref_config
    from repro.data.pipeline import batch_specs_for as ref_batch
    from repro.models import common as rc
    from repro.models.decode import PagedLayout as RefLayout
    from repro.models.decode import cache_spec as ref_cache
    from repro.models.transformer import model_spec as ref_model_spec
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import batch_specs_for
    from repro_torch.models import common as pc
    from repro_torch.models.decode import PagedLayout, cache_spec
    from repro_torch.models.transformer import model_spec

    rspec, pspec = ref_model_spec(ref_config(arch)), model_spec(
        get_config(arch))
    assert pc.param_count(pspec) == rc.param_count(rspec)

    def dt(x):
        return str(x.dtype).replace("torch.", "")
    want = {k: [list(v.shape), str(v.dtype)]
            for k, v in _ref_tree(rc.abstract(rspec)).items()}
    got = _port_flat(pc.abstract(pspec), lambda t: [list(t.shape), dt(t)])
    assert {k: _stack_shape(v) for k, v in got.items()} == want
    assert all(t.is_meta for t in _leaves(pc.abstract(pspec)))
    want_axes = {
        "/".join(_ref_key(e) for e in p): list(v)
        for p, v in jax.tree_util.tree_flatten_with_path(
            rc.logical_axes(rspec), is_leaf=lambda x: isinstance(x, tuple))[0]}
    got_axes = _port_flat(_axes_as_lists(pc.logical_axes(pspec)),
                          lambda a: a.names)
    assert sorted(got_axes) == sorted(want_axes)
    for k, v in got_axes.items():
        if isinstance(v, tuple):        # stacked: "layers" leads
            assert all(x == v[1][0] for x in v[1])
            v = ["layers"] + v[1][0]
        assert v == want_axes[k], k

    layout_args = dict(num_blocks=64, block_tokens=16, max_blocks=8)
    for dtype_pair in (("bfloat16", torch.bfloat16),
                       ("float32", torch.float32)):
        import jax.numpy as jnp
        want = {k: [list(v.shape), str(v.dtype)] for k, v in _ref_tree(
            ref_cache(ref_config(arch), RefLayout(**layout_args), 3,
                      getattr(jnp, dtype_pair[0]))).items()}
        got = {k: [list(v.shape), dt(v)] for k, v in _port_flat(
            cache_spec(get_config(arch), PagedLayout(**layout_args), 3,
                       dtype_pair[1]), lambda t: t).items()}
        assert got == want
    for train in (True, False):
        want = {k: [list(v.shape), str(v.dtype)]
                for k, v in ref_batch(ref_config(arch), 4, 64,
                                      train=train).items()}
        got = {k: [list(v.shape), dt(v)]
               for k, v in batch_specs_for(get_config(arch), 4, 64,
                                           train=train).items()}
        assert got == want


def _axes_as_lists(tree):
    """A port axes tree with each leaf's tuple of names as a list in a
    holder, so :func:`_port_flat` keeps it whole."""
    if isinstance(tree, dict):
        return {k: _axes_as_lists(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_axes_as_lists(v) for v in tree]
    return _Axes(list(tree))


class _Axes:
    def __init__(self, names):
        self.names = names


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


if __name__ == "__main__":
    _reference_main(Path(sys.argv[1]))
