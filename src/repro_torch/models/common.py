"""Parameter-spec machinery and numeric helpers shared by the model code.

The PyTorch counterpart of ``repro.models.common``: a *spec* (nested dict of
:class:`ParamSpec`) describes every weight's shape, init and logical axes,
and :func:`materialize` draws real tensors for it from an explicit
``torch.Generator`` on an explicit device.  The draws differ from
``jax.random`` for the same seed, so tests that compare against the JAX
package convert its materialized arrays (:mod:`repro_torch.convert`)
instead of re-drawing.

Weights keep the JAX layout (``x @ w`` with ``w`` as ``[d_in, d_out]``).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

Pytree = Any

F32 = torch.float32
BF16 = torch.bfloat16


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in x's dtype.  On the CPU a bf16 product runs as one
    float32 product rounded once to bf16 — how XLA's CPU backend computes
    the reference's bf16 dots; PyTorch's own CPU bf16 kernel rounds some
    elements differently at prefill sizes, enough to flip a greedy token at
    a near-tie.  On the GPU the product stays a bf16 GEMM with float32
    accumulation, and so does a shape-only ``meta`` trace of it."""
    w = w.to(x.dtype)
    if x.dtype == BF16 and x.is_cpu:
        return (x.float() @ w.float()).to(BF16)
    return x @ w


def split_heads(x: torch.Tensor, heads: int, dim: int) -> torch.Tensor:
    """``x`` [..., heads * dim] -> [..., heads, dim].  A DTensor whose last
    dim splits over mesh axes that ``heads`` does not divide by is first
    gathered on those axes (DTensor does not unflatten an uneven split)."""
    if isinstance(x, DTensor):
        last = x.ndim - 1
        cut = [isinstance(p, Shard) and p.dim == last for p in x.placements]
        if heads % math.prod(n for n, c in zip(x.device_mesh.shape, cut)
                             if c):
            x = x.redistribute(x.device_mesh, tuple(
                Replicate() if c else p for p, c in zip(x.placements, cut)))
    return x.reshape(tuple(x.shape[:-1]) + (heads, dim))


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``x`` [..., heads, dim] -> [..., heads * dim].  A DTensor keeps its
    placements for the gradient too: one that comes back split over the
    merged dim, where the heads are not, is gathered before the unflatten
    (DTensor does not unflatten an uneven split)."""
    out = x.reshape(tuple(x.shape[:-2]) + (x.shape[-2] * x.shape[-1],))
    if isinstance(out, DTensor):
        from ..distributed import spmd
        out = spmd.constrain(out, out.placements)
    return out


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; a DTensor table looks up on local shards
    (:func:`repro_torch.distributed.spmd.embedding`: a masked lookup in
    each rank's vocab slice, summed over the split) — the same rows."""
    if isinstance(table, DTensor):
        from ..distributed import spmd
        return spmd.embedding(table, tokens)
    return table[tokens.long()]


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in a's dtype, with :func:`matmul`'s rule: on the
    CPU a bf16 product runs as one float32 product rounded once (how XLA's
    CPU backend computes the reference's bf16 ``einsum``)."""
    b = b.to(a.dtype)
    if a.dtype == BF16 and a.is_cpu:
        return torch.einsum(eq, a.float(), b.float()).to(BF16)
    return torch.einsum(eq, a, b)


def head_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """The serving entries' float32 logits ``x`` [M, d] @ ``head`` [d, V]
    (a tied head is the transposed view ``embed.T``).  For plain CUDA
    tensors with both operands bf16: one bf16 x bf16 product with float32
    accumulation and a float32 output (cuBLAS, a transposed head taken as
    it is), which reads the bf16 head once and makes no float32 copy of
    it.  A product of two bf16 numbers is exact in float32, so this
    differs from ``x.float() @ head.float()`` only in the order of the
    float32 sums.  Every other input (the CPU, ``meta``, DTensor, a float32
    operand) takes ``x.float() @ head.float()``, the reference's product,
    bit for bit.  ``launches`` counts the calls on the card's route."""
    if (x.dtype == BF16 and head.dtype == BF16 and x.is_cuda
            and head.is_cuda and not isinstance(x, DTensor)
            and not isinstance(head, DTensor)):
        head_logits.launches += 1
        return torch.mm(x, head, out_dtype=F32)
    return x.float() @ head.float()


head_logits.launches = 0


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"         # normal | zeros | ones | scaled
    scale: float | None = None   # stddev override for normal/scaled
    dtype: Any = F32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


def _fan_in(shape: tuple[int, ...]) -> int:
    # last axis is the output axis by convention (x @ w)
    return math.prod(shape[:-1]) if len(shape) > 1 else shape[0]


def materialize(gen: torch.Generator, spec: Pytree, *,
                device: torch.device | str, dtype=None) -> Pytree:
    """Draw real parameters for ``spec`` (dicts walked in sorted-key order,
    lists in order).  ``dtype`` overrides every leaf's spec dtype — the
    full-width model is materialized straight into bf16."""
    def leaf(p: ParamSpec) -> torch.Tensor:
        dt = dtype or p.dtype
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dt, device=device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dt, device=device)
        std = p.scale if p.scale is not None \
            else 1.0 / math.sqrt(max(1, _fan_in(p.shape)))
        x = torch.randn(p.shape, generator=gen, dtype=F32, device=device)
        return x.mul_(std).to(dt)

    def walk(node):
        if isinstance(node, ParamSpec):
            return leaf(node)
        if isinstance(node, list):
            return [walk(n) for n in node]
        return {k: walk(node[k]) for k in sorted(node)}

    return walk(spec)


def _spec_map(fn, spec: Pytree) -> Pytree:
    if isinstance(spec, ParamSpec):
        return fn(spec)
    if isinstance(spec, list):
        return [_spec_map(fn, n) for n in spec]
    return {k: _spec_map(fn, v) for k, v in spec.items()}


def abstract(spec: Pytree, *, device="meta") -> Pytree:
    """Shape-only stand-ins of ``spec``'s leaves (the reference's
    ``ShapeDtypeStruct``): empty tensors on ``device``, by default the
    ``meta`` device, which holds no storage."""
    return _spec_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                           device=device), spec)


def logical_axes(spec: Pytree) -> Pytree:
    return _spec_map(lambda p: p.axes, spec)


def param_count(spec: Pytree) -> int:
    out: list = []
    _spec_map(lambda p: out.append(math.prod(p.shape)), spec)
    return int(sum(out))


# ---------------------------------------------------------------------------
# Common numeric helpers
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
             offset: float = 0.0) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * (offset + scale.float())
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


_CONSTS: dict = {}


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """A scalar constant rounded to ``like``'s dtype first, as JAX rounds a
    weakly typed Python float to the array's dtype before the op.  Made
    once per (value, dtype, device) and kept: a decode step captured in a
    CUDA graph may copy nothing from host memory."""
    key = (v, like.dtype, like.device)
    c = _CONSTS.get(key)
    if c is None:
        c = _CONSTS[key] = torch.tensor(v, dtype=like.dtype,
                                        device=like.device)
    return c


def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu's own expression, op by op: every op rounds to the
    working dtype, so bf16 results match the reference bit for bit."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True), op by op in x's dtype:
    ``x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x**3)))`` with each
    constant rounded to the dtype and ``x**3`` as ``x * (x * x)`` (how
    ``lax.integer_pow`` multiplies)."""
    x3 = x * (x * x)
    inner = _const(math.sqrt(2 / math.pi), x) * (x + _const(0.044715, x) * x3)
    cdf = _const(0.5, x) * (1 + torch.tanh(inner))
    return x * cdf


def activate(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return silu(x)
    if kind == "gelu":
        return gelu_tanh(x)
    if kind == "relu2":            # squared ReLU (Primer / nemotron-4)
        r = torch.relu(x)
        return r * r
    if kind == "relu":
        return torch.relu(x)
    raise ValueError(f"unknown activation {kind!r}")


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    """Pad embedding tables so the vocab axis shards evenly (MaxText-style)."""
    return ((vocab + multiple - 1) // multiple) * multiple


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split layout, as the JAX package)
# ---------------------------------------------------------------------------

# The cos/sin of every rotary angle come from one host table per (head_dim,
# theta, device), computed once in float32 with the C library's sinf/cosf —
# the functions the reference's XLA CPU backend calls — from float32 angles
# pos * freq, with freq = theta^(-2i/hd) evaluated in float64 and rounded
# (what XLA's constant folding produces).  PyTorch's vectorized sin/cos
# differ in the last bit for a few percent of angles, and in bf16 that is
# enough to flip a greedy token at a near-tie.
_ROPE_TABLES: dict = {}


def _libm_sincos():
    """(sinf, cosf) of the C math library, loaded at first use."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    for fn in (libm.sinf, libm.cosf):
        fn.restype = ctypes.c_float
        fn.argtypes = [ctypes.c_float]
    return libm.sinf, libm.cosf


def yarn_mscale(factor: float, mscale: float) -> float:
    """DeepSeek-V2's ``yarn_get_mscale``: 0.1 * mscale * ln(factor) + 1
    (1 at factor <= 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_of(attn) -> tuple | None:
    """An ``AttnCfg``'s YaRN settings as the hashable tuple the rope
    helpers take, (factor, original_max_pos, beta_fast, beta_slow, mscale,
    mscale_all_dim), or None for plain rope (factor 1)."""
    if attn.yarn_factor == 1.0:
        return None
    return (float(attn.yarn_factor), int(attn.yarn_original_max_pos),
            float(attn.yarn_beta_fast), float(attn.yarn_beta_slow),
            float(attn.yarn_mscale), float(attn.yarn_mscale_all_dim))


def rope_freqs(head_dim: int, theta: float = 10000.0,
               yarn: tuple | None = None) -> np.ndarray:
    """The rotary inverse frequencies, evaluated in float64 and rounded
    once to float32.  With ``yarn`` (:func:`yarn_of`), DeepSeek-V2's YaRN:
    each frequency blends its interpolated value (divided by ``factor``)
    and its original one by the linear ramp between the correction
    dimensions of ``beta_fast`` and ``beta_slow`` over
    ``original_max_pos`` positions: channels below the fast dimension keep
    their frequency, those from the slow one on are interpolated."""
    freqs = 1.0 / (float(theta) ** (np.arange(0, head_dim, 2) / head_dim))
    if yarn is None:
        return freqs.astype(np.float32)
    factor, orig, fast, slow = yarn[:4]

    def dim(rotations):
        return head_dim * math.log(orig / (rotations * 2 * math.pi)) \
            / (2 * math.log(theta))
    low = max(math.floor(dim(fast)), 0)
    high = min(math.ceil(dim(slow)), head_dim - 1)
    if low == high:
        high += 0.001
    ramp = np.clip((np.arange(head_dim // 2) - low) / (high - low), 0, 1)
    return (freqs / factor * ramp + freqs * (1 - ramp)).astype(np.float32)


def rope_table(n: int, head_dim: int, theta: float, device,
               yarn: tuple | None = None):
    """(cos, sin), each [>= n, head_dim/2] float32 on ``device``; with
    ``yarn`` at :func:`rope_freqs`'s YaRN frequencies, times YaRN's ratio
    ``yarn_mscale(factor, mscale) / yarn_mscale(factor, mscale_all_dim)``
    where that is not 1."""
    if torch.device(device).type == "meta":      # a shape-only trace
        return (torch.empty((n, head_dim // 2), device="meta"),
                torch.empty((n, head_dim // 2), device="meta"))
    key = (head_dim, float(theta), str(device), yarn)
    tab = _ROPE_TABLES.get(key)
    if tab is None or tab[0].shape[0] < n:
        rows = max(n, 1024, 2 * tab[0].shape[0] if tab is not None else 0)
        ang = (np.arange(rows, dtype=np.float32)[:, None]
               * rope_freqs(head_dim, theta, yarn)).ravel().tolist()
        sinf, cosf = _libm_sincos()
        cos = np.fromiter(map(cosf, ang), np.float32, len(ang))
        sin = np.fromiter(map(sinf, ang), np.float32, len(ang))
        if yarn is not None:
            ratio = yarn_mscale(yarn[0], yarn[4]) / yarn_mscale(yarn[0],
                                                                yarn[5])
            if ratio != 1.0:
                cos, sin = cos * np.float32(ratio), sin * np.float32(ratio)
        shape = (rows, head_dim // 2)
        tab = (torch.from_numpy(cos.reshape(shape)).to(device),
               torch.from_numpy(sin.reshape(shape)).to(device))
        _ROPE_TABLES[key] = tab
    return tab


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, max_pos: int,
               theta: float = 10000.0,
               yarn: tuple | None = None) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: integer, broadcastable to
    [..., seq], each below ``max_pos``.  The first and second halves of
    head_dim are the rotated pairs.  ``yarn``: :func:`yarn_of`'s settings
    (None: plain rope)."""
    hd = x.shape[-1]
    cos_t, sin_t = rope_table(max_pos, hd, theta, x.device, yarn)
    pos = positions.long()
    cos = cos_t[pos][..., None, :]                      # [..., seq, 1, hd/2]
    sin = sin_t[pos][..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


_MROPE_SECTIONS: dict = {}


def _mrope_sections(sections: tuple, n: int, device) -> torch.Tensor:
    """[n] stream index (0, 1, 2) of each frequency channel, one tensor per
    (sections, device), made once: no host-to-device copy per call."""
    key = (sections, n, device)
    sec = _MROPE_SECTIONS.get(key)
    if sec is None:
        sec = _MROPE_SECTIONS[key] = torch.repeat_interleave(
            torch.arange(3, device=device),
            torch.tensor(sections, device=device), output_size=n)
    return sec


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor,
                sections: tuple[int, int, int], *, max_pos: int,
                theta: float = 10000.0) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): the head_dim/2 frequency channels are
    partitioned into (temporal, height, width) sections, each rotated by
    its own position stream.

    x: [..., seq, heads, head_dim]; positions_3d: integer [3, ..., seq],
    each below ``max_pos``.  Channel c of stream s turns by the angle
    ``pos_s * freq_c`` — the angle :func:`apply_rope` turns channel c by at
    position ``pos_s`` — so its cos/sin come from the same libm table."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {sections} must sum to {hd // 2}")
    cos_t, sin_t = rope_table(max_pos, hd, theta, x.device)
    sec_id = _mrope_sections(tuple(sections), hd // 2, x.device)  # [hd/2]
    pos = positions_3d.long()[sec_id]                         # [hd/2, ..., seq]
    pos = pos.movedim(0, -1)                                  # [..., seq, hd/2]
    chan = torch.arange(hd // 2, device=x.device)
    cos = cos_t[pos, chan][..., None, :]                      # [..., seq, 1, hd/2]
    sin = sin_t[pos, chan][..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Sinusoidal positions (Whisper)
# ---------------------------------------------------------------------------

_SINUSOID_TABLES: dict = {}


_SINUSOID_ROWS: dict = {}


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings [n, d] float32, evaluated
    in float64 on the host and rounded once, as the reference does.  With
    a ``device`` the table is copied there once per (n, d, device) and
    kept: a prefill captured in a CUDA graph may copy nothing from host
    memory."""
    key = (n, d, str(device))
    tab = _SINUSOID_ROWS.get(key)
    if tab is not None:
        return tab
    pos = np.arange(n)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d)
    tab = torch.from_numpy(np.concatenate([np.sin(ang), np.cos(ang)],
                                          axis=1).astype(np.float32))
    if device is None or torch.device(device).type == "meta":
        return tab if device is None else tab.to(device)
    tab = _SINUSOID_ROWS[key] = tab.to(device)
    return tab


def sinusoidal_position_at(pos: torch.Tensor, d: int, *,
                           max_pos: int) -> torch.Tensor:
    """Sinusoidal embedding at runtime positions. pos: [B] integer, each
    below ``max_pos`` -> [B, d] float32.

    The reference evaluates ``sin``/``cos`` of the float32 angles
    ``pos / 10000^(2i/d)`` at runtime; here they come from a host table per
    (d, device), made with the C library's ``sinf``/``cosf`` (what XLA's CPU
    backend calls) from the same float32 angles, the divisors evaluated in
    float64 and rounded (XLA folds them as constants), as the RoPE table
    does."""
    if pos.is_meta:                               # a shape-only trace
        return torch.empty(tuple(pos.shape) + (d,), device="meta")
    key = (d, str(pos.device))
    tab = _SINUSOID_TABLES.get(key)
    if tab is None or tab.shape[0] < max_pos:
        rows = max(max_pos, 512, 2 * tab.shape[0] if tab is not None else 0)
        div = np.power(10000.0, 2 * np.arange(d // 2) / d).astype(np.float32)
        ang = (np.arange(rows, dtype=np.float32)[:, None] / div).ravel()
        sinf, cosf = _libm_sincos()
        vals = ang.tolist()
        sin = np.fromiter(map(sinf, vals), np.float32, len(vals))
        cos = np.fromiter(map(cosf, vals), np.float32, len(vals))
        shape = (rows, d // 2)
        tab = torch.from_numpy(np.concatenate(
            [sin.reshape(shape), cos.reshape(shape)], axis=1)).to(pos.device)
        _SINUSOID_TABLES[key] = tab
    return tab[pos.long()]
