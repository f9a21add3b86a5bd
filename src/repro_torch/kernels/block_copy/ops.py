"""In-place pool block copies (compaction / khugepaged collapse moves).

Replaces the Pallas TPU kernel ``block_copy`` (``repro/kernels/block_copy/
kernel.py``, which aliased the pool in place with ``input_output_aliases``)
and the engine's jnp scatter ``_moves_entry`` (``repro/serving/engine.py``).

One call copies pool row ``src[i]`` to row ``dst[i]`` for every i, along
axis 1 of every ``[reps, NB, ...]`` pool leaf (the K and V pools of a
stacked layer segment), in ONE launch.  Rows with ``dst < 0`` are pad and
skipped.  Copies run concurrently and IN PLACE, so a batch must never read
or write a row that another move of the same batch writes; the serving
engine's move segmentation (``ServingEngine._apply_pending_moves``)
guarantees it.

On CUDA tensors :func:`block_copy` launches the kernel in
``csrc/block_copy.cu`` (or raises); on CPU tensors it runs
:func:`block_copy_plain`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import build


def _rows(src, dst) -> tuple[np.ndarray, np.ndarray]:
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError("src and dst must be 1-D and of one length")
    keep = dst >= 0
    return src[keep], dst[keep]


def block_copy_plain(leaves, src, dst) -> None:
    """``leaf[:, dst[i]] = leaf[:, src[i]]`` for each ``[reps, NB, ...]``
    leaf, every source read before any destination is written."""
    s, d = _rows(src, dst)
    if not s.size:
        return
    for leaf in leaves:
        si = torch.from_numpy(s).to(leaf.device, torch.long)
        di = torch.from_numpy(d).to(leaf.device, torch.long)
        leaf[:, di] = leaf[:, si]


_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
             + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])


def pool_pointers(leaves) -> torch.Tensor:
    """The device table of the leaves' base addresses that the kernel
    reads, after checking once that the leaves can share one launch.  A
    caller whose pools live as long as it does (the serving engine) builds
    it once and hands it to every :func:`block_copy`."""
    first = leaves[0]
    for leaf in leaves:
        if (leaf.shape != first.shape or leaf.dtype != first.dtype
                or leaf.device != first.device or not leaf.is_contiguous()
                or not leaf.is_cuda):
            raise ValueError("block_copy: leaves must be contiguous, on one "
                             "CUDA device, of one shape and dtype")
    return torch.tensor([leaf.data_ptr() for leaf in leaves],
                        dtype=torch.int64).to(first.device)


def block_copy(leaves, src, dst, *, ptrs=None) -> None:
    """Apply the move rows ``src -> dst`` (host int arrays) to every pool
    leaf in place.  CUDA leaves take one kernel launch for all of them
    (counted in ``block_copy.launches``), reading their addresses from
    ``ptrs`` (:func:`pool_pointers` of ``leaves``; built here when None);
    CPU leaves run the plain version."""
    if not leaves[0].is_cuda:
        block_copy_plain(leaves, src, dst)
        return
    s, d = _rows(src, dst)
    if not s.size:
        return
    if ptrs is None:
        ptrs = pool_pointers(leaves)
    elif ptrs.shape != (len(leaves),) or ptrs.device != leaves[0].device:
        raise ValueError("block_copy: ptrs is not the pointer table of "
                         "these leaves")
    first = leaves[0]
    reps, nb = first.shape[:2]
    if s.min() < 0 or max(s.max(), d.max()) >= nb:
        raise ValueError(f"block_copy: move row out of range [0, {nb})")
    row_bytes = first[0, 0].numel() * first.element_size()
    dev = first.device
    rows = torch.from_numpy(np.stack([s, d])).to(dev)
    fn = build.function("block_copy", "block_copy_launch", _ARGTYPES)
    err = fn(ptrs.data_ptr(), rows[0].data_ptr(), rows[1].data_ptr(),
             len(leaves), reps, len(s), nb, row_bytes,
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "block_copy")
    block_copy.launches += 1


block_copy.launches = 0
