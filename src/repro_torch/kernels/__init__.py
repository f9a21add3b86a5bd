"""Hand-written Hopper kernels for the serving path.

  paged_attention/  paged decode attention with exact per-page heat
  flash_attention/  causal/windowed GQA prefill attention
  block_copy/       in-place pool block moves (compaction / collapse)

Each directory's ``ops.py`` holds the wrapper (launches the CUDA kernel in
``../csrc/<name>.cu`` for CUDA tensors, counts launches in ``.launches``)
and the plain PyTorch version it runs for CPU tensors.  :mod:`.build`
compiles the sources with ``nvcc`` at first use.
"""
