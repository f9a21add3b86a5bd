"""Hand-written Hopper kernels for the serving and training paths.

  paged_attention/  paged decode attention with exact per-page heat
  flash_attention/  causal/windowed GQA prefill attention and, for
                    training, its backward (LSE-saving autograd Function)
  block_copy/       in-place pool block moves (compaction / collapse)
  mla_decode/       MLA's absorbed decode over the paged latent pool, with
                    exact per-block heat

Each directory's ``ops.py`` holds the wrapper (launches the CUDA kernel in
``../csrc/<name>.cu`` for CUDA tensors, counts launches in ``.launches``)
and the plain PyTorch version it runs for CPU tensors.  :mod:`.build`
compiles the sources with ``nvcc`` at first use; :mod:`.roundtrip` is the
host's one round trip to a device entry (inputs up from pinned memory, the
entry, outputs down, one wait), which the compiled serving entries and the
policy kernel's batches share.
"""
