"""PyTorch + CUDA port of ``repro`` (eBPF-mm: userspace-guided memory
management for a paged-KV serving engine), for one NVIDIA H100.

Module names mirror ``repro`` so each module's counterpart is easy to find.
Ported so far: the eBPF-policy serving path on dense decoders —

  core/        policy pipeline (scalar and batched routes), memory-
               management plane, tiering, artifact cache, online profiling
  obs/         event ring, telemetry hub, histograms, Chrome trace,
               Prometheus text
  resilience/  seeded failure injection, tier-link health, supervisor
  configs/     model configs (deepseek_7b)
  models/      dense decoder prefill/decode over paged KV
  kernels/     hand-written CUDA kernels (paged decode, flash prefill,
               block copy) with their plain PyTorch versions
  serving/     continuous-batching engine
  convert.py   the JAX package's params -> this package's layout

This package imports neither ``jax`` nor ``repro``; only the tests that
hold it against the reference import both.
"""

__version__ = "0.1.0"
