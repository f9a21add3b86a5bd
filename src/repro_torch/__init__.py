"""PyTorch + CUDA port of ``repro`` (eBPF-mm: userspace-guided memory
management for a paged-KV serving engine), for one NVIDIA H100.

Module names mirror ``repro`` so each module's counterpart is easy to find.
Ported so far: the eBPF-policy serving path for every arch, and training —

  core/        policy pipeline (scalar and batched routes), memory-
               management plane, tiering, artifact cache, online profiling
  obs/         event ring, telemetry hub, histograms, Chrome trace,
               Prometheus text
  resilience/  seeded failure injection, tier-link health, supervisor
  configs/     model configs (all ten archs)
  models/      prefill/decode over paged KV; the training forward and loss
  kernels/     hand-written CUDA kernels (paged decode, flash prefill and
               its backward, block copy) with their plain PyTorch versions
  serving/     continuous-batching engine
  optim/       AdamW and the learning-rate schedule
  data/        the synthetic LM data pipeline
  checkpoint/  the sharded, manifest-driven checkpoint store
  distributed/ the host-side fault-tolerance pieces (watchdog, restarts)
  training/    the train step and the fault-tolerant Trainer
  convert.py   the JAX package's params -> this package's layout

This package imports neither ``jax`` nor ``repro``; only the tests that
hold it against the reference import both.
"""

__version__ = "0.1.0"
