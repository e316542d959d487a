"""gpu_sdr — a software-defined-radio readout framework in JAX.

A from-scratch re-design of the capabilities of GPU_SDR (a CUDA/C++ real-time
readout system for frequency-multiplexed superconducting resonators) as a
JAX/XLA program: all DSP is expressed as jittable JAX functions over static
shapes, streaming state (FIR tails, PFB spare samples, phase indices) is an
explicit scan carry, and channels/time-blocks shard over a `jax.sharding.Mesh`
with collectives for halo exchange.

Layer map (mirrors reference SURVEY.md §1):
  L0  params / utils      — config structs, validation, logging
  L1  engine.sources/sinks— synthetic & replay IQ ingest, HDF5/TCP egress
  L2  ops                 — DDC, FIR, PFB, chirp, lock-in, tone-gen ops
  L3  engine              — streaming pipeline with scan-carried state
  L4  server              — JSON command protocol + TCP servers
  L5  client              — connections, files (HDF5 schema)
  L6  client (analysis)   — VNA, noise, fitting, delay, full-spec, triggers
  L7  scripts             — measurement workflows
"""

__version__ = "0.1.0"

from . import params  # noqa: F401
