"""Multi-chip parallelism: device meshes, channel sharding, and time-block
sharding with halo exchange.

The reference is a single-GPU thread pipeline; its only parallel structures
are per-channel kernels and the overlap-save carries (SURVEY.md section 2.4).
Here those become mesh axes:

  * ``channels`` — tones/PFB bins shard across devices (embarrassingly
    parallel: each device owns a column slice of the modulated-taps matrix);
  * ``time``     — each block's samples shard across devices, with the
    (f-1)*M-sample FIR history exchanged between ring neighbors
    via ``jax.lax.ppermute`` (the sequence-parallel halo exchange).
"""

from .mesh import make_mesh, default_mesh  # noqa: F401
from .sharded import ShardedDDC  # noqa: F401
from .fused_sharded import ShardedFusedLoopback  # noqa: F401
