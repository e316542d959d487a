"""Sharded chirp demodulation + lock-in over a time mesh.

CHIRP mode is elementwise in the mix-down and segment-local in the lock-in,
so time-sharding needs NO halo at all: each time shard demodulates its
segment with a precomputed per-shard phase offset (the uint32 accumulator
advanced by shard_index * Lt, exact mod-period arithmetic) and reduces its
own whole lock-in segments (the engine plan keeps Lt a multiple of ppt).
The channel axis is unused (one chirp channel, like the reference,
cpp/USRP_demodulator.cpp:31-34).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import cplx
from ..ops.chirp import ChirpConfig, chirp_phase_index
from ..ops.cplx import C
from ..ops.lockin import lockin_profile


def _cpair(*spec):
    return C(P(*spec), P(*spec))


@dataclasses.dataclass
class ShardedChirpLockin:
    """Compiled time-sharded chirp demod + lock-in."""

    cfg: ChirpConfig
    mesh: Mesh
    block_len: int
    ppt: int

    def __post_init__(self):
        mesh, L, ppt = self.mesh, self.block_len, self.ppt
        self.T = mesh.shape.get("time", 1)
        assert L % (self.T * ppt) == 0, \
            "block must split into whole lock-in segments per time shard"
        self.Lt = L // self.T
        self.nseg_t = self.Lt // ppt
        period = self.cfg.period
        # per-shard phase offset: shard t starts at sample t*Lt of the block
        t = np.arange(self.T, dtype=np.uint64)
        self.shard_off = jnp.asarray(
            ((t * np.uint64(self.Lt)) % np.uint64(period)).astype(np.uint32))
        self.profile = jnp.asarray(lockin_profile(ppt))
        self._build()

    def _build(self):
        cfg, mesh = self.cfg, self.mesh
        T, Lt, ppt, nseg_t = self.T, self.Lt, self.ppt, self.nseg_t
        time_ax = "time" if "time" in mesh.axis_names else None
        period = jnp.uint32(cfg.period)

        def spmd_step(last, off, x, profile):
            """last (1,) uint32 replicated; off (1,) uint32 per shard;
            x (Lt,) pair; profile (ppt,)."""
            base = (last[0] % period) + off[0]
            base = jnp.where(base >= period, base - period, base)
            n = jnp.arange(Lt, dtype=jnp.uint32)
            idx = chirp_phase_index(cfg, base, n)
            th = jnp.float32(np.pi) * (idx.astype(jnp.float32) *
                                       jnp.float32(1.0 / 2147483647.5))
            c = C(jnp.sin(th), -jnp.cos(th))
            z = cplx.conj_mul(c, x)
            seg = z.reshape(nseg_t, ppt)
            y = cplx.matmul_cr(seg, profile)
            return y

        self._step = jax.jit(shard_map(
            spmd_step, mesh=mesh,
            in_specs=(P(None), P(time_ax), _cpair(time_ax), P(None)),
            out_specs=_cpair(time_ax),
            check_vma=False))

    # ------------------------------------------------------------------
    def init_state(self):
        return jnp.zeros(1, dtype=jnp.uint32)

    def step(self, last, x: C):
        y = self._step(last, self.shard_off, x, self.profile)
        period = self.cfg.period
        new_last = (last + jnp.uint32(self.block_len % period)) % \
            jnp.uint32(period)
        return new_last, y

    def shard_input(self, x_np: np.ndarray) -> C:
        spec = NamedSharding(
            self.mesh,
            P("time" if "time" in self.mesh.axis_names else None))
        xc = cplx.from_np(x_np)
        return C(jax.device_put(xc.re, spec), jax.device_put(xc.im, spec))
