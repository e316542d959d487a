"""Sharded fused DDC+FIR over a (time, channels) mesh.

The multi-chip version of ops/ddc.py.  Sharding layout:

  * input block x (L,)  -> sharded over 'time': each of T devices holds
    Lt = L/T contiguous samples;
  * modulated taps Hmod (f*M, C) -> sharded over 'channels' (column slices);
  * output y (nb, C) -> sharded over both axes (row-contiguous per shard).

The FIR needs the (f-1)*M samples preceding each time-shard (the
overlap-save halo; reference carries: buffer_helper spare samples and the
FIR partial-sum tail, cpp/USRP_server_memory_management.cpp:104-156,
cpp/fir.cu:64-69).  Each device sends its tail one step around the time
ring with ``jax.lax.ppermute``:

  * shard i>0 consumes the tail of shard i-1 of the *same* block (fresh
    ppermute result);
  * shard 0 consumes the tail of shard T-1 of the *previous* block — which
    is exactly what last block's ppermute delivered to it, so the per-shard
    carry is simply "the tail I received last block".

Carrier phases stay exact: per-(time-shard, channel) start offsets are
precomputed host-side as integers mod W; the per-block advance is an int32
vector add carried in the state.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import cplx
from ..ops.cplx import C
from ..ops.ddc import DirectDDCConfig


def _cpair(*spec):
    return C(P(*spec), P(*spec))


@dataclasses.dataclass
class ShardedDDC:
    """Compiled channel+time sharded DDC+FIR for one mesh.

    Usage:
        sd = ShardedDDC(cfg, mesh, block_len)
        state = sd.init_state()
        state, y = sd.step(state, sd.shard_input(block))   # y (nb, C)
    """

    cfg: DirectDDCConfig
    mesh: Mesh
    block_len: int

    def __post_init__(self):
        cfg, mesh, L = self.cfg, self.mesh, self.block_len
        self.T = mesh.shape.get("time", 1)
        self.Kc = mesh.shape.get("channels", 1)
        M, f, W, Cn = cfg.M, cfg.f, cfg.rate, cfg.n_channels
        assert L % (self.T * M) == 0, "block_len must split over time*decim"
        assert Cn % self.Kc == 0, "channels must split over channel axis"
        self.Lt = L // self.T          # samples per time shard
        self.nbt = self.Lt // M        # output rows per time shard
        self.H = (f - 1) * M           # halo size
        assert self.H <= self.Lt, "halo must fit in one time shard"

        fr = np.asarray(cfg.freqs, dtype=np.int64)
        self.hmod = cfg.modulated_taps()             # (f*M, Cn)
        n = np.arange(self.nbt, dtype=np.int64)
        ph = (fr[None, :] * ((n[:, None] * M) % W)) % W
        self.ramp = cplx.const(                       # (nbt, Cn): local rows
            np.exp(-2j * np.pi * ph / float(W)).astype(np.complex64))
        t = np.arange(self.T, dtype=np.int64)
        ph_t = (fr[None, :] * ((t[:, None] * self.Lt) % W)) % W
        self.shardrot = cplx.const(                   # (T, Cn): shard offset
            np.exp(-2j * np.pi * ph_t / float(W)).astype(np.complex64))
        self.stepv = jnp.asarray(((fr * L) % W).astype(np.int32))
        p0 = np.asarray(cfg.phases, dtype=np.int64)
        self.phase0 = jnp.asarray(
            ((p0 + fr * (-self.H)) % W).astype(np.int32))
        self._build()

    # ------------------------------------------------------------------
    def _build(self):
        cfg, mesh = self.cfg, self.mesh
        M, f, W = cfg.M, cfg.f, cfg.rate
        T, H, nbt = self.T, self.H, self.nbt
        has_time = "time" in mesh.axis_names and T > 1
        time_ax = "time" if "time" in mesh.axis_names else None
        ch_ax = "channels" if "channels" in mesh.axis_names else None

        def spmd_step(phase, carry, x, hmod, ramp, shardrot, step):
            """Per-device shapes: phase (C/Kc,), carry (H,), x (Lt,),
            hmod (f*M, C/Kc), ramp (nbt, C/Kc), shardrot (1, C/Kc)."""
            if H > 0 and has_time:
                tail = x[-H:]
                perm = [(i, (i + 1) % T) for i in range(T)]
                recv = C(jax.lax.ppermute(tail.re, "time", perm),
                         jax.lax.ppermute(tail.im, "time", perm))
                tidx = jax.lax.axis_index("time")
                halo = C(jnp.where(tidx == 0, carry.re, recv.re),
                         jnp.where(tidx == 0, carry.im, recv.im))
                new_carry = recv
            elif H > 0:
                halo, new_carry = carry, x[-H:]
            else:
                halo, new_carry = carry, carry
            theta = phase.astype(jnp.float32) * jnp.float32(2 * np.pi / W)
            rot = cplx.expi_neg(theta)
            ze = cplx.concat([halo, x]) if H else x
            X = ze.reshape(nbt + f - 1, M)
            acc = cplx.zeros((nbt, hmod.shape[1]), dtype=x.re.dtype)
            for j in range(f):
                acc = acc + cplx.matmul(X[j:j + nbt, :],
                                        hmod[j * M:(j + 1) * M, :])
            carrier = cplx.mul(ramp, C(rot.re[None, :], rot.im[None, :]))
            carrier = cplx.mul(carrier, shardrot)
            y = cplx.mul(acc, carrier)
            new_phase = phase + step
            new_phase = jnp.where(new_phase >= W, new_phase - W, new_phase)
            return new_phase, new_carry, y

        self._step = jax.jit(shard_map(
            spmd_step, mesh=mesh,
            in_specs=(P(ch_ax),               # phase
                      _cpair(time_ax),        # carry (per time shard)
                      _cpair(time_ax),        # x
                      _cpair(None, ch_ax),    # hmod
                      _cpair(None, ch_ax),    # ramp
                      _cpair(time_ax, ch_ax),  # shardrot
                      P(ch_ax)),              # step
            out_specs=(P(ch_ax), _cpair(time_ax), _cpair(time_ax, ch_ax)),
            check_vma=False))

    # ------------------------------------------------------------------
    def init_state(self):
        return (self.phase0, cplx.zeros(self.T * self.H))

    def step(self, state, x: C):
        phase, carry = state
        phase, carry, y = self._step(phase, carry, x, self.hmod, self.ramp,
                                     self.shardrot, self.stepv)
        return (phase, carry), y

    def shard_input(self, x_np: np.ndarray) -> C:
        """Place a host block onto the mesh with the time-sharded layout."""
        spec = NamedSharding(
            self.mesh,
            P("time" if "time" in self.mesh.axis_names else None))
        xc = cplx.from_np(x_np)
        return C(jax.device_put(xc.re, spec), jax.device_put(xc.im, spec))
