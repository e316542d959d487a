"""Sharded PFB channelizer over a (time, channels) mesh.

Multi-chip version of ops/pfb.py:

  * 'time' axis: the input block is split into contiguous segments; each
    device needs the (avg-1)*nfft samples preceding its segment — the PFB's
    overlap-save halo (reference buffer_helper spare samples) — exchanged
    between ring neighbors with ppermute, with the cross-block
    carry handled exactly like ShardedDDC (shard 0 consumes what last
    block's ppermute delivered).
  * 'channels' axis: the DFT matrix is column-sharded, so each device
    computes nfft/Kc of the output bins for every frame — the windowed
    pre-sum is computed redundantly per channel shard (cheap; it is the
    memory-bound part) and the matmul is split.

Output: (frames, nfft) sharded over (time, channels); with `bins` set, tone
selection happens owner-locally inside the SPMD program (each channel shard
owns nfft/Kc contiguous bins, selects its own, and one psum over the channel
axis combines them — no sharded gather), like the fused chain
(fused_sharded.py).
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
from ..ops.pfb import PFBConfig


def _cpair(*spec):
    return C(P(*spec), P(*spec))


@dataclasses.dataclass
class ShardedPFB:
    """Compiled channel+time sharded PFB for one mesh."""

    cfg: PFBConfig
    mesh: Mesh
    block_len: int
    bins: tuple | None = None     # selected bins -> owner-local tone select

    def __post_init__(self):
        cfg, mesh, L = self.cfg, self.mesh, self.block_len
        nfft, avg = cfg.nfft, cfg.avg
        self.T = mesh.shape.get("time", 1)
        self.Kc = mesh.shape.get("channels", 1)
        assert L % (self.T * nfft) == 0, \
            "block_len must split over time shards in whole frames"
        assert nfft % self.Kc == 0, "nfft must split over channel shards"
        self.Lt = L // self.T
        self.frames_t = self.Lt // nfft
        self.H = (avg - 1) * nfft
        if self.bins is not None:
            nloc = nfft // self.Kc
            b = np.asarray(self.bins, dtype=np.int64)
            self._owners = jnp.asarray((b // nloc).astype(np.int32))
            self._local_idx = jnp.asarray((b % nloc).astype(np.int32))

        from ..ops.cplx import dft_matrix
        self.F = dft_matrix(nfft)                 # (nfft, nfft) C pair
        self.window = cfg.window()
        self._build()

    def _build(self):
        cfg, mesh = self.cfg, self.mesh
        nfft, avg = cfg.nfft, cfg.avg
        T, H, ft = self.T, self.H, self.frames_t
        has_time = "time" in mesh.axis_names and T > 1
        time_ax = "time" if "time" in mesh.axis_names else None
        ch_ax = "channels" if "channels" in mesh.axis_names else None
        Kc = self.Kc
        select = self.bins is not None

        def spmd_step(carry, x, window, F, owners, local_idx):
            """Local shapes: carry (H,), x (Lt,), window (nfft*avg,),
            F (nfft, nfft/Kc); owners/local_idx (n_tones,) replicated
            (dummy scalars when not selecting)."""
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
            W = window.reshape(avg, nfft)
            ze = cplx.concat([halo, x]) if H else x
            X = ze.reshape(ft + avg - 1, nfft)
            pre = cplx.zeros((ft, nfft), dtype=x.re.dtype)
            for i in range(avg):
                pre = pre + cplx.scale(X[i:i + ft, :], W[i][None, :])
            frames = cplx.matmul(pre, F)          # (ft, nfft/Kc)
            if select:
                # owner-local tone select + one psum over the channel axis
                # (no sharded gather; mirrors fused_sharded.pfb_select)
                sel = cplx.take(frames, local_idx, axis=-1)
                if ch_ax is not None and Kc > 1:
                    cidx = jax.lax.axis_index("channels")
                    mask = (owners == cidx).astype(sel.re.dtype)[None, :]
                    sel = C(jax.lax.psum(sel.re * mask, "channels"),
                            jax.lax.psum(sel.im * mask, "channels"))
                return new_carry, sel
            return new_carry, frames

        out_spec = _cpair(time_ax) if select else _cpair(time_ax, ch_ax)
        self._step = jax.jit(shard_map(
            spmd_step, mesh=mesh,
            in_specs=(_cpair(time_ax),            # carry (per time shard)
                      _cpair(time_ax),            # x
                      P(None),                    # window (replicated)
                      _cpair(None, ch_ax),        # DFT columns
                      P(None), P(None)),          # owners / local_idx
            out_specs=(_cpair(time_ax), out_spec),
            check_vma=False))

    # ------------------------------------------------------------------
    def init_state(self) -> C:
        return cplx.zeros(self.T * self.H)

    def step(self, carry: C, x: C):
        """Returns (carry', frames): frames is (L//nfft, nfft) sharded over
        (time, channels), or (L//nfft, n_tones) time-sharded when `bins`
        selection is active."""
        if self.bins is not None:
            owners, local_idx = self._owners, self._local_idx
        else:
            owners = local_idx = jnp.zeros((1,), jnp.int32)
        carry, frames = self._step(carry, x, self.window, self.F,
                                   owners, local_idx)
        return carry, frames

    def shard_input(self, x_np: np.ndarray) -> C:
        spec = NamedSharding(
            self.mesh,
            P("time" if "time" in self.mesh.axis_names else None))
        xc = cplx.from_np(x_np)
        return C(jax.device_put(xc.re, spec), jax.device_put(xc.im, spec))
