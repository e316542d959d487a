"""Mesh-dispatched device-resident replay.

The single-chip DeviceReplay (engine/replay.py) uploads a recording once
and scans the demodulator over HBM-resident blocks.  This is its
multi-chip form: the recording is uploaded ONCE with the blocks' time
axis already sharded over the mesh (block b, shard t holds samples
[b*L + t*Lt, b*L + (t+1)*Lt)), and each execution scans K blocks through
the SHARDED demodulator (parallel/sharded*.py) — the per-block input is
a cheap device-local slice of the resident recording, and the overlap-
save halos ride the demodulator's own ppermute ring exactly as in the
host-fed sharded path (no new collectives).

Reference analog: replay is this framework's --sw_loop
(cpp/USRP_hardware_manager.cpp:1331-1395); the reference has no
multi-device form at all.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import cplx
from ..ops.cplx import C
from ..params import AntennaParams
from ..engine.demodulator import make_demodulator
from ..engine.pipeline import PipelineResult
from .fused_sharded import _to_np_global


@dataclasses.dataclass
class ShardedDeviceReplay:
    """Compiled K-blocks-per-execution sharded demodulation of a
    mesh-resident recording."""

    rx: AntennaParams
    data: np.ndarray                  # complex64 recording (host side)
    mesh: Mesh
    blocks_per_exec: int = 8
    loop: bool = True

    def __post_init__(self):
        mesh = self.mesh
        self.demod = make_demodulator(self.rx, mesh=mesh)
        L = self.demod.plan.block_len
        n = len(self.data)
        # dispatch sub-path (plan==actual battery)
        self.path = "scan"
        nblk = max(1, -(-n // L))
        if self.loop:
            assert n % L == 0, \
                "looped sharded replay needs len(recording) % block == 0"
        # one trailing all-zero block serves post-recording reads (non-loop)
        buf = np.zeros((nblk + 1) * L, dtype=np.complex64)
        buf[:n] = np.asarray(self.data, dtype=np.complex64)[:n]
        time_ax = "time" if "time" in mesh.axis_names else None
        sh = NamedSharding(mesh, P(None, time_ax))
        xc = cplx.from_np(buf.reshape(nblk + 1, L))
        self._X = C(jax.device_put(xc.re, sh), jax.device_put(xc.im, sh))
        self.n_rec_blocks = nblk
        K = self.blocks_per_exec
        demod_step = self.demod.step
        loop = self.loop

        # the recording rides the jit as an ARGUMENT, not a closure
        # constant baked into the compiled program
        def body(X, carry, _):
            state, idx = carry
            x = C(jax.lax.dynamic_slice(X.re, (idx, 0), (1, L))[0],
                  jax.lax.dynamic_slice(X.im, (idx, 0), (1, L))[0])
            state, y = demod_step(state, x)
            nxt = idx + 1
            if loop:
                nxt = jnp.where(nxt >= nblk, nxt - nblk, nxt)
            else:
                nxt = jnp.minimum(nxt, nblk)    # stick at the zero block
            return (state, nxt), y

        import functools

        @jax.jit
        def multi(state, idx, X):
            (state, idx), ys = jax.lax.scan(
                functools.partial(body, X), (state, idx), None, length=K)
            return state, idx, ys

        self._multi = multi

    def run(self, sinks=(), usrp_number: int = 0,
            front_end: str = "A") -> PipelineResult:
        """Demodulate the acquisition (rx.samples) into the sinks; on a
        multi-host mesh each host's sinks receive the gathered global
        stream."""
        from ..engine.pipeline import run_chunked
        plan = self.demod.plan
        K = self.blocks_per_exec
        n_exec = max(1, -(-plan.n_blocks // K))

        def init():
            return (self.demod.init_state(), jnp.int32(0))

        def step(carry):
            st, idx = carry
            st, idx, ys = self._multi(st, idx, self._X)
            return (st, idx), ys

        return run_chunked(step, init, n_exec, plan.n_blocks,
                           plan.block_len, self.demod.n_channels,
                           plan.total_out_rows, sinks,
                           usrp_number=usrp_number, front_end=front_end,
                           to_np=_to_np_global)


@dataclasses.dataclass
class ShardedSegmentedReplay:
    """Chunked HBM-refill replay under a mesh: the sharded form of
    engine/replay.SegmentedDeviceReplay.

    Recordings larger than the per-upload budget are cut into
    fixed-shape segments of `seg_blocks` blocks; each segment is staged
    to the mesh with an async sharded `jax.device_put` (time axis
    pre-sharded, so each device receives only its span) while the
    previous segment streams through the SHARDED demodulator, whose
    overlap-save halos ride its own ppermute ring.  State carries across
    segment boundaries exactly as across blocks, so the gathered output
    matches the single-host paths bit-for-block
    (tests/test_sharded_replay.py::test_sharded_segmented_*).
    """

    rx: AntennaParams
    data: np.ndarray                  # complex64 recording (may be mmap)
    mesh: Mesh
    blocks_per_exec: int = 8
    loop: bool = False
    segment_bytes: int | None = None

    def __post_init__(self):
        from ..engine.replay import device_replay_max_bytes
        mesh = self.mesh
        self.demod = make_demodulator(self.rx, mesh=mesh)
        L = self.demod.plan.block_len
        self.L = L
        n = len(self.data)
        if self.loop:
            assert n % L == 0, \
                "looped segmented replay needs len % block == 0"
        self.nblk_rec = max(1, -(-n // L))
        K = self.blocks_per_exec
        budget = self.segment_bytes or device_replay_max_bytes() // 4
        self.seg_blocks = max(K, (budget // (L * 8)) // K * K)
        time_ax = "time" if "time" in mesh.axis_names else None
        self._sharding = NamedSharding(mesh, P(None, time_ax))
        demod_step = self.demod.step

        def body(X, carry, _):
            state, idx = carry
            x = C(jax.lax.dynamic_slice(X.re, (idx, 0), (1, L))[0],
                  jax.lax.dynamic_slice(X.im, (idx, 0), (1, L))[0])
            state, y = demod_step(state, x)
            return (state, idx + 1), y

        import functools

        @jax.jit
        def multi(state, idx0, X):
            (state, _), ys = jax.lax.scan(
                functools.partial(body, X), (state, idx0), None, length=K)
            return state, ys

        self._multi = multi

    def _segment(self, b0: int) -> np.ndarray:
        # same stream semantics as SegmentedDeviceReplay._segment
        L, S, n = self.L, self.seg_blocks, len(self.data)
        segL = S * L
        if self.loop:
            s0 = (b0 % self.nblk_rec) * L
            if s0 + segL <= n:
                return self.data[s0:s0 + segL]
            parts, need = [self.data[s0:]], segL - (n - s0)
            while need >= n:
                parts.append(self.data)
                need -= n
            if need:
                parts.append(self.data[:need])
            return np.concatenate(parts)
        s0 = b0 * L
        if s0 >= n:
            return np.zeros(segL, dtype=np.complex64)
        chunk = self.data[s0:s0 + segL]
        if len(chunk) == segL:
            return chunk
        buf = np.zeros(segL, dtype=np.complex64)
        buf[:len(chunk)] = chunk
        return buf

    def _stage(self, b0: int) -> C:
        seg = np.asarray(self._segment(b0), dtype=np.complex64)
        seg = seg.reshape(self.seg_blocks, self.L)
        return C(jax.device_put(np.ascontiguousarray(seg.real),
                                self._sharding),
                 jax.device_put(np.ascontiguousarray(seg.imag),
                                self._sharding))

    def run(self, sinks=(), usrp_number: int = 0,
            front_end: str = "A") -> PipelineResult:
        from ..engine.pipeline import run_chunked
        plan = self.demod.plan
        K = self.blocks_per_exec
        n_exec = max(1, -(-plan.n_blocks // K))
        exec_per_seg = self.seg_blocks // K
        n_seg = -(-n_exec // exec_per_seg)
        slot = {"cur": None, "nxt": None, "e": 0}

        def init():
            slot["cur"] = self._stage(0)
            slot["nxt"] = (self._stage(self.seg_blocks)
                           if n_seg > 1 else None)
            slot["e"] = 0
            return self.demod.init_state()

        def step(state):
            e = slot["e"]
            if e > 0 and e % exec_per_seg == 0:
                s = e // exec_per_seg
                slot["cur"] = slot["nxt"]
                slot["nxt"] = (self._stage((s + 1) * self.seg_blocks)
                               if s + 1 < n_seg else None)
            idx0 = jnp.int32((e % exec_per_seg) * K)
            state, ys = self._multi(state, idx0, slot["cur"])
            slot["e"] = e + 1
            return state, ys

        return run_chunked(step, init, n_exec, plan.n_blocks,
                           plan.block_len, self.demod.n_channels,
                           plan.total_out_rows, sinks,
                           usrp_number=usrp_number, front_end=front_end,
                           to_np=_to_np_global)
