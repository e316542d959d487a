"""Device-resident replay: demodulate a recorded IQ stream from HBM.

The host-fed replay path (engine/sources.ReplaySource -> run_pipeline)
moves every block over the host link (PCIe), which caps ingest below the
device's DSP rate.  For recordings that fit in device memory, upload ONCE
and scan the demodulator over HBM-resident blocks: per execution, K
blocks are sliced out with `lax.dynamic_slice` (block index wrapping mod
the recording length when looping) and demodulated with the streaming
state carried through the scan — the replay equivalent of the fused
loopback (engine/fused.py).

Replaces the reference's replay-style --sw_loop file feeds with a form
that runs at the device's rate (the reference streams from the
radio/NIC at 10 GbE).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import cplx
from ..ops.cplx import C
from ..params import AntennaParams
from .demodulator import make_demodulator
from .pipeline import PipelineResult

# share of the device's memory limit a resident recording may take; the
# rest is left to the demodulator's per-execution outputs, the streaming
# state and XLA's workspace
REPLAY_MEMORY_SHARE = 0.5
# budget on a backend that reports no memory limit (the CPU backend)
HOST_REPLAY_MAX_BYTES = 2 << 30


def device_replay_max_bytes() -> int:
    """Largest recording (bytes on device, 8 per complex sample) that the
    one-upload DeviceReplay takes; larger ones ride SegmentedDeviceReplay.
    Derived from the first device's `bytes_limit` times
    REPLAY_MEMORY_SHARE."""
    stats = jax.devices()[0].memory_stats()
    if stats and stats.get("bytes_limit"):
        return int(stats["bytes_limit"] * REPLAY_MEMORY_SHARE)
    return HOST_REPLAY_MAX_BYTES


@dataclasses.dataclass
class DeviceReplay:
    """Compiled K-blocks-per-execution demodulation of an HBM-resident
    recording."""

    rx: AntennaParams
    data: np.ndarray                  # complex64 recording (host side)
    blocks_per_exec: int = 8
    loop: bool = True

    def __post_init__(self):
        self.demod = make_demodulator(self.rx)
        L = self.demod.plan.block_len
        n = len(self.data)
        # which replay form this recording rides — compared against
        # engine/dispatch.plan_dispatch by test_dispatch_table
        self.path = "scan"
        nblk = max(1, -(-n // L))            # data blocks (tail padded)
        if self.loop:
            # exact host-path loop semantics need block-commensurate data
            assert n % L == 0, "looped device replay needs len % block == 0"
        # one trailing all-zero block: post-recording reads (non-loop)
        buf = np.zeros((nblk + 1) * L, dtype=np.complex64)
        buf[:n] = np.asarray(self.data[:nblk * L], dtype=np.complex64)[:n]
        self._X = cplx.from_np(buf)          # one upload, stays in HBM
        self.n_rec_blocks = nblk
        K = self.blocks_per_exec
        demod_step = self.demod.step
        loop = self.loop

        # the recording is an argument, not a closure constant, so it is
        # not baked into the compiled program
        def body(X, carry, _):
            state, idx = carry
            x = C(jax.lax.dynamic_slice(X.re, (idx * L,), (L,)),
                  jax.lax.dynamic_slice(X.im, (idx * L,), (L,)))
            state, y = demod_step(state, x)
            nxt = idx + 1
            if loop:
                nxt = jnp.where(nxt >= nblk, nxt - nblk, nxt)
            else:
                nxt = jnp.minimum(nxt, nblk)   # stick at the zero block
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
        """Demodulate the acquisition (rx.samples), feeding sinks
        packet-by-packet; exactly plan.n_blocks packets are emitted."""
        from .pipeline import run_chunked
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
                           usrp_number=usrp_number, front_end=front_end)


def can_device_replay(source) -> bool:
    """True when the source is a recording that fits the HBM budget."""
    from .sources import ArraySource, ReplaySource
    if not isinstance(source, (ReplaySource, ArraySource)):
        return False
    try:
        nbytes = source.data.size * 8        # complex64
    except AttributeError:
        return False
    return 0 < nbytes <= device_replay_max_bytes()


def can_segmented_replay(source) -> bool:
    """True when the source is a recording too large for the one-upload
    path: it rides SegmentedDeviceReplay (HBM-refill) instead of falling
    all the way back to the per-block host-fed pipeline."""
    from .sources import ArraySource, ReplaySource
    if not isinstance(source, (ReplaySource, ArraySource)):
        return False
    try:
        nbytes = source.data.size * 8        # complex64
    except AttributeError:
        return False
    return nbytes > device_replay_max_bytes()


@dataclasses.dataclass
class SegmentedDeviceReplay:
    """Chunked HBM-refill replay for recordings larger than device
    memory.

    The reference streams unbounded-duration input by construction (the
    RX thread refills 1 Msample buffers forever,
    cpp/USRP_hardware_manager.cpp:1398-1611); this framework's
    equivalent is an hours-long recording, which cannot ride the
    one-upload DeviceReplay once it exceeds the HBM budget.  Instead of
    dropping to the per-block host-fed pipeline (every block over the
    host link, one dispatch each), the recording is cut into
    fixed-shape segments of `seg_blocks` demod blocks; segment s+1 is
    staged to the device with an async `jax.device_put` the moment
    segment s starts executing (host->device transfer overlaps the
    K-blocks-per-execution demod scan — the HostFeed double-buffering
    idea applied to the replay path), and the demodulator's streaming
    state carries across segment boundaries exactly as it does across
    blocks, so the output bit-matches the host-fed path
    (tests/test_segmented_replay.py).

    Dispatch rule (measure.run_measurement / engine/dispatch.py):
    recordings with nbytes <= device_replay_max_bytes() take DeviceReplay;
    larger ones take this class; only non-recording sources fall back to
    the host-fed pipeline.
    """

    rx: AntennaParams
    data: np.ndarray                  # complex64 recording (may be mmap)
    blocks_per_exec: int = 8
    loop: bool = False
    segment_bytes: int | None = None  # per-segment HBM budget override

    def __post_init__(self):
        self.demod = make_demodulator(self.rx)
        L = self.demod.plan.block_len
        self.L = L
        n = len(self.data)
        if self.loop:
            # exact host-path loop semantics need block-commensurate data
            assert n % L == 0, \
                "looped segmented replay needs len % block == 0"
        self.nblk_rec = max(1, -(-n // L))
        K = self.blocks_per_exec
        # two segments are in flight (current + prefetched); keep their
        # combined footprint well inside the device-replay budget
        budget = self.segment_bytes or device_replay_max_bytes() // 4
        self.seg_blocks = max(K, (budget // (L * 8)) // K * K)
        demod_step = self.demod.step

        def body(X, carry, _):
            state, idx = carry
            x = C(jax.lax.dynamic_slice(X.re, (idx * L,), (L,)),
                  jax.lax.dynamic_slice(X.im, (idx * L,), (L,)))
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
        """Stream blocks [b0, b0 + seg_blocks) as one contiguous
        complex64 array (wrapping when looped, zero-padded past the
        recording when not)."""
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
        """Async host->device upload of one segment (device_put returns
        immediately; the transfer overlaps the current segment's
        executions)."""
        seg = np.asarray(self._segment(b0), dtype=np.complex64)
        return C(jax.device_put(np.ascontiguousarray(seg.real)),
                 jax.device_put(np.ascontiguousarray(seg.imag)))

    def run(self, sinks=(), usrp_number: int = 0,
            front_end: str = "A") -> PipelineResult:
        from .pipeline import run_chunked
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
                s = e // exec_per_seg          # entering segment s
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
                           usrp_number=usrp_number, front_end=front_end)
