"""Per-host sharded ingest: N host-local TCP feeds -> ONE globally
time-sharded IQ stream.

The reference's host->device transport is a single-host pinned-pool
pipeline (preallocator + cudaMemcpyAsync,
headers/USRP_server_memory_management.hpp:210-272); its multi-host
equivalent (SURVEY.md section 2.4, "per-host shard of the IQ
stream", cross-host redistribution over the network) runs ONE native TCP receiver
per process (native/stream_ingest.cpp via engine.ingest.
SocketIngestSource), each fed only the time span its local devices own
(distributed.host_time_span), and assembles every global block with
``jax.make_array_from_process_local_data`` — samples never cross hosts:
the host network carries only the tiny per-block liveness agreement, and
the device interconnect carries
the sharded demodulator's own overlap-save halos.

Failure semantics follow the reference's "USRP is not streaming" abort
(cpp/USRP_hardware_manager.cpp:1546-1560): when ANY host's producer dies
or stalls, every host ends the measurement short together — an SPMD
program needs all processes to step in lock-step, so liveness is agreed
per block before the demodulator advances.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops.cplx import C
from ..utils.log import get_logger
from .distributed import host_time_span

log = get_logger("host_ingest")


class PerHostIngest:
    """One native TCP ingest receiver per process, yielding globally
    time-sharded device blocks.

    Each process tells its producer to connect to `.port` and stream the
    raw complex64 samples of THIS host's span of every global block:
    samples [b*L + offset, b*L + offset + local_len) of the global
    stream, back to back.  `device_blocks()` yields
    (C global (L,) sharded over `axis`, local_errors) pairs ready for a
    sharded demodulator step."""

    def __init__(self, mesh, block_len: int, axis: str = "time",
                 port: int = 0, queue_len: int = 16,
                 timeout: float = 30.0):
        from ..engine.ingest import SocketIngestSource
        self.mesh = mesh
        self.axis = axis
        self.block_len = int(block_len)
        start, stop, T = host_time_span(mesh, axis)
        if self.block_len % T:
            raise ValueError(
                f"block_len {block_len} must split over the {T} '{axis}' "
                f"shards")
        self.seg = self.block_len // T
        self.local_len = (stop - start) * self.seg
        self.offset = start * self.seg
        if self.local_len == 0:
            raise ValueError("this host owns no devices on the mesh")
        self.source = SocketIngestSource(self.local_len, port=port,
                                         queue_len=queue_len,
                                         timeout=timeout)
        self.port = self.source.port
        self._sharding = NamedSharding(mesh, P(axis))
        self.aborted = False
        self.shortfall_blocks = 0

    # ------------------------------------------------------------------
    def _all_alive(self, ok: bool) -> bool:
        """Per-block liveness agreement across processes (host network): all hosts
        must advance the SPMD demodulator together or stop together."""
        if jax.process_count() == 1:
            return ok
        from jax.experimental import multihost_utils
        flags = multihost_utils.process_allgather(
            np.asarray([ok], dtype=np.bool_))
        return bool(np.asarray(flags).all())

    def device_blocks(self, block_len: int, n_blocks: int):
        """Yield up to n_blocks (global sharded C block, local errors)."""
        assert block_len == self.block_len, \
            "per-host ingest block length fixed at construction"
        it = self.source.blocks(self.local_len, n_blocks)
        for i in range(n_blocks):
            blk = next(it, None)
            if not self._all_alive(blk is not None):
                # some host's producer is not streaming: end SHORT
                # everywhere, never fabricate samples (reference abort,
                # cpp/USRP_hardware_manager.cpp:1546-1560)
                self.aborted = True
                self.shortfall_blocks = n_blocks - i
                log.error(
                    "per-host ingest is not streaming on at least one "
                    "host: ending measurement %d blocks short (%d/%d "
                    "delivered)", self.shortfall_blocks, i, n_blocks)
                return
            x = np.asarray(blk, dtype=np.complex64)
            re = jax.make_array_from_process_local_data(
                self._sharding, np.ascontiguousarray(x.real), (block_len,))
            im = jax.make_array_from_process_local_data(
                self._sharding, np.ascontiguousarray(x.imag), (block_len,))
            yield C(re, im), int(self.source.take_errors())

    def close(self) -> None:
        self.source.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def host_stream_for(x_global: np.ndarray, ingest: PerHostIngest,
                    n_blocks: int) -> np.ndarray:
    """The byte-for-byte sample stream a producer must send to THIS
    host's `ingest.port` for a given global recording: this host's span
    of each global block, back to back (the per-host shard of the IQ
    stream, SURVEY.md section 2.4)."""
    L, off, n = ingest.block_len, ingest.offset, ingest.local_len
    pieces = [x_global[b * L + off: b * L + off + n]
              for b in range(n_blocks)]
    return np.ascontiguousarray(
        np.concatenate(pieces).astype(np.complex64))
