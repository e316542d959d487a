"""The streaming pipeline host loop.

Replaces the reference's thread graph (TXRX::start spawning UHD-RX ->
RX-worker -> TCP-streamer -> H5-writer threads with lock-free queues,
cpp/USRP_server_link_threads.cpp:238-431) with a single host loop over
jitted steps.  Pipelining comes from JAX's async dispatch: we keep a queue
of in-flight device results and only materialize block i's output after
dispatching block i+depth, so host<->device transfers and device compute
overlap — the functional equivalent of the reference's pinned-buffer double
buffering (preallocator, headers/USRP_server_memory_management.hpp:103-273).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional, Sequence


from ..ops import cplx
from .demodulator import Demodulator
from .sinks import PacketMeta, Sink
from .sources import Source


@dataclasses.dataclass
class PipelineResult:
    n_blocks: int
    rows: int
    channels: int
    elapsed_s: float
    samples_in: int

    @property
    def msps(self) -> float:
        """Raw input complex Msamples/s sustained."""
        return self.samples_in / self.elapsed_s / 1e6


def run_chunked(step, init_state, n_exec: int, n_blocks: int,
                block_len: int, channels: int, total_rows: int,
                sinks: Sequence[Sink] = (), usrp_number: int = 0,
                front_end: str = "A", to_np=None) -> PipelineResult:
    """Shared acquisition loop for the K-blocks-per-execution chains
    (engine/fused.py, engine/replay.py, parallel/fused_sharded.py): one
    execution in flight while the previous result drains to the sinks;
    exactly `n_blocks` packets are emitted (the last execution's excess
    blocks are dropped).

    `step(state) -> (state, ys)` with ys of shape (K, rows_b, channels);
    `to_np(ys) -> np.ndarray` (default cplx.to_np; the sharded chains
    pass their multi-host gather)."""
    conv = to_np if to_np is not None else cplx.to_np
    for s in sinks:
        s.on_start(channels, total_rows)
    state = init_state()
    rows = pkt = 0
    t0 = time.perf_counter()

    def drain(ys):
        nonlocal rows, pkt
        data = conv(ys)[:max(0, n_blocks - pkt)]
        for k in range(data.shape[0]):
            d = data[k]
            meta = PacketMeta(usrp_number=usrp_number,
                              front_end_code=front_end,
                              packet_number=pkt, length=int(d.size),
                              errors=0, channels=int(d.shape[1]))
            for s in sinks:
                s.on_packet(meta, d)
            rows += d.shape[0]
            pkt += 1

    pending = None
    for _ in range(n_exec):
        state, ys = step(state)
        if pending is not None:
            drain(pending)
        pending = ys
    if pending is not None:
        drain(pending)
    elapsed = time.perf_counter() - t0
    for s in sinks:
        s.on_end()
    return PipelineResult(n_blocks=pkt, rows=rows, channels=channels,
                          elapsed_s=elapsed,
                          samples_in=pkt * block_len)


def run_pipeline_mixed(mdemod, source: Source,
                       sinks_per_group: Sequence[Sequence[Sink]],
                       n_blocks: Optional[int] = None, usrp_number: int = 0,
                       front_end: str = "A", depth: int = 2,
                       feed_depth: int = 2) -> PipelineResult:
    """Stream blocks through a MixedDemodulator: every block feeds all
    wave-type groups in one jitted step; group g's packets drain to
    sinks_per_group[g] (mixed wave types exceed the reference, which
    rejects them — cpp/USRP_demodulator.cpp:36-39)."""
    plan = mdemod.plan
    nb = n_blocks if n_blocks is not None else plan.n_blocks
    for g, sinks in zip(mdemod.groups, sinks_per_group):
        for s in sinks:
            s.on_start(g.demod.n_channels, g.demod.plan.total_out_rows)

    if feed_depth > 0:
        from .ingest import HostFeed
        stream = HostFeed(source, depth=feed_depth).device_blocks(
            plan.block_len, nb)
    else:
        take_errors = getattr(source, "take_errors", lambda: 0)
        stream = ((cplx.from_np(b), int(take_errors()))
                  for b in source.blocks(plan.block_len, nb))

    state = mdemod.init_state()
    inflight = collections.deque()
    pkt = 0
    rows_total = 0
    t0 = time.perf_counter()

    def drain_one():
        nonlocal pkt, rows_total
        ys, errs = inflight.popleft()
        for g, y, sinks in zip(mdemod.groups, ys, sinks_per_group):
            data = cplx.to_np(y)
            meta = PacketMeta(
                usrp_number=usrp_number, front_end_code=front_end,
                packet_number=pkt, length=int(data.size),
                errors=errs, channels=int(data.shape[1]))
            for s in sinks:
                s.on_packet(meta, data)
            rows_total += data.shape[0]
        pkt += 1

    try:
        for x, errs in stream:
            state, ys = mdemod.step(state, x)
            inflight.append((ys, errs))
            if len(inflight) > depth:
                drain_one()
        while inflight:
            drain_one()
    finally:
        elapsed = time.perf_counter() - t0
        try:
            while inflight:
                drain_one()
        finally:
            for sinks in sinks_per_group:
                for s in sinks:
                    s.on_end()
    return PipelineResult(n_blocks=pkt, rows=rows_total,
                          channels=mdemod.n_channels, elapsed_s=elapsed,
                          samples_in=pkt * plan.block_len)


def run_pipeline(demod: Demodulator, source: Source,
                 sinks: Sequence[Sink] = (), n_blocks: Optional[int] = None,
                 usrp_number: int = 0, front_end: str = "A",
                 depth: int = 2, feed_depth: int = 2) -> PipelineResult:
    """Stream `n_blocks` blocks from source through the demodulator into
    the sinks.  Returns throughput accounting.

    `feed_depth` > 0 runs ingest through a HostFeed (engine/ingest.py): a
    feeder thread converts + device_puts blocks up to `feed_depth` ahead,
    overlapping the host->device transfer of block i+1 with the device
    compute of block i — the reference's pinned-pool double buffering
    (cpp/USRP_server_link_threads.cpp:604-702).  0 feeds inline."""
    plan = demod.plan
    nb = n_blocks if n_blocks is not None else plan.n_blocks
    for s in sinks:
        s.on_start(demod.n_channels, plan.total_out_rows)

    if feed_depth > 0:
        from .ingest import HostFeed
        stream = HostFeed(source, depth=feed_depth).device_blocks(
            plan.block_len, nb)
    else:
        take_errors = getattr(source, "take_errors", lambda: 0)
        stream = ((cplx.from_np(b), int(take_errors()))
                  for b in source.blocks(plan.block_len, nb))

    state = demod.init_state()
    inflight = collections.deque()
    rows = 0
    pkt = 0
    t0 = time.perf_counter()

    def drain_one():
        nonlocal rows, pkt
        y, errs = inflight.popleft()
        data = cplx.to_np(y)
        meta = PacketMeta(
            usrp_number=usrp_number, front_end_code=front_end,
            packet_number=pkt, length=int(data.size),
            errors=errs, channels=int(data.shape[1]))
        for s in sinks:
            s.on_packet(meta, data)
        rows += data.shape[0]
        pkt += 1

    try:
        for x, errs in stream:
            state, y = demod.step(state, x)
            inflight.append((y, errs))
            if len(inflight) > depth:
                drain_one()
        while inflight:
            drain_one()
    finally:
        # on interruption (Ctrl-C) still flush what we have and close the
        # sinks — the reference's keyboard_disconnect path saves the last
        # chunk (pyUSRP/USRP_connections.py:976-993)
        elapsed = time.perf_counter() - t0
        try:
            while inflight:
                drain_one()
        finally:
            for s in sinks:
                s.on_end()
    # account what was actually emitted (a source may under-deliver),
    # like run_chunked does
    return PipelineResult(n_blocks=pkt, rows=rows, channels=demod.n_channels,
                          elapsed_s=elapsed,
                          samples_in=pkt * plan.block_len)
