"""Host-fed streaming ingest: double-buffered async host->device feed.

The reference's defining real-time loop is an external stream landing on the
host and being pushed through the accelerator continuously: a UHD RX thread
fills pinned buffers from the radio (single_rx_thread,
cpp/USRP_hardware_manager.cpp:1398-1611) while the GPU worker overlaps
`cudaMemcpyAsync` H2D of buffer i+1 with the kernels of buffer i
(rx_single_link, cpp/USRP_server_link_threads.cpp:604-702).

The equivalent here has two parts:

* :class:`SocketIngestSource` — blocks arrive from an external producer over
  TCP into the native C++ ingest ring (native/stream_ingest.cpp, the
  UHD-recv stand-in), drained block-at-a-time on the host;
* :class:`HostFeed` — a feeder thread that stays `depth` blocks ahead of the
  consumer: it converts each block to (re, im) float32 pairs and issues
  `jax.device_put`, so the host->device transfer of block i+1 (and the numpy
  conversion of i+2) overlaps the device compute of block i.  JAX transfers
  are asynchronous; the bounded queue is the double buffer, `depth=2` is the
  classic scheme.

The feed is exact: outputs are bit-identical to the unpipelined path
(tests/test_ingest.py proves both the overlap and the equality).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np

from ..ops import cplx
from .sources import Source


class HostFeed:
    """Wrap a Source so blocks are converted + device_put `depth` blocks
    ahead of consumption on a feeder thread.

    `device_blocks()` yields `(block, errors)` pairs where `block` is a
    device-committed :class:`~..ops.cplx.C` ready to enter a jitted step
    with no host work on the consumer side, and `errors` is the wrapped
    source's per-block error count (sampled on the feeder thread right
    after the block is produced, so attribution matches the unpipelined
    path exactly).
    """

    _END = object()

    def __init__(self, source: Source, depth: int = 2,
                 device=None):
        if depth < 1:
            raise ValueError("HostFeed depth must be >= 1")
        self.source = source
        self.depth = int(depth)
        self.device = device
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._err: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _feed(self, block_len: int, n_blocks: int) -> None:
        import jax
        take_errors = getattr(self.source, "take_errors", lambda: 0)
        try:
            for blk in self.source.blocks(block_len, n_blocks):
                if self._stop.is_set():
                    return
                errs = int(take_errors())
                x = cplx.from_np(blk)
                if self.device is not None:
                    x = jax.device_put(x, self.device)
                # device_put is async: the transfer is in flight while we
                # convert the next block; the bounded put blocks the feeder
                # when it is `depth` blocks ahead
                while not self._stop.is_set():
                    try:
                        self._q.put((x, errs), timeout=0.2)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(self._END, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def device_blocks(self, block_len: int, n_blocks: int):
        """Yield up to n_blocks (device-resident C block, errors) pairs."""
        self._stop.clear()
        # fresh run: drop anything a previous (early-exited or failed)
        # run left behind — stale blocks would head the new stream and a
        # stale error would be re-raised at the end of a clean run
        self._err = None
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread = threading.Thread(
            target=self._feed, args=(block_len, n_blocks),
            name="host-feed", daemon=True)
        self._thread.start()
        try:
            while True:
                x = self._q.get()
                if x is self._END:
                    if self._err is not None:
                        raise self._err
                    return
                yield x
        finally:
            self._stop.set()
            self._thread.join(timeout=5.0)
            self._thread = None


class SocketIngestSource(Source):
    """Blocks arriving from an external producer over TCP.

    Backed by the native ingest receiver (native/stream_ingest.cpp): a C++
    thread reassembles the raw complex64 byte stream into fixed-size blocks
    in a lock-free ring; `blocks()` pops them here.  Ring overflows (the
    consumer falling behind the wire) are reported through `take_errors`
    like the reference's UHD overflow counters
    (cpp/USRP_server_diagnostic.cpp:14-106).

    Use `port=0` for an ephemeral port; read `.port` to tell the producer
    where to connect.  If the producer disconnects or stalls
    mid-measurement the stream ENDS SHORT: a partial tail block is
    delivered zero-padded with its missing samples error-stamped (native
    `padded` counter), the shortfall is logged with the reference's
    "not streaming" diagnostic, and no further blocks are fabricated —
    the reference aborts rather than writing invented samples
    (cpp/USRP_hardware_manager.cpp:1546-1560).  `aborted` records the
    outcome; the pipeline and the H5 sinks handle under-delivery
    (run_pipeline accounting, H5Sink end-of-run shrink).
    """

    def __init__(self, block_len: int, port: int = 0, queue_len: int = 16,
                 timeout: float = 30.0):
        from ..server.native import NativeIngest
        self._ingest = NativeIngest(block_len, port=port,
                                    queue_len=queue_len)
        self.port = self._ingest.port
        self.block_len = int(block_len)
        self.timeout = float(timeout)
        self._errors_reported = 0
        self.aborted = False
        self.shortfall_blocks = 0

    def take_errors(self) -> int:
        st = self._ingest.stats
        total = st["overflows"] + st["padded"]
        delta = total - self._errors_reported
        self._errors_reported = total
        return int(delta)

    @property
    def stats(self) -> dict:
        return self._ingest.stats

    def blocks(self, block_len: int, n_blocks: int):
        assert block_len == self.block_len, \
            "ingest block length fixed at construction (native ring slots)"
        from ..utils.log import get_logger
        for i in range(n_blocks):
            try:
                blk = self._ingest.pop_block(timeout=self.timeout)
            except TimeoutError:
                blk = None
            if blk is None:
                # producer hung up / stalled: end the measurement short,
                # never fabricate data (the reference declares "USRP is
                # not streaming" and aborts,
                # cpp/USRP_hardware_manager.cpp:1546-1560)
                self.aborted = True
                self.shortfall_blocks = n_blocks - i
                get_logger("ingest").error(
                    "ingest producer is not streaming: ending measurement "
                    "%d blocks short (%d/%d delivered)",
                    self.shortfall_blocks, i, n_blocks)
                return
            yield blk

    def close(self) -> None:
        self._ingest.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
