#!/usr/bin/env python3
"""Throughput of the native C++ ingest RECEIVER.

The egress side has a number (tools/native_throughput.py: 1.48 GB/s
framed packets over loopback TCP); this measures the RX half — a
producer streams raw complex64 bytes over loopback TCP into
native/stream_ingest.cpp's reassembly thread + SPSC ring, and the
consumer pops fixed 1 Msample blocks as fast as they land.  This is the
role of the reference's sustained-ingest requirement: the UHD RX thread
refills 1 Msample buffers at 100 Msps = 800 MB/s
(cpp/USRP_hardware_manager.cpp:1398-1611), 1.6 GB/s aggregate for the
full-duplex 2x100 Msps configuration.

Second phase: the PerHostIngest assembly overhead — the per-host shard
stream popped by the native receiver, assembled into a mesh-sharded
global device block via jax.make_array_from_process_local_data
(parallel/host_ingest.py) on the 8-virtual-device CPU mesh.

Run: python tools/native_ingest_throughput.py
"""

import os
import socket
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def bench_receiver():
    from gpu_sdr.server import native as native_mod
    if not native_mod.available():
        print("native library not built (cmake -S native -B native/build)")
        return None
    block_len = 1_000_000                    # the reference's buffer_len
    n_blocks = 400                           # 3.2 GB
    ing = native_mod.NativeIngest(block_len, port=0, queue_len=16)

    payload = (np.arange(4 * block_len) % 251).astype(np.float32) \
        .view(np.complex64).tobytes()        # 2 blocks worth per sendall
    blocks_per_send = len(payload) // (8 * block_len)

    def producer():
        c = socket.create_connection(("127.0.0.1", ing.port), timeout=10)
        c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        for _ in range(n_blocks // blocks_per_send):
            c.sendall(payload)
        c.close()

    t = threading.Thread(target=producer, daemon=True)
    t0 = time.perf_counter()
    t.start()
    got = 0
    while got < n_blocks:
        blk = ing.pop_block(timeout=30.0)
        if blk is None:
            break
        got += 1
    dt = time.perf_counter() - t0
    t.join(timeout=30)
    stats = dict(blocks=got,
                 overflows=int(ing._lib.sdr_ingest_overflows(ing._h)),
                 fragments=int(ing._lib.sdr_ingest_fragments(ing._h)))
    ing.close()
    gb = got * block_len * 8 / 1e9
    msps = got * block_len / dt / 1e6
    print(f"native ingest RX: {gb:.1f} GB in {dt:.2f}s = {gb/dt:.2f} GB/s "
          f"({msps:.0f} Msamples/s) over loopback TCP; "
          f"overflows={stats['overflows']} fragments={stats['fragments']}")
    return gb / dt


def bench_perhost_assembly():
    """Per-host shard stream -> sharded global device block: the
    make_array_from_process_local_data assembly cost per block."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from gpu_sdr.parallel import make_mesh
    from gpu_sdr.parallel.host_ingest import PerHostIngest
    if jax.device_count() < 8:
        print("per-host assembly: needs the 8-device virtual mesh "
              "(XLA_FLAGS=--xla_force_host_platform_device_count=8)")
        return None
    mesh = make_mesh((8, 1), ("time", "channels"))
    block_len = 1_000_000
    n_blocks = 64
    ph = PerHostIngest(mesh, block_len)
    stop = threading.Event()

    def producer():
        # stream until told to stop: the consumer (assembly) is the
        # measured side; ring overflows just mean the producer outpaces
        # it, which is the steady-state condition we want
        c = socket.create_connection(("127.0.0.1", ph.port), timeout=10)
        buf = (np.ones(ph.local_len, dtype=np.complex64) * 0.5).tobytes()
        try:
            while not stop.is_set():
                c.sendall(buf)
        except OSError:
            pass
        c.close()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    got = 0
    t0 = time.perf_counter()
    for blk, errs in ph.device_blocks(block_len, n_blocks):
        got += 1
    dt = time.perf_counter() - t0
    stop.set()
    ph.close()
    t.join(timeout=30)
    msps = got * block_len / dt / 1e6
    gbps = got * block_len * 8 / dt / 1e9
    print(f"per-host assembly: {got} blocks ({block_len} samples) in "
          f"{dt:.2f}s = {gbps:.2f} GB/s ({msps:.0f} Msamples/s) incl. "
          f"socket ingest + make_array_from_process_local_data on the "
          f"8-device mesh = {dt/got*1e3:.1f} ms/block (CPU-mesh device "
          f"buffers)")
    return gbps


def bench_full_duplex():
    """RX ingest + TX egress simultaneously over loopback TCP — the
    reference's full-duplex bar is 2 x 100 Msps = 1.6 GB/s aggregate
    (server_docs/01_installation.md:11)."""
    from gpu_sdr.engine.sinks import PacketMeta
    from gpu_sdr.server import native as native_mod
    from gpu_sdr.server import wire
    if not native_mod.available():
        return None
    # 2 Msample blocks: the Python-side pop/recv loops run per block,
    # so bigger blocks cut GIL churn (1 Msample blocks measured 1.51,
    # below the bar, from loop overhead alone)
    block_len = 2_000_000
    n_blocks = 200
    ing = native_mod.NativeIngest(block_len, port=0, queue_len=16)
    srv = native_mod.NativeSyncServer(port=0,
                                     slot_bytes=8 * block_len + 64,
                                     queue_len=16)
    payload = (np.ones(2 * block_len, dtype=np.complex64) * 0.5).tobytes()
    bps = len(payload) // (8 * block_len)

    def rx_producer():
        c = socket.create_connection(("127.0.0.1", ing.port), timeout=10)
        for _ in range(n_blocks // bps):
            c.sendall(payload)
        c.close()

    rx_done = [0]

    def rx_consumer():
        while rx_done[0] < n_blocks:
            if ing.pop_block(timeout=30.0) is None:
                break
            rx_done[0] += 1

    tx_done = [0]

    def tx_consumer():
        c = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        c.settimeout(30)
        buf = bytearray(8 * block_len)
        view = memoryview(buf)
        while tx_done[0] < n_blocks:
            raw = wire.recv_exact(c, wire.HEADER_SIZE)
            meta = wire.decode_sync_header(raw)
            need = 8 * meta["length"]
            got = 0
            while got < need:            # recv_into: no per-recv allocs
                n = c.recv_into(view[got:need], need - got)
                if n == 0:
                    return
                got += n
            tx_done[0] += 1
        c.close()

    threads = [threading.Thread(target=f, daemon=True)
               for f in (rx_producer, rx_consumer, tx_consumer)]
    data = (np.ones(block_len) + 1j).astype(np.complex64)
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    srv.wait_client(timeout=10)
    for i in range(n_blocks):
        meta = PacketMeta(usrp_number=0, front_end_code="A",
                          packet_number=i, length=block_len, errors=0,
                          channels=1)
        assert srv.push(meta, data, timeout=30)
    for th in threads:
        th.join(timeout=60)
    dt = time.perf_counter() - t0
    total_gb = (rx_done[0] + tx_done[0]) * block_len * 8 / 1e9
    ing.close()
    srv.close()
    print(f"full duplex: RX {rx_done[0]} + TX {tx_done[0]} blocks in "
          f"{dt:.2f}s = {total_gb/dt:.2f} GB/s aggregate over loopback "
          f"TCP (reference full-duplex bar: 1.6 GB/s)")
    return total_gb / dt


if __name__ == "__main__":
    # before any jax import: the virtual 8-device CPU mesh for phase 2
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    bench_receiver()
    bench_full_duplex()
    bench_perhost_assembly()
