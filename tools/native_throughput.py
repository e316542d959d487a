#!/usr/bin/env python3
"""Throughput of the native C++ data plane over loopback TCP.

Pushes large framed packets through the SPSC ring + streamer thread to a
local consumer and reports the sustained rate — the role of the reference's
10 GbE network stress test (scripts/network_test.py) for the egress side.
"""

import os
import socket
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from gpu_sdr.engine.sinks import PacketMeta  # noqa: E402
from gpu_sdr.server import native as native_mod  # noqa: E402


def main():
    if not native_mod.available():
        print("native library not built (cmake -S native -B native/build)")
        return 1
    n_packets = 200
    samples = 1_000_000                      # 8 MB payload per packet
    srv = native_mod.NativeSyncServer(port=0,
                                      slot_bytes=8 * samples + 64,
                                      queue_len=16)
    received = [0]

    def consumer():
        c = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        c.settimeout(10)
        from gpu_sdr.server import wire
        while received[0] < n_packets:
            raw = wire.recv_exact(c, wire.HEADER_SIZE)
            meta = wire.decode_sync_header(raw)
            wire.recv_exact(c, 8 * meta["length"])
            received[0] += 1
        c.close()

    t = threading.Thread(target=consumer, daemon=True)
    t.start()
    srv.wait_client(timeout=10)
    data = (np.ones(samples) + 1j).astype(np.complex64)
    t0 = time.perf_counter()
    for i in range(n_packets):
        meta = PacketMeta(usrp_number=0, front_end_code="A",
                          packet_number=i, length=samples, errors=0,
                          channels=100)
        assert srv.push(meta, data, timeout=30)
    t.join(timeout=60)
    dt = time.perf_counter() - t0
    gb = n_packets * samples * 8 / 1e9
    print(f"native data plane: {gb:.1f} GB in {dt:.2f}s = "
          f"{gb / dt:.2f} GB/s ({n_packets * samples / dt / 1e6:.0f} "
          f"Msamples/s) over loopback TCP")
    print(f"stats: {srv.stats}")
    srv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
