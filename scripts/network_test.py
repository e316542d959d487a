#!/usr/bin/env python3
"""Throughput stress test (reference scripts/network_test.py:1-73):
1000-channel PFB at 100 Msps driven through the full command path, with the
sustained ingest rate reported."""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import gpu_sdr.pyusrp as u  # noqa: E402
from gpu_sdr.engine.sinks import Sink  # noqa: E402
from gpu_sdr.measure import run_measurement  # noqa: E402
from gpu_sdr.params import (AntennaParams, AntMode, UsrpParams,  # noqa: E402
                            WaveType)


class CountingSink(Sink):
    def __init__(self):
        self.rows = 0

    def on_packet(self, meta, data):
        self.rows += data.shape[0]


def main():
    parser = argparse.ArgumentParser(description="Throughput stress test.")
    parser.add_argument("--channels", "-c", type=int, default=1000)
    parser.add_argument("--rate", "-r", type=float, default=100)
    parser.add_argument("--time", "-t", type=float, default=1.0)
    args = parser.parse_args()

    rate = int(args.rate * 1e6)
    nfft = 1024 if args.channels > 100 else 100
    tones = list(np.linspace(-rate / 2 * 0.9, rate / 2 * 0.9, args.channels))
    cmd = UsrpParams()
    cmd.A_TXRX = AntennaParams(
        mode=AntMode.TX, rate=rate, buffer_len=1_000_000,
        samples=int(rate * args.time),
        freq=[int(t) for t in tones],
        ampl=[1.0 / len(tones)] * len(tones),
        wave_type=[WaveType.TONES] * len(tones), delay=1.0)
    cmd.A_RX2 = AntennaParams(
        mode=AntMode.RX, rate=rate, buffer_len=1_000_000,
        samples=int(rate * args.time), fft_tones=nfft, pf_average=4,
        freq=[int(t) for t in tones],
        wave_type=[WaveType.TONES] * len(tones), delay=1.0)

    sink = CountingSink()
    t0 = time.perf_counter()
    run_measurement(cmd, filename=None, extra_sinks=[sink])
    dt = time.perf_counter() - t0
    processed = cmd.A_RX2.samples
    print(f"{args.channels} channels @ {args.rate} Msps: processed "
          f"{processed / 1e6:.0f} Msamples in {dt:.2f}s "
          f"({processed / dt / 1e6:.1f} Msps sustained, {sink.rows} rows out)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
