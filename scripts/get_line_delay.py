#!/usr/bin/env python3
"""Measure and store the line delay (reference scripts/get_line_delay.py)."""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import gpu_sdr.pyusrp as u  # noqa: E402


def main():
    parser = argparse.ArgumentParser(
        description="Measure the line delay of the loopback/replay channel.")
    parser.add_argument("--folder", "-fn", type=str, default="data")
    parser.add_argument("--freq", "-f", type=float, default=300,
                        help="LO frequency in MHz")
    parser.add_argument("--rate", "-r", type=float, default=100,
                        help="Sampling rate in Msps")
    parser.add_argument("--frontend", "-rf", type=str, default="A")
    parser.add_argument("--duration", "-d", type=float, default=0.01)
    args = parser.parse_args()

    os.makedirs(args.folder, exist_ok=True)
    os.chdir(args.folder)
    if not u.Connect():
        u.print_error("Cannot reach the server")
        return 1

    filename = u.measure_line_delay(
        args.rate * 1e6, args.freq * 1e6, args.frontend,
        duration=args.duration, compensate=True)
    delay = u.analyze_line_delay(filename, True)
    u.write_delay_to_file(filename, delay)
    u.load_delay_from_file(filename)
    print(f"Line delay: {delay * 1e9:.0f} ns (stored in {filename}.h5)")
    u.Disconnect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
