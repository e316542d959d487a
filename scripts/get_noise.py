#!/usr/bin/env python3
"""Fixed-tone noise acquisition (reference scripts/get_noise.py): tones
come from a fitted VNA file or the command line; supports guard tones,
DAC division, random benchmark tones and named triggers."""

import argparse
import os
import random
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import gpu_sdr.pyusrp as u  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description="Noise acquisition.")
    parser.add_argument("--folder", "-fn", type=str, default="data")
    parser.add_argument("--freq", "-f", type=float, default=300,
                        help="LO frequency in MHz")
    parser.add_argument("--gain", "-g", type=int, default=0)
    parser.add_argument("--rate", "-r", type=float, default=100)
    parser.add_argument("--frontend", "-rf", type=str, default="A")
    parser.add_argument("--tones", "-T", nargs="+",
                        help="tones in MHz (relative to LO)")
    parser.add_argument("--guard_tones", "-gt", nargs="+")
    parser.add_argument("--decimation", "-d", type=float, default=100)
    parser.add_argument("--time", "-t", type=float, default=10)
    parser.add_argument("--pf", type=int, default=4)
    parser.add_argument("--VNA", "-vna", type=str,
                        help="fitted VNA file providing the tones")
    parser.add_argument("--mode", "-m", type=str, default="DIRECT",
                        choices=["DIRECT", "PFB"])
    parser.add_argument("--random", "-R", type=int,
                        help="generate N random tones (benchmark/test)")
    parser.add_argument("--trigger", "-tr", type=str, default=None)
    parser.add_argument("--DAC_division", "-dd", type=int, default=None)
    args = parser.parse_args()

    os.makedirs(args.folder, exist_ok=True)
    os.chdir(args.folder)
    if not u.Connect():
        u.print_error("Cannot reach the server")
        return 1

    rate = args.rate * 1e6
    rf = args.freq * 1e6
    if args.VNA:
        rf_vna, tones = u.get_tones(args.VNA)
        rf = rf_vna
        tones = list(tones)
        print(f"{len(tones)} tones from {args.VNA}")
    elif args.random:
        tones = [random.uniform(-rate / 2 * 0.8, rate / 2 * 0.8)
                 for _ in range(args.random)]
    elif args.tones:
        tones = [float(t) * 1e6 for t in args.tones]
    else:
        u.print_error("No tones specified (use --tones, --VNA or --random)")
        return 1
    if args.guard_tones:
        tones += [float(t) * 1e6 for t in args.guard_tones]

    amplitudes = None
    if args.DAC_division:
        amplitudes = [1.0 / args.DAC_division] * len(tones)

    trigger = None
    if args.trigger:
        trigger = getattr(u, args.trigger)()

    fn = u.Get_noise(tones, measure_t=args.time, rate=rate,
                     decimation=int(args.decimation), amplitudes=amplitudes,
                     RF=rf, tx_gain=args.gain, Front_end=args.frontend,
                     pf_average=args.pf, mode=args.mode, trigger=trigger)
    if args.VNA:
        u.copy_resonator_group(args.VNA, fn)
    print(f"noise data written to {fn}")
    u.Disconnect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
