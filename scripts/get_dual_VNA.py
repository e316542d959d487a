#!/usr/bin/env python3
"""Dual-frontend VNA scan (reference scripts/get_dual_VNA.py)."""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import gpu_sdr.pyusrp as u  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description="Dual-frontend VNA scan.")
    parser.add_argument("--folder", "-fn", type=str, default="data")
    parser.add_argument("--freq_a", type=float, default=300)
    parser.add_argument("--freq_b", type=float, default=500)
    parser.add_argument("--rate", "-r", type=float, default=100)
    parser.add_argument("--f0", type=float, default=-45)
    parser.add_argument("--f1", type=float, default=45)
    parser.add_argument("--points", "-p", type=float, default=50e3)
    parser.add_argument("--time", "-t", type=float, default=1)
    parser.add_argument("--gain_a", type=int, default=0)
    parser.add_argument("--gain_b", type=int, default=0)
    args = parser.parse_args()

    os.makedirs(args.folder, exist_ok=True)
    os.chdir(args.folder)
    if not u.Connect():
        return 1
    rate = args.rate * 1e6
    fn = u.Dual_VNA(start_f_A=args.f0 * 1e6, last_f_A=args.f1 * 1e6,
                    start_f_B=args.f0 * 1e6, last_f_B=args.f1 * 1e6,
                    measure_t=args.time, n_points=int(args.points),
                    tx_gain_A=args.gain_a, tx_gain_B=args.gain_b,
                    Rate=rate, RF_A=args.freq_a * 1e6,
                    RF_B=args.freq_b * 1e6)
    u.VNA_analysis(fn)
    print(f"dual VNA written to {fn}")
    u.Disconnect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
