#!/usr/bin/env python3
"""Full-spectrum PFB acquisition (reference scripts/get_noise_full.py)."""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import gpu_sdr.pyusrp as u  # noqa: E402


def main():
    parser = argparse.ArgumentParser(
        description="Full-spectrum PFB spectrogram acquisition.")
    parser.add_argument("--folder", "-fn", type=str, default="data")
    parser.add_argument("--freq", "-f", type=float, default=300)
    parser.add_argument("--rate", "-r", type=float, default=100)
    parser.add_argument("--frontend", "-rf", type=str, default="A")
    parser.add_argument("--tones", "-T", nargs="+", default=["0"])
    parser.add_argument("--channels", "-c", type=int, default=100)
    parser.add_argument("--decimation", "-d", type=float, default=0)
    parser.add_argument("--time", "-t", type=float, default=1)
    parser.add_argument("--gain", "-g", type=int, default=0)
    args = parser.parse_args()

    os.makedirs(args.folder, exist_ok=True)
    os.chdir(args.folder)
    if not u.Connect():
        return 1
    tones = [float(t) * 1e6 for t in args.tones]
    fn = u.Get_full_spec(tones, channels=args.channels,
                         measure_t=args.time, rate=args.rate * 1e6,
                         RF=args.freq * 1e6, Front_end=args.frontend,
                         decimation=int(args.decimation) or None,
                         tx_gain=args.gain)
    print(f"PFB data written to {fn}")
    u.Disconnect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
