#!/usr/bin/env python3
"""Overlay noise tone levels on the VNA trace
(reference scripts/diagnostic_noise.py)."""

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import gpu_sdr.pyusrp as u  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description="VNA/noise diagnostic.")
    parser.add_argument("--folder", "-fn", type=str, default="data")
    parser.add_argument("--noise", "-n", type=str, default=None)
    parser.add_argument("--vna", "-v", type=str, default=None)
    args = parser.parse_args()
    os.chdir(args.folder)
    noise = args.noise or sorted(glob.glob("USRP_Noise*.h5"))[-1]
    vna = args.vna or (sorted(glob.glob("USRP_VNA*.h5")) or [None])[-1]
    out = u.diagnostic_VNA_noise(noise, vna)
    print(f"diagnostic written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
