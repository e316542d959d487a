#!/usr/bin/env python3
"""Plot a PFB spectrogram waterfall (reference scripts/plot_spectrogram.py)."""

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import gpu_sdr.pyusrp as u  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description="Plot PFB waterfalls.")
    parser.add_argument("--folder", "-fn", type=str, default="data")
    parser.add_argument("--file", "-f", type=str, default=None)
    args = parser.parse_args()
    os.chdir(args.folder)
    fn = args.file or sorted(glob.glob("USRP_PFB*.h5"))[-1]
    out = u.plot_pfb(fn)
    print(f"plot written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
