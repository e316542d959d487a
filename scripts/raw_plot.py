#!/usr/bin/env python3
"""Plot raw/demodulated timestreams (reference scripts/raw_plot.py,
last_file_plot.py)."""

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import gpu_sdr.pyusrp as u  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description="Plot raw data.")
    parser.add_argument("--folder", "-fn", type=str, default="data")
    parser.add_argument("--file", "-f", nargs="+",
                        help="default: most recent USRP_*.h5")
    parser.add_argument("--mode", "-m", type=str, default="IQ",
                        choices=["IQ", "PM"])
    parser.add_argument("--decimation", "-d", type=int, default=None)
    args = parser.parse_args()
    os.chdir(args.folder)
    files = args.file or sorted(glob.glob("USRP_*.h5"))[-1:]
    out = u.plot_raw_data(files, mode=args.mode,
                          decimation=args.decimation)
    print(f"plot written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
