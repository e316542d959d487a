#!/usr/bin/env python3
"""Plot the most recent measurement file in a folder
(reference scripts/last_file_plot.py)."""

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import gpu_sdr.pyusrp as u  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description="Plot the newest file.")
    parser.add_argument("--folder", "-fn", type=str, default="data")
    parser.add_argument("--mode", "-m", type=str, default="PM",
                        choices=["IQ", "PM"])
    args = parser.parse_args()
    os.chdir(args.folder)
    files = sorted(glob.glob("USRP_*.h5"), key=os.path.getmtime)
    if not files:
        u.print_error("no measurement files found")
        return 1
    out = u.plot_raw_data([files[-1]], mode=args.mode)
    print(f"plot written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
