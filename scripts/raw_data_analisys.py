#!/usr/bin/env python3
"""Offline spectrum analysis of a raw (NODSP) capture
(reference scripts/raw_data_analisys.py)."""

import argparse
import glob
import os
import sys

import numpy as np
from scipy import signal

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import gpu_sdr.pyusrp as u  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description="Raw capture analysis.")
    parser.add_argument("--folder", "-fn", type=str, default="data")
    parser.add_argument("--file", "-f", type=str, default=None)
    parser.add_argument("--welch", "-w", type=int, default=8)
    args = parser.parse_args()
    os.chdir(args.folder)
    fn = args.file or sorted(glob.glob("USRP_*.h5"))[-1]
    info = u.get_rx_info(fn)
    data = u.openH5file(fn)[0]
    f, p = signal.welch(data, fs=info.rate, nperseg=len(data) // args.welch,
                        return_onesided=False, scaling="density")
    order = np.argsort(f)

    import matplotlib
    matplotlib.use("agg")
    import matplotlib.pyplot as pl
    fig, ax = pl.subplots(figsize=(10, 6))
    ax.plot((info.tone + f[order]) / 1e6, 10 * np.log10(p[order] + 1e-30))
    ax.set_xlabel("Frequency [MHz]")
    ax.set_ylabel("PSD [dB/Hz]")
    ax.grid()
    out = "raw_spectrum.png"
    fig.savefig(out, bbox_inches="tight")
    print(f"spectrum written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
