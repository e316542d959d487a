#!/usr/bin/env python3
"""Frequency/dissipation timestream plot from a noise file with fit
parameters (reference scripts/freqts_plot.py)."""

import argparse
import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import gpu_sdr.pyusrp as u  # noqa: E402


def main():
    parser = argparse.ArgumentParser(
        description="Plot frequency timestreams.")
    parser.add_argument("--folder", "-fn", type=str, default="data")
    parser.add_argument("--file", "-f", type=str, default=None)
    parser.add_argument("--displayed", type=int, default=10000)
    args = parser.parse_args()
    os.chdir(args.folder)
    fn = args.file or sorted(glob.glob("USRP_Noise*.h5"))[-1]
    dff, dqr = u.get_frequency_timestreams(fn)

    import matplotlib
    matplotlib.use("agg")
    import matplotlib.pyplot as pl
    fig, (a0, a1) = pl.subplots(nrows=2, sharex=True, figsize=(10, 7))
    step = max(1, dff.shape[1] // args.displayed)
    for i in range(dff.shape[0]):
        a0.plot(dff[i, ::step], label=f"ch{i}")
        a1.plot(dqr[i, ::step])
    a0.set_ylabel("df/f")
    a1.set_ylabel("d(1/Qr)")
    a1.set_xlabel("sample")
    a0.legend(fontsize=7)
    a0.grid(); a1.grid()
    out = "frequency_timestreams.png"
    fig.savefig(out, bbox_inches="tight")
    print(f"plot written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
