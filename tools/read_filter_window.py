#!/usr/bin/env python3
"""Plot a DSP filter window for diagnostics
(reference tools/read_filter_window.py:1-14, which reads the binary window
dump; here windows are regenerated from parameters)."""

import argparse
import sys
import os

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    parser = argparse.ArgumentParser(
        description="Plot PFB / FIR prototype windows.")
    parser.add_argument("--nfft", type=int, default=1024)
    parser.add_argument("--average", type=int, default=4)
    parser.add_argument("--decim", type=int, default=None,
                        help="plot the DIRECT-mode FIR taps instead")
    parser.add_argument("--out", "-o", type=str, default="filter_window.png")
    args = parser.parse_args()

    from gpu_sdr.ops.windows import pfb_window
    from gpu_sdr.ops.fir import fir_taps_direct

    import matplotlib
    matplotlib.use("agg")
    import matplotlib.pyplot as pl

    if args.decim:
        w = fir_taps_direct(args.decim, args.average, dtype=np.float64)
        title = f"DIRECT FIR taps (decim={args.decim}, f={args.average})"
    else:
        w = pfb_window(args.nfft, args.average, dtype=np.float64)
        title = f"PFB prototype (nfft={args.nfft}, avg={args.average})"

    fig, (ax0, ax1) = pl.subplots(nrows=2, figsize=(9, 7))
    ax0.plot(w)
    ax0.set_title(title)
    ax0.set_xlabel("tap")
    ax0.grid()
    H = np.fft.rfft(w, n=len(w) * 16)
    f = np.fft.rfftfreq(len(w) * 16)
    ax1.plot(f, 20 * np.log10(np.abs(H) / np.abs(H).max() + 1e-12))
    ax1.set_xlabel("normalized frequency")
    ax1.set_ylabel("response [dB]")
    ax1.set_ylim(-120, 3)
    ax1.grid()
    fig.savefig(args.out, bbox_inches="tight")
    print(f"window plot written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
