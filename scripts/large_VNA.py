#!/usr/bin/env python3
"""Segmented wide-band VNA: scan a band wider than the sampling rate by
retuning the LO per segment and stitching the results
(reference scripts/large_VNA.py)."""

import argparse
import os
import sys

import h5py
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import gpu_sdr.pyusrp as u  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description="Segmented wide-band VNA.")
    parser.add_argument("--folder", "-fn", type=str, default="data")
    parser.add_argument("--start", type=float, default=200,
                        help="absolute start frequency in MHz")
    parser.add_argument("--stop", type=float, default=600,
                        help="absolute stop frequency in MHz")
    parser.add_argument("--rate", "-r", type=float, default=100)
    parser.add_argument("--points_per_segment", "-p", type=float,
                        default=20e3)
    parser.add_argument("--time", "-t", type=float, default=1,
                        help="seconds per segment")
    parser.add_argument("--gain", "-g", type=int, default=0)
    parser.add_argument("--out", "-o", type=str, default="USRP_large_VNA")
    args = parser.parse_args()

    os.makedirs(args.folder, exist_ok=True)
    os.chdir(args.folder)
    if not u.Connect():
        return 1

    rate = args.rate * 1e6
    span = 0.9 * rate                    # usable band per segment
    f_lo = args.start * 1e6
    f_hi = args.stop * 1e6
    n_seg = int(np.ceil((f_hi - f_lo) / span))
    freq_all, s21_all = [], []
    for s in range(n_seg):
        lo = f_lo + (s + 0.5) * span
        print(f"segment {s + 1}/{n_seg}: LO {lo / 1e6:.1f} MHz")
        fn = u.Single_VNA(start_f=-span / 2, last_f=span / 2,
                          measure_t=args.time,
                          n_points=int(args.points_per_segment),
                          tx_gain=args.gain, Rate=rate, RF=lo,
                          output_filename=f"{args.out}_seg{s}")
        u.VNA_analysis(fn)
        f, z = u.get_VNA_data(fn, calibrated=True)
        keep = (f >= f_lo) & (f <= f_hi)
        freq_all.append(f[keep])
        s21_all.append(z[keep])

    freq = np.concatenate(freq_all)
    s21 = np.concatenate(s21_all)
    order = np.argsort(freq)
    with h5py.File(args.out + ".h5", "w") as f:
        grp = f.create_group("VNA_0")
        grp.attrs.create("calibration", [1.0])
        grp.attrs.create("segments", n_seg)
        grp.create_dataset("frequency", data=freq[order])
        grp.create_dataset("S21", data=s21[order])
    print(f"stitched VNA ({len(freq)} points) written to {args.out}.h5")
    u.Disconnect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
