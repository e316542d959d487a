#!/usr/bin/env python3
"""Beam mapping: raster an XY stage over a grid, acquiring tone response at
each position (reference scripts/beam_mapper/, built on Get_noise).

The per-position result (mean complex response per channel) is stored in a
single HDF5 map file; individual noise files are kept alongside.
"""

import argparse
import os
import sys

import h5py
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
import gpu_sdr.pyusrp as u  # noqa: E402
from velmex import open_stage  # noqa: E402


def raster(stage, x0, x1, nx, y0, y1, ny):
    xs = np.linspace(x0, x1, nx)
    ys = np.linspace(y0, y1, ny)
    for iy, y in enumerate(ys):
        row = xs if iy % 2 == 0 else xs[::-1]   # serpentine
        for x in row:
            yield float(x), float(y)


def main():
    parser = argparse.ArgumentParser(description="XY beam mapping.")
    parser.add_argument("--folder", "-fn", type=str, default="data")
    parser.add_argument("--port", type=str, default=None,
                        help="stage serial port (default: simulated)")
    parser.add_argument("--x0", type=float, default=0)
    parser.add_argument("--x1", type=float, default=10)
    parser.add_argument("--nx", type=int, default=5)
    parser.add_argument("--y0", type=float, default=0)
    parser.add_argument("--y1", type=float, default=10)
    parser.add_argument("--ny", type=int, default=5)
    parser.add_argument("--tones", "-T", nargs="+", default=["0.1"])
    parser.add_argument("--rate", "-r", type=float, default=1)
    parser.add_argument("--freq", "-f", type=float, default=300)
    parser.add_argument("--time", "-t", type=float, default=0.2)
    parser.add_argument("--decimation", "-d", type=int, default=100)
    parser.add_argument("--out", "-o", type=str, default="beam_map")
    args = parser.parse_args()

    os.makedirs(args.folder, exist_ok=True)
    os.chdir(args.folder)
    if not u.Connect():
        return 1

    stage = open_stage(args.port)
    stage.home()
    tones = [float(t) * 1e6 for t in args.tones]
    positions, responses = [], []
    total = args.nx * args.ny
    for i, (x, y) in enumerate(raster(stage, args.x0, args.x1, args.nx,
                                      args.y0, args.y1, args.ny)):
        stage.move_to(x, y)
        fn = u.Get_noise(tones, measure_t=args.time, rate=args.rate * 1e6,
                         decimation=args.decimation, RF=args.freq * 1e6,
                         output_filename=f"map_{i:04d}")
        data = u.openH5file(fn)
        resp = data[:, 8:].mean(axis=1)      # skip FIR transient
        positions.append((x, y))
        responses.append(resp)
        print(f"[{i + 1}/{total}] ({x:.2f}, {y:.2f}) mm -> "
              f"|resp| {np.abs(resp)}")

    with h5py.File(args.out + ".h5", "w") as f:
        grp = f.create_group("beam_map")
        grp.attrs.create("tones", tones)
        grp.attrs.create("grid", [args.nx, args.ny])
        grp.create_dataset("positions", data=np.asarray(positions))
        grp.create_dataset("responses", data=np.asarray(responses))
    print(f"beam map written to {args.out}.h5")
    stage.close()
    u.Disconnect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
