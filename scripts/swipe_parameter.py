#!/usr/bin/env python3
"""Power/parameter sweep (reference scripts/swipe_parameter.py): per gain,
run VNA -> fit -> noise -> diagnostic, accumulating one dataset per point."""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import gpu_sdr.pyusrp as u  # noqa: E402


def main():
    parser = argparse.ArgumentParser(
        description="Sweep TX gain: VNA + fit + noise per point.")
    parser.add_argument("--folder", "-fn", type=str, default="data")
    parser.add_argument("--freq", "-f", type=float, default=300)
    parser.add_argument("--rate", "-r", type=float, default=100)
    parser.add_argument("--gains", "-g", nargs="+", default=["0"])
    parser.add_argument("--f0", type=float, default=-45)
    parser.add_argument("--f1", type=float, default=45)
    parser.add_argument("--points", "-p", type=float, default=20e3)
    parser.add_argument("--vna_time", type=float, default=1)
    parser.add_argument("--noise_time", type=float, default=5)
    parser.add_argument("--peaks", type=int, default=1)
    parser.add_argument("--decimation", "-d", type=int, default=100)
    args = parser.parse_args()

    os.makedirs(args.folder, exist_ok=True)
    os.chdir(args.folder)
    if not u.Connect():
        return 1
    rate = args.rate * 1e6
    rf = args.freq * 1e6
    for g in [int(float(x)) for x in args.gains]:
        print(f"--- gain {g} dB ---")
        vna = u.Single_VNA(start_f=args.f0 * 1e6, last_f=args.f1 * 1e6,
                           measure_t=args.vna_time,
                           n_points=int(args.points), tx_gain=g, Rate=rate,
                           RF=rf, output_filename=f"USRP_VNA_gain{g}")
        u.VNA_analysis(vna)
        try:
            u.initialize_peaks(vna, N_peaks=args.peaks)
            u.vna_fit(vna)
            rf_fit, tones = u.get_tones(vna)
        except (ValueError, IndexError) as e:
            u.print_warning(f"fit failed at gain {g}: {e}; skipping noise")
            continue
        noise = u.Get_noise(list(tones), measure_t=args.noise_time,
                            rate=rate, decimation=args.decimation,
                            RF=rf_fit, tx_gain=g,
                            output_filename=f"USRP_Noise_gain{g}")
        u.copy_resonator_group(vna, noise)
        u.calculate_noise(noise, welch=4)
        u.diagnostic_VNA_noise(noise, vna,
                               output_filename=f"diagnostic_gain{g}")
    u.Disconnect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
