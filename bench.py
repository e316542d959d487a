"""Headline throughput: the 1000-bin channelized readout on one GPU.

Prints the card line (name, power limit) and ONE JSON line:
  {"metric": ..., "value": N, "unit": "Msamples/s/chip", "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": N}}

Baseline: the reference sustains 100 Msps complex input with 1000 PFB
channels on one GPU in real time (scripts/network_test.py:4-6,
server_docs/01_installation.md:11) => vs_baseline = value / 100.

The timed chain is the reference's network-stress configuration run as
a fused on-device loopback through the public API (engine/fused.
FusedLoopback): a 1000-tone comb bin-quantized like the reference's PFB
mode (pyUSRP/USRP_low_level.py:261) -> PFB pre-sum + DFT (nfft 1000,
pf_average 4) -> 1000-bin tone selection, with every block's result
drained to the host.  Each acquisition ends in its host drain, so the
wall time covers the device work.  Metric definitions for the H100
benchmark are ROADMAP item A1; this is the quick headline only.

Fails without a GPU.
"""

from __future__ import annotations

import json
import sys

RATE = 100_000_000
NFFT, AVG, N_TONES = 1000, 4, 1000
BUFFER_LEN = 4_000_000
N_BLOCKS = 64
BLOCKS_PER_EXEC = 8


def headline_loopback():
    """(tx, rx) AntennaParams of the bin-quantized 1000-tone comb."""
    from gpu_sdr.params import AntennaParams, AntMode, WaveType
    freqs = [k * (RATE // NFFT) for k in range(-NFFT // 2, NFFT // 2)]
    common = dict(rate=RATE, buffer_len=BUFFER_LEN,
                  samples=N_BLOCKS * BUFFER_LEN, freq=freqs, delay=1.0)
    tx = AntennaParams(mode=AntMode.TX, ampl=[1.0 / N_TONES] * N_TONES,
                       wave_type=[WaveType.TONES] * N_TONES, **common)
    rx = AntennaParams(mode=AntMode.RX, fft_tones=NFFT, pf_average=AVG,
                       wave_type=[WaveType.TONES] * N_TONES, **common)
    return tx, rx


def bench_loopback_1000(rounds: int = 3) -> float:
    """Best end-to-end Msamples/s of `rounds` acquisitions, after one
    untimed acquisition that compiles."""
    from gpu_sdr.engine.fused import FusedLoopback
    tx, rx = headline_loopback()
    fl = FusedLoopback(tx, rx, blocks_per_exec=BLOCKS_PER_EXEC)
    fl.run([])
    return max(fl.run([]).msps for _ in range(rounds))


def main() -> int:
    import jax
    from chip_smoke import card_line, require_gpu
    from gpu_sdr.config import configure_precision
    require_gpu(jax)
    configure_precision()
    print(f"card {card_line()}", flush=True)
    msps = bench_loopback_1000()
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "1000-tone synth+PFB channelizer loopback throughput",
        "value": round(msps, 1),
        "unit": "Msamples/s/chip",
        "vs_baseline": round(msps / 100.0, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
