"""VNA frequency-axis reconstruction parity: the analysis-side
effective-final-frequency formula must invert the kernel-side uint32
chirpness quantization exactly."""

import numpy as np

from gpu_sdr import golden
from gpu_sdr.client.vna import effective_final_frequency


def test_effective_final_frequency_inverts_quantization():
    rate = 100_000_000
    for f0, f1, n_points in [(-45_000_000, 45_000_000, 50_000),
                             (-400_000, 400_000, 1000),
                             (0, 30_000_000, 12345)]:
        cp = golden.ChirpParameter(f0, f1, rate, n_points, 0.1)
        eff = effective_final_frequency(f0, f1, n_points, rate)
        # reconstruct from the quantized chirpness the kernel actually used
        from_kernel = f0 + int(cp.chirpness) * (n_points - 1.0) * rate \
            / (2.0 ** 32 - 1)
        assert abs(eff - from_kernel) < 1e-6, (eff, from_kernel)
        # quantization moves the endpoint by less than one step spacing
        step_hz = (f1 - f0) / (n_points - 1)
        assert abs(eff - f1) < abs(step_hz) + 1


def test_freq_axis_points_match_phase_accumulator():
    """The linspace frequency axis of VNA_analysis lands each lock-in point
    on the frequency the accumulator actually generated for that step."""
    rate = 1_000_000
    f0, f1, n_points = -300_000, 300_000, 600
    cp = golden.ChirpParameter(f0, f1, rate, n_points, 0.06)
    eff = effective_final_frequency(f0, f1, n_points, rate)
    axis = np.linspace(f0, eff, n_points)
    # frequency of step k from the integer accumulator:
    # f_k = (f0_int + k*chirpness)/ (2^32-1) * rate
    k = np.arange(n_points, dtype=np.float64)
    f_k = (np.float64(int(cp.f0)) + k * np.float64(int(cp.chirpness))) \
        * rate / (2.0 ** 32 - 1)
    assert np.max(np.abs(axis - f_k)) < 1.0   # sub-Hz agreement
