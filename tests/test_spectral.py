"""On-device Welch PSD vs scipy, and the jax backend of calculate_noise."""

import numpy as np
import pytest
from scipy import signal

from gpu_sdr.client import files as Ufiles
from gpu_sdr.client import noise as Unoise
from gpu_sdr.ops.spectral import batched_welch

RNG = np.random.default_rng(9)


@pytest.mark.parametrize("nperseg", [256, 500, 1000])
def test_welch_matches_scipy(nperseg):
    x = RNG.standard_normal((4, 6000)).astype(np.float32)
    fs = 12_500.0
    f_ref, p_ref = signal.welch(x, fs=fs, nperseg=nperseg,
                                detrend="linear", scaling="density")
    f, p = batched_welch(x, fs, nperseg)
    assert np.allclose(f, f_ref)
    assert np.max(np.abs(p - p_ref) / (np.abs(p_ref) + 1e-20)) < 1e-4


def test_welch_peak_location():
    fs = 10_000.0
    t = np.arange(20_000) / fs
    x = np.sin(2 * np.pi * 1234.0 * t)[None, :].astype(np.float32)
    f, p = batched_welch(x, fs, 2000)
    assert abs(f[np.argmax(p[0])] - 1234.0) < fs / 2000


def test_calculate_noise_jax_backend(tmp_path, monkeypatch):
    from gpu_sdr.engine.channel import ChainChannel, IdealChannel
    monkeypatch.chdir(tmp_path)
    rate = int(1e6)
    # real noise floor so both backends measure physics, not float eps
    chan = ChainChannel([IdealChannel()], noise_rms=1e-2, seed=11)
    fn = Unoise.Get_noise([100_000], measure_t=0.5, rate=rate,
                          decimation=100, RF=0, mode="DIRECT",
                          output_filename="noise_jax", channel=chan)
    Unoise.calculate_noise(fn, welch=4, backend="jax")
    info_j, freq_j, real_j, imag_j = Ufiles.get_noise(fn)
    Unoise.calculate_noise(fn, welch=4, backend="scipy")
    info_s, freq_s, real_s, imag_s = Ufiles.get_noise(fn)
    assert np.allclose(freq_j, freq_s)
    # dB spectra agree closely between backends
    assert np.max(np.abs(real_j[0] - real_s[0])) < 0.5


def test_best_split_aligned_first_stage():
    """A multiple-of-8 first stage with a 64..160 second stage when one
    exists; balanced fallback otherwise."""
    from gpu_sdr.ops.cplx import _best_split
    assert _best_split(1000) == (8, 125)
    assert _best_split(512) == (8, 64)
    n1, n2 = _best_split(100)       # no aligned candidate -> balanced
    assert (n1, n2) == (10, 10)


def test_two_stage_dft_1000_matches_numpy():
    """The headline (8,125) split must match numpy fft (full + scrambled)."""
    import numpy as np
    from gpu_sdr.ops import cplx
    from gpu_sdr.ops.cplx import DFT
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((3, 1000)) +
         1j * rng.standard_normal((3, 1000))).astype(np.complex64)
    ref = np.fft.fft(x, axis=-1)
    d = DFT(1000, two_stage=True)
    assert d.split == (8, 125)
    got = cplx.to_np(d(cplx.from_np(x)))
    assert np.abs(got - ref).max() < 2e-3 * np.abs(ref).max()
    # scrambled + scramble_index roundtrip
    sc = cplx.to_np(d.scrambled(cplx.from_np(x)))
    idx = d.scramble_index(np.arange(1000))
    assert np.abs(sc[:, idx] - ref).max() < 2e-3 * np.abs(ref).max()
