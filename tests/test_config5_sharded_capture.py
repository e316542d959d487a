"""BASELINE config-5 style test: multi-tone dual-channel readout sharded
over (time, channels) with overlap-save collectives and triggered capture,
running through the standard measurement path on the 8-device virtual
mesh."""

import numpy as np
import pytest

from gpu_sdr.client import files as Ufiles
from gpu_sdr.client import triggers as Utrig
from gpu_sdr.measure import run_measurement
from gpu_sdr.parallel import make_mesh
from gpu_sdr.params import AntennaParams, AntMode, UsrpParams, WaveType


@pytest.fixture
def tmp_chdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _dual_command(rate, n_tones, samples):
    freqs = [int(f) for f in np.linspace(-400_000, 400_000, n_tones)]
    cmd = UsrpParams()
    for fe in ("A", "B"):
        setattr(cmd, f"{fe}_TXRX", AntennaParams(
            mode=AntMode.TX, rate=rate, buffer_len=100_000, samples=samples,
            freq=freqs, ampl=[1.0 / n_tones] * n_tones,
            wave_type=[WaveType.TONES] * n_tones, delay=1.0))
        setattr(cmd, f"{fe}_RX2", AntennaParams(
            mode=AntMode.RX, rate=rate, buffer_len=100_000, samples=samples,
            decim=100, pf_average=4, freq=freqs,
            wave_type=[WaveType.DIRECT] * n_tones, delay=1.0))
    return cmd, freqs


def test_sharded_dual_channel_measurement(tmp_chdir):
    """Dual-frontend 16-tone DIRECT readout, each frontend's demodulation
    sharded over a (2 time x 4 channels) mesh; both H5 groups filled and
    physically correct."""
    mesh = make_mesh((2, 4), ("time", "channels"))
    rate = 1_000_000
    cmd, freqs = _dual_command(rate, 16, 300_000)
    fn = run_measurement(cmd, "config5_dual", mesh=mesh)
    for ant in ("A_RX2", "B_RX2"):
        data = Ufiles.openH5file(fn, front_end=ant)
        assert data.shape[0] == 16
        steady = data[:, 8:]
        assert np.allclose(np.abs(steady), 1.0 / 16, atol=2e-3), ant


def test_sharded_with_trigger(tmp_chdir):
    """Sharded demodulation feeding the amplitude trigger: only windows
    around an injected glitch get recorded, and nglitch counts ONLY the
    stored glitch (the FIR warm-up transient at rows 0-1 is within
    window_t of the edge and must be neither stored nor counted)."""

    class SpikedTrigger(Utrig.amplitude_trigger):
        """Inject one amplitude glitch into the demodulated stream on
        its way into the trigger (the loopback itself is clean)."""

        def trigger(self, data, metadata):
            self._pkts = getattr(self, "_pkts", 0) + 1
            if self._pkts == 2:
                n_chan = metadata["channels"]
                data = np.array(data)
                # rows 500-505 of this packet -> global row ~1500
                data[500 * n_chan:505 * n_chan] *= 5.0
            return super().trigger(data, metadata)

    mesh = make_mesh((2, 4), ("time", "channels"))
    rate = 1_000_000
    cmd, freqs = _dual_command(rate, 8, 400_000)
    cmd.B_TXRX.mode = AntMode.OFF    # single frontend for this one
    cmd.B_RX2.mode = AntMode.OFF
    out_rate = rate / 100
    # 0.4 s of data at out_rate=10 kS/s -> fire once at 0.3 s accumulated
    trig = SpikedTrigger(sample_rate=out_rate, threshold=6,
                         channels=[0], accumulation_t=0.3,
                         window_t=0.002)
    fn = run_measurement(cmd, "config5_trig", mesh=mesh, trigger=trig)
    with Ufiles.bound_open(fn) as f:
        ds = f["raw_data0"]["A_RX2"]["data"]
        written = int(ds.attrs.get("samples", ds.shape[1]))
    # triggered capture stores only windows (noise + glitch), far fewer
    # samples than the full 4000-row stream
    assert 0 < written < 1000, written
    assert sum(trig.nglitch) >= 1
    # every counted glitch has a stored window (2 noise + nglitch)
    win = int(4 * 0.002 * out_rate)
    assert written >= (2 + sum(trig.nglitch)) * win - 1