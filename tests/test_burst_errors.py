"""Burst-mode TX gating and fault-injection error propagation tests."""

import numpy as np
import pytest

from gpu_sdr.client import files as Ufiles
from gpu_sdr.client import noise as Unoise
from gpu_sdr.engine import make_generator
from gpu_sdr.engine.channel import ChainChannel, DropoutChannel, IdealChannel
from gpu_sdr.params import AntennaParams, AntMode, WaveType


@pytest.fixture
def tmp_chdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_burst_gating():
    """burst_on/burst_off gates the TX comb with the right duty cycle and
    period, continuous across blocks."""
    rate = 1_000_000
    p = AntennaParams(mode=AntMode.TX, rate=rate, buffer_len=50_000,
                      freq=[100_000], ampl=[1.0],
                      wave_type=[WaveType.TONES],
                      burst_on=0.01, burst_off=0.03)
    gen = make_generator(p, block_len=50_000)
    x = np.concatenate(list(gen.blocks(4)))   # 200k samples = 5 periods
    period = int(0.04 * rate)
    on = int(0.01 * rate)
    active = np.abs(x) > 1e-6
    # duty cycle
    assert abs(active.mean() - 0.25) < 0.01
    # gate edges exactly at the period boundaries
    for k in range(4):
        assert active[k * period:k * period + on].all()
        assert not active[k * period + on:(k + 1) * period].any()


def test_dropout_errors_reach_h5(tmp_chdir):
    """Injected dropouts must appear as error coordinates in the H5 file
    and as warnings in the client reader."""
    rate = int(1e6)
    chan = ChainChannel([DropoutChannel(rate=rate, events_per_second=20,
                                        dropout_len=500, seed=3)])
    fn = Unoise.Get_noise([100_000], measure_t=0.5, rate=rate,
                          decimation=100, RF=0, mode="DIRECT",
                          output_filename="noise_err", channel=chan)
    data, errors = Ufiles.openH5file(fn, error_coord=True)
    assert errors is not None and len(errors) > 0, \
        "no error coordinates recorded"
    # error coords are (start_row, end_row) within the output stream
    assert all(0 <= a < b <= data.shape[1] for a, b in errors)
    # calculate_noise refuses errored data, like the reference
    with pytest.raises(ValueError):
        Unoise.calculate_noise(fn)
