"""Reading 'old mode' files (per-packet datasets written by the reference
server's H5_file_writer)."""

import h5py
import numpy as np

from gpu_sdr.client import files as Ufiles


def test_old_mode_read(tmp_path):
    fn = str(tmp_path / "old_style.h5")
    rng = np.random.default_rng(0)
    packets = [rng.standard_normal((2, 100)).astype(np.complex64)
               for _ in range(4)]
    with h5py.File(fn, "w") as f:
        g = f.create_group("raw_data0").create_group("A_RX2")
        g.attrs.create("mode", "RX")
        g.attrs.create("wave_type",
                       np.asarray(["DIRECT", "DIRECT"],
                                  dtype=h5py.string_dtype()))
        for i, p in enumerate(packets):
            ds = g.create_dataset(f"dataset_{i + 1}", data=p)
            ds.attrs.create("errors", 1 if i == 2 else 0)
    data, errs = Ufiles.openH5file(fn, error_coord=True)
    assert data.shape == (2, 400)
    assert np.allclose(data, np.concatenate(packets, axis=1))
    assert len(errs) == 1
    assert tuple(errs[0]) == (200, 300)
    # channel and sample slicing
    sel = Ufiles.openH5file(fn, ch_list=[1], start_sample=50,
                            last_sample=150)
    assert sel.shape == (1, 100)
    assert np.allclose(sel[0], np.concatenate(packets, axis=1)[1, 50:150])


def test_big_file_mode(tmp_path):
    """big_file=True returns the open handle + dataset (caller closes)."""
    import jax
    from gpu_sdr.engine import make_demodulator
    from gpu_sdr.engine.sources import ArraySource
    from gpu_sdr.measure import run_measurement
    from gpu_sdr.params import AntennaParams, AntMode, WaveType
    import os
    os.chdir(tmp_path)
    p = AntennaParams(mode=AntMode.RX, rate=1_000_000, buffer_len=50_000,
                      samples=100_000, decim=100, pf_average=4,
                      freq=[10_000], wave_type=[WaveType.DIRECT])
    from gpu_sdr.params import UsrpParams
    cmd = UsrpParams(); cmd.A_RX2 = p
    x = np.ones(100_000, dtype=np.complex64)
    fn = run_measurement(cmd, "bigfile", source=ArraySource(x))
    f, ds, errs = Ufiles.openH5file(fn, big_file=True, error_coord=True)
    try:
        assert ds.shape[0] == 1
        assert len(errs) == 0
    finally:
        f.close()


def test_get_trigger_info(tmp_path):
    import os
    os.chdir(tmp_path)
    from gpu_sdr.client.triggers import amplitude_trigger
    from gpu_sdr.client import noise as Unoise
    trig = amplitude_trigger(sample_rate=10_000, threshold=5,
                             channels=[0], accumulation_t=0.5,
                             window_t=0.002)
    fn = Unoise.Get_noise([10_000], measure_t=1.0, rate=1_000_000,
                          decimation=100, RF=0, mode="DIRECT",
                          output_filename="trig_info", trigger=trig)
    name, attrs = Ufiles.get_trigger_info(fn)
    assert name == "amplitude_trigger"
    assert "nglitch" in attrs
    assert "bounds" in attrs
