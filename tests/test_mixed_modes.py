"""Mixed wave types on one antenna — a capability BEYOND the reference
(which rejects them, cpp/USRP_demodulator.cpp:36-39): parallel per-type
demodulators over the same RX stream in one jitted step, with the
documented heterogeneous H5 layout (`data` for group 0, `mixed_<k>` for
the rest)."""

import numpy as np
import pytest

from gpu_sdr import golden
from gpu_sdr.client import files as Ufiles
from gpu_sdr.engine import make_demodulator
from gpu_sdr.engine.demodulator import MixedDemodulator
from gpu_sdr.engine.pipeline import run_pipeline_mixed
from gpu_sdr.engine.sinks import MemorySink
from gpu_sdr.engine.sources import ArraySource
from gpu_sdr.measure import run_measurement
from gpu_sdr.ops import cplx
from gpu_sdr.params import AntennaParams, AntMode, UsrpParams, WaveType

RATE = 1_000_000
F_TONES = [100_000, -200_000]
CHIRP = dict(f0=-300_000, f1=300_000, steps=1000, chirp_t=0.1)


def _mixed_rx(samples=400_000):
    return AntennaParams(
        mode=AntMode.RX, rate=RATE, buffer_len=100_000, samples=samples,
        decim=100, pf_average=4,
        freq=F_TONES + [CHIRP["f0"]],
        wave_type=[WaveType.DIRECT, WaveType.DIRECT, WaveType.CHIRP],
        # chirp descriptors are positionally aligned with the channel
        # list (the reference's parallel-array contract)
        chirp_f=[0, 0, CHIRP["f1"]], chirp_t=[0.0, 0.0, CHIRP["chirp_t"]],
        swipe_s=[0, 0, CHIRP["steps"]])


def _stimulus(n):
    """Tone comb + full-scale chirp superimposed."""
    comb = golden.tone_block(F_TONES, [0.4, 0.25], RATE, 0, n)
    cp = golden.ChirpParameter(CHIRP["f0"], CHIRP["f1"], RATE,
                               CHIRP["steps"], CHIRP["chirp_t"])
    return (comb + golden.chirp_signal(cp, 0, n)).astype(np.complex64), cp


def test_mixed_demodulator_groups_and_plan():
    d = make_demodulator(_mixed_rx())
    assert isinstance(d, MixedDemodulator)
    assert [g.wave_type for g in d.groups] == [WaveType.DIRECT,
                                               WaveType.CHIRP]
    assert d.groups[0].channel_idx == (0, 1)
    assert d.groups[1].channel_idx == (2,)
    # common block commensurate with both strides (decim=100 and
    # ppt = length*decim = 100*100)
    assert d.plan.block_len % 100 == 0
    assert d.plan.block_len % (100 * 100) == 0


def test_mixed_demodulation_matches_both_golden_models():
    rx = _mixed_rx()
    d = make_demodulator(rx)
    n = d.plan.n_blocks * d.plan.block_len
    x, cp = _stimulus(n)

    sinks = [[MemorySink()], [MemorySink()]]
    run_pipeline_mixed(d, ArraySource(x), sinks)
    tones = sinks[0][0].data               # (rows, 2)
    vna = sinks[1][0].data                 # (rows, 1)

    # DIRECT group vs the float64 streaming oracle
    gold = golden.GoldenDirectDemodulator(F_TONES, RATE, 100, 4)
    ref = gold(x).T                        # (rows, 2)
    m = min(len(ref), len(tones))
    assert golden.snr_db(ref[:m], tones[:m]) > 80

    # CHIRP group vs the chirp lock-in oracle
    z = golden.chirp_demod(cp, 0, x)
    gd = golden.GoldenVNADecimator(cp.length * 100)
    ref_c = gd(z)
    m = min(len(ref_c), len(vna))
    assert golden.snr_db(ref_c[:m], vna[:m, 0]) > 80


def test_mixed_measurement_h5_layout(tmp_path, monkeypatch):
    """run_measurement writes `data` (group 0) + `mixed_1` (group 1) with
    wave_type/channel_index attrs, readable through openH5file."""
    monkeypatch.chdir(tmp_path)
    rx = _mixed_rx()
    p = UsrpParams()
    p.A_RX2 = rx
    d = make_demodulator(rx)
    n = d.plan.n_blocks * d.plan.block_len
    x, cp = _stimulus(n)
    fn = run_measurement(p, filename="mixed_meas", source=ArraySource(x))

    streams = Ufiles.mixed_streams(fn)
    assert [s[0] for s in streams] == ["data", "mixed_1"]
    attrs = streams[1][1]
    assert list(attrs["wave_type"]) in (["CHIRP"], [b"CHIRP"])
    assert list(attrs["channel_index"]) == [2]

    tones = Ufiles.openH5file(fn)
    assert tones.shape[0] == 2
    # the chirp sweeps through the tone frequencies, so a few rows carry
    # crossing leakage: judge the bulk by the median
    assert abs(np.median(np.abs(tones[0, 16:])) - 0.4) < 3e-3
    assert abs(np.median(np.abs(tones[1, 16:])) - 0.25) < 3e-3
    vna = Ufiles.openH5file(fn, dataset="mixed_1")
    assert vna.shape[0] == 1
    z = golden.chirp_demod(cp, 0, x)
    gd = golden.GoldenVNADecimator(cp.length * 100)
    ref_c = gd(z)
    m = min(len(ref_c), vna.shape[1])
    assert golden.snr_db(ref_c[:m], vna[0, :m]) > 80


def test_mixed_on_mesh_matches_single_device():
    """Mixed wave types under a mesh: every group's SHARDED demodulator
    (time-sharded blocks, ppermute halos) consumes the same block inside one
    jitted step, and the outputs match the single-device mixed path."""
    from gpu_sdr.parallel import make_mesh
    mesh = make_mesh((2, 4), ("time", "channels"))
    rx = _mixed_rx()
    dm = make_demodulator(rx, mesh=mesh)
    ds = make_demodulator(rx)
    assert isinstance(dm, MixedDemodulator)
    # block splits evenly across time shards at every group's stride
    assert dm.plan.block_len % (2 * 100 * 100) == 0
    assert dm.plan.block_len == ds.plan.block_len
    B = dm.plan.block_len
    x, cp = _stimulus(3 * B)

    sm, ss = dm.init_state(), ds.init_state()
    for b in range(3):                    # cross-block carries exercised
        blk = cplx.from_np(x[b * B:(b + 1) * B])
        sm, ym = dm.step(sm, blk)
        ss, ys = ds.step(ss, blk)
        for g, (a, r) in enumerate(zip(ym, ys)):
            snr = golden.snr_db(cplx.to_np(r), cplx.to_np(a))
            assert snr > 80, f"block {b} group {g}: {snr:.1f} dB"
