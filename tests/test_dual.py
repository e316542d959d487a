"""Concurrent A/B frontends (engine/dual.py): both chains advance in
lock-step inside one jitted program on a shared sample timebase — the
reference's synchronized per-frontend thread chains
(cpp/USRP_server_link_threads.cpp:249-397)."""

import numpy as np

from gpu_sdr.client import files as Ufiles
from gpu_sdr.engine.dual import DualFused, plan_dual
from gpu_sdr.engine.fused import FusedLoopback
from gpu_sdr.engine.sinks import MemorySink
from gpu_sdr.measure import run_measurement
from gpu_sdr.params import AntennaParams, AntMode, UsrpParams, WaveType


def _fe(params, fe, tx_freq, rx_freq, rate=1_000_000, samples=400_000):
    setattr(params, f"{fe}_TXRX", AntennaParams(
        mode=AntMode.TX, rate=rate, buffer_len=100_000, samples=samples,
        freq=[tx_freq], ampl=[0.5], wave_type=[WaveType.TONES]))
    setattr(params, f"{fe}_RX2", AntennaParams(
        mode=AntMode.RX, rate=rate, buffer_len=100_000, samples=samples,
        decim=100, pf_average=4, freq=[rx_freq],
        wave_type=[WaveType.DIRECT]))


def test_plan_dual_engages_for_two_fusable_frontends():
    p = UsrpParams()
    _fe(p, "A", 100_000, 100_000)
    _fe(p, "B", -70_000, -70_000)
    pairs = plan_dual(p)
    assert pairs is not None
    assert [name for name, _, _ in pairs] == ["A_RX2", "B_RX2"]
    # single frontend -> no dual plan
    q = UsrpParams()
    _fe(q, "A", 100_000, 100_000)
    assert plan_dual(q) is None


def test_dual_matches_sequential_bit_exactly():
    """Lock-step execution must not change either chain's output."""
    p = UsrpParams()
    _fe(p, "A", 100_000, 100_000)
    _fe(p, "B", -70_000, -70_000)
    pairs = plan_dual(p)
    dual = DualFused(pairs)
    sinks = [MemorySink(), MemorySink()]
    res = dual.run([[sinks[0]], [sinks[1]]])
    assert len(res) == 2
    for (name, tx, rx), sink in zip(pairs, sinks):
        ref_sink = MemorySink()
        FusedLoopback(tx, rx).run([ref_sink], front_end=name[0])
        np.testing.assert_array_equal(ref_sink.data, sink.data)


def test_dual_shared_timebase_phase_alignment():
    """Both frontends demodulate their tone 1 kHz off-carrier; the
    residual rotations must start from the same t=0 (equal initial phase
    after transient), proving packet k of A and B covers the same sample
    indices."""
    df = 1_000
    p = UsrpParams()
    _fe(p, "A", 100_000, 100_000 - df)
    _fe(p, "B", -200_000, -200_000 - df)
    pairs = plan_dual(p)
    dual = DualFused(pairs)
    sa, sb = MemorySink(), MemorySink()
    dual.run([[sa], [sb]])
    a = sa.data[:, 0]
    b = sb.data[:, 0]
    out_rate = 1_000_000 / 100
    k = np.arange(len(a))
    expected = np.exp(2j * np.pi * df * k / out_rate)
    # drop the FIR start-up transient, compare phase trajectories
    pa = np.angle(a[16:] / expected[16:])
    pb = np.angle(b[16:] / expected[16:])
    assert np.ptp(pa) < 1e-3, "A rotation is not the closed form"
    assert np.ptp(pb) < 1e-3, "B rotation is not the closed form"
    assert np.abs(np.angle(np.exp(1j * (pa.mean() - pb.mean())))) < 1e-3, \
        "A/B timebases differ"


def test_run_measurement_dual_writes_both_groups(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    p = UsrpParams()
    _fe(p, "A", 100_000, 100_000)
    _fe(p, "B", -70_000, -70_000)
    fn = run_measurement(p, filename="dual_meas")
    da = Ufiles.openH5file(fn, front_end="A_RX2")
    db = Ufiles.openH5file(fn, front_end="B_RX2")
    assert da.shape == (1, 4_000) and db.shape == (1, 4_000)
    assert np.allclose(np.abs(da[0, 16:]), 0.5, atol=2e-3)
    assert np.allclose(np.abs(db[0, 16:]), 0.5, atol=2e-3)


# ----------------------------------------------------------------------
# Dual frontends UNDER A MESH: one SPMD program advances both chains
# (the multi-chip form of the reference's simultaneous A/B thread chains,
# cpp/USRP_server_link_threads.cpp:249-397)
# ----------------------------------------------------------------------

import jax
import pytest
from jax.sharding import Mesh

from gpu_sdr.engine.dual import DualShardedFused
from gpu_sdr.parallel.fused_sharded import ShardedFusedLoopback


def _mesh(t, c):
    devs = np.array(jax.devices()[:t * c]).reshape(t, c)
    return Mesh(devs, ("time", "channels"))


def _fe_pfb(params, fe, tx_freq, rx_freq, rate=64_000, samples=64_000,
            nfft=64, avg=4):
    setattr(params, f"{fe}_TXRX", AntennaParams(
        mode=AntMode.TX, rate=rate, buffer_len=rate, samples=samples,
        freq=[tx_freq], ampl=[0.5], wave_type=[WaveType.TONES]))
    setattr(params, f"{fe}_RX2", AntennaParams(
        mode=AntMode.RX, rate=rate, buffer_len=rate, samples=samples,
        fft_tones=nfft, pf_average=avg, freq=[rx_freq],
        wave_type=[WaveType.TONES]))


def test_plan_dual_engages_under_mesh():
    p = UsrpParams()
    _fe_pfb(p, "A", 3000, 3000)
    _fe_pfb(p, "B", -7000, -7000)
    pairs = plan_dual(p, mesh=_mesh(4, 2))
    assert pairs is not None
    assert [name for name, _, _ in pairs] == ["A_RX2", "B_RX2"]


def test_plan_dual_sequential_fallback_warns(caplog):
    """A non-fusable dual plan must WARN that timing semantics degrade."""
    import logging
    p = UsrpParams()
    _fe_pfb(p, "A", 3000, 3000)
    _fe_pfb(p, "B", -7000, -7000)
    p.B_RX2.wave_type = [WaveType.CHIRP]   # TONES->CHIRP is not fusable
    p.B_RX2.chirp_f = [-7000]
    p.B_RX2.chirp_t = [0.1]
    p.B_RX2.swipe_s = [100]
    with caplog.at_level(logging.WARNING, logger="gpu_sdr.dual"):
        assert plan_dual(p, mesh=_mesh(4, 2)) is None
    assert any("SEQUENTIALLY" in r.message for r in caplog.records)


def test_dual_sharded_matches_single_chain():
    """Lock-step SPMD execution must not change either chain's output."""
    p = UsrpParams()
    _fe_pfb(p, "A", 3000, 3000)
    _fe_pfb(p, "B", -7000, -7000)
    mesh = _mesh(4, 2)
    pairs = plan_dual(p, mesh=mesh)
    dual = DualShardedFused(pairs, mesh)
    assert dual.ok
    sa, sb = MemorySink(), MemorySink()
    res = dual.run([[sa], [sb]])
    assert len(res) == 2
    for (name, tx, rx), sink in zip(pairs, (sa, sb)):
        ref = MemorySink()
        ShardedFusedLoopback(
            tx, rx, mesh, blocks_per_exec=dual.blocks_per_exec,
            block_len=dual.block_len).run(
                [ref], front_end=name[0], n_blocks=dual.n_blocks)
        np.testing.assert_array_equal(ref.data, sink.data)


def test_dual_sharded_shared_timebase_phase_alignment(tmp_path,
                                                      monkeypatch):
    """Both frontends read a tone 125 Hz off their PFB bin through
    run_measurement(mesh=...): the residual rotations must track the same
    t=0, proving packet k of A and B covers the same sample indices."""
    monkeypatch.chdir(tmp_path)
    df = 125
    rate, nfft = 64_000, 64
    p = UsrpParams()
    _fe_pfb(p, "A", 3000 + df, 3000, rate=rate, nfft=nfft)
    _fe_pfb(p, "B", -7000 + df, -7000, rate=rate, nfft=nfft)
    mesh = _mesh(4, 2)
    fn = run_measurement(p, filename="dual_mesh", mesh=mesh)
    a = Ufiles.openH5file(fn, front_end="A_RX2")[0]
    b = Ufiles.openH5file(fn, front_end="B_RX2")[0]
    frame_rate = rate / nfft
    k = np.arange(len(a))
    expected = np.exp(2j * np.pi * df * k / frame_rate)
    pa = np.unwrap(np.angle(a / expected[:len(a)]))
    pb = np.unwrap(np.angle(b / expected[:len(b)]))
    # skip the PFB start-up frames (avg-1 windows)
    assert np.ptp(pa[4:]) < 1e-2, "A rotation is not the closed form"
    assert np.ptp(pb[4:]) < 1e-2, "B rotation is not the closed form"
    assert np.abs(np.angle(np.exp(1j * (pa[4:].mean() - pb[4:].mean())))) \
        < 1e-2, "A/B timebases differ"


def test_dual_lane_padded_chains_sliced():
    """Two fold chains with different comb sets inside DualFused: each
    frontend's sinks get its own 3-channel stream, matching the
    oracle."""
    from gpu_sdr import golden
    rate = 1_000_000
    freqs_a = [12_345, -67_891, 300_001]       # non-periodic -> fold
    freqs_b = [23_456, -45_678, 210_001]
    pairs = []
    for fe, fs in (("A_RX2", freqs_a), ("B_RX2", freqs_b)):
        tx = AntennaParams(mode=AntMode.TX, rate=rate,
                           buffer_len=100_000, samples=400_000,
                           freq=fs, ampl=[0.3] * 3,
                           wave_type=[WaveType.TONES] * 3)
        rx = AntennaParams(mode=AntMode.RX, rate=rate,
                           buffer_len=100_000, samples=400_000,
                           freq=fs, decim=100, pf_average=4,
                           wave_type=[WaveType.DIRECT] * 3)
        pairs.append((fe, tx, rx))
    d = DualFused(pairs, blocks_per_exec=2)
    assert [ch.path for ch in d.chains] == ["fold_chain"] * 2
    sinks = [MemorySink(), MemorySink()]
    d.run([[s] for s in sinks])
    for s, (_fe, tx, rx) in zip(sinks, pairs):
        assert s.data.shape == (4000, 3)
        x = golden.tone_block(tx.freq, tx.ampl, rate, 0, 400_000)
        assert golden.snr_db(golden.expected_stream(rx, x), s.data) > 90
