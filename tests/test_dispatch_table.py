"""The dispatch table cannot drift from the code:
engine/dispatch.plan_dispatch must predict, for a branch-covering
battery of measurements, exactly the execution path run_measurement
actually takes (measure.LAST_DISPATCH, recorded at each branch).

docs/07_dispatch.md renders the same table for humans.
"""

import numpy as np

from gpu_sdr import golden
from gpu_sdr import measure as measure_mod
from gpu_sdr.engine.dispatch import plan_dispatch
from gpu_sdr.engine.sinks import MemorySink
from gpu_sdr.engine.sources import ArraySource
from gpu_sdr.measure import run_measurement
from gpu_sdr.params import AntennaParams, AntMode, UsrpParams, WaveType

RATE = 1_000_000
RNG = np.random.default_rng(11)


def _assert_plan_matches(params, source=None, mesh=None, expect=None):
    """Plan == actual; returns the RX output stream (rows, channels)."""
    plan = plan_dispatch(params, source=source, mesh=mesh)
    sink = MemorySink()
    run_measurement(params, filename=None, source=source, mesh=mesh,
                    extra_sinks=[sink])
    actual = list(measure_mod.LAST_DISPATCH)
    assert [d.key() for d in plan] == actual, \
        f"plan {[d.key() for d in plan]} != actual {actual}"
    if expect is not None:
        assert actual == expect
    return sink.data


def _assert_golden(rx, x, out, min_db=90.0):
    """The output stream matches the float64 oracle fed the same input."""
    ref = golden.expected_stream(rx, x)
    n = min(len(ref), len(out))
    assert n > 0
    snr = golden.snr_db(ref[:n], out[:n])
    assert snr > min_db, f"{snr:.1f} dB"


def _looped(rec, n):
    """The first n samples of a recording replayed in a loop."""
    return np.resize(rec, n)


def _tones_direct(freqs, samples=200_000, **rx_extra):
    n = len(freqs)
    cmd = UsrpParams()
    cmd.A_TXRX = AntennaParams(
        mode=AntMode.TX, rate=RATE, buffer_len=100_000, samples=samples,
        freq=list(freqs), ampl=[1.0 / n] * n,
        wave_type=[WaveType.TONES] * n, delay=1.0)
    cmd.A_RX2 = AntennaParams(
        mode=AntMode.RX, rate=RATE, buffer_len=100_000, samples=samples,
        freq=list(freqs), decim=rx_extra.pop("decim", 100),
        pf_average=4, wave_type=[WaveType.DIRECT] * n, delay=1.0,
        **rx_extra)
    return cmd


def _tones_direct_input(cmd):
    tx = cmd.A_TXRX
    return golden.tone_block(tx.freq, tx.ampl, RATE, 0, tx.samples)


def test_loopback_fold_kernel():
    """An aperiodic comb into DIRECT readout rides the shift-fold chain
    and matches the oracle."""
    cmd = _tones_direct([12_345, -67_891, 300_001])   # gcd 1: aperiodic
    out = _assert_plan_matches(
        cmd, expect=[("A_RX2", "fused_loopback", "fold_chain")])
    _assert_golden(cmd.A_RX2, _tones_direct_input(cmd), out)


def test_loopback_fold_chain_startup_rows():
    """The fold chain restores the FIR's zero-history startup rows of the
    stream's first block."""
    cmd = _tones_direct([12_345, -67_891, 300_001], samples=100_000)
    out = _assert_plan_matches(
        cmd, expect=[("A_RX2", "fused_loopback", "fold_chain")])
    f = cmd.A_RX2.pf_average
    ref = golden.expected_stream(cmd.A_RX2, _tones_direct_input(cmd))
    assert golden.snr_db(ref[:f - 1], out[:f - 1]) > 80.0


def test_loopback_periodic_comb_replay_kernel():
    """A comb whose period divides the block takes the same fold chain."""
    # gcd 100_000 -> comb period 10 divides the block
    cmd = _tones_direct([-300_000, 100_000, 300_000])
    out = _assert_plan_matches(
        cmd, expect=[("A_RX2", "fused_loopback", "fold_chain")])
    _assert_golden(cmd.A_RX2, _tones_direct_input(cmd), out)


def test_loopback_chirp_wavetable():
    """CHIRP->CHIRP loopback runs the generic synth + lock-in scan."""
    kw = dict(rate=RATE, buffer_len=64_000, samples=256_000,
              freq=[-300_000], chirp_f=[300_000], chirp_t=[0.128],
              swipe_s=[64], delay=1.0)
    cmd = UsrpParams()
    cmd.A_TXRX = AntennaParams(mode=AntMode.TX, ampl=[0.7],
                               wave_type=[WaveType.CHIRP], **kw)
    cmd.A_RX2 = AntennaParams(mode=AntMode.RX, decim=1,
                              wave_type=[WaveType.CHIRP], **kw)
    out = _assert_plan_matches(
        cmd, expect=[("A_RX2", "fused_loopback", "generic_scan")])
    cp = golden.ChirpParameter(-300_000, 300_000, RATE, 64, 0.128)
    x = golden.chirp_signal(cp, 0, 256_000, scale=0.7)
    _assert_golden(cmd.A_RX2, x, out)


def test_loopback_channelizer_wavetable():
    """A bin-quantized comb into the PFB runs the generic synth +
    channelizer scan."""
    nfft, bin_hz = 1000, RATE // 1000
    freqs = [50 * bin_hz, -200 * bin_hz]
    cmd = UsrpParams()
    cmd.A_TXRX = AntennaParams(mode=AntMode.TX, rate=RATE,
                               buffer_len=128_000, freq=freqs,
                               ampl=[0.5, 0.25],
                               wave_type=[WaveType.TONES] * 2)
    cmd.A_RX2 = AntennaParams(mode=AntMode.RX, rate=RATE, fft_tones=nfft,
                              pf_average=4, buffer_len=128_000,
                              samples=256_000, freq=freqs,
                              wave_type=[WaveType.TONES] * 2)
    out = _assert_plan_matches(
        cmd, expect=[("A_RX2", "fused_loopback", "generic_scan")])
    x = golden.tone_block(freqs, [0.5, 0.25], RATE, 0, 256_000)
    _assert_golden(cmd.A_RX2, x, out)


def test_loopback_generic_scan_single_tone_pfb():
    nfft = 50
    cmd = UsrpParams()
    cmd.A_TXRX = AntennaParams(mode=AntMode.TX, rate=RATE,
                               buffer_len=100_000, freq=[100_000],
                               ampl=[1.0], wave_type=[WaveType.TONES])
    cmd.A_RX2 = AntennaParams(mode=AntMode.RX, rate=RATE, fft_tones=nfft,
                              pf_average=4, buffer_len=100_000,
                              samples=200_000, freq=[100_000],
                              wave_type=[WaveType.TONES])
    out = _assert_plan_matches(
        cmd, expect=[("A_RX2", "fused_loopback", "generic_scan")])
    x = golden.tone_block([100_000], [1.0], RATE, 0, 200_000)
    _assert_golden(cmd.A_RX2, x, out)


def _replay_rx(wave, samples=200_000, **extra):
    n_ch = len(extra.get("freq", [0]))
    blen = extra.pop("buffer_len", 100_000)
    return AntennaParams(mode=AntMode.RX, rate=RATE, buffer_len=blen,
                         samples=samples, wave_type=[wave] * n_ch, **extra)


def _looped_source(rec):
    src = ArraySource(rec)
    src.loop = True
    return src


def test_replay_direct_kernel_vs_scan():
    """A looped DIRECT recording replays through the resident scan."""
    rec = (RNG.standard_normal(100_000) +
           1j * RNG.standard_normal(100_000)).astype(np.complex64)
    cmd = UsrpParams()
    cmd.A_RX2 = _replay_rx(WaveType.DIRECT, decim=100, pf_average=4,
                           freq=[100_000, -250_000])
    out = _assert_plan_matches(
        cmd, source=_looped_source(rec),
        expect=[("A_RX2", "device_replay", "scan")])
    _assert_golden(cmd.A_RX2, _looped(rec, 200_000), out)


def test_replay_chirp_table():
    """A looped period-commensurate CHIRP recording: resident scan."""
    rec = (RNG.standard_normal(400_000) +
           1j * RNG.standard_normal(400_000)).astype(np.complex64)
    cmd = UsrpParams()
    cmd.A_RX2 = _replay_rx(WaveType.CHIRP, samples=400_000, decim=1,
                           freq=[-300_000], chirp_f=[300_000],
                           chirp_t=[0.1], swipe_s=[1000])
    out = _assert_plan_matches(
        cmd, source=_looped_source(rec),
        expect=[("A_RX2", "device_replay", "scan")])
    _assert_golden(cmd.A_RX2, rec, out)


def test_replay_channelizer_at():
    """A looped TONES recording: resident scan through the PFB."""
    nfft, bin_hz = 1000, RATE // 1000
    rec = (RNG.standard_normal(256_000) +
           1j * RNG.standard_normal(256_000)).astype(np.complex64)
    cmd = UsrpParams()
    cmd.A_RX2 = _replay_rx(WaveType.TONES, fft_tones=nfft, pf_average=4,
                           samples=256_000, buffer_len=128_000,
                           freq=[50 * bin_hz, -200 * bin_hz])
    out = _assert_plan_matches(
        cmd, source=_looped_source(rec),
        expect=[("A_RX2", "device_replay", "scan")])
    _assert_golden(cmd.A_RX2, rec, out)


def test_sharded_replay_channelizer_at():
    """Under a time-only mesh the same TONES replay rides the sharded
    scan (ppermute halo ring) — plan and actual must agree."""
    from gpu_sdr.parallel import make_mesh
    nfft, bin_hz = 1000, RATE // 1000
    rec = (RNG.standard_normal(256_000) +
           1j * RNG.standard_normal(256_000)).astype(np.complex64)
    cmd = UsrpParams()
    cmd.A_RX2 = _replay_rx(WaveType.TONES, fft_tones=nfft, pf_average=4,
                           samples=256_000, buffer_len=128_000,
                           freq=[50 * bin_hz, -200 * bin_hz])
    out = _assert_plan_matches(
        cmd, source=_looped_source(rec),
        mesh=make_mesh((8, 1), ("time", "channels")),
        expect=[("A_RX2", "sharded_replay", "scan")])
    _assert_golden(cmd.A_RX2, rec, out, min_db=85.0)


def test_replay_pfb_at():
    """nfft=500 (one-stage DFT) TONES replay: resident scan."""
    nfft, bin_hz = 500, RATE // 500
    rec = (RNG.standard_normal(200_000) +
           1j * RNG.standard_normal(200_000)).astype(np.complex64)
    cmd = UsrpParams()
    cmd.A_RX2 = _replay_rx(WaveType.TONES, fft_tones=nfft, pf_average=4,
                           samples=200_000, buffer_len=100_000,
                           freq=[50 * bin_hz, -200 * bin_hz])
    out = _assert_plan_matches(
        cmd, source=_looped_source(rec),
        expect=[("A_RX2", "device_replay", "scan")])
    _assert_golden(cmd.A_RX2, rec, out)


def test_segmented_replay_plan(monkeypatch):
    from gpu_sdr.engine import replay as replay_mod
    rec = (RNG.standard_normal(200_000) +
           1j * RNG.standard_normal(200_000)).astype(np.complex64)
    src = ArraySource(rec)
    monkeypatch.setattr(replay_mod, "device_replay_max_bytes",
                        lambda: 100_000 * 8)
    cmd = UsrpParams()
    cmd.A_RX2 = _replay_rx(WaveType.DIRECT, decim=100, pf_average=4,
                           freq=[100_000, -250_000])
    out = _assert_plan_matches(
        cmd, source=src, expect=[("A_RX2", "segmented_replay", None)])
    _assert_golden(cmd.A_RX2, rec, out)


def test_host_pipeline_white_noise():
    cmd = UsrpParams()
    cmd.A_RX2 = _replay_rx(WaveType.DIRECT, samples=100_000, decim=100,
                           pf_average=4, freq=[100_000])
    _assert_plan_matches(
        cmd, expect=[("A_RX2", "host_pipeline", None)])


def test_host_pipeline_mixed():
    cmd = UsrpParams()
    cmd.A_TXRX = AntennaParams(
        mode=AntMode.TX, rate=RATE, buffer_len=100_000, samples=100_000,
        freq=[100_000, -200_000], ampl=[0.5, 0.5],
        wave_type=[WaveType.TONES] * 2, delay=1.0)
    cmd.A_RX2 = AntennaParams(
        mode=AntMode.RX, rate=RATE, buffer_len=100_000, samples=100_000,
        decim=100, pf_average=4, freq=[100_000, -200_000],
        wave_type=[WaveType.DIRECT, WaveType.CHIRP],
        chirp_f=[0, 200_000], chirp_t=[0.0, 0.1], swipe_s=[0, 1000],
        delay=1.0)
    plan = plan_dispatch(cmd)
    assert plan[0].key() == ("A_RX2", "host_pipeline_mixed", None)


def test_dual_fused():
    freqs = [12_345, -67_891]
    cmd = UsrpParams()
    for tx_name, rx_name in (("A_TXRX", "A_RX2"), ("B_TXRX", "B_RX2")):
        setattr(cmd, tx_name, AntennaParams(
            mode=AntMode.TX, rate=RATE, buffer_len=100_000,
            samples=200_000, freq=freqs, ampl=[0.5, 0.5],
            wave_type=[WaveType.TONES] * 2, delay=1.0))
        setattr(cmd, rx_name, AntennaParams(
            mode=AntMode.RX, rate=RATE, buffer_len=100_000,
            samples=200_000, freq=freqs, decim=100, pf_average=4,
            wave_type=[WaveType.DIRECT] * 2, delay=1.0))
    _assert_plan_matches(
        cmd, expect=[("A_RX2", "dual_fused", "fold_chain"),
                     ("B_RX2", "dual_fused", "fold_chain")])


def test_sharded_paths():
    from gpu_sdr.parallel import make_mesh
    mesh = make_mesh((2, 4), ("time", "channels"))

    nfft, bin_hz = 1000, RATE // 1000
    freqs = [50 * bin_hz, -200 * bin_hz]
    cmd = UsrpParams()
    cmd.A_TXRX = AntennaParams(mode=AntMode.TX, rate=RATE,
                               buffer_len=100_000, samples=400_000,
                               freq=freqs, ampl=[0.5, 0.25],
                               wave_type=[WaveType.TONES] * 2, delay=1.0)
    cmd.A_RX2 = AntennaParams(mode=AntMode.RX, rate=RATE, fft_tones=nfft,
                              pf_average=4, buffer_len=100_000,
                              samples=400_000, freq=freqs,
                              wave_type=[WaveType.TONES] * 2, delay=1.0)
    _assert_plan_matches(cmd, mesh=mesh,
                         expect=[("A_RX2", "sharded_fused", "pfb_scan")])


def test_sharded_fused_channelizer_wavetable():
    """A bin-quantized comb on a TIME-ONLY mesh rides the sharded
    presum + DFT + select chain; a DIRECT recording the sharded scan."""
    from gpu_sdr.parallel import make_mesh
    mesh = make_mesh((8, 1), ("time", "channels"))
    nfft, bin_hz = 1000, RATE // 1000
    freqs = [50 * bin_hz, -200 * bin_hz]
    cmd = UsrpParams()
    cmd.A_TXRX = AntennaParams(mode=AntMode.TX, rate=RATE,
                               buffer_len=128_000, samples=256_000,
                               freq=freqs, ampl=[0.5, 0.25],
                               wave_type=[WaveType.TONES] * 2, delay=1.0)
    cmd.A_RX2 = AntennaParams(mode=AntMode.RX, rate=RATE, fft_tones=nfft,
                              pf_average=4, buffer_len=128_000,
                              samples=256_000, freq=freqs,
                              wave_type=[WaveType.TONES] * 2, delay=1.0)
    out = _assert_plan_matches(
        cmd, mesh=mesh, expect=[("A_RX2", "sharded_fused", "pfb_scan")])
    x = golden.tone_block(freqs, [0.5, 0.25], RATE, 0, 256_000)
    _assert_golden(cmd.A_RX2, x, out)

    rec = (RNG.standard_normal(400_000) +
           1j * RNG.standard_normal(400_000)).astype(np.complex64)
    cmd2 = UsrpParams()
    cmd2.A_RX2 = AntennaParams(mode=AntMode.RX, rate=RATE, decim=100,
                               pf_average=4, buffer_len=100_000,
                               samples=400_000,
                               freq=[100_000, -250_000],
                               wave_type=[WaveType.DIRECT] * 2)
    out2 = _assert_plan_matches(cmd2, source=ArraySource(rec), mesh=mesh,
                                expect=[("A_RX2", "sharded_replay", "scan")])
    _assert_golden(cmd2.A_RX2, rec, out2)


def test_replay_chirp_at_when_period_incommensurate():
    """A looped CHIRP recording whose chirp period does NOT divide the
    block replays through the same resident scan."""
    rec = (RNG.standard_normal(400_000) +
           1j * RNG.standard_normal(400_000)).astype(np.complex64)
    cmd = UsrpParams()
    # steps=300, t=0.03 -> period 30_000 samples; block 100_000
    cmd.A_RX2 = _replay_rx(WaveType.CHIRP, samples=400_000, decim=1,
                           freq=[-300_000], chirp_f=[300_000],
                           chirp_t=[0.03], swipe_s=[300])
    out = _assert_plan_matches(
        cmd, source=_looped_source(rec),
        expect=[("A_RX2", "device_replay", "scan")])
    _assert_golden(cmd.A_RX2, rec, out)


def test_sharded_fused_chirp_table():
    """A chirp loopback under a mesh rides the per-shard chirp synth +
    lock-in chain — plan and actual must agree."""
    from gpu_sdr.parallel import make_mesh
    mesh = make_mesh((4, 2), ("time", "channels"))
    kw = dict(rate=RATE, buffer_len=64_000, samples=256_000,
              freq=[-300_000], chirp_f=[300_000], chirp_t=[0.128],
              swipe_s=[128], delay=1.0)
    cmd = UsrpParams()
    cmd.A_TXRX = AntennaParams(mode=AntMode.TX, ampl=[0.7],
                               wave_type=[WaveType.CHIRP], **kw)
    cmd.A_RX2 = AntennaParams(mode=AntMode.RX, decim=1,
                              wave_type=[WaveType.CHIRP], **kw)
    out = _assert_plan_matches(
        cmd, mesh=mesh,
        expect=[("A_RX2", "sharded_fused", "chirp_lockin")])
    cp = golden.ChirpParameter(-300_000, 300_000, RATE, 128, 0.128)
    x = golden.chirp_signal(cp, 0, 256_000, scale=0.7)
    _assert_golden(cmd.A_RX2, x, out)


def test_sharded_replay_kernel_dispatch():
    """A looped DIRECT recording on a time-only mesh rides the sharded
    scan — plan and actual must agree."""
    from gpu_sdr.parallel import make_mesh
    mesh = make_mesh((8, 1), ("time", "channels"))
    rec = (RNG.standard_normal(256_000) +
           1j * RNG.standard_normal(256_000)).astype(np.complex64)
    cmd = UsrpParams()
    cmd.A_RX2 = _replay_rx(WaveType.DIRECT, decim=100, pf_average=4,
                           samples=512_000, buffer_len=128_000,
                           freq=[100_000, -250_000])
    out = _assert_plan_matches(
        cmd, source=_looped_source(rec), mesh=mesh,
        expect=[("A_RX2", "sharded_replay", "scan")])
    _assert_golden(cmd.A_RX2, _looped(rec, 512_000), out)
