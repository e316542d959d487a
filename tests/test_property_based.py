"""Property-based tests (hypothesis): JSON protocol and wire framing
round-trip for arbitrary valid parameter values."""

import numpy as np
from hypothesis import given, settings, strategies as st

from gpu_sdr.params import AntennaParams, AntMode, UsrpParams, WaveType
from gpu_sdr.server import wire

freqs_st = st.lists(st.integers(-100_000_000, 100_000_000), min_size=1,
                    max_size=8)


@settings(max_examples=50, deadline=None)
@given(
    rate=st.sampled_from([int(1e6), int(1e7), int(1e8)]),
    gain=st.integers(-10, 40),
    samples=st.integers(0, 10 ** 12),
    decim=st.integers(0, 10_000),
    fft_tones=st.integers(0, 10_000),
    freq=freqs_st,
    delay=st.floats(0, 10, allow_nan=False),
    mode=st.sampled_from(list(AntMode)),
    wave=st.sampled_from([WaveType.DIRECT, WaveType.NODSP, WaveType.NOISE]),
)
def test_params_json_roundtrip_property(rate, gain, samples, decim,
                                        fft_tones, freq, delay, mode, wave):
    p = UsrpParams()
    p.A_RX2 = AntennaParams(
        mode=mode, rate=rate, gain=gain, samples=samples, decim=decim,
        fft_tones=fft_tones, freq=freq, delay=delay,
        wave_type=[wave] * len(freq),
        ampl=[1.0] * len(freq))
    q = UsrpParams.from_json(p.to_json())
    assert q.A_RX2.mode == mode
    assert q.A_RX2.rate == rate
    assert q.A_RX2.gain == gain
    assert q.A_RX2.samples == samples
    assert q.A_RX2.decim == decim
    assert q.A_RX2.freq == [int(f) for f in freq]
    assert q.A_RX2.wave_type == [wave] * len(freq)
    assert abs(q.A_RX2.delay - delay) < 1e-12


@settings(max_examples=50, deadline=None)
@given(
    usrp=st.integers(0, 100),
    code=st.sampled_from([b"A", b"B", b"C", b"D"]),
    pkt=st.integers(0, 2 ** 31 - 1),
    errors=st.integers(0, 1000),
    channels=st.integers(1, 10_000),
    n=st.integers(0, 256),
)
def test_wire_header_roundtrip_property(usrp, code, pkt, errors, channels,
                                        n):
    data = np.arange(n, dtype=np.complex64)
    buf = wire.encode_sync_packet(usrp, code, pkt, errors, channels, data)
    meta = wire.decode_sync_header(buf[:wire.HEADER_SIZE])
    assert meta["usrp_number"] == usrp
    assert meta["packet_number"] == pkt
    assert meta["errors"] == errors
    assert meta["channels"] == channels
    assert meta["length"] == n
    assert meta["front_end_code"] == wire.FRONT_END_NAMES[code]
    back = np.frombuffer(buf[wire.HEADER_SIZE:], dtype=np.complex64)
    assert np.array_equal(back, data)
