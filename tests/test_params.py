"""Tests for the parameter structs and JSON protocol (reference parity:
cpp/USRP_JSON_interpreter.cpp, headers/USRP_server_settings.hpp)."""

import json

import pytest

from gpu_sdr.params import (
    AntennaParams, AntMode, DEFAULT_BUFFER_LEN, ParamError, UsrpParams,
    WaveType, chirp_steps_and_length, expected_samples_per_channel,
)


def make_direct_params():
    return AntennaParams(
        mode=AntMode.RX, rate=int(1e8), decim=100, pf_average=4,
        buffer_len=1000000, samples=int(1e8),
        freq=[10_000_000, 20_000_000], ampl=[1.0, 1.0],
        wave_type=[WaveType.DIRECT, WaveType.DIRECT])


def test_json_roundtrip():
    p = UsrpParams(usrp_number=3)
    p.A_RX2 = make_direct_params()
    p.A_TXRX = AntennaParams(
        mode=AntMode.TX, rate=int(1e8), buffer_len=1000000,
        freq=[10_000_000], ampl=[0.5], wave_type=[WaveType.TONES])
    s = p.to_json()
    d = json.loads(s)
    assert d["device"] == 3
    assert d["A_RX2"]["mode"] == "RX"
    assert d["A_RX2"]["rf"] == 0          # wire name for LO is 'rf'
    assert d["A_TXRX"]["wave_type"] == ["TONES"]
    q = UsrpParams.from_json(s)
    assert q.A_RX2.freq == [10_000_000, 20_000_000]
    assert q.A_RX2.wave_type == [WaveType.DIRECT, WaveType.DIRECT]
    assert q.A_TXRX.ampl == [0.5]
    assert q.usrp_number == 3


def test_validation_buffer_clamp():
    # out-of-range buffer lengths reset to default (chk_param semantics,
    # cpp/USRP_JSON_interpreter.cpp:282-288)
    p = make_direct_params()
    p.buffer_len = 10
    w = p.validate("A_RX2")
    assert p.buffer_len == DEFAULT_BUFFER_LEN
    assert w
    p.buffer_len = 0
    p.validate("A_RX2")
    assert p.buffer_len == DEFAULT_BUFFER_LEN


def test_validation_nyquist():
    p = AntennaParams(mode=AntMode.RX, rate=int(1e6),
                      freq=[2_000_000], wave_type=[WaveType.TONES],
                      fft_tones=16)
    with pytest.raises(ParamError):
        p.validate("A_RX2")


def test_validation_pfb_floors():
    p = AntennaParams(mode=AntMode.RX, rate=int(1e6), freq=[1000],
                      wave_type=[WaveType.TONES], fft_tones=0, pf_average=0)
    p.validate("A_RX2")
    assert p.fft_tones == 2
    assert p.pf_average == 1


def test_chirp_steps_and_length():
    # matches demodulator ctor (cpp/USRP_demodulator.cpp:192-206)
    p = AntennaParams(mode=AntMode.RX, rate=int(1e6), decim=1,
                      freq=[-400000], chirp_f=[400000], chirp_t=[0.1],
                      swipe_s=[1000], wave_type=[WaveType.CHIRP])
    steps, length = chirp_steps_and_length(p)
    assert steps == 1000
    assert length == int(0.1 * 1e6 / 1000)
    p.swipe_s = [0]
    steps, length = chirp_steps_and_length(p)
    assert steps == int(0.1 * 1e6)
    assert length == 1


def test_expected_samples():
    p = make_direct_params()
    assert expected_samples_per_channel(p) == int(1e8) // 100
    p2 = AntennaParams(mode=AntMode.RX, rate=int(1e8), samples=int(1e8),
                       fft_tones=1000, pf_average=4, freq=[0],
                       wave_type=[WaveType.TONES])
    assert expected_samples_per_channel(p2) == int(1e8) // 1000


def test_get_number_and_active():
    p = UsrpParams()
    p.A_TXRX = AntennaParams(mode=AntMode.TX, rate=1)
    p.A_RX2 = AntennaParams(mode=AntMode.RX, rate=1)
    assert p.get_number(AntMode.TX) == 1
    assert p.get_number(AntMode.RX) == 1
    assert p.is_A_active() and not p.is_B_active()
