"""Per-host sharded ingest (parallel/host_ingest.py): a native TCP feed
per process supplying its host-local time shard of every global block,
assembled with jax.make_array_from_process_local_data and demodulated by
the sharded chains.  Single-process geometry here (this host owns the
whole mesh); the two-process form runs in the multihost rehearsal
(tools/multihost_rehearsal.py phase 6)."""

import socket
import threading

import numpy as np
import pytest

from gpu_sdr import golden
from gpu_sdr.engine import make_demodulator, run_pipeline
from gpu_sdr.engine.sinks import MemorySink
from gpu_sdr.engine.sources import ArraySource
from gpu_sdr.ops import cplx
from gpu_sdr.parallel import make_mesh
from gpu_sdr.parallel.host_ingest import PerHostIngest, host_stream_for
from gpu_sdr.params import AntennaParams, AntMode, WaveType
from gpu_sdr.server import native

pytestmark = pytest.mark.skipif(not native.ingest_available(),
                                reason="native ingest library not built")

RATE = 1_000_000
FREQS = [100_000, -200_000, 50_000, -350_000]


def _rx(samples=400_000):
    return AntennaParams(mode=AntMode.RX, rate=RATE, decim=100,
                         pf_average=4, buffer_len=100_000, samples=samples,
                         freq=FREQS, wave_type=[WaveType.DIRECT] * 4)


def _send_all(port, payload, chunk=65536):
    with socket.create_connection(("127.0.0.1", port)) as s:
        view = memoryview(payload)
        for i in range(0, len(view), chunk):
            s.sendall(view[i:i + chunk])


def test_per_host_ingest_matches_array_source():
    """The per-host shard assembly must demodulate identically to the
    same recording served whole from memory."""
    rx = _rx()
    mesh = make_mesh((4, 2), ("time", "channels"))
    demod = make_demodulator(rx, mesh=mesh)
    L, nb = demod.plan.block_len, demod.plan.n_blocks
    t = np.arange(nb * L)
    rec = sum(a * np.exp(2j * np.pi * f * t / RATE)
              for f, a in zip(FREQS, [0.4, 0.25, 0.2, 0.1])
              ).astype(np.complex64)

    ref_sink = MemorySink()
    run_pipeline(make_demodulator(rx), ArraySource(rec), [ref_sink])

    with PerHostIngest(mesh, L) as ing:
        # single process: this host owns the whole mesh, so its stream is
        # the full recording
        payload = host_stream_for(rec, ing, nb)
        np.testing.assert_array_equal(payload, rec)
        producer = threading.Thread(
            target=_send_all, args=(ing.port, payload.tobytes()),
            daemon=True)
        producer.start()
        state = demod.init_state()
        outs, errs_total = [], 0
        for xb, errs in ing.device_blocks(L, nb):
            state, y = demod.step(state, xb)
            outs.append(cplx.to_np(y))
            errs_total += errs
        producer.join(timeout=10)
        assert not ing.aborted
    got = np.concatenate(outs, axis=0)
    assert errs_total == 0
    assert got.shape == ref_sink.data.shape
    assert golden.snr_db(ref_sink.data.ravel(), got.ravel()) > 90


def test_per_host_ingest_abort_ends_short():
    """A producer hangup ends the sharded stream short on every host —
    the SPMD demodulator must never advance on fabricated samples
    (reference abort, cpp/USRP_hardware_manager.cpp:1546-1560)."""
    rx = _rx()
    mesh = make_mesh((4, 2), ("time", "channels"))
    demod = make_demodulator(rx, mesh=mesh)
    L, nb = demod.plan.block_len, demod.plan.n_blocks
    assert nb >= 3
    rec = np.ones(nb * L, dtype=np.complex64)

    with PerHostIngest(mesh, L) as ing:
        payload = host_stream_for(rec, ing, nb)
        # producer dies 1.5 blocks in
        short = payload[:L + L // 2]
        producer = threading.Thread(
            target=_send_all, args=(ing.port, short.tobytes()),
            daemon=True)
        producer.start()
        n_got = 0
        errs_total = 0
        for xb, errs in ing.device_blocks(L, nb):
            n_got += 1
            errs_total += errs
        producer.join(timeout=10)
    assert ing.aborted
    assert n_got == 2                       # delivered + padded tail only
    assert ing.shortfall_blocks == nb - 2
    assert errs_total > 0                   # padded tail error-stamped
