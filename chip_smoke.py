#!/usr/bin/env python3
"""Bring-up check: the readout chain on one NVIDIA GPU, end to end.

    python chip_smoke.py                P0-P3 on one card
    python chip_smoke.py --four-cards   P4 only (needs four cards)

P0  Refuses anything but a GPU.  Prints the card and its power limit (from
    nvidia-smi, in a child process that stays off JAX), the JAX version,
    the matmul precision, the compile-cache directory and which data
    plane (native ring or Python fallback) serves the server.
P1  The TCP server in-process and a client sending three requests at the
    reference's deployment widths: the 1000-tone 100 Msps PFB stress
    configuration (scripts/network_test.py) over 1e8 samples, a 100-tone
    DIRECT readout, and a CHIRP sweep at the scripts/get_VNA.py defaults.
    The leading window of each stream is compared with golden.py.
P2  run_measurement over the 1000-tone configuration fed from a recording
    resident on the device and from host-fed ingest, against golden.py.
P3  Each plain XLA path that replaced a hand-written kernel, at
    production widths, against golden.py (gpu_sdr/parity.py).
P4  With --four-cards and nothing else: the 1000-tone loopback through
    run_measurement on a (1, 4) mesh against the one-card result.

Every phase prints one line (shapes, SNR, compile and run seconds,
peak_bytes_in_use, card).  If any phase fails the script exits non-zero
and prints no result; otherwise the last line is one JSON object naming
the device.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import queue
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

SNR_BAR_DB = 90.0
RATE = 100_000_000
# the reference's PFB throughput stress test (scripts/network_test.py)
N_TONES, NFFT, PF_AVERAGE, BUFFER_LEN = 1000, 1024, 4, 1_000_000
STRESS_SAMPLES = 100_000_000          # one second of the radio's stream
HOSTFED_SAMPLES = 20_000_000
WARMUP_BLOCKS = 8                     # one execution of the K=8 chains
TONES_WINDOW = 64 * NFFT              # leading samples compared to golden


def card_line() -> str:
    """The cards' name and power limit as nvidia-smi reports them, read
    in a child process so that only this process holds the device."""
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    lines = [ln.strip() for ln in p.stdout.splitlines() if ln.strip()]
    if p.returncode != 0 or not lines:
        return f"nvidia-smi failed (rc {p.returncode}): {p.stderr.strip()}"
    return " | ".join(lines)


def require_gpu(jax) -> None:
    """Exit (non-zero, no result) unless JAX's first device is a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU; JAX found "
            f"{dev.platform} ({dev.device_kind})")


def result_line(jax) -> str:
    dev = jax.devices()[0]
    return json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}})


class Report:
    """One line per phase; remembers failures."""

    def __init__(self, card: str):
        self.card = card
        self.failed = []

    def line(self, name, shapes, snr_db=None, compile_s=None, run_s=None):
        import jax
        stats = jax.devices()[0].memory_stats() or {}
        snr = "n/a" if snr_db is None else f"{snr_db:.1f} dB"
        cs = "n/a" if compile_s is None else f"{compile_s:.2f} s"
        rs = "n/a" if run_s is None else f"{run_s:.6f} s"
        print(f"{name} | {shapes} | snr {snr} | compile {cs} | run {rs} | "
              f"peak_bytes_in_use {stats.get('peak_bytes_in_use', 'n/a')} "
              f"| card {self.card}", flush=True)
        if snr_db is not None and not snr_db >= SNR_BAR_DB:
            self.fail(name, f"SNR {snr_db:.1f} dB below {SNR_BAR_DB} dB")

    def fail(self, name, why):
        self.failed.append(name)
        print(f"FAIL {name}: {why}", flush=True)

    def run(self, name, fn, *args):
        try:
            fn(self, *args)
        except Exception as e:  # a phase's failure must not hide the next
            import traceback
            traceback.print_exc()
            self.fail(name, f"{type(e).__name__}: {e}")


class HeadSink:
    """Keeps the first `keep` rows of a stream, counts every row and
    checks that every value is finite (the full stream is not held)."""

    def __init__(self, keep: int):
        self.keep, self.rows, self.finite = keep, 0, True
        self._head = []

    def on_start(self, channels, total_rows):
        pass

    def on_packet(self, meta, data):
        d = np.asarray(data)
        self.finite &= bool(np.isfinite(d).all())
        if self.rows < self.keep:
            self._head.append(np.array(d[:self.keep - self.rows]))
        self.rows += len(d)

    def on_end(self):
        pass

    @property
    def head(self) -> np.ndarray:
        return np.concatenate(self._head) if self._head else np.zeros((0, 0))


# ----------------------------------------------------------------------
# Requests at the reference's deployment widths
# ----------------------------------------------------------------------

def _span(n):
    return [int(t) for t in np.linspace(-RATE / 2 * 0.9, RATE / 2 * 0.9, n)]


def tones_command(samples: int):
    """scripts/network_test.py:30-50 at its defaults (1000 channels,
    100 Msps, fft_tones 1024, pf_average 4, buffer_len 1e6)."""
    from gpu_sdr.params import AntennaParams, AntMode, UsrpParams, WaveType
    tones = _span(N_TONES)
    cmd = UsrpParams()
    cmd.A_TXRX = AntennaParams(
        mode=AntMode.TX, rate=RATE, buffer_len=BUFFER_LEN, samples=samples,
        freq=tones, ampl=[1.0 / N_TONES] * N_TONES,
        wave_type=[WaveType.TONES] * N_TONES, delay=1.0)
    cmd.A_RX2 = AntennaParams(
        mode=AntMode.RX, rate=RATE, buffer_len=BUFFER_LEN, samples=samples,
        fft_tones=NFFT, pf_average=PF_AVERAGE, freq=tones,
        wave_type=[WaveType.TONES] * N_TONES, delay=1.0)
    return cmd


def direct_command(samples: int, n_tones: int = 100):
    """A DIRECT readout of 100 tones, decim 100, pf_average 4."""
    from gpu_sdr.params import AntennaParams, AntMode, UsrpParams, WaveType
    tones = _span(n_tones)
    cmd = UsrpParams()
    cmd.A_TXRX = AntennaParams(
        mode=AntMode.TX, rate=RATE, buffer_len=BUFFER_LEN, samples=samples,
        freq=tones, ampl=[1.0 / n_tones] * n_tones,
        wave_type=[WaveType.TONES] * n_tones, delay=1.0)
    cmd.A_RX2 = AntennaParams(
        mode=AntMode.RX, rate=RATE, buffer_len=BUFFER_LEN, samples=samples,
        decim=100, pf_average=4, freq=tones,
        wave_type=[WaveType.DIRECT] * n_tones, delay=1.0)
    return cmd


def vna_command(samples: int | None = None):
    """A CHIRP sweep at the scripts/get_VNA.py defaults: -45..+45 MHz,
    50e3 points over 10 s at 100 Msps, decimation on, LO 300 MHz.
    `samples` shortens the acquisition without changing its shapes."""
    from gpu_sdr.client.vna import compose_vna_command
    cmd = compose_vna_command(-45e6, 45e6, 10.0, 50_000, 0, Rate=RATE,
                              decimation=True, RF=300e6)
    if samples is not None:
        cmd.A_TXRX.samples = cmd.A_RX2.samples = int(samples)
    return cmd


def _expected_rows(cmd) -> int:
    from gpu_sdr.engine.planner import plan_blocks
    p = copy.deepcopy(cmd)
    p.validate()
    return plan_blocks(p.A_RX2).total_out_rows


def _golden_snr(rx, x, head) -> float:
    from gpu_sdr import golden
    ref = golden.expected_stream(rx, x)
    n = min(len(ref), len(head))
    if n == 0:
        raise RuntimeError("no output rows to compare")
    return golden.snr_db(ref[:n], head[:n])


def _check_stream(sink, expect_rows):
    if sink.rows != expect_rows:
        raise RuntimeError(f"{sink.rows} rows streamed, {expect_rows} "
                           f"expected")
    if not sink.finite:
        raise RuntimeError("non-finite values in the stream")


# ----------------------------------------------------------------------
# P0
# ----------------------------------------------------------------------

def data_plane() -> str:
    """Load the native data plane, building it with the system C++
    compiler when it is missing; report which plane serves."""
    from gpu_sdr.server import native as native_mod
    if native_mod.load_library() is None:
        root = os.path.dirname(os.path.abspath(__file__))
        out = os.path.join(root, "native", "build", "libsdr_native.so")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        src = [os.path.join(root, "native", f)
               for f in ("stream_server.cpp", "stream_ingest.cpp")]
        try:
            subprocess.run(["c++", "-O3", "-std=c++17", "-shared", "-fPIC",
                            "-pthread", "-I", os.path.join(root, "native"),
                            *src, "-o", out],
                           check=True, capture_output=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            return f"Python fallback (native build failed: {e})"
    if native_mod.available():
        return "native ring"
    return "Python fallback"


def p0(rep: Report, plane_holder: dict):
    import jax
    from gpu_sdr.config import (compile_cache_dir, configure_precision,
                                matmul_precision)
    configure_precision()
    plane_holder["plane"] = data_plane()
    rep.line("P0 setup",
             f"jax {jax.__version__}, {len(jax.devices())} x "
             f"{jax.devices()[0].device_kind}, matmul precision "
             f"{matmul_precision()}, compile cache {compile_cache_dir()}, "
             f"data plane {plane_holder['plane']}")


# ----------------------------------------------------------------------
# P1: server + client
# ----------------------------------------------------------------------

def _serve(srv, conn, cmd, keep: int, timeout_s: float = 900.0):
    """Send one command, collect its packets from the data socket in
    memory until the server's end of measurement; (sink, seconds)."""
    worker = threading.Thread(target=srv.serve_one,
                              kwargs={"timeout": 60.0}, daemon=True)
    worker.start()
    sink = HeadSink(keep)
    expect = _expected_rows(cmd)
    t0 = time.perf_counter()
    conn.send_params(cmd)
    while sink.rows < expect:
        if time.perf_counter() - t0 > timeout_s:
            raise TimeoutError(f"{sink.rows}/{expect} rows after "
                               f"{timeout_s} s")
        try:
            meta, data = conn.data_queue.get(timeout=1.0)
        except queue.Empty:
            if conn.error_status.is_set():
                raise RuntimeError("server reported an error")
            continue
        sink.on_packet(meta, data.reshape(-1, meta["channels"]))
    if not conn.end_of_measure.wait(timeout=60.0) or \
            conn.error_status.is_set():
        raise RuntimeError("no clean end of measurement from the server")
    dt = time.perf_counter() - t0
    worker.join(timeout=60.0)
    _check_stream(sink, expect)
    return sink, dt


def p1(rep: Report):
    from gpu_sdr import golden
    from gpu_sdr.client.connections import Connection
    from gpu_sdr.params import chirp_steps_and_length
    from gpu_sdr.server.main import Server
    srv = Server(async_port=0, data_port=0, file_writing=False,
                 tcp_streaming=True, host="127.0.0.1")
    srv.start()
    try:
        conn = Connection(host="127.0.0.1", async_port=srv.ports[0],
                          sync_port=srv.ports[1])
        try:
            # 1000-tone PFB stress configuration
            L = BUFFER_LEN  # planner rounds it; the warm-up is 8 blocks
            _, c_s = _serve(srv, conn, tones_command(WARMUP_BLOCKS * L), 1)
            cmd = tones_command(STRESS_SAMPLES)
            sink, r_s = _serve(srv, conn, cmd, TONES_WINDOW // NFFT)
            rx = cmd.A_RX2
            x = golden.tone_block(rx.freq, cmd.A_TXRX.ampl, RATE, 0,
                                  TONES_WINDOW)
            rep.line("P1 server tones_1000",
                     f"{N_TONES} tones, fft {NFFT}, {STRESS_SAMPLES} samples "
                     f"-> {sink.rows} x {N_TONES} rows over TCP, "
                     f"{STRESS_SAMPLES / r_s / 1e6:.1f} Msps wall",
                     _golden_snr(rx, x, sink.head), c_s, r_s)

            # 100-tone DIRECT readout
            window = 100_000
            _, c_s = _serve(srv, conn, direct_command(WARMUP_BLOCKS * L), 1)
            cmd = direct_command(HOSTFED_SAMPLES)
            sink, r_s = _serve(srv, conn, cmd, window // 100)
            rx = cmd.A_RX2
            x = golden.tone_block(rx.freq, cmd.A_TXRX.ampl, RATE, 0, window)
            rep.line("P1 server direct_100",
                     f"100 tones, decim 100, {HOSTFED_SAMPLES} samples -> "
                     f"{sink.rows} x 100 rows over TCP, "
                     f"{HOSTFED_SAMPLES / r_s / 1e6:.1f} Msps wall",
                     _golden_snr(rx, x, sink.head), c_s, r_s)

            # get_VNA.py default sweep
            cmd = vna_command()
            rx = cmd.A_RX2
            steps, length = chirp_steps_and_length(rx)
            _, c_s = _serve(srv, conn, vna_command(WARMUP_BLOCKS * L), 1)
            points = 10
            sink, r_s = _serve(srv, conn, cmd, points)
            cp = golden.ChirpParameter(rx.freq[0], rx.chirp_f[0], RATE,
                                       steps, rx.chirp_t[0])
            x = golden.chirp_signal(cp, 0, points * length * rx.decim,
                                    scale=cmd.A_TXRX.ampl[0])
            rep.line("P1 server vna_sweep",
                     f"{steps} points x {length} samples, {rx.samples} "
                     f"samples -> {sink.rows} rows over TCP, "
                     f"{rx.samples / r_s / 1e6:.1f} Msps wall",
                     _golden_snr(rx, x, sink.head), c_s, r_s)
        finally:
            conn.close()
    finally:
        srv.close()


# ----------------------------------------------------------------------
# P2: recording on the device, host-fed ingest
# ----------------------------------------------------------------------

def _record_comb(cmd, n_blocks: int) -> np.ndarray:
    """n_blocks of the command's TX comb, synthesized by the framework's
    generator on the device (the recording P2 replays)."""
    import jax
    from gpu_sdr.engine import make_generator
    from gpu_sdr.engine.planner import plan_blocks
    from gpu_sdr.ops import cplx
    L = plan_blocks(cmd.A_RX2).block_len
    gen = make_generator(cmd.A_TXRX, block_len=L)
    st = gen.init_state()
    out = []
    for _ in range(n_blocks):
        st, x = gen.step(st)
        out.append(cplx.to_np(jax.block_until_ready(x)))
    return np.concatenate(out).astype(np.complex64)


def _measure(cmd, source, keep):
    from gpu_sdr import measure
    sink = HeadSink(keep)
    t0 = time.perf_counter()
    measure.run_measurement(cmd, None, source=source, extra_sinks=[sink])
    return sink, time.perf_counter() - t0, measure.last_dispatch()


def p2(rep: Report, plane: str):
    from gpu_sdr.engine.planner import plan_blocks
    from gpu_sdr.engine.sources import ReplaySource
    keep = TONES_WINDOW // NFFT
    cmd = tones_command(STRESS_SAMPLES)
    L = plan_blocks(cmd.A_RX2).block_len
    rec = _record_comb(cmd, 16)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "comb_1000.npy")
        np.save(path, rec)
        _, c_s, _ = _measure(tones_command(WARMUP_BLOCKS * L),
                             ReplaySource(path, loop=True), 1)
        sink, r_s, path_taken = _measure(cmd, ReplaySource(path, loop=True),
                                         keep)
    _check_stream(sink, _expected_rows(cmd))
    rep.line("P2 device_replay tones_1000",
             f"recording {len(rec)} samples resident, {STRESS_SAMPLES} "
             f"samples -> {sink.rows} x {N_TONES} rows, path {path_taken}, "
             f"{STRESS_SAMPLES / r_s / 1e6:.1f} Msps wall",
             _golden_snr(cmd.A_RX2, rec[:TONES_WINDOW], sink.head), c_s,
             r_s)

    cmd = tones_command(HOSTFED_SAMPLES)
    n_blocks = plan_blocks(cmd.A_RX2).n_blocks
    stream = np.resize(rec, n_blocks * L)
    src, producer = _hostfed_source(stream, L, plane)
    try:
        sink, r_s, path_taken = _measure(cmd, src, keep)
    finally:
        if producer is not None:
            producer.join(timeout=60.0)
        if hasattr(src, "close"):
            src.close()
    _check_stream(sink, _expected_rows(cmd))
    rep.line("P2 host_fed tones_1000",
             f"{n_blocks} buffers x {L} samples via "
             f"{type(src).__name__}, path {path_taken}, "
             f"{HOSTFED_SAMPLES / r_s / 1e6:.1f} Msps wall (compile "
             f"shared with P1)",
             _golden_snr(cmd.A_RX2, stream[:TONES_WINDOW], sink.head),
             None, r_s)


class _HostBlocks:
    """Host-memory blocks handed to the pipeline one by one: host-fed
    ingest when the native TCP receiver is unavailable."""

    def __init__(self, data):
        self.data_ = data

    def blocks(self, block_len, n_blocks):
        for i in range(n_blocks):
            yield self.data_[i * block_len:(i + 1) * block_len]


def _hostfed_source(stream: np.ndarray, L: int, plane: str):
    """A SocketIngestSource fed by a producer thread over localhost TCP
    (the server's --ingest path) when the native ring is built; else
    host-memory blocks.  Returns (source, producer thread or None)."""
    if plane != "native ring":
        return _HostBlocks(stream), None
    import socket
    from gpu_sdr.engine.ingest import SocketIngestSource
    # the ring holds the whole stream: this check is about the path's
    # output, not about pacing a producer to the pipeline's rate
    src = SocketIngestSource(block_len=L, port=0,
                             queue_len=len(stream) // L + 1)

    def produce():
        with socket.create_connection(("127.0.0.1", src.port)) as s:
            s.sendall(memoryview(np.ascontiguousarray(stream)).cast("B"))

    t = threading.Thread(target=produce, name="ingest_producer",
                         daemon=True)
    t.start()
    return src, t


# ----------------------------------------------------------------------
# P3: plain paths that replaced the kernels
# ----------------------------------------------------------------------

def p3(rep: Report):
    from gpu_sdr import parity
    for name, check in parity.production_checks():
        try:
            r = check()
        except Exception as e:
            import traceback
            traceback.print_exc()
            rep.fail(f"P3 {name}", f"{type(e).__name__}: {e}")
            continue
        rep.line(f"P3 {r.name}", f"{r.shapes}, {r.msps:.1f} Msps",
                 r.snr_db, r.compile_s, r.run_s)


# ----------------------------------------------------------------------
# P4: four cards
# ----------------------------------------------------------------------

def p4(rep: Report):
    import jax
    from gpu_sdr import golden
    from gpu_sdr import measure
    from gpu_sdr.parallel import make_mesh
    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, JAX has "
                           f"{len(jax.devices())}")
    keep = TONES_WINDOW // NFFT
    mesh = make_mesh((1, 4))
    cmd = tones_command(HOSTFED_SAMPLES)
    one = HeadSink(10 ** 9)
    measure.run_measurement(cmd, None, extra_sinks=[one])
    t0 = time.perf_counter()
    four = HeadSink(10 ** 9)
    measure.run_measurement(copy.deepcopy(cmd), None, extra_sinks=[four],
                            mesh=mesh)
    c_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    four2 = HeadSink(keep)
    measure.run_measurement(copy.deepcopy(cmd), None, extra_sinks=[four2],
                            mesh=mesh)
    r_s = time.perf_counter() - t0
    path = measure.last_dispatch()
    _check_stream(four, _expected_rows(cmd))
    snr_one = golden.snr_db(one.head, four.head)
    x = golden.tone_block(cmd.A_RX2.freq, cmd.A_TXRX.ampl, RATE, 0,
                          TONES_WINDOW)
    rep.line("P4 mesh(1,4) vs one card",
             f"{N_TONES} tones, {HOSTFED_SAMPLES} samples -> {four.rows} "
             f"rows, path {path}, {HOSTFED_SAMPLES / r_s / 1e6:.1f} Msps "
             f"wall, vs one card {snr_one:.1f} dB",
             min(snr_one, _golden_snr(cmd.A_RX2, x, four2.head)), c_s, r_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only P4, the (1, 4) mesh against one card")
    args = ap.parse_args(argv)

    import jax
    require_gpu(jax)
    rep = Report(card_line())
    print(f"card {rep.card}", flush=True)
    plane = {"plane": "unknown"}
    rep.run("P0", p0, plane)
    if args.four_cards:
        rep.run("P4", p4)
    else:
        rep.run("P1", p1)
        rep.run("P2", p2, plane["plane"])
        rep.run("P3", p3)
    if rep.failed:
        print(f"chip_smoke: failed phases: {', '.join(rep.failed)}",
              file=sys.stderr)
        return 1
    print(result_line(jax), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
