"""Multi-process (multi-"host") rehearsal of the sharded fused chain.

Launched N times (once per simulated host) by tests/test_multihost.py or
by hand:

  python tools/multihost_rehearsal.py --coordinator localhost:PORT \
      --num_processes 2 --process_id 0  &
  python tools/multihost_rehearsal.py --coordinator localhost:PORT \
      --num_processes 2 --process_id 1

Each process exposes `--devices_per_process` virtual CPU devices (default
4); jax.distributed joins them into one cluster and the (time, channels)
mesh (`--mesh TxC`, default 2x4) spans all processes, so the sharded
chains run exactly as they would across hosts.  Every process checks
ITS addressable output shards against the float64 golden oracle and
prints one JSON line per phase:

  1. sharded fused TONES->DIRECT chain, shard-by-shard golden check
  2. BASELINE config-5 dual-channel readout through run_measurement(mesh=)
     with both frontends advanced LOCK-STEP in one SPMD program; asserts
     the A/B packets are sample-aligned (shared-tone phase test)
  3. remaining sharded mode families (TONES select / NOISE decim / CHIRP)
  4. MIXED wave types under the cross-process mesh
  5. cross-process mesh-dispatched replay (ShardedDeviceReplay) — a
     recording is this framework's --sw_loop
  6. per-host sharded ingest: every process's native TCP receiver is fed
     a DISTINCT stream (its host-local time shard) and the globally
     assembled blocks golden-check through the sharded demodulator
"""

import argparse
import json
import os
import sys


def _parse_args():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--devices_per_process", type=int, default=4)
    ap.add_argument("--mesh", default="2x4",
                    help="time x channels mesh shape, e.g. 4x4 or 2x8")
    return ap.parse_args()


ARGS = _parse_args()

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + f" --xla_force_host_platform_device_count={ARGS.devices_per_process}"
).strip()

import numpy as np  # noqa: E402
import jax          # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SNR_BAR = 90.0      # same bar as the single-process golden tests


def main():
    args = ARGS
    T, Kc = (int(v) for v in args.mesh.lower().split("x"))

    from gpu_sdr.parallel.distributed import initialize_distributed
    initialize_distributed(coordinator_address=args.coordinator,
                           num_processes=args.num_processes,
                           process_id=args.process_id)
    assert len(jax.local_devices()) == args.devices_per_process, \
        jax.local_devices()
    n_dev = args.devices_per_process * args.num_processes
    assert jax.device_count() == n_dev, jax.devices()
    assert T * Kc == n_dev, f"mesh {args.mesh} != {n_dev} devices"

    from gpu_sdr import golden
    from gpu_sdr.parallel import make_mesh
    from gpu_sdr.parallel.fused_sharded import ShardedFusedDirect
    from gpu_sdr.params import AntennaParams, AntMode, WaveType

    rate, decim, pfa = 1_000_000, 10, 4
    # 8 tones so every mesh channel width in {1,2,4,8} divides the set
    freqs = [12_345, -67_891, 300_001, -111_111,
             45_007, -250_013, 150_151, -321_001]
    ampls = [0.4, 0.3, 0.2, 0.1, 0.15, 0.12, 0.1, 0.08]
    L, K, n_exec = 80_000, 2, 2
    tx = AntennaParams(mode=AntMode.TX, rate=rate, buffer_len=L,
                       freq=freqs, ampl=ampls,
                       wave_type=[WaveType.TONES] * len(freqs))
    rx = AntennaParams(mode=AntMode.RX, rate=rate, buffer_len=L,
                       freq=freqs, decim=decim, pf_average=pfa,
                       wave_type=[WaveType.DIRECT] * len(freqs))
    mesh = make_mesh((T, Kc), ("time", "channels"))  # spans all processes
    sf = ShardedFusedDirect(tx, rx, mesh, blocks_per_exec=K, block_len=L)
    assert sf.ok

    # golden reference for all executions (float64 oracle)
    nblk = n_exec * K
    x = golden.tone_block(freqs, ampls, rate, 0, nblk * L)
    gold = golden.GoldenDirectDemodulator(freqs, rate, decim, pfa)
    ref = np.stack([gold(x[i * L:(i + 1) * L]).T for i in range(nblk)])

    state = sf.init_state()
    worst = 0.0
    for e in range(n_exec):
        state, ys = sf.run_exec(state)               # (K, nb, C) global
        for shard in ys.re.addressable_shards:
            sl = shard.index                         # global index tuple
            got = np.asarray(shard.data)
            want = ref[e * K:(e + 1) * K][sl].real.astype(np.float32)
            num = float(np.sum((got - want) ** 2))
            den = float(np.sum(want ** 2)) or 1.0
            worst = max(worst, num / den)
    snr = -10.0 * np.log10(worst) if worst else 999.0
    ok = snr > 95.0
    print(json.dumps({"process": args.process_id,
                      "devices": jax.device_count(),
                      "mesh": args.mesh,
                      "worst_shard_snr_db": round(snr, 1),
                      "ok": bool(ok)}), flush=True)

    # phase 2: BASELINE config-5 shape through the public measurement API —
    # dual-channel readout with BOTH frontends advanced lock-step inside
    # ONE SPMD program over the cross-process mesh (DualShardedFused; the
    # reference's simultaneous A/B thread chains on one PPS timebase,
    # cpp/USRP_server_link_threads.cpp:249-397).  Sample alignment is
    # asserted with a shared injected tone: every TX tone sits `df` off
    # its RX carrier, so both frontends' outputs rotate at df — if packet
    # k of A and B covered different sample instants the residual phases
    # would diverge.
    from gpu_sdr.engine.sinks import MemorySink
    from gpu_sdr.measure import run_measurement
    from gpu_sdr.params import UsrpParams

    n_tones = 16
    d5 = 100                       # 400-tap FIR: tone isolation (config 5)
    df = 1_000                     # shared off-carrier injection
    dfreqs = [int(f) for f in np.linspace(-400_000, 400_000, n_tones)]
    cmd = UsrpParams()
    for fe in ("A", "B"):
        setattr(cmd, f"{fe}_TXRX", AntennaParams(
            mode=AntMode.TX, rate=rate, buffer_len=L, samples=4 * L,
            freq=[f + df for f in dfreqs], ampl=[1.0 / n_tones] * n_tones,
            wave_type=[WaveType.TONES] * n_tones, delay=1.0))
        setattr(cmd, f"{fe}_RX2", AntennaParams(
            mode=AntMode.RX, rate=rate, buffer_len=L, samples=4 * L,
            decim=d5, pf_average=pfa, freq=dfreqs,
            wave_type=[WaveType.DIRECT] * n_tones, delay=1.0))
    sink = MemorySink()
    run_measurement(cmd, None, extra_sinks=[sink], mesh=mesh)
    # the lock-step dual path stamps packets with the FULL antenna name
    # (A_RX2/B_RX2); the sequential fallback would stamp 'A'/'B'
    codes = {m.front_end_code for m in sink.metas}
    lockstep = codes == {"A_RX2", "B_RX2"}
    streams = {c: np.concatenate(
        [p for m, p in zip(sink.metas, sink.packets)
         if m.front_end_code == c]) for c in sorted(codes)}
    a, b = (streams.get("A_RX2"), streams.get("B_RX2"))
    amp_ok = align_ok = False
    if lockstep and a is not None and b is not None and len(a) == len(b):
        out_rate = rate / d5
        k = np.arange(len(a))
        rot = np.exp(2j * np.pi * df * k / out_rate)[:, None]
        ra, rb = a[8:] / rot[8:], b[8:] / rot[8:]   # skip FIR warm-up
        # both frontends see the same FIR gain at df
        amp_ok = bool(np.allclose(np.abs(ra), np.abs(rb), atol=1e-4) and
                      np.allclose(np.abs(ra), 1.0 / n_tones, atol=5e-3))
        pa = np.angle(ra)
        pd = np.angle(ra * np.conj(rb))
        align_ok = bool(np.ptp(pa, axis=0).max() < 1e-2 and
                        np.abs(pd).max() < 1e-3)
    amp_ok = bool(amp_ok and align_ok and lockstep)
    print(json.dumps({"process": args.process_id,
                      "config5_rows": int(sink.data.shape[0]),
                      "config5_channels": int(sink.data.shape[1]),
                      "config5_lockstep": bool(lockstep),
                      "config5_aligned": bool(align_ok),
                      "config5_ok": amp_ok}), flush=True)

    # phase 3: every remaining sharded mode family across the processes,
    # each checked SHARD-BY-SHARD against the float64 oracle (outputs
    # span the processes, so only addressable shards are compared
    # locally): TONES (sharded PFB + owner-local select), NOISE with
    # frame averaging, and the CHIRP lock-in
    from gpu_sdr.ops import pfb as pfb_ops
    from gpu_sdr.parallel.sharded_pfb import ShardedPFB
    from gpu_sdr.parallel.sharded_chirp import ShardedChirpLockin

    rng = np.random.default_rng(7)
    results = {}

    def worst_shard_ratio(y_c, want, worst):
        """want: complex ref rows aligned with y's global rows (NaN rows
        are transient and skipped)."""
        for comp, w in ((y_c.re, want.real), (y_c.im, want.imag)):
            for shard in comp.addressable_shards:
                g = np.asarray(shard.data)
                ww = w[shard.index]
                m = np.isfinite(ww)
                if not m.any():
                    continue
                num = float(np.sum((g[m] - ww[m].astype(np.float32)) ** 2))
                den = float(np.sum(ww[m] ** 2)) or 1.0
                worst = max(worst, num / den)
        return worst

    def to_db(worst):
        return round(-10.0 * np.log10(worst), 1) if worst else 999.0

    # --- TONES: sharded PFB + owner-local tone select ---
    nfft, avg = 64, 4
    Lp = nfft * 32 * max(1, T // 2)   # keep >= 8 frames per time shard
    ft = Lp // nfft
    bins = (5, 17, 40)
    pcfg = pfb_ops.PFBConfig(nfft=nfft, avg=avg, rate=rate)
    sp = ShardedPFB(pcfg, mesh, Lp, bins=bins)
    xs = [(rng.standard_normal(Lp) + 1j * rng.standard_normal(Lp)
           ).astype(np.complex64) for _ in range(2)]
    ref_frames = golden.pfb_frames(np.concatenate(xs), nfft, avg)
    ref_sel = golden.tone_select(ref_frames, list(bins))
    skip = avg - 1                    # zero-primed halo transient
    ref_rows = np.full((2 * ft, len(bins)), complex(np.nan, np.nan),
                       np.complex128)
    ref_rows[skip:skip + len(ref_sel)] = ref_sel[:2 * ft - skip]
    carry = sp.init_state()
    worst = 0.0
    for b_i, b in enumerate(xs):
        carry, sel = sp.step(carry, sp.shard_input(b))
        worst = worst_shard_ratio(sel, ref_rows[b_i * ft:(b_i + 1) * ft],
                                  worst)
    results["tones_snr_db"] = to_db(worst)

    # --- NOISE: full spectrum with frame averaging (decim=4) ---
    dec = 4
    sp2 = ShardedPFB(pcfg, mesh, Lp)
    # reference for averaged groups; groups containing transient rows are
    # NaN-masked
    mark = np.full((2 * ft, nfft), complex(np.nan, np.nan), np.complex128)
    mark[skip:skip + len(ref_frames)] = ref_frames[:2 * ft - skip]
    ref_avg = mark.reshape(2 * ft // dec, dec, nfft).mean(axis=1)
    carry2 = sp2.init_state()
    worst = 0.0
    for b_i, b in enumerate(xs):
        carry2, fr = sp2.step(carry2, sp2.shard_input(b))
        fr = pfb_ops.average_frames(fr, dec)
        g = ft // dec
        worst = worst_shard_ratio(fr, ref_avg[b_i * g:(b_i + 1) * g],
                                  worst)
    results["noise_decim_snr_db"] = to_db(worst)

    # --- CHIRP: sharded lock-in ---
    from gpu_sdr.ops.chirp import ChirpConfig
    cp = golden.ChirpParameter(-300_000, 300_000, rate, 1000, 0.1)
    ccfg = ChirpConfig.from_params(-300_000, 300_000, rate, 1000, 0.1)
    ppt = cp.length                   # decim = 1
    Lc = 80_000
    nseg = Lc // ppt
    sc = ShardedChirpLockin(ccfg, mesh, Lc, ppt)
    xc = [(rng.standard_normal(Lc) + 1j * rng.standard_normal(Lc)
           ).astype(np.complex64) for _ in range(2)]
    z = golden.chirp_demod(cp, 0, np.concatenate(xc))
    gd = golden.GoldenVNADecimator(ppt)
    ref_c = gd(z)
    last = sc.init_state()
    worst = 0.0
    for b_i, b in enumerate(xc):
        last, y = sc.step(last, sc.shard_input(b))
        worst = worst_shard_ratio(
            y, ref_c[b_i * nseg:(b_i + 1) * nseg], worst)
    results["chirp_snr_db"] = to_db(worst)

    phase3_ok = all(v > SNR_BAR for v in results.values())
    results.update({"process": args.process_id, "snr_bar": SNR_BAR,
                    "phase3_ok": phase3_ok})
    print(json.dumps(results), flush=True)

    # phase 4: MIXED wave types under the cross-process mesh (beyond the
    # reference): DIRECT readout + a CHIRP sweep on one RX stream, each
    # group's SHARDED demodulator on the same time-sharded block; every
    # process golden-checks its addressable shards of both outputs
    from jax.sharding import NamedSharding, PartitionSpec
    from gpu_sdr.engine import make_demodulator
    from gpu_sdr.ops.cplx import C as Cpair

    F_T = [100_000, -200_000]
    cpm = golden.ChirpParameter(-300_000, 300_000, rate, 1000, 0.1)
    rxm = AntennaParams(
        mode=AntMode.RX, rate=rate, buffer_len=100_000, samples=200_000,
        decim=100, pf_average=pfa, freq=F_T + [-300_000],
        wave_type=[WaveType.DIRECT] * 2 + [WaveType.CHIRP],
        chirp_f=[0, 0, 300_000], chirp_t=[0.0, 0.0, 0.1],
        swipe_s=[0, 0, 1000])
    dm = make_demodulator(rxm, mesh=mesh)
    B = dm.plan.block_len
    comb = golden.tone_block(F_T, [0.4, 0.25], rate, 0, 2 * B)
    xm = (comb + golden.chirp_signal(cpm, 0, 2 * B)).astype(np.complex64)
    refd = golden.GoldenDirectDemodulator(F_T, rate, 100, pfa)(xm).T
    refc = golden.GoldenVNADecimator(cpm.length * 100)(
        golden.chirp_demod(cpm, 0, xm))[:, None]
    tspec = NamedSharding(mesh, PartitionSpec("time"))
    smix = dm.init_state()
    rd = B // 100
    rc = B // (100 * cpm.length)

    def worst_shard_ratio_c(y_c, want, worst):
        """Complex per-shard ratio: tone channels demodulate to ~real
        amplitudes, so a per-component ratio would divide the im error
        by a near-zero im denominator."""
        for sr, si in zip(y_c.re.addressable_shards,
                          y_c.im.addressable_shards):
            g = np.asarray(sr.data) + 1j * np.asarray(si.data)
            ww = want[sr.index]
            num = float(np.sum(np.abs(g - ww.astype(np.complex64)) ** 2))
            den = float(np.sum(np.abs(ww) ** 2)) or 1.0
            worst = max(worst, num / den)
        return worst

    worst_d = worst_c = 0.0
    for b_i in range(2):
        blk = xm[b_i * B:(b_i + 1) * B]
        xb = Cpair(jax.device_put(blk.real.astype(np.float32), tspec),
                   jax.device_put(blk.imag.astype(np.float32), tspec))
        smix, (yd, yc) = dm.step(smix, xb)
        worst_d = worst_shard_ratio_c(
            yd, refd[b_i * rd:(b_i + 1) * rd], worst_d)
        worst_c = worst_shard_ratio_c(
            yc, refc[b_i * rc:(b_i + 1) * rc], worst_c)
    mixed = {"mixed_direct_snr_db": to_db(worst_d),
             "mixed_chirp_snr_db": to_db(worst_c)}
    phase4_ok = all(v > SNR_BAR for v in mixed.values())
    mixed.update({"process": args.process_id, "snr_bar": SNR_BAR,
                  "phase4_ok": phase4_ok})
    print(json.dumps(mixed), flush=True)

    # phase 5: cross-process mesh-dispatched replay — the recording is
    # this framework's --sw_loop (reference software_rx_thread,
    # cpp/USRP_hardware_manager.cpp:1331-1395); every process receives
    # the gathered global stream and golden-checks it
    from gpu_sdr.parallel.sharded_replay import ShardedDeviceReplay

    rxr = AntennaParams(
        mode=AntMode.RX, rate=rate, decim=100, pf_average=pfa,
        buffer_len=100_000, samples=400_000, freq=freqs,
        wave_type=[WaveType.DIRECT] * len(freqs))
    rec = golden.tone_block(freqs, ampls, rate, 0, 400_000
                            ).astype(np.complex64)
    sr = ShardedDeviceReplay(rxr, rec, mesh, loop=False)
    rsink = MemorySink()
    sr.run([rsink])
    ref_r = golden.GoldenDirectDemodulator(freqs, rate, 100, pfa)(rec).T
    got_r = rsink.data
    n = min(len(ref_r), len(got_r))
    num = float(np.sum(np.abs(got_r[:n] - ref_r[:n].astype(np.complex64)
                              ) ** 2))
    den = float(np.sum(np.abs(ref_r[:n]) ** 2)) or 1.0
    replay_snr = to_db(num / den)
    phase5_ok = bool(replay_snr > SNR_BAR and len(got_r) == len(ref_r))
    print(json.dumps({"process": args.process_id,
                      "replay_snr_db": replay_snr,
                      "replay_rows": int(len(got_r)),
                      "phase5_ok": phase5_ok}), flush=True)

    # phase 6: PER-HOST SHARDED INGEST — every process binds its own
    # native TCP receiver and is fed ONLY the time span its local devices
    # own; the global block is assembled with
    # jax.make_array_from_process_local_data and demodulated by the
    # sharded chain (SURVEY.md section 2.4 "per-host shard of the IQ
    # stream"; reference transport
    # headers/USRP_server_memory_management.hpp:210-272)
    import socket
    import threading
    from gpu_sdr.engine import make_demodulator
    from gpu_sdr.ops import cplx as cplx_ops
    from gpu_sdr.parallel.host_ingest import (PerHostIngest,
                                              host_stream_for)

    rxi = AntennaParams(
        mode=AntMode.RX, rate=rate, decim=100, pf_average=pfa,
        buffer_len=100_000, samples=300_000, freq=freqs,
        wave_type=[WaveType.DIRECT] * len(freqs))
    dmi = make_demodulator(rxi, mesh=mesh)
    Li, nbi = dmi.plan.block_len, dmi.plan.n_blocks
    # the same global recording on every process (deterministic synth);
    # each process streams ONLY its host span to its own receiver
    reci = golden.tone_block(freqs, ampls, rate, 0, nbi * Li
                             ).astype(np.complex64)

    def _produce(port, payload):
        with socket.create_connection(("127.0.0.1", port)) as s:
            s.sendall(payload.tobytes())

    with PerHostIngest(mesh, Li) as ing:
        payload = host_stream_for(reci, ing, nbi)
        assert len(payload) == nbi * ing.local_len
        if args.num_processes > 1:      # each host feeds ONLY its shard
            assert len(payload) < len(reci)
        producer = threading.Thread(target=_produce,
                                    args=(ing.port, payload), daemon=True)
        producer.start()
        sti = dmi.init_state()
        outs = []
        for xb, _errs in ing.device_blocks(Li, nbi):
            sti, y = dmi.step(sti, xb)
            re, im = y.re, y.im
            if not re.is_fully_addressable:
                from jax.experimental import multihost_utils
                re = multihost_utils.process_allgather(re, tiled=True)
                im = multihost_utils.process_allgather(im, tiled=True)
            outs.append(np.asarray(re).astype(np.float32)
                        + 1j * np.asarray(im).astype(np.float32))
        producer.join(timeout=10)
        ingest_aborted = ing.aborted
    got_i = np.concatenate(outs, axis=0)
    ref_i = golden.GoldenDirectDemodulator(freqs, rate, 100, pfa)(reci).T
    n = min(len(ref_i), len(got_i))
    num = float(np.sum(np.abs(got_i[:n] - ref_i[:n].astype(np.complex64)
                              ) ** 2))
    den = float(np.sum(np.abs(ref_i[:n]) ** 2)) or 1.0
    ingest_snr = to_db(num / den)
    phase6_ok = bool(ingest_snr > SNR_BAR and not ingest_aborted and
                     len(got_i) == nbi * (Li // 100))
    print(json.dumps({"process": args.process_id,
                      "host_ingest_snr_db": ingest_snr,
                      "host_ingest_local_len": int(ing.local_len),
                      "host_ingest_rows": int(len(got_i)),
                      "phase6_ok": phase6_ok}), flush=True)

    sys.exit(0 if (ok and amp_ok and phase3_ok and phase4_ok and
                   phase5_ok and phase6_ok) else 1)


if __name__ == "__main__":
    main()
