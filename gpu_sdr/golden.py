"""Golden numpy models of the reference DSP math.

Each function here reproduces, in plain float64 numpy, the exact arithmetic of
one reference CUDA kernel (file:line cited per function).  They are the
verification oracles for the ops in :mod:`gpu_sdr.ops` — every device
path must match these within the documented SNR bound — and double as
executable documentation of the reference semantics.

They are deliberately *slow and obvious*; nothing here runs in the hot path.
"""

from __future__ import annotations

import numpy as np

TWO_31_5 = 2147483647.5  # reference _31_BIT_VALUE (headers/kernels.cuh:36)


# ----------------------------------------------------------------------
# Window builders (reference cpp/kernels.cu:107-310)
# ----------------------------------------------------------------------

def make_hamming_window(length: int, side: int = 0) -> np.ndarray:
    """Zero-padded, sum-normalized Hamming window
    (reference make_hamming_window, cpp/kernels.cu:107-206)."""
    win = np.zeros(length, dtype=np.float64)
    n = length - side
    if n <= 1:
        win[side:] = 1.0
        return win / max(win.sum(), 1.0)
    i = np.arange(n, dtype=np.float64)
    body = 0.54 - 0.46 * np.cos(2.0 * np.pi * i / (n - 1))
    win[side:side + n] = body
    return win / body.sum()


def make_flat_window(length: int, side: int) -> np.ndarray:
    """Flat-top window: zeros on the first `side` samples, constant after,
    normalized to unit sum (reference make_flat_window, cpp/kernels.cu:208-253).

    Note the reference zeroes *both* ends first but then overwrites
    [side, length) with ones, so only the leading `side` samples end up zero;
    we reproduce that behaviour exactly.
    """
    win = np.zeros(length, dtype=np.float64)
    win[side:] = 1.0
    return win / win.sum()


def make_sinc_window(length: int, fc: float) -> np.ndarray:
    """Hamming-windowed sinc low-pass prototype, normalized to unit sum
    (reference make_sinc_window, cpp/kernels.cu:256-310).

    length == 1 degenerates to a unit tap (the reference's formula divides
    by length-1 and would produce NaN)."""
    if length == 1:
        return np.ones(1, dtype=np.float64)
    i = np.arange(length, dtype=np.float64)
    k = i - (length - 1) // 2          # integer center, as in the reference
    x = 2.0 * np.pi * fc * k
    sinc = np.where(k != 0, (2.0 * fc) * np.sin(x) / np.where(x == 0, 1, x),
                    2.0 * fc)
    win = sinc * (0.54 - 0.46 * np.cos(2.0 * np.pi * i / (length - 1)))
    return win / win.sum()


# ----------------------------------------------------------------------
# Multi-tone generation (reference tone_gen, cpp/kernels.cu:589-684)
# ----------------------------------------------------------------------

def tone_gen(freqs, ampls, rate: int, scale: float = 1.0) -> np.ndarray:
    """One period (rate samples) of the multi-tone TX comb.

    The reference places amplitudes in FFT bins (negative f -> rate+f) and
    runs an *unnormalized* inverse cuFFT, i.e.
    ``x[n] = sum_k A_k * exp(+2j*pi*f_k*n/rate)``.
    """
    spec = np.zeros(rate, dtype=np.complex128)
    for f, a in zip(freqs, ampls):
        spec[int(f) % rate] += a
    x = np.fft.ifft(spec) * rate  # cuFFT inverse is unnormalized
    return (x * scale).astype(np.complex128)


def tone_block(freqs, ampls, rate: int, start: int, length: int,
               scale: float = 1.0) -> np.ndarray:
    """`length` samples of the tone comb starting at absolute index `start`,
    evaluated directly (same math as :func:`tone_gen` pointer rotation)."""
    n = (np.asarray(start, dtype=np.int64) + np.arange(length, dtype=np.int64))
    x = np.zeros(length, dtype=np.complex128)
    for f, a in zip(freqs, ampls):
        ph = ((int(f) % rate) * (n % rate)) % rate
        x += a * np.exp(2j * np.pi * ph / rate)
    return x * scale


# ----------------------------------------------------------------------
# DIRECT demodulation (reference direct_demodulator_integer,
# cpp/kernels.cu:45-86)
# ----------------------------------------------------------------------

def direct_demod(x: np.ndarray, freqs, phases, wavetablelen: int,
                 index_counter: int) -> np.ndarray:
    """Integer-phase direct down-conversion of one block.

    For channel c and sample n (block-local), with W = wavetablelen (= rate):
        ii    = (n + index_counter) mod W
        phase = (p_c + (f_c * ii) mod W) / W        [in units of 2*pi]
        out   = x[n] * exp(-2j*pi*phase)
    Returns shape (n_channels, len(x)).
    """
    W = int(wavetablelen)
    n = np.arange(len(x), dtype=np.int64)
    ii = (n + int(index_counter)) % W
    out = np.empty((len(freqs), len(x)), dtype=np.complex128)
    for c, (f, p) in enumerate(zip(freqs, phases)):
        my_phase = (int(p) + (int(f) * ii) % W)
        theta = 2.0 * np.pi * (my_phase / float(W))
        out[c] = x * np.exp(-1j * theta)
    return out


# ----------------------------------------------------------------------
# Streaming polyphase FIR (reference cpp/fir.cu:15-88)
# ----------------------------------------------------------------------

class GoldenFIR:
    """Stateful decimating FIR reproducing the reference ``FIR`` class.

    The reference computes, per block of nt samples (nb = nt/M outputs):
        y[n] = sum_{i=0}^{M*f-1} taps[i] * z[(n-f+1)*M + i]
    which is a sliding correlation of the taps with the signal at output
    stride M, with an (f-1)*M-sample history carried between blocks
    (derived from the cgemm+caxpy formulation at cpp/fir.cu:44-69).
    The first block sees zero history (the reference's startup transient).
    """

    def __init__(self, taps: np.ndarray, M: int, f: int):
        assert len(taps) == M * f
        self.taps = np.asarray(taps, dtype=np.complex128)
        self.M = M
        self.f = f
        self.hist = np.zeros((f - 1) * M, dtype=np.complex128)

    def __call__(self, z: np.ndarray) -> np.ndarray:
        M, f = self.M, self.f
        nt = len(z)
        assert nt % M == 0
        nb = nt // M
        ze = np.concatenate([self.hist, np.asarray(z, dtype=np.complex128)])
        y = np.empty(nb, dtype=np.complex128)
        for n in range(nb):
            y[n] = np.dot(self.taps, ze[n * M: n * M + f * M])
        self.hist = ze[-(f - 1) * M:] if f > 1 else self.hist
        return y


def direct_fir_taps(decim: int, pf_average: int) -> np.ndarray:
    """FIR taps used by DIRECT mode: sinc window of length decim*pf_average
    with fc = 0.75/(2*decim) (reference cpp/USRP_demodulator.cpp:99)."""
    return make_sinc_window(decim * pf_average, 0.75 / (2.0 * decim))


# ----------------------------------------------------------------------
# Polyphase filter bank (reference polyphase_filter, cpp/kernels.cu:474-516
# + cufftExecC2C + tone_select, cpp/kernels.cu:531-554)
# ----------------------------------------------------------------------

def pfb_frames(x: np.ndarray, nfft: int, avg: int,
               window: np.ndarray | None = None) -> np.ndarray:
    """All complete PFB frames of a contiguous signal.

    Frame t (hop nfft, support avg*nfft):
        pre[t, b] = sum_{i<avg} x[t*nfft + b + i*nfft] * w[b + i*nfft]
        out[t]    = FFT_nfft(pre[t])
    This is the reference polyphase_filter kernel followed by the batched
    forward cuFFT; frames requiring samples beyond len(x) are not emitted
    (the reference marks them invalid via buffer_helper batching).
    """
    if window is None:
        window = make_sinc_window(nfft * avg, 1.0 / (2.0 * nfft))
    w = np.asarray(window, dtype=np.float64).reshape(avg, nfft)
    n_frames = (len(x) - avg * nfft) // nfft + 1
    if n_frames <= 0:
        return np.zeros((0, nfft), dtype=np.complex128)
    out = np.empty((n_frames, nfft), dtype=np.complex128)
    for t in range(n_frames):
        seg = x[t * nfft:(t + avg) * nfft].reshape(avg, nfft)
        out[t] = np.fft.fft((seg * w).sum(axis=0))
    return out


def tone_bins(freqs, rate: int, nfft: int) -> np.ndarray:
    """Map tone frequencies to FFT bin indices exactly as the reference
    (upload_multitone_parameters, cpp/USRP_demodulator.cpp:702-768).

    The reference scans a bin axis bin[i] = i*bs - bs*(nfft//2) and assigns a
    tone to the *last* bin with |f - bin[i]| < bs, then wraps by nfft//2.
    """
    bs = float(rate) / float(nfft)
    bins = np.zeros(len(freqs), dtype=np.int64)
    axis = np.arange(nfft, dtype=np.float64) * bs - bs * (nfft // 2)
    for u, f in enumerate(freqs):
        for i in range(nfft):
            if (f < axis[i] + bs) and (f > axis[i] - bs):
                bins[u] = (i + nfft // 2) % nfft
    return bins


def tone_select(frames: np.ndarray, bins) -> np.ndarray:
    """Gather selected bins from PFB frames -> shape (n_frames, n_tones)
    (reference tone_select kernel, cpp/kernels.cu:531-554)."""
    return frames[:, np.asarray(bins, dtype=np.int64)]


def decimate_spectra(frames: np.ndarray, decim: int) -> np.ndarray:
    """Average groups of `decim` consecutive PFB frames
    (reference average_spectra/decimate_spectra, cpp/kernels.cu:704-749)."""
    n = (len(frames) // decim) * decim
    if n == 0:
        return np.zeros((0, frames.shape[1]), dtype=frames.dtype)
    return frames[:n].reshape(-1, decim, frames.shape[1]).mean(axis=1)


# ----------------------------------------------------------------------
# Chirp generation/demodulation (reference chirp_gen / chirp_demodulator,
# cpp/kernels.cu:335-441) — exact uint32 modular arithmetic.
# ----------------------------------------------------------------------

class ChirpParameter:
    """Quantized chirp descriptor, reproducing the constructor math of the
    reference demodulator (cpp/USRP_demodulator.cpp:192-221):

        num_steps = swipe_s  (or chirp_t*rate if unset)
        length    = chirp_t * rate / num_steps      [samples/step, int]
        chirpness = trunc((2^32-1) * (f1-f0)/((num_steps-1)*rate))  [uint32]
        f0        = trunc((2^32-1) * f_start/rate)                  [int32]

    chirpness is stored in a C 'unsigned int' and f0 in an 'int'
    (headers/kernels.cuh:58-64), so both are truncated; VNA frequency-axis
    reconstruction depends on this exact rounding (pyUSRP/USRP_VNA.py:740).
    """

    def __init__(self, f_start: int, f_end: int, rate: int, num_steps: int,
                 chirp_t: float):
        if num_steps < 1:
            num_steps = int(chirp_t * rate)
        length = int(chirp_t * rate / num_steps)
        if length < 1:
            length = 1
        self.num_steps = int(num_steps)
        self.length = int(length)
        two32m1 = float(2 ** 32 - 1)
        if num_steps > 1:
            # C assigns the (possibly negative) double to 'unsigned int':
            # truncate toward zero, then wrap mod 2^32 (x86 behaviour the
            # reference relies on for down-chirps)
            raw = int(two32m1 * (f_end - f_start) / ((num_steps - 1.0) * rate))
            self.chirpness = np.uint32(raw % (2 ** 32))
        else:
            self.chirpness = np.uint32(0)
        raw_f0 = int(two32m1 * (float(f_start) / float(rate))) % (2 ** 32)
        self.f0 = np.int32(raw_f0 - 2 ** 32 if raw_f0 >= 2 ** 31 else raw_f0)

    def period(self) -> int:
        return self.num_steps * self.length


def chirp_phase_index(cp: ChirpParameter, last_index: int,
                      n: np.ndarray) -> np.ndarray:
    """The int32 phase-accumulator value for sample offsets `n`
    (exact uint64/uint32 arithmetic of chirp_gen, cpp/kernels.cu:344-366)."""
    with np.errstate(over="ignore"):
        eff = (np.uint64(last_index) + n.astype(np.uint64)) \
            % np.uint64(cp.period())
        fi = eff // np.uint64(cp.length)
        q_phase = (fi // np.uint64(2)) * (fi + np.uint64(1)) \
            + (fi % np.uint64(2)) * ((fi + np.uint64(1)) // np.uint64(2))
        pc = np.uint64(cp.chirpness) * (np.uint64(cp.length) * q_phase)
        base = (np.uint64(np.int64(cp.f0)).astype(np.uint64)
                + fi * np.uint64(cp.chirpness))
        idx = eff * base - pc
    return idx.astype(np.uint32).astype(np.int32)


def chirp_signal(cp: ChirpParameter, last_index: int, length: int,
                 scale: float = 1.0) -> np.ndarray:
    """TX chirp block: x[n] = scale * (sin(th) - j*cos(th)) with
    th = pi * index/2^31.5 (reference chirp_gen, cpp/kernels.cu:367-368)."""
    n = np.arange(length, dtype=np.uint64)
    idx = chirp_phase_index(cp, last_index, n).astype(np.float64)
    th = np.pi * (idx / TWO_31_5)
    return scale * (np.sin(th) - 1j * np.cos(th))


def chirp_demod(cp: ChirpParameter, last_index: int,
                x: np.ndarray) -> np.ndarray:
    """RX chirp lock-in mix: out = conj(chirp) * x
    (reference chirp_demodulator, cpp/kernels.cu:389-427)."""
    c = chirp_signal(cp, last_index, len(x), scale=1.0)
    return np.conj(c) * np.asarray(x, dtype=np.complex128)


class GoldenVNADecimator:
    """Stateful chirp lock-in decimator reproducing process_chirp decimation
    (cpp/USRP_demodulator.cpp:342-397 + VNA_decimator_helper,
    cpp/USRP_server_memory_management.cpp:30-56).

    Accumulates demodulated samples; every `ppt` samples produces one output
    point = sum(profile * segment) with profile = flat window of length ppt
    zeroed on its first ppt//10 samples (make_flat_window(ppt, ppt//10)).
    """

    def __init__(self, ppt: int):
        self.ppt = int(ppt)
        self.profile = make_flat_window(self.ppt, self.ppt // 10)
        self.buf = np.zeros(0, dtype=np.complex128)

    def __call__(self, z: np.ndarray) -> np.ndarray:
        self.buf = np.concatenate([self.buf, np.asarray(z, np.complex128)])
        nseg = len(self.buf) // self.ppt
        seg = self.buf[:nseg * self.ppt].reshape(nseg, self.ppt)
        out = seg @ self.profile
        self.buf = self.buf[nseg * self.ppt:]
        return out


# ----------------------------------------------------------------------
# Full streaming references (block loop + carry bookkeeping)
# ----------------------------------------------------------------------

class GoldenDirectDemodulator:
    """End-to-end DIRECT-mode block processor: integer-phase DDC followed by
    the per-channel streaming FIR (process_direct,
    cpp/USRP_demodulator.cpp:400-464).  Output per block: (n_ch, nb)."""

    def __init__(self, freqs, rate: int, decim: int, pf_average: int,
                 phases=None):
        self.freqs = [int(f) for f in freqs]
        self.rate = int(rate)
        self.decim = int(decim)
        self.phases = ([0] * len(self.freqs) if phases is None
                       else [int(p) for p in phases])
        self.index = 0
        if decim > 0:
            taps = direct_fir_taps(decim, pf_average)
            self.firs = [GoldenFIR(taps, decim, pf_average)
                         for _ in self.freqs]
        else:
            self.firs = None

    def __call__(self, x: np.ndarray) -> np.ndarray:
        z = direct_demod(x, self.freqs, self.phases, self.rate, self.index)
        self.index = (self.index + len(x)) % self.rate
        if self.firs is None:
            return z
        return np.stack([f(zc) for f, zc in zip(self.firs, z)])


class GoldenPFBDemodulator:
    """End-to-end TONES/NOISE-mode block processor: PFB + FFT (+ optional
    frame averaging) (+ tone selection), with the raw-sample spare carry of
    buffer_helper (cpp/USRP_server_memory_management.cpp:104-156).

    Emits, per block, only frames fully contained in the data seen so far —
    the same steady-state frame stream as the reference (block boundaries of
    the emitted batches differ, the concatenated stream is identical).
    """

    def __init__(self, nfft: int, avg: int, rate: int, freqs=None,
                 decim: int = 0):
        self.nfft, self.avg = int(nfft), int(avg)
        self.window = make_sinc_window(nfft * avg, 1.0 / (2.0 * nfft))
        self.bins = (tone_bins(freqs, rate, nfft)
                     if freqs is not None else None)
        self.decim = int(decim)
        self.carry = np.zeros(0, dtype=np.complex128)
        self.frame_carry = np.zeros((0, nfft), dtype=np.complex128)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        buf = np.concatenate([self.carry, np.asarray(x, np.complex128)])
        frames = pfb_frames(buf, self.nfft, self.avg, self.window)
        consumed = len(frames) * self.nfft
        self.carry = buf[consumed:]
        if self.decim > 0:
            frames = np.concatenate([self.frame_carry, frames])
            n = (len(frames) // self.decim) * self.decim
            self.frame_carry = frames[n:]
            frames = decimate_spectra(frames[:n], self.decim)
        if self.bins is not None:
            return tone_select(frames, self.bins)
        return frames


def expected_stream(rx, x: np.ndarray) -> np.ndarray:
    """Reference output of one single-mode RX antenna (an AntennaParams)
    for the input signal `x` starting at stream sample 0, as
    (rows, channels), aligned row-for-row with the framework's output
    stream: DIRECT and the FIR start from zero history, the PFB from
    avg-1 zero-primed frames (hence the zero prefix), CHIRP from phase
    index 0."""
    from .params import WaveType, chirp_steps_and_length
    x = np.asarray(x, dtype=np.complex128)
    w = rx.wave_type[0]
    rate, decim = int(rx.rate), int(rx.decim)
    if w == WaveType.DIRECT:
        g = GoldenDirectDemodulator(rx.freq, rate, decim, int(rx.pf_average))
        return g(x).T
    if w in (WaveType.TONES, WaveType.NOISE):
        nfft, avg = int(rx.fft_tones), int(rx.pf_average)
        primed = np.concatenate([np.zeros((avg - 1) * nfft, np.complex128), x])
        frames = pfb_frames(primed, nfft, avg)
        if decim > 0:
            frames = decimate_spectra(frames, decim)
        if w == WaveType.TONES:
            frames = tone_select(frames, tone_bins(rx.freq, rate, nfft))
        return frames
    if w == WaveType.CHIRP:
        steps, length = chirp_steps_and_length(rx)
        cp = ChirpParameter(int(rx.freq[0]), int(rx.chirp_f[0]), rate,
                            steps, float(rx.chirp_t[0]))
        z = chirp_demod(cp, 0, x)
        if decim > 0:
            z = GoldenVNADecimator(length * decim)(z)
        return z[:, None]
    raise NotImplementedError(f"no reference for {w}")


# ----------------------------------------------------------------------
# SNR-style comparison helper used across the test suite
# ----------------------------------------------------------------------

def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    """Signal-to-error ratio in dB between a golden and a candidate array."""
    ref = np.asarray(ref).ravel()
    test = np.asarray(test).ravel()
    err = np.linalg.norm(ref - test)
    sig = np.linalg.norm(ref)
    if err == 0:
        return np.inf
    if sig == 0:
        return -np.inf
    return 20.0 * np.log10(sig / err)
