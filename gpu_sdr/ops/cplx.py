"""Complex arithmetic as explicit float32 (re, im) pairs.

Every complex array on the device path is a :class:`C` pair of real
arrays.  Owning the decomposition lets the framework choose the
3-multiply complex matmul explicitly; whether native complex64 with
`jnp.fft` is faster on the H100 is ROADMAP items A4/C2.

Host boundary: numpy complex64 <-> C via :func:`from_np` / :func:`to_np`.
C is a NamedTuple, hence a pytree: it scans, jits and shards transparently.

The DFT here replaces cuFFT (the reference channelizer's FFT stage,
cpp/USRP_demodulator.cpp:501): a dense DFT-as-matmul for PFB-sized
transforms, and a two-stage Cooley-Tukey split, each stage again a
matmul, for larger ones.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class C(NamedTuple):
    """A complex tensor as a (re, im) pair of equally-shaped real arrays."""

    re: jax.Array
    im: jax.Array

    @property
    def shape(self):
        return self.re.shape

    @property
    def dtype(self):
        return self.re.dtype

    def __add__(self, o: "C") -> "C":
        return C(self.re + o.re, self.im + o.im)

    def __sub__(self, o: "C") -> "C":
        return C(self.re - o.re, self.im - o.im)

    def reshape(self, *s) -> "C":
        return C(self.re.reshape(*s), self.im.reshape(*s))

    def __getitem__(self, idx) -> "C":
        return C(self.re[idx], self.im[idx])

    def transpose(self, *axes) -> "C":
        return C(self.re.transpose(*axes), self.im.transpose(*axes))

    def conj(self) -> "C":
        return C(self.re, -self.im)

    def abs2(self) -> jax.Array:
        return self.re * self.re + self.im * self.im


# ----------------------------------------------------------------------
# Host boundary
# ----------------------------------------------------------------------

def from_np(x: np.ndarray, dtype=jnp.float32) -> C:
    x = np.asarray(x)
    return C(jnp.asarray(np.ascontiguousarray(x.real), dtype=dtype),
             jnp.asarray(np.ascontiguousarray(x.imag), dtype=dtype))


def to_np(x: C) -> np.ndarray:
    return np.asarray(x.re).astype(np.float32) + \
        1j * np.asarray(x.im).astype(np.float32)


def zeros(shape, dtype=jnp.float32) -> C:
    return C(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))


def const(x: np.ndarray, dtype=jnp.float32) -> C:
    """Host-precomputed complex constant -> device pair."""
    return from_np(np.asarray(x), dtype=dtype)


# ----------------------------------------------------------------------
# Elementwise ops
# ----------------------------------------------------------------------

def mul(a: C, b: C) -> C:
    return C(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def conj_mul(a: C, b: C) -> C:
    """conj(a) * b."""
    return C(a.re * b.re + a.im * b.im, a.re * b.im - a.im * b.re)


def scale(a: C, s) -> C:
    return C(a.re * s, a.im * s)


def expi(theta: jax.Array) -> C:
    """exp(1j*theta)."""
    return C(jnp.cos(theta), jnp.sin(theta))


def expi_neg(theta: jax.Array) -> C:
    """exp(-1j*theta)."""
    return C(jnp.cos(theta), -jnp.sin(theta))


def concat(parts, axis=0) -> C:
    return C(jnp.concatenate([p.re for p in parts], axis=axis),
             jnp.concatenate([p.im for p in parts], axis=axis))


def take(a: C, idx, axis=-1) -> C:
    return C(jnp.take(a.re, idx, axis=axis), jnp.take(a.im, idx, axis=axis))


# ----------------------------------------------------------------------
# Matmul ops
# ----------------------------------------------------------------------

def matmul(a: C, b: C, precision=None) -> C:
    """Complex matmul via the 3-real-multiply (Karatsuba) decomposition:
        k1 = ar @ (br + bi);  k2 = (ai - ar) @ bi? -- use the stable form:
        re = ar@br - ai@bi ; im = (ar+ai)@(br+bi) - ar@br - ai@bi
    3 real matmuls instead of 4; the adds are fused by XLA."""
    rr = jnp.matmul(a.re, b.re, precision=precision)
    ii = jnp.matmul(a.im, b.im, precision=precision)
    ri = jnp.matmul(a.re + a.im, b.re + b.im, precision=precision)
    return C(rr - ii, ri - rr - ii)


def matmul_rc(a: jax.Array, b: C, precision=None) -> C:
    """(real a) @ (complex b)."""
    return C(jnp.matmul(a, b.re, precision=precision),
             jnp.matmul(a, b.im, precision=precision))


def matmul_cr(a: C, b: jax.Array, precision=None) -> C:
    """(complex a) @ (real b)."""
    return C(jnp.matmul(a.re, b, precision=precision),
             jnp.matmul(a.im, b, precision=precision))


# ----------------------------------------------------------------------
# DFT as matmul (cuFFT replacement)
# ----------------------------------------------------------------------

_TWO_STAGE_MIN = 4096  # above this, use the Cooley-Tukey two-stage split


def _dft_factors(n: int, sign: float) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    return np.exp(sign * 2j * np.pi * np.outer(k, k) / n)


def dft_matrix(n: int, inverse: bool = False) -> C:
    """Dense DFT matrix F[n, k] = exp(-+2j*pi*n*k/N) as a C pair.
    Forward matches numpy/cuFFT convention (negative exponent, no scale);
    inverse is unnormalized (like cuFFT)."""
    F = _dft_factors(n, +1.0 if inverse else -1.0)
    return const(F.astype(np.complex64))


def _best_split(n: int) -> Tuple[int, int]:
    """Pick the Cooley-Tukey split (n1, n2), n = n1*n2.

    Preference order: n1 multiple of 8 with 64 <= n2 <= 160 (the (8, 125)
    split of the 1000-bin channelizer that the parity tests pin); then
    balanced.  Which split, or cuFFT, is fastest on the H100 is not
    measured yet (ROADMAP A4).
    """
    aligned = [(d, n // d) for d in range(8, n + 1, 8)
               if n % d == 0 and 64 <= n // d <= 160]
    if aligned:
        return min(aligned, key=lambda p: p[0] + p[1])
    best = (1, n)
    target = int(np.sqrt(n))
    for d in range(1, target + 1):
        if n % d == 0:
            best = (d, n // d)
    return best


def _swap_last(a: C) -> C:
    return C(jnp.swapaxes(a.re, -1, -2), jnp.swapaxes(a.im, -1, -2))


def _dot_contract_sublast(a: C, b: C):
    """Contract a's second-to-last axis with b's first axis:
    (..., m, n) x (m, k) -> (..., n, k) — no explicit transpose (XLA picks
    layouts).  3-real-multiply complex decomposition."""
    import jax

    def dg(x, y):
        nd = x.ndim
        return jax.lax.dot_general(
            x, y, dimension_numbers=(((nd - 2,), (0,)), ((), ())))

    rr = dg(a.re, b.re)
    ii = dg(a.im, b.im)
    ri = dg(a.re + a.im, b.re + b.im)
    return C(rr - ii, ri - rr - ii)


class DFT:
    """Batched DFT over the last axis, built once per length.

    For n <= 4096: one (T, n) x (n, n) complex matmul.
    For larger composite n = n1*n2: Cooley-Tukey with input split
    x[n2*a + b], output Y[k1 + n1*k2]:

        Y[k1 + n1*k2] = sum_b W_N^{b*k1} W_n2^{b*k2}
                        ( sum_a W_n1^{a*k1} x[n2*a + b] )

    — two matmul stages + one elementwise twiddle.
    """

    def __init__(self, n: int, inverse: bool = False,
                 two_stage: bool | None = None):
        self.n = n
        self.inverse = inverse
        self.split = None
        n1, n2 = _best_split(n)
        if two_stage is None:
            two_stage = n > _TWO_STAGE_MIN
        if not two_stage or n1 == 1:
            self.F = dft_matrix(n, inverse)
        else:
            sign = +1.0 if inverse else -1.0
            self.split = (n1, n2)
            self.F1 = const(_dft_factors(n1, sign).astype(np.complex64))
            self.F2 = const(_dft_factors(n2, sign).astype(np.complex64))
            b = np.arange(n2, dtype=np.float64)
            k1 = np.arange(n1, dtype=np.float64)
            tw = np.exp(sign * 2j * np.pi * np.outer(b, k1) / n)  # (n2, n1)
            self.TW = const(tw.astype(np.complex64))

    def __call__(self, x: C) -> C:
        """x: (..., n) -> (..., n) (numpy fft convention, unnormalized)."""
        if self.split is None:
            return matmul(x, self.F)
        n1, n2 = self.split
        lead = x.shape[:-1]
        yt = _swap_last(self._scrambled_2d(x))   # (..., k2, k1)
        return yt.reshape(lead + (self.n,))      # index k2*n1 + k1 = k

    def _scrambled_2d(self, x: C) -> C:
        n1, n2 = self.split
        lead = x.shape[:-1]
        xs = x.reshape(lead + (n1, n2))          # xs[a, b] = x[n2*a + b]
        z = _dot_contract_sublast(xs, self.F1)   # (..., b, k1): sum_a
        z = mul(z, self.TW)                      # twiddle W_N^{b*k1}
        return _dot_contract_sublast(z, self.F2)  # (..., k1, k2): sum_b

    def scrambled(self, x: C) -> C:
        """Two-stage DFT without the final un-scramble transpose: returns
        (..., k1, k2) where bin k = k2*n1 + k1 lives at [..., k % n1,
        k // n1] (see scramble_index).  Transpose-free via dot_general
        contractions — the fast path when a gather follows anyway."""
        assert self.split is not None
        lead = x.shape[:-1]
        y = self._scrambled_2d(x)                # (..., k1, k2)
        return y.reshape(lead + (self.n,))       # flat pos = k1*n2 + k2

    def scramble_index(self, bins) -> np.ndarray:
        """Map bin indices k to their position in scrambled() output."""
        assert self.split is not None
        n1, n2 = self.split
        b = np.asarray(bins, dtype=np.int64)
        return ((b % n1) * n2 + (b // n1)).astype(np.int32)


def fft(x: C, dft: DFT) -> C:
    return dft(x)
