"""Wideband sync scan as one matmul + roll-combines.

TPU-native redesign of the reference scan kernel
(/root/reference/src/scan_kernel.cuh:27-366). The reference re-mixes the
window and redoes the 42-tap correlation for every (frequency, pattern) pair.
We factor the math so the expensive correlation is computed ONCE per
frequency, shared by all averaging patterns:

With z_f(t) = c(t) * exp(-2j*pi*f*(t mod N)/fs) the per-(f,p) metric is
    s_p(f, lag) = sum_i conj(u_p((lag+i) mod N)) * cb42[i],
    u_p(tau)    = sum_m mask_p[m] * (z_f((tau+864m) mod N)
                                     + z_f((tau+864m+336) mod N)).
Linearity turns this into
    s_p(f, lag) = sum_m mask_p[m] * (G_f((lag+864m) mod N)
                                     + G_f((lag+864m+336) mod N)),
    G_f(l)      = sum_i conj(z_f((l+i) mod N)) * cb42[i]
                = E_f(l) * sum_i conj(c~(l+i)) * cb42[i] * exp(2j*pi*f*i/fs)
with E_f(l) = exp(2j*pi*f*l/fs) and c~ the window extended by its own head
(the final 41 lags wrap; wrapped taps additionally pick up
chi_f = exp(-2j*pi*f*N/fs) because the reference mixes on wrapped indices —
we add that correction exactly with a second tiny matmul).

So the whole frequency scan is one (N,42) x (42,F) complex matmul, a
(41,42) x (42,F) boundary matmul, and 12 rolls+adds — ~40x less arithmetic
than the reference's formulation at scan depth 6.

Candidate selection mirrors the reference: best lag per 256-lag slice (21
slices, the last wrapping past N), then top-8 slice maxima per (f, p)
(scan_kernel.cuh:85-364). Positions are canonicalized mod N (the reference
can emit aliased pos >= N whose deep-pattern averaging then reads out of
bounds; see SURVEY.md quirks).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from .tables import FreqTables, cached_freq_tables

_N = C.WINDOW_LEN
_HIGHEST = jax.lax.Precision.HIGHEST


def _as_tables(freqs) -> FreqTables:
    """Accept either a static freqs tuple (cached constant tables) or a
    FreqTables of (possibly sharded, traced) arrays."""
    if isinstance(freqs, FreqTables):
        return freqs
    return cached_freq_tables(tuple(float(f) for f in freqs))


def _lag_matrix(c: jnp.ndarray) -> jnp.ndarray:
    """(N, 42) matrix Cmat[l, i] = c~(l+i), c~ = window extended by its head."""
    ext = jnp.concatenate([c, c[: C.SYNC_CORR_LEN - 1]])
    idx = np.arange(_N)[:, None] + np.arange(C.SYNC_CORR_LEN)[None, :]
    return ext[idx]


def _boundary_matrix(c: jnp.ndarray) -> jnp.ndarray:
    """(41, 42) wrapped-tap contributions for lags l = N-41+r: taps with
    l+i >= N read c[l+i-N]; all other entries zero."""
    r = np.arange(C.SYNC_CORR_LEN - 1)[:, None]
    i = np.arange(C.SYNC_CORR_LEN)[None, :]
    wrapped = i >= (C.SYNC_CORR_LEN - 1) - r  # l+i >= N
    idx = np.where(wrapped, r + i - (C.SYNC_CORR_LEN - 1), 0)
    return jnp.where(jnp.asarray(wrapped), c[idx], 0.0 + 0.0j)


def sync_correlation(c: jnp.ndarray, freqs) -> jnp.ndarray:
    """G (N, F) complex64: 42-tap cyclic sync correlation of the wrapped-mixed
    window at every (lag, frequency). `freqs`: tuple or FreqTables."""
    t = _as_tables(freqs)
    B = jnp.asarray(t.B)
    cmat = _lag_matrix(c)
    R = jnp.matmul(jnp.conj(cmat), B, precision=_HIGHEST)  # (N, F)
    D = jnp.matmul(jnp.conj(_boundary_matrix(c)), B, precision=_HIGHEST)  # (41, F)
    R = R.at[_N - (C.SYNC_CORR_LEN - 1) :, :].add(jnp.asarray(t.chi) * D)
    return jnp.asarray(t.E) * R


def pattern_metrics(G: jnp.ndarray, scan_depth: int) -> jnp.ndarray:
    """xb (P, N, F) float32: |s_p(f, lag)| for the first `scan_depth` patterns.

    Exploits that patterns 1..6 are prefixes (cumulative sums of per-frame
    terms) and patterns 7..8 are sparse combinations (msk_context.cuh:231-240).
    """
    T = [
        jnp.roll(G, -864 * m, axis=0) + jnp.roll(G, -(864 * m + C.SECOND_SYNC_SAMPLE), axis=0)
        for m in range(C.PATTERN_LEN)
    ]
    S = []
    acc = T[0]
    S.append(acc)  # pattern 0: frame 1
    for m in range(1, 6):
        acc = acc + T[m]
        S.append(acc)  # patterns 1..5: prefixes
    S.append(T[0] + T[3])  # pattern 6: 100100
    S.append(T[0] + T[3] + T[4])  # pattern 7: 100110
    return jnp.abs(jnp.stack(S[:scan_depth], axis=0)).astype(jnp.float32)


def select_candidates(
    xb: jnp.ndarray, num_cand: int = C.NUM_CANDIDATES_PER_PATTERN,
    dec: int = 1,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per (pattern, freq): best lag in each 256-lag slice, then top-k slices
    in descending xb order (k = num_cand, reference fixes it at 8).

    xb: (P, N, F) -> (pos, xb_top) each (F, P, k) with pos in [0, N).

    dec > 1 selects on the COARSE lag grid (every dec-th lag of each slice)
    (config.scan_decimation): positions land on multiples of dec, at most
    dec-1 samples off the full-resolution argmax. The full field is still
    computed; only selection is coarse.
    """
    P = xb.shape[0]
    F = xb.shape[2]
    pad = jnp.concatenate([xb, xb[:, : C.SCAN_PAD_LEN - _N, :]], axis=1)
    sl = pad.reshape(P, C.NUM_SCAN_SLICES, C.SCAN_SLICE, F)
    if dec > 1:
        sl = sl[:, :, ::dec, :]
    slice_max = sl.max(axis=2)  # (P, 21, F)
    slice_arg = (dec * sl.argmax(axis=2)).astype(jnp.int32)
    sm = slice_max.transpose(2, 0, 1)  # (F, P, 21)
    sa = slice_arg.transpose(2, 0, 1)
    top_xb, top_slice = jax.lax.top_k(sm, num_cand)
    pos = (top_slice * C.SCAN_SLICE + jnp.take_along_axis(sa, top_slice, axis=-1)) % _N
    return pos.astype(jnp.int32), top_xb


def scan(
    c: jnp.ndarray, freqs, scan_depth: int,
    num_cand: int = C.NUM_CANDIDATES_PER_PATTERN,
    dec: int = 1,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Full scan of one window: returns (pos, xb), each (F, scan_depth, k).
    `freqs`: static tuple or FreqTables (shardable arrays). dec: coarse
    lag-grid selection (see select_candidates)."""
    G = sync_correlation(c, freqs)
    xb = pattern_metrics(G, scan_depth)
    return select_candidates(xb, num_cand, dec)
