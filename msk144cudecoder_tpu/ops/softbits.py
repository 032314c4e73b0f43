"""Batched softbit demodulation for all scan candidates at once.

Redesign of the reference softbits kernel
(/root/reference/src/softbits_kernel.cuh:9-248). For the full candidate
grid (demod_candidates), instead of re-mixing the whole window per
candidate (the reference launches freq x depth x 8 blocks, each repeating
the mix), we mix once per frequency, build the pattern-averaged signal
ZA_p = sum_m mask_p[m] * roll(z, -864m) once per (freq, pattern), and
gather each candidate's 864-sample frame from it — ZA[(pos+t) mod N] equals
the reference's per-candidate averaged frame. For a prefiltered survivor
subset (demod_survivors) each frame is gathered straight from the window
and the mix table, as the reference's per-candidate blocks do.

Per candidate: carrier-phase estimate over both 42-sample sync regions,
derotation, 12-sample half-sine matched filter producing 144 interleaved
Q/I softbits, normalization by 2/(ssig*sigma^2), extraction of the 128 data
softbits, and the nbadsync sync-quality count.
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


def _mix_table(freqs) -> jnp.ndarray:
    """W (F, N): exp(-2j*pi*f*t/fs) on wrapped indices t in [0, N).
    `freqs`: static tuple or FreqTables (shardable arrays)."""
    if isinstance(freqs, FreqTables):
        return freqs.W
    return cached_freq_tables(tuple(float(f) for f in freqs)).W


@functools.lru_cache(maxsize=None)
def _sync_vec() -> np.ndarray:
    """(864,) vector v with v[i] = conj(cb42[i]) on both sync regions, so the
    phase-estimation sum is a single mat-vec: s = frame @ v."""
    v = np.zeros(C.FRAME_LEN, dtype=np.complex128)
    v[0:42] = np.conj(C.CB42)
    v[336:378] = np.conj(C.CB42)
    return v.astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _matched_filter_mats() -> tuple[np.ndarray, np.ndarray]:
    """Constant tap matrices turning the matched filter into matmuls.

    WQ (864, 72): column q holds pp12 at rows (858 + 12q + i) mod 864 — the
    Q-rail integration windows (softbits_kernel.cuh:156-171 thread 0-71).
    WI (864, 72): column q holds pp12 at rows 12q + i — the I-rail windows
    (threads 72-143). sb_q = imag(d) @ WQ, sb_i = real(d) @ WI.

    The (864, 72) matmul form keeps every axis wide, where a (..., 72, 12)
    reshape + small einsum would leave a 12-wide minor axis.
    """
    WQ = np.zeros((C.FRAME_LEN, 72), dtype=np.float32)
    WI = np.zeros((C.FRAME_LEN, 72), dtype=np.float32)
    pp = C.PP12.astype(np.float32)
    for q in range(72):
        for i in range(12):
            WQ[(858 + 12 * q + i) % C.FRAME_LEN, q] += pp[i]
            WI[12 * q + i, q] += pp[i]
    return WQ, WI


def mix_all(c: jnp.ndarray, freqs) -> jnp.ndarray:
    """(F, N) wrapped-mixed signal for every search frequency."""
    return c[None, :] * jnp.asarray(_mix_table(freqs))


def pattern_average(z: jnp.ndarray, scan_depth: int) -> jnp.ndarray:
    """(F, N) -> (F, P, N): sum_m mask_p[m] * roll(z, -864m), prefix-reused."""
    rolls = [jnp.roll(z, -864 * m, axis=-1) for m in range(C.PATTERN_LEN)]
    out = []
    acc = rolls[0]
    out.append(acc)
    for m in range(1, 6):
        acc = acc + rolls[m]
        out.append(acc)
    out.append(rolls[0] + rolls[3])
    out.append(rolls[0] + rolls[3] + rolls[4])
    return jnp.stack(out[:scan_depth], axis=1)


def gather_frames(za: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """za (F, P, N), pos (F, P, K) -> frames (F, P, K, 864) cyclic windows."""
    zad = jnp.concatenate([za, za[..., : C.FRAME_LEN - 1]], axis=-1)
    idx = pos[..., None] + np.arange(C.FRAME_LEN)[None, None, None, :]
    return jnp.take_along_axis(zad[:, :, None, :], idx, axis=-1)


def demod(frames: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """frames (..., 864) -> (softbits_wo_sync (..., 128), nbadsync (...))."""
    sv = jnp.asarray(_sync_vec())
    s = jnp.einsum("...t,t->...", frames, sv, precision=_HIGHEST)
    phase0 = jnp.arctan2(s.imag, s.real)
    cfac = jax.lax.complex(jnp.cos(phase0), -jnp.sin(phase0))
    d = frames * cfac[..., None]

    WQ, WI = _matched_filter_mats()
    shape = d.shape[:-1]
    sb_q = jnp.matmul(d.imag, jnp.asarray(WQ), precision=_HIGHEST)
    sb_i = jnp.matmul(d.real, jnp.asarray(WI), precision=_HIGHEST)
    sb = jnp.stack([sb_q, sb_i], axis=-1).reshape(shape + (144,))

    sav = sb.mean(axis=-1, keepdims=True)
    s2av = (sb * sb).mean(axis=-1, keepdims=True)
    ssig = jnp.sqrt(jnp.maximum(s2av - sav * sav, 1e-30))
    scale = 2.0 / (ssig * (C.SOFTBIT_SIGMA**2))
    sb_wo_sync = scale * jnp.concatenate([sb[..., 8:56], sb[..., 64:144]], axis=-1)

    s8 = jnp.asarray(C.SYNC_WORD_PM.astype(np.int32))
    nbad = jnp.zeros(shape, dtype=jnp.int32)
    for base in (C.FIRST_SYNC_BIT, C.SECOND_SYNC_BIT):
        hard = jnp.where(sb[..., base : base + 8] < 0.0, -1, 1)
        v = jnp.sum(hard * s8, axis=-1)
        nbad = nbad + (8 - v) // 2
    return sb_wo_sync, nbad


def demod_candidates(
    c: jnp.ndarray, freqs, scan_depth: int, pos: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One window -> softbits (F, P, 8, 128) and nbadsync (F, P, 8)."""
    z = mix_all(c, freqs)
    za = pattern_average(z, scan_depth)
    frames = gather_frames(za, pos)
    return demod(frames)


def survivor_frames(c: jnp.ndarray, freqs, pos: jnp.ndarray,
                    f_idx: jnp.ndarray, p_idx: jnp.ndarray) -> jnp.ndarray:
    """(S,) candidates given by (pos, frequency index, pattern index) ->
    their pattern-averaged, mixed frames (S, 864).

    frame[l] = sum_m mask_p[m] * c[t] * W[f, t],  t = (pos + 864 m + l) mod N

    — the same products summed in the same frame order as
    gather_frames(pattern_average(mix_all(c)), pos) (masked-off frames add
    exact zeros). Each term reads one contiguous 864-sample run of the
    window and of its frequency's mix-table row, both extended by their own
    head so the run never wraps: a block gather per (survivor, frame)."""
    W = jnp.asarray(_mix_table(freqs))  # (F, N)
    L = C.FRAME_LEN
    c_ext = jnp.concatenate([c, c[: L - 1]])
    w_ext = jnp.concatenate([W, W[:, : L - 1]], axis=1)
    masks = jnp.asarray(C.PATTERN_MASKS.astype(np.float32))[p_idx]  # (S, 6)

    def run(f, start):
        return (jax.lax.dynamic_slice(c_ext, (start,), (L,))
                * jax.lax.dynamic_slice(w_ext, (f, start), (1, L))[0])

    acc = None
    for m in range(C.PATTERN_LEN):
        z = jax.vmap(run)(f_idx, (pos + 864 * m) % _N)  # (S, 864)
        z = jnp.where(masks[:, m:m + 1] != 0.0, z, 0.0)
        acc = z if acc is None else acc + z
    return acc


def demod_survivors(c: jnp.ndarray, freqs, pos: jnp.ndarray,
                    f_idx: jnp.ndarray, p_idx: jnp.ndarray
                    ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Demodulate a prefiltered candidate subset: (S,) int32 pos / f_idx /
    p_idx -> (softbits (S, 128), nbadsync (S,))."""
    return demod(survivor_frames(c, freqs, pos, f_idx, p_idx))
