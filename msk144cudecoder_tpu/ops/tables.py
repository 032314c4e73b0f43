"""Per-frequency-grid constant tables, as arrays that can be device-sharded.

The reference bakes its frequency grid into kernel geometry (one CUDA block
per channel, /root/reference/src/msk_context.cuh:95-135). Here the grid is
data: four arrays indexed by the frequency axis F. Keeping them as arrays
(rather than jit-constants keyed on a static freqs tuple) is what lets
shard_map split the frequency axis across a device mesh — each device receives
only its slice of every table.

  B   (42, F) complex64   cb42[i] * exp(+2j pi f i / fs)      (scan matmul RHS)
  E   (N, F)  complex64   exp(+2j pi f l / fs)                (lag phase ramp)
  chi (1, F)  complex64   exp(-2j pi f N / fs) - 1            (wrap correction)
  W   (F, N)  complex64   exp(-2j pi f t / fs)                (demod mix-down)

Phases are reduced mod 1 in float64 on the host before complex64 conversion,
matching the reference's per-sample sincosf on wrapped indices.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from .. import constants as C

_N = C.WINDOW_LEN


class FreqTables(NamedTuple):
    B: np.ndarray  # (42, F) complex64
    E: np.ndarray  # (N, F) complex64
    chi: np.ndarray  # (1, F) complex64
    W: np.ndarray  # (F, N) complex64


def build_freq_tables(freqs: np.ndarray) -> FreqTables:
    freqs = np.asarray(freqs, dtype=np.float64)
    i = np.arange(C.SYNC_CORR_LEN)
    B = C.CB42[:, None] * np.exp(2j * np.pi * freqs[None, :] * i[:, None] / C.SAMPLE_RATE)
    t = np.arange(_N)
    phase = np.mod(np.outer(t, freqs) / C.SAMPLE_RATE, 1.0)
    E = np.exp(2j * np.pi * phase)
    chi = np.exp(-2j * np.pi * freqs * _N / C.SAMPLE_RATE) - 1.0
    W = np.exp(-2j * np.pi * phase.T)
    return FreqTables(
        B=B.astype(np.complex64),
        E=E.astype(np.complex64),
        chi=chi[None, :].astype(np.complex64),
        W=W.astype(np.complex64),
    )


@functools.lru_cache(maxsize=None)
def cached_freq_tables(freqs_key: tuple) -> FreqTables:
    return build_freq_tables(np.asarray(freqs_key))


def padded_freqs(freqs: np.ndarray, multiple: int) -> np.ndarray:
    """Extend the frequency grid upward so len divides `multiple` (sharding
    pad). The extra channels are real frequencies past the right boundary —
    harmless additional coverage rather than dead channels."""
    n = len(freqs)
    rem = (-n) % multiple
    if rem == 0:
        return np.asarray(freqs, dtype=np.float64)
    step = freqs[1] - freqs[0] if n > 1 else 1.0
    ext = freqs[-1] + step * np.arange(1, rem + 1)
    return np.concatenate([freqs, ext]).astype(np.float64)
