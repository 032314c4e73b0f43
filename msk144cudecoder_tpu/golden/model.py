"""Pure-NumPy golden model of the MSK144 decode chain (and an encoder).

This is the correctness oracle for the JAX/Pallas implementation: every stage
mirrors the reference decoder's math in float64 with straightforward loops.
Stage provenance (file:line in /root/reference/):
  analytic_method2   src/analytic2.cuh:236-258 (shift -fs/8, 15-tap FIR twice
                     with the second pass time-reversed, shift +fs/8, 32-pad)
  analytic_method1   src/analytic_fft.cu:84-157 (8192-pt FFT Hilbert w/ BPF)
  iq_filter          src/analytic2.cuh:261-281 (LPF only)
  scan               src/scan_kernel.cuh:27-366 (mix, pattern-average, 42-tap
                     sync correlation over all lags, per-slice max, top-8)
  demod_softbits     src/softbits_kernel.cuh:9-248 (frame averaging, phase
                     estimate, matched filter, normalization, nbadsync)
  bp_decode          src/ldpc_kernel.cuh:100-248 (log-domain BP, <=10 iters,
                     piecewise-linear atanh, CRC13 + hard-error gate)
The encoder (modulate/synthesize) is new: the reference has no transmitter,
but we need synthetic fixtures since the demo WAV is absent from the snapshot.

One deliberate divergence: the reference's scan can emit aliased candidate
positions pos in [5184, 5376) whose 6-frame averaging then reads one sample
past its buffer (latent OOB in softbits_kernel.cuh:69-74). We canonicalize
pos modulo 5184, which indexes identical data without the OOB.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import constants as C
from ..protocol import crc, ldpc_tables, msg77

# ---------------------------------------------------------------------------
# Encoder (fixture synthesis)
# ---------------------------------------------------------------------------


def frame_bits_from_message(text: str, hashes: Optional[msg77.CallsignHashTable] = None) -> np.ndarray:
    """Message text -> 144 channel bits (sync + LDPC codeword interleave)."""
    bits77 = msg77.pack77(text, hashes)
    info = crc.attach_crc(bits77)
    cw = ldpc_tables.encode(info)
    frame = np.zeros(144, dtype=np.uint8)
    frame[0:8] = C.SYNC_WORD
    frame[8:56] = cw[0:48]
    frame[56:64] = C.SYNC_WORD
    frame[64:144] = cw[48:128]
    return frame


def modulate_frame(bits144: np.ndarray) -> np.ndarray:
    """144 channel bits -> one 864-sample complex MSK baseband frame.

    Even bits ride the Q (imag) rail with half-sine pulses centered on even
    bit boundaries (pulse q spans samples [12q-6, 12q+6) cyclically); odd bits
    ride the I (real) rail spanning [12p, 12p+12). This is the waveform whose
    sync section equals the reference's 42-sample template
    (msk_context.cuh:176-197) and whose matched filter is the demodulator.
    """
    s = 2.0 * np.asarray(bits144, dtype=np.float64) - 1.0
    t = np.arange(C.FRAME_LEN)
    i_rail = np.zeros(C.FRAME_LEN)
    q_rail = np.zeros(C.FRAME_LEN)
    pp = C.PP12
    for p in range(72):
        iidx = (12 * p + np.arange(12)) % C.FRAME_LEN
        i_rail[iidx] += s[2 * p + 1] * pp
        qidx = (12 * p - 6 + np.arange(12)) % C.FRAME_LEN
        q_rail[qidx] += s[2 * p] * pp
    del t
    return i_rail + 1j * q_rail


def synthesize_baseband(
    messages: Sequence[Tuple[str, float]],
    num_frames: int,
    snr_db: Optional[float] = None,
    rng: Optional[np.random.Generator] = None,
    sample_offset: int = 0,
) -> np.ndarray:
    """Complex baseband of repeated MSK144 frames at given carrier offsets.

    messages: list of (text, f0_hz). SNR is per WSJT convention: signal power
    relative to noise power in a 2500 Hz bandwidth.
    """
    rng = rng or np.random.default_rng(0)
    n = num_frames * C.FRAME_LEN
    t = np.arange(sample_offset, sample_offset + n)
    sig = np.zeros(n, dtype=np.complex128)
    for text, f0 in messages:
        bb = modulate_frame(frame_bits_from_message(text))
        tiled = np.tile(bb, num_frames)
        tiled = np.roll(tiled, -sample_offset % C.FRAME_LEN)
        sig += tiled * np.exp(2j * np.pi * f0 * t / C.SAMPLE_RATE)
    if snr_db is not None:
        # complex-noise sigma so that Re(noise) power in 2500 Hz = 1, with
        # Re(signal) power = 1/2 per message (constant-envelope MSK).
        noise_sigma = np.sqrt(0.5 * (C.SAMPLE_RATE / 2) / 2500.0) * np.sqrt(2.0)
        amp = np.sqrt(2.0 * 10 ** (snr_db / 10.0))
        sig = amp * sig + noise_sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return sig


def synthesize_audio_int16(
    messages: Sequence[Tuple[str, float]],
    num_frames: int,
    snr_db: Optional[float] = None,
    rng: Optional[np.random.Generator] = None,
    scale: float = 1000.0,
) -> np.ndarray:
    """Real 16-bit mono audio at 12 kS/s (reference read-mode 1)."""
    bb = synthesize_baseband(messages, num_frames, snr_db, rng)
    audio = bb.real * scale
    return np.clip(np.round(audio), -32768, 32767).astype(np.int16)


def synthesize_pings_int16(
    pings: Sequence[Tuple[str, float, float, int, int]],
    num_frames: int,
    rng: np.random.Generator,
    scale: float = 1000.0,
) -> np.ndarray:
    """16-bit audio of meteor pings over one noise floor: each ping is
    (text, f0_hz, snr_db, start_frame, n_frames), with synthesize_baseband's
    SNR and noise conventions; pings may overlap in time."""
    n = num_frames * C.FRAME_LEN
    sig = np.zeros(n, dtype=np.complex128)
    t = np.arange(n)
    for text, f0, snr, s, L in pings:
        bb = np.tile(modulate_frame(frame_bits_from_message(text)), L)
        amp = np.sqrt(2.0 * 10 ** (snr / 10.0))
        lo, hi = s * C.FRAME_LEN, (s + L) * C.FRAME_LEN
        sig[lo:hi] += amp * bb * np.exp(
            2j * np.pi * f0 * t[lo:hi] / C.SAMPLE_RATE)
    noise_sigma = np.sqrt(0.5 * (C.SAMPLE_RATE / 2) / 2500.0) * np.sqrt(2.0)
    sig += noise_sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return np.clip(np.round(sig.real * scale), -32768, 32767).astype(np.int16)


def synthesize_iq_int8(
    messages: Sequence[Tuple[str, float]],
    num_frames: int,
    snr_db: Optional[float] = None,
    rng: Optional[np.random.Generator] = None,
    scale: float = 24.0,
) -> np.ndarray:
    """Interleaved signed 8-bit I/Q at 12 kS/s (reference read-mode 2)."""
    bb = synthesize_baseband(messages, num_frames, snr_db, rng)
    iq = np.empty(2 * bb.size, dtype=np.int8)
    iq[0::2] = np.clip(np.round(bb.real * scale), -128, 127).astype(np.int8)
    iq[1::2] = np.clip(np.round(bb.imag * scale), -128, 127).astype(np.int8)
    return iq


# ---------------------------------------------------------------------------
# Analytic-signal preprocessing
# ---------------------------------------------------------------------------


def _fir_pass_forward(x: np.ndarray) -> np.ndarray:
    """out[i] = sum_k h[k] * x[i+15-k] over i in [0, len-32); tail unchanged."""
    h = C.FIR15
    out = x.copy()
    n = x.size - 32
    acc = np.zeros(n, dtype=x.dtype)
    for k in range(15):
        if h[k] != 0.0:
            acc += h[k] * x[15 - k : 15 - k + n]
    out[:n] = acc
    return out


def _fir_pass_backward(x: np.ndarray) -> np.ndarray:
    """out[i] = sum_k h[k] * x[i-15+k] over i in [32, len); head unchanged."""
    h = C.FIR15
    out = x.copy()
    n = x.size - 32
    acc = np.zeros(n, dtype=x.dtype)
    for k in range(15):
        if h[k] != 0.0:
            acc += h[k] * x[32 - 15 + k : 32 - 15 + k + n]
    out[32:] = acc
    return out


def _shift_fs8(x: np.ndarray, direction: int) -> np.ndarray:
    """Frequency shift by fs/8; direction=-1 mirrors the reference's 'left'
    table exp(-j*2pi*(n+1)/8), direction=+1 the 'right' table exp(+j*2pi*n/8)
    (analytic2.cuh:12-91; the off-by-one in the left table is a protocol quirk
    amounting to a constant phase that downstream phase estimation removes)."""
    n = np.arange(x.size)
    if direction < 0:
        w = np.exp(-2j * np.pi * (n + 1) / 8.0)
    else:
        w = np.exp(2j * np.pi * n / 8.0)
    return x * w


def analytic_method2(samples: np.ndarray) -> np.ndarray:
    """Real (already normalized) samples -> analytic signal, shift+FIR^2+shift."""
    padded = np.zeros(C.WINDOW_LEN + 2 * C.FIR_PAD, dtype=np.complex128)
    padded[C.FIR_PAD : C.FIR_PAD + C.WINDOW_LEN] = samples
    padded = _shift_fs8(padded, -1)
    padded = _fir_pass_forward(padded)
    padded = _fir_pass_backward(padded)
    padded = _shift_fs8(padded, +1)
    return padded[C.FIR_PAD : C.FIR_PAD + C.WINDOW_LEN]


def iq_filter(samples: np.ndarray) -> np.ndarray:
    """Complex IQ samples -> low-pass filtered (reference apply_filter)."""
    padded = np.zeros(C.WINDOW_LEN + 2 * C.FIR_PAD, dtype=np.complex128)
    padded[C.FIR_PAD : C.FIR_PAD + C.WINDOW_LEN] = samples
    padded = _fir_pass_forward(padded)
    padded = _fir_pass_backward(padded)
    return padded[C.FIR_PAD : C.FIR_PAD + C.WINDOW_LEN]


def analytic_bpf() -> np.ndarray:
    """Raised-cosine band filter for method 1 (analytic_fft.cu:39-58)."""
    nfft = C.ANALYTIC_NFFT
    df = C.SAMPLE_RATE / nfft
    f = np.arange(nfft // 2) * df - C.ANALYTIC_BPF_CENTER
    t = 1.0 / C.ANALYTIC_BPF_WIDTH
    beta = C.ANALYTIC_BPF_BETA
    lo = (1 - beta) / (2 * t)
    hi = (1 + beta) / (2 * t)
    h = np.ones(nfft // 2)
    af = np.abs(f)
    trans = (af > lo) & (af <= hi)
    h[trans] = 0.5 * (1.0 + np.cos((np.pi * t / beta) * (af[trans] - lo)))
    h[af > hi] = 0.0
    return h


def analytic_method1(samples: np.ndarray) -> np.ndarray:
    """Real samples -> analytic signal via 8192-pt FFT Hilbert w/ band filter."""
    nfft = C.ANALYTIC_NFFT
    x = np.zeros(nfft, dtype=np.complex128)
    x[: samples.size] = samples * (2.0 / nfft)
    X = np.fft.fft(x)
    X[: nfft // 2] *= analytic_bpf()
    X[0] *= 0.5
    X[nfft // 2 :] = 0.0
    # reference uses an unnormalized inverse FFT (cuFFT), hence the nfft factor
    out = np.fft.ifft(X) * nfft
    return out[: C.WINDOW_LEN]


def rms_normalize_int16(samples: np.ndarray) -> np.ndarray:
    x = np.asarray(samples, dtype=np.float64)
    rms = np.sqrt(np.mean(x * x))
    return x / rms if rms > 0 else x


# ---------------------------------------------------------------------------
# Stage 1: sync scan
# ---------------------------------------------------------------------------


@dataclass
class Candidate:
    freq_idx: int
    pattern_idx: int
    pos: int
    xb: float
    f0: float
    num_avg: int


def mix_down(cdat: np.ndarray, f0: float) -> np.ndarray:
    t = np.arange(cdat.size)
    return cdat * np.exp(-2j * np.pi * f0 * t / C.SAMPLE_RATE)


def scan_xb(cdat: np.ndarray, f0: float, pattern_idx: int) -> np.ndarray:
    """Correlation magnitude for all 5184 cyclic lags at one (freq, pattern)."""
    z = mix_down(cdat, f0)
    mask = C.PATTERN_MASKS[pattern_idx]
    n = C.WINDOW_LEN
    y = np.zeros(n, dtype=np.complex128)
    for m in range(C.PATTERN_LEN):
        if mask[m]:
            y += np.roll(z, -(864 * m)) + np.roll(z, -(864 * m + C.SECOND_SYNC_SAMPLE))
    # s[lag] = sum_i conj(y[lag+i]) * cb42[i]
    s = np.zeros(n, dtype=np.complex128)
    for i in range(C.SYNC_CORR_LEN):
        s += np.roll(np.conj(y), -i) * C.CB42[i]
    return np.abs(s)


def slice_candidates(xb: np.ndarray, dec: int = 1) -> List[Tuple[int, float]]:
    """(pos, xb) of the top-8 slice maxima of one (freq, pattern) lag field:
    best lag per 256-lag slice, then top-8 of the 21 slice maxima
    (scan_kernel.cuh:85-364 semantics). dec > 1 searches only every dec-th
    lag of each slice (config.scan_decimation)."""
    padded = np.concatenate([xb, xb[: C.SCAN_PAD_LEN - C.WINDOW_LEN]])
    sl = padded.reshape(C.NUM_SCAN_SLICES, C.SCAN_SLICE)[:, ::dec]
    slice_arg = sl.argmax(axis=1)
    slice_max = sl[np.arange(C.NUM_SCAN_SLICES), slice_arg]
    top = np.argsort(-slice_max, kind="stable")[: C.NUM_CANDIDATES_PER_PATTERN]
    return [((int(r) * C.SCAN_SLICE + dec * int(slice_arg[r])) % C.WINDOW_LEN,
             float(slice_max[r])) for r in top]


def scan_candidates(cdat: np.ndarray, freqs: np.ndarray, scan_depth: int,
                    dec: int = 1) -> List[Candidate]:
    """Top-8 candidates per (freq, pattern) (see slice_candidates)."""
    out: List[Candidate] = []
    for fi, f0 in enumerate(freqs):
        for p in range(scan_depth):
            for pos, xb in slice_candidates(scan_xb(cdat, f0, p), dec):
                out.append(
                    Candidate(
                        freq_idx=fi,
                        pattern_idx=p,
                        pos=pos,
                        xb=xb,
                        f0=float(f0),
                        num_avg=int(C.PATTERN_NUM_AVG[p]),
                    )
                )
    return out


# ---------------------------------------------------------------------------
# Stage 2: softbit demodulation
# ---------------------------------------------------------------------------


def demod_softbits(cdat: np.ndarray, cand: Candidate) -> Tuple[np.ndarray, int]:
    """One candidate -> (128 normalized data softbits, nbadsync)."""
    z = mix_down(cdat, cand.f0)
    mask = C.PATTERN_MASKS[cand.pattern_idx]
    frame = np.zeros(C.FRAME_LEN, dtype=np.complex128)
    t = np.arange(C.FRAME_LEN)
    for m in range(C.PATTERN_LEN):
        if mask[m]:
            frame += z[(cand.pos + t + 864 * m) % C.WINDOW_LEN]

    # Carrier-phase estimate over both 42-sample sync regions.
    s = np.sum(frame[0:42] * np.conj(C.CB42)) + np.sum(frame[336 : 336 + 42] * np.conj(C.CB42))
    phase0 = np.arctan2(s.imag, s.real)
    frame = frame * np.exp(-1j * phase0)

    # Matched filter: 144 softbits, interleaved Q,I,Q,I...
    sb = np.zeros(144)
    pp = C.PP12
    for q in range(72):
        idx = (C.FRAME_LEN - 6 + 12 * q + np.arange(12)) % C.FRAME_LEN
        sb[2 * q] = np.sum(frame.imag[idx] * pp)
        idx = (12 * q + np.arange(12)) % C.FRAME_LEN
        sb[2 * q + 1] = np.sum(frame.real[idx] * pp)

    sav = sb.mean()
    s2av = (sb * sb).mean()
    ssig = np.sqrt(s2av - sav * sav)
    scale = 2.0 / (ssig * C.SOFTBIT_SIGMA**2)
    sb_wo_sync = scale * np.concatenate([sb[8:56], sb[64:144]])

    nbadsync = 0
    for base in (C.FIRST_SYNC_BIT, C.SECOND_SYNC_BIT):
        hard = np.where(sb[base : base + 8] < 0.0, -1, 1)
        v = int(np.sum(hard * C.SYNC_WORD_PM))
        nbadsync += (8 - v) // 2
    return sb_wo_sync, nbadsync


# ---------------------------------------------------------------------------
# Stage 3: LDPC belief propagation
# ---------------------------------------------------------------------------


def platanh(x: float) -> float:
    """Piecewise-linear atanh approximation (ldpc_kernel.cuh:65-93)."""
    z = abs(x)
    sign = 1.0 if x >= 0 else -1.0
    if z <= 0.664:
        return x / 0.83
    if z <= 0.9217:
        return sign * (z - 0.4064) / 0.322
    if z <= 0.9951:
        return sign * (z - 0.8378) / 0.0524
    if z <= 0.9998:
        return sign * (z - 0.9914) / 0.0012
    return sign * 7.0


def bp_decode(llr: np.ndarray, max_iters: int = C.NUM_BP_ITERATIONS):
    """Log-domain BP on one candidate. Returns (found, cw, n_iter, n_hard_errors)."""
    NM, MN, DEG = ldpc_tables.NM, ldpc_tables.MN, ldpc_tables.ROW_DEGREE
    tov = np.zeros((128, 3))
    toc = np.zeros((38, 11))
    for it in range(max_iters):
        zn = llr + tov.sum(axis=1)
        cw = (zn > 0.0).astype(np.uint8)
        ncheck = 0
        for r in range(38):
            bits = NM[r, : DEG[r]]
            ncheck += int(cw[bits].sum() % 2)
        if ncheck == 0:
            nerr = int(np.sum(cw != (llr > 0.0)))
            if crc.check_crc(cw[:90]) and nerr < C.MAX_HARD_ERRORS:
                return True, cw, it, nerr
        for b in range(128):
            for k in range(3):
                r, slot = MN[b, k]
                toc[r, slot] = zn[b] - tov[b, k]
        for b in range(128):
            for k in range(3):
                r, slot = MN[b, k]
                prod = 1.0
                for j in range(DEG[r]):
                    if j != slot:
                        prod *= np.tanh(-0.5 * toc[r, j])
                tov[b, k] = 2.0 * platanh(-prod)
    return False, np.zeros(128, dtype=np.uint8), max_iters, 0


# ---------------------------------------------------------------------------
# End-to-end golden decode
# ---------------------------------------------------------------------------


@dataclass
class GoldenDecode:
    candidate: Candidate
    nbadsync: int
    softbits: np.ndarray
    message_bits: np.ndarray
    ldpc_iters: int
    ldpc_errors: int
    text: str


def decode_window(
    cdat: np.ndarray,
    freqs: np.ndarray,
    scan_depth: int,
    nbadsync_threshold: int,
    hashes: Optional[msg77.CallsignHashTable] = None,
) -> List[GoldenDecode]:
    """Full golden pipeline on one preprocessed 5184-sample window."""
    hashes = hashes if hashes is not None else msg77.CallsignHashTable()
    results: List[GoldenDecode] = []
    for cand in scan_candidates(cdat, freqs, scan_depth):
        sb, nbadsync = demod_softbits(cdat, cand)
        if nbadsync > nbadsync_threshold:
            continue
        found, cw, iters, nerr = bp_decode(sb)
        if not found:
            continue
        bits77 = cw[:77]
        if not msg77.plausible_message_type(bits77):
            continue
        ok, text = msg77.unpack77(bits77, hashes)
        if not ok:
            continue
        results.append(GoldenDecode(cand, nbadsync, sb, bits77, iters, nerr, text))
    return results
