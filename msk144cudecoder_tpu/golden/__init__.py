"""Float64 NumPy golden model — the correctness oracle for the JAX pipeline."""

from .model import (  # noqa: F401
    Candidate,
    GoldenDecode,
    analytic_method1,
    analytic_method2,
    bp_decode,
    decode_window,
    demod_softbits,
    frame_bits_from_message,
    iq_filter,
    mix_down,
    modulate_frame,
    platanh,
    rms_normalize_int16,
    scan_candidates,
    scan_xb,
    slice_candidates,
    synthesize_audio_int16,
    synthesize_baseband,
    synthesize_iq_int8,
    synthesize_pings_int16,
)
