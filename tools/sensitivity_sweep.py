"""Decode-sensitivity sweep: decode probability vs SNR, JAX pipeline vs the
float64 golden model.

The reference's sensitivity floor comes from 6-frame coherent averaging
(README.md:6); this sweep checks that the pipeline tracks the golden
model's floor — the decode-parity criterion expressed statistically
(per-trial bit-exactness is meaningless at the noise floor where
single-sample rounding flips decodes). Each SNR's trials are seeded windows
(seed 1000 + trial) decoded in one batched call; the decoded trial indices
are printed so runs can be compared trial for trial.

Usage: python tools/sensitivity_sweep.py [--trials 20] [--snrs -4,-6,-8]
       [--platform cpu] [--golden]  (defaults: the deep scan, on the GPU)
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--trials", type=int, default=20)
    p.add_argument("--snrs", type=str, default="-4,-6,-8")
    p.add_argument("--platform", type=str, default=None,
                   help="JAX platform (default cuda; fails without one)")
    p.add_argument("--scan-depth", type=int, default=6)
    p.add_argument("--candidates-per-pattern", type=int, default=8)
    p.add_argument("--search-width", type=float, default=500.0)
    p.add_argument("--search-step", type=float, default=1.0)
    p.add_argument("--max-survivors", type=int, default=256)
    p.add_argument("--survivor-prefilter", type=int, default=None)
    p.add_argument("--nbadsync-threshold", type=int, default=3)
    p.add_argument("--scan-decimation", type=int, default=4)
    p.add_argument("--golden", action="store_true", help="also run the golden model")
    args = p.parse_args()

    from msk144cudecoder_tpu import golden as G
    from msk144cudecoder_tpu.config import DecoderConfig
    from msk144cudecoder_tpu.ops import pipeline
    from msk144cudecoder_tpu.protocol import msg77
    from msk144cudecoder_tpu.runtime.backend import (enable_persistent_cache,
                                                     use_platform)

    dev = use_platform(args.platform)[0]
    enable_persistent_cache()
    if dev.platform == "gpu":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        print(f"card: {smi}")

    cfg = DecoderConfig(search_width=args.search_width,
                        search_step=args.search_step,
                        scan_depth=args.scan_depth,
                        max_survivors=args.max_survivors,
                        survivor_prefilter=args.survivor_prefilter,
                        nbadsync_threshold=args.nbadsync_threshold,
                        candidates_per_pattern=args.candidates_per_pattern,
                        scan_decimation=args.scan_decimation)
    message = "CQ K1ABC FN42"
    snrs = [float(s) for s in args.snrs.split(",")]

    print(f"device={dev.device_kind} message={message!r} F={cfg.num_freqs} "
          f"depth={cfg.scan_depth} dec={cfg.scan_decimation} "
          f"K={cfg.max_survivors} trials={args.trials}")
    print(f"{'SNR dB':>7} | {'jax decode %':>12} | {'golden decode %':>15} | "
          f"decoded trials")
    for snr in snrs:
        audio = np.stack([
            G.synthesize_audio_int16([(message, 1500.0)], 6, snr_db=snr,
                                     rng=np.random.default_rng(1000 + t))
            for t in range(args.trials)])
        res = pipeline.decode_raw(audio, cfg)
        found = np.asarray(res.found)
        bits = pipeline.unpack_message_bits(np.asarray(res.message_bits))
        hits = []
        for t in range(args.trials):
            h = msg77.CallsignHashTable()
            if any(msg77.unpack77(bits[t, k], h) == (True, message)
                   for k in np.nonzero(found[t])[0]):
                hits.append(t)
        gold_hits = 0
        if args.golden:
            for t in range(args.trials):
                cdat = G.analytic_method2(G.rms_normalize_int16(audio[t]))
                golds = G.decode_window(cdat, cfg.freqs, cfg.scan_depth,
                                        cfg.nbadsync_threshold)
                gold_hits += any(g.text == message for g in golds)
        gcol = (f"{100.0 * gold_hits / args.trials:14.0f}%" if args.golden
                else "      (skipped)")
        print(f"{snr:7.1f} | {100.0 * len(hits) / args.trials:11.0f}% | "
              f"{gcol} | {hits}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
