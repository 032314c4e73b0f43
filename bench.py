"""Benchmark: real-time factor on the reference's deep-scan configuration.

Headline metric: real-time factor on one device on the deep scan
(--search-step=1 --search-width=500 --scan-depth=6 --nbadsync-threshold=3,
/root/reference/README.md:65-67). One loop iteration consumes HOP_LEN = 2592
new samples (216 ms of signal, main.cu:283-294); rtf = samples decoded per
wall-second / 12000.

Besides the headline, the JSON line carries candidate_decodes_per_s
(BP-decoded survivors/s and scanned candidates/s), batch-1 latency vs the
210 ms loop budget, IQ-mode and analytic-method-1 rtf rows, and the sharded
(1,1)-mesh ms/window (the single-device anchor of the scaling row).

Prints exactly one JSON line:
  {"metric": ..., "value": N, "unit": ..., ...}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=256,
                   help="windows per device call")
    p.add_argument("--iters", type=int, default=8, help="timed iterations per stream")
    p.add_argument("--streams", type=int, default=4,
                   help="concurrent host threads feeding the device (each "
                        "thread's dispatch+fetch round trips overlap the "
                        "others', like the CLI's pipelined batch mode)")
    p.add_argument("--quick", action="store_true",
                   help="small config for CI/CPU smoke runs")
    p.add_argument("--headline-only", action="store_true",
                   help="skip the secondary rows (IQ, method-1, sharded mesh)")
    p.add_argument("--platform", type=str, default=None,
                   help="JAX platform (default cuda; fails without one)")
    args = p.parse_args()

    import jax

    from msk144cudecoder_tpu.runtime.backend import (
        NoDeviceError, enable_persistent_cache, use_platform)

    try:
        use_platform(args.platform)
    except NoDeviceError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    enable_persistent_cache()
    from msk144cudecoder_tpu import constants as C
    from msk144cudecoder_tpu import golden as G
    from msk144cudecoder_tpu.config import DecoderConfig
    from msk144cudecoder_tpu.ops import pipeline

    if args.quick:
        cfg = DecoderConfig(search_width=100.0, scan_depth=3, max_survivors=128)
    else:
        cfg = DecoderConfig(search_step=1.0, search_width=500.0, scan_depth=6,
                            nbadsync_threshold=3)

    rng = np.random.default_rng(0)
    msg_audio = G.synthesize_audio_int16(
        [("CQ K1ABC FN42", 1500.0)], 6, snr_db=4.0, rng=rng
    )
    noise = rng.normal(0.0, 1000.0, (args.batch - 1, C.WINDOW_LEN)).astype(np.int16)
    raw = np.concatenate([msg_audio[None, :], noise]) if args.batch > 1 else msg_audio[None, :]

    dev = jax.devices()[0]
    print(f"bench: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())} "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} cfg: F={cfg.num_freqs} "
          f"P={cfg.scan_depth} K={cfg.max_survivors} batch={args.batch}",
          file=sys.stderr)

    # Device-resident input: the metric is device throughput; the CLI's
    # pipelined batch mode overlaps ingest with compute the same way.

    def measure(fn, raw_np, streams, iters, batch, putter=None):
        """ms/window through fn on `streams` concurrent host threads.
        Every iteration's (compacted) found flags are fetched to the host,
        as a real consumer reads results per window; independent streams
        from separate host threads overlap the dispatch+fetch round
        trips."""
        put = putter if putter is not None else (lambda a: jax.device_put(a, dev))
        raws = [put(raw_np) for _ in range(streams)]
        for r_ in raws:  # compile + warm every stream's buffer
            np.asarray(fn(r_).found)
        t0 = time.perf_counter()
        ths = [threading.Thread(
            target=lambda rd: [np.asarray(fn(rd).found) for _ in range(iters)],
            args=(r_,)) for r_ in raws]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        dt = time.perf_counter() - t0
        return dt / (streams * iters * batch) * 1e3

    raw_dev = jax.device_put(raw, dev)
    t0 = time.perf_counter()
    res = pipeline.decode_raw(raw_dev, cfg)
    jax.block_until_ready(res)
    compile_s = time.perf_counter() - t0
    print(f"bench: first call (compile+run) {compile_s:.1f}s", file=sys.stderr)

    # sanity: the planted message must decode
    assert bool(np.asarray(res.found[0]).any()), "bench stimulus failed to decode"

    # best of 3 passes; the per-pass values are printed for audit
    passes = [measure(lambda r_: pipeline.decode_raw(r_, cfg), raw,
                      args.streams, args.iters, args.batch)
              for _ in range(1 if args.quick else 3)]
    ms_win = min(passes)
    passes_r = sorted(round(p, 4) for p in passes)
    print(f"bench: passes {passes_r} ms/window", file=sys.stderr)
    per_window_s = ms_win / 1e3
    samples_per_s = C.HOP_LEN / per_window_s
    rtf = samples_per_s / C.SAMPLE_RATE
    # candidate decode rates (BASELINE.md metric): BP-decoded survivors per
    # second (each window batch-decodes the full static K-survivor LDPC
    # batch) and scan candidates searched per second (F * depth * 8 sync
    # lags demodulation-ranked per window)
    cand_decodes_per_s = cfg.max_survivors / per_window_s
    cand_scanned_per_s = cfg.num_candidates / per_window_s
    print(f"bench: {ms_win:.2f} ms/window  {samples_per_s:,.0f} samples/s  "
          f"rtf={rtf:,.1f}x  {cand_decodes_per_s:,.0f} BP decodes/s  "
          f"{cand_scanned_per_s:,.0f} candidates scanned/s", file=sys.stderr)

    # batch-1 latency: the real-time streaming case (one 432 ms window per
    # call, fetch results) must land far inside the 216 ms loop budget
    raw1 = jax.device_put(raw[:1], dev)
    res1 = pipeline.decode_raw(raw1, cfg)
    np.asarray(res1.found)
    lat = []
    for _ in range(max(args.iters, 8)):
        t0 = time.perf_counter()
        res1 = pipeline.decode_raw(raw1, cfg)
        np.asarray(res1.found)
        lat.append(time.perf_counter() - t0)
    latency_b1_ms = min(lat) * 1e3
    print(f"bench: batch-1 latency {latency_b1_ms:.2f} ms/loop "
          f"(budget 210 ms)", file=sys.stderr)

    out = {
        "metric": "real_time_factor_deep_scan" if not args.quick else "real_time_factor_quick",
        "value": round(rtf, 2),
        "unit": "x_realtime_per_device",
        "latency_b1_ms": round(latency_b1_ms, 2),
        "peak_samples_per_s": round(samples_per_s),
        "candidate_decodes_per_s": round(cand_decodes_per_s),
        "candidates_scanned_per_s": round(cand_scanned_per_s),
        "batch": args.batch,
        # per-pass audit trail: the headline is best-of-N; the spread is in
        # the artifact, not just stderr
        "headline_passes_ms": passes_r,
        "headline_median_ms": passes_r[len(passes_r) // 2],
    }
    if not args.headline_only:
        sec_iters = max(2, args.iters // 4)

        # IQ read mode (read_mode=2: 2x8-bit signed, LPF-only preprocessing,
        # center 0 Hz — main.cu:334-381)
        cfg_iq = cfg.replace(read_mode=2, center_frequency=0.0)
        iq = G.synthesize_iq_int8([("CQ K1ABC FN42", 0.0)], 6, snr_db=4.0,
                                  rng=np.random.default_rng(2))
        iq_noise = (np.random.default_rng(3).normal(0.0, 16.0,
                    (args.batch - 1, 2 * C.WINDOW_LEN))).astype(np.int8)
        raw_iq = np.concatenate([iq[None, :], iq_noise])
        res_iq = pipeline.decode_raw(jax.device_put(raw_iq, dev), cfg_iq)
        assert bool(np.asarray(res_iq.found[0]).any()), "IQ stimulus failed to decode"
        ms_iq = measure(lambda r_: pipeline.decode_raw(r_, cfg_iq), raw_iq,
                        args.streams, sec_iters, args.batch)
        out["rtf_iq_mode"] = round(C.HOP_LEN / (ms_iq / 1e3) / C.SAMPLE_RATE, 2)
        print(f"bench: IQ mode {ms_iq:.2f} ms/window rtf={out['rtf_iq_mode']:,}x",
              file=sys.stderr)

        # analytic method 1 (8192-pt FFT Hilbert + band filter)
        cfg_m1 = cfg.replace(analytic_method=1)
        res_m1 = pipeline.decode_raw(raw_dev, cfg_m1)
        assert bool(np.asarray(res_m1.found[0]).any()), "method-1 stimulus failed to decode"
        ms_m1 = measure(lambda r_: pipeline.decode_raw(r_, cfg_m1), raw,
                        args.streams, sec_iters, args.batch)
        out["rtf_analytic_method1"] = round(C.HOP_LEN / (ms_m1 / 1e3) / C.SAMPLE_RATE, 2)
        print(f"bench: method 1 {ms_m1:.2f} ms/window "
              f"rtf={out['rtf_analytic_method1']:,}x", file=sys.stderr)

        # the reference's DEFAULT configuration (200 Hz / 2 Hz / depth 4 /
        # threshold 1, main.cu:122-133) — what a stock invocation runs
        cfg_def = DecoderConfig()
        res_def = pipeline.decode_raw(raw_dev, cfg_def)
        assert bool(np.asarray(res_def.found[0]).any()), "default-config stimulus failed to decode"
        ms_def = measure(lambda r_: pipeline.decode_raw(r_, cfg_def), raw,
                         args.streams, sec_iters, args.batch)
        out["rtf_default_config"] = round(C.HOP_LEN / (ms_def / 1e3) / C.SAMPLE_RATE, 2)
        print(f"bench: default config {ms_def:.3f} ms/window "
              f"rtf={out['rtf_default_config']:,}x", file=sys.stderr)

        # scan-decimation ablation (round-5): the headline runs the dec=4
        # default; record dec=1 (the reference's exact per-lag grid) and
        # dec=2 so the coarse-grid win is auditable from the artifact
        for dec_ab in (1, 2):
            cfg_ab = cfg.replace(scan_decimation=dec_ab)
            res_ab = pipeline.decode_raw(raw_dev, cfg_ab)
            assert bool(np.asarray(res_ab.found[0]).any())
            ms_ab = measure(lambda r_: pipeline.decode_raw(r_, cfg_ab), raw,
                            args.streams, sec_iters, args.batch)
            out[f"rtf_scan_dec{dec_ab}"] = round(
                C.HOP_LEN / (ms_ab / 1e3) / C.SAMPLE_RATE, 2)
            print(f"bench: scan dec={dec_ab} {ms_ab:.3f} ms/window "
                  f"rtf={out[f'rtf_scan_dec{dec_ab}']:,}x", file=sys.stderr)

        # sharded (1,1)-mesh path: the scaling row's single-device anchor —
        # the shard_map layout must match the unsharded jit
        from jax.sharding import NamedSharding, PartitionSpec as P

        from msk144cudecoder_tpu.parallel.sharding import MeshDecoder, make_mesh

        mesh = make_mesh(n_time=1, n_freq=1, devices=[dev])
        md = MeshDecoder(cfg, mesh)
        in_shard = NamedSharding(mesh, P("time", None))
        res_sh = md.decode(jax.device_put(raw, in_shard))
        assert bool(np.asarray(res_sh.found[0]).any()), "sharded stimulus failed to decode"
        # ALTERNATING sharded/unsharded trials: the ratio must compare
        # contemporaneous draws of both paths
        sh_ms, pl_ms = [], []
        for _ in range(3):
            sh_ms.append(measure(md.decode, raw, args.streams, sec_iters,
                                 args.batch,
                                 putter=lambda a: jax.device_put(a, in_shard)))
            pl_ms.append(measure(lambda r_: pipeline.decode_raw(r_, cfg),
                                 raw, args.streams, sec_iters, args.batch))
        ms_sh, ms_pl = min(sh_ms), min(pl_ms)
        out["sharded_1x1_ms_per_window"] = round(ms_sh, 4)
        out["sharded_unsharded_alternating_ms"] = round(ms_pl, 4)
        out["sharded_vs_unsharded_ratio"] = round(ms_sh / ms_pl, 4)
        out["sharded_trials_ms"] = {
            "sharded": [round(x, 4) for x in sh_ms],
            "unsharded": [round(x, 4) for x in pl_ms]}
        out["sharded_protocol"] = "alternating trials, best-of-3 each"
        print(f"bench: sharded (1,1) mesh {ms_sh:.3f} vs unsharded "
              f"{ms_pl:.3f} ms/window (alternating; ratio "
              f"{ms_sh / ms_pl:.3f})", file=sys.stderr)

    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
