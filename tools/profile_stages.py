"""Where the deep-scan decode spends its device time on a GPU.

  1. One jax.profiler trace of decode_raw at the deep scan (F=501, P=6,
     K=256) on a window batch: per pipeline stage (the jax.named_scope
     names in ops/pipeline.py: preprocess, scan, prefilter, demod, select,
     bp, compact) the summed device time of its kernels, the device's busy
     and idle share of the traced window, and each stage's HBM roofline —
     the bytes XLA's cost analysis says the stage's own program accesses,
     over 4.8 TB/s (H200 HBM3e, NVIDIA data sheet).
  2. The fused BP kernel against ldpc.bp_decode: alone at B*K rows of real
     survivor LLRs, and end to end in the same decode program with either
     BP, timed in turns (reference, kernel, kernel, reference).
  3. BP's bit->edge copy by plain indexing against a HIGHEST one-hot
     matmul (the two exact forms on a CUDA device).
  4. The largest window batch that compiles and runs at the deep scan.

Usage: python tools/profile_stages.py [--batch 64] [--out DIR] [--per-kernel]
Prints a summary; writes summary.json and the trace under DIR (default
out/profile). XLA runs a jitted program as one CUDA command buffer,
which the trace shows as a single event; --per-kernel turns command buffers
off for this process so the trace attributes each kernel to its stage (at
the cost of one launch per kernel in every timing it takes).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAGES = ("preprocess", "scan", "prefilter", "demod", "select", "bp",
          "compact")
HBM_BYTES_PER_S = 4.8e12  # H200 (NVIDIA data sheet)


def timed(fn, *args, reps=5) -> float:
    """Median ms per call after a warm-up, each call blocked on."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def op_scopes(hlo_text: str) -> dict:
    """Optimized-HLO instruction name -> pipeline stage, from each
    instruction's op_name metadata (the named_scope path)."""
    out = {}
    for m in re.finditer(r"%?([\w.\-]+) = [^\n]*?metadata=\{[^}]*op_name=\"([^\"]*)\"",
                         hlo_text):
        for p in m.group(2).split("/"):
            p = re.sub(r"^vmap\((.*)\)$", r"\1", p)  # scopes under vmap
            if p in STAGES:
                out[m.group(1)] = p
                break
    return out


def reduce_trace(trace_dir: str, scopes: dict) -> dict:
    """Per-stage device ms, busy and idle share from the xplane trace."""
    import jax

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    per = {s: 0.0 for s in STAGES}
    per["other"] = 0.0
    intervals = []
    unknown = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "stream" not in line.name.lower():
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                op = str(stats.get("hlo_op", ev.name))
                st = scopes.get(op)
                if st is None:
                    st = "other"
                    unknown[op] = unknown.get(op, 0.0) + ev.duration_ns / 1e6
                per[st] += ev.duration_ns / 1e6
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    intervals.sort()
    busy, end, t0 = 0.0, None, intervals[0][0] if intervals else 0
    t1 = max(b for _, b in intervals) if intervals else 0
    for a, b in intervals:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    span = (t1 - t0) / 1e6
    top_other = sorted(unknown.items(), key=lambda kv: -kv[1])[:8]
    return {"stage_ms": {k: round(v, 4) for k, v in per.items()},
            "busy_ms": round(busy / 1e6, 4), "span_ms": round(span, 4),
            "idle_share": round(1 - busy / 1e6 / span, 4) if span else None,
            "unattributed_top": [(k, round(v, 4)) for k, v in top_other],
            "trace": path}


def bytes_accessed(fn, *args) -> float:
    ca = fn.lower(*args).compile().cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    return float(ca.get("bytes accessed", 0.0)) if ca else 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--out", default="out/profile")
    ap.add_argument("--fit", default="64,128,256,512",
                    help="window batches to try for the memory fit")
    ap.add_argument("--per-kernel", action="store_true",
                    help="trace without command buffers (see above)")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    if args.per_kernel:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_enable_command_buffer=")

    import jax
    import jax.numpy as jnp

    from msk144cudecoder_tpu import constants as C
    from msk144cudecoder_tpu import golden as G
    from msk144cudecoder_tpu.config import DecoderConfig
    from msk144cudecoder_tpu.ops import bp_kernel, ldpc, pipeline, scan, softbits
    from msk144cudecoder_tpu.runtime.backend import (enable_persistent_cache,
                                                     use_platform)

    dev = use_platform()[0]
    enable_persistent_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi} | jax {jax.__version__} {dev.device_kind}")
    summary: dict = {"card": smi, "batch": args.batch,
                     "xla_flags": os.environ.get("XLA_FLAGS", "")}

    cfg = DecoderConfig(search_step=1.0, search_width=500.0, scan_depth=6,
                        nbadsync_threshold=3)
    freqs = tuple(float(f) for f in cfg.freqs)
    B, K = args.batch, cfg.max_survivors
    rng = np.random.default_rng(0)
    ping = G.synthesize_audio_int16([("CQ K1ABC FN42", 1500.0)], 6,
                                    snr_db=0.0, rng=rng)
    noise = rng.normal(0, 1000, (B - 1, C.WINDOW_LEN)).astype(np.int16)
    raw = jax.device_put(np.concatenate([ping[None], noise]), dev)

    # 1. trace + per-stage roofline -----------------------------------
    dec = jax.jit(lambda r: pipeline.decode_raw(r, cfg))
    compiled = dec.lower(raw).compile()
    jax.block_until_ready(dec(raw))
    tdir = os.path.join(args.out, "trace")
    jax.profiler.start_trace(tdir)
    for _ in range(3):
        jax.block_until_ready(dec(raw))
    jax.profiler.stop_trace()
    tr = reduce_trace(tdir, op_scopes(compiled.as_text()))
    for k in tr["stage_ms"]:
        tr["stage_ms"][k] = round(tr["stage_ms"][k] / 3, 4)
    tr["busy_ms"] = round(tr["busy_ms"] / 3, 4)

    c = jax.jit(lambda r: pipeline.preprocess(r, cfg))(raw)
    scan_fn = jax.jit(jax.vmap(lambda w: scan.scan(
        w, freqs, cfg.scan_depth, dec=cfg.scan_decimation)))
    pos, xb = scan_fn(c)
    pre = pipeline.resolve_prefilter(cfg, cfg.num_candidates)
    per_cell = pipeline.prefilter_per_cell(cfg, cfg.num_freqs * 6, pre)
    pf_fn = jax.jit(jax.vmap(lambda p, x: pipeline.prefilter_select(
        x, p, pre, per_cell, None)))
    front = pf_fn(pos, xb)
    dm_fn = jax.jit(jax.vmap(lambda w, p, f, q: softbits.demod_survivors(
        w, freqs, p, f, q)))
    sb, nbad = dm_fn(c, front[1], front[2], front[3])
    prep_fn = jax.jit(jax.vmap(lambda w: pipeline.prepare_window(w, freqs, cfg)))
    prep = prep_fn(c)
    llr = prep.llr.reshape(B * K, 128)
    valid = prep.valid.reshape(B * K)
    bp_fn = jax.jit(pipeline.bp_stage)
    bp = bp_fn(llr, valid)
    bp_b = jax.tree_util.tree_map(lambda a: a.reshape((B, K) + a.shape[1:]), bp)
    fin_fn = jax.jit(jax.vmap(lambda pr, bb: pipeline.finish_window(pr, bb, cfg)))
    sel_fn = jax.jit(jax.vmap(lambda n, x: pipeline._select_top(
        cfg, n, x, pre, 6, True, None)))
    nbytes = {
        "preprocess": bytes_accessed(
            jax.jit(lambda r: pipeline.preprocess(r, cfg)), raw),
        "scan": bytes_accessed(scan_fn, c),
        "prefilter": bytes_accessed(pf_fn, pos, xb),
        "demod": bytes_accessed(dm_fn, c, front[1], front[2], front[3]),
        "select": bytes_accessed(sel_fn, nbad, front[0]),
        # the Pallas call reports no cost: LLRs + validity in, results out
        "bp": float(B * K * (128 * 4 + 4 + 4 + 128 * 4 + 3 * 4)),
        "compact": bytes_accessed(fin_fn, prep, bp_b),
    }
    tr["roofline"] = {}
    print(f"trace of decode_raw, deep scan, batch {B} (per call): busy "
          f"{tr['busy_ms']} ms, idle share {tr['idle_share']}")
    for s in STAGES:
        t_roof = nbytes[s] / HBM_BYTES_PER_S * 1e3
        ms = tr["stage_ms"][s]
        share = t_roof / ms if ms else None
        tr["roofline"][s] = {"bytes": nbytes[s], "roof_ms": round(t_roof, 4),
                             "share": round(share, 4) if share else None}
        print(f"  {s:10s} {ms:9.4f} ms  {nbytes[s] / 1e6:10.1f} MB  "
              f"roofline {t_roof:8.4f} ms  share {share if share is None else round(share, 3)}")
    print(f"  other      {tr['stage_ms']['other']:9.4f} ms  top "
          f"{tr['unattributed_top'][:4]}")
    summary["trace"] = tr

    # 2. BP kernel vs reference: alone and end to end ------------------
    ref_bp = jax.jit(ldpc.bp_decode)
    ker_bp = jax.jit(bp_kernel.bp_decode)
    alone = {"ref_ms": timed(ref_bp, llr, valid),
             "kernel_ms": timed(ker_bp, llr, valid)}

    def decode_with(bp_impl):
        def f(r):
            orig = pipeline.bp_stage
            pipeline.bp_stage = bp_impl  # swapped while this traces
            try:
                return pipeline.decode_windows(
                    pipeline.preprocess(r, cfg), freqs, cfg)
            finally:
                pipeline.bp_stage = orig
        return jax.jit(f)

    e2e_ref, e2e_ker = decode_with(ldpc.bp_decode), decode_with(
        bp_kernel.bp_decode)
    order = [("ref", e2e_ref), ("kernel", e2e_ker), ("kernel", e2e_ker),
             ("ref", e2e_ref)]
    e2e = {"ref": [], "kernel": []}
    for name, fn in order:
        e2e[name].append(timed(fn, raw) / B)
    summary["bp"] = {"rows": B * K, "alone": alone, "e2e_ms_per_window": e2e}
    print(f"BP alone at {B * K} rows: ldpc.bp_decode {alone['ref_ms']:.3f} "
          f"ms, bp_kernel {alone['kernel_ms']:.3f} ms")
    print(f"decode end to end, ms/window (ref, kernel, kernel, ref): "
          f"ref {e2e['ref']} kernel {e2e['kernel']}")

    # 3. bit->edge copy: indexing vs HIGHEST one-hot matmul --------------
    sel = np.zeros((128, 418), np.float32)
    for e, b in enumerate(ldpc._tables()["EDGE_BIT"]):
        sel[b, e] = 1.0
    sel_j = jnp.asarray(sel)

    def with_edges(edge_fn):
        def f(l, v):
            orig = ldpc.bit_to_edges
            ldpc.bit_to_edges = edge_fn
            try:
                return ldpc.bp_decode(l, v)
            finally:
                ldpc.bit_to_edges = orig
        return jax.jit(f)

    idx_ms = timed(with_edges(ldpc.bit_to_edges), llr, valid)
    mm_ms = timed(with_edges(lambda zn: jnp.matmul(
        zn, sel_j, precision=jax.lax.Precision.HIGHEST)), llr, valid)
    summary["edge_copy"] = {"indexing_ms": idx_ms, "highest_matmul_ms": mm_ms}
    print(f"ldpc.bp_decode with bit->edge by indexing {idx_ms:.3f} ms, by "
          f"HIGHEST matmul {mm_ms:.3f} ms")

    # 4. window-batch fit -------------------------------------------------
    fit = {}
    for b in [int(x) for x in args.fit.split(",") if x]:
        r = jax.device_put(np.resize(np.asarray(raw), (b, C.WINDOW_LEN)), dev)
        t0 = time.perf_counter()
        try:
            comp = dec.lower(r).compile()
            ma = comp.memory_analysis()
            jax.block_until_ready(comp(r))
            ms = timed(comp, r, reps=3)
            fit[b] = {"ok": True, "compile_run_s": round(
                time.perf_counter() - t0, 2), "ms_per_window": round(ms / b, 4),
                "temp_bytes": getattr(ma, "temp_size_in_bytes", None)}
        except Exception as e:  # out of memory, most likely
            fit[b] = {"ok": False, "error": str(e).splitlines()[0][:200]}
        print(f"window batch {b}: {fit[b]}")
    summary["fit"] = fit
    summary["peak_bytes_in_use"] = dev.memory_stats().get("peak_bytes_in_use")
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
