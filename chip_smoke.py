#!/usr/bin/env python3
"""Smoke test of the MSK144 decoder on an NVIDIA GPU.

Drives the main path once through the entry points a user calls, at the
reference's deepest documented configuration (--search-step=1
--search-width=500 --scan-depth=6 --nbadsync-threshold=3: F=501, P=6,
24,048 candidate slots, K=256), and checks every result by the repo's own
means:

  1. shell   the real shell, `python -m msk144cudecoder_tpu`, on 60 s of
             stream synthesised from a seed with 8 planted messages at mixed
             frequency and SNR (one at -4 dB that needs num_avg > 1): once
             per window, once with --window-batch 64; every plant decodes
             and both runs print the same lines. Then the stock
             configuration, IQ mode and analytic method 1 on their own
             stimuli.
  2. parity  the GPU against the CPU backend in one process, on 8
             deep-scan windows: scan candidates, survivor softbits and
             decoded messages.
  3. bp      the compiled fused BP kernel (ops/bp_kernel.py) against the
             plain ldpc.bp_decode at 65,536 real rows and on the busy-band
             batch, with both timings.
  4. busy    the busy-band battery (tests/test_busyband.py's stimulus).

`--four-cards` runs instead only the multi-card path and the one-card run
it is compared with: `python -m msk144cudecoder_tpu.parallel` over four
cards in one process (--mesh-time 1), and as four processes with one card
each.

Every phase runs in a child process of its own, one after another, so one
process holds a card at a time; this parent never touches the GPU. Each
phase prints its results and time. The last line of stdout is one JSON
object, {"ok": ..., "device": {"platform", "kind", "count"}}; the exit code
is 0 only when every phase passed on a GPU.

Usage: python chip_smoke.py [--four-cards] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEEP = ["--search-step", "1", "--search-width", "500", "--scan-depth", "6",
        "--nbadsync-threshold", "3"]
# 8 planted messages over 60 s of stream: (text, f0 Hz, SNR dB, start frame,
# frames). Windows are 6 frames at a 3-frame hop, so a 6-frame ping starting
# on a multiple of 3 fills one window exactly — the -4 dB ping needs that
# window's 6-frame average (num_avg > 1) to decode.
PLANTS = [
    ("CQ K1ABC FN42", 1500.0, 6.0, 9, 4),
    ("K1ABC W9XYZ EN37", 1312.0, 3.0, 110, 5),
    ("W9XYZ K1ABC R-03", 1693.0, 0.0, 186, 6),
    ("CQ N0XYZ DM79", 1421.0, 8.0, 312, 3),
    ("N0XYZ K1ABC -08", 1577.0, 2.0, 414, 6),
    ("CQ G4ABC IO91", 1266.0, 5.0, 516, 4),
    ("K9AN N0XYZ 73", 1735.0, -4.0, 618, 6),
    ("CQ W1AW FN31", 1450.0, 1.0, 720, 5),
]
N_FRAMES = 834  # 60.05 s at 864 samples per 72 ms frame
SEED = 2024


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- helpers


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["PYTHONFAULTHANDLER"] = "1"  # a crashing child prints its stack
    return env


def _run(cmd, timeout, stdin_path=None, env=None) -> subprocess.CompletedProcess:
    """Run cmd to its end; a command past its time limit is killed and
    reported with return code 124."""
    stdin = open(stdin_path, "rb") if stdin_path else subprocess.DEVNULL
    try:
        return subprocess.run(cmd, stdin=stdin, capture_output=True,
                              text=True, timeout=timeout, cwd=ROOT,
                              env=env or _env())
    except subprocess.TimeoutExpired as e:
        out = e.stdout.decode() if isinstance(e.stdout, bytes) else e.stdout
        err = e.stderr.decode() if isinstance(e.stderr, bytes) else e.stderr
        return subprocess.CompletedProcess(cmd, 124, out or "",
                                           (err or "") + "\n[timed out]")
    finally:
        if stdin_path:
            stdin.close()


def _lines(out: str, keep_snr: bool = True) -> list[str]:
    """Decode lines minus the wall-clock date (and optionally the snr)."""
    res = []
    for ln in out.splitlines():
        if ln.startswith("***"):
            ln = re.sub(r"date=\d+; ", "", ln)
            if not keep_snr:
                ln = re.sub(r"snr=\s*-?\d+; ", "", ln)
            res.append(ln)
    return res


def _grab(pattern: str, text: str) -> str | None:
    m = re.search(pattern, text)
    return m.group(1) if m else None


def _child(phase: str, out_dir: str, timeout: int) -> dict:
    """Run one phase in a child process; its last stdout line is JSON."""
    t0 = time.time()
    p = _run([sys.executable, os.path.abspath(__file__), "--phase", phase,
              "--out", out_dir], timeout)
    for ln in p.stdout.splitlines()[:-1]:
        log(f"  [{phase}] {ln}")
    try:
        res = json.loads(p.stdout.splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        res = {"ok": False}
    if p.returncode != 0:
        res["ok"] = False
        log(f"  [{phase}] exit {p.returncode}; stderr tail:\n"
            + p.stderr[-3000:])
    res["seconds"] = round(time.time() - t0, 1)
    return res


# ------------------------------------------------------------- stimuli


def make_stimuli(out_dir: str) -> dict:
    """Synthesise every stimulus from SEED; returns name -> file path."""
    import numpy as np

    sys.path.insert(0, ROOT)
    from msk144cudecoder_tpu import golden as G

    rng = np.random.default_rng(SEED)
    files = {}

    def save(name, arr):
        path = os.path.join(out_dir, name)
        arr.tofile(path)
        files[name] = path

    deep = G.synthesize_pings_int16(PLANTS, N_FRAMES, rng)
    save("deep.raw", deep)
    save("deep_short.raw", deep[: 20 * 12000])
    save("stock.raw", G.synthesize_audio_int16(
        [("CQ K1ABC FN42", 1450.0), ("K1ABC W9XYZ EN37", 1562.0)], 9,
        snr_db=3.0, rng=rng))
    save("iq.raw", G.synthesize_iq_int8(
        [("CQ N0XYZ DM79", -48.0), ("W9XYZ K1ABC R-03", 66.0)], 9,
        snr_db=3.0, rng=rng))
    save("method1.raw", G.synthesize_audio_int16(
        [("CQ G4ABC IO91", 1530.0), ("K9AN N0XYZ 73", 1444.0)], 9,
        snr_db=3.0, rng=rng))
    return files


# ------------------------------------------------------ phase 1: the shell


def phase_shell(out_dir: str) -> dict:
    files = make_stimuli(out_dir)
    cli = [sys.executable, "-m", "msk144cudecoder_tpu"]
    cache = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
             or os.path.join(ROOT, ".jax_cache"))
    res = {"cache_dir": cache, "cache_existed": os.path.isdir(cache)}
    ok = True

    def shell(name, args, stim, expect, timeout=600):
        nonlocal ok
        t0 = time.time()
        p = _run(cli + args, timeout, stdin_path=files[stim])
        wall = time.time() - t0
        lines = _lines(p.stdout)
        got = {_grab(r"msg='([^']*)'", ln) for ln in lines}
        missing = sorted(set(expect) - got)
        first = _grab(r"First results \(compile \+ run\): ([\d.]+) s", p.stderr)
        peak = _grab(r"Device peak memory: (\d+) bytes", p.stderr)
        thr = _grab(r"(Throughput: .*)", p.stderr)
        good = p.returncode == 0 and not missing
        ok = ok and good
        log(f"shell {name}: rc={p.returncode} wall={wall:.1f}s "
            f"first_results={first}s lines={len(lines)} "
            f"missing={missing} peak_bytes_in_use={peak}"
            + (f" | {thr}" if thr else ""))
        if not good:
            log(p.stderr[-3000:])
        res[name] = {"ok": good, "wall_s": round(wall, 2),
                     "first_results_s": first, "peak_bytes_in_use": peak,
                     "throughput": thr, "missing": missing}
        return lines

    planted = [p[0] for p in PLANTS]
    per_win = shell("deep_per_window", DEEP, "deep.raw", planted)
    batched = shell("deep_batch64", DEEP + ["--window-batch", "64"],
                    "deep.raw", planted)
    same = per_win == batched
    ok = ok and same
    log(f"shell deep: per-window and --window-batch 64 lines identical: "
        f"{same} ({len(per_win)} lines)")
    if not same:
        log("  per-window only: " + str(sorted(set(per_win) - set(batched))))
        log("  batch-64 only:   " + str(sorted(set(batched) - set(per_win))))
    weak = [ln for ln in per_win if "K9AN N0XYZ 73" in ln]
    avg = [int(_grab(r"num_avg=(\d+)", ln)) for ln in weak]
    log(f"shell deep: -4 dB plant decoded with num_avg {avg}")
    ok = ok and bool(avg) and min(avg) > 1
    res["weak_num_avg"] = avg
    # warm start: the same shape again, now from the compilation cache
    shell("deep_warm", DEEP, "deep_short.raw", ["CQ K1ABC FN42"])
    shell("stock", [], "stock.raw", ["CQ K1ABC FN42", "K1ABC W9XYZ EN37"])
    shell("iq", ["--read-mode", "2"], "iq.raw",
          ["CQ N0XYZ DM79", "W9XYZ K1ABC R-03"])
    shell("method1", ["--analytic-method", "1"], "method1.raw",
          ["CQ G4ABC IO91", "K9AN N0XYZ 73"])
    res["deep_lines"] = per_win
    res["ok"] = ok
    return res


# ---------------------------------------------- phases run in a child


def _deep_cfg(**kw):
    from msk144cudecoder_tpu.config import DecoderConfig

    return DecoderConfig(search_step=1.0, search_width=500.0, scan_depth=6,
                         nbadsync_threshold=3, **kw)


def _deep_windows(n: int, first: int = 0):
    import numpy as np

    from msk144cudecoder_tpu import constants as C
    from msk144cudecoder_tpu import golden as G

    audio = G.synthesize_pings_int16(PLANTS, N_FRAMES,
                                     np.random.default_rng(SEED))
    starts = range(first * C.HOP_LEN, len(audio) - C.WINDOW_LEN + 1,
                   C.HOP_LEN)
    return np.stack([audio[s:s + C.WINDOW_LEN] for s in starts][:n])


def _time(fn, *args, reps: int = 5) -> float:
    """Median wall ms of fn(*args) after one warm-up, blocking on results."""
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def phase_info(out_dir: str) -> dict:
    import jax

    devs = jax.devices()
    log(f"jax {jax.__version__}  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"jax.devices() = {devs}")
    return {"ok": devs[0].platform == "gpu", "platform": devs[0].platform,
            "kind": devs[0].device_kind, "count": len(devs)}


def phase_parity(out_dir: str) -> dict:
    """GPU vs CPU backend in one process on 8 deep-scan windows.

    Tolerances: softbits of a candidate both backends keep agree within
    rtol 1e-3 / atol 1e-3 (float32 sums in another order). Scan candidates
    may differ only at near-ties: two lags (or two slice maxima) whose xb
    agree within 1e-4 relative can rank either way under float32 rounding
    in a different summation order (tests/test_pallas.py, SURVEY §7)."""
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cuda,cpu")
    from msk144cudecoder_tpu.ops import pipeline, scan
    from msk144cudecoder_tpu.runtime import StreamDecoder

    gpu, cpu = jax.devices("cuda")[0], jax.devices("cpu")[0]
    cfg = _deep_cfg()
    freqs = tuple(float(f) for f in cfg.freqs)
    # windows around each plant: the 8 windows whose first frame is
    # closest to each ping's start
    all_w = _deep_windows(400)
    raw = all_w[[p[3] // 3 for p in PLANTS]]

    @jax.jit
    def front(r):
        c = pipeline.preprocess(r, cfg)
        pos, xb = jax.vmap(lambda w: scan.scan(
            w, freqs, cfg.scan_depth, dec=cfg.scan_decimation))(c)
        prep = jax.vmap(lambda w: pipeline.prepare_window(w, freqs, cfg))(c)
        return pos, xb, prep

    out = {}
    with jax.default_matmul_precision("highest"):
        for name, dev in (("gpu", gpu), ("cpu", cpu)):
            r = jax.device_put(raw, dev)
            pos, xb, prep = jax.device_get(front(r))
            res = jax.device_get(pipeline.decode_raw(r, cfg))
            dec = StreamDecoder(cfg)
            items = [[(it.message, it.f0, it.num_avg, it.nbadsync)
                      for it in w] for w in dec.postprocess_batch(res, 8)]
            out[name] = (pos, xb, prep, items)
    (pg, xg, prg, ig), (pc, xc, prc, ic) = out["gpu"], out["cpu"]

    # scan candidates
    rel = lambda a, b: abs(a - b) / max(abs(a), abs(b), 1e-30)
    bad_scan, ties = [], 0
    for idx in zip(*np.nonzero(pg != pc)):
        w, f, p, k = idx
        a, b = float(xg[idx]), float(xc[idx])
        swap = [kk for kk in range(pg.shape[-1])
                if pg[w, f, p, kk] == pc[idx]
                and rel(float(xg[w, f, p, kk]), b) <= 1e-4]
        if rel(a, b) <= 1e-4 or swap:
            ties += 1
        else:
            bad_scan.append((tuple(int(i) for i in idx), a, b))
    xb_close = np.allclose(np.sort(xg, -1), np.sort(xc, -1), rtol=1e-3,
                           atol=1e-3)
    log(f"parity scan: {pg.size} candidates, {ties} near-tie differences, "
        f"{len(bad_scan)} others {bad_scan[:5]}, xb within 1e-3: {xb_close}")

    # survivor softbits for candidates (same index, same lag) in both
    n_cmp, worst = 0, 0.0
    sb_ok = True
    for w in range(8):
        key_c = {(int(c_), int(p_)): i for i, (c_, p_) in
                 enumerate(zip(prc.cand_k[w], prc.pos_k[w]))}
        for i, (c_, p_) in enumerate(zip(prg.cand_k[w], prg.pos_k[w])):
            j = key_c.get((int(c_), int(p_)))
            if j is None:
                continue
            a, b = prg.llr[w, i], prc.llr[w, j]
            n_cmp += 1
            worst = max(worst, float(np.max(np.abs(a - b)
                                            / (1e-3 + 1e-3 * np.abs(b)))))
            sb_ok = sb_ok and np.allclose(a, b, rtol=1e-3, atol=1e-3)
    log(f"parity softbits: {n_cmp} shared survivors, within rtol/atol 1e-3: "
        f"{sb_ok} (worst |diff|/tol {worst:.3f})")

    same_msgs = ig == ic
    n_msgs = sum(len(w) for w in ig)
    log(f"parity decodes: {n_msgs} message lines, identical "
        f"(message, f0, num_avg, nbadsync): {same_msgs}")
    if not same_msgs:
        log(f"  gpu {ig}\n  cpu {ic}")
    found = {m for w in ig for (m, *_ ) in w}
    log(f"parity decodes: {len(found)} of the 8 plants in these windows")
    ok = (not bad_scan and xb_close and sb_ok and same_msgs and found
          and n_cmp > 0)
    return {"ok": bool(ok), "near_ties": ties, "shared_survivors": n_cmp}


def phase_bp(out_dir: str) -> dict:
    """Compiled BP kernel vs ldpc.bp_decode on real survivor LLRs."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from msk144cudecoder_tpu.config import DecoderConfig
    from msk144cudecoder_tpu.ops import bp_kernel, ldpc, pipeline

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_busyband import BASE, NCELLS, staggered_pileup_audio, stream_windows

    def llrs(cfg, raw, chunk):
        freqs = tuple(float(f) for f in cfg.freqs)
        prep_fn = jax.jit(lambda r: jax.vmap(lambda w: pipeline.prepare_window(
            w, freqs, cfg))(pipeline.preprocess(r, cfg)))
        parts = [prep_fn(jnp.asarray(raw[i:i + chunk]))
                 for i in range(0, len(raw), chunk)]
        llr = jnp.concatenate([p.llr.reshape(-1, 128) for p in parts])
        valid = jnp.concatenate([p.valid.reshape(-1) for p in parts])
        return llr, valid

    ref_fn = jax.jit(ldpc.bp_decode)
    ker_fn = jax.jit(bp_kernel.bp_decode)
    res, ok = {}, True
    for name, cfg, raw, chunk in (
            ("deep_65536", _deep_cfg(), _deep_windows(256), 64),
            ("busy_band", DecoderConfig(max_survivors=NCELLS,
                                        survivor_prefilter=0, **BASE),
             stream_windows(staggered_pileup_audio()), 4)):
        llr, valid = llrs(cfg, raw, chunk)
        r0 = jax.device_get(ref_fn(llr, valid))
        r1 = jax.device_get(ker_fn(llr, valid))
        diff = np.zeros(llr.shape[0], bool)
        for f in ("found", "codeword", "iterations", "hard_errors"):
            a, b = np.asarray(getattr(r0, f)), np.asarray(getattr(r1, f))
            diff |= (a != b).reshape(len(a), -1).any(axis=1)
        rows = np.nonzero(diff)[0]
        for r in rows[:10]:
            log(f"bp {name}: row {r} differs: ref found={r0.found[r]} "
                f"it={r0.iterations[r]} nerr={r0.hard_errors[r]} | kernel "
                f"found={r1.found[r]} it={r1.iterations[r]} "
                f"nerr={r1.hard_errors[r]}")
        t_ref = _time(ref_fn, llr, valid)
        t_ker = _time(ker_fn, llr, valid)
        log(f"bp {name}: {llr.shape[0]} rows, {int(np.sum(valid))} valid, "
            f"{int(np.sum(r0.found))} decoded; rows differing: {len(rows)}; "
            f"ldpc.bp_decode {t_ref:.3f} ms, bp_kernel {t_ker:.3f} ms")
        ok = ok and len(rows) == 0 and int(np.sum(r0.found)) > 0
        res[name] = {"rows": int(llr.shape[0]), "differ": int(len(rows)),
                     "ref_ms": round(t_ref, 3), "kernel_ms": round(t_ker, 3)}
    res["ok"] = bool(ok)
    return res


def phase_busy(out_dir: str) -> dict:
    """tests/test_busyband.py's battery on the card: all four staggered
    pings decode at (num_avg, nbadsync) = (1, 0); the K=256 overload keeps
    per-message parity and the overflow warning fires."""
    import io
    from contextlib import redirect_stderr

    import numpy as np

    from msk144cudecoder_tpu.config import DecoderConfig
    from msk144cudecoder_tpu.runtime import StreamDecoder

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_busyband import (BASE, NCELLS, PINGS, staggered_pileup_audio,
                               stream_windows)

    windows = stream_windows(staggered_pileup_audio())

    def decode(cfg):
        dec = StreamDecoder(cfg)
        buf = io.StringIO()
        with redirect_stderr(buf):
            r = dec.decode_to_host(windows)
            best: dict = {}
            for items in dec.postprocess_batch(r, len(windows)):
                for it in items:
                    k = (it.num_avg, it.nbadsync)
                    if it.message not in best or k < best[it.message]:
                        best[it.message] = k
        return best, int(np.asarray(r.num_survivors).max()), buf.getvalue()

    full, max_surv, _ = decode(DecoderConfig(
        max_survivors=NCELLS, survivor_prefilter=0, **BASE))
    want = {m for m, *_ in PINGS}
    full_ok = set(full) == want and all(v == (1, 0) for v in full.values())
    log(f"busy full: {full} max survivors {max_surv}: {full_ok}")
    over, over_surv, err = decode(DecoderConfig(
        max_survivors=256, survivor_prefilter=0, **BASE))
    warned = "survivors exceed the LDPC batch" in err
    log(f"busy K=256 overload: parity {over == full}, warning {warned}, "
        f"max survivors {over_surv}")
    ok = full_ok and over == full and warned and over_surv > 256
    return {"ok": bool(ok), "max_survivors": max_surv}


def phase_placement(out_dir: str) -> dict:
    """MeshDecoder over every local card: the table shards and the result
    rows must land on all of them, not all on the first."""
    import jax
    import numpy as np

    from msk144cudecoder_tpu.parallel import MeshDecoder, make_mesh

    devs = jax.devices()
    md = MeshDecoder(_deep_cfg(), make_mesh(1, len(devs)))
    tbl = {s.device.id for s in md._tbl.W.addressable_shards}
    res = md.decode(_deep_windows(4))
    out = {s.device.id for s in res.found.addressable_shards}
    busy = [(d.memory_stats() or {}).get("bytes_in_use", 1) for d in devs]
    log(f"placement: {len(devs)} devices, W table shards on {sorted(tbl)}, "
        f"result shards on {sorted(out)}, bytes_in_use per device {busy}")
    ok = len(tbl) == len(out) == len(devs) and all(b > 0 for b in busy)
    found = int(np.asarray(res.found).sum())
    return {"ok": bool(ok) and found > 0, "devices": len(devs)}


PHASES = {"info": phase_info, "parity": phase_parity, "bp": phase_bp,
          "busy": phase_busy, "placement": phase_placement}


# ------------------------------------------------------- four cards


def four_cards(out_dir: str) -> bool:
    files = make_stimuli(out_dir)
    cap = files["deep.raw"]
    # Each frequency shard keeps its own top-K survivors, so a mesh decodes
    # up to K * n_freq rows per window where one card decodes K. At the
    # deep scan's threshold 3 noise alone overflows K=256 on every window,
    # and what truncation drops then depends on the shard count. The
    # comparison therefore runs with the prefilter off and K above any
    # survivor count, where every layout must decode the same rows.
    par = [sys.executable, "-m", "msk144cudecoder_tpu.parallel",
           "--input", cap, "--window-batch", "16", "--survivor-prefilter",
           "0", "--max-survivors", "4096"] + DEEP
    ok = True

    def one(name, cmd, env):
        t0 = time.time()
        p = _run(cmd, 900, env=env)
        thr = _grab(r"Throughput: .* = ([\d.]+) ms/window", p.stderr)
        mesh = _grab(r"(Mesh: .*)", p.stderr)
        log(f"four-cards {name}: rc={p.returncode} wall={time.time() - t0:.1f}s "
            f"ms/window={thr} {mesh}")
        if p.returncode != 0:
            log(p.stderr[-3000:])
        return p

    env1 = _env()
    env1["CUDA_VISIBLE_DEVICES"] = "0"
    base = one("1 card", par + ["--mesh-time", "1"], env1)
    ok = ok and base.returncode == 0
    ref = _lines(base.stdout)
    ref_nosnr = _lines(base.stdout, keep_snr=False)
    got = {_grab(r"msg='([^']*)'", ln) for ln in ref}
    ok = ok and got >= {p[0] for p in PLANTS}

    a = one("(a) 1 process x 4 cards", par + ["--mesh-time", "1"], _env())
    same_a = a.returncode == 0 and _lines(a.stdout) == ref
    log(f"four-cards (a): same lines as 1 card: {same_a}")

    port = 40000 + os.getpid() % 20000
    procs = []
    for i in range(4):
        env = _env()
        env["CUDA_VISIBLE_DEVICES"] = str(i)
        procs.append(subprocess.Popen(
            par + ["--coordinator", f"localhost:{port}", "--num-processes",
                   "4", "--process-id", str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=ROOT, env=env))
    t0 = time.time()
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=900))
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate())
    rcs = [p.returncode for p in procs]
    thr = _grab(r"Throughput: .* = ([\d.]+) ms/window", outs[0][1])
    log(f"four-cards (b) 4 processes x 1 card: rcs={rcs} "
        f"wall={time.time() - t0:.1f}s ms/window={thr} "
        f"{_grab(r'(Mesh: .*)', outs[0][1])}")
    for i, (o, e) in enumerate(outs):
        if procs[i].returncode != 0:
            log(f"  process {i} stderr tail:\n{e[-2000:]}")
    lines_b = [ln for o, _ in outs for ln in _lines(o, keep_snr=False)]
    # each process keeps its own SNR tracker over its stream segment, so
    # the snr field may differ near segment starts; the rest must match
    same_b = all(r == 0 for r in rcs) and lines_b == ref_nosnr
    log(f"four-cards (b): same lines as 1 card (snr aside): {same_b}")
    if not same_b:
        log(f"  1 card only: {sorted(set(ref_nosnr) - set(lines_b))}")
        log(f"  4 proc only: {sorted(set(lines_b) - set(ref_nosnr))}")
    return ok and same_a and same_b


# ------------------------------------------------------------------ main


def _nvidia_smi() -> str:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return p.stdout.strip() or p.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card path and its 1-card "
                         "comparison (needs 4 GPUs)")
    ap.add_argument("--out", default=os.path.join(ROOT, "out", "smoke"),
                    help="directory for stimuli (default out/smoke)")
    ap.add_argument("--phase", choices=sorted(PHASES), help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.phase:  # child: one phase, JSON on the last line
        try:
            from msk144cudecoder_tpu.runtime.backend import (
                enable_persistent_cache, use_platform)

            if args.phase != "parity":
                use_platform()
            enable_persistent_cache()
            res = PHASES[args.phase](args.out)
        except Exception as e:  # report, never pass
            import traceback

            traceback.print_exc()
            res = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(res, default=str))
        return 0 if res.get("ok") else 1

    t_all = time.time()
    log(_nvidia_smi())  # the card's name and power limit, as nvidia-smi says
    device = {"platform": None, "kind": None, "count": 0}
    os.makedirs(args.out, exist_ok=True)
    info = _child("info", args.out, 300)
    ok = bool(info.get("ok"))
    if info.get("platform"):
        device = {k: info[k] for k in ("platform", "kind", "count")}
    log(f"phase info: {'ok' if ok else 'FAILED'} {device} "
        f"({info['seconds']} s)")
    if ok and args.four_cards:
        ok = ok and device["count"] >= 4
        pl = _child("placement", args.out, 600)
        log(f"phase placement: {'ok' if pl['ok'] else 'FAILED'} "
            f"({pl['seconds']} s)")
        t0 = time.time()
        fc = four_cards(args.out)
        log(f"phase four-cards: {'ok' if fc else 'FAILED'} "
            f"({time.time() - t0:.1f} s)")
        ok = ok and pl["ok"] and fc
    elif ok:
        t0 = time.time()
        try:
            sh = phase_shell(args.out)
        except Exception as e:
            sh = {"ok": False, "error": repr(e)}
        log(f"phase shell: {'ok' if sh['ok'] else 'FAILED'} "
            f"({time.time() - t0:.1f} s)")
        ok = ok and sh["ok"]
        for name, limit in (("parity", 600), ("bp", 600), ("busy", 600)):
            r = _child(name, args.out, limit)
            log(f"phase {name}: {'ok' if r['ok'] else 'FAILED'} "
                f"({r['seconds']} s)")
            ok = ok and r["ok"]
    log(f"total {time.time() - t_all:.1f} s")
    print(json.dumps({"ok": bool(ok), "device": device}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
