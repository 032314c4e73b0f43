"""End-to-end runtime tests: synthetic streams through the full decoder shell.

Replaces the reference's manual `cat demo/0001.wav | msk144cudecoder`
verification (README.md:70-73; the demo file is stripped from the snapshot)
with synthetic MSK144 stimuli from the golden encoder.
"""

import io

import numpy as np
import pytest

from msk144cudecoder_tpu import constants as C
from msk144cudecoder_tpu import golden as G
from msk144cudecoder_tpu.cli import build_parser, config_from_args, print_banner
from msk144cudecoder_tpu.config import DecoderConfig
from msk144cudecoder_tpu.runtime import ResultFilter, SNRTracker, StreamDecoder
from msk144cudecoder_tpu.runtime.stream import window_stream


# max_survivors must cover every plausible survivor (the reference decodes all
# of them, result_filter then prefers lowest num_avg — a too-small K can drop
# the num_avg=1 decode while a deeper-averaged duplicate survives on xb rank).
CFG_SMALL = DecoderConfig(search_width=100.0, scan_depth=3, max_survivors=256)


class TestSNRTracker:
    def test_noise_floor_asymmetric_ema(self):
        t = SNRTracker()
        t.process_powers(np.full(8, 4.0))
        assert t.snr_f == pytest.approx(-8.0)  # flat signal: peak/noise-1 = 0
        # rising avg: slow EMA
        t.process_powers(np.full(8, 8.0))
        # noise floor = 0.9*4 + 0.1*8 = 4.4; peak/noise-1 = 8/4.4-1
        assert t.snr_f == pytest.approx(10 * np.log10(8 / 4.4 - 1), abs=1e-5)
        # falling avg: instant
        t.process_powers(np.full(8, 1.0))
        assert t.snr_f == pytest.approx(-8.0)

    def test_peak_detection(self):
        t = SNRTracker()
        p = np.ones(8)
        t.process_powers(p)
        strong = p.copy()
        strong[3] = 100.0
        t.process_powers(strong)
        assert t.snr_f > 8.0

    def test_clamping(self):
        # Lower clamp: flat power gives peak/noise-1 = 0 -> -inf -> -8 dB.
        t = SNRTracker()
        t.process_powers(np.full(8, 4.0))
        assert t.snr_f == -8.0
        # Upper clamp: established low noise floor, then a burst window whose
        # avg stays below floor (noise falls instantly) but peak is huge.
        t = SNRTracker()
        t.process_powers(np.full(8, 1.0))
        p = np.full(8, 0.1)
        p[0] = 0.7  # avg=0.175 < 1 -> noise drops to 0.175; peak/noise-1 = 3
        t.process_powers(p)
        assert t.snr_f == pytest.approx(10 * np.log10(0.7 / 0.175 - 1), abs=1e-6)
        p[0] = 1e6
        t.process_powers(p)  # avg ~1.25e5 > noise -> rises slowly; ratio ~80
        assert -8.0 <= t.snr_f <= 24.0


class TestResultFilter:
    def test_dedup_keeps_best(self):
        f = ResultFilter()
        f.block_begin()
        f.put_message(1, 1500.0, 3, 1, 2, "CQ K1ABC FN42")
        f.put_message(2, 1500.0, 1, 0, 0, "CQ K1ABC FN42")
        f.put_message(0, 1490.0, 2, 0, 1, "K1ABC W9XYZ 73")
        f.block_end()
        res = f.block_result()
        assert len(res) == 2
        by_msg = {r.message: r for r in res}
        assert by_msg["CQ K1ABC FN42"].num_avg == 1
        assert by_msg["CQ K1ABC FN42"].pattern_idx == 0

    def test_line_format(self):
        f = ResultFilter()
        f.block_begin()
        f.put_message(3, 1502.0, 1, 0, 0, "CQ K1ABC FN42")
        f.block_end()
        line = f.block_result()[0].format_line()
        assert line.startswith("***  snr= 3; f0=  1502; num_avg=1; nbadsync=0; pattern_idx=0; date=")
        assert line.endswith("msg='CQ K1ABC FN42'; ")


class TestWindowStream:
    def test_audio_overlap(self):
        n = C.WINDOW_LEN
        samples = np.arange(n * 2, dtype=np.int16)
        windows = list(window_stream(io.BytesIO(samples.tobytes()), 1))
        assert len(windows) == 3
        np.testing.assert_array_equal(windows[0], samples[:n])
        np.testing.assert_array_equal(windows[1], samples[n // 2 : n // 2 + n])
        np.testing.assert_array_equal(windows[2], samples[n:])

    def test_iq_is_twice_the_bytes(self):
        n = C.WINDOW_LEN * 2
        samples = (np.arange(n, dtype=np.int32) % 127).astype(np.int8)
        windows = list(window_stream(io.BytesIO(samples.tobytes()), 2))
        assert len(windows) == 1
        np.testing.assert_array_equal(windows[0], samples)

    def test_short_read_ends_stream(self):
        samples = np.zeros(C.WINDOW_LEN + 10, dtype=np.int16)
        windows = list(window_stream(io.BytesIO(samples.tobytes()), 1))
        assert len(windows) == 1


class TestStreamDecoder:
    def test_decode_synthetic_audio(self):
        audio = G.synthesize_audio_int16(
            [("CQ K1ABC FN42", 1500.0)], 6, snr_db=10.0, rng=np.random.default_rng(5)
        )
        dec = StreamDecoder(CFG_SMALL)
        res = dec.decode_block(audio)
        assert len(res) == 1
        assert res[0].message == "CQ K1ABC FN42"
        assert res[0].f0 == pytest.approx(1500.0, abs=2.0)
        assert res[0].num_avg == 1

    def test_decode_iq_mode(self):
        iq = G.synthesize_iq_int8(
            [("K1ABC W9XYZ EN37", 20.0)], 6, snr_db=10.0, rng=np.random.default_rng(6)
        )
        cfg = DecoderConfig.create(read_mode=2, search_width=100.0, scan_depth=3,
                                   max_survivors=64)
        dec = StreamDecoder(cfg)
        res = dec.decode_block(iq)
        assert len(res) == 1
        assert res[0].message == "K1ABC W9XYZ EN37"
        assert res[0].f0 == pytest.approx(20.0, abs=2.0)

    def test_weak_signal_needs_averaging(self):
        """At low SNR the deep averaging patterns should still find the frame."""
        audio = G.synthesize_audio_int16(
            [("CQ K1ABC FN42", 1500.0)], 6, snr_db=-2.0, rng=np.random.default_rng(7)
        )
        dec = StreamDecoder(DecoderConfig(search_width=100.0, scan_depth=6, max_survivors=128))
        res = dec.decode_block(audio)
        assert len(res) == 1
        assert res[0].message == "CQ K1ABC FN42"

    def test_noise_only_no_decodes(self):
        rng = np.random.default_rng(8)
        audio = (rng.normal(0, 1000, C.WINDOW_LEN)).astype(np.int16)
        dec = StreamDecoder(CFG_SMALL)
        assert dec.decode_block(audio) == []

    def test_streaming_two_messages(self):
        rng = np.random.default_rng(9)
        a1 = G.synthesize_audio_int16([("CQ K1ABC FN42", 1510.0)], 6, snr_db=10.0, rng=rng)
        a2 = G.synthesize_audio_int16([("K1ABC W9XYZ R-02", 1490.0)], 6, snr_db=10.0, rng=rng)
        stream = io.BytesIO(a1.tobytes() + a2.tobytes())
        dec = StreamDecoder(CFG_SMALL)
        texts = []
        for w in window_stream(stream, 1):
            texts.append({r.message for r in dec.decode_block(w)})
        assert len(texts) == 3  # 2 full windows + 1 overlap window
        assert "CQ K1ABC FN42" in texts[0]
        assert "K1ABC W9XYZ R-02" in texts[2]


class TestCLI:
    def test_defaults_match_reference_code(self):
        args = build_parser().parse_args([])
        cfg = config_from_args(args)
        assert cfg.center_frequency == 1500.0
        assert cfg.search_step == 2.0
        assert cfg.search_width == 200.0
        assert cfg.scan_depth == 4
        assert cfg.analytic_method == 2
        assert cfg.nbadsync_threshold == 1

    def test_iq_default_center(self):
        args = build_parser().parse_args(["--read-mode", "2"])
        assert config_from_args(args).center_frequency == 0.0

    def test_banner(self, capsys):
        print_banner(CFG_SMALL)
        err = capsys.readouterr().err
        assert "Center Frequency: 1500Hz" in err
        assert "Left Boundary: 1450Hz" in err
        assert "Right Boundary: 1550Hz" in err


class TestBatchedStreaming:
    def test_decode_many_matches_sequential(self):
        rng = np.random.default_rng(9)
        a1 = G.synthesize_audio_int16([("CQ K1ABC FN42", 1510.0)], 6, snr_db=10.0, rng=rng)
        a2 = G.synthesize_audio_int16([("K1ABC W9XYZ R-02", 1490.0)], 6, snr_db=10.0, rng=rng)
        batch = np.stack([a1, a2])

        seq = StreamDecoder(CFG_SMALL)
        want = [{r.message for r in seq.decode_block(a1)},
                {r.message for r in seq.decode_block(a2)}]

        bat = StreamDecoder(CFG_SMALL)
        got = [{r.message for r in win} for win in bat.decode_many(batch)]
        assert got == want
        assert got[0] == {"CQ K1ABC FN42"}
        assert got[1] == {"K1ABC W9XYZ R-02"}

    def test_decode_many_n_valid_drops_pad(self):
        rng = np.random.default_rng(10)
        a = G.synthesize_audio_int16([("CQ K1ABC FN42", 1500.0)], 6, snr_db=10.0, rng=rng)
        batch = np.stack([a, np.zeros_like(a)])
        dec = StreamDecoder(CFG_SMALL)
        out = dec.decode_many(batch, n_valid=1)
        assert len(out) == 1
        assert {r.message for r in out[0]} == {"CQ K1ABC FN42"}


class TestResultCompaction:
    def test_found_rows_lead_and_survive_compaction(self):
        """With max_results << K, every decode must still be returned
        (found-first device-side compaction, pipeline.decode_window_tables)."""
        rng = np.random.default_rng(12)
        a = G.synthesize_audio_int16(
            [("CQ K1ABC FN42", 1500.0)], 6, snr_db=10.0, rng=rng)
        cfg = CFG_SMALL.replace(max_results=8)
        dec = StreamDecoder(cfg)
        res = dec.decode_block(a)
        assert {r.message for r in res} == {"CQ K1ABC FN42"}

        from msk144cudecoder_tpu.ops import pipeline as pl_mod

        out = pl_mod.decode_raw(a[None, :], cfg)
        found = np.asarray(out.found[0])
        assert found.shape == (8,)
        # found slots are contiguous at the front
        nf = int(found.sum())
        assert nf >= 1
        assert found[:nf].all() and not found[nf:].any()


class TestSurvivorSelection:
    def test_exact_xb_ordering_with_overflow(self):
        """>K survivors: selection must be the exact top-K by (nbadsync asc,
        xb desc), with xb ordered exactly (down to 1-ulp differences) within
        an nbadsync class — a float composite key cannot do this (VERDICT
        weak #2)."""
        import jax.numpy as jnp
        from msk144cudecoder_tpu.ops import pipeline as pl_mod

        rng = np.random.default_rng(7)
        n, k = 4096, 256
        nbad = rng.integers(0, 4, n).astype(np.int32)
        xb = (rng.random(n).astype(np.float32) * 100.0).astype(np.float32)
        # adversarial: many 1-ulp-apart pairs inside one nbad class
        base = np.float32(37.25)
        ulp = np.spacing(base).astype(np.float32)
        for i in range(0, 400, 2):
            nbad[i] = nbad[i + 1] = 1
            xb[i] = base + ulp * (i // 2)
            xb[i + 1] = base + ulp * (i // 2) + ulp / 2  # rounds to +0 or +1 ulp
        xb = xb.astype(np.float32)

        top = np.asarray(pl_mod.select_survivors(
            jnp.asarray(nbad), jnp.asarray(xb), k))

        order = np.lexsort((np.arange(n), -xb.astype(np.float64), nbad))
        expected = order[:k]
        np.testing.assert_array_equal(top, expected)

    def test_topk_selection_matches_exact_sort_for_survivors(self):
        """The fast exponent-packed top_k path (used for threshold <= 4) must
        produce the same survivor set AND order as the exact two-key sort,
        including 1-ulp xb differences inside one nbadsync class. Rows above
        the threshold are diagnostics-only (never decoded, never printed) and
        may order differently."""
        import jax.numpy as jnp
        from msk144cudecoder_tpu.ops import pipeline as pl_mod

        rng = np.random.default_rng(11)
        n, k, thr = 4096, 256, 3
        nbad = rng.integers(0, 8, n).astype(np.int32)
        xb = (rng.random(n).astype(np.float32) * 100.0).astype(np.float32)
        base = np.float32(37.25)
        ulp = np.spacing(base).astype(np.float32)
        for i in range(0, 400, 2):
            nbad[i] = nbad[i + 1] = rng.integers(0, thr + 1)
            xb[i] = base + ulp * (i // 2)
            xb[i + 1] = base + ulp * (i // 2) + ulp / 2
        xb = xb.astype(np.float32)
        # force truncation pressure inside the valid classes
        assert (nbad <= thr).sum() > k

        t0 = np.asarray(pl_mod.select_survivors(
            jnp.asarray(nbad), jnp.asarray(xb), k))
        t1 = np.asarray(pl_mod.select_survivors_topk(
            jnp.asarray(nbad), jnp.asarray(xb), k, thr))
        v0 = [(int(nbad[i]), float(xb[i]), int(i)) for i in t0 if nbad[i] <= thr]
        v1 = [(int(nbad[i]), float(xb[i]), int(i)) for i in t1 if nbad[i] <= thr]
        assert v0 == v1

    def test_overflow_warning_fires(self, capsys):
        """num_survivors > max_survivors must produce a stderr warning
        (no silent truncation, VERDICT weak #3)."""
        from msk144cudecoder_tpu.ops.pipeline import WindowDecodeResult

        cfg = CFG_SMALL.replace(max_survivors=4, max_results=4)
        dec = StreamDecoder(cfg)
        r = 4
        res = WindowDecodeResult(
            cand_index=np.zeros((1, r), np.int32),
            valid=np.zeros((1, r), bool),
            found=np.zeros((1, r), bool),
            message_bits=np.zeros((1, r, 10), np.uint8),
            nbadsync=np.zeros((1, r), np.int32),
            xb=np.zeros((1, r), np.float32),
            pos=np.zeros((1, r), np.int32),
            ldpc_iterations=np.zeros((1, r), np.int32),
            hard_errors=np.zeros((1, r), np.int32),
            num_survivors=np.array([9], np.int32),
            shard_survivors=np.array([9], np.int32),
            block_power=np.ones((1, 8), np.float32),
        )
        dec._postprocess_one(res, 0)
        err = capsys.readouterr().err
        assert "9 sync survivors exceed" in err and "max_survivors=4" in err

    def test_shard_overflow_warning_fires(self, capsys):
        """A single frequency shard exceeding its LOCAL top-K must warn even
        when the global sum stays under K * n_shards (each shard truncates
        locally — ADVICE r4 medium)."""
        from msk144cudecoder_tpu.ops.pipeline import WindowDecodeResult

        cfg = CFG_SMALL.replace(max_survivors=4, max_results=4)
        dec = StreamDecoder(cfg, survivor_capacity=16)  # 4 shards x K=4
        r = 4
        res = WindowDecodeResult(
            cand_index=np.zeros((1, r), np.int32),
            valid=np.zeros((1, r), bool),
            found=np.zeros((1, r), bool),
            message_bits=np.zeros((1, r, 10), np.uint8),
            nbadsync=np.zeros((1, r), np.int32),
            xb=np.zeros((1, r), np.float32),
            pos=np.zeros((1, r), np.int32),
            ldpc_iterations=np.zeros((1, r), np.int32),
            hard_errors=np.zeros((1, r), np.int32),
            num_survivors=np.array([9], np.int32),  # under capacity 16
            shard_survivors=np.array([7], np.int32),  # one shard over K=4
            block_power=np.ones((1, 8), np.float32),
        )
        dec._postprocess_one(res, 0)
        err = capsys.readouterr().err
        assert "7 sync survivors in one frequency shard" in err
        assert "max_survivors=4 per shard" in err

    def test_ragged_byte_tail_ends_cleanly(self, capsys):
        """A stream ending mid-sample must take the normal short-read exit,
        not crash in np.frombuffer (ADVICE round 1)."""
        data = np.zeros(C.WINDOW_LEN, dtype=np.int16).tobytes() + b"\x01"
        windows = list(window_stream(io.BytesIO(data), 1))
        assert len(windows) == 1
        assert "Incomplete read" in capsys.readouterr().err


class TestNewMessageTypesEndToEnd:
    """Every unpack77 branch reached through the synthesized-RF pipeline
    (VERDICT round-1 items 3/4). Types the reference's plausibility gate
    admits (0.2, 5) decode through the full StreamDecoder; gated types
    (0.1, 0.3/0.4, 3) are checked at the ops level (bits survive the channel)
    plus gate parity (StreamDecoder drops them like the reference)."""

    def test_type_02_full_stream_decode(self):
        msg = "PA3XYZ/P R 590003 IO91NP"
        audio = G.synthesize_audio_int16(
            [(msg, 1500.0)], 6, snr_db=10.0, rng=np.random.default_rng(21))
        res = StreamDecoder(CFG_SMALL).decode_block(audio)
        assert [r.message for r in res] == [msg]

    def test_type_5_full_stream_decode_with_hash_context(self):
        msg = "<PA3XYZ> <G4ABC> R 570123 JO22DB"
        audio = G.synthesize_audio_int16(
            [(msg, 1500.0)], 6, snr_db=10.0, rng=np.random.default_rng(22))
        dec = StreamDecoder(CFG_SMALL)
        dec.hashes.add("PA3XYZ")
        dec.hashes.add("G4ABC")
        res = dec.decode_block(audio)
        assert [r.message for r in res] == [msg]

    @pytest.mark.parametrize("msg", [
        "K1ABC RR73; W9XYZ <KH1/KH7Z> -08",  # 0.1
        "WA9XYZ KA1ABC R 16A EMA",           # 0.3
        "WA9XYZ KA1ABC 32A SNJ",             # 0.4
        "TU; K1ABC W9XYZ R 589 0013",        # 3
    ])
    def test_gated_types_survive_channel_but_are_gate_dropped(self, msg):
        from msk144cudecoder_tpu.ops import pipeline as pl_mod
        from msk144cudecoder_tpu.protocol import msg77

        audio = G.synthesize_audio_int16(
            [(msg, 1500.0)], 6, snr_db=10.0, rng=np.random.default_rng(23))
        out = pl_mod.decode_raw(audio[None, :], CFG_SMALL)
        found = np.asarray(out.found[0])
        assert found.any()
        k = int(np.nonzero(found)[0][0])
        bits = pl_mod.unpack_message_bits(out.message_bits[0][k])
        h = msg77.CallsignHashTable()
        h.add("KH1/KH7Z")
        ok, text = msg77.unpack77(bits, h)
        assert ok and text == msg
        # gate parity: the reference never hands these to the codec
        assert not msg77.plausible_message_type(bits)
        res = StreamDecoder(CFG_SMALL).decode_block(audio)
        assert res == []


def _run_cli(stdin_bytes: bytes, extra_args=(), env_extra=None, timeout=240):
    """Run `python -m msk144cudecoder_tpu` as a subprocess on CPU."""
    import os
    import subprocess

    env = dict(os.environ)
    env.update(env_extra or {})
    cmd = ["python", "-m", "msk144cudecoder_tpu", "--platform", "cpu",
           *extra_args]
    proc = subprocess.run(cmd, input=stdin_bytes, capture_output=True,
                          timeout=timeout, env=env, cwd=os.path.dirname(
                              os.path.dirname(os.path.abspath(__file__))))
    return proc.stdout.decode(), proc.stderr.decode()


class TestScopedMetrics:
    def test_spans_print_when_enabled(self):
        rng = np.random.default_rng(31)
        audio = G.synthesize_audio_int16(
            [("CQ K1ABC FN42", 1500.0)], 6, snr_db=10.0, rng=rng)
        out, err = _run_cli(
            audio.tobytes() + audio.tobytes(),
            extra_args=["--search-width", "100", "--scan-depth", "3"],
            env_extra={"MSK144_TPU_METRICS": "1"})
        assert "CQ K1ABC FN42" in out
        for span in ("working_loop", "ingest", "submit", "collect",
                     "device_wait_transfer", "postprocess", "unpack77",
                     "result_filter"):
            assert f"Measured time: {span} " in err, (span, err[-2000:])
        # nesting: inner spans are indented under working_loop/collect
        assert "\n  Measured time: ingest" in err
        assert "    Measured time: device_wait_transfer" in err

    def test_spans_silent_by_default(self):
        rng = np.random.default_rng(32)
        audio = (rng.normal(0, 1000, C.WINDOW_LEN)).astype(np.int16)
        _, err = _run_cli(audio.tobytes(),
                          extra_args=["--search-width", "100",
                                      "--scan-depth", "3"],
                          env_extra={"MSK144_TPU_METRICS": "0"})
        assert "Measured time:" not in err


class TestCliBatchMode:
    """The pipelined throughput mode (--window-batch > 1, device calls for
    several batches in flight) must emit exactly the sequential mode's
    decode lines, in stream order, including the zero-padded ragged tail
    flush (cli.py:193-263)."""

    @staticmethod
    def _staggered_stream() -> bytes:
        rng = np.random.default_rng(77)
        n = 12 * C.FRAME_LEN
        t = np.arange(n)
        sig = np.zeros(n, dtype=np.complex128)
        for text, f0, snr, s in [("CQ K1ABC FN42", 1470.0, 7.0, 0),
                                 ("K1ABC W9XYZ EN37", 1530.0, 5.0, 4)]:
            bb = np.tile(G.modulate_frame(G.frame_bits_from_message(text)), 5)
            amp = np.sqrt(2.0 * 10 ** (snr / 10.0))
            lo, hi = s * C.FRAME_LEN, (s + 5) * C.FRAME_LEN
            sig[lo:hi] += amp * bb * np.exp(
                2j * np.pi * f0 * t[lo:hi] / C.SAMPLE_RATE)
        noise = np.sqrt(0.5 * (C.SAMPLE_RATE / 2) / 2500.0) * np.sqrt(2.0)
        sig += noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        a = np.clip(np.round(sig.real * 1000.0), -32768, 32767)
        return a.astype(np.int16).tobytes()

    @staticmethod
    def _lines(out: str):
        # decode lines minus the wall-clock date field
        import re

        return [re.sub(r"date=\d+; ", "", ln) for ln in out.splitlines()
                if ln.startswith("***")]

    def test_pipelined_output_matches_sequential(self):
        stream = self._staggered_stream()  # 3 windows: batch 2 + ragged 1
        args = ["--search-width", "200", "--scan-depth", "3"]
        out_seq, _ = _run_cli(stream, extra_args=args)
        out_bat, err_bat = _run_cli(
            stream, extra_args=args + ["--window-batch", "2",
                                       "--pipeline-depth", "2"])
        seq, bat = self._lines(out_seq), self._lines(out_bat)
        assert "CQ K1ABC FN42" in "".join(seq)
        assert "K1ABC W9XYZ EN37" in "".join(seq)
        assert bat == seq
        assert "Done" in out_bat
        # the steady-state throughput line only prints past the first batch
        assert "Throughput:" in err_bat


class TestDemoCapture:
    def test_demo_decodes_all_three_pings(self):
        """demo/capture.raw (the stand-in for the reference's stripped demo
        WAV) must decode its three planted messages with default flags, and
        tools/make_demo.py must reproduce it byte for byte."""
        import pathlib
        import subprocess
        import sys

        repo = pathlib.Path(__file__).resolve().parents[1]
        data = (repo / "demo" / "capture.raw").read_bytes()
        out, _ = _run_cli(data)
        for msg in ("CQ K1ABC FN42", "K1ABC W9XYZ EN37", "W9XYZ K1ABC RR73"):
            assert f"msg='{msg}'" in out, msg
        subprocess.run([sys.executable, "tools/make_demo.py"], cwd=repo,
                       check=True, capture_output=True)
        assert (repo / "demo" / "capture.raw").read_bytes() == data


class TestOverflowWarningRateLimit:
    def test_first_immediate_then_aggregated(self, capsys, monkeypatch):
        """A deep-scan noise band can overflow EVERY window; the warning
        prints immediately once, then as a periodic aggregate instead of
        one stderr line per 216 ms hop."""
        monkeypatch.setattr(StreamDecoder, "OVERFLOW_WARN_EVERY", 4)
        dec = StreamDecoder(CFG_SMALL)
        dec._warn_overflow(900)  # first overflow: immediate
        assert "900 sync survivors exceed" in capsys.readouterr().err
        dec._warn_overflow(850)
        dec._warn_overflow(0)
        assert capsys.readouterr().err == ""  # silenced mid-period
        dec._warn_overflow(950)  # 4th window closes the period
        err = capsys.readouterr().err
        assert "950 sync survivors exceed" in err
        assert "3 of the last 4 windows overflowed; max 950" in err
        dec._warn_overflow(0)
        assert capsys.readouterr().err == ""  # clean period stays silent


class TestDecodeCacheBound:
    def test_cache_evicts_fifo_at_cap(self, monkeypatch):
        from msk144cudecoder_tpu.runtime import decoder as dec_mod
        monkeypatch.setattr(dec_mod, "DECODE_CACHE_MAX", 4)
        dec = StreamDecoder(CFG_SMALL)
        rng = np.random.default_rng(0)
        for _ in range(16):
            dec._unpack_cached(rng.integers(0, 2, 77).astype(np.int8))
        assert len(dec._decode_cache) <= 4


class TestGapPatternDecode:
    """End-to-end decode of a gapped meteor ping: signal present only in
    window frames {0, 3} — the reason the reference carries the two gap
    averaging patterns 100100/100110 (msk_context.cuh:231-240, rows 6-7 of
    PATTERN_MASKS). At this SNR no contiguous-prefix pattern decodes (frame 0
    alone is too weak, prefixes 2..6 average in pure-noise frames); only the
    matched gap pattern does."""

    @staticmethod
    def _gap_audio(msg, snr_db, seed, mask=(1, 0, 0, 1, 0, 0)):
        rng = np.random.default_rng(seed)
        sig = G.synthesize_baseband([(msg, 1500.0)], 6, snr_db=None)
        fm = np.repeat(np.asarray(mask, np.float64), C.FRAME_LEN)
        # same noise calibration as golden.synthesize_baseband
        noise_sigma = np.sqrt(0.5 * (C.SAMPLE_RATE / 2) / 2500.0) * np.sqrt(2.0)
        amp = np.sqrt(2.0 * 10 ** (snr_db / 10.0))
        bb = amp * sig * fm + noise_sigma * (
            rng.standard_normal(sig.size) + 1j * rng.standard_normal(sig.size))
        return np.clip(np.round(bb.real * 1000.0), -32768, 32767).astype(np.int16)

    @pytest.mark.parametrize("seed", [1, 3])
    def test_gap_ping_decodes_via_pattern_6(self, seed):
        cfg = DecoderConfig(search_width=100.0, scan_depth=8, max_survivors=512)
        dec = StreamDecoder(cfg)
        res = dec.decode_block(self._gap_audio("CQ K1ABC FN42", -2.0, seed))
        assert [(r.message, r.pattern_idx, r.num_avg) for r in res] == [
            ("CQ K1ABC FN42", 6, 2)]


def _has_cuda_card() -> bool:
    import shutil
    import subprocess

    smi = shutil.which("nvidia-smi")
    return bool(smi) and subprocess.run(
        [smi, "-L"], capture_output=True).returncode == 0


class TestNoDeviceFallback:
    """Without --platform the shells decode on the GPU; with none present
    they stop with a clear message instead of carrying on on the CPU."""

    def test_cli_without_platform_fails_without_gpu(self):
        import os
        import subprocess
        import sys

        if _has_cuda_card():
            pytest.skip("a GPU is present")
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        proc = subprocess.run(
            [sys.executable, "-m", "msk144cudecoder_tpu"], input=b"",
            capture_output=True, timeout=120, cwd=repo,
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert proc.returncode != 0
        assert b"no cuda device found" in proc.stderr
        assert b"--platform=cpu" in proc.stderr

    def test_chip_smoke_fails_without_gpu(self, tmp_path):
        import json
        import os
        import subprocess
        import sys

        if _has_cuda_card():
            pytest.skip("a GPU is present")
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py", "--out", str(tmp_path)],
            capture_output=True, text=True, timeout=300, cwd=repo)
        assert proc.returncode != 0
        last = json.loads(proc.stdout.strip().splitlines()[-1])
        assert last["ok"] is False


class TestCompileCache:
    def test_honours_jax_compilation_cache_dir(self, tmp_path, monkeypatch):
        import jax

        from msk144cudecoder_tpu.runtime import backend

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        monkeypatch.delenv("MSK144_TPU_JAX_CACHE", raising=False)
        before = jax.config.jax_compilation_cache_dir
        try:
            assert backend.enable_persistent_cache() == str(tmp_path)
            # the program sets no directory of its own
            assert jax.config.jax_compilation_cache_dir == before
        finally:
            jax.config.update("jax_compilation_cache_dir", before)

    def test_default_cache_inside_checkout(self):
        import pathlib

        from msk144cudecoder_tpu.runtime import backend

        repo = pathlib.Path(__file__).resolve().parents[1]
        path = backend.default_cache_dir()
        assert path.is_relative_to(repo) and path != repo
        assert path.name in (repo / ".gitignore").read_text().replace(
            "/", "").split()
