"""Port transcript writers and ``batch_transcribe_to_csv`` vs the JAX
package's, on the CPU.

Every writer renders the same result (segments with and without word
timings, an hour rollover, non-ASCII text) byte for byte as the JAX
writers do, under every subtitle line option. ``batch_transcribe_to_csv``
runs the port and the JAX Transcriber (a small Whisper, JAX-initialised and
bridged, 1 s windows) over the same WAV files: the same rows (apart from
the measured real-time factor), sidecars and per-format files (apart from
the JSON's measured wall time).
"""

import csv
import json
import os

import numpy as np
import pytest

from audax.infer import transcribe as jtr_mod
from audax.infer import writers as jwriters
from audax.infer.align import WordTiming as JaxWordTiming
from audax.data.audio_io import write_wav
from audax_torch.infer import transcribe as T
from audax_torch.infer import writers
from audax_torch.infer.align import WordTiming

from .whisper_pair import model as bridged_model
from .whisper_pair import tokenizers


def _results(with_words, long=False):
    """The same TranscriptionResult built from each package's types."""
    out = []
    for mod, wt in ((T, WordTiming), (jtr_mod, JaxWordTiming)):
        words1 = words2 = None
        if with_words:
            words1 = [wt(" Hello", 0.0, 0.4, 0.9), wt(" there", 0.5, 0.9, 0.8),
                      wt(" general", 1.0, 1.6, 0.7),
                      wt(" Kenobi", 1.7, 2.3, 0.95)]
            words2 = [wt(" You're", 3.0, 3.4, 0.9), wt(" bold", 3.5, 3.9, 0.85),
                      wt(" café", 3.9, 4.0, 0.5)]
        off = 3599.5 if long else 0.0
        segs = [mod.Segment(" Hello there general Kenobi", off, off + 2.4,
                            -0.1, 0.0, words=words1,
                            compression_ratio=1.2, no_speech_prob=0.01),
                mod.Segment(" You're bold café", off + 3.0, off + 4.0, -0.2,
                            0.2, words=words2),
                mod.Segment("  ", off + 4.0, off + 4.5, -0.3, 0.0)]
        text = "".join(s.text for s in segs).strip()
        out.append(mod.TranscriptionResult(text, segs,
                                           audio_seconds=off + 4.5,
                                           wall_seconds=0.125))
    return out


OPTS = [dict(), dict(max_words_per_line=2), dict(max_line_width=12),
        dict(max_line_width=12, max_line_count=2), dict(highlight_words=True),
        dict(max_words_per_line=3, highlight_words=True)]


@pytest.mark.parametrize("fmt", writers.FORMATS)
@pytest.mark.parametrize("with_words", [False, True], ids=["segments", "words"])
@pytest.mark.parametrize("long", [False, True], ids=["short", "hour"])
def test_render_matches_jax(fmt, with_words, long):
    ours, ref = _results(with_words, long)
    for opts in OPTS:
        assert writers.render_result(ours, fmt, **opts) == \
            jwriters.render_result(ref, fmt, **opts), (fmt, opts)


def test_write_result_and_get_writer_match_jax(tmp_path):
    ours, ref = _results(True)
    w = writers.get_writer("all", str(tmp_path / "port"))
    jw = jwriters.get_writer("all", str(tmp_path / "jax"))
    paths, jpaths = w(ours, "/x/memo.wav"), jw(ref, "/y/memo.wav")
    assert [os.path.basename(p) for p in paths] == \
        [os.path.basename(p) for p in jpaths] == \
        [f"memo.{f}" for f in writers.FORMATS]
    for p, jp in zip(paths, jpaths):
        assert open(p, "rb").read() == open(jp, "rb").read()
    single = writers.write_result(ours, "srt", str(tmp_path / "a" / "b.srt"),
                                  max_words_per_line=2)
    assert open(single).read() == jwriters.render_result(
        ref, "srt", max_words_per_line=2)
    assert writers._ts(3725.0049, sep=",") == jwriters._ts(3725.0049, sep=",")
    for bad in (lambda: writers.get_writer("nope", str(tmp_path)),
                lambda: writers.render_result(ours, "doc"),
                lambda: writers.write_result(ours, "doc", str(tmp_path / "z"))):
        with pytest.raises(ValueError, match="unknown output format"):
            bad()


@pytest.fixture(scope="module")
def pair():
    jtok, tok = tokenizers()
    jcfg, jparams, _, cfg, params = bridged_model()
    kw = dict(max_new_tokens=6, temperature_fallback=False, timestamps=True)
    return (jtr_mod.Transcriber(jparams, jcfg, jtok, backend="xla", **kw),
            T.Transcriber(params, cfg, tok, device="cpu", **kw))


def _wavs(root, rng):
    root.mkdir()
    paths = []
    for i, (seconds, rate) in enumerate(((1.5, 16000), (0.7, 16000),
                                         (1.2, 22050))):
        p = str(root / f"memo{i}.wav")
        write_wav(p, (0.1 * rng.standard_normal(int(seconds * rate))
                      ).astype(np.float32), rate)
        paths.append(p)
    bad = str(root / "broken.wav")
    with open(bad, "wb") as fh:
        fh.write(b"junk")
    return paths + [bad]


def _rows(rows, root):
    """Rows without the measured real-time factor, each file's folder in
    an error message replaced by ``ROOT``."""
    out = []
    for r in rows:
        r = {k: v for k, v in r.items() if k != "rtf"}
        if r.get("error"):
            r["error"] = r["error"].replace(str(root), "ROOT")
        out.append(r)
    return out


def _csv_rows(path):
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    assert all(float(r["rtf"]) != 0.0 for r in rows)
    return _rows(rows, path.parent)


def test_batch_transcribe_to_csv_matches_jax(pair, tmp_path, rng):
    jtr, tr = pair
    paths = {"port": _wavs(tmp_path / "port", rng)}
    paths["jax"] = _wavs(tmp_path / "jax", np.random.default_rng(0))
    # the same audio in both folders
    for p, q in zip(paths["port"], paths["jax"]):
        with open(p, "rb") as a, open(q, "wb") as b:
            b.write(a.read())
    runs = {}
    for key, fn, t in (("port", T.batch_transcribe_to_csv, tr),
                       ("jax", jtr_mod.batch_transcribe_to_csv, jtr)):
        root = tmp_path / key
        runs[key] = fn(t, paths[key], str(root / "out.csv"),
                       previous={"memo0.wav": "old text"},
                       output_format="all", output_dir=str(root / "subs"),
                       writer_opts=dict(max_words_per_line=2))
    ours, ref = runs["port"], runs["jax"]
    assert len(ours) == 4 and "error" in ours[3] and ours[3]["rtf"] == -1.0
    assert _rows(ours, tmp_path / "port") == _rows(ref, tmp_path / "jax")
    assert ours[0]["previous"] == "old text"
    assert _csv_rows(tmp_path / "port" / "out.csv") == \
        _csv_rows(tmp_path / "jax" / "out.csv")
    for i in range(3):
        for suffix in ("txt",):
            a = (tmp_path / "port" / f"memo{i}.{suffix}").read_bytes()
            assert a == (tmp_path / "jax" / f"memo{i}.{suffix}").read_bytes()
        for fmt in writers.FORMATS:
            a = (tmp_path / "port" / "subs" / f"memo{i}.{fmt}").read_text()
            b = (tmp_path / "jax" / "subs" / f"memo{i}.{fmt}").read_text()
            if fmt == "json":
                a, b = json.loads(a), json.loads(b)
                assert a.pop("wall_seconds") > 0 and b.pop("wall_seconds") > 0
                for sa, sb in zip(a["segments"], b["segments"]):
                    assert sa.pop("avg_logprob") == pytest.approx(
                        sb.pop("avg_logprob"), abs=1e-4)
                    assert sa.pop("no_speech_prob") == pytest.approx(
                        sb.pop("no_speech_prob"), abs=1e-5)
            assert a == b, (i, fmt)
