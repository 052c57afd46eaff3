"""Transcript output writers: txt / srt / vtt / tsv / json (own copy of
``audax/infer/writers.py``).

The reference reaches transcripts through openai-whisper's ``model.transcribe``
(AB/wavToWhisper.py:7-18), whose CLI ecosystem emits subtitle formats from the
segment list. The port produces the same artifact family from its own
``TranscriptionResult``:

- ``txt``  — plain text, one segment per line
- ``srt``  — SubRip cues (``HH:MM:SS,mmm``), 1-indexed
- ``vtt``  — WebVTT cues (``HH:MM:SS.mmm``)
- ``tsv``  — ``start\tend\ttext`` with integer-millisecond offsets
- ``json`` — the full result (text, segments, word timings, diagnostics)

Subtitle cues honour word-level re-lining when the result carries word
timings (``Transcriber(word_timestamps=True)``): ``max_words_per_line`` /
``max_line_width`` / ``max_line_count`` split segments into word-timed cues,
and ``highlight_words`` emits one cue per word with the active word
underlined (``<u>…</u>``) — the conventional karaoke form.

Pure functions over ``TranscriptionResult``; no device work.
"""
from __future__ import annotations

import dataclasses
import json as _json
import os
from typing import IO, List, Optional, Sequence

__all__ = ["FORMATS", "write_result", "get_writer", "render_result"]

FORMATS = ("txt", "srt", "vtt", "tsv", "json")


def _ts(seconds: float, *, sep: str) -> str:
    """Format seconds as HH:MM:SS<sep>mmm (srt uses ',', vtt '.')."""
    ms = max(0, int(round(seconds * 1000.0)))
    h, ms = divmod(ms, 3_600_000)
    m, ms = divmod(ms, 60_000)
    s, ms = divmod(ms, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}{sep}{ms:03d}"


@dataclasses.dataclass
class _Cue:
    start: float
    end: float
    lines: List[str]


def _segment_cues(result, *, max_words_per_line: Optional[int] = None,
                  max_line_width: Optional[int] = None,
                  max_line_count: Optional[int] = None,
                  highlight_words: bool = False) -> List[_Cue]:
    """Flatten a result's segments into subtitle cues.

    Without word timings (or constraints) each segment is one cue. With
    word timings, words are greedily packed into lines bounded by
    ``max_line_width`` chars / ``max_words_per_line`` words, and cues hold
    at most ``max_line_count`` lines, timed by their first/last word.
    """
    want_words = (highlight_words or max_words_per_line or max_line_width
                  or max_line_count)
    cues: List[_Cue] = []
    for seg in result.segments:
        words = seg.words if want_words else None
        if not words:
            text = seg.text.strip()
            if text:
                cues.append(_Cue(seg.start, seg.end, [text]))
            continue
        # Pack words into lines under the width/count constraints.
        width = max_line_width or 10 ** 9
        per_line = max_words_per_line or 10 ** 9
        lines: List[List] = [[]]
        for w in words:
            line = lines[-1]
            joined = "".join(x.word for x in line) + w.word
            if line and (len(joined.strip()) > width or len(line) >= per_line):
                lines.append([w])
            else:
                line.append(w)
        lines = [ln for ln in lines if ln]
        # cues hold max_line_count lines (default 1 when any line
        # constraint is active, else the whole segment stays one cue)
        if max_line_count:
            group = max_line_count
        elif max_line_width or max_words_per_line:
            group = 1
        else:
            group = max(len(lines), 1)
        for i in range(0, len(lines), group):
            chunk = lines[i:i + group]
            flat = [w for ln in chunk for w in ln]
            if highlight_words:
                # one cue per word; the active word underlined
                for j, w in enumerate(flat):
                    rendered = []
                    for ln in chunk:
                        parts = []
                        for x in ln:
                            t = x.word
                            if x is flat[j]:
                                t = (t[: len(t) - len(t.lstrip())]
                                     + "<u>" + t.strip() + "</u>")
                            parts.append(t)
                        rendered.append("".join(parts).strip())
                    end = (flat[j + 1].start if j + 1 < len(flat)
                           else flat[-1].end)
                    cues.append(_Cue(flat[j].start, end, rendered))
            else:
                cues.append(_Cue(flat[0].start, flat[-1].end,
                                 ["".join(x.word for x in ln).strip()
                                  for ln in chunk]))
    return cues


def _write_txt(result, fh: IO[str], **_opts) -> None:
    for seg in result.segments:
        text = seg.text.strip()
        if text:
            fh.write(text + "\n")
    if not result.segments and result.text.strip():
        fh.write(result.text.strip() + "\n")


def _write_srt(result, fh: IO[str], **opts) -> None:
    for i, cue in enumerate(_segment_cues(result, **opts), start=1):
        fh.write(f"{i}\n{_ts(cue.start, sep=',')} --> "
                 f"{_ts(cue.end, sep=',')}\n")
        fh.write("\n".join(cue.lines) + "\n\n")


def _write_vtt(result, fh: IO[str], **opts) -> None:
    fh.write("WEBVTT\n\n")
    for cue in _segment_cues(result, **opts):
        fh.write(f"{_ts(cue.start, sep='.')} --> "
                 f"{_ts(cue.end, sep='.')}\n")
        fh.write("\n".join(cue.lines) + "\n\n")


def _write_tsv(result, fh: IO[str], **_opts) -> None:
    fh.write("start\tend\ttext\n")
    for seg in result.segments:
        fh.write(f"{int(round(seg.start * 1000))}\t"
                 f"{int(round(seg.end * 1000))}\t{seg.text.strip()}\n")


def _write_json(result, fh: IO[str], **_opts) -> None:
    def seg_dict(seg):
        d = {"text": seg.text, "start": seg.start, "end": seg.end,
             "avg_logprob": seg.avg_logprob, "temperature": seg.temperature,
             "compression_ratio": seg.compression_ratio,
             "no_speech_prob": seg.no_speech_prob}
        if seg.words is not None:
            d["words"] = [{"word": w.word, "start": w.start, "end": w.end,
                           "probability": w.probability}
                          for w in seg.words]
        return d

    _json.dump({"text": result.text,
                "segments": [seg_dict(s) for s in result.segments],
                "audio_seconds": result.audio_seconds,
                "wall_seconds": result.wall_seconds}, fh,
               ensure_ascii=False, indent=2)
    fh.write("\n")


_WRITERS = {"txt": _write_txt, "srt": _write_srt, "vtt": _write_vtt,
            "tsv": _write_tsv, "json": _write_json}


def render_result(result, fmt: str, **opts) -> str:
    """Render one result in ``fmt`` to a string (the HTTP
    ``response_format`` path; same writers as the file API)."""
    import io
    if fmt not in _WRITERS:
        raise ValueError(f"unknown output format {fmt!r}; "
                         f"choose from {FORMATS}")
    buf = io.StringIO()
    _WRITERS[fmt](result, buf, **opts)
    return buf.getvalue()


def write_result(result, fmt: str, path: str, **opts) -> str:
    """Write one result in ``fmt`` to ``path`` (returns the path)."""
    if fmt not in _WRITERS:
        raise ValueError(f"unknown output format {fmt!r}; "
                         f"choose from {FORMATS} or 'all'")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        _WRITERS[fmt](result, fh, **opts)
    return path


def get_writer(fmt: str, output_dir: str):
    """Return ``writer(result, audio_path, **opts)`` emitting
    ``output_dir/<stem>.<fmt>``; ``fmt='all'`` emits every format."""
    fmts: Sequence[str] = FORMATS if fmt == "all" else (fmt,)
    for f in fmts:
        if f not in _WRITERS:
            raise ValueError(f"unknown output format {f!r}; "
                             f"choose from {FORMATS} or 'all'")

    def writer(result, audio_path: str, **opts) -> List[str]:
        stem = os.path.splitext(os.path.basename(audio_path))[0]
        return [write_result(result, f, os.path.join(output_dir,
                                                     f"{stem}.{f}"), **opts)
                for f in fmts]

    return writer
