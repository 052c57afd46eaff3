"""Task tokenizers: the Whisper special-token layout after a BPE base vocab
and a plain vocab tokenizer (port of ``audax/symbolic/tokenizer.py``:
``WhisperTokenizer``, ``VocabTokenizer``; own copies).

The layout (<|endoftext|>, <|startoftranscript|>, 99 language tags, task
tags, timestamps at 0.02 s resolution) is appended after an arbitrary
byte-level BPE base vocab: with the published vocab.json/merges.txt on disk
the ids match OpenAI/HF checkpoints; in tests a tiny trained vocab gets the
same structure.

``VocabTokenizer`` is the simple lookup tokenizer of the raw ABC-token
variant (a token -> id JSON, the reference's preprocess_data.py:311-361).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

from audax_torch.symbolic.bpe import BPE

__all__ = ["WhisperTokenizer", "VocabTokenizer", "WHISPER_LANGUAGES",
           "WHISPER_LANGUAGES_V3"]

# the 99 whisper language codes in canonical id order; large-v3 appends
# "yue" (Cantonese) as language 100, shifting every later special id by one
WHISPER_LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms "
    "cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn "
    "et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
    "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln "
    "ha ba jw su"
).split()
WHISPER_LANGUAGES_V3 = WHISPER_LANGUAGES + ["yue"]


class WhisperTokenizer:
    """BPE base + whisper control tokens; ids laid out exactly after the base
    vocab so ported checkpoints line up."""

    def __init__(self, bpe: BPE, *, num_languages: int = len(WHISPER_LANGUAGES),
                 timestamp_count: int = 1501):
        if not 1 <= num_languages <= len(WHISPER_LANGUAGES_V3):
            raise ValueError(f"num_languages must be in "
                             f"[1, {len(WHISPER_LANGUAGES_V3)}]: {num_languages}")
        self.bpe = bpe
        base = len(bpe)
        self.eot = base
        self.sot = base + 1
        self._lang_base = base + 2
        self.num_languages = num_languages
        #: language codes valid for THIS layout (99 for <=v2, 100 for v3)
        self.languages = WHISPER_LANGUAGES_V3[:num_languages]
        self.translate = self._lang_base + num_languages
        self.transcribe = self.translate + 1
        self.sot_lm = self.transcribe + 1
        self.sot_prev = self.sot_lm + 1
        self.no_speech = self.sot_prev + 1
        self.no_timestamps = self.no_speech + 1
        self.timestamp_begin = self.no_timestamps + 1
        self.timestamp_count = timestamp_count
        self.vocab_size = self.timestamp_begin + timestamp_count

    @classmethod
    def from_pretrained_dir(cls, directory: str,
                            vocab_size: int | None = None) -> "WhisperTokenizer":
        """Load vocab.json + merges.txt (HF/OpenAI format) from disk.

        Pass the checkpoint's ``vocab_size`` (model config) to infer the
        language count: large-v3 checkpoints carry 51866 (100 languages),
        earlier multilingual ones 51865 (99). Without it, 99 is assumed.
        """
        bpe = BPE.load(directory)
        if vocab_size is not None:
            return cls.for_vocab_size(bpe, vocab_size)
        return cls(bpe)

    @classmethod
    def for_vocab_size(cls, bpe: BPE, vocab_size: int,
                       timestamp_count: int = 1501) -> "WhisperTokenizer":
        """Solve the language count from the checkpoint's total vocab size:
        ``vocab = base + 2 (eot, sot) + num_languages + 6 (task/ctl)
        + timestamps``. For the published multilingual base (50257) this
        yields 99 for vocab 51865 and 100 (large-v3, +yue) for 51866."""
        num_languages = vocab_size - len(bpe) - 8 - timestamp_count
        return cls(bpe, num_languages=num_languages,
                   timestamp_count=timestamp_count)

    def lang_token(self, lang: str) -> int:
        return self._lang_base + self.languages.index(lang)

    def sot_sequence(self, *, lang: str = "en", task: str = "transcribe",
                     timestamps: bool = False) -> List[int]:
        seq = [self.sot, self.lang_token(lang),
               self.transcribe if task == "transcribe" else self.translate]
        if not timestamps:
            seq.append(self.no_timestamps)
        return seq

    def timestamp_token(self, seconds: float) -> int:
        return self.timestamp_begin + int(round(seconds / 0.02))

    def timestamp_seconds(self, token: int) -> float:
        return (token - self.timestamp_begin) * 0.02

    def is_timestamp(self, token: int) -> bool:
        return token >= self.timestamp_begin

    def special_ids(self) -> List[int]:
        ids = [self.eot, self.sot, self.translate, self.transcribe,
               self.sot_lm, self.sot_prev, self.no_speech, self.no_timestamps]
        ids.extend(range(self._lang_base, self._lang_base + self.num_languages))
        return ids

    def encode(self, text: str) -> List[int]:
        return self.bpe.encode(text, with_specials=False)

    def non_speech_tokens(self) -> List[int]:
        """Base-vocab ids for annotation/music symbols — whisper's default
        ``suppress_tokens="-1"`` list, so decoding never emits bracket
        noise, ♪, speaker dashes, etc. (openai builds the same set inside
        its tokenizer; the reference consumed it through
        openai-whisper's transcribe defaults, AB/wavToWhisper.py:10-13).

        Probes THIS tokenizer's vocab: a symbol contributes only when it
        (or its space-prefixed form) encodes to a single token, except the
        musical-note set whose lead token is banned even when multi-token
        (matching upstream). On the published GPT-2-style vocabs this
        reproduces openai's ids; on tiny ad-hoc test vocabs it degrades to
        whatever single-byte symbols exist."""
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
        symbols += ("<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] "
                    "{{ }} ♪♪ ♪♪♪").split()
        notes = set("♩♪♫♬♭♮♯")
        out = set()
        for lead in (" -", " '"):
            ids = self.encode(lead)
            if len(ids) == 1:
                out.add(ids[0])
        for sym in symbols + sorted(notes):
            for ids in (self.encode(sym), self.encode(" " + sym)):
                if ids and (len(ids) == 1 or sym in notes):
                    out.add(ids[0])
        return sorted(out)

    def decode(self, ids: Sequence[int], *, skip_special: bool = True) -> str:
        base = len(self.bpe)
        parts: List[str] = []
        run: List[int] = []

        def flush():
            if run:
                parts.append(self.bpe.decode(run))
                run.clear()

        for i in ids:
            i = int(i)
            if i >= base:
                if not skip_special:
                    flush()
                    parts.append(self._special_repr(i))
                continue
            run.append(i)
        flush()
        return "".join(parts)

    def _special_repr(self, i: int) -> str:
        if i == self.eot:
            return "<|endoftext|>"
        if i == self.sot:
            return "<|startoftranscript|>"
        if self._lang_base <= i < self._lang_base + self.num_languages:
            return f"<|{self.languages[i - self._lang_base]}|>"
        if i == self.translate:
            return "<|translate|>"
        if i == self.transcribe:
            return "<|transcribe|>"
        if i == self.sot_lm:
            return "<|startoflm|>"
        if i == self.sot_prev:
            return "<|startofprev|>"
        if i == self.no_speech:
            return "<|nospeech|>"
        if i == self.no_timestamps:
            return "<|notimestamps|>"
        if i >= self.timestamp_begin:
            return f"<|{self.timestamp_seconds(i):.2f}|>"
        return f"<|special_{i}|>"


class VocabTokenizer:
    """Plain token<->id lookup tokenizer over whitespace-split or
    caller-supplied token streams (raw ABC-token mode)."""

    def __init__(self, vocab: Dict[str, int], *, unk: str = "<unk>",
                 pad: str = "<pad>", bos: str = "<s>", eos: str = "</s>"):
        self.vocab = dict(vocab)
        for sp in (pad, bos, eos, unk):
            if sp not in self.vocab:
                self.vocab[sp] = len(self.vocab)
        self.unk, self.pad, self.bos, self.eos = unk, pad, bos, eos
        self.id_to_token = {i: t for t, i in self.vocab.items()}

    @property
    def pad_id(self) -> int:
        return self.vocab[self.pad]

    @property
    def bos_id(self) -> int:
        return self.vocab[self.bos]

    @property
    def eos_id(self) -> int:
        return self.vocab[self.eos]

    def __len__(self) -> int:
        return len(self.vocab)

    def encode_tokens(self, tokens: Sequence[str]) -> List[int]:
        unk = self.vocab[self.unk]
        return [self.vocab.get(t, unk) for t in tokens]

    def decode(self, ids: Sequence[int], *,
               skip_special: bool = True) -> List[str]:
        specials = {self.pad, self.bos, self.eos} if skip_special else set()
        out = []
        for i in ids:
            t = self.id_to_token.get(int(i))
            if t is not None and t not in specials:
                out.append(t)
        return out

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump(self.vocab, fh, ensure_ascii=False, indent=0)

    @classmethod
    def load(cls, path: str) -> "VocabTokenizer":
        with open(path) as fh:
            return cls(json.load(fh))
