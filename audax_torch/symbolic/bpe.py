"""Byte-pair encoding: trainer + encoder/decoder (pure Python, no Rust).

Port of ``audax/symbolic/bpe.py``: an own copy, so the PyTorch package
imports nothing of the JAX one.

The reference trains a BPE vocab over ABC-notation corpora with the HF
``tokenizers`` Rust crate (reference: .charles/music2midi/preprocess_data.py:363-472,
vocab 2000, specials <abc_start/end/pad>) and uses GPT2-style byte-level BPE
inside the Whisper/Qwen tokenizers. This module owns both capabilities
in-framework:

  * ``train_bpe`` — classic merge-frequency training over pre-tokenized words
  * ``BPE`` — encoder/decoder with byte-level fallback and special tokens,
    serializable to vocab.json + merges.txt (GPT-2 file format, so externally
    trained vocabs load too)
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["BPE", "train_bpe", "bytes_to_unicode", "gpt2_pretokenize"]


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_ENCODER = bytes_to_unicode()
_BYTE_DECODER = {v: k for k, v in _BYTE_ENCODER.items()}

_GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                 r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


def gpt2_pretokenize(text: str) -> List[str]:
    import regex
    return regex.findall(_GPT2_PATTERN, text)


def _word_to_symbols(word: str) -> Tuple[str, ...]:
    return tuple(_BYTE_ENCODER[b] for b in word.encode("utf-8"))


def train_bpe(
    corpus: Iterable[str],
    vocab_size: int,
    *,
    special_tokens: Sequence[str] = (),
    pretokenize=gpt2_pretokenize,
    min_frequency: int = 2,
) -> "BPE":
    """Train byte-level BPE. Alphabet (256 byte symbols) + specials are always
    included; merges fill the remaining budget."""
    word_freq: Counter = Counter()
    for text in corpus:
        for w in pretokenize(text):
            word_freq[_word_to_symbols(w)] += 1

    vocab: Dict[str, int] = {}
    for tok in special_tokens:
        vocab[tok] = len(vocab)
    for ch in _BYTE_ENCODER.values():
        if ch not in vocab:
            vocab[ch] = len(vocab)

    merges: List[Tuple[str, str]] = []
    words = dict(word_freq)
    while len(vocab) < vocab_size:
        pairs: Counter = Counter()
        for sym, freq in words.items():
            for a, b in zip(sym, sym[1:]):
                pairs[(a, b)] += freq
        if not pairs:
            break
        (a, b), freq = pairs.most_common(1)[0]
        if freq < min_frequency:
            break
        merges.append((a, b))
        merged = a + b
        # two merge paths can yield the same string (('ab','c') and
        # ('a','bc')): reassigning would leave a hole and push max id to
        # len(vocab), overlapping the special-token ids appended after
        if merged not in vocab:
            vocab[merged] = len(vocab)
        new_words = {}
        for sym, f in words.items():
            out, i = [], 0
            while i < len(sym):
                if i + 1 < len(sym) and sym[i] == a and sym[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(sym[i])
                    i += 1
            new_words[tuple(out)] = new_words.get(tuple(out), 0) + f
        words = new_words
    return BPE(vocab, merges, special_tokens=list(special_tokens),
               pretokenize=pretokenize)


class BPE:
    """Byte-level BPE encoder/decoder with special-token support."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 *, special_tokens: Optional[List[str]] = None,
                 pretokenize=gpt2_pretokenize):
        self.vocab = dict(vocab)
        self.merges = list(merges)
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.special_tokens = list(special_tokens or [])
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self._pretokenize = pretokenize

    # -- core -------------------------------------------------------------
    def _bpe_word(self, symbols: Tuple[str, ...]) -> List[str]:
        word = list(symbols)
        while len(word) > 1:
            best, best_rank = None, None
            for i, pair in enumerate(zip(word, word[1:])):
                r = self.ranks.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            word[best: best + 2] = [word[best] + word[best + 1]]
        return word

    def encode(self, text: str, *, with_specials: bool = True) -> List[int]:
        """Encode, recognizing special tokens as atomic substrings first."""
        segments: List[Tuple[str, bool]] = [(text, False)]
        if with_specials and self.special_tokens:
            for sp in sorted(self.special_tokens, key=len, reverse=True):
                nxt: List[Tuple[str, bool]] = []
                for seg, is_sp in segments:
                    if is_sp:
                        nxt.append((seg, True))
                        continue
                    parts = seg.split(sp)
                    for i, part in enumerate(parts):
                        if part:
                            nxt.append((part, False))
                        if i < len(parts) - 1:
                            nxt.append((sp, True))
                segments = nxt
        ids: List[int] = []
        for seg, is_sp in segments:
            if is_sp:
                ids.append(self.vocab[seg])
                continue
            for w in self._pretokenize(seg):
                for piece in self._bpe_word(_word_to_symbols(w)):
                    if piece in self.vocab:
                        ids.append(self.vocab[piece])
                    else:  # unmergeable multi-byte piece: emit per symbol
                        ids.extend(self.vocab[c] for c in piece)
        return ids

    def token_bytes(self, i: int) -> "bytes | None":
        """Raw bytes of one vocab id (None for special tokens/unknown ids).
        Byte-level pieces do NOT decode independently — UTF-8 sequences can
        span pieces — so alignment code groups on bytes, not on per-token
        decode output."""
        tok = self.id_to_token.get(int(i))
        if tok is None or tok in self.special_tokens:
            return None
        return bytes(_BYTE_DECODER[c] for c in tok)

    def decode(self, ids: Sequence[int], *, skip_specials: bool = False) -> str:
        out: List[str] = []
        specials = set(self.special_tokens)
        buf: List[str] = []

        def flush():
            if buf:
                data = bytes(_BYTE_DECODER[c] for c in "".join(buf))
                out.append(data.decode("utf-8", errors="replace"))
                buf.clear()

        for i in ids:
            tok = self.id_to_token.get(int(i))
            if tok is None:
                continue
            if tok in specials:
                flush()
                if not skip_specials:
                    out.append(tok)
            else:
                buf.append(tok)
        flush()
        return "".join(out)

    # -- vocab extension (resize-embeddings contract) ---------------------
    def add_tokens(self, tokens: Sequence[str]) -> int:
        """Append atomic tokens (the reference's tokenizer.add_tokens +
        resize_token_embeddings contract, preprocess_data.py:430-472,
        model.py:217-224). Returns count added."""
        added = 0
        for t in tokens:
            if t not in self.vocab:
                self.vocab[t] = len(self.vocab)
                self.special_tokens.append(t)
                added += 1
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        return added

    def added_token_ids(self) -> List[int]:
        """Ids of the special/appended atomic tokens (train-time specials +
        everything from ``add_tokens``). The reference read these from
        added_tokens.json to build its constrained-decoding allowlist
        (model.py:369-377); meaningful when a general-text vocab was
        extended with ABC tokens — then this IS the ABC token set."""
        return [self.vocab[t] for t in self.special_tokens
                if t in self.vocab]

    def __len__(self) -> int:
        return len(self.vocab)

    # -- persistence (GPT-2 file format) ----------------------------------
    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "vocab.json"), "w") as fh:
            json.dump(self.vocab, fh, ensure_ascii=False)
        with open(os.path.join(directory, "merges.txt"), "w") as fh:
            fh.write("#version: 0.2\n")
            for a, b in self.merges:
                fh.write(f"{a} {b}\n")
        with open(os.path.join(directory, "special_tokens.json"), "w") as fh:
            json.dump(self.special_tokens, fh, ensure_ascii=False)

    @classmethod
    def load(cls, directory: str, pretokenize=gpt2_pretokenize) -> "BPE":
        with open(os.path.join(directory, "vocab.json")) as fh:
            vocab = json.load(fh)
        merges: List[Tuple[str, str]] = []
        with open(os.path.join(directory, "merges.txt")) as fh:
            for i, line in enumerate(fh):
                line = line.rstrip("\n")
                # only the FIRST line may be the '#version:' header: byte
                # '#' maps to itself in byte-level BPE, so real merges can
                # start with '#' (GPT-2/Whisper merges.txt has '# #',
                # '## #', ... producing the '##'/'###' tokens) and must
                # not be skipped as comments
                if not line or (i == 0 and line.startswith("#version")):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        sp_path = os.path.join(directory, "special_tokens.json")
        specials = []
        if os.path.exists(sp_path):
            with open(sp_path) as fh:
                specials = json.load(fh)
        return cls(vocab, merges, special_tokens=specials,
                   pretokenize=pretokenize)
