"""Build a full-size (50,257-token) GPT-2-format tokenizer directory from a
small label corpus by padding a trained BPE with unused filler tokens
(port of ``tools/make_padded_tokenizer.py``).

With no published Whisper vocabulary files on the machine, a model at the
published widths still needs a vocabulary of the published size:
``cli/main.py:_load_whisper`` shrinks ``cfg.vocab_size`` to the
tokenizer's, and a ~300-token head is another model (the head is ~40% of
the decoder's FLOPs). Padding the trained BPE to the multilingual base
size (50,257) makes ``WhisperTokenizer.for_vocab_size`` resolve the
standard 51,865 layout; filler ids are never produced by ``encode`` (no
merge reaches them) and never decoded.

    python -m audax_torch.tools.make_padded_tokenizer \\
        --labels-csv datagen/mididataset.csv --out tok_full [--vocab-size 50257]
"""

from __future__ import annotations

import argparse
import csv

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--labels-csv", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--vocab-size", type=int, default=50257,
                    help="padded base size (published multilingual base)")
    ap.add_argument("--bpe-vocab", type=int, default=600,
                    help="real trained vocab budget before padding")
    args = ap.parse_args(argv)

    from audax_torch.symbolic.bpe import BPE, train_bpe

    with open(args.labels_csv, newline="") as fh:
        corpus = [row["labels"] for row in csv.DictReader(fh)]
    if not corpus:
        raise SystemExit(f"no labels in {args.labels_csv}")
    bpe = train_bpe(corpus, vocab_size=args.bpe_vocab)
    vocab = dict(bpe.vocab)
    for i in range(len(vocab), args.vocab_size):
        vocab[f"<unused{i}>"] = i
    padded = BPE(vocab, bpe.merges)
    padded.save(args.out)
    print(f"{args.out}: {len(padded)} tokens "
          f"({len(bpe)} trained + {len(padded) - len(bpe)} filler), "
          f"{len(bpe.merges)} merges")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
