"""Shared set-up of the port's serving tests: one small Whisper drawn by the
JAX package and carried into the port through the weight bridge, and the
same Whisper tokenizer built by both packages.

The tokenizer has the published 51,865-token layout (a BPE trained on a
tiny corpus, padded with never-produced filler tokens to the 50,257-token
base), so the logit projection and its int4 packing run at the real,
ragged vocabulary width.
"""

import jax
import numpy as np

from audax.core.config import WhisperConfig as JaxWhisperConfig
from audax.models.whisper import init_whisper_params
from audax.symbolic.bpe import BPE as JaxBPE
from audax.symbolic.bpe import train_bpe as jax_train_bpe
from audax.symbolic.tokenizer import WhisperTokenizer as JaxTokenizer
from audax_torch.core.config import WhisperConfig
from audax_torch.models.bridge import params_from_numpy
from audax_torch.symbolic.bpe import BPE
from audax_torch.symbolic.tokenizer import WhisperTokenizer

VOCAB = 51865
CORPUS = ["hello world how are you", "the cat sat on the mat"] * 3


def tokenizers():
    """(JAX tokenizer, port tokenizer) with the same 51,865-token layout."""
    bpe = jax_train_bpe(CORPUS, vocab_size=300)
    vocab = dict(bpe.vocab)
    for i in range(len(vocab), 50257):
        vocab[f"<unused{i}>"] = i
    jtok = JaxTokenizer.for_vocab_size(JaxBPE(vocab, bpe.merges), VOCAB)
    tok = WhisperTokenizer.for_vocab_size(BPE(vocab, bpe.merges), VOCAB)
    assert jtok.vocab_size == tok.vocab_size == VOCAB
    return jtok, tok


def model(*, d_model=64, heads=2, encoder_layers=1, decoder_layers=2,
          n_audio_ctx=50, n_text_ctx=32, seed=0):
    """(jcfg, jparams, numpy tree, cfg, port params on the CPU). The default
    n_audio_ctx of 50 makes the serving window 1 s."""
    jcfg = JaxWhisperConfig(n_mels=80, n_audio_ctx=n_audio_ctx,
                            d_model=d_model, encoder_layers=encoder_layers,
                            decoder_layers=decoder_layers, heads=heads,
                            vocab_size=VOCAB, n_text_ctx=n_text_ctx)
    jparams = init_whisper_params(jcfg, jax.random.key(seed))
    tree = jax.tree.map(np.asarray, jparams)
    cfg = WhisperConfig(**jcfg.asdict())
    return jcfg, jparams, tree, cfg, params_from_numpy(tree, cfg,
                                                       device="cpu")
