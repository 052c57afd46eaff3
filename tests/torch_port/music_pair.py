"""Shared set-up of the music-training parity tests: a tiny two-tower
built by the JAX package and carried into the port through the weight
bridge, and an in-memory music dataset (``MusicDataset``'s interface) of
rendered random melodies with their ABC and BPE ids."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np

from audax.core.config import TwoTowerConfig as JaxTTConfig
from audax.core.config import WhisperConfig as JaxWhisperConfig
from audax.models import two_tower as JT
from audax.models.causal_lm import CausalLMConfig as JaxLMConfig
from audax_torch.core.config import TwoTowerConfig, WhisperConfig
from audax_torch.data.music_dataset import ABC_SPECIALS, MusicExample
from audax_torch.data.synth import _random_melody, render_midi
from audax_torch.models import two_tower as PT
from audax_torch.models.bridge import params_from_numpy, two_tower_from_numpy
from audax_torch.models.causal_lm import CausalLMConfig
from audax_torch.symbolic.abc import midi_to_abc
from audax_torch.symbolic.bpe import train_bpe

#: LM 2 layers, d 64, 4/2 heads (head_dim 16); audio tower 2 layers, a 1 s
#: window (100 frames); the adapter's 4 heads (head_dim 16) and 48 target
#: tokens put its cross-attention on the flash path (plain K2/K7/K8 on CPU)
LM = dict(d_model=64, layers=2, heads=4, kv_heads=2, qk_norm=True,
          max_seq=64)
AUDIO = dict(n_mels=80, n_audio_ctx=50, d_model=64, encoder_layers=2,
             decoder_layers=1, heads=2, vocab_size=64, n_text_ctx=8)
TT = dict(adapter_heads=4, top_k_unfrozen_layers=1, max_target_tokens=48,
          batch_size=4, epochs=2, adapter_lr=3e-3, lm_lr=1e-3)
CHUNK_S = 1.0


class MemoryDataset:
    """``MusicDataset``'s interface over a list of ``MusicExample``."""

    def __init__(self, examples, tokenizer):
        self.items = list(examples)
        self.tokenizer = tokenizer
        vocab = tokenizer.vocab
        self.start_id, self.end_id, self.pad_id = (
            vocab.get(s, 0) for s in ABC_SPECIALS)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def music_dataset(n=8, seed=0, max_tokens=48):
    """Rendered 1 s random melodies (2 notes, up to 2-note chords), their
    ABC, and a BPE trained over the ABC."""
    rng = np.random.default_rng(seed)
    mfs = [_random_melody(rng, 2, 100, low=48, high=84, max_poly=2)[0]
           for _ in range(n)]
    mfs = [m.cut(CHUNK_S) if m.duration_seconds > CHUNK_S else m
           for m in mfs]
    abcs = [midi_to_abc(m, title=f"t{i}") for i, m in enumerate(mfs)]
    bpe = train_bpe(abcs, 160, special_tokens=list(ABC_SPECIALS),
                    min_frequency=2)
    start, end, pad = (bpe.vocab[s] for s in ABC_SPECIALS)
    items = []
    for i, (m, abc) in enumerate(zip(mfs, abcs)):
        ids = ([start] + bpe.encode(abc, with_specials=False)
               + [end])[:max_tokens]
        mask = np.zeros(max_tokens, np.int32)
        mask[: len(ids)] = 1
        padded = np.full(max_tokens, pad, np.int32)
        padded[: len(ids)] = ids
        items.append(MusicExample(render_midi(m), 16000, padded, mask, abc,
                                  f"t{i}"))
    return MemoryDataset(items, bpe)


def build_pair(vocab, seed=0, **tt):
    """(JAX model, port model on the CPU) with the same weights; the
    adapter's zero gates are opened from a numpy seed."""
    tt_kw = dict(TT, **tt)
    jm = JT.build_two_tower(JaxTTConfig(**tt_kw), JaxWhisperConfig(**AUDIO),
                            JaxLMConfig(vocab_size=vocab, **LM), vocab,
                            jax.random.key(seed))
    rng = np.random.default_rng(seed + 100)
    params = jax.tree.map(np.asarray, jm.params)
    for gate in ("out", "ffn_out"):
        k = params["adapter"][gate]["kernel"]
        params["adapter"][gate]["kernel"] = (
            0.5 * rng.standard_normal(k.shape) / np.sqrt(k.shape[0])
        ).astype(np.float32)
    jm = jm._replace(params=jax.tree.map(jnp.asarray, params))
    lm_cfg = CausalLMConfig(vocab_size=vocab, **LM)
    audio_cfg = WhisperConfig(**AUDIO)
    pm = PT.TwoTowerModel(
        params_from_numpy(jax.tree.map(np.asarray, jm.audio_params),
                          audio_cfg, device="cpu"),
        audio_cfg, two_tower_from_numpy(params, lm_cfg, device="cpu"),
        lm_cfg, TwoTowerConfig(**tt_kw))
    return jm, pm


def with_cfg(jm, pm, **changes):
    """Both models with their two-tower configs changed."""
    return (jm._replace(cfg=replace(jm.cfg, **changes)),
            pm._replace(cfg=replace(pm.cfg, **changes)))


def flat(tree, prefix=""):
    """{path: numpy array} of a nested dict of arrays or tensors."""
    out = {}
    for k in sorted(tree):
        p = f"{prefix}/{k}" if prefix else k
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, p))
        else:
            out[p] = (v.detach().cpu().numpy() if hasattr(v, "detach")
                      else np.asarray(v))
    return out
