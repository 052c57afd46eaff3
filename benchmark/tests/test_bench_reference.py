"""The plain reference against the program's CPU path at a tiny Whisper:
log-mel, encoder, teacher-forced logits, loss and collation agree."""

import numpy as np
import pytest
import torch

from benchmark.lib import gen, weights
from benchmark.lib.serve import whisper_config
from benchmark.reference import compare
from benchmark.reference import whisper_ref as ref
from tiny import tiny_cfg


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_cfg()
    params = weights.make_whisper(cfg, 77, dtype=torch.float32, device="cpu")
    bank = gen.speech_bank(77)
    audio = np.zeros((2, 480000), np.float32)
    audio[0, :64000] = bank[:64000]
    audio[1] = bank[100000:580000]
    return cfg, params, torch.from_numpy(audio)


def test_log_mel_matches_the_frontend(setup):
    from audax_torch.frontend.features import LogMelFrontend
    cfg, _, audio = setup
    got = LogMelFrontend.whisper(cfg["num_mel_bins"], device="cpu")(audio)
    want = ref.log_mel(audio, cfg["num_mel_bins"])
    assert got.shape == want.shape == (2, 3000, cfg["num_mel_bins"])
    assert float((got - want).abs().max()) < 2e-4


def test_logits_and_loss_match_the_program(setup):
    from audax_torch.models.whisper import decode_train, encode
    from audax_torch.train.seq2seq import collate_seq2seq, seq2seq_loss_sum
    cfg, params, audio = setup
    heads = cfg["decoder_attention_heads"]
    mel = ref.log_mel(audio, cfg["num_mel_bins"])
    wcfg = whisper_config(cfg)
    enc_p = encode(params, wcfg, mel)
    enc_r = ref.encode(params, heads, mel)
    assert float((enc_p - enc_r).abs().max()) < 1e-4
    prompt = cfg["deployment"]["prompt"]
    rows = gen.label_rows(np.array([12, 19]), prompt, cfg["eos_token_id"],
                          gen.rng_for(5, 0))
    dec_in, labels = compare.collate(rows, prompt[0])
    coll = collate_seq2seq(rows, decoder_start_id=prompt[0])
    assert np.array_equal(dec_in.numpy(), coll["decoder_input_ids"])
    assert np.array_equal(labels.numpy(), coll["labels"])
    lp = decode_train(params, wcfg, dec_in, enc_p)
    lr = ref.decode(params, heads, dec_in, enc_r)
    assert float((lp - lr).abs().max()) < 1e-4
    sp, cp = seq2seq_loss_sum(lp, labels)
    sr, cr = ref.loss_sum(params, heads, mel, dec_in, labels)
    assert int(cp) == int(cr)
    assert float(sp) == pytest.approx(float(sr), rel=1e-5)


def test_lower_precision_rounds_the_products(setup):
    _, _, audio = setup
    x = audio[:, :4096].reshape(-1, 64)
    low = ref.Lower(torch.float8_e4m3fn)(x)
    err = float((low - x).abs().max() / x.abs().max())
    assert 1e-3 < err < 0.1
    assert torch.equal(ref.FULL(x), x)
