"""Port UrbanSound8K data path vs the JAX package on the CPU: the synthetic
stand-in dataset, Parquet preprocessing and split loading.

Features are compared within 2e-3 in the log domain, the JAX package's
own frontend bound (``bench.py``); everything else exactly. The synthetic
clips are pure tones over a 0.01 noise floor, about 100 dB of range, so
their lowest bins come out of cancelling float32 sums: on these 20 clips
the JAX package's own two frontends (Pallas in interpret mode, XLA) differ
by up to 1.4e-3, and each float32 path by as much from a float64 oracle.
The 2e-4 parity of the tiers on broadband signals is held in
``test_torch_logmel_direct.py``.
"""

import os

import numpy as np
import pytest

from audax.core.config import MelConfig as JaxMelConfig
from audax.core.config import UrbanSoundConfig as JaxUrbanSoundConfig
from audax.data import synth as jax_synth
from audax.data.urbansound import load_split as jax_load_split
from audax.data.urbansound import parquet_name as jax_parquet_name
from audax.data.urbansound import preprocess_to_parquet as jax_preprocess
from audax.frontend import LogMelFrontend as JaxFrontend
from audax_torch.core.config import MelConfig, UrbanSoundConfig
from audax_torch.data import synth
from audax_torch.data.urbansound import (featurize_clips, load_split,
                                         parquet_name, preprocess_to_parquet)
from audax_torch.frontend import LogMelFrontend
from audax_torch.ops import direct_mel

TOL = 2e-3
#: UrbanSound v2 (the overlap tier) and a --fft 512 --hop 160 config, which
#: is not overlap-applicable (g = 32, a = 5) and runs the packed tier K4
MELS = {"v2": {}, "fft512_hop160": dict(n_fft=512, hop_length=160)}


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The synthetic dataset written by each package (2 clips per fold)."""
    root = tmp_path_factory.mktemp("us8k")
    ours = synth.make_synthetic_urbansound(str(root / "port"), per_fold=2)
    ref = jax_synth.make_synthetic_urbansound(str(root / "jax"), per_fold=2)
    return ours, ref


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = p
    return out


def test_synthetic_dataset_byte_identical(datasets):
    ours, ref = _files(datasets[0]), _files(datasets[1])
    assert sorted(ours) == sorted(ref)
    assert len(ours) == 21                      # 20 WAVs + the metadata CSV
    for rel in ours:
        with open(ours[rel], "rb") as a, open(ref[rel], "rb") as b:
            assert a.read() == b.read(), rel
    assert synth.SYNTH_CLASSES == jax_synth.SYNTH_CLASSES


@pytest.mark.parametrize("name", list(MELS))
def test_preprocess_and_load_split_match(name, datasets, tmp_path):
    mel, jmel = MelConfig(**MELS[name]), JaxMelConfig(**MELS[name])
    us = UrbanSoundConfig(dataset_root=datasets[0])
    jus = JaxUrbanSoundConfig(dataset_root=datasets[1])
    before = direct_mel.fused_logmel_packed_plain.launches
    ours = preprocess_to_parquet(us, mel, str(tmp_path / "port.parquet"),
                                 batch_size=8,
                                 frontend=LogMelFrontend(mel, device="cpu"))
    launched = direct_mel.fused_logmel_packed_plain.launches - before
    assert launched == (3 if name == "fft512_hop160" else 0)  # 8 + 8 + 4
    ref = jax_preprocess(jus, jmel, str(tmp_path / "jax.parquet"),
                         batch_size=8, frontend=JaxFrontend(jmel,
                                                            backend="xla"))
    import pyarrow.parquet as pq
    a, b = pq.read_table(ours), pq.read_table(ref)
    assert a.schema == b.schema and a.num_rows == b.num_rows == 20
    for col in ("slice_file_name", "fold", "class_id", "class_name",
                "mel_shape", "processing_success"):
        assert a.column(col).to_pylist() == b.column(col).to_pylist(), col
    shape = a.column("mel_shape").to_pylist()[0]
    assert shape == [mel.n_mels, mel.frames_for(64000)]
    for folds in ((1, 2, 3, 4, 5, 6, 7, 8), (9,), (10,)):
        got, want = load_split(ours, folds), jax_load_split(ref, folds)
        np.testing.assert_array_equal(got["y"], want["y"])
        assert list(got["file"]) == list(want["file"])
        assert got["x"].shape == want["x"].shape == (
            2 * len(folds), mel.frames_for(64000), mel.n_mels)
        np.testing.assert_allclose(got["x"], want["x"], atol=TOL, rtol=0)
        # the same file read by both loaders: identical arrays
        same = jax_load_split(ours, folds)
        np.testing.assert_array_equal(got["x"], same["x"])
        np.testing.assert_array_equal(got["y"], same["y"])
    assert parquet_name(mel, "train") == jax_parquet_name(jmel, "train")


def test_corrupt_wav_gives_failed_row(datasets, tmp_path):
    import shutil

    import pyarrow.parquet as pq

    root = tmp_path / "copy"
    shutil.copytree(datasets[0], root)
    bad = root / "audio" / "fold3" / sorted(os.listdir(root / "audio"
                                                       / "fold3"))[1]
    bad.write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunk")
    mel = MelConfig()
    us = UrbanSoundConfig(dataset_root=str(root))
    out = preprocess_to_parquet(us, mel, str(tmp_path / "bad.parquet"),
                                batch_size=8,
                                frontend=LogMelFrontend(mel, device="cpu"))
    table = pq.read_table(out)
    ref = pq.read_table(jax_preprocess(
        JaxUrbanSoundConfig(dataset_root=str(root)), JaxMelConfig(),
        str(tmp_path / "bad_jax.parquet"), batch_size=8,
        frontend=JaxFrontend(JaxMelConfig(), backend="xla")))
    for col in ("slice_file_name", "mel_shape", "processing_success"):
        assert table.column(col).to_pylist() == ref.column(col).to_pylist()
    ok = table.column("processing_success").to_pylist()
    names = table.column("slice_file_name").to_pylist()
    assert table.num_rows == 20 and ok.count(False) == 1
    failed = names[ok.index(False)]
    assert failed == bad.name
    assert table.column("log_mel").to_pylist()[ok.index(False)] == []
    split = load_split(out, (3,))
    assert list(split["file"]) == [n for n in names
                                   if n.startswith("f3_") and n != failed]
    # featurize_clips yields the failed row on its own, before its batch
    events = list(featurize_clips(us, mel, batch_size=8,
                                  frontend=LogMelFrontend(mel, device="cpu")))
    assert [len(rows) for rows, _ in events] == [1, 8, 8, 3]
    assert events[0][1] is None and events[0][0][0]["slice_file_name"] == failed
    assert tuple(events[1][1].shape) == (8, 128, 501)
