"""The port's host C++ (``audax_torch/native``) against the JAX package's.

The decoder: m4a, mp3, ogg and flac files written by JAX's
``encode_audio_file`` decode through the port's ``decode_audio_file`` (and
``read_audio``) to JAX's samples and rate bit for bit, and ``memo_to_wav``
writes JAX's bytes. The SF2 synth: a minimal soundfont written here (the
repo holds none) renders within 1e-6 of JAX's ``Sf2Synth``, directly and
through ``render_midi(soundfont=)``, ``make_midi_dataset`` and
``stage_midi2wav``. A build without ``g++``, or one that does not
compile, raises; there is no quiet route.
"""

import filecmp
import struct

import numpy as np
import pytest

from audax.data import audio_io as JIO
from audax.data import music_dataset as JMD
from audax.data import synth as JSynth
from audax.native import bindings as JB
from audax.symbolic.midi import MidiFile as JMidi
from audax_torch.core.config import DataGenConfig
from audax_torch.data import audio_io as PIO
from audax_torch.data import music_dataset as PMD
from audax_torch.data import synth as PSynth
from audax_torch.native import bindings as PB
from audax_torch.native import build as PBuild
from audax_torch.symbolic.midi import MidiFile as PMidi

SF2_TOL = 1e-6
FORMATS = ("m4a", "mp3", "ogg", "flac")


def write_minimal_sf2(path: str, sample_rate: int = 16000) -> str:
    """One preset (bank 0, program 0) of one instrument zone over every
    key: a looped 440 Hz sine of 0.25 s, root key 69, with a short attack,
    a decay to -6 dB and a 0.2 s release (the generators the synth
    honours)."""
    n = sample_rate // 4
    smp = np.round(12000 * np.sin(2 * np.pi * 440 * np.arange(n)
                                  / sample_rate)).astype("<i2")
    smpl = smp.tobytes() + bytes(92)          # 46 zero samples after it

    def chunk(cid: bytes, body: bytes) -> bytes:
        return cid + struct.pack("<I", len(body)) + body + b"\0" * (len(body)
                                                                    & 1)

    def name(s: str) -> bytes:
        return s.encode().ljust(20, b"\0")

    def gens(pairs) -> bytes:
        return b"".join(struct.pack("<Hh", op, amt) for op, amt in pairs)

    phdr = (name("Sine") + struct.pack("<HHHIII", 0, 0, 0, 0, 0, 0)
            + name("EOP") + struct.pack("<HHHIII", 0, 0, 1, 0, 0, 0))
    pbag = struct.pack("<HHHH", 0, 0, 1, 0)
    pgen = gens([(41, 0), (0, 0)])            # instrument 0, terminal
    inst = name("SineInst") + struct.pack("<H", 0) + name("EOI") + \
        struct.pack("<H", 1)
    ibag = struct.pack("<HHHH", 0, 0, 7, 0)
    igen = gens([(43, 127 << 8), (34, -7200), (36, -1200), (37, 60),
                 (38, -2400), (54, 1), (53, 0), (0, 0)])
    shdr = (name("sine") + struct.pack("<IIIIIBbHH", 0, n, 400, n - 400,
                                       sample_rate, 69, 0, 0, 1)
            + name("EOS") + struct.pack("<IIIIIBbHH", 0, 0, 0, 0, 0, 0, 0,
                                        0, 0))
    pdta = b"pdta" + b"".join(chunk(c, b) for c, b in (
        (b"phdr", phdr), (b"pbag", pbag), (b"pmod", bytes(10)),
        (b"pgen", pgen), (b"inst", inst), (b"ibag", ibag),
        (b"imod", bytes(10)), (b"igen", igen), (b"shdr", shdr)))
    sdta = b"sdta" + chunk(b"smpl", smpl)
    info = b"INFO" + chunk(b"ifil", struct.pack("<HH", 2, 1))
    body = b"sfbk" + chunk(b"LIST", info) + chunk(b"LIST", sdta) + \
        chunk(b"LIST", pdta)
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


def _signal(channels: int, rate: int, seconds: float = 1.5, seed: int = 0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    x = np.stack([0.3 * np.sin(2 * np.pi * (220 + 110 * c) * t)
                  + 0.03 * rng.standard_normal(t.size)
                  for c in range(channels)], axis=1)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """(fmt, channels, rate) -> a file written by JAX's encoder."""
    root = tmp_path_factory.mktemp("encoded")
    out = {}
    for fmt in FORMATS:
        for channels, rate in ((1, 16000), (2, 44100)):
            path = str(root / f"clip_{channels}ch_{rate}.{fmt}")
            JB.encode_audio_file(path, _signal(channels, rate), rate)
            out[(fmt, channels, rate)] = path
    return out


@pytest.mark.parametrize("layout", [(1, 16000), (2, 44100)],
                         ids=["mono16k", "stereo44k"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_matches_jax_bit_for_bit(encoded, fmt, layout):
    path = encoded[(fmt, *layout)]
    ours, rate = PB.decode_audio_file(path)
    ref, jrate = JB.decode_audio_file(path)
    assert rate == jrate == layout[1] and ours.dtype == np.float32
    assert ours.shape == ref.shape and ours.shape[1] == layout[0]
    np.testing.assert_array_equal(ours, ref)
    got, grate = PIO.read_audio(path)
    np.testing.assert_array_equal(got, ref)
    assert grate == jrate


@pytest.mark.parametrize("fmt", FORMATS)
def test_memo_to_wav_writes_jax_bytes(encoded, tmp_path, fmt):
    src = encoded[(fmt, 2, 44100)]
    ours = PIO.memo_to_wav(src, str(tmp_path / "ours"))
    theirs = JIO.memo_to_wav(src, str(tmp_path / "theirs"))
    assert ours.endswith(f"clip_2ch_44100.wav")
    assert filecmp.cmp(ours, theirs, shallow=False)


def test_port_encoder_writes_what_jax_decodes(tmp_path):
    x = _signal(1, 16000)
    path = str(tmp_path / "port.flac")
    PB.encode_audio_file(path, x, 16000)
    ref, rate = JB.decode_audio_file(path)
    ours, _ = PB.decode_audio_file(path)
    np.testing.assert_array_equal(ours, ref)
    assert rate == 16000 and abs(len(ref) - len(x)) <= 1
    np.testing.assert_allclose(ref[:len(x), 0], x[:len(ref), 0], atol=1e-4)


def test_undecodable_file_raises(tmp_path):
    path = tmp_path / "junk.mp3"
    path.write_bytes(b"ID3\x03\x00\x00\x00" + bytes(64))
    with pytest.raises(ValueError, match="decode failed"):
        PB.decode_audio_file(str(path))
    with pytest.raises(ValueError, match="decode failed"):
        PIO.read_audio(str(path))


@pytest.fixture(scope="module")
def soundfont(tmp_path_factory):
    return write_minimal_sf2(str(tmp_path_factory.mktemp("sf2") / "s.sf2"))


def _melody(seed: int):
    """The same melody in both packages' MidiFile types."""
    mf, _ = JSynth._random_melody(np.random.default_rng(seed), 8, 90,
                                  max_poly=2)
    return PMidi.from_bytes(mf.to_bytes()), mf


def test_sf2_render_matches_jax(soundfont):
    ours, theirs = PB.Sf2Synth(soundfont), JB.Sf2Synth(soundfont)
    assert ours.presets() == theirs.presets() == [
        {"bank": 0, "program": 0, "zones": 1}]
    for seed in range(3):
        pm, jm = _melody(seed)
        a = ours.render(pm, 16000)
        b = theirs.render(jm, 16000)
        assert a.dtype == np.float32 and a.shape == b.shape
        assert np.isfinite(a).all() and np.abs(a).max() > 0.05
        np.testing.assert_allclose(a, b, atol=SF2_TOL, rtol=0)
        np.testing.assert_array_equal(a, ours.render(pm, 16000))
    ours.close()
    ours.close()                               # idempotent


def test_render_midi_soundfont_matches_jax(soundfont):
    pm, jm = _melody(5)
    np.testing.assert_allclose(
        PSynth.render_midi(pm, 22050, soundfont=soundfont),
        JSynth.render_midi(jm, 22050, soundfont=soundfont),
        atol=SF2_TOL, rtol=0)


def test_make_midi_dataset_soundfont_matches_jax(soundfont, tmp_path):
    from audax.core.config import DataGenConfig as JCfg
    kw = dict(num_items=3, notes_per_item=5, soundfont=soundfont, seed=4)
    ours = PSynth.make_midi_dataset(DataGenConfig(
        out_dir=str(tmp_path / "p"), **kw))
    theirs = JSynth.make_midi_dataset(JCfg(out_dir=str(tmp_path / "j"), **kw))
    a = open(ours).read().replace(str(tmp_path / "p"), "")
    assert a == open(theirs).read().replace(str(tmp_path / "j"), "")
    for i in range(3):
        name = f"wavs/midi_{i:05d}.wav"
        x = PIO.read_wav(str(tmp_path / "p" / name))[0]
        y = JIO.read_wav(str(tmp_path / "j" / name))[0]
        assert np.abs(x).max() > 0.05
        np.testing.assert_allclose(x, y, atol=1.01 / 32767, rtol=0)


def test_stage_midi2wav_soundfont_matches_jax(soundfont, tmp_path):
    mid = tmp_path / "mid"
    mid.mkdir()
    for seed in range(2):
        _melody(seed)[1].save(str(mid / f"m{seed}.mid"))
    from audax.core.config import DataGenConfig as JCfg
    PMD.stage_midi2wav(str(mid), str(tmp_path / "p"),
                       DataGenConfig(soundfont=soundfont), workers=1)
    JMD.stage_midi2wav(str(mid), str(tmp_path / "j"),
                       JCfg(soundfont=soundfont), workers=1)
    for seed in range(2):
        x = PIO.read_wav(str(tmp_path / "p" / f"m{seed}.wav"))[0]
        y = JIO.read_wav(str(tmp_path / "j" / f"m{seed}.wav"))[0]
        np.testing.assert_allclose(x, y, atol=1.01 / 32767, rtol=0)


def test_unparsable_soundfont_raises(tmp_path):
    bad = tmp_path / "bad.sf2"
    bad.write_bytes(b"RIFF\x04\x00\x00\x00junk")
    with pytest.raises(ValueError, match="failed to parse soundfont"):
        PB.Sf2Synth(str(bad))


def test_build_without_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(PBuild, "BUILD", tmp_path)
    monkeypatch.setattr(PBuild.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        PBuild.build("sf2synth")


def test_failed_compile_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(PBuild, "BUILD", tmp_path / "build")
    monkeypatch.setattr(PBuild, "_HERE", tmp_path)
    monkeypatch.setitem(PBuild.LIBRARIES, "broken", ("src/broken.cpp", ()))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build broken"):
        PBuild.build("broken")
    assert not list((tmp_path / "build").glob("*.so"))


def test_builds_are_keyed_by_source(tmp_path, monkeypatch):
    """The library name carries a hash of the source and flags: an edited
    source is a new library, an unchanged one is reused."""
    (tmp_path / "src").mkdir()
    src = tmp_path / "src" / "k.cpp"
    src.write_text('extern "C" int k() { return 1; }\n')
    monkeypatch.setattr(PBuild, "BUILD", tmp_path / "build")
    monkeypatch.setattr(PBuild, "_HERE", tmp_path)
    monkeypatch.setitem(PBuild.LIBRARIES, "k", ("src/k.cpp", ()))
    first = PBuild.build("k")
    assert PBuild.build("k") == first and first.exists()
    src.write_text('extern "C" int k() { return 2; }\n')
    assert PBuild.lib_path("k") != first


def test_no_quiet_routes():
    """The JAX package's quiet availability probes are not ported."""
    for name in ("available", "decode_available", "render_simple"):
        assert not hasattr(PB, name)
