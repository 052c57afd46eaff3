// Own copy of audax/native/src/sf2synth.cpp (the audax_torch port's SF2
// synth, built by audax_torch/native/build.py). The additive voice
// synth_render_simple is not copied: the port renders it in numpy
// (audax_torch/data/synth.py:render_simple).
//
// SF2 soundfont synthesizer — the framework's fluidsynth replacement.
//
// The reference renders MIDI through the FluidSynth C library (subprocess at
// .charles/music2midi/preprocess_data.py:130-138, pretty_midi binding at
// AB/synthDataset.py:35, midi2audio at .charles/midi2spectrogram.py:1-3).
// This module owns that capability natively: parse the SF2 (RIFF: sdta
// sample data + pdta preset/instrument/zone generators), then render note
// lists by pitched sample playback with loop handling and an exponential
// ADSR volume envelope — mixed straight into a float buffer the Python side
// hands to the feature pipeline.
//
// C ABI (ctypes-friendly): sf2_open / sf2_close / sf2_preset_count /
// sf2_render.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------- RIFF ----
struct Chunk {
  char id[5] = {0};
  const uint8_t* data = nullptr;
  uint32_t size = 0;
};

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  bool read_chunk(Chunk* c) {
    if (pos + 8 > n) return false;
    std::memcpy(c->id, p + pos, 4);
    c->id[4] = 0;
    std::memcpy(&c->size, p + pos + 4, 4);
    c->data = p + pos + 8;
    pos += 8 + c->size + (c->size & 1);
    return pos <= n + 1;
  }
};

// ------------------------------------------------------------- SF2 data ---
// generator ids we honor
enum Gen : uint16_t {
  kStartAddrOfs = 0, kEndAddrOfs = 1, kStartLoopOfs = 2, kEndLoopOfs = 3,
  kInitialAttenuation = 48, kCoarseTune = 51, kFineTune = 52,
  kAttackVolEnv = 34, kHoldVolEnv = 35, kDecayVolEnv = 36,
  kSustainVolEnv = 37, kReleaseVolEnv = 38,
  kInstrument = 41, kKeyRange = 43, kVelRange = 44,
  kSampleID = 53, kSampleModes = 54, kOverridingRootKey = 58,
};

struct SampleHeader {
  uint32_t start, end, loop_start, loop_end, rate;
  uint8_t orig_pitch;
  int8_t correction;
  uint16_t type, link;
};

struct Zone {               // resolved instrument zone
  int key_lo = 0, key_hi = 127, vel_lo = 0, vel_hi = 127;
  int sample_id = -1;
  int root_key = -1;        // -1 -> use sample header
  int sample_modes = 0;     // 1/3 -> loop
  double fine_tune = 0.0;   // semitones
  double attenuation_db = 0.0;
  // volume envelope (seconds / level)
  double attack = 0.001, hold = 0.0, decay = 0.001, release = 0.05;
  double sustain_level = 1.0;
  int32_t start_ofs = 0, end_ofs = 0, loop_start_ofs = 0, loop_end_ofs = 0;
};

struct Preset {
  int bank = 0, program = 0;
  std::vector<Zone> zones;
};

struct GenRec { uint16_t oper; int16_t amount; };

double timecents_to_sec(int16_t tc) { return std::pow(2.0, tc / 1200.0); }

struct SoundFont {
  std::vector<int16_t> samples;
  std::vector<SampleHeader> shdr;
  std::vector<Preset> presets;
};

template <typename T>
std::vector<T> read_records(const Chunk& c) {
  std::vector<T> out(c.size / sizeof(T));
  std::memcpy(out.data(), c.data, out.size() * sizeof(T));
  return out;
}

#pragma pack(push, 1)
struct RawPhdr { char name[20]; uint16_t preset, bank; uint16_t bag_idx;
                 uint32_t library, genre, morphology; };
struct RawBag { uint16_t gen_idx, mod_idx; };
struct RawGen { uint16_t oper; int16_t amount; };
struct RawInst { char name[20]; uint16_t bag_idx; };
struct RawShdr { char name[20]; uint32_t start, end, loop_start, loop_end,
                 rate; uint8_t pitch; int8_t corr; uint16_t link, type; };
#pragma pack(pop)

void apply_gen(Zone* z, uint16_t oper, int16_t amt) {
  switch (oper) {
    case kKeyRange: z->key_lo = amt & 0xFF; z->key_hi = (amt >> 8) & 0xFF; break;
    case kVelRange: z->vel_lo = amt & 0xFF; z->vel_hi = (amt >> 8) & 0xFF; break;
    case kSampleID: z->sample_id = amt; break;
    case kOverridingRootKey: if (amt >= 0) z->root_key = amt; break;
    case kSampleModes: z->sample_modes = amt; break;
    case kCoarseTune: z->fine_tune += amt; break;
    case kFineTune: z->fine_tune += amt / 100.0; break;
    case kInitialAttenuation: z->attenuation_db += amt / 10.0; break;
    case kAttackVolEnv: z->attack = timecents_to_sec(amt); break;
    case kHoldVolEnv: z->hold = timecents_to_sec(amt); break;
    case kDecayVolEnv: z->decay = timecents_to_sec(amt); break;
    case kSustainVolEnv:
      z->sustain_level = std::pow(10.0, -std::min<int>(std::max<int>(amt, 0), 1440) / 200.0);
      break;
    case kReleaseVolEnv: z->release = timecents_to_sec(amt); break;
    case kStartAddrOfs: z->start_ofs += amt; break;
    case kEndAddrOfs: z->end_ofs += amt; break;
    case kStartLoopOfs: z->loop_start_ofs += amt; break;
    case kEndLoopOfs: z->loop_end_ofs += amt; break;
    default: break;
  }
}

SoundFont* parse_sf2(const uint8_t* data, size_t n) {
  if (n < 12 || std::memcmp(data, "RIFF", 4) || std::memcmp(data + 8, "sfbk", 4))
    return nullptr;
  Reader top{data + 12, n - 12};
  Chunk list;
  std::vector<RawPhdr> phdr;
  std::vector<RawBag> pbag, ibag;
  std::vector<RawGen> pgen, igen;
  std::vector<RawInst> inst;
  std::vector<RawShdr> rshdr;
  auto sf = new SoundFont();

  while (top.read_chunk(&list)) {
    if (std::memcmp(list.id, "LIST", 4) != 0 || list.size < 4) continue;
    const char* kind = reinterpret_cast<const char*>(list.data);
    Reader sub{list.data + 4, list.size - 4};
    Chunk c;
    while (sub.read_chunk(&c)) {
      if (!std::memcmp(kind, "sdta", 4) && !std::memcmp(c.id, "smpl", 4)) {
        sf->samples.resize(c.size / 2);
        std::memcpy(sf->samples.data(), c.data, sf->samples.size() * 2);
      } else if (!std::memcmp(kind, "pdta", 4)) {
        if (!std::memcmp(c.id, "phdr", 4)) phdr = read_records<RawPhdr>(c);
        else if (!std::memcmp(c.id, "pbag", 4)) pbag = read_records<RawBag>(c);
        else if (!std::memcmp(c.id, "pgen", 4)) pgen = read_records<RawGen>(c);
        else if (!std::memcmp(c.id, "inst", 4)) inst = read_records<RawInst>(c);
        else if (!std::memcmp(c.id, "ibag", 4)) ibag = read_records<RawBag>(c);
        else if (!std::memcmp(c.id, "igen", 4)) igen = read_records<RawGen>(c);
        else if (!std::memcmp(c.id, "shdr", 4)) rshdr = read_records<RawShdr>(c);
      }
    }
  }
  for (const auto& s : rshdr) {
    if (!std::memcmp(s.name, "EOS", 3) && s.start == 0 && s.end == 0) continue;
    sf->shdr.push_back({s.start, s.end, s.loop_start, s.loop_end, s.rate,
                        s.pitch, s.corr, s.type, s.link});
  }

  // resolve instrument zones (global zone + local zones)
  auto inst_zones = [&](int inst_idx) {
    std::vector<Zone> zones;
    if (inst_idx < 0 || inst_idx + 1 >= static_cast<int>(inst.size()))
      return zones;
    Zone global;
    bool have_global = false;
    for (int b = inst[inst_idx].bag_idx; b < inst[inst_idx + 1].bag_idx; ++b) {
      if (b + 1 >= static_cast<int>(ibag.size())) break;
      Zone z = have_global ? global : Zone();
      bool has_sample = false;
      // clamp the generator range to the actual igen chunk: malformed
      // gen_idx values must not read past the vector
      int g_end = std::min<int>(ibag[b + 1].gen_idx,
                                static_cast<int>(igen.size()));
      for (int g = ibag[b].gen_idx; g < g_end; ++g) {
        apply_gen(&z, igen[g].oper, igen[g].amount);
        if (igen[g].oper == kSampleID) has_sample = true;
      }
      if (has_sample) {
        zones.push_back(z);
      } else if (!have_global && zones.empty()) {
        global = z;
        have_global = true;
      }
    }
    return zones;
  };

  for (size_t pi = 0; pi + 1 < phdr.size(); ++pi) {
    Preset preset;
    preset.bank = phdr[pi].bank;
    preset.program = phdr[pi].preset;
    for (int b = phdr[pi].bag_idx; b < phdr[pi + 1].bag_idx; ++b) {
      if (b + 1 >= static_cast<int>(pbag.size())) break;
      int inst_idx = -1;
      int key_lo = 0, key_hi = 127, vel_lo = 0, vel_hi = 127;
      int pg_end = std::min<int>(pbag[b + 1].gen_idx,
                                 static_cast<int>(pgen.size()));
      for (int g = pbag[b].gen_idx; g < pg_end; ++g) {
        if (pgen[g].oper == kInstrument) inst_idx = pgen[g].amount;
        else if (pgen[g].oper == kKeyRange) {
          key_lo = pgen[g].amount & 0xFF; key_hi = (pgen[g].amount >> 8) & 0xFF;
        } else if (pgen[g].oper == kVelRange) {
          vel_lo = pgen[g].amount & 0xFF; vel_hi = (pgen[g].amount >> 8) & 0xFF;
        }
      }
      for (Zone z : inst_zones(inst_idx)) {
        // preset-level ranges intersect instrument-level ranges
        z.key_lo = std::max(z.key_lo, key_lo);
        z.key_hi = std::min(z.key_hi, key_hi);
        z.vel_lo = std::max(z.vel_lo, vel_lo);
        z.vel_hi = std::min(z.vel_hi, vel_hi);
        if (z.key_lo <= z.key_hi && z.sample_id >= 0 &&
            z.sample_id < static_cast<int>(sf->shdr.size()))
          preset.zones.push_back(z);
      }
    }
    if (!preset.zones.empty()) sf->presets.push_back(std::move(preset));
  }
  return sf;
}

// ------------------------------------------------------------- renderer ---
struct NoteEvent {           // mirrors the Python ctypes struct
  double start;              // seconds
  double duration;           // seconds
  int32_t pitch;
  int32_t velocity;
  int32_t program;           // GM program (preset select); -1 = first preset
};

const Zone* find_zone(const SoundFont& sf, int program, int pitch, int vel) {
  const Preset* chosen = nullptr;
  for (const auto& p : sf.presets)
    if (p.bank == 0 && p.program == program) { chosen = &p; break; }
  if (!chosen && !sf.presets.empty()) chosen = &sf.presets[0];
  if (!chosen) return nullptr;
  const Zone* fallback = nullptr;
  for (const auto& z : chosen->zones) {
    if (pitch >= z.key_lo && pitch <= z.key_hi) {
      if (vel >= z.vel_lo && vel <= z.vel_hi) return &z;
      if (!fallback) fallback = &z;
    }
  }
  return fallback;
}

void render_note(const SoundFont& sf, const Zone& z, const NoteEvent& ev,
                 double out_rate, float* out, int64_t out_len) {
  const SampleHeader& sh = sf.shdr[z.sample_id];
  // signed generator offsets on unsigned addresses: clamp every derived
  // index into [0, samples.size()] — a negative start would read before
  // the sample buffer (the ip >= s_end guard never catches ip < 0)
  const int64_t n_samp = static_cast<int64_t>(sf.samples.size());
  auto clamp_idx = [n_samp](int64_t v) {
    return std::max<int64_t>(0, std::min(v, n_samp));
  };
  int64_t s_start = clamp_idx(static_cast<int64_t>(sh.start) + z.start_ofs);
  int64_t s_end = clamp_idx(static_cast<int64_t>(sh.end) + z.end_ofs);
  int64_t l_start = clamp_idx(static_cast<int64_t>(sh.loop_start)
                              + z.loop_start_ofs);
  int64_t l_end = clamp_idx(static_cast<int64_t>(sh.loop_end)
                            + z.loop_end_ofs);
  if (s_end <= s_start) return;
  bool looped = (z.sample_modes == 1 || z.sample_modes == 3) &&
                l_end > l_start && l_end <= s_end;

  int root = z.root_key >= 0 ? z.root_key : sh.orig_pitch;
  double semis = (ev.pitch - root) + z.fine_tune + sh.correction / 100.0;
  double step = std::pow(2.0, semis / 12.0) * sh.rate / out_rate;

  double amp = (ev.velocity / 127.0);
  amp = amp * amp;                                  // perceptual curve
  amp *= std::pow(10.0, -z.attenuation_db / 20.0);

  int64_t first = static_cast<int64_t>(ev.start * out_rate);
  int64_t note_frames = static_cast<int64_t>(ev.duration * out_rate);
  int64_t total = note_frames + static_cast<int64_t>(z.release * out_rate) + 1;

  double pos = static_cast<double>(s_start);
  const double a_fr = std::max(z.attack * out_rate, 1.0);
  const double h_fr = z.hold * out_rate;
  const double d_fr = std::max(z.decay * out_rate, 1.0);
  const double r_fr = std::max(z.release * out_rate, 1.0);
  // per-frame exponential decay factors
  const double decay_mul = std::pow(std::max(z.sustain_level, 1e-5),
                                    1.0 / d_fr);
  const double rel_mul = std::pow(1e-4, 1.0 / r_fr);

  double env = 0.0;
  double decay_env = 1.0;
  double rel_env = 1.0;
  for (int64_t i = 0; i < total; ++i) {
    int64_t oi = first + i;
    if (oi >= out_len) break;
    if (oi < 0) continue;
    // envelope
    double e;
    if (i < a_fr) {
      e = (i + 1) / a_fr;
    } else if (i < a_fr + h_fr) {
      e = 1.0;
    } else {
      if (decay_env > z.sustain_level) decay_env *= decay_mul;
      if (decay_env < z.sustain_level) decay_env = z.sustain_level;
      e = decay_env;
    }
    if (i >= note_frames) {
      rel_env *= rel_mul;
      e *= rel_env;
      if (e < 1e-5) break;
    }
    // sample fetch (linear interpolation)
    if (!looped && pos >= static_cast<double>(s_end - 1)) break;
    int64_t ip = static_cast<int64_t>(pos);
    double frac = pos - ip;
    int64_t ip1 = ip + 1;
    if (looped && ip1 >= l_end) ip1 = l_start;
    if (ip >= s_end) break;
    double v = sf.samples[ip] * (1.0 - frac) + sf.samples[ip1] * frac;
    out[oi] += static_cast<float>(v / 32768.0 * amp * e);
    pos += step;
    if (looped && pos >= static_cast<double>(l_end))
      pos -= static_cast<double>(l_end - l_start);
  }
}

}  // namespace

// ------------------------------------------------------------------ ABI ---
extern "C" {

void* sf2_open(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(n);
  size_t got = std::fread(buf.data(), 1, n, f);
  std::fclose(f);
  if (static_cast<long>(got) != n) return nullptr;
  return parse_sf2(buf.data(), buf.size());
}

void sf2_close(void* handle) { delete static_cast<SoundFont*>(handle); }

int sf2_preset_count(void* handle) {
  return handle ? static_cast<int>(static_cast<SoundFont*>(handle)->presets.size()) : 0;
}

int sf2_preset_info(void* handle, int idx, int* bank, int* program,
                    int* n_zones) {
  auto* sf = static_cast<SoundFont*>(handle);
  if (!sf || idx < 0 || idx >= static_cast<int>(sf->presets.size())) return -1;
  *bank = sf->presets[idx].bank;
  *program = sf->presets[idx].program;
  *n_zones = static_cast<int>(sf->presets[idx].zones.size());
  return 0;
}

// notes: array of NoteEvent; out: caller-allocated float buffer (zeroed)
int sf2_render(void* handle, const NoteEvent* notes, int n_notes,
               double sample_rate, float* out, int64_t out_len) {
  auto* sf = static_cast<SoundFont*>(handle);
  if (!sf || sf->samples.empty()) return -1;
  int rendered = 0;
  for (int i = 0; i < n_notes; ++i) {
    const Zone* z = find_zone(*sf, notes[i].program, notes[i].pitch,
                              notes[i].velocity);
    if (!z) continue;
    render_note(*sf, *z, notes[i], sample_rate, out, out_len);
    ++rendered;
  }
  return rendered;
}

}  // extern "C"
