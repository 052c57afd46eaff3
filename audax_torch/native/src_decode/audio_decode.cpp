// Own copy of audax/native/src_decode/audio_decode.cpp (the audax_torch
// port's compressed-audio codec, built by audax_torch/native/build.py
// against the system libavformat/libavcodec/libavutil).
//
// In-process compressed-audio decode/encode for the host data layer.
//
// The reference shelled out to the ffmpeg *binary* per file to convert m4a
// voice memos (reference: AB/memoToWav.py:11-26, 16 kHz mono pcm_s16le) and
// to segment eval audio (music2midi/README.md:103-113). Here the same codec
// capability is an in-process C++ module linking the system libavformat/
// libavcodec — no subprocess per file, one malloc'd float buffer out.
//
// decode: any container/codec the system lavc knows (m4a/AAC, mp3, ogg,
//         flac, ...) -> interleaved float32 + sample rate + channels.
// encode: float32 mono/stereo -> AAC-in-M4A (or whatever the extension's
//         container prefers) — used by tests to build fixtures and by the
//         dataset tooling to emit compressed artifacts.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
}

#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Append one decoded AVFrame as interleaved float32 with `channels`
// output channels. Returns 0, or <0 on an unsupported sample format —
// silence here would feed models all-zero audio with rc=0. The frame's
// OWN channel count bounds reads (a mid-stream layout change must not
// dereference a missing plane); missing channels duplicate channel 0.
int append_frame(const AVFrame* fr, int channels, std::vector<float>& out) {
    const int n = fr->nb_samples;
    const AVSampleFormat fmt = static_cast<AVSampleFormat>(fr->format);
    const bool planar = av_sample_fmt_is_planar(fmt);
    const AVSampleFormat base = av_get_packed_sample_fmt(fmt);
    const int fr_ch = fr->ch_layout.nb_channels > 0
                      ? fr->ch_layout.nb_channels : channels;
    switch (base) {
        case AV_SAMPLE_FMT_FLT: case AV_SAMPLE_FMT_DBL:
        case AV_SAMPLE_FMT_S16: case AV_SAMPLE_FMT_S32:
        case AV_SAMPLE_FMT_U8:
            break;
        default:
            return -10;  // unsupported sample format: loud, not silent
    }
    const size_t start = out.size();
    out.resize(start + static_cast<size_t>(n) * channels);
    float* dst = out.data() + start;

    auto sample = [&](int ch, int i) -> float {
        if (ch >= fr_ch) ch = 0;      // layout shrank mid-stream
        // extended_data covers >8-channel planar audio; aliases data[] below
        const uint8_t* plane = planar ? fr->extended_data[ch]
                                      : fr->extended_data[0];
        const int idx = planar ? i : i * fr_ch + ch;
        switch (base) {
            case AV_SAMPLE_FMT_FLT:
                return reinterpret_cast<const float*>(plane)[idx];
            case AV_SAMPLE_FMT_DBL:
                return static_cast<float>(
                    reinterpret_cast<const double*>(plane)[idx]);
            case AV_SAMPLE_FMT_S16:
                return reinterpret_cast<const int16_t*>(plane)[idx] / 32768.0f;
            case AV_SAMPLE_FMT_S32:
                return reinterpret_cast<const int32_t*>(plane)[idx]
                       / 2147483648.0f;
            default:  // AV_SAMPLE_FMT_U8 (format screened above)
                return (plane[idx] - 128) / 128.0f;
        }
    };
    for (int i = 0; i < n; ++i)
        for (int ch = 0; ch < channels; ++ch)
            *dst++ = sample(ch, i);
    return 0;
}

}  // namespace

extern "C" {

void audax_audio_free(float* p) { std::free(p); }

// Decode `path` fully. Returns 0 on success; fills *out (malloc'd,
// interleaved [n_frames * channels]), *n_frames, *channels, *sample_rate.
int audax_decode_audio(const char* path, float** out, long* n_frames,
                       int* channels, int* sample_rate) {
    *out = nullptr;
    *n_frames = 0;
    AVFormatContext* ic = nullptr;
    if (avformat_open_input(&ic, path, nullptr, nullptr) < 0) return -1;
    int rc = -2;
    AVCodecContext* cc = nullptr;
    AVPacket* pkt = nullptr;
    AVFrame* fr = nullptr;
    std::vector<float> pcm;
    int stream_idx = -1;
    int ch = 0;

    do {
        if (avformat_find_stream_info(ic, nullptr) < 0) break;
        const AVCodec* dec = nullptr;
        stream_idx = av_find_best_stream(ic, AVMEDIA_TYPE_AUDIO, -1, -1,
                                         &dec, 0);
        if (stream_idx < 0 || !dec) { rc = -3; break; }
        cc = avcodec_alloc_context3(dec);
        if (!cc) break;
        if (avcodec_parameters_to_context(
                cc, ic->streams[stream_idx]->codecpar) < 0) break;
        if (avcodec_open2(cc, dec, nullptr) < 0) { rc = -4; break; }
        ch = cc->ch_layout.nb_channels;
        if (ch <= 0) { rc = -5; break; }
        pkt = av_packet_alloc();
        fr = av_frame_alloc();
        if (!pkt || !fr) break;

        int frame_rc = 0;
        auto drain = [&]() {
            while (avcodec_receive_frame(cc, fr) == 0) {
                int r = append_frame(fr, ch, pcm);
                if (r < 0) frame_rc = r;
                av_frame_unref(fr);
            }
        };
        while (av_read_frame(ic, pkt) >= 0) {
            if (pkt->stream_index == stream_idx &&
                avcodec_send_packet(cc, pkt) == 0)
                drain();
            av_packet_unref(pkt);
            if (frame_rc < 0) break;
        }
        avcodec_send_packet(cc, nullptr);  // flush
        drain();
        if (frame_rc < 0) { rc = frame_rc; break; }

        *sample_rate = cc->sample_rate;
        *channels = ch;
        *n_frames = static_cast<long>(pcm.size()) / ch;
        *out = static_cast<float*>(std::malloc(pcm.size() * sizeof(float)));
        if (*out) {
            std::memcpy(*out, pcm.data(), pcm.size() * sizeof(float));
            rc = 0;
        }
    } while (false);

    if (fr) av_frame_free(&fr);
    if (pkt) av_packet_free(&pkt);
    if (cc) avcodec_free_context(&cc);
    avformat_close_input(&ic);
    return rc;
}

// Encode interleaved float32 -> `path` (container by extension; AAC for
// .m4a/.mp4). Returns 0 on success.
int audax_encode_audio(const char* path, const float* samples, long n_frames,
                       int channels, int sample_rate) {
    AVFormatContext* oc = nullptr;
    if (avformat_alloc_output_context2(&oc, nullptr, nullptr, path) < 0
        || !oc)
        return -1;
    int rc = -2;
    AVCodecContext* cc = nullptr;
    AVPacket* pkt = nullptr;
    AVFrame* fr = nullptr;

    do {
        enum AVCodecID cid = oc->oformat->audio_codec;
        const AVCodec* enc = avcodec_find_encoder(cid);
        if (!enc) { rc = -3; break; }
        AVStream* st = avformat_new_stream(oc, nullptr);
        if (!st) break;
        cc = avcodec_alloc_context3(enc);
        if (!cc) break;
        cc->sample_rate = sample_rate;
        av_channel_layout_default(&cc->ch_layout, channels);
        cc->sample_fmt = enc->sample_fmts ? enc->sample_fmts[0]
                                          : AV_SAMPLE_FMT_FLTP;
        cc->bit_rate = 96000;
        cc->time_base = AVRational{1, sample_rate};
        if (oc->oformat->flags & AVFMT_GLOBALHEADER)
            cc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
        if (avcodec_open2(cc, enc, nullptr) < 0) { rc = -4; break; }
        if (avcodec_parameters_from_context(st->codecpar, cc) < 0) break;
        st->time_base = cc->time_base;
        if (!(oc->oformat->flags & AVFMT_NOFILE) &&
            avio_open(&oc->pb, path, AVIO_FLAG_WRITE) < 0) { rc = -5; break; }
        if (avformat_write_header(oc, nullptr) < 0) break;

        pkt = av_packet_alloc();
        fr = av_frame_alloc();
        if (!pkt || !fr) break;
        const int step = cc->frame_size > 0 ? cc->frame_size : 1024;
        const bool planar = av_sample_fmt_is_planar(cc->sample_fmt);
        const AVSampleFormat enc_base =
            av_get_packed_sample_fmt(cc->sample_fmt);
        long pos = 0;
        int64_t pts = 0;
        bool failed = false;

        // write one float sample in the ENCODER'S sample format (writing raw
        // float32 into an S16 buffer would overflow it 2x; into S32P it
        // would be bit-garbage)
        auto put_sample = [&](uint8_t* plane, int idx, float s) -> bool {
            if (s > 1.0f) s = 1.0f;
            if (s < -1.0f) s = -1.0f;
            switch (enc_base) {
                case AV_SAMPLE_FMT_FLT:
                    reinterpret_cast<float*>(plane)[idx] = s;
                    return true;
                case AV_SAMPLE_FMT_DBL:
                    reinterpret_cast<double*>(plane)[idx] = s;
                    return true;
                case AV_SAMPLE_FMT_S16:
                    reinterpret_cast<int16_t*>(plane)[idx] =
                        static_cast<int16_t>(lrintf(s * 32767.0f));
                    return true;
                case AV_SAMPLE_FMT_S32:
                    reinterpret_cast<int32_t*>(plane)[idx] =
                        static_cast<int32_t>(lrint(s * 2147483647.0));
                    return true;
                case AV_SAMPLE_FMT_U8:
                    plane[idx] = static_cast<uint8_t>(lrintf(s * 127.0f) + 128);
                    return true;
                default:
                    return false;   // unsupported encoder format
            }
        };

        auto pump = [&](AVFrame* frame) -> bool {
            if (avcodec_send_frame(cc, frame) < 0) return false;
            while (avcodec_receive_packet(cc, pkt) == 0) {
                av_packet_rescale_ts(pkt, cc->time_base, st->time_base);
                pkt->stream_index = st->index;
                if (av_interleaved_write_frame(oc, pkt) < 0) return false;
            }
            return true;
        };
        while (pos < n_frames && !failed) {
            const int n = static_cast<int>(
                n_frames - pos < step ? n_frames - pos : step);
            fr->nb_samples = n;
            fr->format = cc->sample_fmt;
            av_channel_layout_copy(&fr->ch_layout, &cc->ch_layout);
            if (av_frame_get_buffer(fr, 0) < 0) { failed = true; break; }
            for (int c = 0; c < channels && !failed; ++c) {
                uint8_t* plane = planar ? fr->extended_data[c]
                                        : fr->extended_data[0];
                for (int i = 0; i < n; ++i) {
                    const float s = samples[(pos + i) * channels + c];
                    if (!put_sample(plane, planar ? i : i * channels + c, s)) {
                        failed = true;
                        break;
                    }
                }
            }
            if (failed) break;
            fr->pts = pts;
            pts += n;
            failed = !pump(fr);
            av_frame_unref(fr);
            pos += n;
        }
        if (failed) break;
        if (!pump(nullptr)) break;  // flush
        if (av_write_trailer(oc) < 0) break;
        rc = 0;
    } while (false);

    if (fr) av_frame_free(&fr);
    if (pkt) av_packet_free(&pkt);
    if (cc) avcodec_free_context(&cc);
    if (oc && !(oc->oformat->flags & AVFMT_NOFILE) && oc->pb)
        avio_closep(&oc->pb);
    if (oc) avformat_free_context(oc);
    return rc;
}

}  // extern "C"
