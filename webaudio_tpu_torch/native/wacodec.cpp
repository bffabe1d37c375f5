// wacodec.cpp — compressed-audio decode host for webaudio_tpu_torch (a copy
// of webaudio_tpu/native/wacodec.cpp).
//
// The reference implementation delegates compressed codecs (mp3, ogg/vorbis,
// aac/m4a, alac, webm/opus, ...) to the symphonia crate
// (/root/reference/src/decoding.rs:15-54), decoding any unseekable `Read`
// stream incrementally (`MediaInput` decoding.rs:60-92, `MediaDecoder`
// chunk iterator decoding.rs:97+), and streams from disk real-time-safely
// via the creek crate (/root/reference/src/media_element.rs:12-55).
//
// This is the native C++ equivalent: a decode host over the system FFmpeg
// libraries (libavformat demux + libavcodec decode + libswresample to f32)
// exposing a C ABI consumed via ctypes from media/decoding.py.  Two entry
// styles share one code path:
//
//   - wac_open/wac_stream_read/wac_stream_seek/wac_close: an incremental
//     pull-handle over caller-supplied read/seek callbacks (seek optional —
//     unseekable streams decode forward-only, like symphonia's MediaSource).
//     Memory is bounded by the swresample scratch + per-call chunk size,
//     independent of media length.
//   - wac_decode: whole-stream decode from memory (built on the handle).
//
// Output is planar f32 at the stream's native rate; sample-rate conversion
// to the context rate stays in the engine (the same split the reference
// makes: symphonia decodes, the engine resamples).
//
// Build: g++ -O2 -shared -fPIC wacodec.cpp -o libwacodec.so \
//            -lavformat -lavcodec -lavutil -lswresample

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

namespace {

typedef int (*wac_read_cb)(void* opaque, uint8_t* buf, int n);
typedef int64_t (*wac_seek_cb)(void* opaque, int64_t offset, int whence);

struct MemReader {
    const uint8_t* data;
    int64_t size;
    int64_t pos;
};

int mem_read(void* opaque, uint8_t* buf, int buf_size) {
    MemReader* r = static_cast<MemReader*>(opaque);
    int64_t remaining = r->size - r->pos;
    if (remaining <= 0) return AVERROR_EOF;
    int n = static_cast<int>(remaining < buf_size ? remaining : buf_size);
    memcpy(buf, r->data + r->pos, n);
    r->pos += n;
    return n;
}

int64_t mem_seek(void* opaque, int64_t offset, int whence) {
    MemReader* r = static_cast<MemReader*>(opaque);
    if (whence == AVSEEK_SIZE) return r->size;
    whence &= ~AVSEEK_FORCE;
    int64_t target;
    switch (whence) {
        case SEEK_SET: target = offset; break;
        case SEEK_CUR: target = r->pos + offset; break;
        case SEEK_END: target = r->size + offset; break;
        default: return -1;
    }
    if (target < 0 || target > r->size) return -1;
    r->pos = target;
    return target;
}

void set_err(char* errbuf, int errlen, const char* msg, int averr = 0) {
    if (!errbuf || errlen <= 0) return;
    if (averr != 0) {
        char avmsg[128];
        av_strerror(averr, avmsg, sizeof(avmsg));
        snprintf(errbuf, errlen, "%s: %s", msg, avmsg);
    } else {
        snprintf(errbuf, errlen, "%s", msg);
    }
}

struct StreamHandle {
    AVIOContext* avio = nullptr;
    AVFormatContext* fmt = nullptr;
    AVCodecContext* codec = nullptr;
    SwrContext* swr = nullptr;
    AVFrame* frame = nullptr;
    AVPacket* pkt = nullptr;
    uint8_t** sw_data = nullptr;   // av_samples_alloc'd planar f32 planes
    int sw_capacity = 0;

    // caller callbacks (pull mode); mem reader (in-memory mode)
    wac_read_cb read_cb = nullptr;
    wac_seek_cb seek_cb = nullptr;
    void* opaque = nullptr;
    MemReader mem{nullptr, 0, 0};

    int stream_idx = -1;
    int nch = 0;
    int sr = 0;
    bool demux_eof = false;    // sent flush packet to the decoder
    bool drained = false;      // decoder + resampler fully flushed
    // decoded-but-undelivered frames, per channel, starting at lo_pos
    std::vector<std::vector<float>> pending;
    size_t pending_pos = 0;
    // source position (in frames) of the NEXT sample wac_stream_read
    // returns; derived from frame pts when available
    int64_t next_pos = 0;
    bool have_pts_base = false;

    ~StreamHandle() {
        if (sw_data) {
            av_freep(&sw_data[0]);
            av_freep(&sw_data);
        }
        if (pkt) av_packet_free(&pkt);
        if (frame) av_frame_free(&frame);
        if (swr) swr_free(&swr);
        if (codec) avcodec_free_context(&codec);
        if (fmt) avformat_close_input(&fmt);
        if (avio) {
            av_freep(&avio->buffer);
            avio_context_free(&avio);
        }
    }
};

int cb_read(void* opaque, uint8_t* buf, int buf_size) {
    StreamHandle* h = static_cast<StreamHandle*>(opaque);
    int n = h->read_cb(h->opaque, buf, buf_size);
    if (n < 0) return AVERROR_EOF;
    if (n == 0) return AVERROR_EOF;
    return n;
}

int64_t cb_seek(void* opaque, int64_t offset, int whence) {
    StreamHandle* h = static_cast<StreamHandle*>(opaque);
    return h->seek_cb(h->opaque, offset, whence);
}

// Open demuxer + decoder + resampler on an already-set h->avio.
int open_common(StreamHandle& h, char* errbuf, int errlen) {
    av_log_set_level(AV_LOG_FATAL);  // errors surface via errbuf instead
    h.fmt = avformat_alloc_context();
    if (!h.fmt) { set_err(errbuf, errlen, "oom"); return 1; }
    h.fmt->pb = h.avio;
    h.fmt->flags |= AVFMT_FLAG_CUSTOM_IO;

    int ret = avformat_open_input(&h.fmt, nullptr, nullptr, nullptr);
    if (ret < 0) { set_err(errbuf, errlen, "open_input", ret); return 2; }
    ret = avformat_find_stream_info(h.fmt, nullptr);
    if (ret < 0) { set_err(errbuf, errlen, "stream_info", ret); return 2; }

    const AVCodec* dec = nullptr;
    h.stream_idx =
        av_find_best_stream(h.fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &dec, 0);
    if (h.stream_idx < 0 || !dec) {
        set_err(errbuf, errlen, "no audio stream", h.stream_idx);
        return 3;
    }
    AVStream* stream = h.fmt->streams[h.stream_idx];

    h.codec = avcodec_alloc_context3(dec);
    if (!h.codec) { set_err(errbuf, errlen, "oom"); return 1; }
    ret = avcodec_parameters_to_context(h.codec, stream->codecpar);
    if (ret < 0) { set_err(errbuf, errlen, "codec params", ret); return 3; }
    ret = avcodec_open2(h.codec, dec, nullptr);
    if (ret < 0) { set_err(errbuf, errlen, "codec open", ret); return 3; }

    h.nch = h.codec->ch_layout.nb_channels;
    h.sr = h.codec->sample_rate;
    if (h.nch <= 0 || h.nch > 32 || h.sr <= 0) {
        set_err(errbuf, errlen, "bad channel count / sample rate");
        return 3;
    }

    // resampler: any input layout/format -> planar f32, same rate
    AVChannelLayout out_layout;
    av_channel_layout_copy(&out_layout, &h.codec->ch_layout);
    ret = swr_alloc_set_opts2(&h.swr, &out_layout, AV_SAMPLE_FMT_FLTP, h.sr,
                              &h.codec->ch_layout, h.codec->sample_fmt, h.sr,
                              0, nullptr);
    av_channel_layout_uninit(&out_layout);
    if (ret < 0 || !h.swr || swr_init(h.swr) < 0) {
        set_err(errbuf, errlen, "swr init", ret);
        return 4;
    }

    h.frame = av_frame_alloc();
    h.pkt = av_packet_alloc();
    if (!h.frame || !h.pkt) { set_err(errbuf, errlen, "oom"); return 1; }
    h.pending.assign(h.nch, {});
    return 0;
}

// Convert one decoded frame (or flush with null) into h.pending.
int drain_frame(StreamHandle& h, AVFrame* f) {
    int max_out = swr_get_out_samples(h.swr, f ? f->nb_samples : 0);
    if (max_out <= 0) return 0;
    // output planes must be av_samples_alloc'd: swresample writes in
    // SIMD-sized blocks and assumes ffmpeg's buffer padding/alignment
    if (max_out > h.sw_capacity) {
        if (h.sw_data) {
            av_freep(&h.sw_data[0]);
            av_freep(&h.sw_data);
        }
        int linesize = 0;
        int cap = max_out * 2 + 1024;
        if (av_samples_alloc_array_and_samples(
                &h.sw_data, &linesize, h.nch, cap,
                AV_SAMPLE_FMT_FLTP, 0) < 0) {
            h.sw_data = nullptr;
            h.sw_capacity = 0;
            return AVERROR(ENOMEM);
        }
        h.sw_capacity = cap;
    }
    int got = swr_convert(
        h.swr, h.sw_data, h.sw_capacity,
        f ? const_cast<const uint8_t**>(
                reinterpret_cast<uint8_t**>(f->extended_data))
          : nullptr,
        f ? f->nb_samples : 0);
    if (got < 0) return got;
    for (int ch = 0; ch < h.nch; ++ch) {
        const float* p = reinterpret_cast<const float*>(h.sw_data[ch]);
        h.pending[ch].insert(h.pending[ch].end(), p, p + got);
    }
    return got;
}

// Pump one demuxer packet through the decoder into h.pending.
// Returns 0 ok (possibly zero new frames), 1 fully drained, <0 error code.
int pump(StreamHandle& h, char* errbuf, int errlen) {
    if (h.drained) return 1;
    int ret;
    if (!h.demux_eof) {
        ret = av_read_frame(h.fmt, h.pkt);
        if (ret == AVERROR_EOF) {
            h.demux_eof = true;
        } else if (ret < 0) {
            set_err(errbuf, errlen, "read_frame", ret);
            return -5;
        } else if (h.pkt->stream_index != h.stream_idx) {
            av_packet_unref(h.pkt);
            return 0;
        }
        ret = avcodec_send_packet(h.codec, h.demux_eof ? nullptr : h.pkt);
        if (!h.demux_eof) av_packet_unref(h.pkt);
        if (ret < 0 && ret != AVERROR(EAGAIN) && ret != AVERROR_EOF) {
            set_err(errbuf, errlen, "send_packet", ret);
            return -5;
        }
    }
    bool decoder_eof = false;
    while (true) {
        ret = avcodec_receive_frame(h.codec, h.frame);
        if (ret == AVERROR(EAGAIN)) break;
        if (ret == AVERROR_EOF) { decoder_eof = true; break; }
        if (ret < 0) { set_err(errbuf, errlen, "decode", ret); return -5; }
        if (!h.have_pts_base && h.frame->pts != AV_NOPTS_VALUE) {
            // anchor the source-frame position from the container clock
            AVStream* s = h.fmt->streams[h.stream_idx];
            int64_t pos = av_rescale_q(h.frame->pts, s->time_base,
                                       AVRational{1, h.sr});
            size_t buffered = h.pending[0].size() - h.pending_pos;
            h.next_pos = pos - static_cast<int64_t>(buffered);
            h.have_pts_base = true;
        }
        if (drain_frame(h, h.frame) < 0) {
            set_err(errbuf, errlen, "resample");
            return -5;
        }
        av_frame_unref(h.frame);
    }
    if (h.demux_eof && decoder_eof) {
        if (drain_frame(h, nullptr) < 0) {  // flush resampler delay
            set_err(errbuf, errlen, "flush");
            return -5;
        }
        h.drained = true;
        return 1;
    }
    return 0;
}

}  // namespace

extern "C" {

// --- incremental pull-handle API -------------------------------------------

// Open a decode handle over caller callbacks.  `seek` may be NULL for
// forward-only (unseekable) streams — the reference's MediaInput contract
// (decoding.rs:60-92).  On success returns the handle and fills
// channels/rate/duration (duration in seconds, <0 when the container does
// not declare one).
void* wac_open(wac_read_cb read, wac_seek_cb seek, void* opaque,
               uint32_t* channels, uint32_t* rate, double* duration,
               char* errbuf, int errlen) {
    StreamHandle* h = new StreamHandle();
    h->read_cb = read;
    h->seek_cb = seek;
    h->opaque = opaque;

    constexpr int kIoBuf = 1 << 16;
    uint8_t* iobuf = static_cast<uint8_t*>(av_malloc(kIoBuf));
    if (!iobuf) { set_err(errbuf, errlen, "oom"); delete h; return nullptr; }
    h->avio = avio_alloc_context(iobuf, kIoBuf, 0, h, cb_read, nullptr,
                                 seek ? cb_seek : nullptr);
    if (!h->avio) {
        av_free(iobuf);
        set_err(errbuf, errlen, "oom");
        delete h;
        return nullptr;
    }
    if (open_common(*h, errbuf, errlen) != 0) {
        delete h;
        return nullptr;
    }
    *channels = static_cast<uint32_t>(h->nch);
    *rate = static_cast<uint32_t>(h->sr);
    AVStream* s = h->fmt->streams[h->stream_idx];
    if (s->duration > 0) {
        *duration = s->duration * av_q2d(s->time_base);
    } else if (h->fmt->duration > 0) {
        *duration = h->fmt->duration / static_cast<double>(AV_TIME_BASE);
    } else {
        *duration = -1.0;
    }
    return h;
}

// Pull up to max_frames decoded frames.  `out` is channel-major with row
// stride max_frames (out[ch*max_frames + i]).  Returns the frame count
// (0 = end of stream, <0 = error with message in errbuf).  `pos` (may be
// NULL) receives the source frame index of the first returned sample.
int64_t wac_stream_read(void* handle, float* out, int64_t max_frames,
                        int64_t* pos, char* errbuf, int errlen) {
    StreamHandle* h = static_cast<StreamHandle*>(handle);
    if (max_frames <= 0) return 0;
    while (static_cast<int64_t>(h->pending[0].size() - h->pending_pos)
               < max_frames) {
        int rc = pump(*h, errbuf, errlen);
        if (rc < 0) return rc;
        if (rc == 1) break;  // drained
    }
    int64_t avail =
        static_cast<int64_t>(h->pending[0].size() - h->pending_pos);
    int64_t n = avail < max_frames ? avail : max_frames;
    if (pos) *pos = h->next_pos;
    if (n <= 0) return 0;
    for (int ch = 0; ch < h->nch; ++ch) {
        memcpy(out + static_cast<int64_t>(ch) * max_frames,
               h->pending[ch].data() + h->pending_pos, sizeof(float) * n);
    }
    h->pending_pos += static_cast<size_t>(n);
    h->next_pos += n;
    // compact once the consumed prefix dominates (keeps memory bounded by
    // ~2x the largest single pull regardless of stream length)
    if (h->pending_pos > (1u << 16) &&
        h->pending_pos * 2 > h->pending[0].size()) {
        for (auto& v : h->pending) v.erase(v.begin(), v.begin() + h->pending_pos);
        h->pending_pos = 0;
    }
    return n;
}

// Seek to `seconds` (requires a seekable source).  Container seeks land on
// the nearest earlier sync point; `actual` receives the stream position in
// seconds the next wac_stream_read will return from (callers discard
// forward to sample accuracy).  Returns 0 on success.
int wac_stream_seek(void* handle, double seconds, double* actual,
                    char* errbuf, int errlen) {
    StreamHandle* h = static_cast<StreamHandle*>(handle);
    if (!h->seek_cb && h->mem.data == nullptr) {
        set_err(errbuf, errlen, "stream is not seekable");
        return 1;
    }
    AVStream* s = h->fmt->streams[h->stream_idx];
    int64_t ts = av_rescale_q(static_cast<int64_t>(seconds * h->sr),
                              AVRational{1, h->sr}, s->time_base);
    int ret = av_seek_frame(h->fmt, h->stream_idx, ts, AVSEEK_FLAG_BACKWARD);
    if (ret < 0) { set_err(errbuf, errlen, "seek", ret); return 2; }
    avcodec_flush_buffers(h->codec);
    // drop any resampler delay + pending samples from the old position
    if (h->swr) {
        swr_close(h->swr);
        if (swr_init(h->swr) < 0) {
            set_err(errbuf, errlen, "swr reinit");
            return 2;
        }
    }
    for (auto& v : h->pending) v.clear();
    h->pending_pos = 0;
    h->demux_eof = false;
    h->drained = false;
    h->have_pts_base = false;
    h->next_pos = static_cast<int64_t>(seconds * h->sr);  // pts refines it
    // decode one pump so the pts anchor reflects the landing point
    char tmp[1];
    (void)tmp;
    int rc = pump(*h, errbuf, errlen);
    if (rc < 0) return 2;
    *actual = h->next_pos / static_cast<double>(h->sr);
    return 0;
}

void wac_close(void* handle) {
    delete static_cast<StreamHandle*>(handle);
}

// --- whole-stream decode (memory) ------------------------------------------

// Decode a whole compressed stream from memory.
//   out      <- malloc'd planar f32 block, channels*frames floats
//               (channel-major, contiguous); caller frees with wac_free
//   channels <- stream channel count (clamped to 32)
//   rate     <- stream sample rate
//   frames   <- decoded frame count
// Returns 0 on success, nonzero on failure (message in errbuf).
int wac_decode(const uint8_t* data, uint64_t size, float** out,
               uint32_t* channels, uint32_t* rate, uint64_t* frames,
               char* errbuf, int errlen) {
    *out = nullptr;
    *channels = 0;
    *rate = 0;
    *frames = 0;

    StreamHandle h;
    h.mem = MemReader{data, static_cast<int64_t>(size), 0};

    constexpr int kIoBuf = 1 << 16;
    uint8_t* iobuf = static_cast<uint8_t*>(av_malloc(kIoBuf));
    if (!iobuf) { set_err(errbuf, errlen, "oom"); return 1; }
    h.avio = avio_alloc_context(iobuf, kIoBuf, 0, &h.mem, mem_read, nullptr,
                                mem_seek);
    if (!h.avio) { av_free(iobuf); set_err(errbuf, errlen, "oom"); return 1; }
    int rc = open_common(h, errbuf, errlen);
    if (rc != 0) return rc;

    AVStream* stream = h.fmt->streams[h.stream_idx];
    int64_t est = stream->duration > 0
        ? av_rescale_q(stream->duration, stream->time_base, {1, h.sr})
        : 0;
    if (est > 0 && est < (int64_t{1} << 32)) {
        for (auto& v : h.pending) v.reserve(static_cast<size_t>(est));
    }

    while (true) {
        rc = pump(h, errbuf, errlen);
        if (rc < 0) return 5;
        if (rc == 1) break;
    }

    uint64_t n = h.pending[0].size();
    if (n == 0) { set_err(errbuf, errlen, "no audio frames decoded"); return 6; }

    float* block = static_cast<float*>(
        malloc(sizeof(float) * n * static_cast<uint64_t>(h.nch)));
    if (!block) { set_err(errbuf, errlen, "oom"); return 1; }
    for (int ch = 0; ch < h.nch; ++ch)
        memcpy(block + static_cast<uint64_t>(ch) * n, h.pending[ch].data(),
               sizeof(float) * n);

    *out = block;
    *channels = static_cast<uint32_t>(h.nch);
    *rate = static_cast<uint32_t>(h.sr);
    *frames = n;
    return 0;
}

void wac_free(float* p) { free(p); }

// Library smoke probe: returns the linked libavformat major version.
int wac_version(void) { return LIBAVFORMAT_VERSION_MAJOR; }

}  // extern "C"
