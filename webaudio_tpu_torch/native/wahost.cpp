// wahost: native host-side audio runtime for webaudio_tpu_torch (a copy of
// webaudio_tpu/native/wahost.cpp).
//
// The native equivalent of the reference's host-side Rust crates that
// do real work outside the DSP graph: symphonia's WAV decode path
// (reference: src/decoding.rs), hound's WAV encode
// (media_recorder/mod.rs:40-48), the AudioBuffer linear resampler
// (buffer.rs:311-363), and dasp's sample conversion (render/thread.rs:12).
// Compiled to a shared library under webaudio_tpu_torch/build/ at first
// use and bound via ctypes (webaudio_tpu_torch/native/__init__.py); the
// pure-numpy implementations remain as fallback and as the format
// reference.
//
// Build: g++ -O3 -shared -fPIC wahost.cpp -o libwahost.so

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cmath>

extern "C" {

// ---------------------------------------------------------------------------
// WAV (RIFF) decoding: PCM u8/i16/i24/i32 and float32/64.
// Two-phase: probe the header, then decode into caller-allocated planar f32.
// ---------------------------------------------------------------------------

struct WavInfo {
    uint32_t channels;
    uint32_t frames;
    double sample_rate;
    uint16_t format;      // 1 = int PCM, 3 = IEEE float
    uint16_t bits;
    uint64_t data_offset; // payload position in the byte stream
};

static int wav_parse(const uint8_t* data, uint64_t len, WavInfo* info) {
    if (len < 12 || memcmp(data, "RIFF", 4) != 0 || memcmp(data + 8, "WAVE", 4) != 0)
        return -1;
    uint64_t pos = 12;
    bool have_fmt = false, have_data = false;
    uint16_t block_align = 0;
    while (pos + 8 <= len) {
        const uint8_t* cid = data + pos;
        uint32_t size;
        memcpy(&size, data + pos + 4, 4);
        uint64_t body = pos + 8;
        if (body + size > len) size = (uint32_t)(len - body);
        if (memcmp(cid, "fmt ", 4) == 0 && size >= 16) {
            uint16_t fmt_tag, channels, ba, bits;
            uint32_t rate;
            memcpy(&fmt_tag, data + body, 2);
            memcpy(&channels, data + body + 2, 2);
            memcpy(&rate, data + body + 4, 4);
            memcpy(&ba, data + body + 12, 2);
            memcpy(&bits, data + body + 14, 2);
            if (fmt_tag == 0xFFFE && size >= 40)  // WAVE_FORMAT_EXTENSIBLE
                memcpy(&fmt_tag, data + body + 24, 2);
            info->format = fmt_tag;
            info->channels = channels;
            info->sample_rate = (double)rate;
            info->bits = bits;
            block_align = ba;
            have_fmt = true;
        } else if (memcmp(cid, "data", 4) == 0) {
            info->data_offset = body;
            info->frames = block_align ? size / block_align : 0;
            have_data = true;
            if (have_fmt && block_align)
                info->frames = size / block_align;
        }
        pos = body + size + (size & 1);
    }
    if (!have_fmt || !have_data || info->channels == 0) return -2;
    if (block_align == 0) return -3;
    // recompute frames with final block_align (data may precede fmt)
    return 0;
}

int wah_wav_probe(const uint8_t* data, uint64_t len, uint32_t* channels,
                  uint32_t* frames, double* sample_rate) {
    WavInfo info{};
    int rc = wav_parse(data, len, &info);
    if (rc != 0) return rc;
    *channels = info.channels;
    *frames = info.frames;
    *sample_rate = info.sample_rate;
    return 0;
}

// out: planar (channels, frames) f32
int wah_wav_decode(const uint8_t* data, uint64_t len, float* out) {
    WavInfo info{};
    int rc = wav_parse(data, len, &info);
    if (rc != 0) return rc;
    const uint8_t* p = data + info.data_offset;
    const uint32_t C = info.channels;
    const uint64_t N = info.frames;

    if (info.format == 1 && info.bits == 16) {
        for (uint64_t i = 0; i < N; ++i)
            for (uint32_t c = 0; c < C; ++c) {
                int16_t v;
                memcpy(&v, p + (i * C + c) * 2, 2);
                out[c * N + i] = (float)v / 32768.0f;
            }
    } else if (info.format == 3 && info.bits == 32) {
        for (uint64_t i = 0; i < N; ++i)
            for (uint32_t c = 0; c < C; ++c)
                memcpy(&out[c * N + i], p + (i * C + c) * 4, 4);
    } else if (info.format == 1 && info.bits == 24) {
        for (uint64_t i = 0; i < N; ++i)
            for (uint32_t c = 0; c < C; ++c) {
                const uint8_t* s = p + (i * C + c) * 3;
                int32_t v = (int32_t)s[0] | ((int32_t)s[1] << 8) | ((int32_t)s[2] << 16);
                if (v >= (1 << 23)) v -= (1 << 24);
                out[c * N + i] = (float)v / 8388608.0f;
            }
    } else if (info.format == 1 && info.bits == 32) {
        for (uint64_t i = 0; i < N; ++i)
            for (uint32_t c = 0; c < C; ++c) {
                int32_t v;
                memcpy(&v, p + (i * C + c) * 4, 4);
                out[c * N + i] = (float)((double)v / 2147483648.0);
            }
    } else if (info.format == 1 && info.bits == 8) {
        for (uint64_t i = 0; i < N; ++i)
            for (uint32_t c = 0; c < C; ++c)
                out[c * N + i] = ((float)p[i * C + c] - 128.0f) / 128.0f;
    } else if (info.format == 3 && info.bits == 64) {
        for (uint64_t i = 0; i < N; ++i)
            for (uint32_t c = 0; c < C; ++c) {
                double v;
                memcpy(&v, p + (i * C + c) * 8, 8);
                out[c * N + i] = (float)v;
            }
    } else {
        return -4;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Linear-interpolation resampling, planar (reference: buffer.rs:311-363)
// ---------------------------------------------------------------------------

void wah_resample_linear(const float* in, uint32_t channels,
                         uint64_t in_frames, float* out,
                         uint64_t out_frames, double ratio /* out/in rate */) {
    // endpoint-preserving mapping: position i/(out-1) in [0,1] scaled to
    // [0, in-1], first and last samples intact (reference: buffer.rs:311-363)
    (void)ratio;
    for (uint32_t c = 0; c < channels; ++c) {
        const float* src = in + c * in_frames;
        float* dst = out + c * out_frames;
        for (uint64_t i = 0; i < out_frames; ++i) {
            double position = out_frames > 1
                ? (double)i / (double)(out_frames - 1) : 0.0;
            double playhead = position * (double)(in_frames - 1);
            uint64_t k = (uint64_t)playhead;
            if (k >= in_frames - 1) {
                dst[i] = src[in_frames - 1];
                continue;
            }
            float frac = (float)(playhead - (double)k);
            dst[i] = src[k] * (1.0f - frac) + src[k + 1] * frac;
        }
    }
}

// ---------------------------------------------------------------------------
// Sample conversion + interleaving (reference: render/thread.rs:12,513-520)
// ---------------------------------------------------------------------------

void wah_interleave_f32_to_i16(const float* planar, uint32_t channels,
                               uint64_t frames, int16_t* interleaved) {
    for (uint64_t i = 0; i < frames; ++i)
        for (uint32_t c = 0; c < channels; ++c) {
            float v = planar[c * frames + i];
            if (v > 1.0f) v = 1.0f;
            if (v < -1.0f) v = -1.0f;
            interleaved[i * channels + c] = (int16_t)lrintf(v * 32767.0f);
        }
}

void wah_interleave_f32(const float* planar, uint32_t channels,
                        uint64_t frames, float* interleaved) {
    for (uint64_t i = 0; i < frames; ++i)
        for (uint32_t c = 0; c < channels; ++c)
            interleaved[i * channels + c] = planar[c * frames + i];
}

void wah_deinterleave_f32(const float* interleaved, uint32_t channels,
                          uint64_t frames, float* planar) {
    for (uint64_t i = 0; i < frames; ++i)
        for (uint32_t c = 0; c < channels; ++c)
            planar[c * frames + i] = interleaved[i * channels + c];
}


// ---------------------------------------------------------------------------
// FLAC decoding (RFC 9639): the native analog of symphonia-bundle-flac
// (reference: src/decoding.rs routes FLAC through symphonia with the "all"
// feature set, Cargo.toml:63-66).  Supports 8/16/24/32-bit, all subframe
// types (constant / verbatim / fixed 0-4 / LPC), rice + rice2 residuals
// with escape partitions, wasted bits, and left/right/mid-side stereo
// decorrelation.  CRCs are not verified (decode-or-reject on structure).
// ---------------------------------------------------------------------------

struct BitReader {
    const uint8_t* data;
    uint64_t len;      // bytes
    uint64_t pos;      // bit position
    bool ok;
};

static inline uint32_t br_bit(BitReader* br) {
    if (br->pos >= br->len * 8) { br->ok = false; return 0; }
    uint32_t b = (br->data[br->pos >> 3] >> (7 - (br->pos & 7))) & 1u;
    br->pos++;
    return b;
}

static uint64_t br_bits(BitReader* br, uint32_t n) {
    // n <= 57 guaranteed by callers
    if (br->pos + n > br->len * 8) { br->ok = false; return 0; }
    uint64_t byte_i = br->pos >> 3;
    uint32_t bit_off = (uint32_t)(br->pos & 7);
    uint64_t v = 0;
    uint32_t avail = 0;
    while (avail < bit_off + n) {
        v = (v << 8) | (byte_i < br->len ? br->data[byte_i] : 0);
        byte_i++;
        avail += 8;
    }
    v >>= (avail - bit_off - n);
    v &= (n == 64) ? ~0ull : ((1ull << n) - 1ull);
    br->pos += n;
    return v;
}

static int64_t br_sbits(BitReader* br, uint32_t n) {
    uint64_t v = br_bits(br, n);
    if (n == 0) return 0;
    if (v & (1ull << (n - 1))) return (int64_t)(v | (~0ull << n));
    return (int64_t)v;
}

static uint32_t br_unary(BitReader* br) {
    uint32_t q = 0;
    while (br->ok && br_bit(br) == 0) {
        q++;
        if (q > 1u << 24) { br->ok = false; break; }
    }
    return q;
}

static void br_align(BitReader* br) {
    br->pos = (br->pos + 7) & ~7ull;
}

struct FlacInfo {
    uint32_t channels;
    uint32_t sample_rate;
    uint32_t bps;
    uint64_t total_samples;
    uint64_t frames_offset;  // byte offset of the first audio frame
};

static int flac_parse_header(const uint8_t* data, uint64_t len, FlacInfo* fi) {
    if (len < 42 || memcmp(data, "fLaC", 4) != 0) return -1;
    uint64_t off = 4;
    bool last = false;
    bool have_info = false;
    while (!last) {
        if (off + 4 > len) return -1;
        last = (data[off] & 0x80u) != 0;
        uint32_t type = data[off] & 0x7fu;
        uint32_t blen = ((uint32_t)data[off + 1] << 16) |
                        ((uint32_t)data[off + 2] << 8) | data[off + 3];
        off += 4;
        if (off + blen > len) return -1;
        if (type == 0) {  // STREAMINFO
            if (blen < 34) return -1;
            const uint8_t* p = data + off;
            fi->sample_rate = ((uint32_t)p[10] << 12) | ((uint32_t)p[11] << 4)
                              | (p[12] >> 4);
            fi->channels = ((p[12] >> 1) & 0x7u) + 1;
            fi->bps = (((p[12] & 1u) << 4) | (p[13] >> 4)) + 1;
            fi->total_samples = ((uint64_t)(p[13] & 0x0fu) << 32)
                | ((uint64_t)p[14] << 24) | ((uint64_t)p[15] << 16)
                | ((uint64_t)p[16] << 8) | p[17];
            have_info = true;
        }
        off += blen;
    }
    if (!have_info || fi->sample_rate == 0 || fi->channels == 0) return -1;
    fi->frames_offset = off;
    return 0;
}

// decoded UTF-8-style coded number (frame/sample index); -1 on error
static int64_t flac_utf8(BitReader* br) {
    uint32_t b0 = (uint32_t)br_bits(br, 8);
    if (!(b0 & 0x80u)) return b0;
    uint32_t n = 0;
    uint32_t mask = 0x40u;
    while (b0 & mask) { n++; mask >>= 1; }
    if (n == 0 || n > 6) return -1;
    uint64_t v = b0 & (mask - 1);
    for (uint32_t i = 0; i < n; i++) {
        uint32_t b = (uint32_t)br_bits(br, 8);
        if ((b & 0xc0u) != 0x80u) return -1;
        v = (v << 6) | (b & 0x3fu);
    }
    return (int64_t)v;
}

static const uint32_t kFlacBlockSizes[16] = {
    0, 192, 576, 1152, 2304, 4608, 0, 0,
    256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
static const uint32_t kFlacRates[16] = {
    0, 88200, 176400, 192000, 8000, 16000, 22050, 24000,
    32000, 44100, 48000, 96000, 0, 0, 0, 0};

// returns 0 on success; fills samples[ch][i] (int64 workspace)
static int flac_subframe(BitReader* br, uint32_t bs, uint32_t bps,
                         int64_t* smp) {
    if (br_bit(br) != 0) return -1;  // reserved
    uint32_t type = (uint32_t)br_bits(br, 6);
    uint32_t wasted = 0;
    if (br_bit(br)) wasted = br_unary(br) + 1;
    if (!br->ok || wasted >= bps) return -1;
    uint32_t eff = bps - wasted;
    uint32_t order = 0;
    enum { CONST, VERB, FIXED, LPC } kind;
    if (type == 0) kind = CONST;
    else if (type == 1) kind = VERB;
    else if ((type & 0x38u) == 0x08u && (type & 7u) <= 4) {
        kind = FIXED; order = type & 7u;
    } else if (type & 0x20u) {
        kind = LPC; order = (type & 0x1fu) + 1;
    } else return -1;

    if (kind == CONST) {
        int64_t v = br_sbits(br, eff);
        for (uint32_t i = 0; i < bs; i++) smp[i] = v;
    } else if (kind == VERB) {
        for (uint32_t i = 0; i < bs; i++) smp[i] = br_sbits(br, eff);
    } else {
        if (order > bs) return -1;
        for (uint32_t i = 0; i < order; i++) smp[i] = br_sbits(br, eff);
        int32_t qcoef[32];
        int32_t shift = 0;
        if (kind == LPC) {
            uint32_t prec = (uint32_t)br_bits(br, 4);
            if (prec == 15) return -1;
            prec += 1;
            shift = (int32_t)br_sbits(br, 5);
            if (shift < 0) return -1;
            for (uint32_t i = 0; i < order; i++)
                qcoef[i] = (int32_t)br_sbits(br, prec);
        }
        // residual
        uint32_t method = (uint32_t)br_bits(br, 2);
        if (method > 1) return -1;
        uint32_t pbits = method == 0 ? 4 : 5;
        uint32_t escape = method == 0 ? 0xFu : 0x1Fu;
        uint32_t porder = (uint32_t)br_bits(br, 4);
        uint32_t nparts = 1u << porder;
        if ((bs >> porder) << porder != bs) return -1;
        uint32_t idx = order;
        for (uint32_t part = 0; part < nparts; part++) {
            uint32_t count = bs >> porder;
            if (part == 0) {
                if (count < order) return -1;
                count -= order;
            }
            uint32_t rp = (uint32_t)br_bits(br, pbits);
            if (rp == escape) {
                uint32_t raw = (uint32_t)br_bits(br, 5);
                for (uint32_t i = 0; i < count; i++)
                    smp[idx++] = raw ? br_sbits(br, raw) : 0;
            } else {
                for (uint32_t i = 0; i < count; i++) {
                    uint64_t q = br_unary(br);
                    uint64_t u = (q << rp) | br_bits(br, rp);
                    smp[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
                }
            }
            if (!br->ok) return -1;
        }
        // predict
        if (kind == FIXED) {
            switch (order) {
                case 0: break;
                case 1: for (uint32_t i = 1; i < bs; i++)
                            smp[i] += smp[i-1];
                        break;
                case 2: for (uint32_t i = 2; i < bs; i++)
                            smp[i] += 2*smp[i-1] - smp[i-2];
                        break;
                case 3: for (uint32_t i = 3; i < bs; i++)
                            smp[i] += 3*smp[i-1] - 3*smp[i-2] + smp[i-3];
                        break;
                case 4: for (uint32_t i = 4; i < bs; i++)
                            smp[i] += 4*smp[i-1] - 6*smp[i-2]
                                      + 4*smp[i-3] - smp[i-4];
                        break;
            }
        } else {
            for (uint32_t i = order; i < bs; i++) {
                int64_t acc = 0;
                for (uint32_t j = 0; j < order; j++)
                    acc += (int64_t)qcoef[j] * smp[i - 1 - j];
                smp[i] += acc >> shift;
            }
        }
    }
    if (wasted)
        for (uint32_t i = 0; i < bs; i++) smp[i] <<= wasted;
    return br->ok ? 0 : -1;
}

int wah_flac_probe(const uint8_t* data, uint64_t len, uint32_t* channels,
                   uint32_t* sample_rate, uint64_t* frames) {
    FlacInfo fi;
    if (flac_parse_header(data, len, &fi) != 0) return -1;
    *channels = fi.channels;
    *sample_rate = fi.sample_rate;
    *frames = fi.total_samples;  // 0 = unknown; caller decodes to count
    return 0;
}

// out: planar f32 [channels][total_samples]; cap = per-channel capacity.
// Returns decoded frame count (>=0) or -1 on error.
int64_t wah_flac_decode(const uint8_t* data, uint64_t len, float* out,
                        uint64_t cap) {
    FlacInfo fi;
    if (flac_parse_header(data, len, &fi) != 0) return -1;
    BitReader br = {data, len, fi.frames_offset * 8, true};
    const uint32_t maxbs = 65536;
    int64_t* work = (int64_t*)malloc(
        (uint64_t)fi.channels * maxbs * sizeof(int64_t));
    if (!work) return -1;
    uint64_t done = 0;
    while (br.pos + 32 <= br.len * 8) {
        // frame sync
        uint64_t sync = br_bits(&br, 14);
        if (!br.ok) break;
        if (sync != 0x3FFEu) { free(work); return -1; }
        br_bit(&br);                       // reserved
        br_bit(&br);                       // blocking strategy
        uint32_t bs_code = (uint32_t)br_bits(&br, 4);
        uint32_t sr_code = (uint32_t)br_bits(&br, 4);
        uint32_t ch_asgn = (uint32_t)br_bits(&br, 4);
        uint32_t ss_code = (uint32_t)br_bits(&br, 3);
        br_bit(&br);                       // reserved
        if (flac_utf8(&br) < 0) { free(work); return -1; }
        uint32_t bs;
        if (bs_code == 6) bs = (uint32_t)br_bits(&br, 8) + 1;
        else if (bs_code == 7) bs = (uint32_t)br_bits(&br, 16) + 1;
        else bs = kFlacBlockSizes[bs_code];
        if (sr_code == 12) br_bits(&br, 8);
        else if (sr_code == 13 || sr_code == 14) br_bits(&br, 16);
        (void)kFlacRates;
        br_bits(&br, 8);                   // header CRC-8
        if (!br.ok || bs == 0 || bs > maxbs) { free(work); return -1; }
        uint32_t bps = fi.bps;
        static const uint32_t kSS[8] = {0, 8, 12, 0, 16, 20, 24, 32};
        if (ss_code != 0 && kSS[ss_code]) bps = kSS[ss_code];
        uint32_t nch = fi.channels;
        bool lr_side = false, rl_side = false, mid_side = false;
        if (ch_asgn <= 7) {
            if (ch_asgn + 1 != nch) { free(work); return -1; }
        } else if (ch_asgn == 8) { lr_side = true; nch = 2; }
        else if (ch_asgn == 9) { rl_side = true; nch = 2; }
        else if (ch_asgn == 10) { mid_side = true; nch = 2; }
        else { free(work); return -1; }
        if (nch != fi.channels) { free(work); return -1; }

        for (uint32_t c = 0; c < nch; c++) {
            uint32_t sb_bps = bps;
            if ((lr_side && c == 1) || (rl_side && c == 0) ||
                (mid_side && c == 1))
                sb_bps += 1;  // side channel carries one extra bit
            if (flac_subframe(&br, bs, sb_bps, work + (uint64_t)c * maxbs)
                != 0) { free(work); return -1; }
        }
        br_align(&br);
        br_bits(&br, 16);  // frame CRC-16
        if (!br.ok) { free(work); return -1; }

        // stereo decorrelation
        int64_t* c0 = work;
        int64_t* c1 = work + maxbs;
        if (lr_side) {
            for (uint32_t i = 0; i < bs; i++) c1[i] = c0[i] - c1[i];
        } else if (rl_side) {
            for (uint32_t i = 0; i < bs; i++) c0[i] = c1[i] + c0[i];
        } else if (mid_side) {
            for (uint32_t i = 0; i < bs; i++) {
                int64_t side = c1[i];
                int64_t m2 = (c0[i] << 1) | (side & 1);
                c0[i] = (m2 + side) >> 1;
                c1[i] = (m2 - side) >> 1;
            }
        }

        uint64_t n = bs;
        if (done + n > cap) n = cap > done ? cap - done : 0;
        double scale = 1.0 / (double)(1ull << (bps - 1));
        for (uint32_t c = 0; c < fi.channels; c++) {
            float* dst = out + (uint64_t)c * cap + done;
            int64_t* src = work + (uint64_t)c * maxbs;
            for (uint64_t i = 0; i < n; i++)
                dst[i] = (float)((double)src[i] * scale);
        }
        done += n;
        if (done >= cap) break;
        // stop cleanly at stream end (allow trailing padding bytes)
        if (br.pos + 32 > br.len * 8) break;
    }
    free(work);
    return (int64_t)done;
}

}  // extern "C"
