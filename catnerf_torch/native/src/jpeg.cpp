// JPEG decoding and encoding: the port's own source, read by
// catnerf_torch/data/jpeg.py.
//
// The decoder takes baseline (SOF0) and extended-Huffman (SOF1) files:
// 8-bit samples, one (grey) or three (YCbCr) components, sampling factors
// up to 2 x 2, interleaved or not, restart markers. It gives what
// libjpeg(-turbo) gives with its defaults, sample for sample: the integer
// "islow" inverse DCT (jidctint.c), the fancy (triangular) upsampling of
// jdsample.c for h2v1, h1v2 and h2v2 chroma (box replication where
// libjpeg uses it: a component two samples wide or less, other integer
// ratios), and the fixed-point YCbCr -> RGB tables of jdcolor.c. Anything
// else (progressive, lossless or arithmetic-coded files, 12-bit samples,
// four components, an RGB or CMYK transform, a height defined by DNL, an
// EXIF orientation other than 1) is refused with a message.
//
// The encoder writes baseline files of BGR images: YCbCr, 4:2:0 sampling
// (jccolor.c's tables, jcsample.c's h2v2 averaging), the standard
// quantisation tables of the JPEG specification (Annex K.1) scaled by
// quality as jcparam.c scales them, the integer forward DCT of
// jfdctint.c, and the standard Huffman tables (Annex K.3).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Error {
    std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw Error{what}; }

// ------------------------------------------------------------ Huffman
struct Huffman {
    bool defined = false;
    int maxcode[18];
    int valptr[17];
    int mincode[17];
    uint8_t vals[256];
    // codes of up to 9 bits: (length << 8 | value), 0 where longer
    uint16_t fast[512];
};

void build_huffman(Huffman& h, const uint8_t bits[16], const uint8_t* vals,
                   int nvals) {
    std::memcpy(h.vals, vals, nvals);
    std::memset(h.fast, 0, sizeof(h.fast));
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
        h.valptr[len] = k;
        h.mincode[len] = code;
        for (int i = 0; i < bits[len - 1]; ++i, ++code, ++k) {
            if (len <= 9) {
                const int shift = 9 - len;
                for (int j = 0; j < (1 << shift); ++j)
                    h.fast[(code << shift) | j] =
                        static_cast<uint16_t>((len << 8) | vals[k]);
            }
        }
        h.maxcode[len] = bits[len - 1] ? code - 1 : -1;
        if (code > (1 << len)) fail("bad Huffman table");
        code <<= 1;
    }
    h.maxcode[17] = 0x7fffffff;
    h.defined = true;
}

// ------------------------------------------------------------ bit reader
struct Bits {
    const uint8_t* data;
    int64_t n;
    int64_t pos;
    uint32_t acc = 0;
    int nbits = 0;
    bool marker = false;  // stopped at a marker: zeros from here on

    void fill() {
        while (nbits <= 24) {
            int byte = 0;
            if (!marker && pos < n) {
                byte = data[pos];
                if (byte == 0xFF) {
                    const int next = pos + 1 < n ? data[pos + 1] : 0xD9;
                    if (next == 0x00) {
                        pos += 2;
                    } else {
                        marker = true;
                        byte = 0;
                    }
                } else {
                    ++pos;
                }
            }
            acc |= static_cast<uint32_t>(byte) << (24 - nbits);
            nbits += 8;
        }
    }
    int get(int k) {
        if (k == 0) return 0;
        fill();
        const int v = static_cast<int>(acc >> (32 - k));
        acc <<= k;
        nbits -= k;
        return v;
    }
    int decode(const Huffman& h) {
        fill();
        const uint16_t f = h.fast[acc >> 23];
        if (f) {
            const int len = f >> 8;
            acc <<= len;
            nbits -= len;
            return f & 0xFF;
        }
        int code = 0;
        for (int len = 1; len <= 16; ++len) {
            code = (code << 1) | static_cast<int>(acc >> 31);
            acc <<= 1;
            --nbits;
            if (code <= h.maxcode[len] && h.maxcode[len] >= 0 &&
                code >= h.mincode[len])
                return h.vals[h.valptr[len] + code - h.mincode[len]];
        }
        fail("corrupt entropy-coded data (bad Huffman code)");
    }
    // the restart marker RSTn expected next: align, consume it
    void restart(int expect) {
        acc = 0;
        nbits = 0;
        // skip to the marker (libjpeg skips stray bytes too)
        while (pos + 1 < n && !(data[pos] == 0xFF && data[pos + 1] >= 0xD0 &&
                                data[pos + 1] <= 0xD7))
            ++pos;
        if (pos + 1 >= n || data[pos + 1] != 0xD0 + expect)
            fail("missing or out-of-order restart marker");
        pos += 2;
        marker = false;
    }
};

inline int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ------------------------------------------------------------ IDCT
// jidctint.c (libjpeg-turbo): the slow-but-accurate integer inverse DCT.
const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
              FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
              FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
              FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
              FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int64_t descale(int64_t x, int n) {
    return (x + (int64_t(1) << (n - 1))) >> n;
}

// the post-IDCT range limit of jdmaster.c's prepare_range_limit_table:
// the value (before +128) is taken modulo 1024 as a signed 10-bit number
inline uint8_t idct_limit(int64_t x) {
    int v = static_cast<int>(x & 1023);
    if (v >= 512) v -= 1024;
    v += 128;
    return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out,
                int64_t stride) {
    int ws[64];
    for (int c = 0; c < 8; ++c) {
        const int16_t* in = coef + c;
        const uint16_t* q = quant + c;
        int* w = ws + c;
        if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
            !in[56]) {
            const int dc = (in[0] * q[0]) * (1 << PASS1_BITS);
            for (int r = 0; r < 8; ++r) w[8 * r] = dc;
            continue;
        }
        int64_t z2 = in[16] * q[16], z3 = in[48] * q[48];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = in[0] * q[0];
        z3 = in[32] * q[32];
        int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
        int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
        const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3,
                      tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = in[56] * q[56];
        tmp1 = in[40] * q[40];
        tmp2 = in[24] * q[24];
        tmp3 = in[8] * q[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        const int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int s = CONST_BITS - PASS1_BITS;
        w[0] = static_cast<int>(descale(tmp10 + tmp3, s));
        w[56] = static_cast<int>(descale(tmp10 - tmp3, s));
        w[8] = static_cast<int>(descale(tmp11 + tmp2, s));
        w[48] = static_cast<int>(descale(tmp11 - tmp2, s));
        w[16] = static_cast<int>(descale(tmp12 + tmp1, s));
        w[40] = static_cast<int>(descale(tmp12 - tmp1, s));
        w[24] = static_cast<int>(descale(tmp13 + tmp0, s));
        w[32] = static_cast<int>(descale(tmp13 - tmp0, s));
    }
    for (int r = 0; r < 8; ++r) {
        const int* w = ws + 8 * r;
        uint8_t* o = out + r * stride;
        const int s = CONST_BITS + PASS1_BITS + 3;
        if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
            const uint8_t v = idct_limit(descale(w[0], PASS1_BITS + 3));
            for (int c = 0; c < 8; ++c) o[c] = v;
            continue;
        }
        int64_t z2 = w[2], z3 = w[6];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << CONST_BITS);
        int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << CONST_BITS);
        const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3,
                      tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = w[7];
        tmp1 = w[5];
        tmp2 = w[3];
        tmp3 = w[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        const int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        o[0] = idct_limit(descale(tmp10 + tmp3, s));
        o[7] = idct_limit(descale(tmp10 - tmp3, s));
        o[1] = idct_limit(descale(tmp11 + tmp2, s));
        o[6] = idct_limit(descale(tmp11 - tmp2, s));
        o[2] = idct_limit(descale(tmp12 + tmp1, s));
        o[5] = idct_limit(descale(tmp12 - tmp1, s));
        o[3] = idct_limit(descale(tmp13 + tmp0, s));
        o[4] = idct_limit(descale(tmp13 - tmp0, s));
    }
}

// ------------------------------------------------------------ decoder
struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int td = 0, ta = 0;
    int width = 0, height = 0;  // samples of the component (downsampled)
    int bw = 0, bh = 0;         // blocks allocated (the MCU-padded area)
    std::vector<uint8_t> plane;  // bh*8 rows of bw*8 samples
    int pred = 0;
};

struct Decoder {
    const uint8_t* data;
    int64_t n;
    int width = 0, height = 0;
    int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    int restart_interval = 0;
    bool frame = false, adobe_rgb = false, ended = false;
    uint16_t quant[4][64];
    bool quant_defined[4] = {false, false, false, false};
    Huffman dc[4], ac[4];
    std::vector<Component> comps;

    int u16(int64_t p) const {
        if (p + 1 >= n) fail("truncated file");
        return (data[p] << 8) | data[p + 1];
    }

    void read_dqt(int64_t p, int64_t end) {
        while (p < end) {
            const int pq = data[p] >> 4, tq = data[p] & 15;
            if (tq > 3) fail("bad DQT");
            ++p;
            for (int k = 0; k < 64; ++k) {
                int v;
                if (pq) {
                    v = u16(p);
                    p += 2;
                } else {
                    v = data[p++];
                }
                quant[tq][kZigzag[k]] = static_cast<uint16_t>(v);
            }
            quant_defined[tq] = true;
        }
    }

    void read_dht(int64_t p, int64_t end) {
        while (p < end) {
            const int tc = data[p] >> 4, th = data[p] & 15;
            if (tc > 1 || th > 3 || p + 17 > end) fail("bad DHT");
            uint8_t bits[16];
            int total = 0;
            for (int i = 0; i < 16; ++i) total += bits[i] = data[p + 1 + i];
            if (total > 256 || p + 17 + total > end) fail("bad DHT");
            build_huffman(tc ? ac[th] : dc[th], bits, data + p + 17, total);
            p += 17 + total;
        }
    }

    void read_sof(int64_t p, int marker) {
        if (marker == 0xC2 || marker == 0xC6 || marker == 0xCA ||
            marker == 0xCE)
            fail("progressive JPEG files are not supported");
        if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB ||
            marker == 0xCF)
            fail("lossless JPEG files are not supported");
        if (marker >= 0xC9)
            fail("arithmetic-coded JPEG files are not supported");
        if (frame) fail("more than one frame");
        frame = true;
        if (data[p] != 8)
            fail("sample precision " + std::to_string(data[p]) +
                 " is not supported (8-bit only)");
        height = u16(p + 1);
        width = u16(p + 3);
        const int nc = data[p + 5];
        if (height == 0)
            fail("a height defined by a DNL marker is not supported");
        if (width == 0) fail("zero width");
        if (nc != 1 && nc != 3)
            fail(std::to_string(nc) + " components are not supported "
                 "(grey or YCbCr only)");
        for (int i = 0; i < nc; ++i) {
            Component c;
            c.id = data[p + 6 + 3 * i];
            c.h = data[p + 7 + 3 * i] >> 4;
            c.v = data[p + 7 + 3 * i] & 15;
            c.tq = data[p + 8 + 3 * i];
            if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2 || c.tq > 3)
                fail("sampling factors above 2 are not supported");
            comps.push_back(c);
        }
        if (nc == 1) comps[0].h = comps[0].v = 1;  // as libjpeg: one block
        for (auto& c : comps) {
            hmax = std::max(hmax, c.h);
            vmax = std::max(vmax, c.v);
        }
        mcux = (width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        for (auto& c : comps) {
            c.width = (width * c.h + hmax - 1) / hmax;
            c.height = (height * c.v + vmax - 1) / vmax;
            c.bw = mcux * c.h;
            c.bh = mcuy * c.v;
            c.plane.assign(static_cast<size_t>(c.bw) * 8 * c.bh * 8, 0);
        }
        if (nc == 3 && comps[0].id == 'R' && comps[1].id == 'G' &&
            comps[2].id == 'B')
            fail("RGB-coded JPEG files are not supported");
    }

    void decode_block(Bits& bits, Component& c, int bx, int by) {
        int16_t coef[64];
        std::memset(coef, 0, sizeof(coef));
        const Huffman& hd = dc[c.td];
        const Huffman& ha = ac[c.ta];
        const int s = bits.decode(hd);
        if (s > 11) fail("corrupt entropy-coded data (DC magnitude)");
        const int diff = s ? extend(bits.get(s), s) : 0;
        c.pred += diff;
        coef[0] = static_cast<int16_t>(c.pred);
        for (int k = 1; k < 64;) {
            const int rs = bits.decode(ha);
            const int r = rs >> 4, sz = rs & 15;
            if (sz) {
                k += r;
                if (k > 63) fail("corrupt entropy-coded data (AC run)");
                coef[kZigzag[k]] =
                    static_cast<int16_t>(extend(bits.get(sz), sz));
                ++k;
            } else if (r == 15) {
                k += 16;
            } else {
                break;
            }
        }
        const int64_t stride = static_cast<int64_t>(c.bw) * 8;
        idct_islow(coef, quant[c.tq],
                   c.plane.data() + static_cast<int64_t>(by) * 8 * stride +
                       bx * 8,
                   stride);
    }

    int64_t read_scan(int64_t p, int64_t len) {
        const int ns = data[p];
        if (ns < 1 || ns > static_cast<int>(comps.size()) ||
            len < 6 + 2 * ns)
            fail("bad SOS");
        std::vector<Component*> sc;
        for (int i = 0; i < ns; ++i) {
            const int id = data[p + 1 + 2 * i];
            Component* found = nullptr;
            for (auto& c : comps)
                if (c.id == id) found = &c;
            if (!found) fail("scan names an unknown component");
            found->td = data[p + 2 + 2 * i] >> 4;
            found->ta = data[p + 2 + 2 * i] & 15;
            if (found->td > 3 || found->ta > 3 || !dc[found->td].defined ||
                !ac[found->ta].defined)
                fail("scan uses an undefined Huffman table");
            if (!quant_defined[found->tq])
                fail("component uses an undefined quantisation table");
            sc.push_back(found);
        }
        const int ss = data[p + 1 + 2 * ns], se = data[p + 2 + 2 * ns],
                  ahal = data[p + 3 + 2 * ns];
        if (ss != 0 || se != 63 || ahal != 0)
            fail("spectral selection or successive approximation in a "
                 "sequential file");
        Bits bits{data, n, p + len - 2};
        for (auto* c : sc) c->pred = 0;
        int64_t units, ux;
        if (ns == 1) {
            ux = (sc[0]->width + 7) / 8;
            units = ux * ((sc[0]->height + 7) / 8);
        } else {
            ux = mcux;
            units = static_cast<int64_t>(mcux) * mcuy;
        }
        int rst = 0;
        for (int64_t u = 0; u < units; ++u) {
            if (restart_interval && u && u % restart_interval == 0) {
                bits.restart(rst);
                rst = (rst + 1) & 7;
                for (auto* c : sc) c->pred = 0;
            }
            const int mx = static_cast<int>(u % ux),
                      my = static_cast<int>(u / ux);
            if (ns == 1) {
                decode_block(bits, *sc[0], mx, my);
            } else {
                for (auto* c : sc)
                    for (int yy = 0; yy < c->v; ++yy)
                        for (int xx = 0; xx < c->h; ++xx)
                            decode_block(bits, *c, mx * c->h + xx,
                                         my * c->v + yy);
            }
        }
        // skip to the next marker
        int64_t q = bits.pos;
        while (q + 1 < n && !(data[q] == 0xFF && data[q + 1] != 0x00 &&
                              !(data[q + 1] >= 0xD0 && data[q + 1] <= 0xD7)))
            ++q;
        return q;
    }

    // EXIF orientation (tag 0x0112) of an APP1 segment; 1 when absent
    int exif_orientation(int64_t p, int64_t len) const {
        if (len < 14 || std::memcmp(data + p, "Exif\0\0", 6) != 0) return 1;
        const uint8_t* t = data + p + 6;
        const int64_t tn = len - 8;
        const bool le = t[0] == 'I';
        auto rd16 = [&](int64_t o) -> int {
            if (o + 2 > tn) return -1;
            return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1];
        };
        auto rd32 = [&](int64_t o) -> int64_t {
            if (o + 4 > tn) return -1;
            return le ? (int64_t(t[o]) | (t[o + 1] << 8) | (t[o + 2] << 16) |
                         (int64_t(t[o + 3]) << 24))
                      : ((int64_t(t[o]) << 24) | (t[o + 1] << 16) |
                         (t[o + 2] << 8) | t[o + 3]);
        };
        const int64_t ifd = rd32(4);
        const int count = ifd < 0 ? -1 : rd16(ifd);
        for (int i = 0; i < count; ++i) {
            const int64_t e = ifd + 2 + 12 * i;
            if (rd16(e) == 0x0112) {
                const int v = rd16(e + 8);
                return v < 0 ? 1 : v;
            }
        }
        return 1;
    }

    void parse() {
        if (n < 4 || data[0] != 0xFF || data[1] != 0xD8)
            fail("not a JPEG file");
        int64_t p = 2;
        while (p < n) {
            if (data[p] != 0xFF) {
                ++p;  // stray byte (libjpeg warns and skips)
                continue;
            }
            int marker = data[p + 1];
            if (marker == 0xFF) {
                ++p;
                continue;
            }
            p += 2;
            if (marker == 0xD9) {
                ended = true;
                return;
            }
            if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01)
                continue;
            const int len = u16(p);
            if (len < 2 || p + len > n) fail("truncated marker segment");
            const int64_t body = p + 2;
            if (marker == 0xDB) {
                read_dqt(body, p + len);
            } else if (marker == 0xC4) {
                read_dht(body, p + len);
            } else if (marker == 0xDD) {
                restart_interval = u16(body);
            } else if (marker == 0xDC) {
                fail("a height defined by a DNL marker is not supported");
            } else if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 &&
                       marker != 0xC8 && marker != 0xCC) {
                read_sof(body, marker);
            } else if (marker == 0xCC) {
                fail("arithmetic-coded JPEG files are not supported");
            } else if (marker == 0xE1) {
                const int o = exif_orientation(body, len);
                if (o != 1)
                    fail("EXIF orientation " + std::to_string(o) +
                         " is not supported (1 only)");
            } else if (marker == 0xEE) {
                if (len >= 14 && std::memcmp(data + body, "Adobe", 5) == 0) {
                    const int transform = data[body + 11];
                    if (transform == 0 && comps.size() != 1) adobe_rgb = true;
                    if (transform == 2)
                        fail("YCCK JPEG files are not supported");
                }
            } else if (marker == 0xDA) {
                if (!frame) fail("scan before the frame header");
                if (adobe_rgb && comps.size() == 3)
                    fail("RGB-coded JPEG files are not supported");
                p = read_scan(body, len);
                continue;
            }
            p += len;
        }
    }
};

inline uint8_t clamp255(int v) {
    return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// one component upsampled to the full image (width x height), as
// jdsample.c does it with do_fancy_upsampling on
void upsample(const Component& c, int hmax, int vmax, int width, int height,
              std::vector<uint8_t>& out) {
    out.assign(static_cast<size_t>(width) * height, 0);
    const int64_t stride = static_cast<int64_t>(c.bw) * 8;
    const uint8_t* in = c.plane.data();
    const int hr = hmax / c.h, vr = vmax / c.v;
    const int cw = c.width, ch = c.height;
    // the row above the first is the first, the row below the last the
    // last (jdmainct.c's context pointers)
    auto row = [&](int r) -> const uint8_t* {
        if (r < 0) r = 0;
        if (r > ch - 1) r = ch - 1;
        return in + r * stride;
    };
    std::vector<uint8_t> tmp(static_cast<size_t>(2 * cw + 2));
    for (int y = 0; y < height; ++y) {
        uint8_t* o = out.data() + static_cast<int64_t>(y) * width;
        if (hr == 1 && vr == 1) {
            std::memcpy(o, row(y), width);
        } else if (hr == 2 && vr == 1 && cw > 2) {  // h2v1_fancy_upsample
            const uint8_t* ip = row(y);
            uint8_t* t = tmp.data();
            t[0] = ip[0];
            t[1] = static_cast<uint8_t>((ip[0] * 3 + ip[1] + 2) >> 2);
            for (int x = 1; x < cw - 1; ++x) {
                const int v = ip[x] * 3;
                t[2 * x] = static_cast<uint8_t>((v + ip[x - 1] + 1) >> 2);
                t[2 * x + 1] = static_cast<uint8_t>((v + ip[x + 1] + 2) >> 2);
            }
            t[2 * cw - 2] =
                static_cast<uint8_t>((ip[cw - 1] * 3 + ip[cw - 2] + 1) >> 2);
            t[2 * cw - 1] = ip[cw - 1];
            std::memcpy(o, t, width);
        } else if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
            const int r = y >> 1;
            const uint8_t* i0 = row(r);
            const uint8_t* i1 = (y & 1) ? row(r + 1) : row(r - 1);
            const int bias = (y & 1) ? 2 : 1;
            for (int x = 0; x < width; ++x)
                o[x] = static_cast<uint8_t>((i0[x] * 3 + i1[x] + bias) >> 2);
        } else if (hr == 2 && vr == 2 && cw > 2) {  // h2v2_fancy_upsample
            const int r = y >> 1;
            const uint8_t* i0 = row(r);
            const uint8_t* i1 = (y & 1) ? row(r + 1) : row(r - 1);
            uint8_t* t = tmp.data();
            int last = i0[0] * 3 + i1[0];
            int cur = last;
            int next = i0[1] * 3 + i1[1];
            t[0] = static_cast<uint8_t>((cur * 4 + 8) >> 4);
            t[1] = static_cast<uint8_t>((cur * 3 + next + 7) >> 4);
            last = cur;
            cur = next;
            for (int x = 1; x < cw - 1; ++x) {
                next = i0[x + 1] * 3 + i1[x + 1];
                t[2 * x] = static_cast<uint8_t>((cur * 3 + last + 8) >> 4);
                t[2 * x + 1] = static_cast<uint8_t>((cur * 3 + next + 7) >> 4);
                last = cur;
                cur = next;
            }
            t[2 * cw - 2] = static_cast<uint8_t>((cur * 3 + last + 8) >> 4);
            t[2 * cw - 1] = static_cast<uint8_t>((cur * 4 + 7) >> 4);
            std::memcpy(o, t, width);
        } else {  // box replication (h2v1_upsample, h2v2_upsample)
            const uint8_t* ip = row(y / vr);
            for (int x = 0; x < width; ++x) o[x] = ip[x / hr];
        }
    }
}

// jdcolor.c's ycc_rgb_convert tables
struct YccTables {
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    YccTables() {
        const int SCALEBITS = 16;
        const int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
        auto fix = [](double x) {
            return static_cast<int64_t>(x * (1L << 16) + 0.5);
        };
        for (int i = 0, x = -128; i <= 255; ++i, ++x) {
            cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >>
                                       SCALEBITS);
            cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >>
                                       SCALEBITS);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + ONE_HALF;
        }
    }
};

// ------------------------------------------------------------ encoder
const uint8_t kStdLuma[64] = {  // Annex K.1, zigzag order
    16, 11, 12, 14, 12, 10, 16, 14, 13, 14, 18, 17, 16, 19, 24, 40,
    26, 24, 22, 22, 24, 49, 35, 37, 29, 40, 58, 51, 61, 60, 57, 51,
    56, 55, 64, 72, 92, 78, 64, 68, 87, 69, 55, 56, 80, 109, 81, 87,
    95, 98, 103, 104, 103, 62, 77, 113, 121, 112, 100, 120, 92, 101, 103, 99};
const uint8_t kStdChroma[64] = {
    17, 18, 18, 24, 21, 24, 47, 26, 26, 47, 99, 66, 56, 66, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3: bits (counts of codes of lengths 1..16), then values
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125};
const uint8_t kAcLumaVals[162] = {
    1, 2, 3, 0, 4, 17, 5, 18, 33, 49, 65, 6, 19, 81, 97, 7, 34, 113, 20, 50,
    129, 145, 161, 8, 35, 66, 177, 193, 21, 82, 209, 240, 36, 51, 98, 114,
    130, 9, 10, 22, 23, 24, 25, 26, 37, 38, 39, 40, 41, 42, 52, 53, 54, 55,
    56, 57, 58, 67, 68, 69, 70, 71, 72, 73, 74, 83, 84, 85, 86, 87, 88, 89,
    90, 99, 100, 101, 102, 103, 104, 105, 106, 115, 116, 117, 118, 119, 120,
    121, 122, 131, 132, 133, 134, 135, 136, 137, 138, 146, 147, 148, 149,
    150, 151, 152, 153, 154, 162, 163, 164, 165, 166, 167, 168, 169, 170,
    178, 179, 180, 181, 182, 183, 184, 185, 186, 194, 195, 196, 197, 198,
    199, 200, 201, 202, 210, 211, 212, 213, 214, 215, 216, 217, 218, 225,
    226, 227, 228, 229, 230, 231, 232, 233, 234, 241, 242, 243, 244, 245,
    246, 247, 248, 249, 250};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119};
const uint8_t kAcChromaVals[162] = {
    0, 1, 2, 3, 17, 4, 5, 33, 49, 6, 18, 65, 81, 7, 97, 113, 19, 34, 50, 129,
    8, 20, 66, 145, 161, 177, 193, 9, 35, 51, 82, 240, 21, 98, 114, 209, 10,
    22, 36, 52, 225, 37, 241, 23, 24, 25, 26, 38, 39, 40, 41, 42, 53, 54, 55,
    56, 57, 58, 67, 68, 69, 70, 71, 72, 73, 74, 83, 84, 85, 86, 87, 88, 89,
    90, 99, 100, 101, 102, 103, 104, 105, 106, 115, 116, 117, 118, 119, 120,
    121, 122, 130, 131, 132, 133, 134, 135, 136, 137, 138, 146, 147, 148,
    149, 150, 151, 152, 153, 154, 162, 163, 164, 165, 166, 167, 168, 169,
    170, 178, 179, 180, 181, 182, 183, 184, 185, 186, 194, 195, 196, 197,
    198, 199, 200, 201, 202, 210, 211, 212, 213, 214, 215, 216, 217, 218,
    226, 227, 228, 229, 230, 231, 232, 233, 234, 242, 243, 244, 245, 246,
    247, 248, 249, 250};

struct Codes {
    uint16_t code[256];
    uint8_t len[256];
    Codes(const uint8_t bits[16], const uint8_t* vals) {
        std::memset(len, 0, sizeof(len));
        int c = 0, k = 0;
        for (int l = 1; l <= 16; ++l) {
            for (int i = 0; i < bits[l - 1]; ++i, ++k, ++c) {
                code[vals[k]] = static_cast<uint16_t>(c);
                len[vals[k]] = static_cast<uint8_t>(l);
            }
            c <<= 1;
        }
    }
};

struct Writer {
    std::vector<uint8_t> out;
    uint32_t acc = 0;
    int nbits = 0;
    void byte(int b) { out.push_back(static_cast<uint8_t>(b)); }
    void word(int w) {
        byte(w >> 8);
        byte(w & 0xFF);
    }
    void put(uint32_t v, int k) {
        acc = (acc << k) | (v & ((1u << k) - 1));
        nbits += k;
        while (nbits >= 8) {
            const int b = (acc >> (nbits - 8)) & 0xFF;
            byte(b);
            if (b == 0xFF) byte(0);
            nbits -= 8;
        }
    }
    void flush() {
        if (nbits) put(0x7F, 8 - nbits);  // pad with ones
    }
};

// jfdctint.c: the integer forward DCT, results scaled up by 8
void fdct_islow(int* d) {
    for (int r = 0; r < 8; ++r) {
        int* p = d + 8 * r;
        const int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
        const int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
        const int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
        const int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
        const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        p[0] = static_cast<int>((tmp10 + tmp11) * (1 << PASS1_BITS));
        p[4] = static_cast<int>((tmp10 - tmp11) * (1 << PASS1_BITS));
        const int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
        const int s = CONST_BITS - PASS1_BITS;
        p[2] = static_cast<int>(descale(z1 + tmp13 * FIX_0_765366865, s));
        p[6] = static_cast<int>(descale(z1 + tmp12 * -FIX_1_847759065, s));
        int64_t y1 = tmp4 + tmp7, y2 = tmp5 + tmp6, y3 = tmp4 + tmp6,
                y4 = tmp5 + tmp7;
        const int64_t z5 = (y3 + y4) * FIX_1_175875602;
        const int64_t t4 = tmp4 * FIX_0_298631336, t5 = tmp5 * FIX_2_053119869,
                      t6 = tmp6 * FIX_3_072711026, t7 = tmp7 * FIX_1_501321110;
        y1 *= -FIX_0_899976223;
        y2 *= -FIX_2_562915447;
        y3 = y3 * -FIX_1_961570560 + z5;
        y4 = y4 * -FIX_0_390180644 + z5;
        p[7] = static_cast<int>(descale(t4 + y1 + y3, s));
        p[5] = static_cast<int>(descale(t5 + y2 + y4, s));
        p[3] = static_cast<int>(descale(t6 + y2 + y3, s));
        p[1] = static_cast<int>(descale(t7 + y1 + y4, s));
    }
    for (int c = 0; c < 8; ++c) {
        int* p = d + c;
        const int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
        const int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
        const int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
        const int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
        const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        p[0] = static_cast<int>(descale(tmp10 + tmp11, PASS1_BITS));
        p[32] = static_cast<int>(descale(tmp10 - tmp11, PASS1_BITS));
        const int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
        const int s = CONST_BITS + PASS1_BITS;
        p[16] = static_cast<int>(descale(z1 + tmp13 * FIX_0_765366865, s));
        p[48] = static_cast<int>(descale(z1 + tmp12 * -FIX_1_847759065, s));
        int64_t y1 = tmp4 + tmp7, y2 = tmp5 + tmp6, y3 = tmp4 + tmp6,
                y4 = tmp5 + tmp7;
        const int64_t z5 = (y3 + y4) * FIX_1_175875602;
        const int64_t t4 = tmp4 * FIX_0_298631336, t5 = tmp5 * FIX_2_053119869,
                      t6 = tmp6 * FIX_3_072711026, t7 = tmp7 * FIX_1_501321110;
        y1 *= -FIX_0_899976223;
        y2 *= -FIX_2_562915447;
        y3 = y3 * -FIX_1_961570560 + z5;
        y4 = y4 * -FIX_0_390180644 + z5;
        p[56] = static_cast<int>(descale(t4 + y1 + y3, s));
        p[40] = static_cast<int>(descale(t5 + y2 + y4, s));
        p[24] = static_cast<int>(descale(t6 + y2 + y3, s));
        p[8] = static_cast<int>(descale(t7 + y1 + y4, s));
    }
}

// one 8x8 block of `plane` (row stride `stride`) at (bx, by): level shift,
// forward DCT, quantisation (divisor 8 q, rounded half away from zero as
// jcdctmgr.c), Huffman coding
void encode_block(Writer& w, const uint8_t* plane, int64_t stride, int bx,
                  int by, const int* q, int& pred, const Codes& dcc,
                  const Codes& acc) {
    int d[64];
    for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 8; ++c)
            d[8 * r + c] = plane[(by * 8 + r) * stride + bx * 8 + c] - 128;
    fdct_islow(d);
    int zz[64];
    for (int k = 0; k < 64; ++k) {
        const int i = kZigzag[k];
        const int div = 8 * q[i];
        int t = d[i];
        if (t < 0) {
            t = -((-t + (div >> 1)) / div);
        } else {
            t = (t + (div >> 1)) / div;
        }
        zz[k] = t;
    }
    auto bits_of = [](int v) {
        int a = v < 0 ? -v : v, s = 0;
        while (a) {
            ++s;
            a >>= 1;
        }
        return s;
    };
    const int diff = zz[0] - pred;
    pred = zz[0];
    int s = bits_of(diff);
    w.put(dcc.code[s], dcc.len[s]);
    if (s) w.put(diff < 0 ? diff - 1 : diff, s);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
        const int v = zz[k];
        if (!v) {
            ++run;
            continue;
        }
        while (run > 15) {
            w.put(acc.code[0xF0], acc.len[0xF0]);
            run -= 16;
        }
        s = bits_of(v);
        const int rs = (run << 4) | s;
        w.put(acc.code[rs], acc.len[rs]);
        w.put(v < 0 ? v - 1 : v, s);
        run = 0;
    }
    if (run) w.put(acc.code[0], acc.len[0]);
}

// a plane padded to (bh*8) x (bw*8) by replicating its last column and row
std::vector<uint8_t> pad_plane(const std::vector<uint8_t>& p, int w, int h,
                               int pw, int ph) {
    std::vector<uint8_t> o(static_cast<size_t>(pw) * ph);
    for (int y = 0; y < ph; ++y) {
        const uint8_t* src = p.data() + static_cast<int64_t>(std::min(y, h - 1)) * w;
        uint8_t* dst = o.data() + static_cast<int64_t>(y) * pw;
        std::memcpy(dst, src, w);
        for (int x = w; x < pw; ++x) dst[x] = src[w - 1];
    }
    return o;
}

thread_local std::string g_error;
thread_local std::vector<uint8_t> g_encoded;

}  // namespace

extern "C" {

// The message of the last call that failed.
const char* jpeg_last_error() { return g_error.c_str(); }

// Frame size and component count of a JPEG file (0), or -1 (see
// jpeg_last_error).
int jpeg_info(const uint8_t* data, int64_t n, int* width, int* height,
              int* components) {
    try {
        Decoder d{data, n};
        if (n < 4 || data[0] != 0xFF || data[1] != 0xD8)
            fail("not a JPEG file");
        int64_t p = 2;
        while (p + 3 < n && !d.frame) {
            if (data[p] != 0xFF) {
                ++p;
                continue;
            }
            const int marker = data[p + 1];
            if (marker == 0xFF || marker == 0xD8 || marker == 0x01 ||
                (marker >= 0xD0 && marker <= 0xD7)) {
                p += marker == 0xFF ? 1 : 2;
                continue;
            }
            const int len = d.u16(p + 2);
            if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 &&
                marker != 0xC8 && marker != 0xCC)
                d.read_sof(p + 4, marker);
            p += 2 + len;
        }
        if (!d.frame) fail("no frame header");
        *width = d.width;
        *height = d.height;
        *components = static_cast<int>(d.comps.size());
        return 0;
    } catch (const Error& e) {
        g_error = e.what;
        return -1;
    }
}

// Decode into out: height x width x 3 bytes in BGR order (a grey file's
// sample in all three), as cv2.imread(path, IMREAD_COLOR) gives. 0, or -1
// (see jpeg_last_error).
int jpeg_decode_bgr(const uint8_t* data, int64_t n, uint8_t* out,
                    int width, int height) {
    try {
        Decoder d{data, n};
        d.parse();
        if (!d.frame) fail("no frame header");
        if (d.width != width || d.height != height)
            fail("frame size differs from the one asked for");
        std::vector<std::vector<uint8_t>> full(d.comps.size());
        for (size_t i = 0; i < d.comps.size(); ++i)
            upsample(d.comps[i], d.hmax, d.vmax, width, height, full[i]);
        const int64_t npx = static_cast<int64_t>(width) * height;
        if (d.comps.size() == 1) {
            for (int64_t i = 0; i < npx; ++i)
                out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = full[0][i];
            return 0;
        }
        static const YccTables t;
        for (int64_t i = 0; i < npx; ++i) {
            const int y = full[0][i], cb = full[1][i], cr = full[2][i];
            out[3 * i + 2] = clamp255(y + t.cr_r[cr]);
            out[3 * i + 1] = clamp255(
                y + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16));
            out[3 * i + 0] = clamp255(y + t.cb_b[cb]);
        }
        return 0;
    } catch (const Error& e) {
        g_error = e.what;
        return -1;
    }
}

// Encode a BGR uint8 image (height x width x 3) at `quality` (1-100).
// Returns the byte count of the file, which jpeg_encoded copies out, or -1
// (see jpeg_last_error).
int64_t jpeg_encode(const uint8_t* img, int width, int height, int quality) {
    const int channels = 3, hmax = 2;
    try {
        if (width < 1 || height < 1 || width > 65535 || height > 65535)
            fail("image size out of range");
        if (quality < 1) quality = 1;
        if (quality > 100) quality = 100;
        const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
        int qz[2][64];  // zigzag order, as written
        int qn[2][64];  // natural order, for quantising
        for (int t = 0; t < 2; ++t)
            for (int k = 0; k < 64; ++k) {
                const int base = t ? kStdChroma[k] : kStdLuma[k];
                int v = (base * scale + 50) / 100;
                v = v < 1 ? 1 : (v > 255 ? 255 : v);
                qz[t][k] = v;
                qn[t][kZigzag[k]] = v;
            }
        const int64_t npx = static_cast<int64_t>(width) * height;
        std::vector<std::vector<uint8_t>> planes;
        {  // jccolor.c rgb_ycc_convert
            const int64_t ONE_HALF = 1 << 15, CBCR_OFFSET = int64_t(128) << 16;
            auto fix = [](double x) {
                return static_cast<int64_t>(x * (1L << 16) + 0.5);
            };
            std::vector<uint8_t> Y(npx), Cb(npx), Cr(npx);
            for (int64_t i = 0; i < npx; ++i) {
                const int b = img[3 * i], g = img[3 * i + 1], r = img[3 * i + 2];
                Y[i] = static_cast<uint8_t>(
                    (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b +
                     ONE_HALF) >> 16);
                Cb[i] = static_cast<uint8_t>(
                    (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b +
                     CBCR_OFFSET + ONE_HALF - 1) >> 16);
                Cr[i] = static_cast<uint8_t>(
                    (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b +
                     CBCR_OFFSET + ONE_HALF - 1) >> 16);
            }
            planes.push_back(std::move(Y));
            planes.push_back(std::move(Cb));
            planes.push_back(std::move(Cr));
        }
        const int mcux = (width + 8 * hmax - 1) / (8 * hmax);
        const int mcuy = (height + 8 * hmax - 1) / (8 * hmax);
        // the padded planes: luma at the MCU-padded size, chroma averaged
        // 2 x 2 from it (jcsample.c h2v2_downsample, bias 1, 2, 1, 2 ...)
        std::vector<std::vector<uint8_t>> padded;
        const int pw = mcux * 8 * hmax, ph = mcuy * 8 * hmax;
        for (size_t c = 0; c < planes.size(); ++c) {
            std::vector<uint8_t> p = pad_plane(planes[c], width, height, pw, ph);
            if (c == 0) {
                padded.push_back(std::move(p));
                continue;
            }
            std::vector<uint8_t> s(static_cast<size_t>(pw / 2) * (ph / 2));
            for (int y = 0; y < ph / 2; ++y) {
                int bias = 1;
                for (int x = 0; x < pw / 2; ++x) {
                    const uint8_t* a = p.data() + (2 * y) * int64_t(pw) + 2 * x;
                    s[y * int64_t(pw / 2) + x] = static_cast<uint8_t>(
                        (a[0] + a[1] + a[pw] + a[pw + 1] + bias) >> 2);
                    bias ^= 3;
                }
            }
            padded.push_back(std::move(s));
        }
        Writer w;
        w.word(0xFFD8);
        w.word(0xFFE0);  // JFIF APP0
        w.word(16);
        const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
        for (uint8_t b : jfif) w.byte(b);
        for (int t = 0; t < 2; ++t) {
            w.word(0xFFDB);
            w.word(67);
            w.byte(t);
            for (int k = 0; k < 64; ++k) w.byte(qz[t][k]);
        }
        w.word(0xFFC0);
        w.word(8 + 3 * channels);
        w.byte(8);
        w.word(height);
        w.word(width);
        w.byte(channels);
        for (int c = 0; c < channels; ++c) {
            w.byte(c + 1);
            w.byte(c == 0 ? 0x22 : 0x11);
            w.byte(c == 0 ? 0 : 1);
        }
        auto dht = [&](int cls, int id, const uint8_t* bits, const uint8_t* vals) {
            int total = 0;
            for (int i = 0; i < 16; ++i) total += bits[i];
            w.word(0xFFC4);
            w.word(19 + total);
            w.byte((cls << 4) | id);
            for (int i = 0; i < 16; ++i) w.byte(bits[i]);
            for (int i = 0; i < total; ++i) w.byte(vals[i]);
        };
        dht(0, 0, kDcLumaBits, kDcVals);
        dht(1, 0, kAcLumaBits, kAcLumaVals);
        dht(0, 1, kDcChromaBits, kDcVals);
        dht(1, 1, kAcChromaBits, kAcChromaVals);
        w.word(0xFFDA);
        w.word(6 + 2 * channels);
        w.byte(channels);
        for (int c = 0; c < channels; ++c) {
            w.byte(c + 1);
            w.byte(c == 0 ? 0x00 : 0x11);
        }
        w.byte(0);
        w.byte(63);
        w.byte(0);
        static const Codes dcl(kDcLumaBits, kDcVals), acl(kAcLumaBits, kAcLumaVals),
            dcc(kDcChromaBits, kDcVals), acc(kAcChromaBits, kAcChromaVals);
        int pred[3] = {0, 0, 0};
        for (int my = 0; my < mcuy; ++my)
            for (int mx = 0; mx < mcux; ++mx) {
                for (int yy = 0; yy < hmax; ++yy)
                    for (int xx = 0; xx < hmax; ++xx)
                        encode_block(w, padded[0].data(), pw, mx * hmax + xx,
                                     my * hmax + yy, qn[0], pred[0], dcl, acl);
                for (int c = 1; c < channels; ++c)
                    encode_block(w, padded[c].data(), pw / 2, mx, my, qn[1],
                                 pred[c], dcc, acc);
            }
        w.flush();
        w.word(0xFFD9);
        g_encoded.swap(w.out);
        return static_cast<int64_t>(g_encoded.size());
    } catch (const Error& e) {
        g_error = e.what;
        return -1;
    }
}

// Copy out the bytes of the last jpeg_encode of this thread.
void jpeg_encoded(uint8_t* out) {
    std::memcpy(out, g_encoded.data(), g_encoded.size());
}

}  // extern "C"
