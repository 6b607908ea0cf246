// PNG row filters undone (PNG specification, 2nd edition, section 9):
// the port's own source, read by catnerf_torch/data/png.py. A row's
// bytes depend on the reconstructed row above and the bytes `bpp` to
// their left, so rows are undone in order, left to right.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// raw: height rows of 1 + row_bytes bytes, each led by its filter type;
// out: height x row_bytes. Returns -1, or the first row whose filter type
// is not 0-4 (out is then undefined from that row on).
int64_t png_unfilter(const uint8_t* raw, int64_t height, int64_t row_bytes,
                     int bpp, uint8_t* out) {
    for (int64_t y = 0; y < height; ++y) {
        const uint8_t* f = raw + y * (row_bytes + 1) + 1;
        const int kind = f[-1];
        uint8_t* o = out + y * row_bytes;
        const uint8_t* up = y ? o - row_bytes : nullptr;
        switch (kind) {
        case 0:
            std::memcpy(o, f, row_bytes);
            break;
        case 1:
            for (int64_t i = 0; i < row_bytes; ++i)
                o[i] = f[i] + (i >= bpp ? o[i - bpp] : 0);
            break;
        case 2:
            for (int64_t i = 0; i < row_bytes; ++i)
                o[i] = f[i] + (up ? up[i] : 0);
            break;
        case 3:
            for (int64_t i = 0; i < row_bytes; ++i) {
                const int a = i >= bpp ? o[i - bpp] : 0;
                const int b = up ? up[i] : 0;
                o[i] = f[i] + ((a + b) >> 1);
            }
            break;
        case 4:
            for (int64_t i = 0; i < row_bytes; ++i) {
                const int a = i >= bpp ? o[i - bpp] : 0;
                const int b = up ? up[i] : 0;
                const int c = (up && i >= bpp) ? up[i - bpp] : 0;
                const int pa = std::abs(b - c), pb = std::abs(a - c),
                          pc = std::abs(a + b - 2 * c);
                const int pred = (pa <= pb && pa <= pc) ? a
                                 : (pb <= pc ? b : c);
                o[i] = f[i] + pred;
            }
            break;
        default:
            return y;
        }
    }
    return -1;
}

}  // extern "C"
