// PNG row unfiltering (PNG specification, section 9 "Filtering"): undo the
// per-row filter of every row of a decompressed, non-interlaced image.
//
// Each input row is one filter-type byte followed by `row_bytes` filtered
// bytes; `bpp` is the number of bytes per complete pixel (at least 1).  The
// unfiltered rows, without their type bytes, go to `out`.  Average and
// Paeth depend on the byte just unfiltered to their left, so a row is a
// serial scan; rows depend on the row above.
//
// Returns 0, or -(r + 1) when row r has a filter type outside 0-4.

#include <cstdint>
#include <cstdlib>

static inline uint8_t paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    return static_cast<uint8_t>(pb <= pc ? b : c);
}

extern "C" int png_unfilter(const uint8_t* in, int64_t height, int64_t row_bytes, int bpp,
                            uint8_t* out) {
    for (int64_t r = 0; r < height; ++r) {
        const uint8_t type = in[r * (row_bytes + 1)];
        const uint8_t* src = in + r * (row_bytes + 1) + 1;
        uint8_t* dst = out + r * row_bytes;
        const uint8_t* up = r > 0 ? dst - row_bytes : nullptr;  // unfiltered row above
        switch (type) {
            case 0:
                for (int64_t i = 0; i < row_bytes; ++i) dst[i] = src[i];
                break;
            case 1:
                for (int64_t i = 0; i < row_bytes; ++i)
                    dst[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? dst[i - bpp] : 0));
                break;
            case 2:
                for (int64_t i = 0; i < row_bytes; ++i)
                    dst[i] = static_cast<uint8_t>(src[i] + (up ? up[i] : 0));
                break;
            case 3:
                for (int64_t i = 0; i < row_bytes; ++i) {
                    const int a = i >= bpp ? dst[i - bpp] : 0;
                    const int b = up ? up[i] : 0;
                    dst[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
                }
                break;
            case 4:
                for (int64_t i = 0; i < row_bytes; ++i) {
                    const int a = i >= bpp ? dst[i - bpp] : 0;
                    const int b = up ? up[i] : 0;
                    const int c = (up && i >= bpp) ? up[i - bpp] : 0;
                    dst[i] = static_cast<uint8_t>(src[i] + paeth(a, b, c));
                }
                break;
            default:
                return static_cast<int>(-(r + 1));
        }
    }
    return 0;
}
