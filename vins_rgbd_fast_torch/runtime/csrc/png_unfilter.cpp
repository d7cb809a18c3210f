// PNG scanline unfiltering (the five filter types of the PNG spec, ISO/IEC
// 15948 §9) for the port's PNG decoder (io/images.py decode_png).
//
// Average and Paeth predict each byte from the byte already reconstructed
// to its left, a sequential dependency along the row that numpy cannot
// vectorise: in Python a 640x480 RGB frame of Paeth rows takes seconds,
// here milliseconds.  All five types run here so a frame is one call.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 png_unfilter.cpp -o libvins_png.so

#include <cstdint>
#include <cstdlib>

extern "C" {

// raw: height rows of (1 filter byte + stride bytes), as inflated from the
// IDAT stream; out: height * stride bytes.  bpp: bytes per complete pixel
// (at least 1).  Returns 0, or -(row + 1) for a row with an unknown filter.
int vins_png_unfilter(const uint8_t* raw, int height, int stride, int bpp, uint8_t* out) {
    for (int y = 0; y < height; ++y) {
        const uint8_t filt = raw[(size_t)y * (stride + 1)];
        const uint8_t* in = raw + (size_t)y * (stride + 1) + 1;
        uint8_t* cur = out + (size_t)y * stride;
        const uint8_t* prev = y > 0 ? out + (size_t)(y - 1) * stride : nullptr;
        const int lead = bpp < stride ? bpp : stride;  // bytes with no left neighbour
        switch (filt) {
            case 0:
                for (int x = 0; x < stride; ++x) cur[x] = in[x];
                break;
            case 1:  // Sub
                for (int x = 0; x < lead; ++x) cur[x] = in[x];
                for (int x = lead; x < stride; ++x) cur[x] = (uint8_t)(in[x] + cur[x - bpp]);
                break;
            case 2:  // Up
                for (int x = 0; x < stride; ++x) cur[x] = (uint8_t)(in[x] + (prev ? prev[x] : 0));
                break;
            case 3:  // Average
                for (int x = 0; x < stride; ++x) {
                    const int a = x >= bpp ? cur[x - bpp] : 0;
                    const int b = prev ? prev[x] : 0;
                    cur[x] = (uint8_t)(in[x] + ((a + b) >> 1));
                }
                break;
            case 4:  // Paeth
                for (int x = 0; x < stride; ++x) {
                    const int a = x >= bpp ? cur[x - bpp] : 0;
                    const int b = prev ? prev[x] : 0;
                    const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
                    const int p = a + b - c;
                    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
                    cur[x] = (uint8_t)(in[x] + ((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c)));
                }
                break;
            default:
                return -(y + 1);
        }
    }
    return 0;
}

}  // extern "C"
