/* PNG scanline unfiltering (PNG spec section 9, filter method 0).
 *
 * The port decodes the glTF PNG textures itself (the machine that runs the
 * port on the GPU has no imaging library): zlib inflates the IDAT stream in
 * Python, and this function reverses the per-row filters, which is a
 * byte-serial recurrence (Paeth in particular) far too slow in Python for
 * the ~38 MB of the Sponza replica's textures.
 *
 * in:  height rows of (1 filter byte + stride data bytes)
 * out: height rows of stride bytes
 * bpp: bytes per complete pixel (>= 1)
 * Returns 0 on success, 1 + row index of the first row whose filter type
 * is not 0..4.
 */
#include <stdint.h>
#include <stdlib.h>

static inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    if (pb <= pc) return (uint8_t)b;
    return (uint8_t)c;
}

int png_unfilter(const uint8_t *in, uint8_t *out, int64_t height,
                 int64_t stride, int64_t bpp) {
    for (int64_t y = 0; y < height; ++y) {
        const uint8_t *src = in + y * (stride + 1);
        uint8_t ft = src[0];
        src += 1;
        uint8_t *dst = out + y * stride;
        const uint8_t *up = y > 0 ? out + (y - 1) * stride : NULL;
        for (int64_t i = 0; i < stride; ++i) {
            int a = i >= bpp ? dst[i - bpp] : 0;
            int b = up ? up[i] : 0;
            int c = (up && i >= bpp) ? up[i - bpp] : 0;
            int v = src[i];
            switch (ft) {
                case 0: break;
                case 1: v += a; break;
                case 2: v += b; break;
                case 3: v += (a + b) >> 1; break;
                case 4: v += paeth(a, b, c); break;
                default: return (int)(y + 1);
            }
            dst[i] = (uint8_t)v;
        }
    }
    return 0;
}
