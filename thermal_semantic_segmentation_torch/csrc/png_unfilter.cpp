// PNG scanline unfiltering (the PNG specification, section 9: filter
// method 0, types None, Sub, Up, Average and Paeth), for the port's PNG
// reader (data/png.py). Sub, Average and Paeth read the byte one pixel to
// the left in the row being rebuilt, so a row is a sequential loop; the
// reader calls this once a pass with the GIL released.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 png_unfilter.cpp -o libpng_unfilter.so
// (the standard library only).

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// src: rows * (1 + row_bytes) bytes, each row its filter type byte then its
// filtered bytes; dst: rows * row_bytes bytes. bpp: bytes a complete pixel
// (at least 1). The row before the first is zero. Returns rows, or
// -(1 + r) for the first row r whose filter type is not 0..4 (dst then
// holds the rows before it).
long tss_png_unfilter(const uint8_t* src, uint8_t* dst, long rows,
                      long row_bytes, int bpp) {
  const uint8_t* prior = nullptr;
  for (long r = 0; r < rows; ++r) {
    const uint8_t* in = src + r * (row_bytes + 1);
    const uint8_t type = *in++;
    uint8_t* out = dst + r * row_bytes;
    switch (type) {
      case 0:
        std::memcpy(out, in, row_bytes);
        break;
      case 1:
        for (long i = 0; i < row_bytes; ++i)
          out[i] = in[i] + (i >= bpp ? out[i - bpp] : 0);
        break;
      case 2:
        for (long i = 0; i < row_bytes; ++i)
          out[i] = in[i] + (prior ? prior[i] : 0);
        break;
      case 3:
        for (long i = 0; i < row_bytes; ++i) {
          const int left = i >= bpp ? out[i - bpp] : 0;
          const int up = prior ? prior[i] : 0;
          out[i] = in[i] + ((left + up) >> 1);
        }
        break;
      case 4:
        for (long i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = prior ? prior[i] : 0;
          const int c = (prior && i >= bpp) ? prior[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = in[i] + pred;
        }
        break;
      default:
        return -(1 + r);
    }
    prior = out;
  }
  return rows;
}

}  // extern "C"
