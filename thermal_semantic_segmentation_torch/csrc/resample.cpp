// One pass of PIL's convolution resampling (Pillow's Resample.c) for the
// port's data/image.py: along the middle axis of an (outer, in_len, inner)
// array, out[a, o, j] = sum over t < count[o] of in[a, xmin[o] + t, j] *
// k[o * ksize + t], the sum taken tap by tap in order, as PIL takes it. A
// horizontal pass is (rows, width, channels), a vertical one (1, height,
// width * channels). The weights come from data/image.coefficients.
//
//   8-bit ('L', 'RGB'): int weights in 22-bit fixed point, the sum started
//     at 2^21 in 32-bit ints, stored clip(sum >> 22, 0, 255);
//   'F': float64 sums, stored as float;
//   'I': float64 sums, rounded half away from zero;
//   'I;16': that rounded sum's low byte and high byte, each clipped to
//     0..255 (a sum over 65535 keeps its low byte under 0xFF).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 resample.cpp -o libresample.so
// (the standard library only; no -ffast-math: the sums stay IEEE).

#include <cstdint>
#include <vector>

namespace {

template <typename In, typename Out, typename K, typename Acc, typename Store>
void pass(const In* in, Out* out, long outer, long in_len, long out_len,
          long inner, const long* xmin, const long* count, const K* k,
          long ksize, Acc init, Store store) {
  std::vector<Acc> acc(inner);
  for (long a = 0; a < outer; ++a) {
    const In* src = in + a * in_len * inner;
    Out* dst = out + a * out_len * inner;
    for (long o = 0; o < out_len; ++o) {
      const K* ko = k + o * ksize;
      const long n = count[o];
      const In* base = src + xmin[o] * inner;
      if (inner <= 4) {  // narrow rows (a horizontal pass): a sum a sample
        for (long j = 0; j < inner; ++j) {
          Acc ss = init;
          for (long t = 0; t < n; ++t) ss += base[t * inner + j] * ko[t];
          dst[o * inner + j] = store(ss);
        }
        continue;
      }
      // wide rows (a vertical pass): whole rows, tap by tap
      for (long j = 0; j < inner; ++j) acc[j] = init;
      for (long t = 0; t < n; ++t) {
        const In* row = base + t * inner;
        const K w = ko[t];
        for (long j = 0; j < inner; ++j) acc[j] += row[j] * w;
      }
      for (long j = 0; j < inner; ++j) dst[o * inner + j] = store(acc[j]);
    }
  }
}

inline int round_up(double ss) {  // Resample.c ROUND_UP
  return static_cast<int>(ss >= 0.0 ? ss + 0.5 : ss - 0.5);
}

inline int clip8(int v) { return v <= 0 ? 0 : (v < 256 ? v : 255); }

}  // namespace

extern "C" {

void tss_resample_u8(const uint8_t* in, uint8_t* out, long outer,
                     long in_len, long out_len, long inner,
                     const long* xmin, const long* count, const int32_t* k,
                     long ksize) {
  pass(in, out, outer, in_len, out_len, inner, xmin, count, k, ksize,
       int32_t{1} << 21,
       [](int32_t ss) { return static_cast<uint8_t>(clip8(ss >> 22)); });
}

void tss_resample_f32(const float* in, float* out, long outer, long in_len,
                      long out_len, long inner, const long* xmin,
                      const long* count, const double* k, long ksize) {
  pass(in, out, outer, in_len, out_len, inner, xmin, count, k, ksize, 0.0,
       [](double ss) { return static_cast<float>(ss); });
}

void tss_resample_i32(const int32_t* in, int32_t* out, long outer,
                      long in_len, long out_len, long inner,
                      const long* xmin, const long* count, const double* k,
                      long ksize) {
  pass(in, out, outer, in_len, out_len, inner, xmin, count, k, ksize, 0.0,
       [](double ss) { return static_cast<int32_t>(round_up(ss)); });
}

void tss_resample_u16(const uint16_t* in, uint16_t* out, long outer,
                      long in_len, long out_len, long inner,
                      const long* xmin, const long* count, const double* k,
                      long ksize) {
  pass(in, out, outer, in_len, out_len, inner, xmin, count, k, ksize, 0.0,
       [](double ss) {
         const int v = round_up(ss);
         return static_cast<uint16_t>(clip8(v >> 8) * 256 + clip8(v % 256));
       });
}

}  // extern "C"
