// Fused bilinear align-corners upsample + per-pixel argmax + max-softmax
// confidence, for NVIDIA Hopper (built for sm_90a).
//
// Replaces the TPU kernel thermal_semantic_segmentation_tpu/ops/pallas_kernels.py
// ::upsample_argmax (body _kernel). It computes the same function, not a copy
// of its blocks: the TPU kernel streams class planes through two dense MXU
// matmuls; here each output pixel reads 2-tap tables and loops over classes.
//
// Bound. At the serving shape (8, 33, 65, 13) -> 256x512 the kernel must read
// 0.9 MB of logits and write 8.4 MB (int32 id + f32 confidence per pixel):
// ~2.8 us at 3.35 TB/s. The upsampled (N, 256, 512, 13) float32 logits
// (~54 MB at batch 8) only ever live in registers. What keeps a simple
// design far from that bound is instructions, not bytes: one thread per
// pixel with 4 gathered loads and 2 expf per class issues ~300 instructions
// and 28 MUFU ops per pixel. This design cuts both:
//
// 1. One block per (image, tile of output rows, tile of output columns).
//    The host (kernels/upsample_argmax.py::launch_plan) picks the tile sizes
//    from the shapes so that the staged rows fit in 48 KB of shared memory.
// 2. Row interpolation is staged: the block's threads compute
//    (1-a)*x[lo] + a*x[hi] once per (output row, source column, class) into
//    shared memory, about 1/8 of the lerps at the serving shape (65 source
//    columns for 512 output columns). Offsets inside an image are 32-bit;
//    for an NHWC-contiguous view the staged columns of a source row are one
//    run of floats, read coalesced with no division per element. No TMA:
//    the logits (0.9 MB) stay in L2, and a row pitch of w*C floats (3380
//    bytes at the serving shape) is no multiple of 16 bytes, as a TMA
//    descriptor needs.
//    Layout s[row][source column][class], `pitch` floats per column, pitch a
//    multiple of 4 with pitch/4 odd: a thread reads a column's classes as
//    float4s, and the 8 threads of a quarter warp, on neighbouring or equal
//    columns, fall in distinct 16-byte bank groups or share one word.
// 3. Column interpolation reads shared memory with 32-bit offsets. Each
//    thread owns 4 consecutive output columns (and loops over rows of the
//    tile when the host plan gives it several): its taps come in as one
//    int4 / float4 each (tables padded to a multiple of 4 on the host) and
//    its ids and confidences go out as one int4 and one float4 where the 4
//    pixels are 16-byte aligned (out_w % 4 == 0), else as masked scalars.
// 4. One pass of exps. With kC = 13 classes fixed at compile time the 13
//    upsampled values stay in registers: pass 1 takes max and argmax (strict
//    '>', a tie keeps the lowest class), pass 2 sums exp2((v - max) * log2e)
//    with ex2.approx.ftz.f32 (one MUFU.EX2 each, relative error ~2^-22; terms
//    below 2^-126 flush to 0 next to a sum >= 1), and conf = 1 / sum by
//    Newton-Raphson from an integer-trick seed (3 steps: relative error
//    about 6e-8, FMA pipe only, no MUFU.RCP). So 13 MUFU ops per pixel, and
//    conf stays far inside rtol 1e-4 / atol 1e-5 of the exact softmax max.
//    A runtime class count takes the same two passes, recomputing the
//    interpolation from shared memory in pass 2.
//
// On the H100 this design is bound by instruction issue and by each block's
// serial stage -> barrier -> compute order, not by bytes (PERF.md):
// variants that read each source row once per tile (5x less L2 traffic) or
// shared each thread's source columns across its 4 pixels (fewer shared
// loads, more FMAs) measured slower.
//
// Order of operations follows the TPU kernel: rows first, then columns, fp32.
// The weights come from host-built 2-tap tables (lo, hi, w_hi) with the
// reference's float64 -> float32 arithmetic, bit-identical to the JAX
// matrices. Logits are read through the strides passed in, so a
// channels_last NCHW model output (physically NHWC) needs no copy.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kVec = 4;           // output columns per thread
constexpr int kMaxThreads = 128;  // the host plan never exceeds this
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 1 / s for s >= 1: seed from the float's bits (relative error < 5.1%), then
// three Newton steps r += r * (1 - s * r), each squaring the error
// (2.6e-3, 6.6e-6, then float32 rounding).
__device__ __forceinline__ float reciprocal(float s) {
  float r = __int_as_float(0x7EF311C7 - __float_as_int(s));
#pragma unroll
  for (int i = 0; i < 3; ++i) r = fmaf(r, fmaf(-s, r, 1.0f), r);
  return r;
}

// One output pixel from its two staged source columns `pl`, `ph` (each
// `pitch` floats, 16-byte aligned) and column weight b.
template <int kC>
__device__ __forceinline__ void pixel(const float* pl, const float* ph, float b,
                                      int c_runtime, int& id, float& conf) {
  const float wl = 1.0f - b;
  float best;
  int best_i = 0;
  float sum = 0.0f;
  if constexpr (kC > 0) {
    constexpr int kQ = (kC + 3) / 4;
    float v[kQ * 4];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const float4 l = reinterpret_cast<const float4*>(pl)[q];
      const float4 h = reinterpret_cast<const float4*>(ph)[q];
      v[4 * q + 0] = wl * l.x + b * h.x;
      v[4 * q + 1] = wl * l.y + b * h.y;
      v[4 * q + 2] = wl * l.z + b * h.z;
      v[4 * q + 3] = wl * l.w + b * h.w;
    }
    best = v[0];
#pragma unroll
    for (int k = 1; k < kC; ++k) {
      if (v[k] > best) {
        best = v[k];
        best_i = k;
      }
    }
    const float m = best * kLog2e;
#pragma unroll
    for (int k = 0; k < kC; ++k) sum += ex2(fmaf(v[k], kLog2e, -m));
  } else {
    best = wl * pl[0] + b * ph[0];
    for (int k = 1; k < c_runtime; ++k) {
      const float v = wl * pl[k] + b * ph[k];
      if (v > best) {
        best = v;
        best_i = k;
      }
    }
    const float m = best * kLog2e;
    for (int k = 0; k < c_runtime; ++k)
      sum += ex2(fmaf(wl * pl[k] + b * ph[k], kLog2e, -m));
  }
  id = best_i;
  conf = reciprocal(sum);
}

// kVec consecutive output pixels of one row. Source column c of the row's
// staged logits sits at s[(base + c) * pitch]; `left` counts the row's
// columns from the first pixel on. Stores as one int4 and one float4 where
// all kVec pixels are in the row and 16-byte aligned (all of them when
// out_w % kVec == 0), else as masked scalars.
template <int kC>
__device__ __forceinline__ void row4(const float* s, int base, int pitch,
                                     int4 lo, int4 hi, float4 b, int c_runtime,
                                     int left, int* pred, float* conf) {
  int4 ids;
  float4 confs;
  pixel<kC>(s + (base + lo.x) * pitch, s + (base + hi.x) * pitch, b.x,
            c_runtime, ids.x, confs.x);
  pixel<kC>(s + (base + lo.y) * pitch, s + (base + hi.y) * pitch, b.y,
            c_runtime, ids.y, confs.y);
  pixel<kC>(s + (base + lo.z) * pitch, s + (base + hi.z) * pitch, b.z,
            c_runtime, ids.z, confs.z);
  pixel<kC>(s + (base + lo.w) * pitch, s + (base + hi.w) * pitch, b.w,
            c_runtime, ids.w, confs.w);
  if (left >= kVec && (reinterpret_cast<uintptr_t>(pred) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(conf) & 15) == 0) {
    *reinterpret_cast<int4*>(pred) = ids;
    *reinterpret_cast<float4*>(conf) = confs;
  } else {
    const int id_q[kVec] = {ids.x, ids.y, ids.z, ids.w};
    const float conf_q[kVec] = {confs.x, confs.y, confs.z, confs.w};
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      if (q < left) {
        pred[q] = id_q[q];
        conf[q] = conf_q[q];
      }
    }
  }
}

// Block (tile_w / kVec, block_h), each thread row looping over the tile's
// tile_h output rows in steps of block_h; grid (ceil(out_w / tile_w),
// ceil(out_h / tile_h), n); dynamic shared memory tile_h * span * pitch
// floats. kC > 0 fixes the class count at compile time; kC == 0 reads it
// from c_runtime. Column tables are padded to a multiple of kVec.
template <int kC>
__global__ void __launch_bounds__(kMaxThreads) upsample_argmax_kernel(
    const float* __restrict__ x, int64_t sn, int sh, int sw, int sc, int w,
    int c_runtime, const int* __restrict__ row_lo,
    const int* __restrict__ row_hi, const float* __restrict__ row_w,
    const int* __restrict__ col_lo, const int* __restrict__ col_hi,
    const float* __restrict__ col_w, int out_h, int out_w, int tile_h,
    int span, int pitch, int* __restrict__ pred, float* __restrict__ conf) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int num_classes = kC > 0 ? kC : c_runtime;
  const int x0 = blockIdx.x * blockDim.x * kVec;
  const int y0 = blockIdx.y * tile_h;
  const int n = blockIdx.z;
  const int c0 = col_lo[x0];  // first staged source column
  const float* img = x + n * sn;

  // stage: s[r][j][k] = rows-interpolated logit at (y0 + r, c0 + j, k)
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int threads = blockDim.x * blockDim.y;
  // Offsets inside an image are 32-bit (the wrapper checks that they fit).
  // A tile narrower than `span` stages clamped, unread columns.
  const int row_elems = span * num_classes;
  const bool packed = sc == 1 && sw == num_classes;  // NHWC-contiguous rows
  for (int r = 0; r < tile_h && y0 + r < out_h; ++r) {
    const int oy = y0 + r;
    const float a = row_w[oy];
    const float* p_lo = img + row_lo[oy] * sh;
    const float* p_hi = img + row_hi[oy] * sh;
    float* dst = s + r * span * pitch;
    if (packed) {  // the staged columns are one run of floats
      const int first = c0 * num_classes;
      const int last = w * num_classes - 1;
      for (int e = tid; e < row_elems; e += threads) {
        const int off = min(first + e, last);
        const int j = e / num_classes;
        dst[e + j * (pitch - num_classes)] =
            (1.0f - a) * __ldg(p_lo + off) + a * __ldg(p_hi + off);
      }
    } else {
      for (int e = tid; e < row_elems; e += threads) {
        const int j = e / num_classes;
        const int k = e - j * num_classes;
        const int off = min(c0 + j, w - 1) * sw + k * sc;
        dst[j * pitch + k] =
            (1.0f - a) * __ldg(p_lo + off) + a * __ldg(p_hi + off);
      }
    }
  }
  __syncthreads();

  const int ox = x0 + threadIdx.x * kVec;
  if (ox >= out_w) return;
  const int4 lo = *reinterpret_cast<const int4*>(col_lo + ox);
  const int4 hi = *reinterpret_cast<const int4*>(col_hi + ox);
  const float4 b = *reinterpret_cast<const float4*>(col_w + ox);
  for (int r = threadIdx.y; r < tile_h && y0 + r < out_h; r += blockDim.y) {
    const int64_t o = (static_cast<int64_t>(n) * out_h + y0 + r) * out_w + ox;
    row4<kC>(s, r * span - c0, pitch, lo, hi, b, c_runtime, out_w - ox,
             pred + o, conf + o);
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). Strides are in elements, for the
// logical NHWC view of the logits; every offset inside one image fits in
// an int. The launch plan (tile_h, tile_w, block_h, span, pitch) comes from
// kernels/upsample_argmax.py::launch_plan. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int tss_upsample_argmax_f32(
    const void* logits, long long sn, int sh, int sw, int sc, int n, int w,
    int c, const void* row_lo, const void* row_hi, const void* row_w,
    const void* col_lo, const void* col_hi, const void* col_w, int out_h,
    int out_w, int tile_h, int tile_w, int block_h, int span, int pitch,
    void* pred, void* conf, void* stream) {
  const dim3 grid((out_w + tile_w - 1) / tile_w, (out_h + tile_h - 1) / tile_h,
                  n);
  const dim3 block(tile_w / kVec, block_h);
  const size_t smem = sizeof(float) * tile_h * span * pitch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(logits);
  const int* rl = static_cast<const int*>(row_lo);
  const int* rh = static_cast<const int*>(row_hi);
  const float* rw = static_cast<const float*>(row_w);
  const int* cl = static_cast<const int*>(col_lo);
  const int* ch = static_cast<const int*>(col_hi);
  const float* cw = static_cast<const float*>(col_w);
  int* p = static_cast<int*>(pred);
  float* q = static_cast<float*>(conf);
  if (c == 13) {
    upsample_argmax_kernel<13><<<grid, block, smem, s>>>(
        x, sn, sh, sw, sc, w, c, rl, rh, rw, cl, ch, cw, out_h, out_w, tile_h,
        span, pitch, p, q);
  } else {
    upsample_argmax_kernel<0><<<grid, block, smem, s>>>(
        x, sn, sh, sw, sc, w, c, rl, rh, rw, cl, ch, cw, out_h, out_w, tile_h,
        span, pitch, p, q);
  }
  return static_cast<int>(cudaGetLastError());
}
