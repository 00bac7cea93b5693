// Fused bilinear align-corners upsample + per-pixel argmax + max-softmax
// confidence, for NVIDIA Hopper (built for sm_90a).
//
// Replaces the TPU kernel thermal_semantic_segmentation_tpu/ops/pallas_kernels.py
// ::upsample_argmax (body _kernel). It computes the same function, not a copy
// of its blocks: one thread per output pixel (n, oy, ox) loops over the C
// classes, interpolating each class at that pixel from four source logits.
//
// Bound: memory traffic. Per output pixel the kernel does ~C*20 flops but
// must write 8 bytes (int32 id + f32 confidence). At the serving shape
// (8, 33, 65, 13) -> 256x512 it reads 0.9 MB of logits and writes 8.4 MB, so
// the floor is ~2.8 us at 3.35 TB/s. The design keeps the upsampled
// (N, 256, 512, 13) f32 tensor (~54 MB at batch 8) out of device memory
// entirely: it only ever lives in registers, one class at a time. The
// logits themselves are tiny and stay in L2, so the four gathers per class
// hit cache, and the two output stores are coalesced along ox.
//
// Order of operations follows the TPU kernel: rows first
// ((1-a) * x[lo, :] + a * x[hi, :] at the two source columns), then columns;
// fp32 accumulation; strict '>' for the argmax (a tie keeps the lowest class);
// an online softmax (running max and sum-exp) for the confidence.
//
// The interpolation weights come from host-built 2-tap tables (lo, hi, w_hi
// per output row and per output column) with the reference's float64 ->
// float32 arithmetic, so they are bit-identical to the JAX matrices.
// Logits are read through the strides passed in, so a channels_last NCHW
// model output (physically NHWC) needs no copy. The ragged edge is masked.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;

// kC > 0 fixes the class count at compile time (fully unrolled);
// kC == 0 reads it from c_runtime.
template <int kC>
__global__ void __launch_bounds__(kThreads) upsample_argmax_kernel(
    const float* __restrict__ x, int64_t sn, int64_t sh, int64_t sw,
    int64_t sc, int c_runtime, const int* __restrict__ row_lo,
    const int* __restrict__ row_hi, const float* __restrict__ row_w,
    const int* __restrict__ col_lo, const int* __restrict__ col_hi,
    const float* __restrict__ col_w, int out_h, int out_w,
    int* __restrict__ pred, float* __restrict__ conf) {
  const int ox = blockIdx.x * kThreads + threadIdx.x;
  const int oy = blockIdx.y;
  const int64_t n = blockIdx.z;
  if (ox >= out_w) return;
  const int num_classes = kC > 0 ? kC : c_runtime;

  const float a = row_w[oy];
  const float b = col_w[ox];
  const float* base = x + n * sn;
  const float* p_ll = base + row_lo[oy] * sh + col_lo[ox] * sw;  // (lo, lo)
  const float* p_hl = base + row_hi[oy] * sh + col_lo[ox] * sw;  // (hi, lo)
  const float* p_lh = base + row_lo[oy] * sh + col_hi[ox] * sw;  // (lo, hi)
  const float* p_hh = base + row_hi[oy] * sh + col_hi[ox] * sw;  // (hi, hi)

  float best = kNeg;
  int best_i = 0;
  float run_max = kNeg;
  float run_sum = 0.0f;
#pragma unroll
  for (int k = 0; k < num_classes; ++k) {
    const int64_t off = k * sc;
    // rows first, at the two source columns...
    const float r_lo = (1.0f - a) * __ldg(p_ll + off) + a * __ldg(p_hl + off);
    const float r_hi = (1.0f - a) * __ldg(p_lh + off) + a * __ldg(p_hh + off);
    // ...then columns
    const float up = (1.0f - b) * r_lo + b * r_hi;
    if (up > best) {
      best = up;
      best_i = k;
    }
    const float new_max = fmaxf(run_max, up);
    run_sum = run_sum * expf(run_max - new_max) + expf(up - new_max);
    run_max = new_max;
  }
  const int64_t o = (n * out_h + oy) * out_w + ox;
  pred[o] = best_i;
  conf[o] = expf(best - (run_max + logf(run_sum)));
}

}  // namespace

// Plain C interface (loaded with ctypes). Strides are in elements, for the
// logical NHWC view of the logits. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int tss_upsample_argmax_f32(
    const void* logits, long long sn, long long sh, long long sw, long long sc,
    int n, int c, const void* row_lo, const void* row_hi, const void* row_w,
    const void* col_lo, const void* col_hi, const void* col_w, int out_h,
    int out_w, void* pred, void* conf, void* stream) {
  const dim3 grid((out_w + kThreads - 1) / kThreads, out_h, n);
  const dim3 block(kThreads);
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
    upsample_argmax_kernel<13><<<grid, block, 0, s>>>(
        x, sn, sh, sw, sc, c, rl, rh, rw, cl, ch, cw, out_h, out_w, p, q);
  } else {
    upsample_argmax_kernel<0><<<grid, block, 0, s>>>(
        x, sn, sh, sw, sc, c, rl, rh, rw, cl, ch, cw, out_h, out_w, p, q);
  }
  return static_cast<int>(cudaGetLastError());
}
