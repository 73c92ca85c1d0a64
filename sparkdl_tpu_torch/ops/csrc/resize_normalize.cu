// Fused anti-aliased bilinear resize + affine normalize, for Hopper (sm_90a).
//
//   x   uint8 or float32 [N, H, W, C]
//   out float32          [N, h, w, C] = (Ww · (Wh · x)) * scale + offset
//
// Replaces the Pallas TPU kernel sparkdl_tpu/ops/infeed.py::_kernel (launched
// by fused_resize_normalize(use_pallas=True); pallas_call at infeed.py:245).
// That kernel viewed each image as [H, W*C], cast uint8 through int32 and
// applied the column weights as kron(Ww^T, I_C), all to suit Mosaic's 2-D
// matmul lowering. None of that is part of the math, and none of it is kept:
// here columns are contracted per channel directly and uint8 converts to
// float exactly in a register.
//
// What bounds it: memory. At the main-path shape (64 x 512x512x3 uint8 to
// 299x299) the least traffic is 50.3 MB in + 68.7 MB out, about 36 us at the
// H100's 3.35 TB/s; its banded multiply-adds (~4 taps per axis) are a few
// hundred MFLOP, a few us at the fp32 rate. This first design makes two
// launches and round-trips an fp32 scratch t [N, h, W, C] (117.6 MB written,
// then read), so it moves about three times the least traffic; its time on
// the card is in PERF.md. Fusing both passes over a band of output rows in
// shared memory, and wider loads than one byte per thread, are later work.
//
// Numerics: plain fp32 FMAs, no TF32 — the reference buys exact fp32
// resampling on purpose. Each output row's nonzero weight band [lo, hi) is
// computed on the host; outside it every weight is exactly 0, so skipping
// those terms changes only the summation order (and skips 0 * inf for a
// float input holding inf).
//
// One thread per element of t (row pass), then per element of out (column
// pass). The grid is (row chunks, output rows, images), so a thread finds its
// image and output row in blockIdx and never divides a 64-bit index.
// Neighbouring threads take neighbouring (u, c) or (x, c) positions, so the
// reads of x and t coalesce along the image row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void rows_kernel(const T* __restrict__ x,
                            const float* __restrict__ wh,
                            const int* __restrict__ lo,
                            const int* __restrict__ hi,
                            float* __restrict__ t, int H, int h, int row) {
  const int uc = blockIdx.x * kThreads + threadIdx.x;  // (u, c) in the row
  if (uc >= row) return;
  const int y = blockIdx.y;
  const int64_t img = blockIdx.z;
  const T* src = x + img * H * row + uc;
  const float* w = wh + (int64_t)y * H;
  float acc = 0.f;
  for (int v = lo[y]; v < hi[y]; ++v) {
    acc = fmaf(w[v], (float)src[(int64_t)v * row], acc);
  }
  t[(img * h + y) * row + uc] = acc;
}

__global__ void cols_kernel(const float* __restrict__ t,
                            const float* __restrict__ ww,
                            const int* __restrict__ lo,
                            const int* __restrict__ hi,
                            float* __restrict__ out, int h, int W, int C,
                            int w, float scale, float offset) {
  const int xc = blockIdx.x * kThreads + threadIdx.x;  // (x, c) in the row
  if (xc >= w * C) return;
  const int xo = xc / C;
  const int c = xc - xo * C;
  const int64_t ny = (int64_t)blockIdx.z * h + blockIdx.y;  // (image, row)
  const float* src = t + ny * W * C + c;
  const float* wt = ww + (int64_t)xo * W;
  float acc = 0.f;
  for (int u = lo[xo]; u < hi[xo]; ++u) {
    acc = fmaf(wt[u], src[u * C], acc);
  }
  out[ny * w * C + xc] = acc * scale + offset;
}

unsigned chunks(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// Launches both passes on `stream`; returns cudaGetLastError() (0 = launched).
// tmp must hold N*h*W*C floats and out N*h*w*C floats; all buffers contiguous.
extern "C" int resize_normalize_launch(
    const void* x, int x_is_u8,
    const float* wh, const int* h_lo, const int* h_hi,
    const float* ww, const int* w_lo, const int* w_hi,
    float* tmp, float* out,
    int n, int H, int W, int C, int h, int w,
    float scale, float offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t row = (int64_t)W * C;
  // grid.y and grid.z are at most 65535; rows fit an int
  if (h > 65535 || n > 65535 || row > 0x7fffffff || (int64_t)w * C > 0x7fffffff) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const dim3 row_grid(chunks(row), h, n);
  if (x_is_u8) {
    rows_kernel<uint8_t><<<row_grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(x), wh, h_lo, h_hi, tmp, H, h, (int)row);
  } else {
    rows_kernel<float><<<row_grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), wh, h_lo, h_hi, tmp, H, h, (int)row);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 col_grid(chunks((int64_t)w * C), h, n);
  cols_kernel<<<col_grid, kThreads, 0, s>>>(tmp, ww, w_lo, w_hi, out, h, W, C,
                                            w, scale, offset);
  return (int)cudaGetLastError();
}
