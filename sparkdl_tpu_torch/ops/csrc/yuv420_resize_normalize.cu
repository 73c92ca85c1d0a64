// Packed planar YCbCr 4:2:0 -> RGB: per-plane anti-aliased bilinear resize,
// BT.601 inverse, clip, affine normalize, and optionally the round to uint8,
// in one launch, for Hopper (sm_90a).
//
//   x   uint8 [N, H*W*3/2]: Y [H, W], then Cb and Cr [H/2, W/2], per row
//   out float32 or uint8 [N, h, w, 3]
//
// Replaces sparkdl_tpu/ops/infeed.py::fused_yuv420_resize_normalize. That op
// is not a Pallas kernel: it is an XLA einsum chain (three per-plane resizes,
// then the colour math) that XLA fuses into the model program on the TPU.
// PyTorch has no such fusion, and the chain run op by op is about ten
// launches with fp32 planes in device memory between them; here it is one
// pass with nothing in device memory but the packed input and the output.
//
// What bounds it, on paper: memory. At the main path's shape (64 x 150x150
// 4:2:0 rows to 299x299) it reads 2.16 MB and writes 17.2 MB of uint8 (68.7
// MB as fp32), about 6 us at the H100's 3.35 TB/s; its banded multiply-adds
// (2 taps an axis at this upsample) are a few us at the fp32 rate. So the
// design reads each source byte about once, keeps the resized planes in
// shared memory only, and writes each output byte once.
//
// * A block takes one work item: a band of R = 8 output rows by a tile of
//   output columns of one image. The host plan (infeed.py::yuv420_plan) picks
//   the tile so that the row pass's results of all three planes fit the
//   shared-memory budget: a larger source gets narrower tiles, not more
//   shared memory. A source row streams from device memory, so only the
//   width of one output column's taps can overflow the budget: a horizontal
//   downscale steeper than about 384x, which the plan refuses.
// * Row pass: for each plane, each thread takes 4 neighbouring source columns
//   of the tile's span and walks the band's source rows once, reading each
//   byte once from device memory; one load from a per-band table [band,
//   source row, R] gives that source row's weights for all R output rows (0
//   where it is not one of a row's taps). The R x 4 sums go to shared memory.
//   Y's band comes from the full-resolution plane, Cb's and Cr's from the
//   half-resolution planes with their own weights (H/2 -> h), so the chroma
//   upsample and the resize are one pass, as in the reference.
// * Column pass: each thread takes one output column of the band and all R
//   rows of it, contracts its Y column taps and its chroma column taps (Cb
//   and Cr share them) from shared memory, applies the colour transform,
//   clip and affine, and stores each row's 3 channels; a warp's stores
//   adjoin. The column's band and weights are read once a band.
//
// What bounds it on the card (PERF.md): instruction issue, not memory. The
// uint8 and fp32 outputs take about the same time though one stores 4x the
// bytes; taking a whole output column per thread (so a column's band and
// weights are read once a band) cut the time by a third. At 3024x4032 the
// tiles are 50 columns wide, so most of a block's threads idle in the column
// pass.
//
// Numerics: plain fp32 FMAs, no TF32, as the reference's HIGHEST-precision
// einsums. Each row-pass sum is an fmaf chain from 0 over ascending source
// rows (a zero weight of the band table adds exactly 0), each column-pass sum
// a chain over ascending source columns; only the summation order differs
// from the plain einsums. The colour transform and the affine are written
// with __fmul_rn / __fadd_rn, so they are not contracted into FMAs: the
// uint8 output is then exactly rint of the fp32 output, and each step rounds
// as the plain version's separate multiplies and adds do.

#include <cuda_runtime.h>
#include <stdint.h>

// One plane's layout, from infeed.py::yuv420_plan (the chroma entry serves
// Cb and Cr, which share their geometry).
struct Plane {
  const float* table;  // [bands, span, R] row weights of each band
  const int* bands;    // [bands, 2] source rows [rs, re) of each band
  const int* tiles;    // [tiles, 2] source columns [cs, ce) of each tile
  const float* ww;     // [taps, w] column weights, transposed
  const int* w_lo;     // [w] first source column of output column x
  const int* w_hi;     // [w] one past its last
  int span;            // source rows a band's table holds
  int pitch;           // floats of one row of the row pass's results
  int stride;          // bytes of one source row of the plane
};

// The launcher's argument, which infeed.py mirrors with ctypes (outside the
// anonymous namespace: the exported launcher takes it).
struct Args {
  const unsigned char* x;
  void* out;
  Plane luma, chroma;
  long long row_bytes;  // bytes of one packed row: H*W*3/2
  int H, W, h, w;
  int tile_w, tiles, bands;
  float scale, offset;
  float cr_r, cb_g, cr_g, cb_b;  // the BT.601 inverse, from infeed.py
};

namespace {

constexpr int kThreads = 256;            // as THREADS in infeed.py
constexpr int R = 8;                     // output rows a band, as YUV420_ROWS
constexpr int kMaxSmem = 48 * 1024;      // as YUV420_SMEM_BUDGET

// Shared memory of one block, as infeed.py::_yuv420_smem_bytes: R rows of
// the row pass's results for Y, then Cb, then Cr.
__host__ __device__ inline int smem_bytes(int luma_pitch, int chroma_pitch) {
  return 4 * R * (luma_pitch + 2 * chroma_pitch);
}

// The R weights of one source row for the R output rows of a band, in R/4
// float4 loads through the read-only cache.
__device__ __forceinline__ void load_weights(const float* p, float* v) {
#pragma unroll
  for (int r = 0; r < R; r += 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p + r));
    v[r] = f.x;
    v[r + 1] = f.y;
    v[r + 2] = f.z;
    v[r + 3] = f.w;
  }
}

// Row pass of one 4-column chunk of one plane: t[k][e0 + m] = sum over the
// band's source rows v, ascending, of weight(v, k) * plane[v][cs + e0 + m].
__device__ __forceinline__ void row_chunk(const unsigned char* plane,
                                          int stride, const float* table,
                                          int tspan, int pitch, int band,
                                          int vlo, int vhi, int cs, int span,
                                          int e0, float* t) {
  float acc[4][R];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int k = 0; k < R; ++k) acc[m][k] = 0.f;
  const float* wrow = table + (size_t)band * tspan * R;
  const unsigned char* px = plane + (size_t)vlo * stride + cs + e0;
  const int live = min(4, span - e0);  // columns of the chunk in the span
#pragma unroll 2
  for (int v = vlo; v < vhi; ++v) {
    float wv[R], xv[4];
    load_weights(wrow, wv);
#pragma unroll
    for (int m = 0; m < 4; ++m) xv[m] = m < live ? (float)__ldg(px + m) : 0.f;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int k = 0; k < R; ++k) acc[m][k] = fmaf(wv[k], xv[m], acc[m][k]);
    wrow += R;
    px += stride;
  }
#pragma unroll
  for (int k = 0; k < R; ++k)
    *reinterpret_cast<float4*>(t + k * pitch + e0) =
        make_float4(acc[0][k], acc[1][k], acc[2][k], acc[3][k]);
}

template <bool kU8>
__global__ void __launch_bounds__(kThreads)
    yuv420_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int band = blockIdx.x % a.bands;
  const int tile = blockIdx.x / a.bands % a.tiles;
  const int img = blockIdx.x / a.bands / a.tiles;
  const int y0 = band * R;
  const int rows = min(R, a.h - y0);
  const int x0 = tile * a.tile_w;
  const int cols = min(a.tile_w, a.w - x0);

  const unsigned char* y_plane = a.x + (int64_t)img * a.row_bytes;
  const unsigned char* cb_plane = y_plane + (int64_t)a.H * a.W;
  const unsigned char* cr_plane =
      cb_plane + (int64_t)(a.H / 2) * (a.W / 2);
  float* ty = smem;
  float* tcb = ty + R * a.luma.pitch;
  float* tcr = tcb + R * a.chroma.pitch;

  const int y_vlo = __ldg(a.luma.bands + 2 * band);
  const int y_vhi = __ldg(a.luma.bands + 2 * band + 1);
  const int y_cs = __ldg(a.luma.tiles + 2 * tile);
  const int y_span = __ldg(a.luma.tiles + 2 * tile + 1) - y_cs;
  const int c_vlo = __ldg(a.chroma.bands + 2 * band);
  const int c_vhi = __ldg(a.chroma.bands + 2 * band + 1);
  const int c_cs = __ldg(a.chroma.tiles + 2 * tile);
  const int c_span = __ldg(a.chroma.tiles + 2 * tile + 1) - c_cs;

  // Row pass over the chunks of all three planes at once: Y's, then Cb's,
  // then Cr's.
  const int yq = (y_span + 3) / 4;
  const int cq = (c_span + 3) / 4;
  for (int q = tid; q < yq + 2 * cq; q += kThreads) {
    if (q < yq) {
      row_chunk(y_plane, a.luma.stride, a.luma.table, a.luma.span,
                   a.luma.pitch, band, y_vlo, y_vhi, y_cs, y_span, 4 * q, ty);
    } else {
      const bool is_cb = q < yq + cq;
      row_chunk(is_cb ? cb_plane : cr_plane, a.chroma.stride,
                   a.chroma.table, a.chroma.span, a.chroma.pitch, band, c_vlo,
                   c_vhi, c_cs, c_span, 4 * (q - yq - (is_cb ? 0 : cq)),
                   is_cb ? tcb : tcr);
    }
  }
  __syncthreads();

  // Column pass: one output column of the band a thread, all R rows at
  // once, so the column's taps and weights are read once a band and the R
  // rows' sums are independent; neighbouring threads store neighbouring
  // pixels of each row.
  const int64_t out_row = (int64_t)a.w * 3;
  for (int xl = tid; xl < cols; xl += kThreads) {
    const int xo = x0 + xl;
    float yv[R], cb[R], cr[R];
#pragma unroll
    for (int k = 0; k < R; ++k) yv[k] = cb[k] = cr[k] = 0.f;
    const int ylo = __ldg(a.luma.w_lo + xo);
    const int ynt = __ldg(a.luma.w_hi + xo) - ylo;
    const float* ys = ty + (ylo - y_cs);
    for (int i = 0; i < ynt; ++i) {
      const float wi = __ldg(a.luma.ww + i * a.w + xo);
#pragma unroll
      for (int k = 0; k < R; ++k)
        yv[k] = fmaf(wi, ys[k * a.luma.pitch + i], yv[k]);
    }
    const int clo = __ldg(a.chroma.w_lo + xo);
    const int cnt = __ldg(a.chroma.w_hi + xo) - clo;
    const float* bs = tcb + (clo - c_cs);
    const float* rs = tcr + (clo - c_cs);
    for (int i = 0; i < cnt; ++i) {
      const float wi = __ldg(a.chroma.ww + i * a.w + xo);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        cb[k] = fmaf(wi, bs[k * a.chroma.pitch + i], cb[k]);
        cr[k] = fmaf(wi, rs[k * a.chroma.pitch + i], cr[k]);
      }
    }

    const int64_t o0 = (((int64_t)img * a.h + y0) * a.w + xo) * 3;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (k >= rows) break;
      const float cbk = __fsub_rn(cb[k], 128.f);
      const float crk = __fsub_rn(cr[k], 128.f);
      float rgb[3];
      rgb[0] = __fadd_rn(yv[k], __fmul_rn(a.cr_r, crk));
      rgb[1] = __fadd_rn(__fadd_rn(yv[k], __fmul_rn(a.cb_g, cbk)),
                         __fmul_rn(a.cr_g, crk));
      rgb[2] = __fadd_rn(yv[k], __fmul_rn(a.cb_b, cbk));
      const int64_t o = o0 + k * out_row;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v = __fadd_rn(
            __fmul_rn(fminf(fmaxf(rgb[c], 0.f), 255.f), a.scale), a.offset);
        if constexpr (kU8) {
          // rintf rounds half to even, as torch.round and jnp.round do
          static_cast<uint8_t*>(a.out)[o + c] =
              (uint8_t)fminf(fmaxf(rintf(v), 0.f), 255.f);
        } else {
          static_cast<float*>(a.out)[o + c] = v;
        }
      }
    }
  }
}

typedef void (*Kernel)(const Args);

Kernel kernel_for(int out_u8) {
  return out_u8 ? yuv420_kernel<true> : yuv420_kernel<false>;
}

}  // namespace

// sizeof(Args), which the ctypes mirror in infeed.py must equal.
extern "C" int yuv420_resize_normalize_args_size() {
  return (int)sizeof(Args);
}

// Shared memory one block of this plan lays out.
extern "C" int yuv420_resize_normalize_smem(int luma_pitch,
                                            int chroma_pitch) {
  return smem_bytes(luma_pitch, chroma_pitch);
}

// Blocks of this plan that fit on one SM, and the kernel's registers and
// local memory (spills) per thread. Returns a CUDA error (0 = success).
extern "C" int yuv420_resize_normalize_occupancy(int out_u8, int smem,
                                                 int* blocks, int* registers,
                                                 int* local_bytes) {
  const Kernel k = kernel_for(out_u8);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, k, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

// Launches the kernel once on `stream`, one block per work item (`grid` =
// N * tiles * bands); returns cudaGetLastError() (0 = launched). The plan
// (pitches, smem) comes from infeed.py::yuv420_plan; out holds N*h*w*3
// elements of float32, or of uint8 with out_u8; x is contiguous.
extern "C" int yuv420_resize_normalize_launch(const Args* a, int out_u8,
                                              int grid, int smem,
                                              void* stream) {
  const Kernel k = kernel_for(out_u8);
  if (grid < 1 || a->tiles < 1 || a->bands < 1 ||
      grid % (a->tiles * a->bands) != 0 || smem > kMaxSmem ||
      a->luma.pitch % 4 != 0 || a->chroma.pitch % 4 != 0 ||
      smem != smem_bytes(a->luma.pitch, a->chroma.pitch)) {
    return (int)cudaErrorInvalidConfiguration;
  }
  k<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}
