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
// What bounds it, on paper: memory. At the main-path shape (64 x 512x512x3
// uint8 to 299x299) the least traffic is 50.3 MB in + 68.7 MB out, about
// 36 us at the H100's 3.35 TB/s; its banded multiply-adds (~4 taps per axis)
// are about 0.35 GFLOP, a few us at the fp32 rate. So the design moves each
// byte about once, in one launch, with nothing in device memory between the
// passes, and keeps the next loads in flight while a block computes:
//
// * Work items are (image, column tile, band of R output rows), bands
//   fastest. The host plan (infeed.py::resize_plan) picks R and the tile so
//   that a block's shared memory stays within budget: a steeper downscale
//   gets shorter bands or narrower tiles, not more shared memory.
// * The kernel is persistent: as many blocks as fit on the card at once,
//   each walking a contiguous run of items, so consecutive items are mostly
//   consecutive bands of one image.
// * Source rows, cut to the tile's column span, stream through a ring of
//   `depth` rows in shared memory with 16-byte cp.async copies (plain loads
//   where the tensor's own edge cuts a 16-byte chunk, or where the row stride
//   is not a multiple of 16 bytes and rows would land at different
//   alignments). A band that continues the previous one loads only the rows
//   it adds, so rows shared by neighbouring bands are read once. The next
//   item's rows are in flight while an item is computed.
// * Row pass: each thread takes 8 neighbouring uint8 elements (or 4 floats)
//   of the staged rows and walks the band's source rows once, converting
//   each element once. One vector load from a per-band table [band, source
//   row, R] gives the weights of that source row for all R output rows (0
//   where it is not one of a row's taps), so 8 x R sums build up in
//   registers; they go to an fp32 tile t[R, span*C] in shared memory as
//   float4s. t never goes to device memory.
// * Column pass: each thread takes one (output column, channel) of the tile,
//   walks that column's taps once and keeps all R rows' sums in registers,
//   so each column weight is read once per band; the affine is applied and
//   each warp stores 32 neighbouring floats of an output row. The column
//   weights come transposed, so a warp's loads of them adjoin.
//
// What bounds it on the card (PERF.md): the SMs' own work, not memory. The
// loads hide behind the compute; the row pass, the column pass and each
// item's barriers and bookkeeping add up to most of the time. Staging the
// output for aligned float4 stores, or the column taps in shared memory,
// costs a block per SM and gained nothing.
//
// Numerics: plain fp32 FMAs, no TF32 — the reference buys exact fp32
// resampling on purpose. Each t element is an fmaf chain from 0 over
// ascending source rows, each output a chain over ascending source columns,
// as in the two-pass kernel this replaces; a zero weight of the band table
// adds exactly 0 to a finite sum, so only the summation order differs from
// the plain einsums.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // as THREADS in infeed.py
constexpr int kMaxSmem = 232448;   // the most one block may have (227 KB)

struct Args {
  const void* x;
  long long x_bytes;
  const float* hw;  // [bands, band_span, R]: row weights per band
  const int* h_lo;
  const int* h_hi;
  int band_span;
  const float* ww;  // [taps, w]: column weights, transposed, taps padded
  const int* w_lo;  //   to a multiple of 4 with zeros
  const int* w_hi;
  float* out;
  int H, W, C, h, w;
  int tile_w, tiles, bands, depth, pitch;
  long long items;
  float scale, offset;
};

// Shared memory of one block, as infeed.py::_smem_bytes: the ring of
// `depth` rows of `pitch` bytes, then t, `rows` rows of pitch / itemsize
// floats.
__host__ __device__ inline int smem_bytes(int itemsize, int rows, int depth,
                                          int pitch) {
  return depth * pitch + rows * (pitch / itemsize) * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte k of `word` as a float, exactly: 2^23 + b has b in its low mantissa
// bits, and subtracting 2^23 leaves b.
__device__ __forceinline__ float byte_to_float(uint32_t word, unsigned k) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440u | k)) -
         8388608.f;
}

// The row pass's vector: 4 elements of a ring slot at vector index q, as
// floats (a 4-byte word of uint8, or a float4).
template <typename T>
__device__ __forceinline__ void load4(const unsigned char* slot, int q,
                                      float* v);

template <>
__device__ __forceinline__ void load4<uint8_t>(const unsigned char* slot,
                                               int q, float* v) {
  const uint32_t w = reinterpret_cast<const uint32_t*>(slot)[q];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = byte_to_float(w, k);
}

template <>
__device__ __forceinline__ void load4<float>(const unsigned char* slot, int q,
                                             float* v) {
  const float4 f = reinterpret_cast<const float4*>(slot)[q];
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

// The R weights of one source row for the R output rows of a band, in as
// few loads as R allows, through the read-only cache.
template <int R>
__device__ __forceinline__ void load_weights(const float* p, float* v) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int r = 0; r < R; r += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p + r));
      v[r] = f.x;
      v[r + 1] = f.y;
      v[r + 2] = f.z;
      v[r + 3] = f.w;
    }
  } else if constexpr (R == 2) {
    const float2 f = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = f.x;
    v[1] = f.y;
  } else {
    v[0] = __ldg(p);
  }
}

// One work item: a band of output rows by a tile of output columns of one
// image. Items are walked in order (bands fastest), so the block steps
// from one to the next by counting, not by dividing.
struct Item {
  int img, tile, band;
};

__device__ __forceinline__ void step(Item& it, int bands, int tiles) {
  if (++it.band == bands) {
    it.band = 0;
    if (++it.tile == tiles) {
      it.tile = 0;
      ++it.img;
    }
  }
}

// What the loader and the compute need of an item: its rows and columns,
// where its source rows lie, and which of them it adds to the ring.
struct Span {
  int img, y0, rows, x0, cols;
  int cs;        // first source column of the tile
  int span;      // elements of a staged row: (last column + 1 - cs) * C
  int64_t off;   // bytes from x to source row 0, column cs, of the image
  int head;      // offset of every staged row in its 16-byte chunk
  int vlo;       // first source row of the band
  int vb, ve;    // source rows [vb, ve) the item adds to the ring
  int slot;      // ring slot of source row vlo
};

// The ring is filled in load order: the rows of a run of consecutive bands
// of one (image, tile) follow each other, source row v at slot
// (slot0 + v - v0) % depth; `next` is the slot after the last row loaded,
// where a new run starts.
struct Run {
  int v0, slot0, next;
};

// At most 80 registers a thread at R <= 4, so 3 blocks fit an SM (the
// unrolled loops need more than 64); taller bands get room for 2.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads, R <= 4 ? 3 : 2)
    resize_kernel(const Args a) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* t = reinterpret_cast<float*>(smem + a.depth * a.pitch);
  const unsigned char* ring_end = smem + a.depth * a.pitch;
  const int pitch_t = a.pitch / (int)sizeof(T);  // t floats per row
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int C = a.C;
  const unsigned char* xb = static_cast<const unsigned char*>(a.x);
  const int64_t row_bytes = (int64_t)a.W * C * sizeof(T);
  // With a row stride that is a multiple of 16 bytes every row of a tile
  // starts at the same offset `head` within a 16-byte chunk; its slot keeps
  // that offset, so whole chunks copy with cp.async.
  const bool aligned = row_bytes % 16 == 0;

  const int64_t first = a.items * blockIdx.x / gridDim.x;
  const int64_t last = a.items * (blockIdx.x + 1) / gridDim.x;
  Item start;
  start.band = (int)(first % a.bands);
  start.tile = (int)(first / a.bands % a.tiles);
  start.img = (int)(first / a.bands / a.tiles);

  // Where item `it` lies, and which rows it adds to `run` (a band that
  // continues the band before it in this block's walk adds only its new
  // rows). Updates `run`.
  auto place = [&](const Item& it, bool continues, Run& run) {
    Span s;
    s.img = it.img;
    s.y0 = it.band * R;
    s.rows = min(R, a.h - s.y0);
    s.x0 = it.tile * a.tile_w;
    s.cols = min(a.tile_w, a.w - s.x0);
    s.cs = __ldg(a.w_lo + s.x0);
    s.span = (__ldg(a.w_hi + s.x0 + s.cols - 1) - s.cs) * C;
    s.off = (int64_t)it.img * a.H * row_bytes + (int64_t)s.cs * C * sizeof(T);
    s.head = aligned ? (int)((reinterpret_cast<uintptr_t>(xb) + s.off) & 15)
                     : 0;
    s.vlo = __ldg(a.h_lo + s.y0);
    s.ve = __ldg(a.h_hi + s.y0 + s.rows - 1);
    if (continues) {
      s.vb = __ldg(a.h_hi + s.y0 - 1);
    } else {
      run.v0 = s.vb = s.vlo;
      run.slot0 = run.next;
    }
    s.slot = (run.slot0 + s.vlo - run.v0) % a.depth;
    run.next = (run.slot0 + s.ve - run.v0) % a.depth;
    return s;
  };

  // Copy the source rows [vb, ve) of an item into their ring slots: one
  // warp a row, its lanes along the row.
  auto issue = [&](const Span& s) {
    const int nbytes = s.span * (int)sizeof(T);
    for (int v = s.vb + warp; v < s.ve; v += kWarps) {
      int slot = s.slot + v - s.vlo;  // < 2 * depth
      if (slot >= a.depth) slot -= a.depth;
      unsigned char* dst = ring + slot * a.pitch;
      const int64_t src = s.off + v * row_bytes;
      if (aligned) {
        const int chunks = (s.head + nbytes + 15) >> 4;
        for (int ch = lane; ch < chunks; ch += 32) {
          const int64_t g = src - s.head + ch * 16;
          if (g >= 0 && g + 16 <= a.x_bytes) {
            cp_async16(dst + ch * 16, xb + g);
          } else {  // the tensor's first or last chunk: the row's bytes only
            for (int b = 0; b < 16; ++b) {
              const int sb = ch * 16 + b;
              if (sb >= s.head && sb < s.head + nbytes)
                dst[sb] = xb[g + b];
            }
          }
        }
      } else {
        for (int e = lane; e < s.span; e += 32)
          reinterpret_cast<T*>(dst)[e] =
              reinterpret_cast<const T*>(xb + src)[e];
      }
    }
  };

  // The loader runs one item in front of the compute; each item's copies
  // are one group, so waiting until one group is in flight means the item
  // about to be computed has landed. The compute takes each item's place
  // from the loader.
  Run run = {0, 0, 0};
  Item load_item = start;
  int64_t next_load = first;
  auto load_next = [&]() {
    Span s = {};
    if (next_load < last) {
      s = place(load_item, load_item.band > 0 && next_load > first, run);
      issue(s);
      step(load_item, a.bands, a.tiles);
      ++next_load;
    }
    cp_async_commit();
    return s;
  };
  Span pending = load_next();

  // the column pass's thread-to-(column, channel) map advances by
  // kThreads elements: dx columns and dc channels
  const int dx = kThreads / C;
  const int dc = kThreads - dx * C;
  for (int64_t i = first; i < last; ++i) {
    // item i + 1, into slots items i and i + 1 do not share
    const Span s = pending;
    pending = load_next();
    cp_async_wait<1>();
    __syncthreads();  // item i's rows visible; t free of item i - 1

    // Row pass: t[k][e] = sum over output row y0 + k's taps, in ascending
    // source rows, of weight * staged element e. A thread takes V elements
    // and walks the band's source rows once, converting each element once;
    // one load gives the R rows' weights of a source row (0 past a row's
    // taps, which adds exactly 0). Unrolled, so loads of several source
    // rows are in flight at once.
    constexpr int V = sizeof(T) == 1 ? 8 : 4;  // one 8- or 16-byte load
    const int head_e = s.head / (int)sizeof(T);
    const int q_lo = head_e / V;
    const int nq = (head_e + s.span + V - 1) / V - q_lo;
    const float* wband = a.hw + s.y0 * a.band_span;  // band y0 / R
    for (int q = q_lo + tid; q < q_lo + nq; q += kThreads) {
      float acc[V][R];
#pragma unroll
      for (int m = 0; m < V; ++m)
#pragma unroll
        for (int k = 0; k < R; ++k) acc[m][k] = 0.f;
      const unsigned char* row = ring + s.slot * a.pitch;
#pragma unroll 4
      for (int v = s.vlo; v < s.ve; ++v) {
        float xv[V], wv[R];
#pragma unroll
        for (int m = 0; m < V; m += 4) load4<T>(row, q * (V / 4) + m / 4, xv + m);
        load_weights<R>(wband + (v - s.vlo) * R, wv);
#pragma unroll
        for (int m = 0; m < V; ++m)
#pragma unroll
          for (int k = 0; k < R; ++k) acc[m][k] = fmaf(wv[k], xv[m], acc[m][k]);
        row += a.pitch;
        if (row == ring_end) row = ring;
      }
#pragma unroll
      for (int k = 0; k < R; ++k)
#pragma unroll
        for (int m = 0; m < V; m += 4)
          *reinterpret_cast<float4*>(t + k * pitch_t + V * q + m) =
              make_float4(acc[m][k], acc[m + 1][k], acc[m + 2][k],
                          acc[m + 3][k]);
    }
    __syncthreads();

    // Column pass: one (column, channel) a thread, all R rows at once.
    const int jn = s.cols * C;
    const int64_t out_row = (int64_t)a.w * C;
    float* out0 = a.out + ((int64_t)s.img * a.h + s.y0) * out_row +
                  (int64_t)s.x0 * C;
    int xo = s.x0 + tid / C;
    int c = tid % C;
    for (int j = tid; j < jn; j += kThreads) {
      const int lo = __ldg(a.w_lo + xo);
      const int nt = __ldg(a.w_hi + xo) - lo;
      const float* wx = a.ww + xo;  // [w_taps, w]: a warp's loads adjoin
      const float* src = t + head_e + (lo - s.cs) * C + c;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      // taps in unrolled fours, so their loads issue together; a tap past
      // the column's last has weight 0 (the host pads the weights) and
      // reads the last one's t, which adds exactly 0
      for (int i0 = 0; i0 < nt; i0 += 4) {
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const float wi = __ldg(wx + (i0 + d) * a.w);
          const float* p = src + min(i0 + d, nt - 1) * C;
#pragma unroll
          for (int r = 0; r < R; ++r)
            acc[r] = fmaf(wi, p[r * pitch_t], acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < s.rows) out0[r * out_row + j] = acc[r] * a.scale + a.offset;
      }
      xo += dx;
      c += dc;
      if (c >= C) {
        c -= C;
        ++xo;
      }
    }
  }
  cp_async_wait<0>();
}

typedef void (*Kernel)(const Args);

Kernel kernel_for(int x_is_u8, int rows) {
#define RESIZE_CASE(R)                                                  \
  case R:                                                               \
    return x_is_u8 ? resize_kernel<uint8_t, R> : resize_kernel<float, R>;
  switch (rows) {
    RESIZE_CASE(1)
    RESIZE_CASE(2)
    RESIZE_CASE(4)
    RESIZE_CASE(8)
  }
#undef RESIZE_CASE
  return nullptr;
}

// Lets `k` take up to kMaxSmem bytes of dynamic shared memory on the
// current device, once per kernel and device (a launch being captured into
// a CUDA graph then makes no call but the launch).
cudaError_t allow_smem(int x_is_u8, int rows, Kernel k) {
  static unsigned long long done[2][9];  // device bits per kernel
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done[x_is_u8 != 0][rows] & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess) done[x_is_u8 != 0][rows] |= bit;
  return err;
}

}  // namespace

// Shared memory one block of this plan lays out (as infeed.py::_smem_bytes).
extern "C" int resize_normalize_smem(int x_is_u8, int rows, int depth,
                                     int pitch) {
  return smem_bytes(x_is_u8 ? 1 : 4, rows, depth, pitch);
}

// Blocks of this plan that fit on one SM, and the kernel's registers and
// local memory (spills) per thread. Returns a CUDA error (0 = success).
extern "C" int resize_normalize_occupancy(int x_is_u8, int rows, int smem,
                                          int* blocks, int* registers,
                                          int* local_bytes) {
  const Kernel k = kernel_for(x_is_u8, rows);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(x_is_u8, rows, k);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

// Launches the kernel once on `stream` with `grid` persistent blocks;
// returns cudaGetLastError() (0 = launched). The plan (rows, tile_w, depth,
// pitch, smem) comes from infeed.py::resize_plan; out must hold
// n*h*w*C floats; x is contiguous.
extern "C" int resize_normalize_launch(
    const void* x, int x_is_u8, long long x_bytes, const float* hw,
    const int* h_lo, const int* h_hi, int band_span, const float* ww,
    const int* w_lo, const int* w_hi, float* out, int n, int H,
    int W, int C, int h, int w, int rows, int tile_w, int depth, int pitch,
    int smem, int grid, float scale, float offset, void* stream) {
  const Kernel k = kernel_for(x_is_u8, rows);
  const int tiles = (w + tile_w - 1) / tile_w;
  const int bands = (h + rows - 1) / rows;
  if (k == nullptr || grid < 1 || smem > kMaxSmem || pitch % 16 != 0 ||
      depth < 1 ||
      smem != smem_bytes(x_is_u8 ? 1 : 4, rows, depth, pitch)) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const cudaError_t err = allow_smem(x_is_u8, rows, k);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.x = x;
  a.x_bytes = x_bytes;
  a.hw = hw;
  a.h_lo = h_lo;
  a.h_hi = h_hi;
  a.band_span = band_span;
  a.ww = ww;
  a.w_lo = w_lo;
  a.w_hi = w_hi;
  a.out = out;
  a.H = H;
  a.W = W;
  a.C = C;
  a.h = h;
  a.w = w;
  a.tile_w = tile_w;
  a.tiles = tiles;
  a.bands = bands;
  a.depth = depth;
  a.pitch = pitch;
  a.items = (long long)n * tiles * bands;
  a.scale = scale;
  a.offset = offset;
  k<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
