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
// (2 taps an axis at this upsample) are a few us at the fp32 rate.
//
// What bounded the first design on the card (PERF.md, k2_phases.py): the
// latency of each block's phases in turn. One block per band waited on a
// device-memory load for each source row of its row pass, with 76 of 256
// threads working, then ran its column pass in two rounds of 256 and 43
// threads; the phases' savings added up to more than the whole. This
// design is K1's (resize_normalize.cu) carried over to three planes:
//
// * Persistent blocks, as many as fit on the card at once. A work item is
//   a band of R = 8 output rows by a tile of output columns of one image
//   (bands fastest); items are handed out one at a time, a block's first
//   two fixed and each later one from a queue in device memory (an atomic
//   counter the last block to finish sets back to 0), so blocks that an
//   SM's scheduler serves less take fewer items. The host plan
//   (infeed.py::yuv420_plan) picks the tile so that shared memory stays
//   within budget: a larger source gets narrower tiles.
// * Each plane's source rows, cut to the tile's column span, stream
//   through a ring of two items' rows in shared memory with 16-byte
//   cp.async copies, two items ahead of the compute. Neither the packed
//   row (H*W*3/2 bytes) nor a plane's row (W or W/2 bytes) is a multiple of
//   16, so every source row has its own offset in its 16-byte chunk; its
//   slot keeps that offset (up to 15 bytes after the slot's start) and the
//   row pass finds it again from the row's address. Chunks the tensor's
//   own edge cuts are copied with plain loads. The item's row taps, and
//   the tile's column weights, come by cp.async too.
// * Row pass: a thread takes one output row and 8 neighbouring source
//   columns of Y, or 4 of Cb and Cr together (as many bytes), and walks
//   that row's own taps (first source row and count), so no multiply-add
//   is by a zero weight; unaligned words of the slot give its bytes. The
//   results go to shared memory: Y's rows, then Cb's and Cr's
//   interleaved, so a column tap of both chroma planes is one 8-byte load.
// * Column pass: a thread takes one output column and all R rows, with
//   the column's taps (a count known at compile time for the common
//   upsamples: 2 or 4 for Y, 2 for the chroma) and weights in registers;
//   other geometries take (row, column) units. 8 x 299 pixels are one
//   round of 320 threads.
// * Stores: with one tile a band's uint8 output is one contiguous run
//   (7,176 bytes at the main shape). It is staged in shared memory at the
//   output's own offset in its 16-byte chunk and written with 16-byte
//   stores, bytes only at its ragged ends. fp32 output, and narrower
//   tiles, store each pixel directly; a warp's stores adjoin.
//
// What bounds it on the card (PERF.md, k2_phases.py): not memory. Its
// cost per image is half the first design's, but the persistent pipeline
// adds a fixed cost: the first items' copies land before any compute, and
// at the end each block finishes the items it has claimed (an SM's
// scheduler serves its oldest blocks first, so its last block runs its
// last items alone). Of the rest, about half is the two passes and half
// each item's bookkeeping, copies and copy-out, in lockstep phases
// (copy-out and row pass, barrier, copies and column pass, barrier);
// 64 registers a thread allow three blocks an SM.
//
// Numerics: plain fp32 FMAs, no TF32, as the reference's HIGHEST-precision
// einsums. Each row-pass sum is an fmaf chain from 0 over a row's taps in
// ascending source rows, each column-pass sum a chain over ascending source
// columns (a padded tap adds 0 * a finite value, exactly 0, to a sum that
// is at least +0); only the summation order differs from the plain einsums.
// The colour transform and the affine are written with __fmul_rn /
// __fadd_rn, so they are not contracted into FMAs: the uint8 output is then
// exactly the round of the fp32 output, and each step rounds as the plain
// version's separate multiplies and adds do. With scale 1 and offset 0 the
// affine is the identity and is skipped, and the uint8 round is the
// saturating float-to-uint8 conversion (round half to even); with the
// affine, it adds 2^23 to the clipped value, which rounds it to an integer,
// half to even, in the low mantissa bits. Clipping to [0, 255] before the
// round equals clipping after it, as both bounds are integers.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// One plane's layout, from infeed.py::yuv420_plan (the chroma entry serves
// Cb and Cr, which share their geometry).
struct Plane {
  const float* row_w;   // [h, row_taps] output row y's weights from row_lo
  const int* row_lo;    // [h] first source row of output row y
  const int* row_hi;    // [h] one past its last
  const int* bands;     // [bands, 2] source rows [rs, re) of each band
  const int* tiles;     // [tiles, 2] source columns [cs, ce) of each tile
  const float* col_w;   // [col_taps, pad4(w)] column weights, transposed,
                        // zero-padded
  const int* col_lo;    // [pad4(w)] first source column of output column x
  long long offset;     // bytes from a packed row's start to the plane (Cb)
  int stride;           // bytes of one source row of the plane
  int row_taps;         // row_w's width
  int col_taps;         // taps of every output column (even, zero-padded)
  int depth;            // ring slots
  int pitch;            // bytes of one ring slot (a multiple of 16)
  int t_pitch;          // floats of one row-pass result row of the plane
};

// The launcher's argument, which infeed.py mirrors with ctypes (outside the
// anonymous namespace: the exported launcher takes it).
struct Args {
  const unsigned char* x;
  void* out;
  int* queue;           // [2] next item, blocks done: 0 between launches
  Plane luma, chroma;
  long long row_bytes;  // bytes of one packed row: H*W*3/2
  long long cr_offset;  // bytes from a packed row's start to Cr
  long long x_bytes;    // bytes of x
  long long items;      // work items: N * tiles * bands
  int h, w;
  int tile_w, tiles, bands;
  int staged;           // a band's output goes out through shared memory
  int affine;           // scale and offset are not 1 and 0
  float scale, offset;
  float cr_r, cb_g, cr_g, cb_b;  // the BT.601 inverse, from infeed.py
};

namespace {

constexpr int kThreads = 320;         // as YUV420_THREADS in infeed.py
constexpr int kWarps = kThreads / 32;
constexpr int R = 8;                  // output rows a band, as YUV420_ROWS
constexpr int kChunk = 8;             // as YUV420_CHUNK: row-pass columns
                                      // of Y a thread (of Cb and Cr: 4)
constexpr int kMaxSmem = 75 * 1024;   // as YUV420_SMEM_BUDGET

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

// Bytes of one item's row taps of a plane: first rows [R], ends [R],
// weights [R, row_taps].
__host__ __device__ inline int taps_bytes(int row_taps) {
  return round16(4 * R * (2 + row_taps));
}

// Columns of a row of a tile's column weights or first columns in shared
// memory, and of the whole output in device memory: padded to 4, so
// 16-byte copies stay aligned.
__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// Bytes of one buffer of a tile's column weights [col_taps, pad4(tile_w)]
// and first columns [pad4(tile_w)], Y's then the chroma's at cols_c_bytes.
__host__ __device__ inline int cols_c_bytes(const Args& a) {
  return 4 * pad4(a.tile_w) * (a.luma.col_taps + 1);
}
__host__ __device__ inline int cols_bytes(const Args& a) {
  return cols_c_bytes(a) + 4 * pad4(a.tile_w) * (a.chroma.col_taps + 1);
}

// Byte offsets of shared memory's regions, as infeed.py::_yuv420_smem_bytes:
// the rings of Y, Cb and Cr; the row pass's results, Y's [R, t_pitch] and
// the chroma's [R, t_pitch, 2]; the column buffers (one for a one-tile
// plan, else three, by item number mod 3: items k, k + 1 and k + 2 are in
// use at once); the row taps of two items (by parity),
// Y's then the chroma's; the bands and tiles of both planes, and two items
// published for the loader (int4: valid, image, tile, band); the staged
// output.
struct Layout {
  int ring_cb, ring_cr, t, cols, taps, spans, stage, total;
};

__host__ __device__ inline Layout layout(const Args& a, int itemsize) {
  Layout l;
  l.ring_cb = a.luma.depth * a.luma.pitch;
  l.ring_cr = l.ring_cb + a.chroma.depth * a.chroma.pitch;
  l.t = l.ring_cr + a.chroma.depth * a.chroma.pitch;
  l.cols = l.t + 4 * R * (a.luma.t_pitch + 2 * a.chroma.t_pitch);
  l.taps = l.cols + (a.tiles == 1 ? 1 : 3) * cols_bytes(a);
  l.spans = l.taps + 2 * (taps_bytes(a.luma.row_taps) +
                          taps_bytes(a.chroma.row_taps));
  l.stage = l.spans + round16(16 * (a.bands + a.tiles)) + 32;
  l.total = l.stage + (a.staged ? round16(15 + R * a.w * 3 * itemsize) : 0);
  return l;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// 16 bytes of which the first `bytes` are copied and the rest zeroed.
__device__ __forceinline__ void cp_async16_part(void* dst, const void* src,
                                                int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
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

// The 4 bytes of a ring at byte offset `off` (any alignment), as floats:
// two aligned words, shifted together.
__device__ __forceinline__ void load4(const unsigned char* ring, int off,
                                      float* v) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(ring + (off & ~3));
  const uint32_t w = __funnelshift_r(p[0], p[1], (off & 3) * 8);
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = byte_to_float(w, k);
}

// The 8 bytes of a ring at byte offset `off` (any alignment), as floats:
// three aligned words, shifted together.
__device__ __forceinline__ void load8(const unsigned char* ring, int off,
                                      float* v) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(ring + (off & ~3));
  const uint32_t w0 = p[0], w1 = p[1], w2 = p[2];
  const unsigned sh = (off & 3) * 8;
  const uint32_t lo = __funnelshift_r(w0, w1, sh);
  const uint32_t hi = __funnelshift_r(w1, w2, sh);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = byte_to_float(lo, k);
    v[4 + k] = byte_to_float(hi, k);
  }
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

template <int N>
struct Int {
  static constexpr int value = N;
};

// One pixel's BT.601 inverse, clip, affine and, for uint8 output, the
// round: the low byte of v[c]'s bits is then the uint8. Without the
// affine it is the saturating float-to-uint8 conversion; with it, the
// clipped value plus 2^23, which rounds it to an integer, half to even,
// in the low mantissa bits. Clipping to [0, 255] before the round equals
// clipping after it, as both bounds are integers.
template <bool kU8, bool kAffine>
__device__ __forceinline__ void colour(const Args& a, float yv, float cb,
                                       float cr, float* v) {
  const float cbk = __fsub_rn(cb, 128.f);
  const float crk = __fsub_rn(cr, 128.f);
  float rgb[3];
  rgb[0] = __fadd_rn(yv, __fmul_rn(a.cr_r, crk));
  rgb[1] = __fadd_rn(__fadd_rn(yv, __fmul_rn(a.cb_g, cbk)),
                     __fmul_rn(a.cr_g, crk));
  rgb[2] = __fadd_rn(yv, __fmul_rn(a.cb_b, cbk));
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float f = fminf(fmaxf(rgb[c], 0.f), 255.f);
    if constexpr (kAffine) {
      f = __fadd_rn(__fmul_rn(f, a.scale), a.offset);
      if constexpr (kU8) f = fminf(fmaxf(f, 0.f), 255.f);
    }
    if constexpr (kU8 && !kAffine) {
      // round half to even, saturating at 0 and 255 (the clip above then
      // changes nothing, and the compiler drops it)
      unsigned u;
      asm("cvt.rni.sat.u8.f32 %0, %1;" : "=r"(u) : "f"(rgb[c]));
      v[c] = __uint_as_float(u);
    } else {
      v[c] = kU8 ? __fadd_rn(f, 8388608.f) : f;
    }
  }
}

template <typename T>
__device__ __forceinline__ void put(T* dst, const float* v) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if constexpr (sizeof(T) == 1) {
      dst[c] = static_cast<T>(__float_as_uint(v[c]));
    } else {
      dst[c] = v[c];
    }
  }
}

// One work item: a band of R output rows by a tile of output columns of
// one image, numbered with bands fastest.
struct Item {
  int img, tile, band;
};

// What the compute needs of an item beyond its number: where it lies and
// the ring slots of its bands' first rows.
struct Pending {
  Item it;
  int slot_y, slot_c;
  bool valid;  // false past the block's last item
};

// At most 64 registers a thread, so 3 blocks of 320 threads fit an SM.
template <bool kU8>
__global__ void __launch_bounds__(kThreads, 3)
    yuv420_kernel(const Args a) {
  using T = typename std::conditional<kU8, uint8_t, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(a, sizeof(T));
  unsigned char* const ring_y = smem;
  unsigned char* const ring_cb = smem + L.ring_cb;
  unsigned char* const ring_cr = smem + L.ring_cr;
  float* const t_y = reinterpret_cast<float*>(smem + L.t);
  float* const t_c = t_y + R * a.luma.t_pitch;
  int* const bands_y = reinterpret_cast<int*>(smem + L.spans);
  int* const bands_c = bands_y + 2 * a.bands;
  int* const tiles_y = bands_c + 2 * a.bands;
  int* const tiles_c = tiles_y + 2 * a.tiles;
  int4* const next_item = reinterpret_cast<int4*>(
      smem + L.spans + round16(16 * (a.bands + a.tiles)));  // [2]
  unsigned char* const stage = smem + L.stage;
  const int tb_y = taps_bytes(a.luma.row_taps);
  const int tb_c = taps_bytes(a.chroma.row_taps);
  const int cb_bytes = cols_bytes(a);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(a.x);

  // the bands and tiles of both planes, once
  for (int j = tid; j < 2 * a.bands; j += kThreads) {
    bands_y[j] = __ldg(a.luma.bands + j);
    bands_c[j] = __ldg(a.chroma.bands + j);
  }
  for (int j = tid; j < 2 * a.tiles; j += kThreads) {
    tiles_y[j] = __ldg(a.luma.tiles + j);
    tiles_c[j] = __ldg(a.chroma.tiles + j);
  }
  __syncthreads();

  // Items are handed out one at a time: a block's first two are fixed
  // (blockIdx.x and blockIdx.x + gridDim.x), each later one comes from the
  // queue, so blocks that an SM's scheduler serves less take fewer items
  // and none is left working alone at the end. Thread 0 fetches each
  // number one item ahead of publishing it and two ahead of its use, so
  // nothing waits on an atomic.
  // (the fetched count, kept raw: adding to it at once would wait for it)
  int ahead = 0;
  if (tid == 0) ahead = atomicAdd(a.queue, 1);
  // Item number n as (valid, image, tile, band); numbers fit 31 bits (the
  // launcher checks), so they divide in 32.
  auto decode_item = [&](unsigned n) {
    const unsigned rest = n / (unsigned)a.bands;
    const unsigned img = rest / (unsigned)a.tiles;
    return make_int4(n < (unsigned)a.items, (int)img,
                     (int)(rest - img * (unsigned)a.tiles),
                     (int)(n - rest * (unsigned)a.bands));
  };

  // Copy 16-byte chunk `ch` of one source row's bytes [src, src + nbytes)
  // of x into a ring slot, at the row's own offset in its 16-byte chunk
  // (nothing past the row's last chunk).
  auto copy_chunk = [&](unsigned char* dst, int64_t src, int nbytes,
                        int ch) {
    const int head = (int)((xa + src) & 15);
    if (ch >= (head + nbytes + 15) >> 4) return;
    const int64_t g = src - head + ch * 16;
    if (g >= 0 && g + 16 <= a.x_bytes) {
      cp_async16(dst + ch * 16, a.x + g);
    } else {  // the tensor's first or last chunk: the row's bytes only
      for (int b = 0; b < 16; ++b) {
        const int sb = ch * 16 + b;
        if (sb >= head && sb < head + nbytes) dst[sb] = a.x[g + b];
      }
    }
  };

  // Copy an item's row taps of one plane into its buffer, by the last
  // warp: first rows, ends, then the weights of `rows` output rows.
  auto copy_taps = [&](unsigned char* dst, const Plane& p, int y0,
                       int rows) {
    int* const lo = reinterpret_cast<int*>(dst);
    float* const wt = reinterpret_cast<float*>(lo + 2 * R);
    for (int e = lane; e < rows; e += 32) {
      cp_async4(lo + e, p.row_lo + y0 + e);
      cp_async4(lo + R + e, p.row_hi + y0 + e);
    }
    const float* src = p.row_w + (int64_t)y0 * p.row_taps;
    for (int e = lane; e < rows * p.row_taps; e += 32)
      cp_async4(wt + e, src + e);
  };

  // Copy a tile's column weights (zero past the tile's columns) and first
  // columns into column buffer `b`, in 16-byte pieces over every thread
  // (a tile starts at a multiple of 4 columns, the plan sees to it).
  auto copy_columns = [&](int tile, int b) {
    const int x0 = tile * a.tile_w;
    const int cols = min(a.tile_w, a.w - x0);
    const int quads = pad4(a.tile_w) >> 2;
    auto plane = [&](const Plane& p, unsigned char* buf) {
      for (int j = tid; j < quads * (p.col_taps + 1); j += kThreads) {
        const int i = j / quads, q = j - i * quads;
        const int n = min(max(cols - 4 * q, 0), 4);  // columns to copy
        const void* src = i < p.col_taps
            ? static_cast<const void*>(p.col_w + i * pad4(a.w) + x0 + 4 * q)
            : static_cast<const void*>(p.col_lo + x0 + 4 * q);
        cp_async16_part(buf + 16 * j, n ? src : p.col_lo, 4 * n);
      }
    };
    unsigned char* const buf = smem + L.cols + b * cb_bytes;
    plane(a.luma, buf);
    plane(a.chroma, buf + cols_c_bytes(a));
  };

  // The loader runs two items in front of the compute: item k + 2 is
  // issued once item k's row pass is done, so its copies run under item
  // k's column pass and item k + 1's row pass. A plane's ring is filled in
  // load order, each item's source rows after the last item's (slot
  // `next`); the ring holds two items' rows, so item k + 2's go into the
  // slots item k no longer needs, and its row taps into the buffer of its
  // parity, which item k's row pass has finished with. For a plan of
  // several tiles its tile's column weights go to column buffer
  // (k + 2) % 3, as item k's column pass still reads buffer k % 3. Each
  // item's copies are one group, so waiting until one group is in flight
  // means the item about to be computed has landed.
  int next_y = 0, next_c = 0;
  int loads = 0;  // load_next calls: the block's items, and past its end
  int load_cols = 0;  // the column buffer of the next item loaded
  auto load_next = [&]() {
    Pending p;
    const int4 d = loads == 0   ? decode_item(blockIdx.x)
                   : loads == 1 ? decode_item(blockIdx.x + gridDim.x)
                                : next_item[loads & 1];
    p.valid = d.x != 0;
    p.it.img = d.y;
    p.it.tile = d.z;
    p.it.band = d.w;
    p.slot_y = next_y;
    p.slot_c = next_c;
    if (p.valid) {
      const Item& it = p.it;
      const int vy = bands_y[2 * it.band];
      const int ny = bands_y[2 * it.band + 1] - vy;
      const int vc = bands_c[2 * it.band];
      const int nc = bands_c[2 * it.band + 1] - vc;
      next_y += ny;
      if (next_y >= a.luma.depth) next_y -= a.luma.depth;
      next_c += nc;
      if (next_c >= a.chroma.depth) next_c -= a.chroma.depth;
      const int cs_y = tiles_y[2 * it.tile];
      const int span_y = tiles_y[2 * it.tile + 1] - cs_y;
      const int cs_c = tiles_c[2 * it.tile];
      const int span_c = tiles_c[2 * it.tile + 1] - cs_c;
      const int64_t base = (int64_t)it.img * a.row_bytes;
      // the rows as (row, 16-byte chunk) slots over all the threads, as
      // many a row as its slot holds chunks
      const int cy = a.luma.pitch >> 4, cc = a.chroma.pitch >> 4;
      const int sy = ny * cy, sc = nc * cc;
      for (int j = tid; j < sy + 2 * sc; j += kThreads) {
        if (j < sy) {
          const int r = j / cy;
          int slot = p.slot_y + r;
          if (slot >= a.luma.depth) slot -= a.luma.depth;
          copy_chunk(ring_y + slot * a.luma.pitch,
                     base + a.luma.offset +
                         (int64_t)(vy + r) * a.luma.stride + cs_y,
                     span_y, j - r * cy);
        } else {
          const bool cr = j - sy >= sc;
          const int jc = j - sy - (cr ? sc : 0);
          const int r = jc / cc;
          int slot = p.slot_c + r;
          if (slot >= a.chroma.depth) slot -= a.chroma.depth;
          copy_chunk((cr ? ring_cr : ring_cb) + slot * a.chroma.pitch,
                     base + (cr ? a.cr_offset : a.chroma.offset) +
                         (int64_t)(vc + r) * a.chroma.stride + cs_c,
                     span_c, jc - r * cc);
        }
      }
      if (warp == kWarps - 1) {
        const int y0 = it.band * R;
        const int rows = min(R, a.h - y0);
        unsigned char* buf = smem + L.taps + (loads & 1) * (tb_y + tb_c);
        copy_taps(buf, a.luma, y0, rows);
        copy_taps(buf + tb_y, a.chroma, y0, rows);
      }
      if (a.tiles > 1 || loads == 0) copy_columns(it.tile, load_cols);
    }
    cp_async_commit();
    ++loads;
    if (a.tiles > 1 && ++load_cols == 3) load_cols = 0;
    return p;
  };

  // Write a staged band's output: 16-byte stores where a whole chunk of
  // the output is the band's; the ragged ends one byte a thread.
  auto copy_out = [&](const Item& it) {
    const int y0 = it.band * R;
    const int nb = min(R, a.h - y0) * a.w * 3 * (int)sizeof(T);
    unsigned char* const g = static_cast<unsigned char*>(a.out) +
                             ((int64_t)it.img * a.h + y0) * a.w * 3 *
                                 sizeof(T);
    const int head = (int)(reinterpret_cast<uintptr_t>(g) & 15);
    unsigned char* const g0 = g - head;  // 16-byte aligned
    const int c0 = head > 0 ? 1 : 0;     // whole chunks [c0, c1)
    const int c1 = (head + nb) >> 4;
    for (int ch = c0 + tid; ch < c1; ch += kThreads) {
      *reinterpret_cast<uint4*>(g0 + ch * 16) =
          *reinterpret_cast<const uint4*>(stage + ch * 16);
    }
    if (warp == kWarps - 2) {
      // bytes [head, 16) of the first chunk, and from the last whole
      // chunk's end to the band's end (by a warp with fewer chunks)
      const int sb = lane < 16 ? lane : max(c1, c0) * 16 + lane - 16;
      if (sb < head + nb && (lane < 16 ? head > 0 && sb >= head : true))
        g0[sb] = stage[sb];
    }
  };

  // The row pass's units: one output row and kChunk neighbouring columns
  // of Y (units [0, R * qy)), or kChunk / 2 of Cb and Cr together (the
  // next R * qc), so every unit loads and sums as many bytes. A thread's
  // first unit is decoded once.
  const int qy = a.luma.t_pitch / kChunk;
  const int qc = a.chroma.t_pitch / (kChunk / 2);
  const int units = R * (qy + qc);
  auto decode = [&](int u, bool& luma, int& k, int& q) {
    luma = u < R * qy;
    const int uu = luma ? u : u - R * qy;
    const int q_n = luma ? qy : qc;
    k = uu / q_n;
    q = uu - k * q_n;
  };
  bool luma0;
  int k0, q0;
  decode(tid, luma0, k0, q0);

  // One tap of the row pass: the weight times the unit's bytes of the
  // source row in `slot`, whose bytes start `head` bytes into it.
  auto tap_y = [&](float wt, int slot, unsigned head, int q, float* acc) {
    float xv[kChunk];
    load8(ring_y, slot * a.luma.pitch + (int)(head & 15) + kChunk * q, xv);
#pragma unroll
    for (int m = 0; m < kChunk; ++m) acc[m] = fmaf(wt, xv[m], acc[m]);
  };
  auto tap_c = [&](float wt, int slot, unsigned hcb, unsigned hcr, int q,
                   float* cb, float* cr) {
    constexpr int kHalf = kChunk / 2;
    float xb[kHalf], xr[kHalf];
    const int off = slot * a.chroma.pitch + kHalf * q;
    load4(ring_cb, off + (int)(hcb & 15), xb);
    load4(ring_cr, off + (int)(hcr & 15), xr);
#pragma unroll
    for (int m = 0; m < kHalf; ++m) {
      cb[m] = fmaf(wt, xb[m], cb[m]);
      cr[m] = fmaf(wt, xr[m], cr[m]);
    }
  };

  // Row pass of an item, from the row taps in buffer `b`: t[k][e] = sum
  // over output row y0 + k's taps, in ascending source rows, of weight *
  // staged element e. Two taps (every row of an upsample) run straight
  // through; other counts loop.
  auto row_pass = [&](const Pending& cur, int b) {
    const Item it = cur.it;
    const int y0 = it.band * R;
    const int rows = min(R, a.h - y0);
    const int64_t base = (int64_t)it.img * a.row_bytes;
    const int cs_y = tiles_y[2 * it.tile];
    const int cs_c = tiles_c[2 * it.tile];
    // a row's offset in its 16-byte chunk: (its address) & 15
    const unsigned hb_y = (unsigned)(xa + base + a.luma.offset + cs_y);
    const unsigned hb_cb = (unsigned)(xa + base + a.chroma.offset + cs_c);
    const unsigned hb_cr = (unsigned)(xa + base + a.cr_offset + cs_c);
    const unsigned char* taps = smem + L.taps + b * (tb_y + tb_c);
    for (int u = tid; u < units; u += kThreads) {
      bool luma = luma0;
      int k = k0, q = q0;
      if (u != tid) decode(u, luma, k, q);
      if (k >= rows) continue;
      if (luma) {
        const int* tl = reinterpret_cast<const int*>(taps);
        const float* wr =
            reinterpret_cast<const float*>(tl + 2 * R) + k * a.luma.row_taps;
        const int lo = tl[k];
        const int n = tl[R + k] - lo;
        const int depth = a.luma.depth;
        int slot = cur.slot_y + lo - bands_y[2 * it.band];
        if (slot >= depth) slot -= depth;
        unsigned h = hb_y + (unsigned)(lo * a.luma.stride);
        float acc[kChunk];
#pragma unroll
        for (int m = 0; m < kChunk; ++m) acc[m] = 0.f;
        if (n == 2) {
          const int slot1 = slot + 1 == depth ? 0 : slot + 1;
          tap_y(wr[0], slot, h, q, acc);
          tap_y(wr[1], slot1, h + a.luma.stride, q, acc);
        } else {
          for (int j = 0; j < n; ++j) {
            tap_y(wr[j], slot, h, q, acc);
            if (++slot == depth) slot = 0;
            h += a.luma.stride;
          }
        }
        float4* t = reinterpret_cast<float4*>(t_y + k * a.luma.t_pitch +
                                              kChunk * q);
        t[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        t[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
      } else {
        constexpr int kHalf = kChunk / 2;
        const int* tl = reinterpret_cast<const int*>(taps + tb_y);
        const float* wr = reinterpret_cast<const float*>(tl + 2 * R) +
                          k * a.chroma.row_taps;
        const int lo = tl[k];
        const int n = tl[R + k] - lo;
        const int depth = a.chroma.depth;
        int slot = cur.slot_c + lo - bands_c[2 * it.band];
        if (slot >= depth) slot -= depth;
        const unsigned d = (unsigned)(lo * a.chroma.stride);
        unsigned hcb = hb_cb + d, hcr = hb_cr + d;
        float cb[kHalf], cr[kHalf];
#pragma unroll
        for (int m = 0; m < kHalf; ++m) cb[m] = cr[m] = 0.f;
        if (n == 2) {
          const int slot1 = slot + 1 == depth ? 0 : slot + 1;
          const unsigned st = a.chroma.stride;
          tap_c(wr[0], slot, hcb, hcr, q, cb, cr);
          tap_c(wr[1], slot1, hcb + st, hcr + st, q, cb, cr);
        } else {
          for (int j = 0; j < n; ++j) {
            tap_c(wr[j], slot, hcb, hcr, q, cb, cr);
            if (++slot == depth) slot = 0;
            hcb += a.chroma.stride;
            hcr += a.chroma.stride;
          }
        }
        float4* t = reinterpret_cast<float4*>(
            t_c + k * 2 * a.chroma.t_pitch + 2 * kHalf * q);
#pragma unroll
        for (int m = 0; m < kHalf; m += 2)
          t[m / 2] = make_float4(cb[m], cr[m], cb[m + 1], cr[m + 1]);
      }
    }
  };

  // Column pass of an item from column buffer `b`, then each pixel's
  // colour math and store (to the stage, which has the output's row
  // pitch, or to the output). Where the tile's columns fit the block and
  // the taps are counts it is built for, a thread takes one output column
  // and all R rows, with the column's taps and weights in registers;
  // otherwise a thread takes (row, column) units in turn and reads the
  // weights tap by tap.
  auto column_pass = [&](const Item& it, int b, auto taps_y, auto taps_c,
                         auto affine_flag, auto staged_flag) {
    constexpr int TY = decltype(taps_y)::value;
    constexpr int TC = decltype(taps_c)::value;
    constexpr bool kAffine = decltype(affine_flag)::value;
    constexpr bool kStaged = decltype(staged_flag)::value;
    const int twp = pad4(a.tile_w);
    const float* const cw_y =
        reinterpret_cast<const float*>(smem + L.cols + b * cb_bytes);
    const int* const cl_y =
        reinterpret_cast<const int*>(cw_y + twp * a.luma.col_taps);
    const float* const cw_c = reinterpret_cast<const float*>(
        smem + L.cols + b * cb_bytes + cols_c_bytes(a));
    const int* const cl_c =
        reinterpret_cast<const int*>(cw_c + twp * a.chroma.col_taps);
    const int tp_y = a.luma.t_pitch, tp_c = 2 * a.chroma.t_pitch;
    const int y0 = it.band * R;
    const int rows = min(R, a.h - y0);
    const int x0 = it.tile * a.tile_w;
    const int cols = min(a.tile_w, a.w - x0);
    // the first columns are absolute: the row pass's results start at the
    // tile's first source column
    const float* const ty0 = t_y - tiles_y[2 * it.tile];
    const float* const tc0 = t_c - 2 * tiles_c[2 * it.tile];
    T* const out = static_cast<T*>(a.out) +
                   (((int64_t)it.img * a.h + y0) * a.w + x0) * 3;
    // the staged output keeps the output's offset in its 16-byte chunk
    T* const dst = kStaged
        ? reinterpret_cast<T*>(stage + (reinterpret_cast<uintptr_t>(out) &
                                        15))
        : out;
    const int64_t pitch = (int64_t)a.w * 3;
    if constexpr (TY > 0) {
      const int xl = tid;
      if (xl < cols) {
        const float* ty = ty0 + cl_y[xl];
        const float* tc = tc0 + 2 * cl_c[xl];
        float wy[TY], wc[TC];
#pragma unroll
        for (int i = 0; i < TY; ++i) wy[i] = cw_y[i * twp + xl];
#pragma unroll
        for (int i = 0; i < TC; ++i) wc[i] = cw_c[i * twp + xl];
        T* const d = dst + xl * 3;
        // half the rows' sums and colour at a time, then their stores,
        // so the rows' chains run side by side
#pragma unroll
        for (int k0 = 0; k0 < R; k0 += R / 2) {
          float v[R / 2][3];
#pragma unroll
          for (int k = 0; k < R / 2; ++k) {
            float yv = 0.f, cb = 0.f, cr = 0.f;
#pragma unroll
            for (int i = 0; i < TY; ++i)
              yv = fmaf(wy[i], ty[(k0 + k) * tp_y + i], yv);
#pragma unroll
            for (int i = 0; i < TC; ++i) {
              const float2 c = *reinterpret_cast<const float2*>(
                  tc + (k0 + k) * tp_c + 2 * i);
              cb = fmaf(wc[i], c.x, cb);
              cr = fmaf(wc[i], c.y, cr);
            }
            colour<kU8, kAffine>(a, yv, cb, cr, v[k]);
          }
#pragma unroll
          for (int k = 0; k < R / 2; ++k) {
            if (k0 + k < rows) put(d + (k0 + k) * pitch, v[k]);
          }
        }
      }
    } else {
      const int dr = kThreads / cols, dx = kThreads - dr * cols;
      int r = tid / cols, xl = tid - r * cols;
      for (int u = tid; u < rows * cols; u += kThreads) {
        const float* ty = ty0 + r * tp_y + cl_y[xl];
        const float* tc = tc0 + r * tp_c + 2 * cl_c[xl];
        float yv = 0.f, cb = 0.f, cr = 0.f;
        for (int i = 0; i < a.luma.col_taps; ++i)
          yv = fmaf(cw_y[i * twp + xl], ty[i], yv);
        for (int i = 0; i < a.chroma.col_taps; ++i) {
          const float wi = cw_c[i * twp + xl];
          const float2 c = *reinterpret_cast<const float2*>(tc + 2 * i);
          cb = fmaf(wi, c.x, cb);
          cr = fmaf(wi, c.y, cr);
        }
        float v[3];
        colour<kU8, kAffine>(a, yv, cb, cr, v);
        put(dst + r * pitch + xl * 3, v);
        xl += dx;
        r += dr;
        if (xl >= cols) {
          xl -= cols;
          ++r;
        }
      }
    }
  };

  // the column pass for this launch's affine and staging, and the tile's
  // taps
  auto columns_for = [&](const Item& it, int b, auto affine_flag,
                         auto staged_flag) {
    const int ty = a.luma.col_taps, tc = a.chroma.col_taps;
    if (a.tile_w <= kThreads && ty == 2 && tc == 2) {
      column_pass(it, b, Int<2>(), Int<2>(), affine_flag, staged_flag);
    } else if (a.tile_w <= kThreads && ty == 4 && tc == 2) {
      column_pass(it, b, Int<4>(), Int<2>(), affine_flag, staged_flag);
    } else {
      column_pass(it, b, Int<0>(), Int<0>(), affine_flag, staged_flag);
    }
  };
  auto columns = [&](const Item& it, int b) {
    if (a.affine) {
      if (a.staged) {
        columns_for(it, b, Flag<true>(), Flag<true>());
      } else {
        columns_for(it, b, Flag<true>(), Flag<false>());
      }
    } else if (a.staged) {
      columns_for(it, b, Flag<false>(), Flag<true>());
    } else {
      columns_for(it, b, Flag<false>(), Flag<false>());
    }
  };

  Pending pending = load_next();
  Pending pending2 = load_next();
  Item prev = pending.it;
  int cols_b = 0;  // item i's column buffer
  int i = 0;
  for (; pending.valid; ++i) {
    const Pending cur = pending;
    pending = pending2;
    cp_async_wait<1>();
    __syncthreads();  // item i's copies landed; t and stage free

    // the block's item i + 2, decoded, for the loader after the next
    // barrier; and one more number, fetched
    if (tid == 0) {
      next_item[i & 1] = decode_item(2 * gridDim.x + ahead);
      ahead = atomicAdd(a.queue, 1);
    }
    if (a.staged && i > 0) copy_out(prev);
    row_pass(cur, i & 1);
    __syncthreads();  // t ready; stage written out

    pending2 = load_next();  // item i + 2
    columns(cur.it, cols_b);
    if (a.tiles > 1 && ++cols_b == 3) cols_b = 0;
    prev = cur.it;
  }
  cp_async_wait<0>();
  if (a.staged && i > 0) {
    __syncthreads();  // the last item's stage written
    copy_out(prev);
  }
  // The last block to finish leaves the queue at 0 for the next launch:
  // every block's fetches come before its count of blocks done.
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(a.queue + 1, 1) == (int)gridDim.x - 1) {
      a.queue[0] = 0;
      a.queue[1] = 0;
    }
  }
}

typedef void (*Kernel)(const Args);

Kernel kernel_for(int out_u8) {
  return out_u8 ? yuv420_kernel<true> : yuv420_kernel<false>;
}

// Lets the kernel take up to kMaxSmem bytes of dynamic shared memory on the
// current device, once per instance and device (a launch being captured
// into a CUDA graph then makes no call but the launch).
cudaError_t allow_smem(int out_u8) {
  static unsigned long long done[2];  // device bits per instance
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done[out_u8 != 0] & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel_for(out_u8),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess) done[out_u8 != 0] |= bit;
  return err;
}

}  // namespace

// sizeof(Args), which the ctypes mirror in infeed.py must equal.
extern "C" int yuv420_resize_normalize_args_size() {
  return (int)sizeof(Args);
}

// Shared memory one block of this plan lays out.
extern "C" int yuv420_resize_normalize_smem(const Args* a, int out_u8) {
  return layout(*a, out_u8 ? 1 : 4).total;
}

// Blocks of this plan that fit on one SM, and the kernel's registers and
// local memory (spills) per thread. Returns a CUDA error (0 = success).
extern "C" int yuv420_resize_normalize_occupancy(int out_u8, int smem,
                                                 int* blocks, int* registers,
                                                 int* local_bytes) {
  const Kernel k = kernel_for(out_u8);
  cudaError_t err = allow_smem(out_u8);
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

// Launches the kernel once on `stream` with `grid` persistent blocks, at
// most one per item; returns cudaGetLastError() (0 = launched). The plan
// (taps, rings, tiles, smem) comes from infeed.py::yuv420_plan; out holds
// N*h*w*3 elements of float32, or of uint8 with out_u8; x is contiguous;
// queue holds two 0s, which the kernel leaves so, and no other launch uses
// it at the same time.
extern "C" int yuv420_resize_normalize_launch(const Args* a, int out_u8,
                                              int grid, int smem,
                                              void* stream) {
  const Plane* planes[2] = {&a->luma, &a->chroma};
  bool ok = grid >= 1 && a->items >= 1 && a->tiles >= 1 && a->bands >= 1 &&
            a->queue != nullptr && grid <= a->items &&
            a->items + 3LL * grid < (1LL << 31) &&
            smem <= kMaxSmem && smem == layout(*a, out_u8 ? 1 : 4).total &&
            (!a->staged || a->tiles == 1);
  for (const Plane* p : planes) {
    ok = ok && p->depth >= 1 && p->pitch % 16 == 0 &&
         p->t_pitch % kChunk == 0 && p->col_taps >= 2 &&
         p->col_taps % 2 == 0;
  }
  if (!ok) return (int)cudaErrorInvalidConfiguration;
  const cudaError_t err = allow_smem(out_u8);
  if (err != cudaSuccess) return (int)err;
  kernel_for(out_u8)<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}
