// The inference epilogue of a conv unit, for Hopper (sm_90a): the conv's
// bias, BatchNorm with its running statistics, a residual and ReLU, applied
// to the bf16 conv output in one pass.
//
//   y, residual, out  bf16 [N, C, H, W], channels_last or contiguous NCHW
//                     (the three in the same layout)
//   bias              bf16 [C] or none
//   mean, mul, beta   fp32 [C]; mul = rsqrt(running_var + eps) * weight
//
// Per element, with c its channel, exactly what the eager chain of PyTorch
// ops it replaces computes (models/layers.py: the bf16 bias add, BatchNorm's
// fp32 formula, the cast back, the residual add and F.relu), in its order
// and at its precision:
//
//   v = float(y)
//   v = float(bf16_rn(v + float(bias[c])))          if there is a bias
//   v = ((v - mean[c]) * mul[c]) + beta[c]           three fp32 roundings
//   t = bf16_rn(v)
//   t = bf16_rn(float(t) + float(residual))          if there is a residual
//   t = t < 0 ? 0 : t                                if relu (NaN stays)
//
// The fp32 steps are __fsub_rn, __fmul_rn and __fadd_rn, so the compiler
// cannot contract them into an FMA: the eager chain rounds after each.
//
// What bounds it: memory. Each element is read once (and its residual) and
// written once, 4 or 6 bytes, against ~40 bytes for the eager chain's six
// passes; the per-channel vectors are a few KB and stay in L1. So the
// design is a plain streaming loop with no shared memory:
//
// * A persistent grid (the blocks that fit on the card at once) walks the
//   tensor with a grid stride; each thread takes kUnroll 16-byte vectors of
//   8 bf16 an iteration, with all their loads issued before any math.
// * channels_last with C % 8 == 0: a vector's 8 elements are 8 neighbouring
//   channels of one pixel; their per-channel terms are float4 loads through
//   the read-only cache. NCHW with H*W % 8 == 0: a vector lies in one
//   channel plane, and its terms are 3 or 4 scalar loads. The channel of a
//   thread's next vector is carried forward from the last one, so the loop
//   divides nothing.
// * Everything else (another channel count or plane size, a pointer not
//   16-byte aligned) takes a scalar grid-stride loop over elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // as THREADS in epilogue.py
constexpr int kVec = 8;         // bf16 per 16-byte access
constexpr int kUnroll = 2;      // vectors in flight per thread

// the three launch modes, as MODE_* in epilogue.py
constexpr int kChannelsLast8 = 0;
constexpr int kPlanes8 = 1;
constexpr int kScalar = 2;

struct Args {
  const __nv_bfloat16* __restrict__ y;
  const __nv_bfloat16* __restrict__ bias;
  const float* __restrict__ mean;
  const float* __restrict__ mul;
  const float* __restrict__ beta;
  const __nv_bfloat16* __restrict__ residual;
  __nv_bfloat16* __restrict__ out;
  long long n;    // elements
  long long hw;   // H * W
  int c;          // channels
  int channels_last;
  int relu;
};

// one element; the vector kernels fix bias and residual at compile time,
// the scalar kernel passes them as run-time flags
__device__ __forceinline__ __nv_bfloat16 apply(bool has_bias, bool has_res,
                                               bool relu, float v, float b,
                                               float m, float s, float o,
                                               __nv_bfloat16 r) {
  if (has_bias) v = __bfloat162float(__float2bfloat16_rn(__fadd_rn(v, b)));
  v = __fadd_rn(__fmul_rn(__fsub_rn(v, m), s), o);
  __nv_bfloat16 t = __float2bfloat16_rn(v);
  if (has_res) {
    t = __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(t), __bfloat162float(r)));
  }
  if (relu && __bfloat162float(t) < 0.0f) t = __ushort_as_bfloat16(0);
  return t;
}

union Pack {
  uint4 u;
  __nv_bfloat16 h[kVec];
};

// channels_last, C % 8 == 0: vector v holds channels (8v mod C) .. +7
template <bool kBias, bool kRes>
__global__ void __launch_bounds__(kThreads)
    epilogue_channels_last8(Args a) {
  const long long nv = a.n / kVec;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const uint4* __restrict__ y = reinterpret_cast<const uint4*>(a.y);
  const uint4* __restrict__ r = reinterpret_cast<const uint4*>(a.residual);
  uint4* __restrict__ out = reinterpret_cast<uint4*>(a.out);
  // channel of the first element of this thread's vectors, carried forward
  const int step = (int)((stride * kVec) % a.c);
  int c = (int)((first * kVec) % a.c);
  for (long long v0 = first; v0 < nv; v0 += kUnroll * stride) {
    Pack yv[kUnroll], rv[kUnroll];
    int cs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * stride;
      cs[u] = c;
      c += step;
      if (c >= a.c) c -= a.c;
      if (v < nv) {
        yv[u].u = y[v];
        if (kRes) rv[u].u = r[v];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * stride;
      if (v >= nv) break;
      const int c0 = cs[u];
      float m[kVec], s[kVec], o[kVec], b[kVec];
      *reinterpret_cast<float4*>(m) =
          __ldg(reinterpret_cast<const float4*>(a.mean + c0));
      *reinterpret_cast<float4*>(m + 4) =
          __ldg(reinterpret_cast<const float4*>(a.mean + c0 + 4));
      *reinterpret_cast<float4*>(s) =
          __ldg(reinterpret_cast<const float4*>(a.mul + c0));
      *reinterpret_cast<float4*>(s + 4) =
          __ldg(reinterpret_cast<const float4*>(a.mul + c0 + 4));
      *reinterpret_cast<float4*>(o) =
          __ldg(reinterpret_cast<const float4*>(a.beta + c0));
      *reinterpret_cast<float4*>(o + 4) =
          __ldg(reinterpret_cast<const float4*>(a.beta + c0 + 4));
      if (kBias) {
        Pack bv;
        bv.u = __ldg(reinterpret_cast<const uint4*>(a.bias + c0));
#pragma unroll
        for (int j = 0; j < kVec; ++j) b[j] = __bfloat162float(bv.h[j]);
      }
      Pack t;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        t.h[j] = apply(kBias, kRes, a.relu, __bfloat162float(yv[u].h[j]),
                       kBias ? b[j] : 0.0f, m[j], s[j], o[j],
                       kRes ? rv[u].h[j] : __ushort_as_bfloat16(0));
      }
      out[v] = t.u;
    }
  }
}

// contiguous NCHW, H*W % 8 == 0: vector v lies in plane 8v / HW, channel
// (8v / HW) mod C
template <bool kBias, bool kRes>
__global__ void __launch_bounds__(kThreads) epilogue_planes8(Args a) {
  const long long nv = a.n / kVec;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const uint4* __restrict__ y = reinterpret_cast<const uint4*>(a.y);
  const uint4* __restrict__ r = reinterpret_cast<const uint4*>(a.residual);
  uint4* __restrict__ out = reinterpret_cast<uint4*>(a.out);
  // (position in its plane, channel) of this thread's next vector, carried
  // forward by the stride's (elements mod HW, planes mod C)
  const long long e_step = stride * kVec;
  const long long p_step = e_step % a.hw;
  const int c_step = (int)((e_step / a.hw) % a.c);
  long long p = (first * kVec) % a.hw;
  int c = (int)(((first * kVec) / a.hw) % a.c);
  for (long long v0 = first; v0 < nv; v0 += kUnroll * stride) {
    Pack yv[kUnroll], rv[kUnroll];
    int cs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * stride;
      cs[u] = c;
      p += p_step;
      c += c_step;
      if (p >= a.hw) {
        p -= a.hw;
        ++c;
      }
      if (c >= a.c) c -= a.c;
      if (v < nv) {
        yv[u].u = y[v];
        if (kRes) rv[u].u = r[v];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * stride;
      if (v >= nv) break;
      const int ch = cs[u];
      const float m = __ldg(a.mean + ch), s = __ldg(a.mul + ch),
                  o = __ldg(a.beta + ch);
      const float b = kBias ? __bfloat162float(a.bias[ch]) : 0.0f;
      Pack t;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        t.h[j] = apply(kBias, kRes, a.relu, __bfloat162float(yv[u].h[j]),
                       b, m, s, o,
                       kRes ? rv[u].h[j] : __ushort_as_bfloat16(0));
      }
      out[v] = t.u;
    }
  }
}

// any channel count, plane size or alignment: one element at a time
__global__ void __launch_bounds__(kThreads) epilogue_scalar(Args a) {
  const long long stride = (long long)gridDim.x * kThreads;
  const bool has_bias = a.bias != nullptr, has_res = a.residual != nullptr;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < a.n; i += stride) {
    const int ch = a.channels_last ? (int)(i % a.c)
                                   : (int)((i / a.hw) % a.c);
    const float b = has_bias ? __bfloat162float(a.bias[ch]) : 0.0f;
    a.out[i] = apply(has_bias, has_res, a.relu, __bfloat162float(a.y[i]),
                     b, __ldg(a.mean + ch), __ldg(a.mul + ch),
                     __ldg(a.beta + ch),
                     has_res ? a.residual[i] : __ushort_as_bfloat16(0));
  }
}

typedef void (*Kernel)(Args);

template <bool kBias, bool kRes>
Kernel pick(int mode) {
  switch (mode) {
    case kChannelsLast8: return epilogue_channels_last8<kBias, kRes>;
    case kPlanes8: return epilogue_planes8<kBias, kRes>;
    case kScalar: return epilogue_scalar;
    default: return nullptr;
  }
}

// nine kernels in all: a vector kernel per layout for each of bias and
// residual present or not (ReLU is a flag: a uniform branch), and one
// scalar kernel for everything else
Kernel kernel_for(int mode, int has_bias, int has_res) {
  if (has_bias) return has_res ? pick<true, true>(mode)
                               : pick<true, false>(mode);
  return has_res ? pick<false, true>(mode) : pick<false, false>(mode);
}

}  // namespace

// Blocks of this kernel instance that fit on one SM, and its registers and
// local memory (spills) per thread. Returns a CUDA error (0 = success).
extern "C" int conv_epilogue_occupancy(int mode, int has_bias, int has_res,
                                       int* blocks, int* registers,
                                       int* local_bytes) {
  const Kernel k = kernel_for(mode, has_bias, has_res);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

// Launches the epilogue once on `stream` with `grid` blocks in `mode` (the
// caller checked the mode's conditions: layout, C or H*W a multiple of 8,
// 16-byte alignment); bias and residual may be null. Returns
// cudaGetLastError() (0 = launched).
extern "C" int conv_epilogue_launch(
    const void* y, const void* bias, const float* mean, const float* mul,
    const float* beta, const void* residual, void* out, long long n,
    int c, long long hw, int channels_last, int relu, int mode, int grid,
    void* stream) {
  const Kernel k = kernel_for(mode, bias != nullptr, residual != nullptr);
  if (k == nullptr || grid < 1 || c < 1 || hw < 1 || n % (c * hw) != 0 ||
      (mode == kChannelsLast8 && (!channels_last || c % kVec != 0)) ||
      (mode == kPlanes8 && (channels_last || hw % kVec != 0))) {
    return (int)cudaErrorInvalidConfiguration;
  }
  Args a;
  a.y = static_cast<const __nv_bfloat16*>(y);
  a.bias = static_cast<const __nv_bfloat16*>(bias);
  a.mean = mean;
  a.mul = mul;
  a.beta = beta;
  a.residual = static_cast<const __nv_bfloat16*>(residual);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.n = n;
  a.hw = hw;
  a.c = c;
  a.channels_last = channels_last;
  a.relu = relu;
  k<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
