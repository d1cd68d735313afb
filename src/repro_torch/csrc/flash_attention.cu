// Causal GQA flash attention (forward) for Hopper (sm_90a), with a plain C
// interface loaded through ctypes by repro_torch/kernels/flash_attention.py.
//
// Replaces the Pallas kernel of src/repro/kernels/flash_attention.py
// (flash_attention, :74; body _attn_kernel, :32): causal attention with an
// online softmax, f32 running max, sum and accumulator, KV tiles above the
// diagonal skipped, the element mask applied only where a tile can hold a
// masked element, and q head h reading kv head h / (H / KV).
//
// Layout. q is (B, S, H, D), k and v are (B, S, KV, D), read through their
// batch, sequence and head strides (the last dimension is contiguous), so
// no transpose is made as flash_attention.py:92-94 does. GQA is by index:
// no repeated K/V is ever written. The output is a contiguous (B, S, H, D)
// tensor of q's dtype. S need not be a multiple of the tile: rows and
// columns past S are zero-filled in shared memory and masked.
//
// What bounds it on the card. At the llama3.2-1b prefill (B, S, H, KV, D) =
// (4, 2048, 32, 8, 64) the causal work is 68.7 GFLOP against 84 MB of q, k,
// v and out, so the tensor cores (989 TFLOP/s bf16) would bound it at about
// 69 us and it is operation-bound. This first kernel uses no tensor core:
// it multiplies in f32 on the CUDA cores (67 TFLOP/s at most), so it is
// bound by the f32 FMA rate and by shared-memory loads, an order of
// magnitude above that bound. wgmma, TMA and a pipelined tile ring are
// later work.
//
// What the simple design does. One block of 4 warps takes 64 query rows of
// one (b, h); each warp owns 16 of them. K/V tiles of 64 rows are staged
// through shared memory in f32; for each tile a lane computes the scores of
// its 2 key columns for the warp's 16 rows (float4 loads, q broadcast),
// the warp reduces max and sum with shuffles, and the probabilities go
// through shared memory to the P.V product, where a lane owns D / 32
// accumulator columns per row. Rows and columns are padded by 4 floats so
// the float4 loads of a warp hit distinct banks.
//
// Numbers. Scores, softmax and accumulator are f32 whatever the input
// dtype (f32 or bf16), as in the Pallas kernel; exp is the accurate expf
// (no fast math), the output is acc / max(l, 1e-30) rounded once to the
// output dtype. Only the order of the f32 sums differs from the plain
// version.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the cudaError_t of its launch.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;                  // query rows per block
constexpr int kBK = 64;                  // key rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kBQ / kWarps;      // query rows per warp
// the causal loop below pairs query tile qt with key tiles 0..qt
static_assert(kBQ == kBK, "query and key tiles must be the same size");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// Shared memory of one block, in floats: q and k tiles with rows padded to
// D + 4, the v tile, and each warp's probabilities. Mirrors
// repro_torch.kernels.flash_attention.smem_bytes.
template <int D> constexpr int smem_floats() {
  return 2 * kBQ * (D + 4) + kBK * D + kBQ * kBK;
}

// Stage 64 rows of a (.., S, .., D) operand starting at sequence index
// s0 into dst (row stride ld), in f32; rows at or past S read as 0.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, int ld,
                                      const T* __restrict__ src,
                                      int64_t row_stride, int s0, int S) {
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = s0 + r;
    dst[r * ld + d] = s < S ? to_f32(src[int64_t(s) * row_stride + d]) : 0.f;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int S, int H, int KV,
    int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
    int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, float scale) {
  constexpr int LD = D + 4;              // padded row of the q and k tiles
  constexpr int DPL = (D + 31) / 32;     // accumulator columns per lane
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sP = sV + kBK * D;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * kRows;         // the warp's first row in the tile
  const int c0 = lane * DPL;             // the lane's first output column

  stage<T, D>(sQ, LD, q + b * qsb + h * qsh, qss, q0, S);
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[r][t] = 0.f;
  }

  // block-causal: only key tiles whose start <= the query tile's end
  for (int kt = 0; kt <= qt; ++kt) {
    const int kv0 = kt * kBK;
    __syncthreads();  // the previous tile's k, v and p are no longer read
    stage<T, D>(sK, LD, kb, kss, kv0, S);
    stage<T, D>(sV, D, vb, vss, kv0, S);
    __syncthreads();

    // scores of key columns lane and lane + 32 for the warp's rows
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 k0 = *reinterpret_cast<const float4*>(sK + lane * LD + d);
      const float4 k1 =
          *reinterpret_cast<const float4*>(sK + (lane + 32) * LD + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(sQ + (row0 + r) * LD + d);
        s[r][0] += qv.x * k0.x + qv.y * k0.y + qv.z * k0.z + qv.w * k0.w;
        s[r][1] += qv.x * k1.x + qv.y * k1.y + qv.z * k1.z + qv.w * k1.w;
      }
    }

    // online softmax, one row at a time across the warp
    // a tile below the diagonal ends before q0 < S: nothing to mask
    const bool diagonal = kt == qt;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = q0 + row0 + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = kv0 + lane + 32 * c;
        s[r][c] = (!diagonal || (j <= i && j < S)) ? s[r][c] * scale
                                                   : -INFINITY;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      // every processed tile holds a key at or before each of its rows,
      // so m_new is finite; the guard keeps exp(-inf - -inf) out anyway
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[r] - m_use);
      const float p0 = expf(s[r][0] - m_use), p1 = expf(s[r][1] - m_use);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int t = 0; t < DPL; ++t) acc[r][t] *= alpha;
      sP[(row0 + r) * kBK + lane] = p0;
      sP[(row0 + r) * kBK + lane + 32] = p1;
    }
    __syncwarp();

    // acc += p . v, four key rows at a time
    if (c0 < D) {
      for (int j = 0; j < kBK; j += 4) {
        float vv[4][DPL];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int t = 0; t < DPL; ++t) vv[u][t] = sV[(j + u) * D + c0 + t];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 p =
              *reinterpret_cast<const float4*>(sP + (row0 + r) * kBK + j);
#pragma unroll
          for (int t = 0; t < DPL; ++t)
            acc[r][t] += p.x * vv[0][t] + p.y * vv[1][t] + p.z * vv[2][t] +
                         p.w * vv[3][t];
        }
      }
    }
  }

  if (c0 < D) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = q0 + row0 + r;
      if (i >= S) continue;
      const float lr = fmaxf(l[r], 1e-30f);
      T* o = out + ((int64_t(b) * S + i) * H + h) * D + c0;
#pragma unroll
      for (int t = 0; t < DPL; ++t) o[t] = from_f32<T>(acc[r][t] / lr);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int KV, const int64_t* st,
                   float scale, cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * int(sizeof(float));
  auto kern = flash_fwd_kernel<T, D>;
  // above 48 KB only after opting in: once per device, not on every
  // launch (a launch may be captured in a CUDA graph)
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KV, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       void* out, int B, int S, int H, int KV, int D,
                       const int64_t* st, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, S, H, KV, st, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, B, S, H, KV, st, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, B, S, H, KV, st, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, S, H, KV, st, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, H, D), k and v (B, S, KV, D), out (B, S, H, D) contiguous;
// strides[9] = q's (b, s, h), k's (b, s, h), v's (b, s, h) strides in
// elements; dtype 0 = float32, 1 = bfloat16. H % KV == 0 and D in
// {16, 32, 64, 128} are checked by the caller.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, long long B,
                                   long long S, long long H, long long KV,
                                   long long D, const long long* strides,
                                   float scale, int dtype, void* stream) {
  int64_t st[9];
  for (int i = 0; i < 9; ++i) st[i] = strides[i];
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, out, int(B), int(S), int(H), int(KV),
                             int(D), st, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, int(B), int(S), int(H),
                                     int(KV), int(D), st, scale, s);
  return cudaErrorInvalidValue;
}
