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
// 69 us and it is operation-bound: the kernel has to keep the tensor cores
// fed from shared memory, with the softmax between the two products.
//
// bf16 (the served path): flash_bf16_kernel, the FlashAttention-2 shape on
// mma.sync. One block of 4 warps owns 64 query rows of one (b, h), 16 per
// warp; the grid walks the query tiles from the last (the longest row of
// the causal triangle) to the first, so the heavy blocks start early. q is
// copied once and held in registers as mma A fragments. 64-row K and V
// tiles stream through a 2-stage cp.async ring (16 bytes a thread, bf16 as
// stored, zero-filled past S), so the next tile's copy overlaps this one's
// products. S = q.K^T is mma.sync m16n8k16 (bf16 in, f32 accumulate) with
// K fragments from ldmatrix; the online softmax runs on the f32 accumulator
// fragments in registers, each row's max and sum reduced across the 4 lanes
// that hold it, the mask only on the diagonal tile; the probabilities are
// rounded to bf16 in registers and used directly as the A operand of P.V,
// with V fragments from ldmatrix.trans. Rounding P to bf16 before P.V is
// what the reference model does in both of its attention regimes
// (repro/models/layers.py:202 and :242); the row sum and the accumulator
// stay f32. wgmma and TMA are later work.
//
// float32: flash_fwd_kernel, on the CUDA cores. One block of 4 warps takes
// 64 query rows of one (b, h); each warp owns 16 of them. K/V tiles of 64
// rows are staged through shared memory in f32; for each tile a lane
// computes the scores of its 2 key columns for the warp's 16 rows (float4
// loads, q broadcast), the warp reduces max and sum with shuffles, and the
// probabilities go through shared memory to the P.V product, where a lane
// owns D / 32 accumulator columns per row. Rows and columns are padded by 4
// floats so the float4 loads of a warp hit distinct banks. Scores, softmax
// and accumulator are f32; exp is the accurate expf (no fast math), the
// output is acc / max(l, 1e-30) rounded once to the output dtype. Only the
// order of the f32 sums differs from the plain version. It is bound by the
// f32 FMA rate (67 TFLOP/s at most) and shared-memory loads.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the cudaError_t of its launch.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "tile_mma.cuh"

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
  static int opted[64] = {};
  const cudaError_t err = tile_mma::opt_in_smem(kern, smem, opted);
  if (err != cudaSuccess) return err;
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

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync) fed by a cp.async ring
// ---------------------------------------------------------------------------

using tile_mma::bf16;

// Shared memory of one block of flash_bf16_kernel, in bf16: the q tile and
// 2 stages of (k, v) tiles, rows padded to D + kPad. Mirrors
// repro_torch.kernels.flash_attention.smem_bytes.
template <int D> constexpr int smem_bf16_elems() {
  return 5 * kBQ * (D + tile_mma::kPad);
}

// 3 blocks an SM for D <= 64 leaves up to 168 registers a thread, enough
// to keep the q, score and output fragments without spilling; D = 128
// needs more and runs 2 blocks an SM
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 3 : 2)
    flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int B, int S, int H,
    int KV, int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
    int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, float scale_log2) {
  using namespace tile_mma;
  constexpr int LD = D + kPad;       // row of a shared tile, in bf16
  constexpr int KD = D / 16;         // k-steps of q.k^T
  constexpr int NS = kBK / 8;        // n-tiles of the scores (8 keys each)
  constexpr int ND = D / 8;          // n-tiles of the output
  extern __shared__ uint4 smem_u4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_u4);
  bf16* sK = sQ + kBQ * LD;          // [2][kBK][LD]
  bf16* sV = sK + 2 * kBK * LD;      // [2][kBK][LD]

  // (h, b) vary fastest, query tiles from the last (longest) to the first
  const int nq = (S + kBQ - 1) / kBQ;
  const int h = blockIdx.x % H;
  const int b = (blockIdx.x / H) % B;
  const int qt = nq - 1 - int(blockIdx.x / (H * B));
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bf16* kb = k + b * ksb + kvh * ksh;
  const bf16* vb = v + b * vsb + kvh * vsh;

  load_tile64<kThreads>(sQ, LD, q + b * qsb + h * qsh, qss, q0, S, D);
  load_tile64<kThreads>(sK, LD, kb, kss, 0, S, D);
  load_tile64<kThreads>(sV, LD, vb, vss, 0, S, D);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // the warp's 16 query rows as A fragments, for the whole key loop
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldmatrix_x4(qf[kk], sQ + (warp * 16 + ldm_row(lane, true)) * LD +
                            kk * 16 + ldm_col(lane, true));

  // this lane holds rows g and g + 8 of the warp's 16: m, l per row
  float o[ND][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const int row_g = q0 + warp * 16 + g;  // sequence index of row g

  // block-causal: key tiles 0 .. qt, tile kt + 1 copied while kt is used
  for (int kt = 0; kt <= qt; ++kt) {
    const int st = kt & 1;
    if (kt < qt) {
      load_tile64<kThreads>(sK + (st ^ 1) * kBK * LD, LD, kb, kss,
                            (kt + 1) * kBK, S, D);
      load_tile64<kThreads>(sV + (st ^ 1) * kBK * LD, LD, vb, vss,
                            (kt + 1) * kBK, S, D);
    }
    cp_async_commit();  // an empty group on the last tile keeps the count
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cK = sK + st * kBK * LD;
    const bf16* cV = sV + st * kBK * LD;

    // s = q . k^T for the warp's 16 rows and the tile's 64 keys
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, cK + (np * 16 + ldm_row(lane, false)) * LD +
                            kk * 16 + ldm_col(lane, false));
        mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // only the diagonal tile holds masked keys (a tile below it ends
    // before q0 < S)
    if (kt == qt) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = row_g + (e >= 2 ? 8 : 0);
          const int j = kt * kBK + n * 8 + 2 * t + (e & 1);
          if (j > i || j >= S) s[n][e] = -INFINITY;
        }
    }

    // online softmax on the accumulator fragments, max on the raw scores,
    // exp2 of (score - max) * scale * log2(e) as one FMA; a row's 64
    // scores lie in the 4 lanes of its quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NS; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      // each processed tile holds a key at or before each of its rows, so
      // m_new is finite; the guard keeps exp(-inf - -inf) out anyway
      const float ms = (m_new == -INFINITY ? 0.f : m_new) * scale_log2;
      const float alpha = exp2_ftz(fmaf(m[r], scale_log2, -ms));
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[n][2 * r] = exp2_ftz(fmaf(s[n][2 * r], scale_log2, -ms));
        s[n][2 * r + 1] = exp2_ftz(fmaf(s[n][2 * r + 1], scale_log2, -ms));
        sum += s[n][2 * r] + s[n][2 * r + 1];
      }
      l[r] = l[r] * alpha + sum;  // this lane's part; the quad sums at the end
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }

    // o += bf16(p) . v: the score fragments of keys 16 kk .. 16 kk + 15
    // are the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, cV + (kk * 16 + ldm_row(lane, true)) * LD +
                                  dp * 16 + ldm_col(lane, true));
        mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int i = row_g + 8 * r;
    if (i >= S) continue;
    const float lr = fmaxf(l[r], 1e-30f);
    bf16* orow = out + ((int64_t(b) * S + i) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(o[n][2 * r] / lr, o[n][2 * r + 1] / lr);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int B, int S, int H, int KV,
                        const int64_t* st, float scale, cudaStream_t stream) {
  constexpr int smem = smem_bf16_elems<D>() * int(sizeof(bf16));
  auto kern = flash_bf16_kernel<D>;
  static int opted[64] = {};
  const cudaError_t err = tile_mma::opt_in_smem(kern, smem, opted);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((S + kBQ - 1) / kBQ) * H * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<unsigned(blocks), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), B, S, H, KV,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v,
                          void* out, int B, int S, int H, int KV, int D,
                          const int64_t* st, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch_bf16<16>(q, k, v, out, B, S, H, KV, st, scale, s);
    case 32: return launch_bf16<32>(q, k, v, out, B, S, H, KV, st, scale, s);
    case 64: return launch_bf16<64>(q, k, v, out, B, S, H, KV, st, scale, s);
    case 128:
      return launch_bf16<128>(q, k, v, out, B, S, H, KV, st, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, H, D), k and v (B, S, KV, D), out (B, S, H, D) contiguous;
// strides[9] = q's (b, s, h), k's (b, s, h), v's (b, s, h) strides in
// elements; dtype 0 = float32 (flash_fwd_kernel), 1 = bfloat16
// (flash_bf16_kernel). H % KV == 0 and D in {16, 32, 64, 128} are checked
// by the caller, and for bfloat16 that q, k, v start on 16 bytes and their
// strides are multiples of 8 elements (the cp.async copies are 16 bytes).
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
    return dispatch_bf16(q, k, v, out, int(B), int(S), int(H), int(KV),
                         int(D), st, scale, s);
  return cudaErrorInvalidValue;
}
