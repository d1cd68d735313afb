// Mamba-2 chunked SSD scan for Hopper (sm_90a), the forward and a bf16
// backward (ssd_scan_bwd; its note opens its section below), with a plain
// C interface loaded through ctypes by repro_torch/kernels/ssd_scan.py.
//
// Replaces the Pallas kernel of src/repro/kernels/ssd_scan.py (ssd_scan,
// :70; body _ssd_kernel, :29). For each (b, h) a loop over the chunks of
// length Q, in order, carries an f32 (P, N) state S. With cs the inclusive
// cumsum of a = A.dt over the chunk and x = X.dt:
//   y_i = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) x_j + exp(cs_i) C_i . S
//   S  <- exp(cs_last) S + sum_j (x_j exp(cs_last - cs_j)) B_j^T
// B and C are shared across heads. Only Y is returned.
//
// What bounds it on the card. At the mamba2-130m prefill (B, S, H, P, N) =
// (4, 2048, 24, 64, 128) with Q = 256, the function reads and writes 55 MB
// (X, Adt, B, C, Y) and does 16.1 GFLOP over the causal pairs: it is
// bound by bytes, at about 17 us. A kernel that walks the chunks of one
// (b, h) in order runs 96 blocks on 132 SMs; the work has to be spread over
// the chunks, and the products put on the tensor cores.
//
// bf16 (the served path): three passes, the decomposition ssd_chunked
// follows (kernels/ssd_scan.py), each parallel over chunks:
//   (a) ssd_states_kernel, one block per (b, h, chunk, 64 rows of P): the
//       chunk's inclusive cumsum by a parallel scan in the block
//       (block_cumsum), then the chunk's state contribution
//       (x o exp(cs_last - cs))^T . B as a (P, N) product over the chunk
//       on mma.sync, x o decay rounded to bf16 in shared memory, written in
//       f32 to a scratch buffer (B, H, nc, P, N), and exp(cs_last) per
//       chunk to a second one (B, H, nc);
//   (b) ssd_state_pass_kernel, one thread per (b, h, state element), in
//       order over the chunks: turns the contributions in place into the
//       f32 state entering each chunk (carry * decay + contribution, as the
//       plain version's loop);
//   (c) ssd_chunk_scan_kernel, one block per (b, h, chunk, 64-row query
//       tile), longest tiles first: the same block_cumsum, then
//       Y = exp(cs) o (C . bf16(S_in)^T) + sum over key tiles <= the query
//       tile of bf16((C . B^T) o L) . X, with C . B^T on mma.sync, the
//       decay L = exp(cs_i - cs_j) (j <= i) built on the f32 accumulator
//       fragments and rounded to bf16 in registers as the A operand of the
//       product with X. C is held in registers as A fragments; 64-row B
//       and X tiles stream through a 2-stage cp.async ring.
// The scratch round trip (2 x 25 MB at mamba2-130m) is this design's cost,
// not the function's. The products take bf16 operands and accumulate in
// f32; the cumsum adds in a fixed order shared by passes (a) and (c).
//
// float32: ssd_scan_kernel, on the CUDA cores, one block of 256 threads
// (16 x 16) per (b, h). The state stays in shared memory for the whole
// sequence (P x N f32: 32 KB at P = 64, N = 128). A chunk of Q = 256 would
// make the (Q, Q) f32 decay and score matrices 256 KB, over the 227 KB a
// block may have, so they are never formed whole: the chunk is cut into
// 64-row tiles, and for each query tile i and key tile j <= i the 64 x 64
// scores (C_i . B_j) exp(cs_i - cs_j) are built from the staged tiles and
// the chunk's cumsum in shared memory, then multiplied into the query
// tile's Y, which each thread keeps in registers (4 rows x P / 16 columns).
// Tile rows are padded to N + 1 floats so a warp's loads hit distinct
// banks. Everything is f32; the cumsum runs in order, one thread, like
// jnp.cumsum; exp is the accurate expf. Y is rounded once to X's dtype.
// Only the order of the f32 sums differs from the plain version. It is
// bound by one SM's f32 FMA rate and shared-memory loads.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the cudaError_t of its launch.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "tile_mma.cuh"

namespace {

constexpr int kT = 64;          // rows of a query or key tile within a chunk
constexpr int kThreads = 256;   // 16 x 16
constexpr int kMaxN = 128;      // state width: N % 16 == 0, N <= kMaxN

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

// Shared memory of one block, in floats: the state (P rows of N + 1), the
// chunk's cumsum (Q), the C and B tiles (64 rows of N + 1), the X tile
// (64 x P) and the score tile (64 x 65). Mirrors
// repro_torch.kernels.ssd_scan.smem_bytes.
__host__ __device__ constexpr int smem_floats(int P, int N, int Q) {
  return P * (N + 1) + Q + 2 * kT * (N + 1) + kT * P + kT * (kT + 1);
}

// Stage rows r0 .. r0 + 63 of a chunk (row stride `stride`, `cols`
// contiguous columns) into dst (row stride ld) in f32, each row times
// w[r] when w is given; rows at or past the chunk's end Q read as 0.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld,
                                      const T* __restrict__ src,
                                      int64_t stride, int r0, int Q,
                                      int cols, const float* w = nullptr) {
  for (int i = threadIdx.x; i < kT * cols; i += kThreads) {
    const int r = i / cols, c = i - r * cols;
    float val = 0.f;
    if (r0 + r < Q) {
      val = to_f32(src[int64_t(r0 + r) * stride + c]);
      if (w) val *= w[r];
    }
    dst[r * ld + c] = val;
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(
    const T* __restrict__ X, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, T* __restrict__ Y,
    int S, int H, int N, int Q, int64_t xsb, int64_t xss, int64_t xsh,
    int64_t asb, int64_t ass, int64_t ash, int64_t bsb, int64_t bss,
    int64_t csb, int64_t css) {
  constexpr int PB = P / 16;     // columns of P per thread
  constexpr int kMaxNB = kMaxN / 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int NS = N + 1;          // padded row of the state, C and B tiles
  const int NB = N / 16;         // columns of N per thread (state update)
  extern __shared__ float4 smem4[];
  float* sS = reinterpret_cast<float*>(smem4);  // [P][NS] state
  float* sCs = sS + P * NS;                     // [Q] cumsum of a
  float* sC = sCs + Q;                          // [kT][NS]
  float* sB = sC + kT * NS;                     // [kT][NS]
  float* sX = sB + kT * NS;                     // [kT][P]
  float* sL = sX + kT * P;                      // [kT][kT + 1] scores
  float* sW = sL;  // [kT] state-update weights (the score tile is free then)

  for (int i = threadIdx.x; i < P * NS; i += kThreads) sS[i] = 0.f;

  const int ntiles = (Q + kT - 1) / kT;
  for (int s0 = 0; s0 < S; s0 += Q) {
    const T* xc = X + b * xsb + s0 * xss + h * xsh;
    const T* bc = Bm + b * bsb + s0 * bss;
    const T* cc = Cm + b * csb + s0 * css;
    for (int i = threadIdx.x; i < Q; i += kThreads)
      sCs[i] = A[b * asb + (s0 + i) * ass + h * ash];
    __syncthreads();
    if (threadIdx.x == 0) {  // inclusive cumsum, in order
      float run = 0.f;
      for (int i = 0; i < Q; ++i) sCs[i] = run += sCs[i];
    }
    __syncthreads();

    for (int it = 0; it < ntiles; ++it) {
      const int i0 = it * kT;
      stage(sC, NS, cc, css, i0, Q, N);
      __syncthreads();

      // y = exp(cs_i) C_i . S_p: the incoming state
      float acc[4][PB];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int u = 0; u < PB; ++u) acc[a][u] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[PB];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = sC[(ty + 16 * a) * NS + n];
#pragma unroll
        for (int u = 0; u < PB; ++u) sv[u] = sS[(tx + 16 * u) * NS + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int u = 0; u < PB; ++u) acc[a][u] += cv[a] * sv[u];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        const float e = i < Q ? expf(sCs[i]) : 0.f;
#pragma unroll
        for (int u = 0; u < PB; ++u) acc[a][u] *= e;
      }

      // y += ((C_i . B_j) * exp(cs_i - cs_j), j <= i) . x_j, key tiles
      // up to the diagonal
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        stage(sB, NS, bc, bss, j0, Q, N);
        stage(sX, P, xc, xss, j0, Q, P);
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[a][e] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = sC[(ty + 16 * a) * NS + n];
#pragma unroll
          for (int e = 0; e < 4; ++e) bv[e] = sB[(tx + 16 * e) * NS + n];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[a][e] += cv[a] * bv[e];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty + 16 * a;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + tx + 16 * e;
            const float decay =
                (j <= i && i < Q) ? expf(sCs[i] - sCs[j]) : 0.f;
            sL[(ty + 16 * a) * (kT + 1) + tx + 16 * e] = sc[a][e] * decay;
          }
        }
        __syncthreads();
        for (int j = 0; j < kT; ++j) {
          float lv[4], xv[PB];
#pragma unroll
          for (int a = 0; a < 4; ++a) lv[a] = sL[(ty + 16 * a) * (kT + 1) + j];
#pragma unroll
          for (int u = 0; u < PB; ++u) xv[u] = sX[j * P + tx + 16 * u];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int u = 0; u < PB; ++u) acc[a][u] += lv[a] * xv[u];
        }
        __syncthreads();  // sB, sX and sL are restaged next
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        if (i >= Q) continue;
        T* y = Y + ((int64_t(b) * S + s0 + i) * H + h) * P;
#pragma unroll
        for (int u = 0; u < PB; ++u) y[tx + 16 * u] = from_f32<T>(acc[a][u]);
      }
    }

    // S <- exp(cs_last) S + sum_j (x_j exp(cs_last - cs_j)) B_j^T; this
    // thread owns rows ty + 16 u and columns tx + 16 v of the state
    const float last = sCs[Q - 1];
    float su[PB][kMaxNB];
#pragma unroll
    for (int u = 0; u < PB; ++u)
#pragma unroll
      for (int v = 0; v < kMaxNB; ++v) su[u][v] = 0.f;
    for (int jt = 0; jt < ntiles; ++jt) {
      const int j0 = jt * kT;
      for (int j = threadIdx.x; j < kT; j += kThreads)
        sW[j] = j0 + j < Q ? expf(last - sCs[j0 + j]) : 0.f;
      __syncthreads();
      stage(sB, NS, bc, bss, j0, Q, N);
      stage(sX, P, xc, xss, j0, Q, P, sW);
      __syncthreads();
      for (int j = 0; j < kT; ++j) {
        float xv[PB], bv[kMaxNB];
#pragma unroll
        for (int u = 0; u < PB; ++u) xv[u] = sX[j * P + ty + 16 * u];
#pragma unroll
        for (int v = 0; v < kMaxNB; ++v)
          bv[v] = v < NB ? sB[j * NS + tx + 16 * v] : 0.f;
#pragma unroll
        for (int u = 0; u < PB; ++u)
#pragma unroll
          for (int v = 0; v < kMaxNB; ++v) su[u][v] += xv[u] * bv[v];
      }
      __syncthreads();  // sW, sB and sX are restaged next
    }
    const float decay = expf(last);
#pragma unroll
    for (int u = 0; u < PB; ++u)
#pragma unroll
      for (int v = 0; v < kMaxNB; ++v)
        if (v < NB) {
          float* st = sS + (ty + 16 * u) * NS + tx + 16 * v;
          *st = *st * decay + su[u][v];
        }
    __syncthreads();  // the next chunk reads the new state
  }
}

template <typename T, int P>
cudaError_t launch(const void* X, const float* A, const void* Bm,
                   const void* Cm, void* Y, int B, int S, int H, int N,
                   int Q, const int64_t* st, cudaStream_t stream) {
  const int smem = smem_floats(P, N, Q) * int(sizeof(float));
  auto kern = ssd_scan_kernel<T, P>;
  // the size varies with N and Q
  static int opted[64] = {};
  const cudaError_t err = tile_mma::opt_in_smem(kern, smem, opted);
  if (err != cudaSuccess) return err;
  kern<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(X), A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(Y), S, H, N, Q, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_p(const void* X, const float* A, const void* Bm,
                       const void* Cm, void* Y, int B, int S, int H, int P,
                       int N, int Q, const int64_t* st, cudaStream_t s) {
  switch (P) {
    case 16: return launch<T, 16>(X, A, Bm, Cm, Y, B, S, H, N, Q, st, s);
    case 32: return launch<T, 32>(X, A, Bm, Cm, Y, B, S, H, N, Q, st, s);
    case 64: return launch<T, 64>(X, A, Bm, Cm, Y, B, S, H, N, Q, st, s);
    case 128: return launch<T, 128>(X, A, Bm, Cm, Y, B, S, H, N, Q, st, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: three passes over chunks, tensor cores (mma.sync), cp.async ring
// ---------------------------------------------------------------------------

using tile_mma::bf16;

constexpr int kWarpsB = 4;               // warps of a bf16 block
constexpr int kThreadsB = 32 * kWarpsB;
constexpr int kThreadsPass = 256;        // threads of a state-pass block

// Shared memory of one block of passes (a) and (c), in bytes: bf16 tiles
// with rows padded by kPad, then the chunk's cumsum and the scan's warp
// totals in f32. Mirrors repro_torch.kernels.ssd_scan.smem_bytes.
__host__ __device__ constexpr int states_smem_bytes(int P, int N, int Q) {
  // X and B rings of 2 x 64 rows; X holds the block's 64-row slab of P
  return 2 * 2 * 64 * ((P < 64 ? P : 64) + tile_mma::kPad + N +
                       tile_mma::kPad) + 4 * (Q + kWarpsB);
}
__host__ __device__ constexpr int scan_smem_bytes(int P, int N, int Q) {
  // the C tile and B and X rings of 2 x 64 rows; the (P, N) incoming state
  // borrows the second stage, P (N + 8) <= 64 (N + 8) + 64 (P + 8) for
  // P, N <= 128
  return 2 * (3 * 64 * (N + tile_mma::kPad) + 2 * 64 * (P + tile_mma::kPad)) +
         4 * (Q + kWarpsB);
}

// Inclusive cumsum of v[0 .. Q) in shared memory by the block's kThreadsB
// threads: each thread adds its ceil(Q / kThreadsB) contiguous values in
// order, the threads' totals are scanned across each warp by shuffles and
// across the warps in order, and each thread adds its offset back in
// order. The order depends only on Q, so passes (a) and (c) get the same
// bits. tot holds kWarpsB floats. Starts and ends with every thread.
__device__ void block_cumsum(float* v, int Q, float* tot) {
  const int per = (Q + kThreadsB - 1) / kThreadsB;
  const int lo = min(int(threadIdx.x) * per, Q), hi = min(lo + per, Q);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float run = 0.f;
  for (int i = lo; i < hi; ++i) run += v[i];
  float inc = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  float excl = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 31) tot[warp] = inc;
  __syncthreads();
  float base = 0.f;
  for (int w = 0; w < warp; ++w) base += tot[w];
  float acc = lane == 0 ? base : base + excl;
  for (int i = lo; i < hi; ++i) v[i] = acc += v[i];
  __syncthreads();
}

// Pass (a): the state contribution of one chunk to 64 rows of P,
//   states[b, h, c, p, n] = sum_j bf16(x_j[p] exp(cs_last - cs_j)) B_j[n],
// and decay[b, h, c] = exp(cs_last). With kBwd (the backward's pass (b)),
// X is dY, Bm is C and the weight exp(cs_j): the chunk's contribution to
// the state gradient, sum_i bf16(dy_i[p] exp(cs_i)) C_i[n]; `decay` then
// receives the chunk's cumsum, (B, H, S / Q, Q).
template <int P, bool kBwd = false>
__global__ void __launch_bounds__(kThreadsB) ssd_states_kernel(
    const bf16* __restrict__ X, const float* __restrict__ A,
    const bf16* __restrict__ Bm, float* __restrict__ states,
    float* __restrict__ decay, int B, int S, int H, int N, int Q,
    int64_t xsb, int64_t xss, int64_t xsh, int64_t asb, int64_t ass,
    int64_t ash, int64_t bsb, int64_t bss) {
  using namespace tile_mma;
  constexpr int SLAB = P < 64 ? P : 64;  // rows of P of one block
  constexpr int MT = SLAB / 16;          // m-tiles of the slab
  // (m-tile, 16 columns of N) items, dealt round robin to the warps
  constexpr int ITEMS = (MT * (kMaxN / 16) + kWarpsB - 1) / kWarpsB;
  constexpr int LDX = SLAB + kPad;
  const int LDB = N + kPad;
  const int nc = S / Q, ntiles = (Q + 63) / 64;
  extern __shared__ uint4 smem_u4[];
  bf16* sX = reinterpret_cast<bf16*>(smem_u4);             // [2][64][LDX]
  bf16* sB = sX + 2 * 64 * LDX;                            // [2][64][LDB]
  float* sCs = reinterpret_cast<float*>(sB + 2 * 64 * LDB);  // [Q]
  float* sTot = sCs + Q;                                     // [kWarpsB]

  int idx = blockIdx.x;
  const int slab = idx % (P / SLAB);
  idx /= P / SLAB;
  const int c = idx % nc;
  idx /= nc;
  const int h = idx % H, b = idx / H;
  const int s0 = c * Q, p0 = slab * SLAB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bf16* xc = X + b * xsb + int64_t(s0) * xss + h * xsh + p0;
  const bf16* bc = Bm + b * bsb + int64_t(s0) * bss;

  load_tile64<kThreadsB>(sX, LDX, xc, xss, 0, Q, SLAB);
  load_tile64<kThreadsB>(sB, LDB, bc, bss, 0, Q, N);
  cp_async_commit();
  for (int i = threadIdx.x; i < Q; i += kThreadsB)
    sCs[i] = A[b * asb + int64_t(s0 + i) * ass + h * ash];
  __syncthreads();
  block_cumsum(sCs, Q, sTot);
  const float last = sCs[Q - 1];
  if (kBwd && slab == 0) {
    float* out = decay + ((int64_t(b) * H + h) * nc + c) * Q;
    for (int i = threadIdx.x; i < Q; i += kThreadsB) out[i] = sCs[i];
  }
  __syncthreads();
  // the cumsum becomes each position's weight exp(cs_last - cs_j)
  // (exp(cs_j) with kBwd)
  for (int i = threadIdx.x; i < Q; i += kThreadsB)
    sCs[i] = kBwd ? expf(sCs[i]) : expf(last - sCs[i]);

  float acc[ITEMS][2][4];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it)
#pragma unroll
    for (int u = 0; u < 2; ++u)
      acc[it][u][0] = acc[it][u][1] = acc[it][u][2] = acc[it][u][3] = 0.f;

  for (int jt = 0; jt < ntiles; ++jt) {
    const int st = jt & 1;
    if (jt + 1 < ntiles) {
      load_tile64<kThreadsB>(sX + (st ^ 1) * 64 * LDX, LDX, xc, xss,
                             (jt + 1) * 64, Q, SLAB);
      load_tile64<kThreadsB>(sB + (st ^ 1) * 64 * LDB, LDB, bc, bss,
                             (jt + 1) * 64, Q, N);
    }
    cp_async_commit();  // an empty group on the last tile keeps the count
    cp_async_wait<1>();
    __syncthreads();
    bf16* cX = sX + st * 64 * LDX;
    const bf16* cB = sB + st * 64 * LDB;

    // x_j o exp(cs_last - cs_j), rounded to bf16 in place (rows past Q
    // are zero-filled and stay so)
    for (int i = threadIdx.x; i < 64 * SLAB / 2; i += kThreadsB) {
      const int r = i / (SLAB / 2), col = (i - r * (SLAB / 2)) * 2;
      const int j = jt * 64 + r;
      if (j >= Q) continue;
      const float w = sCs[j];
      auto* e = reinterpret_cast<__nv_bfloat162*>(cX + r * LDX + col);
      const float2 f = __bfloat1622float2(*e);
      *e = __floats2bfloat162_rn(f.x * w, f.y * w);
    }
    __syncthreads();

    // acc += (x o w)^T . B over the tile's 64 positions: A fragments of
    // x^T and B fragments of B, both from ldmatrix.trans
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int item = warp + kWarpsB * it;
        const int mt = item % MT, np = item / MT;
        if (np >= N / 16) continue;
        uint32_t af[4], bfr[4];
        ldmatrix_x4_trans(af, cX + (ks * 16 + ldm_row(lane, false)) * LDX +
                                  mt * 16 + ldm_col(lane, false));
        ldmatrix_x4_trans(bfr, cB + (ks * 16 + ldm_row(lane, true)) * LDB +
                                   np * 16 + ldm_col(lane, true));
        mma_bf16(acc[it][0], af, bfr[0], bfr[1]);
        mma_bf16(acc[it][1], af, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  float* out = states + (((int64_t(b) * H + h) * nc + c) * P + p0) * N;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int item = warp + kWarpsB * it;
    const int mt = item % MT, np = item / MT;
    if (np >= N / 16) continue;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float* o = out + (mt * 16 + g) * N + np * 16 + u * 8 + 2 * t;
      *reinterpret_cast<float2*>(o) = make_float2(acc[it][u][0],
                                                  acc[it][u][1]);
      *reinterpret_cast<float2*>(o + 8 * N) = make_float2(acc[it][u][2],
                                                          acc[it][u][3]);
    }
  }
  if (!kBwd && slab == 0 && threadIdx.x == 0)
    decay[(int64_t(b) * H + h) * nc + c] = expf(last);
}

// Pass (b): in place, the contribution of each chunk becomes the state
// entering it; one thread per (b, h, 4 state elements), the chunks in
// order, the loads of 8 chunks in flight at a time. PN % 4 == 0. With
// kReverse (the backward's pass (c)) the chunks run from the last: each
// chunk's contribution to the state gradient becomes the gradient of the
// state leaving it.
template <bool kReverse = false>
__global__ void __launch_bounds__(kThreadsPass) ssd_state_pass_kernel(
    float* __restrict__ states, const float* __restrict__ decay,
    int64_t BH, int nc, int PN) {
  constexpr int kBatch = 8;
  const int64_t i = int64_t(blockIdx.x) * kThreadsPass + threadIdx.x;
  const int PN4 = PN / 4;
  if (i >= BH * PN4) return;
  const int64_t bh = i / PN4;
  float4* s = reinterpret_cast<float4*>(states + bh * nc * PN) + (i - bh * PN4);
  const float* d = decay + bh * nc;
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (c0 + u < nc) v[u] = s[int64_t(kReverse ? nc - 1 - c0 - u : c0 + u)
                               * PN4];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (c0 + u >= nc) break;
      const int cc = kReverse ? nc - 1 - c0 - u : c0 + u;
      s[int64_t(cc) * PN4] = carry;
      const float dc = d[cc];
      carry.x = carry.x * dc + v[u].x;
      carry.y = carry.y * dc + v[u].y;
      carry.z = carry.z * dc + v[u].z;
      carry.w = carry.w * dc + v[u].w;
    }
  }
}

// f32 (P, N) state at src, rounded to bf16 into rows of ld in dst, by the
// whole block
__device__ void stage_state_bf16(bf16* dst, int ld,
                                 const float* __restrict__ src, int P,
                                 int N) {
  constexpr int kBatch = 8;  // float4 loads in flight per thread
  const float4* s4 = reinterpret_cast<const float4*>(src);
  const int n4 = P * N / 4;
  for (int i0 = threadIdx.x; i0 < n4; i0 += kBatch * kThreadsB) {
    float4 f[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i0 + u * kThreadsB < n4) f[u] = s4[i0 + u * kThreadsB];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreadsB;
      if (i >= n4) break;
      const int p = 4 * i / N, n = 4 * i - p * N;
      *reinterpret_cast<uint2*>(dst + p * ld + n) = make_uint2(
          tile_mma::pack_bf16(f[u].x, f[u].y),
          tile_mma::pack_bf16(f[u].z, f[u].w));
    }
  }
}

// Pass (c): Y for 64 query rows of one chunk,
//   y_i = exp(cs_i) C_i . bf16(S_in)^T
//         + sum_{j <= i} bf16((C_i . B_j) exp(cs_i - cs_j)) x_j.
template <int P>
__global__ void __launch_bounds__(kThreadsB) ssd_chunk_scan_kernel(
    const bf16* __restrict__ X, const float* __restrict__ A,
    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
    const float* __restrict__ states, bf16* __restrict__ Y, int B, int S,
    int H, int N, int Q, int64_t xsb, int64_t xss, int64_t xsh, int64_t asb,
    int64_t ass, int64_t ash, int64_t bsb, int64_t bss, int64_t csb,
    int64_t css) {
  using namespace tile_mma;
  constexpr int LDX = P + kPad;
  constexpr int KN = kMaxN / 16;  // most k-steps over N
  constexpr int NP = P / 8;       // n-tiles of Y
  const int LDB = N + kPad, KS = N / 16;
  const int nc = S / Q, ntiles = (Q + 63) / 64;
  extern __shared__ uint4 smem_u4[];
  // the C tile, then 2 stages of (B tile, X tile); the incoming state
  // [P][LDB] fills the second stage before its first tile is copied
  bf16* sC = reinterpret_cast<bf16*>(smem_u4);
  bf16* sRing = sC + 64 * LDB;
  const int stage = 64 * (LDB + LDX);
  bf16* sS = sRing + stage;
  float* sCs = reinterpret_cast<float*>(sRing + 2 * stage);  // [Q]
  float* sTot = sCs + Q;                                     // [kWarpsB]

  // (c, h, b) vary fastest, query tiles from the last (longest) first
  int idx = blockIdx.x;
  const int bhc = B * H * nc;
  const int it = ntiles - 1 - idx / bhc;
  idx %= bhc;
  const int c = idx % nc;
  idx /= nc;
  const int h = idx % H, b = idx / H;
  const int s0 = c * Q, i0 = it * 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bf16* xc = X + b * xsb + int64_t(s0) * xss + h * xsh;
  const bf16* bc = Bm + b * bsb + int64_t(s0) * bss;

  load_tile64<kThreadsB>(sC, LDB, Cm + b * csb + int64_t(s0) * css, css, i0,
                         Q, N);
  load_tile64<kThreadsB>(sRing, LDB, bc, bss, 0, Q, N);
  load_tile64<kThreadsB>(sRing + 64 * LDB, LDX, xc, xss, 0, Q, P);
  cp_async_commit();
  for (int i = threadIdx.x; i < Q; i += kThreadsB)
    sCs[i] = A[b * asb + int64_t(s0 + i) * ass + h * ash];
  if (c > 0)  // the state entering the chunk, rounded to bf16
    stage_state_bf16(sS, LDB,
                     states + ((int64_t(b) * H + h) * nc + c) * P * N, P, N);
  __syncthreads();
  block_cumsum(sCs, Q, sTot);
  cp_async_wait<0>();
  __syncthreads();

  // the warp's 16 rows of C as A fragments, for the whole tile loop
  uint32_t cf[KN][4];
#pragma unroll
  for (int kk = 0; kk < KN; ++kk)
    if (kk < KS)
      ldmatrix_x4(cf[kk], sC + (warp * 16 + ldm_row(lane, true)) * LDB +
                              kk * 16 + ldm_col(lane, true));

  // this lane holds rows g and g + 8 of the warp's 16 (chunk positions)
  const int row_g = i0 + warp * 16 + g;
  const float cs_g = sCs[min(row_g, Q - 1)];
  const float cs_g8 = sCs[min(row_g + 8, Q - 1)];
  float y[NP][4];
#pragma unroll
  for (int n = 0; n < NP; ++n) y[n][0] = y[n][1] = y[n][2] = y[n][3] = 0.f;
  if (c > 0) {
    // y = exp(cs_i) C_i . S_in^T: B fragments of S_in^T from its rows
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      if (kk >= KS) continue;
#pragma unroll
      for (int pp = 0; pp < NP / 2; ++pp) {
        uint32_t sf[4];
        ldmatrix_x4(sf, sS + (pp * 16 + ldm_row(lane, false)) * LDB +
                            kk * 16 + ldm_col(lane, false));
        mma_bf16(y[2 * pp], cf[kk], sf[0], sf[1]);
        mma_bf16(y[2 * pp + 1], cf[kk], sf[2], sf[3]);
      }
    }
    const float e0 = row_g < Q ? expf(cs_g) : 0.f;
    const float e1 = row_g + 8 < Q ? expf(cs_g8) : 0.f;
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      y[n][0] *= e0;
      y[n][1] *= e0;
      y[n][2] *= e1;
      y[n][3] *= e1;
    }
    __syncthreads();  // the second stage is copied into next
  }

  // key tiles 0 .. it, tile jt + 1 copied while jt is used
  for (int jt = 0; jt <= it; ++jt) {
    const int st = jt & 1;
    if (jt < it) {
      bf16* nB = sRing + (st ^ 1) * stage;
      load_tile64<kThreadsB>(nB, LDB, bc, bss, (jt + 1) * 64, Q, N);
      load_tile64<kThreadsB>(nB + 64 * LDB, LDX, xc, xss, (jt + 1) * 64, Q,
                             P);
    }
    cp_async_commit();  // an empty group on the last tile keeps the count
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cB = sRing + st * stage;
    const bf16* cX = cB + 64 * LDB;

    // scores C_i . B_j^T for the warp's 16 rows and the tile's 64 keys
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      if (kk >= KS) continue;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, cB + (np * 16 + ldm_row(lane, false)) * LDB +
                             kk * 16 + ldm_col(lane, false));
        mma_bf16(sc[2 * np], cf[kk], bfr[0], bfr[1]);
        mma_bf16(sc[2 * np + 1], cf[kk], bfr[2], bfr[3]);
      }
    }

    // times the decay exp(cs_i - cs_j), causal within the chunk: only the
    // diagonal tile holds a pair j > i or a row past Q with keys past Q
    const bool diagonal = jt == it;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = row_g + (e >= 2 ? 8 : 0);
        const int j = jt * 64 + n * 8 + 2 * t + (e & 1);
        const float cs_i = e >= 2 ? cs_g8 : cs_g;
        sc[n][e] = (!diagonal || (j <= i && i < Q))
                       ? sc[n][e] * __expf(cs_i - sCs[min(j, Q - 1)])
                       : 0.f;
      }

    // y += bf16(scores) . x_j: the score fragments of keys 16 kk ..
    // 16 kk + 15 are the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
          pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int pp = 0; pp < NP / 2; ++pp) {
        uint32_t xf[4];
        ldmatrix_x4_trans(xf, cX + (kk * 16 + ldm_row(lane, true)) * LDX +
                                  pp * 16 + ldm_col(lane, true));
        mma_bf16(y[2 * pp], pa, xf[0], xf[1]);
        mma_bf16(y[2 * pp + 1], pa, xf[2], xf[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row_g + 8 * r;
    if (i >= Q) continue;
    bf16* yr = Y + ((int64_t(b) * S + s0 + i) * H + h) * P + 2 * t;
#pragma unroll
    for (int n = 0; n < NP; ++n)
      *reinterpret_cast<uint32_t*>(yr + n * 8) =
          pack_bf16(y[n][2 * r], y[n][2 * r + 1]);
  }
}

template <int P, bool kBwd = false>
cudaError_t launch_states(const void* X, const float* A, const void* Bm,
                          float* states, float* decay, int B, int S, int H,
                          int N, int Q, const int64_t* st, cudaStream_t s) {
  static int opted[64] = {};
  const int smem = states_smem_bytes(P, N, Q);
  auto kern = ssd_states_kernel<P, kBwd>;
  const cudaError_t err = tile_mma::opt_in_smem(kern, smem, opted);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * (S / Q) * (P / (P < 64 ? P : 64));
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<unsigned(blocks), kThreadsB, smem, s>>>(
      static_cast<const bf16*>(X), A, static_cast<const bf16*>(Bm), states,
      decay, B, S, H, N, Q, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7]);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_scan(const void* X, const float* A, const void* Bm,
                        const void* Cm, const float* states, void* Y, int B,
                        int S, int H, int N, int Q, const int64_t* st,
                        cudaStream_t s) {
  static int opted[64] = {};
  const int smem = scan_smem_bytes(P, N, Q);
  auto kern = ssd_chunk_scan_kernel<P>;
  const cudaError_t err = tile_mma::opt_in_smem(kern, smem, opted);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * (S / Q) * ((Q + 63) / 64);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<unsigned(blocks), kThreadsB, smem, s>>>(
      static_cast<const bf16*>(X), A, static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), states, static_cast<bf16*>(Y), B, S, H,
      N, Q, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9]);
  return cudaGetLastError();
}

bool bad_shape(long long S, long long N, long long Q) {
  return N % 16 != 0 || N <= 0 || N > kMaxN || Q <= 0 || S % Q != 0;
}

template <bool kReverse>
cudaError_t launch_state_pass(float* states, const float* decay,
                              long long BH, long long nc, long long PN,
                              cudaStream_t s) {
  const long long blocks = (BH * PN / 4 + kThreadsPass - 1) / kThreadsPass;
  if (PN % 4 || blocks <= 0 || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  ssd_state_pass_kernel<kReverse><<<unsigned(blocks), kThreadsPass, 0, s>>>(
      states, decay, BH, int(nc), int(PN));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 backward: the gradients of Y with respect to X, Adt, B and C
// ---------------------------------------------------------------------------
//
// Replaces no Pallas kernel: the reference differentiates ssd_chunked with
// jax's autograd, and the port recomputed it in f32 under torch's, which
// materialises the (b, h, c, q, q) decays. Per chunk, with cs the inclusive
// cumsum of a, L[i, j] = exp(cs_i - cs_j) (j <= i), e = exp(cs),
// w = exp(cs_last - cs), S_in the state entering the chunk and G the
// gradient of the state leaving it:
//   dx_j = sum_{i >= j} (C_i . B_j) L_ij dy_i + w_j G B_j
//   dC_i = sum_h [sum_{j <= i} (dy_i . x_j) L_ij B_j + e_i S_in^T dy_i]
//   dB_j = sum_h [sum_{i >= j} (dy_i . x_j) L_ij C_i + w_j G^T x_j]
//   d(cs)_k = sum_j M_kj - sum_i M_ik + dy_k . (e_k S_in C_k)
//             - x_k . (w_k G B_k),  M_ij = (C_i . B_j)(dy_i . x_j) L_ij
//   da_k = sum_{m >= k} d(cs)_m + <G, S_out>
// (kernels/ssd_scan.py's ssd_chunked_backward is the same in PyTorch).
//
// What bounds it. Its work is about 2.8 times the forward's (work_backward:
// 180.8 GFLOP at the mamba2-130m train step (16, 2048, 24, 64, 128), 482.1
// at granite's (4, 4096, 128, 64, 128), against 0.68 and 1.66 GB of
// inputs and outputs): on the tensor cores 0.18 and 0.49 ms. The design
// puts every product on mma.sync and spreads the work over chunks, as the
// forward does, in seven launches:
//   (1, 2) the forward's passes (a) and (b) as they are: S_in;
//   (3) ssd_states_kernel<P, true>: each chunk's contribution to the state
//       gradient, sum_i bf16(dy_i e_i) C_i^T, and the chunks' cumsums;
//   (4) ssd_state_pass_kernel<true>: the reverse pass, G in place;
//   (5) ssd_bwd_dx_kernel, one block per (b, h, chunk, 64-row key tile),
//       over the query tiles at or after it: dx, and the f32 column and row
//       sums of M with the inter-chunk terms into a scratch of d(cs) parts;
//   (6) ssd_bwd_dbc_kernel, one block per (dC or dB, b, chunk, 64-row
//       tile), the heads looped inside: B and C are shared across heads,
//       so the sum over heads is taken in a fixed order in f32, first of
//       the masked decayed dy . x^T products (one product with B or C per
//       tile pair, not one per head), then of each head's inter-chunk term;
//   (7) ssd_bwd_dadt_kernel, one block per (b, h, chunk): d(cs) from its
//       parts in order, its sum from the chunk's end, and <G, S_out>.
// Precision follows the forward: bf16 operands (x, B, C, dy, the decayed
// scores and dy . x^T sums, the states rounded as the forward rounds them,
// x o w and dy o e) with f32 accumulation; cumsums, decays, state carries
// and every term of d(cs) stay f32, M taken from the f32 fragments. No
// atomics: every sum runs in an order fixed by the shapes, so a call gives
// the same bits every time.

// the sum of v over the 4 lanes of a quad (the lanes of one fragment row);
// every lane gets the same bits
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the sum of v over the 8 quads of a warp (a fragment column)
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

__device__ __forceinline__ float2 bf2_at(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Shared memory of passes (5) and (6), in bytes. Mirror
// repro_torch.kernels.ssd_scan.backward_smem_bytes.
__host__ __device__ constexpr int dx_smem_bytes(int P, int N, int Q) {
  // the key tile's B and X, two stages of a query tile's C and dY, the
  // chunk's cumsum, 4 x 64 column sums and the diagonal tile's 64
  return 2 * 3 * 64 * (N + tile_mma::kPad + P + tile_mma::kPad) +
         4 * ((Q + 3) / 4 * 4) + 4 * 5 * 64;
}
__host__ __device__ constexpr int dbc_smem_bytes(int P, int N) {
  // two stages of (own, other) (64, P) tiles and their 2 x 64 cumsums, two
  // (64, N) tiles of B or C; the (P, N) state borrows the latter
  return 2 * (2 * 2 * 64 * (P + tile_mma::kPad) + 4 * 2 * 64) +
         2 * 2 * 64 * (N + tile_mma::kPad);
}

// Pass (5): for the 64 key rows j of one tile of one (b, h, chunk),
//   dx_j = w_j G B_j + sum_{i >= j} bf16((C_i . B_j) L_ij) dy_i,
// and the parts of d(cs): rowpart[b, h, c, jt, i] = sum over the tile's j
// of M_ij for the query rows i of later tiles; for the tile's own rows the
// same sum over its diagonal pair plus the row's own terms
// dy_j . (e_j C_j S_in^T) - x_j . (w_j B_j G^T) - sum_i M_ij.
template <int P>
__global__ void __launch_bounds__(kThreadsB) ssd_bwd_dx_kernel(
    const bf16* __restrict__ X, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const bf16* __restrict__ dY,
    const float* __restrict__ cs, const float* __restrict__ states,
    const float* __restrict__ grads, bf16* __restrict__ dX,
    float* __restrict__ rowpart, int B, int S, int H, int N, int Q,
    int64_t xsb, int64_t xss, int64_t xsh, int64_t bsb, int64_t bss,
    int64_t csb, int64_t css) {
  using namespace tile_mma;
  constexpr int LDX = P + kPad;
  constexpr int KN = kMaxN / 16;  // most k-steps over N
  constexpr int KP = P / 16;      // k-steps over P
  constexpr int NP = P / 8;       // n-tiles of dx
  const int LDB = N + kPad, KS = N / 16;
  const int nc = S / Q, ntiles = (Q + 63) / 64;
  extern __shared__ uint4 smem_u4[];
  bf16* sB = reinterpret_cast<bf16*>(smem_u4);  // [64][LDB] the key tile's B
  bf16* sX = sB + 64 * LDB;                     // [64][LDX] its X
  bf16* sRing = sX + 64 * LDX;  // 2 x ([64][LDB] C, [64][LDX] dy)
  const int stage = 64 * (LDB + LDX);
  float* sCs = reinterpret_cast<float*>(sRing + 2 * stage);  // [Q]
  float* sPart = sCs + (Q + 3) / 4 * 4;  // [4][64] each warp's column sums
  float* sOwn = sPart + 256;  // [64] the key tile's own rows

  // key tiles from the first (the most query tiles) on; (c, h, b) fastest
  int idx = blockIdx.x;
  const int bhc = B * H * nc;
  const int jt = idx / bhc;
  idx %= bhc;
  const int c = idx % nc;
  idx /= nc;
  const int h = idx % H, b = idx / H;
  const int s0 = c * Q, j0 = jt * 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t dss = int64_t(H) * P, dsb = int64_t(S) * dss;
  const bf16* xc = X + b * xsb + int64_t(s0) * xss + h * xsh;
  const bf16* bc = Bm + b * bsb + int64_t(s0) * bss;
  const bf16* cc = Cm + b * csb + int64_t(s0) * css;
  const bf16* dyc = dY + b * dsb + int64_t(s0) * dss + int64_t(h) * P;
  const int64_t chunk_id = (int64_t(b) * H + h) * nc + c;

  load_tile64<kThreadsB>(sB, LDB, bc, bss, j0, Q, N);
  load_tile64<kThreadsB>(sX, LDX, xc, xss, j0, Q, P);
  // the first stage: the diagonal pair's query tile, the key tile itself
  load_tile64<kThreadsB>(sRing, LDB, cc, css, j0, Q, N);
  load_tile64<kThreadsB>(sRing + 64 * LDB, LDX, dyc, dss, j0, Q, P);
  cp_async_commit();
  for (int i = threadIdx.x; i < Q; i += kThreadsB)
    sCs[i] = cs[chunk_id * Q + i];
  // the (P, N) states borrow the second stage until the pair loop
  bf16* sState = sRing + stage;
  if (c > 0) stage_state_bf16(sState, LDB, states + chunk_id * P * N, P, N);
  cp_async_wait<0>();
  __syncthreads();

  // this lane holds key rows g and g + 8 of the warp's 16
  const int row_g = j0 + warp * 16 + g;
  const float cs_g = sCs[min(row_g, Q - 1)];
  const float cs_g8 = sCs[min(row_g + 8, Q - 1)];
  const float last = sCs[Q - 1];
  const int lr = warp * 16 + g;  // the row within the tile
  float own0 = 0.f, own1 = 0.f;  // the rows' own terms of d(cs)

  if (c > 0) {
    // dy_j . (e_j C_j S_in^T): C_j as A fragments, S_in^T from its rows
    float yo[NP][4];
#pragma unroll
    for (int n = 0; n < NP; ++n)
      yo[n][0] = yo[n][1] = yo[n][2] = yo[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      if (kk >= KS) continue;
      uint32_t af[4];
      ldmatrix_x4(af, sRing + (lr - g + ldm_row(lane, true)) * LDB + kk * 16 +
                          ldm_col(lane, true));
#pragma unroll
      for (int pp = 0; pp < NP / 2; ++pp) {
        uint32_t sf[4];
        ldmatrix_x4(sf, sState + (pp * 16 + ldm_row(lane, false)) * LDB +
                            kk * 16 + ldm_col(lane, false));
        mma_bf16(yo[2 * pp], af, sf[0], sf[1]);
        mma_bf16(yo[2 * pp + 1], af, sf[2], sf[3]);
      }
    }
    const bf16* dy0 = sRing + 64 * LDB;
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      const float2 a = bf2_at(dy0 + lr * LDX + n * 8 + 2 * t);
      const float2 a8 = bf2_at(dy0 + (lr + 8) * LDX + n * 8 + 2 * t);
      d0 += yo[n][0] * a.x + yo[n][1] * a.y;
      d1 += yo[n][2] * a8.x + yo[n][3] * a8.y;
    }
    // every lane shuffles; rows past Q read zeros and are dropped
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);
    own0 = row_g < Q ? d0 * expf(cs_g) : 0.f;
    own1 = row_g + 8 < Q ? d1 * expf(cs_g8) : 0.f;
  }
  __syncthreads();  // S_in is read; G takes its place

  float dx[NP][4];  // dx of rows g, g + 8 of the warp
#pragma unroll
  for (int n = 0; n < NP; ++n) dx[n][0] = dx[n][1] = dx[n][2] = dx[n][3] = 0.f;
  if (c + 1 < nc) {
    stage_state_bf16(sState, LDB, grads + chunk_id * P * N, P, N);
    __syncthreads();
    // w_j B_j G^T: B_j as A fragments, G^T from its rows
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      if (kk >= KS) continue;
      uint32_t af[4];
      ldmatrix_x4(af, sB + (lr - g + ldm_row(lane, true)) * LDB + kk * 16 +
                          ldm_col(lane, true));
#pragma unroll
      for (int pp = 0; pp < NP / 2; ++pp) {
        uint32_t sf[4];
        ldmatrix_x4(sf, sState + (pp * 16 + ldm_row(lane, false)) * LDB +
                            kk * 16 + ldm_col(lane, false));
        mma_bf16(dx[2 * pp], af, sf[0], sf[1]);
        mma_bf16(dx[2 * pp + 1], af, sf[2], sf[3]);
      }
    }
    const float w0 = row_g < Q ? expf(last - cs_g) : 0.f;
    const float w1 = row_g + 8 < Q ? expf(last - cs_g8) : 0.f;
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      const float2 a = bf2_at(sX + lr * LDX + n * 8 + 2 * t);
      const float2 a8 = bf2_at(sX + (lr + 8) * LDX + n * 8 + 2 * t);
      d0 += dx[n][0] * a.x + dx[n][1] * a.y;
      d1 += dx[n][2] * a8.x + dx[n][3] * a8.y;
      dx[n][0] *= w0;
      dx[n][1] *= w0;
      dx[n][2] *= w1;
      dx[n][3] *= w1;
    }
    own0 -= w0 * quad_sum(d0);
    own1 -= w1 * quad_sum(d1);
  }
  __syncthreads();  // the second stage is copied into next

  float msum0 = 0.f, msum1 = 0.f;  // sum over i of M_ij, rows g and g + 8
  const int npairs = ntiles - jt;
  for (int k = 0; k < npairs; ++k) {
    const int it = jt + k, st = k & 1;
    if (k + 1 < npairs) {
      bf16* nx = sRing + (st ^ 1) * stage;
      load_tile64<kThreadsB>(nx, LDB, cc, css, (it + 1) * 64, Q, N);
      load_tile64<kThreadsB>(nx + 64 * LDB, LDX, dyc, dss, (it + 1) * 64, Q,
                             P);
    }
    cp_async_commit();  // an empty group on the last pair keeps the count
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cC = sRing + st * stage;
    const bf16* cDy = cC + 64 * LDB;

    // S^T = B_j . C_i^T for the warp's 16 key rows and the tile's 64 queries
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      if (kk >= KS) continue;
      uint32_t af[4];
      ldmatrix_x4(af, sB + (lr - g + ldm_row(lane, true)) * LDB + kk * 16 +
                          ldm_col(lane, true));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, cC + (np * 16 + ldm_row(lane, false)) * LDB +
                             kk * 16 + ldm_col(lane, false));
        mma_bf16(sc[2 * np], af, bfr[0], bfr[1]);
        mma_bf16(sc[2 * np + 1], af, bfr[2], bfr[3]);
      }
    }
    // times the decay exp(cs_i - cs_j), i >= j, both within the chunk
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = row_g + (e >= 2 ? 8 : 0);
        const int i = it * 64 + n * 8 + 2 * t + (e & 1);
        const float cs_j = e >= 2 ? cs_g8 : cs_g;
        sc[n][e] = (i >= j && i < Q && j < Q)
                       ? sc[n][e] * __expf(sCs[min(i, Q - 1)] - cs_j)
                       : 0.f;
      }

    // dx_j += bf16(S^T o L^T) . dy_i: the score fragments of queries
    // 16 kk .. 16 kk + 15 are the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
          pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int pp = 0; pp < NP / 2; ++pp) {
        uint32_t yf[4];
        ldmatrix_x4_trans(yf, cDy + (kk * 16 + ldm_row(lane, true)) * LDX +
                                  pp * 16 + ldm_col(lane, true));
        mma_bf16(dx[2 * pp], pa, yf[0], yf[1]);
        mma_bf16(dx[2 * pp + 1], pa, yf[2], yf[3]);
      }
    }

    // dP^T = x_j . dy_i^T
    float dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, sX + (lr - g + ldm_row(lane, true)) * LDX + kk * 16 +
                          ldm_col(lane, true));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, cDy + (np * 16 + ldm_row(lane, false)) * LDX +
                             kk * 16 + ldm_col(lane, false));
        mma_bf16(dp[2 * np], af, bfr[0], bfr[1]);
        mma_bf16(dp[2 * np + 1], af, bfr[2], bfr[3]);
      }
    }

    // M^T = (S^T o L^T) o dP^T in f32: its sums over i (this lane's rows)
    // and over j (each warp's 16 rows, then the 4 warps in order)
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float m0 = sc[n][0] * dp[n][0], m1 = sc[n][1] * dp[n][1];
      const float m2 = sc[n][2] * dp[n][2], m3 = sc[n][3] * dp[n][3];
      r0 += m0 + m1;
      r1 += m2 + m3;
      const float c0 = column_sum(m0 + m2), c1 = column_sum(m1 + m3);
      if (g == 0)
        *reinterpret_cast<float2*>(sPart + warp * 64 + n * 8 + 2 * t) =
            make_float2(c0, c1);
    }
    msum0 += r0;
    msum1 += r1;
    __syncthreads();
    if (threadIdx.x < 64) {
      const int i = it * 64 + threadIdx.x;
      const float v = sPart[threadIdx.x] + sPart[64 + threadIdx.x] +
                      sPart[128 + threadIdx.x] + sPart[192 + threadIdx.x];
      if (k == 0)
        sOwn[threadIdx.x] = v;
      else if (i < Q)
        rowpart[(chunk_id * ntiles + jt) * Q + i] = v;
    }
    __syncthreads();  // this stage is refilled two tiles on; sPart reused
  }

  // the key tile's own rows: the diagonal pair's sum over j, then the
  // rows' own terms
  const float m0 = quad_sum(msum0), m1 = quad_sum(msum1);
  if (t == 0) {
    sOwn[lr] += own0 - m0;
    sOwn[lr + 8] += own1 - m1;
  }
  __syncthreads();
  if (threadIdx.x < 64 && j0 + int(threadIdx.x) < Q)
    rowpart[(chunk_id * ntiles + jt) * Q + j0 + threadIdx.x] =
        sOwn[threadIdx.x];

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = row_g + 8 * r;
    if (j >= Q) continue;
    bf16* xr = dX + ((int64_t(b) * S + s0 + j) * H + h) * P + 2 * t;
#pragma unroll
    for (int n = 0; n < NP; ++n)
      *reinterpret_cast<uint32_t*>(xr + n * 8) =
          pack_bf16(dx[n][2 * r], dx[n][2 * r + 1]);
  }
}

// Pass (6): dC (role 0) or dB (role 1) for 64 rows of one tile of one
// (b, chunk), the heads looped inside in order. Role 0, rows i ("own" dy,
// "other" x, the other tile's B):
//   dC_i = sum_{jt <= it} bf16(sum_h (dy_i . x_j) L_ij) B_j
//          + sum_h bf16(e_i dy_i) bf16(S_in);
// role 1, rows j ("own" x, "other" dy, the other tile's C):
//   dB_j = sum_{it >= jt} bf16(sum_h (x_j . dy_i) L_ij) C_i
//          + sum_h bf16(w_j x_j) bf16(G).
template <int P>
__global__ void __launch_bounds__(kThreadsB) ssd_bwd_dbc_kernel(
    const bf16* __restrict__ X, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const bf16* __restrict__ dY,
    const float* __restrict__ cs, const float* __restrict__ states,
    const float* __restrict__ grads, bf16* __restrict__ dB,
    bf16* __restrict__ dC, int B, int S, int H, int N, int Q, int64_t xsb,
    int64_t xss, int64_t xsh, int64_t bsb, int64_t bss, int64_t csb,
    int64_t css) {
  using namespace tile_mma;
  constexpr int LDX = P + kPad;
  constexpr int KP = P / 16;
  constexpr int KN = kMaxN / 16;
  const int LDB = N + kPad, KS = N / 16;
  const int nc = S / Q, ntiles = (Q + 63) / 64;
  extern __shared__ uint4 smem_u4[];
  bf16* sT = reinterpret_cast<bf16*>(smem_u4);  // [2][own, other][64][LDX]
  float* sCr = reinterpret_cast<float*>(sT + 4 * 64 * LDX);  // [2][128]
  bf16* sN = reinterpret_cast<bf16*>(sCr + 256);  // [2][64][LDB]

  // the blocks with the most tile pairs first: v pairs, role, (c, b)
  const int per = 2 * B * nc;
  const int v = ntiles - int(blockIdx.x) / per;
  const int rem = int(blockIdx.x) % per;
  const int role = rem & 1;
  const int c = (rem >> 1) % nc, b = (rem >> 1) / nc;
  const int tl = role ? ntiles - v : v - 1;  // the block's own tile
  const int s0 = c * Q, r0 = tl * 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int lr = warp * 16 + g;
  const int64_t dss = int64_t(H) * P, dsb = int64_t(S) * dss;
  const bf16* xc = X + b * xsb + int64_t(s0) * xss;
  const bf16* dyc = dY + b * dsb + int64_t(s0) * dss;
  const bf16* own = role ? xc : dyc;
  const bf16* oth = role ? dyc : xc;
  const int64_t own_ss = role ? xss : dss, own_sh = role ? xsh : P;
  const int64_t oth_ss = role ? dss : xss, oth_sh = role ? P : xsh;
  const bf16* nt = role ? Cm + b * csb + int64_t(s0) * css
                        : Bm + b * bsb + int64_t(s0) * bss;
  const int64_t nt_ss = role ? css : bss;
  const float* cs_b = cs + int64_t(b) * H * nc * Q + int64_t(c) * Q;

  // step k: tile pair k / H (its other tile o), head k % H
  auto other_tile = [&](int kp) { return role ? tl + kp : kp; };
  auto prefetch = [&](int k, int st) {
    const int kp = k / H, hh = k - kp * H;
    bf16* so = sT + st * 2 * 64 * LDX;
    load_tile64<kThreadsB>(so, LDX, own + hh * own_sh, own_ss, r0, Q, P);
    load_tile64<kThreadsB>(so + 64 * LDX, LDX, oth + hh * oth_sh, oth_ss,
                           other_tile(kp) * 64, Q, P);
    if (hh == 0)
      load_tile64<kThreadsB>(sN + (kp & 1) * 64 * LDB, LDB, nt, nt_ss,
                             other_tile(kp) * 64, Q, N);
  };
  // threads 0-63 the own rows' cumsum, 64-127 the other tile's
  auto cs_load = [&](int k) {
    const int kp = k / H, hh = k - kp * H;
    const int r = (threadIdx.x < 64 ? tl : other_tile(kp)) * 64 +
                  (threadIdx.x & 63);
    return r < Q ? cs_b[int64_t(hh) * nc * Q + r] : 0.f;
  };

  float acc[KN * 2][4];  // the warp's 16 rows x N
#pragma unroll
  for (int n = 0; n < KN * 2; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float W[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) W[n][0] = W[n][1] = W[n][2] = W[n][3] = 0.f;

  const int K = v * H;
  prefetch(0, 0);
  cp_async_commit();
  float csv = cs_load(0);
  for (int k = 0; k < K; ++k) {
    const int st = k & 1, kp = k / H, hh = k - kp * H;
    sCr[st * 128 + threadIdx.x] = csv;
    if (k + 1 < K) {
      prefetch(k + 1, st ^ 1);
      csv = cs_load(k + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cO = sT + st * 2 * 64 * LDX;
    const bf16* cT = cO + 64 * LDX;
    const float* csO = sCr + st * 128;
    const float* csT = csO + 64;

    // own_r . other_o^T over P, for the warp's 16 rows and 64 columns
    float dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, cO + (lr - g + ldm_row(lane, true)) * LDX + kk * 16 +
                          ldm_col(lane, true));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, cT + (np * 16 + ldm_row(lane, false)) * LDX +
                             kk * 16 + ldm_col(lane, false));
        mma_bf16(dp[2 * np], af, bfr[0], bfr[1]);
        mma_bf16(dp[2 * np + 1], af, bfr[2], bfr[3]);
      }
    }
    // W += dp o L, causal: the query position at or after the key's
    const int o0 = other_tile(kp) * 64;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = lr + (e >= 2 ? 8 : 0), ol = n * 8 + 2 * t + (e & 1);
        const int ri = r0 + rl, oi = o0 + ol;
        const bool ok = ri < Q && oi < Q && (role ? oi >= ri : oi <= ri);
        const float x = role ? csT[ol] - csO[rl] : csO[rl] - csT[ol];
        if (ok) W[n][e] += dp[n][e] * __expf(x);
      }

    if (hh == H - 1) {
      // acc += bf16(W) . (B or C of the other tile): W's fragments over
      // the other tile's positions 16 kk .. 16 kk + 15 are the A fragment
      // of k-step kk
      const bf16* cN = sN + (kp & 1) * 64 * LDB;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(W[2 * kk][0], W[2 * kk][1]),
            pack_bf16(W[2 * kk][2], W[2 * kk][3]),
            pack_bf16(W[2 * kk + 1][0], W[2 * kk + 1][1]),
            pack_bf16(W[2 * kk + 1][2], W[2 * kk + 1][3])};
#pragma unroll
        for (int nn = 0; nn < KN; ++nn) {
          if (nn >= KS) continue;
          uint32_t nf[4];
          ldmatrix_x4_trans(nf, cN + (kk * 16 + ldm_row(lane, true)) * LDB +
                                    nn * 16 + ldm_col(lane, true));
          mma_bf16(acc[2 * nn], pa, nf[0], nf[1]);
          mma_bf16(acc[2 * nn + 1], pa, nf[2], nf[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) W[n][0] = W[n][1] = W[n][2] = W[n][3] = 0.f;
    }
    __syncthreads();  // this stage is refilled two steps on
  }

  // the inter-chunk terms, head by head: bf16(scale o own) . bf16(state),
  // the state (P, N) over both (64, N) tiles
  const float* state = role ? grads : states;
  if (role ? c + 1 < nc : c > 0) {
    for (int hh = 0; hh < H; ++hh) {
      load_tile64<kThreadsB>(sT, LDX, own + hh * own_sh, own_ss, r0, Q, P);
      cp_async_commit();
      const int64_t chunk_id = (int64_t(b) * H + hh) * nc + c;
      stage_state_bf16(sN, LDB, state + chunk_id * P * N, P, N);
      const float* csh = cs + chunk_id * Q;
      const int ri = r0 + lr;
      const float last = csh[Q - 1];
      const float x0 = ri < Q ? csh[ri] : 0.f;
      const float x1 = ri + 8 < Q ? csh[ri + 8] : 0.f;
      const float sc0 = ri < Q ? expf(role ? last - x0 : x0) : 0.f;
      const float sc1 = ri + 8 < Q ? expf(role ? last - x1 : x1) : 0.f;
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) {
        uint32_t af[4];
        ldmatrix_x4(af, sT + (lr - g + ldm_row(lane, true)) * LDX + kk * 16 +
                            ldm_col(lane, true));
        // rows g (registers 0, 2) and g + 8 (1, 3) scaled, rounded to bf16
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float s = (u & 1) ? sc1 : sc0;
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&af[u]));
          af[u] = pack_bf16(f.x * s, f.y * s);
        }
#pragma unroll
        for (int nn = 0; nn < KN; ++nn) {
          if (nn >= KS) continue;
          uint32_t nf[4];
          ldmatrix_x4_trans(nf, sN + (kk * 16 + ldm_row(lane, true)) * LDB +
                                    nn * 16 + ldm_col(lane, true));
          mma_bf16(acc[2 * nn], af, nf[0], nf[1]);
          mma_bf16(acc[2 * nn + 1], af, nf[2], nf[3]);
        }
      }
      __syncthreads();  // sT and sN are refilled for the next head
    }
  }

  bf16* out = role ? dB : dC;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + lr + 8 * r;
    if (i >= Q) continue;
    bf16* orow = out + (int64_t(b) * S + s0 + i) * N + 2 * t;
#pragma unroll
    for (int n = 0; n < KN * 2; ++n)
      if (n < 2 * KS)
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// Pass (7): dAdt of one (b, h, chunk): d(cs)_i the sum of its parts over
// the key tiles at or before i's, in order, then summed from the chunk's
// end, plus <G, S_out> (S_out the state entering the next chunk; zero for
// the last chunk, whose G is zero).
__global__ void __launch_bounds__(kThreadsB) ssd_bwd_dadt_kernel(
    const float* __restrict__ states, const float* __restrict__ grads,
    const float* __restrict__ rowpart, float* __restrict__ dA, int S, int H,
    int PN, int Q) {
  extern __shared__ float smem_f[];
  float* v = smem_f;     // [Q], reversed
  float* tot = v + Q;    // [kWarpsB]
  const int nc = S / Q, ntiles = (Q + 63) / 64;
  int idx = blockIdx.x;
  const int c = idx % nc;
  idx /= nc;
  const int h = idx % H, b = idx / H;
  const int64_t chunk_id = (int64_t(b) * H + h) * nc + c;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float dot = 0.f;
  if (c + 1 < nc) {
    const float4* g4 = reinterpret_cast<const float4*>(grads + chunk_id * PN);
    const float4* s4 =
        reinterpret_cast<const float4*>(states + (chunk_id + 1) * PN);
    for (int i = threadIdx.x; i < PN / 4; i += kThreadsB) {
      const float4 a = g4[i], s = s4[i];
      dot += a.x * s.x + a.y * s.y + a.z * s.z + a.w * s.w;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
  if (lane == 0) tot[warp] = dot;
  const float* rp = rowpart + chunk_id * ntiles * Q;
  for (int i = threadIdx.x; i < Q; i += kThreadsB) {
    float d = 0.f;
    for (int jt = 0; jt <= i / 64; ++jt) d += rp[int64_t(jt) * Q + i];
    v[Q - 1 - i] = d;
  }
  __syncthreads();
  float corr = 0.f;
  for (int w = 0; w < kWarpsB; ++w) corr += tot[w];
  __syncthreads();  // tot is the scan's next
  block_cumsum(v, Q, tot);
  for (int i = threadIdx.x; i < Q; i += kThreadsB)
    dA[(int64_t(b) * S + int64_t(c) * Q + i) * H + h] = v[Q - 1 - i] + corr;
}

template <int P>
cudaError_t launch_bwd(const void* X, const float* A, const void* Bm,
                       const void* Cm, const void* dY, void* dX, float* dA,
                       void* dB, void* dC, float* states, float* decay,
                       float* dstates, float* cs, float* rowpart, int B,
                       int S, int H, int N, int Q, const int64_t* st,
                       cudaStream_t s) {
  const int nc = S / Q, ntiles = (Q + 63) / 64;
  const long long BH = (long long)B * H;
  if (BH * nc * ntiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  // (1, 2) the state entering each chunk, as the forward has it
  cudaError_t err = launch_states<P>(X, A, Bm, states, decay, B, S, H, N, Q,
                                     st, s);
  if (err != cudaSuccess) return err;
  err = launch_state_pass<false>(states, decay, BH, nc, (long long)P * N, s);
  if (err != cudaSuccess) return err;
  // (3, 4) the gradient of the state leaving each chunk; dY contiguous
  const int64_t dst[8] = {int64_t(S) * H * P, int64_t(H) * P, P, st[3],
                          st[4], st[5], st[8], st[9]};
  err = launch_states<P, true>(dY, A, Cm, dstates, cs, B, S, H, N, Q, dst,
                               s);
  if (err != cudaSuccess) return err;
  err = launch_state_pass<true>(dstates, decay, BH, nc, (long long)P * N, s);
  if (err != cudaSuccess) return err;
  // (5) dX and the parts of d(cs)
  {
    static int opted[64] = {};
    const int smem = dx_smem_bytes(P, N, Q);
    auto kern = ssd_bwd_dx_kernel<P>;
    err = tile_mma::opt_in_smem(kern, smem, opted);
    if (err != cudaSuccess) return err;
    kern<<<unsigned(BH * nc * ntiles), kThreadsB, smem, s>>>(
        static_cast<const bf16*>(X), static_cast<const bf16*>(Bm),
        static_cast<const bf16*>(Cm), static_cast<const bf16*>(dY), cs,
        states, dstates, static_cast<bf16*>(dX), rowpart, B, S, H, N, Q,
        st[0], st[1], st[2], st[6], st[7], st[8], st[9]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // (6) dC and dB
  {
    static int opted[64] = {};
    const int smem = dbc_smem_bytes(P, N);
    auto kern = ssd_bwd_dbc_kernel<P>;
    err = tile_mma::opt_in_smem(kern, smem, opted);
    if (err != cudaSuccess) return err;
    kern<<<unsigned(2LL * B * nc * ntiles), kThreadsB, smem, s>>>(
        static_cast<const bf16*>(X), static_cast<const bf16*>(Bm),
        static_cast<const bf16*>(Cm), static_cast<const bf16*>(dY), cs,
        states, dstates, static_cast<bf16*>(dB), static_cast<bf16*>(dC), B,
        S, H, N, Q, st[0], st[1], st[2], st[6], st[7], st[8], st[9]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // (7) dAdt
  ssd_bwd_dadt_kernel<<<unsigned(BH * nc), kThreadsB,
                        4 * (Q + kWarpsB), s>>>(states, dstates, rowpart, dA,
                                                S, H, P * N, Q);
  return cudaGetLastError();
}

}  // namespace

// bf16 pass (a). X (B, S, H, P), Adt (B, S, H) f32 and Bc (B, S, N) as
// ssd_scan_fwd takes them (strides[10] likewise; Cc's are not read);
// states (B, H, S / Q, P, N) and decay (B, H, S / Q) f32 contiguous, written.
// The caller checks P, that X and Bc start on 16 bytes and that their
// strides are multiples of 8 elements (the cp.async copies are 16 bytes).
extern "C" int ssd_chunk_states_fwd(const void* X, const void* Adt,
                                    const void* Bc, void* states,
                                    void* decay, long long B, long long S,
                                    long long H, long long P, long long N,
                                    long long Q, const long long* strides,
                                    void* stream) {
  if (bad_shape(S, N, Q)) return cudaErrorInvalidValue;
  int64_t st[10];
  for (int i = 0; i < 10; ++i) st[i] = strides[i];
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const float*>(Adt);
  auto* sp = static_cast<float*>(states);
  auto* dp = static_cast<float*>(decay);
  const int b = int(B), l = int(S), h = int(H), n = int(N), q = int(Q);
  switch (P) {
    case 16: return launch_states<16>(X, A, Bc, sp, dp, b, l, h, n, q, st, s);
    case 32: return launch_states<32>(X, A, Bc, sp, dp, b, l, h, n, q, st, s);
    case 64: return launch_states<64>(X, A, Bc, sp, dp, b, l, h, n, q, st, s);
    case 128:
      return launch_states<128>(X, A, Bc, sp, dp, b, l, h, n, q, st, s);
    default: return cudaErrorInvalidValue;
  }
}

// bf16 pass (b), in place on pass (a)'s states and decay: BH = B * H, nc =
// S / Q chunks, PN = P * N state elements (a multiple of 4).
extern "C" int ssd_state_pass_fwd(void* states, const void* decay,
                                  long long BH, long long nc, long long PN,
                                  void* stream) {
  return launch_state_pass<false>(static_cast<float*>(states),
                                  static_cast<const float*>(decay), BH, nc,
                                  PN, static_cast<cudaStream_t>(stream));
}

// bf16 pass (c): X, Adt, Bc, Cc and strides[10] as ssd_scan_fwd takes them;
// states the output of pass (b); Y (B, S, H, P) bf16 contiguous. The caller
// checks P and the 16-byte alignment of X, Bc and Cc as for pass (a).
extern "C" int ssd_chunk_scan_fwd(const void* X, const void* Adt,
                                  const void* Bc, const void* Cc,
                                  const void* states, void* Y, long long B,
                                  long long S, long long H, long long P,
                                  long long N, long long Q,
                                  const long long* strides, void* stream) {
  if (bad_shape(S, N, Q)) return cudaErrorInvalidValue;
  int64_t st[10];
  for (int i = 0; i < 10; ++i) st[i] = strides[i];
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const float*>(Adt);
  const auto* sp = static_cast<const float*>(states);
  const int b = int(B), l = int(S), h = int(H), n = int(N), q = int(Q);
  switch (P) {
    case 16:
      return launch_scan<16>(X, A, Bc, Cc, sp, Y, b, l, h, n, q, st, s);
    case 32:
      return launch_scan<32>(X, A, Bc, Cc, sp, Y, b, l, h, n, q, st, s);
    case 64:
      return launch_scan<64>(X, A, Bc, Cc, sp, Y, b, l, h, n, q, st, s);
    case 128:
      return launch_scan<128>(X, A, Bc, Cc, sp, Y, b, l, h, n, q, st, s);
    default: return cudaErrorInvalidValue;
  }
}

// X (B, S, H, P), Adt (B, S, H) f32, Bc and Cc (B, S, N), Y (B, S, H, P)
// contiguous; strides[10] = X's (b, s, h), Adt's (b, s, h), Bc's (b, s),
// Cc's (b, s) strides in elements (each last dimension contiguous); dtype
// (of X, Bc, Cc and Y) 0 = float32 (ssd_scan_kernel); bfloat16 goes
// through the three passes above. P in {16, 32, 64, 128}, N % 16 == 0 with
// N <= 128, S % Q == 0 and the shared-memory budget are checked by the
// caller.
extern "C" int ssd_scan_fwd(const void* X, const void* Adt, const void* Bc,
                            const void* Cc, void* Y, long long B, long long S,
                            long long H, long long P, long long N,
                            long long Q, const long long* strides, int dtype,
                            void* stream) {
  if (N % 16 != 0 || N > kMaxN || Q <= 0 || S % Q != 0)
    return cudaErrorInvalidValue;
  int64_t st[10];
  for (int i = 0; i < 10; ++i) st[i] = strides[i];
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const float*>(Adt);
  if (dtype == 0)
    return dispatch_p<float>(X, A, Bc, Cc, Y, int(B), int(S), int(H), int(P),
                             int(N), int(Q), st, s);
  return cudaErrorInvalidValue;
}

// The bf16 backward: X, Adt, Bc, Cc and strides[10] as ssd_scan_fwd takes
// them, dY (B, S, H, P) bf16 contiguous; written: dX (B, S, H, P) and dBc,
// dCc (B, S, N) bf16, dAdt (B, S, H) f32, all contiguous. Scratch, f32
// contiguous: states and dstates (B, H, S / Q, P, N), decay (B, H, S / Q),
// cs (B, H, S / Q, Q), rowpart (B, H, S / Q, ceil(Q / 64), Q). The caller
// checks P, the 16-byte rows of X, Bc, Cc and the shared-memory budget.
extern "C" int ssd_scan_bwd(const void* X, const void* Adt, const void* Bc,
                            const void* Cc, const void* dY, void* dX,
                            void* dAdt, void* dBc, void* dCc, void* states,
                            void* decay, void* dstates, void* cs,
                            void* rowpart, long long B, long long S,
                            long long H, long long P, long long N,
                            long long Q, const long long* strides,
                            void* stream) {
  if (bad_shape(S, N, Q)) return cudaErrorInvalidValue;
  int64_t st[10];
  for (int i = 0; i < 10; ++i) st[i] = strides[i];
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const float*>(Adt);
  auto* dA = static_cast<float*>(dAdt);
  auto* sp = static_cast<float*>(states);
  auto* dp = static_cast<float*>(decay);
  auto* gp = static_cast<float*>(dstates);
  auto* cp = static_cast<float*>(cs);
  auto* rp = static_cast<float*>(rowpart);
  const int b = int(B), l = int(S), h = int(H), n = int(N), q = int(Q);
  switch (P) {
    case 16:
      return launch_bwd<16>(X, A, Bc, Cc, dY, dX, dA, dBc, dCc, sp, dp, gp,
                            cp, rp, b, l, h, n, q, st, s);
    case 32:
      return launch_bwd<32>(X, A, Bc, Cc, dY, dX, dA, dBc, dCc, sp, dp, gp,
                            cp, rp, b, l, h, n, q, st, s);
    case 64:
      return launch_bwd<64>(X, A, Bc, Cc, dY, dX, dA, dBc, dCc, sp, dp, gp,
                            cp, rp, b, l, h, n, q, st, s);
    case 128:
      return launch_bwd<128>(X, A, Bc, Cc, dY, dX, dA, dBc, dCc, sp, dp, gp,
                             cp, rp, b, l, h, n, q, st, s);
    default: return cudaErrorInvalidValue;
  }
}
