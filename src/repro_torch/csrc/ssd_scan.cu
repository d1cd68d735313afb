// Mamba-2 chunked SSD scan (forward) for Hopper (sm_90a), with a plain C
// interface loaded through ctypes by repro_torch/kernels/ssd_scan.py.
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
// (4, 2048, 24, 64, 128) with Q = 256, the work the Pallas kernel does per
// (b, h, chunk) is 25.8 GFLOP against 55 MB of inputs and output: the
// tensor cores would bound it at about 26 us. This first kernel multiplies
// in f32 on the CUDA cores and runs only B x H = 96 blocks (one per (b, h),
// fewer than the 132 SMs), each walking its chunks in order, so it is bound
// by one SM's f32 FMA rate and shared-memory loads, far above that bound.
// Splitting the chunks across blocks (intra-chunk work in parallel, a short
// state pass after) and wgmma are later work.
//
// What the simple design does. One block of 256 threads (16 x 16) per
// (b, h). The state stays in shared memory for the whole sequence (P x N
// f32: 32 KB at P = 64, N = 128). A chunk of Q = 256 would make the (Q, Q)
// f32 decay and score matrices 256 KB, over the 227 KB a block may have, so
// they are never formed whole: the chunk is cut into 64-row tiles, and for
// each query tile i and key tile j <= i the 64 x 64 scores (C_i . B_j)
// exp(cs_i - cs_j) are built from the staged tiles and the chunk's cumsum
// in shared memory, then multiplied into the query tile's Y, which each
// thread keeps in registers (4 rows x P / 16 columns). Each product gives a
// thread a 4 x 4 (or 4 x P/16) register tile, so it loads 8 values per 16
// multiply-adds. Tile rows are padded to N + 1 floats so a warp's loads hit
// distinct banks.
//
// Numbers. Everything is f32 whatever the input dtype (f32 or bf16); the
// cumsum runs in order, one thread, like jnp.cumsum; exp is the accurate
// expf. Y is rounded once to X's dtype. Only the order of the f32 sums
// differs from the plain version (ssd_chunked).
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the cudaError_t of its launch.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
  // above 48 KB only after opting in; the size varies with N and Q, so
  // raise the device's opt-in when a launch needs more than the last one
  // (not on every launch: a launch may be captured in a CUDA graph)
  static int opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (smem > opted_in[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in[dev] = smem;
  }
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

}  // namespace

// X (B, S, H, P), Adt (B, S, H) f32, Bc and Cc (B, S, N), Y (B, S, H, P)
// contiguous; strides[10] = X's (b, s, h), Adt's (b, s, h), Bc's (b, s),
// Cc's (b, s) strides in elements (each last dimension contiguous); dtype
// (of X, Bc, Cc and Y) 0 = float32, 1 = bfloat16. P in {16, 32, 64, 128},
// N % 16 == 0 with N <= 128, S % Q == 0 and the shared-memory budget are
// checked by the caller.
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
  if (dtype == 1)
    return dispatch_p<__nv_bfloat16>(X, A, Bc, Cc, Y, int(B), int(S), int(H),
                                     int(P), int(N), int(Q), st, s);
  return cudaErrorInvalidValue;
}
