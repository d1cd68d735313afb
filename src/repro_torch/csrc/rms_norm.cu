// RMS norm of bfloat16 rows, plain or with a SiLU gate, forward and
// backward, for Hopper (sm_90a), with a plain C interface loaded through
// ctypes by repro_torch/kernels/rms_norm.py.
//
// Replaces no Pallas kernel: the reference's norm (src/repro/models/
// layers.py, rms_norm) is jnp code that XLA fuses into one loop over each
// row. Run eagerly, the same arithmetic on a bf16 row is a chain of launches
// (the float32 copy, the square, the mean, rsqrt, two broadcast products,
// the cast back: 8 forward and 17 backward; the Mamba mixer's gated norm
// rms_norm(y * silu(z)) 10 and 20), each reading and writing float32
// temporaries of the row's size; this kernel pair is the fusion XLA does,
// written by hand.
//
// What bounds it on the card: bytes. With U the bytes of one bf16 tensor of
// the rows, the forward reads x (and z) and writes the output, 2 U (3 U
// gated), plus one float32 rstd a row; the backward reads dout, x (and z)
// and writes dx (and dz), 3 U (5 U gated). At mamba2-130m's train step the
// gated norm's 32,768 rows of 1,536 are U = 100.7 MB: 302 and 503 MB, 90
// and 150 us at 3.35 TB/s. There are no products to put on tensor cores.
// The design:
//
// - A row is taken by a group of G threads (one warp up to a width of
//   1,024, then 64, 128 and 256 threads up to 2,048, 4,096 and 8,192), in
//   blocks of 256 threads holding 256 / G rows. Each thread holds V <= 4
//   vectors of 8 bf16 (16-byte loads and stores, neighbouring threads on
//   neighbouring vectors, every load of a row started before any is used) in
//   registers from the load to the store, so each row is read from device
//   memory once and written once.
// - The row's float32 sums go through warp shuffles (xor butterflies, which
//   leave every lane the same bits) and, for a group of several warps, one
//   step through shared memory that every thread reads in the same order:
//   the same inputs give the same bits.
// - The forward computes the plain version's own roundings, in its order:
//   s = bf16(z / (1 + exp(-z))) and g = bf16(x * s) with a gate (else
//   g = x), ms = sum(g * g) * (1 / D) in float32, rstd = rsqrt(ms + eps),
//   out = bf16((g * rstd) * w) with w the float32 parameter. Only the order
//   of the row's sum differs from the eager chain's. rstd is kept, one
//   float32 a row, for the backward.
// - The backward, one pass over each row: from dout, x (and z), w and rstd
//   it recomputes g and gh = g * rstd, forms a = dout * w and the row's
//   c = mean(a * gh), and writes dx = bf16(dg) with
//   dg = rstd * (a - gh * c), or gated dx = bf16(dg * s) and
//   dz = bf16(dg * x * s'(z)), s' the SiLU's derivative
//   sigma * (1 + z * (1 - sigma)). dg stays float32 (the eager chain rounds
//   it to bf16 first). Its SiLU takes the fast exponential and division
//   (silu_fast): with three exponentials and divisions an element, the
//   exact ones made the gated backward instruction-bound (50% of its byte
//   bound against 80%). The gradient of w, the sum over rows of dout * gh, is
//   summed on a persistent grid (as many blocks as fit on the card at
//   once, each walking rows grid-stride): each row group adds its rows'
//   terms into its own float32 row of shared memory (in registers they
//   cost a third of the card's blocks), the block adds its groups' rows in
//   order into one partial row, and rms_dw_kernel adds the partials in a
//   fixed order. No float atomics: the same inputs give the same bits on
//   every call.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the cudaError_t of its launch.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWidth = 8192;

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 p = __bfloat1622float2(h[j]);
    f[2 * j] = p.x;
    f[2 * j + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = __float2bfloat16_rn(f[j]);
  return u;
}

__device__ __forceinline__ void load_w(const float4* w, int v,
                                       float (&f)[8]) {
  const float4 lo = __ldg(w + 2 * v), hi = __ldg(w + 2 * v + 1);
  f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
  f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
}

// SiLU rounded to bf16 as F.silu rounds it on the card: x / (1 + exp(-x))
// in float32, rounded once.
__device__ __forceinline__ float silu_bf16(float z) {
  return bf16r(__fdiv_rn(z, __fadd_rn(1.f, expf(-z))));
}

// The normed value g of one element: x, or bf16(x * bf16(silu(z))).
template <bool kGate>
__device__ __forceinline__ float gated(float x, float z) {
  if constexpr (kGate) return bf16r(__fmul_rn(x, silu_bf16(z)));
  return x;
}

// The sum of v over the G threads of this thread's row group, the same bits
// in every thread of the group. Every thread of the block calls it.
template <int G>
__device__ __forceinline__ float group_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if constexpr (G == 32) {
    return v;
  } else {
    constexpr int W = G / 32;
    const int warp = threadIdx.x >> 5;
    __syncthreads();  // every thread has read the last call's sums
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    const int first = warp - warp % W;
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) t += red[first + i];
    return t;
  }
}

// Forward: one row group of G threads per row, V vectors of 8 a thread.
template <int G, int V, bool kGate>
__global__ void __launch_bounds__(kThreads)
    rms_fwd_kernel(const uint4* __restrict__ x, const uint4* __restrict__ z,
                   const float4* __restrict__ w, uint4* __restrict__ out,
                   float* __restrict__ rstd, long long rows, int nvec,
                   float inv_d, float eps) {
  constexpr int R = kThreads / G;
  __shared__ float red[kWarps];
  const int lane = threadIdx.x % G;
  const long long row = static_cast<long long>(blockIdx.x) * R
                        + threadIdx.x / G;
  const bool live = row < rows;
  const long long base = row * nvec;
  uint4 xv[V], zv[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {  // every load in flight before any use
    const int v = lane + k * G;
    if (!live || v >= nvec) continue;
    xv[k] = __ldcs(x + base + v);
    if constexpr (kGate) zv[k] = __ldcs(z + base + v);
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int v = lane + k * G;
    if (!live || v >= nvec) continue;
    float xf[8], zf[8], g[8];
    unpack(xv[k], xf);
    if constexpr (kGate) unpack(zv[k], zf);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      g[j] = gated<kGate>(xf[j], kGate ? zf[j] : 0.f);
      ss = __fadd_rn(ss, __fmul_rn(g[j], g[j]));
    }
    xv[k] = pack(g);  // exact: g is a bf16 value
  }
  ss = group_sum<G>(ss, red);
  if (!live) return;
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_d), eps));
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int v = lane + k * G;
    if (v >= nvec) continue;
    float g[8], wf[8], o[8];
    unpack(xv[k], g);
    load_w(w, v, wf);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = __fmul_rn(__fmul_rn(g[j], r), wf[j]);
    __stcs(out + base + v, pack(o));
  }
  if (lane == 0) rstd[row] = r;
}

// The backward's SiLU of z and the logistic sigma(z), by the fast exponential
// and division: its g may differ from the forward's in the last bf16 place
// in a rare element, which moves no gradient beyond float32 rounding.
__device__ __forceinline__ void silu_fast(float z, float& s, float& sig) {
  sig = __fdividef(1.f, 1.f + __expf(-z));
  s = bf16r(z * sig);
}

// Backward: a persistent grid; each block walks row blocks grid-stride, its
// row groups adding dw's terms into their own float32 row of shared memory,
// and writes one partial row of D, the groups' rows added in order, to
// partials[blockIdx.x].
template <int G, int V, bool kGate>
__global__ void __launch_bounds__(kThreads)
    rms_bwd_kernel(const uint4* __restrict__ dout,
                   const uint4* __restrict__ x, const uint4* __restrict__ z,
                   const float4* __restrict__ w,
                   const float* __restrict__ rstd, uint4* __restrict__ dx,
                   uint4* __restrict__ dz, float* __restrict__ partials,
                   long long rows, int nvec, float inv_d) {
  constexpr int R = kThreads / G;
  constexpr int W = G * V * 8;  // widest row of this plan
  __shared__ float red[kWarps];
  __shared__ __align__(16) float acc_s[R][W];
  const int lane = threadIdx.x % G, group = threadIdx.x / G;
  float4* acc = reinterpret_cast<float4*>(acc_s[group]);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int v = lane + k * G;
    acc[2 * v] = acc[2 * v + 1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (long long rb = blockIdx.x; rb * R < rows; rb += gridDim.x) {
    const long long row = rb * R + group;
    const bool live = row < rows;
    const long long base = row * nvec;
    const float r = live ? rstd[row] : 0.f;
    uint4 dv[V], xv[V], zv[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {  // every load in flight before any use
      const int v = lane + k * G;
      if (!live || v >= nvec) continue;
      dv[k] = __ldcs(dout + base + v);
      xv[k] = __ldcs(x + base + v);
      if constexpr (kGate) zv[k] = __ldcs(z + base + v);
    }
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int v = lane + k * G;
      if (!live || v >= nvec) continue;
      float df[8], xf[8], zf[8], wf[8], t[8];
      unpack(dv[k], df);
      unpack(xv[k], xf);
      if constexpr (kGate) unpack(zv[k], zf);
      load_w(w, v, wf);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float g = xf[j];
        if constexpr (kGate) {
          float s, sig;
          silu_fast(zf[j], s, sig);
          g = bf16r(xf[j] * s);
        }
        const float gh = g * r;
        dot = fmaf(df[j] * wf[j], gh, dot);
        t[j] = df[j] * gh;
      }
      float4 a0 = acc[2 * v], a1 = acc[2 * v + 1];
      a0.x += t[0]; a0.y += t[1]; a0.z += t[2]; a0.w += t[3];
      a1.x += t[4]; a1.y += t[5]; a1.z += t[6]; a1.w += t[7];
      acc[2 * v] = a0;
      acc[2 * v + 1] = a1;
    }
    const float c = group_sum<G>(dot, red) * inv_d;
    if (!live) continue;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int v = lane + k * G;
      if (v >= nvec) continue;
      float df[8], xf[8], zf[8], wf[8], o[8], oz[8];
      unpack(dv[k], df);
      unpack(xv[k], xf);
      if constexpr (kGate) unpack(zv[k], zf);
      load_w(w, v, wf);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float s = 0.f, sig = 0.f, g = xf[j];
        if constexpr (kGate) {
          silu_fast(zf[j], s, sig);
          g = bf16r(xf[j] * s);
        }
        const float dg = r * (df[j] * wf[j] - g * r * c);
        if constexpr (kGate) {
          o[j] = dg * s;
          oz[j] = dg * xf[j] * (sig * (1.f + zf[j] * (1.f - sig)));
        } else {
          o[j] = dg;
        }
      }
      __stcs(dx + base + v, pack(o));
      if constexpr (kGate) __stcs(dz + base + v, pack(oz));
    }
  }

  // dw: this block's row groups' rows added in order, one partial row
  __syncthreads();
  const int D = nvec * 8;
  float* part = partials + static_cast<long long>(blockIdx.x) * D;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    float t = acc_s[0][i];
#pragma unroll
    for (int q = 1; q < R; ++q) t += acc_s[q][i];
    part[i] = t;
  }
}

// dw[col] = the sum of partials[b][col] over b in a fixed order: 32 columns
// a block, 8 threads a column each adding every 8th partial, then the 8 in
// order.
__global__ void __launch_bounds__(kThreads)
    rms_dw_kernel(const float* __restrict__ partials, float* __restrict__ dw,
                  int nparts, int D) {
  __shared__ float s[kWarps][33];
  const int col = blockIdx.x * 32 + (threadIdx.x & 31);
  const int warp = threadIdx.x >> 5;
  float t = 0.f;
  if (col < D)
    for (int b = warp; b < nparts; b += kWarps)
      t += __ldcs(partials + static_cast<long long>(b) * D + col);
  s[warp][threadIdx.x & 31] = t;
  __syncthreads();
  if (warp == 0 && col < D) {
    float u = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) u += s[i][threadIdx.x & 31];
    dw[col] = u;
  }
}

// The (G, V) plan of a width D: the smallest group of 32 to 256 threads
// with at most 4 vectors of 8 a thread. 0 outside [8, kMaxWidth] or for a
// D that is not a multiple of 8.
void plan(int D, int& G, int& V) {
  G = V = 0;
  if (D < 8 || D > kMaxWidth || D % 8) return;
  for (G = 32; G * 32 < D; G *= 2) {
  }
  V = (D / 8 + G - 1) / G;
}

// Launch F<G, V, gate>(args...) for the plan's (G, V); G = 32 takes V 1 to
// 4, the larger groups V 3 or 4 (a narrower row would take a smaller one).
#define RMS_DISPATCH(KERNEL, GATE, GRID, STREAM, ...)                      \
  do {                                                                     \
    const unsigned grid_ = GRID;                                             \
    switch (G * 8 + V) {                                                   \
      case 32 * 8 + 1: KERNEL<32, 1, GATE><<<grid_, kThreads, 0, STREAM>>>( \
          __VA_ARGS__); break;                                             \
      case 32 * 8 + 2: KERNEL<32, 2, GATE><<<grid_, kThreads, 0, STREAM>>>( \
          __VA_ARGS__); break;                                             \
      case 32 * 8 + 3: KERNEL<32, 3, GATE><<<grid_, kThreads, 0, STREAM>>>( \
          __VA_ARGS__); break;                                             \
      case 32 * 8 + 4: KERNEL<32, 4, GATE><<<grid_, kThreads, 0, STREAM>>>( \
          __VA_ARGS__); break;                                             \
      case 64 * 8 + 3: KERNEL<64, 3, GATE><<<grid_, kThreads, 0, STREAM>>>( \
          __VA_ARGS__); break;                                             \
      case 64 * 8 + 4: KERNEL<64, 4, GATE><<<grid_, kThreads, 0, STREAM>>>( \
          __VA_ARGS__); break;                                             \
      case 128 * 8 + 3: KERNEL<128, 3, GATE><<<grid_, kThreads, 0,         \
          STREAM>>>(__VA_ARGS__); break;                                   \
      case 128 * 8 + 4: KERNEL<128, 4, GATE><<<grid_, kThreads, 0,         \
          STREAM>>>(__VA_ARGS__); break;                                   \
      case 256 * 8 + 3: KERNEL<256, 3, GATE><<<grid_, kThreads, 0,         \
          STREAM>>>(__VA_ARGS__); break;                                   \
      case 256 * 8 + 4: KERNEL<256, 4, GATE><<<grid_, kThreads, 0,         \
          STREAM>>>(__VA_ARGS__); break;                                   \
      default: return cudaErrorInvalidValue;                               \
    }                                                                      \
  } while (0)

template <int G, int V, bool kGate>
int bwd_occupancy() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, rms_bwd_kernel<G, V, kGate>, kThreads, 0) != cudaSuccess)
    return 0;
  return n;
}

// Blocks of the backward kernel's persistent grid for (D, gate) and rows:
// as many as fit on the card at once, at most one a row block.
long long bwd_blocks(long long rows, int D, bool gate) {
  int G, V;
  plan(D, G, V);
  if (!G || rows <= 0) return 0;
  int per_sm = 0;
#define RMS_OCC(GG, VV)                                                    \
  if (G == GG && V == VV)                                                  \
    per_sm = gate ? bwd_occupancy<GG, VV, true>()                          \
                  : bwd_occupancy<GG, VV, false>();
  RMS_OCC(32, 1) RMS_OCC(32, 2) RMS_OCC(32, 3) RMS_OCC(32, 4)
  RMS_OCC(64, 3) RMS_OCC(64, 4) RMS_OCC(128, 3) RMS_OCC(128, 4)
  RMS_OCC(256, 3) RMS_OCC(256, 4)
#undef RMS_OCC
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess || per_sm <= 0)
    return 0;
  const long long row_blocks = (rows + kThreads / G - 1) / (kThreads / G);
  const long long fit = static_cast<long long>(per_sm) * sms;
  return row_blocks < fit ? row_blocks : fit;
}

}  // namespace

extern "C" {

// Blocks of the backward's grid, so many partial rows of D floats the
// wrapper allocates; 0 where the kernel does not take (rows, D).
int rms_norm_bwd_blocks(long long rows, int D, int gate) {
  return static_cast<int>(bwd_blocks(rows, D, gate != 0));
}

// out = bf16(g * rstd * w) over `rows` contiguous rows of D bf16, g = x or
// bf16(x * bf16(silu(z))) where z is not null; rstd: rows floats.
int rms_norm_fwd(const void* x, const void* z, const void* w, void* out,
                 void* rstd, long long rows, int D, float inv_d, float eps,
                 void* stream) {
  int G, V;
  plan(D, G, V);
  if (!G || rows <= 0) return cudaErrorInvalidValue;
  const long long blocks = (rows + kThreads / G - 1) / (kThreads / G);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x4 = static_cast<const uint4*>(x);
  const auto* z4 = static_cast<const uint4*>(z);
  const auto* w4 = static_cast<const float4*>(w);
  auto* o4 = static_cast<uint4*>(out);
  auto* r = static_cast<float*>(rstd);
  if (z)
    RMS_DISPATCH(rms_fwd_kernel, true, unsigned(blocks), s, x4, z4, w4, o4,
                 r, rows, D / 8, inv_d, eps);
  else
    RMS_DISPATCH(rms_fwd_kernel, false, unsigned(blocks), s, x4, z4, w4, o4,
                 r, rows, D / 8, inv_d, eps);
  return cudaGetLastError();
}

// dx (and dz where z is not null) and dw of the forward's output given
// dout, on a grid of nparts blocks (rms_norm_bwd_blocks(rows, D, z != null)
// fills the card; the same nparts gives the same bits). partials: nparts
// rows of D floats.
int rms_norm_bwd(const void* dout, const void* x, const void* z,
                 const void* w, const void* rstd, void* dx, void* dz,
                 void* dw, void* partials, long long nparts, long long rows,
                 int D, float inv_d, void* stream) {
  int G, V;
  plan(D, G, V);
  if (!G || rows <= 0 || nparts <= 0 || nparts > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* d4 = static_cast<const uint4*>(dout);
  const auto* x4 = static_cast<const uint4*>(x);
  const auto* z4 = static_cast<const uint4*>(z);
  const auto* w4 = static_cast<const float4*>(w);
  const auto* r = static_cast<const float*>(rstd);
  auto* dx4 = static_cast<uint4*>(dx);
  auto* dz4 = static_cast<uint4*>(dz);
  auto* p = static_cast<float*>(partials);
  if (z)
    RMS_DISPATCH(rms_bwd_kernel, true, unsigned(nparts), s, d4, x4, z4, w4,
                 r, dx4, dz4, p, rows, D / 8, inv_d);
  else
    RMS_DISPATCH(rms_bwd_kernel, false, unsigned(nparts), s, d4, x4, z4, w4,
                 r, dx4, dz4, p, rows, D / 8, inv_d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rms_dw_kernel<<<unsigned((D + 31) / 32), kThreads, 0, s>>>(
      p, static_cast<float*>(dw), int(nparts), D);
  return cudaGetLastError();
}

}  // extern "C"
