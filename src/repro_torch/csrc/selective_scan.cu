// Mamba-1 selective scan on the card, forward and backward (Jamba's mixer).
//
// Replaces no Pallas kernel: the JAX package has no Mamba-1 mixer. Added
// because no kernel of the port computes this recurrence. The SSD kernel
// (ssd_scan.cu) takes one scalar decay per head and shares B and C over the
// head's channels; Mamba-1 has a decay for every (channel, state) pair:
//
//   delta_t[c]  = softplus(delta_raw_t[c] + bias[c])
//   s_t[c, n]   = exp(delta_t[c] A[c, n]) s_{t-1}[c, n] + delta_t[c] B_t[n] u_t[c]
//   y_t[c]      = (sum_n C_t[n] s_t[c, n] + D[c] u_t[c]) * silu(z_t[c])
//
// u, delta_raw, z (B, S, Dc) and B_t, C_t (B, S, N) bfloat16 with a
// contiguous last dimension; A (Dc, N), D and bias (Dc) float32; y (B, S, Dc)
// bfloat16, contiguous. N = 16 (STATE); Dc a multiple of 128. The recurrence
// runs in float32 and the state never leaves the chip inside a chunk.
//
// What bounds it on an H100: one exp per (token, channel, state), 1.34 G a
// layer at Jamba2-3B's (1, 16384, 5120, 16), on the SFU (16 a clock per SM,
// ~0.36 ms a pass), beside 0.67 GB of bf16 reads and writes and 0.67 GB of
// kept float32 states (0.40 ms at 3.35 TB/s). Design (Mamba's hardware-aware scan, arXiv:2312.00752 s3.3,
// laid out for the port's channel-contiguous (B, S, Dc) tensors): a thread
// owns one channel and its 16 states in registers and walks CHUNK = 64
// steps; chunks run in parallel; B and C of the chunk's steps sit in shared
// memory as float32 rows, read 16 bytes at a time.
//
// Forward, three launches:
//   ss_fwd_chunk_kernel<false>  each chunk's end state from zero, and the
//                               sum of its deltas (the chunk's decay is
//                               exp(A sum delta));
//   ss_state_pass_kernel        a pass over the chunks that turns them
//                               into the state entering each chunk, in
//                               place;
//   ss_fwd_chunk_kernel<true>   each chunk again from its entering state,
//                               writing y and, for the backward, the state
//                               before every SUB-th step (B, S / SUB, N, Dc)
//                               float32.
// Backward, five launches, no atomics (every sum in a fixed order):
//   ss_bwd_adjoint_kernel       each chunk's adjoint of its entering state
//                               from its own outputs, walking back from zero;
//                               the deltas as float32 for the main pass;
//   ss_adjoint_pass_kernel      a reverse pass over the chunks: the adjoint
//                               of the state leaving each chunk;
//   ss_bwd_chunk_kernel         each chunk: 4 lanes a channel (4 states
//                               each); per SUB steps, last first, the states
//                               and decays again in registers from the kept
//                               state, then the reverse steps: du, d
//                               delta_raw, dz written; dB, dC summed over
//                               the block's 64 channels (butterfly in the
//                               warp, warps in order) into one row per
//                               64-channel tile; dA, dD and the bias
//                               gradient summed over the chunk;
//   ss_bwd_bc_kernel            dB, dC: the tiles' rows summed in order;
//   ss_bwd_param_kernel         dA, dD, d bias: the chunks summed in order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int STATE = 16;        // N
constexpr int CHUNK = 64;        // steps a thread walks
constexpr int SUB = 8;           // steps between the kept states
constexpr int SUBS = CHUNK / SUB;
constexpr int FWD_THREADS = 128; // channels a block of the one-lane kernels
constexpr int LANES = 4;         // lanes a channel in ss_bwd_chunk_kernel
constexpr int NS = STATE / LANES;
constexpr int BWD_THREADS = 256; // 64 channels
constexpr int BWD_CHANNELS = BWD_THREADS / LANES;
constexpr int WARPS = BWD_THREADS / 32;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(NS == 4, "a lane's states are read as one float4 row");
static_assert(BWD_THREADS == SUB * 2 * STATE,
              "a thread a (step, dB or dC state) of the SUB steps' rows");

struct Strides {                 // elements: batch and row strides
  long long u_b, u_s, d_b, d_s, z_b, z_s, B_b, B_s, C_b, C_s;
};

__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// torch's softplus (beta 1, threshold 20)
__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + __expf(-x));
}

// 2^x on the SFU, a subnormal result flushed to 0 (a decay below 2^-126
// leaves nothing of the state either way)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// B or C of the chunk's steps into shared memory as float32, zero past S
__device__ void load_tile(float (*dst)[STATE], const __nv_bfloat16* src,
                          long long bs, long long ss, int b, int t0, int S) {
  for (int i = threadIdx.x; i < CHUNK * STATE; i += blockDim.x) {
    int j = i / STATE, n = i % STATE, t = t0 + j;
    dst[j][n] = t < S ? ld(src + b * bs + t * ss + n) : 0.f;
  }
}

// Rows t0 .. t0 + CHUNK - 1 of a (B, S, Dc) tensor, channels c0 .. c0 + W
// - 1, into dst[CHUNK][W] in 16-byte loads, zero past the chunk's steps: a
// block asks for its whole chunk at once, so the loads' latency is paid
// once a chunk.
template <int W, typename T>
__device__ void stage(T* dst, const T* src, long long bs, long long ss,
                      int b, int t0, int steps, int c0) {
  constexpr int V = W * sizeof(T) / 16;   // 16-byte vectors a row
  for (int i = threadIdx.x; i < CHUNK * V; i += blockDim.x) {
    const int j = i / V, v = i % V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (j < steps)
      val = *reinterpret_cast<const uint4*>(
          src + b * bs + (long long)(t0 + j) * ss + c0 + v * (16 / sizeof(T)));
    reinterpret_cast<uint4*>(dst + j * W)[v] = val;
  }
}

// NV values of row j of a (CHUNK, STATE) tile from column n0, in 16-byte
// reads
template <int NV>
__device__ __forceinline__ void row(const float (*t)[STATE], int j, int n0,
                                   float* out) {
  const float4* r = reinterpret_cast<const float4*>(t[j] + n0);
#pragma unroll
  for (int q = 0; q < NV / 4; ++q) {
    const float4 v = r[q];
    out[4 * q] = v.x;
    out[4 * q + 1] = v.y;
    out[4 * q + 2] = v.z;
    out[4 * q + 3] = v.w;
  }
}

// One round of the butterfly: the lane whose bit m is set keeps values
// HALF .. 2 HALF - 1 and sends 0 .. HALF - 1, its partner the other way;
// each adds what it receives to what it keeps, in v[0 .. HALF - 1].
template <int HALF>
__device__ __forceinline__ void fold(float* v, int bit, int m) {
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = bit ? v[i] : v[i + HALF];
    const float keep = bit ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
  }
}

// A pass over one chunk with a thread a channel: from zero (OUT false),
// leaving the end state and the deltas' sum in ends and sdelta; or from
// the entering state in ends (OUT true), writing y and the kept states.
// Dynamic shared memory: fwd_smem(OUT).
template <bool OUT>
__global__ void __launch_bounds__(FWD_THREADS)
ss_fwd_chunk_kernel(const __nv_bfloat16* __restrict__ u,
                    const __nv_bfloat16* __restrict__ draw,
                    const float* __restrict__ bias,
                    const float* __restrict__ A,
                    const __nv_bfloat16* __restrict__ Bm,
                    const __nv_bfloat16* __restrict__ Cm,
                    const float* __restrict__ Dv,
                    const __nv_bfloat16* __restrict__ z,
                    __nv_bfloat16* __restrict__ y,
                    float* __restrict__ ends,     // (Bt, nc, N, Dc)
                    float* __restrict__ kept,     // (Bt, ceil(S / SUB), N, Dc)
                    float* __restrict__ sdelta, int S, int Dc, Strides st) {
  extern __shared__ __align__(16) unsigned char smem[];
  float (*sB)[STATE] = reinterpret_cast<float (*)[STATE]>(smem);
  float (*sC)[STATE] = sB + CHUNK;               // OUT only
  __nv_bfloat16* su = reinterpret_cast<__nv_bfloat16*>(
      sB + (OUT ? 2 : 1) * CHUNK);
  __nv_bfloat16* sd = su + CHUNK * FWD_THREADS;
  __nv_bfloat16* sz = sd + CHUNK * FWD_THREADS;  // OUT only
  const int tid = threadIdx.x, c0 = blockIdx.x * FWD_THREADS, c = c0 + tid;
  const int k = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int t0 = k * CHUNK, steps = min(CHUNK, S - t0);
  load_tile(sB, Bm, st.B_b, st.B_s, b, t0, S);
  stage<FWD_THREADS>(su, u, st.u_b, st.u_s, b, t0, steps, c0);
  stage<FWD_THREADS>(sd, draw, st.d_b, st.d_s, b, t0, steps, c0);
  if constexpr (OUT) {
    load_tile(sC, Cm, st.C_b, st.C_s, b, t0, S);
    stage<FWD_THREADS>(sz, z, st.z_b, st.z_s, b, t0, steps, c0);
  }
  float a2[STATE], h[STATE];
  const long long ebase = ((long long)b * nc + k) * STATE * Dc + c;
#pragma unroll
  for (int n = 0; n < STATE; ++n) {
    a2[n] = A[c * STATE + n] * LOG2E;
    h[n] = OUT ? ends[ebase + (long long)n * Dc] : 0.f;
  }
  const float bc = bias[c], dc = OUT ? Dv[c] : 0.f;
  __syncthreads();
  __nv_bfloat16* yp = OUT ? y + ((long long)b * S + t0) * Dc + c : nullptr;
  const long long nk = (S + SUB - 1) / SUB;
  float sdl = 0.f;
  for (int j = 0; j < steps; ++j) {
    if constexpr (OUT) {
      if (j % SUB == 0) {
        const long long at = ((long long)b * nk + (t0 + j) / SUB) * STATE
                             * Dc + c;
#pragma unroll
        for (int n = 0; n < STATE; ++n) kept[at + (long long)n * Dc] = h[n];
      }
    }
    const float uv = __bfloat162float(su[j * FWD_THREADS + tid]);
    const float d = softplus(__bfloat162float(sd[j * FWD_THREADS + tid])
                             + bc);
    const float du = d * uv;
    float acc = 0.f;
    sdl += d;
#pragma unroll
    for (int q = 0; q < STATE; q += 4) {      // 4 states at a time
      float bq[4], cq[4];
      row<4>(sB, j, q, bq);
      if constexpr (OUT) row<4>(sC, j, q, cq);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[q + i] = ex2(d * a2[q + i]) * h[q + i] + du * bq[i];
        if constexpr (OUT) acc += cq[i] * h[q + i];
      }
    }
    if constexpr (OUT) {
      const float zz = __bfloat162float(sz[j * FWD_THREADS + tid]);
      yp[(long long)j * Dc] =
          __float2bfloat16((acc + dc * uv) * (zz * sigmoid(zz)));
    }
  }
  if constexpr (!OUT) {
#pragma unroll
    for (int n = 0; n < STATE; ++n) ends[ebase + (long long)n * Dc] = h[n];
    sdelta[((long long)b * nc + k) * Dc + c] = sdl;
  }
}

constexpr size_t fwd_smem(bool out) {
  return sizeof(float) * (out ? 2 : 1) * CHUNK * STATE
         + sizeof(__nv_bfloat16) * (out ? 3 : 2) * CHUNK * FWD_THREADS;
}

// Per (batch, state, channel): the chunks' end states (from zero) into the
// state entering each chunk, in place.
__global__ void ss_state_pass_kernel(float* __restrict__ ends,
                                     const float* __restrict__ sdelta,
                                     const float* __restrict__ A, int Bt,
                                     int nc, int Dc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)Bt * STATE * Dc) return;
  const int c = i % Dc, n = (i / Dc) % STATE, b = i / ((long long)STATE * Dc);
  const float a2 = A[c * STATE + n] * LOG2E;
  float carry = 0.f;
  for (int k = 0; k < nc; ++k) {
    const long long at = (((long long)b * nc + k) * STATE + n) * Dc + c;
    const float end = ends[at];
    ends[at] = carry;
    carry = ex2(a2 * sdelta[((long long)b * nc + k) * Dc + c]) * carry + end;
  }
}

// Each chunk's adjoint of its entering state from its own outputs: walking
// back from zero, g <- a_t (g + dy_t C_t); the chunk's delta sum, and each
// step's delta as float32 for the main pass. Dynamic shared memory:
// ADJ_SMEM.
__global__ void __launch_bounds__(FWD_THREADS)
ss_bwd_adjoint_kernel(const __nv_bfloat16* __restrict__ draw,
                      const float* __restrict__ bias,
                      const float* __restrict__ A,
                      const __nv_bfloat16* __restrict__ Cm,
                      const __nv_bfloat16* __restrict__ z,
                      const __nv_bfloat16* __restrict__ dout,
                      float* __restrict__ gbuf, float* __restrict__ sdelta,
                      float* __restrict__ delta, int S, int Dc, Strides st) {
  extern __shared__ __align__(16) unsigned char smem[];
  float (*sC)[STATE] = reinterpret_cast<float (*)[STATE]>(smem);
  __nv_bfloat16* sd = reinterpret_cast<__nv_bfloat16*>(sC + CHUNK);
  __nv_bfloat16* sz = sd + CHUNK * FWD_THREADS;
  __nv_bfloat16* so = sz + CHUNK * FWD_THREADS;
  const int tid = threadIdx.x, c0 = blockIdx.x * FWD_THREADS, c = c0 + tid;
  const int k = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int t0 = k * CHUNK, steps = min(CHUNK, S - t0);
  load_tile(sC, Cm, st.C_b, st.C_s, b, t0, S);
  stage<FWD_THREADS>(sd, draw, st.d_b, st.d_s, b, t0, steps, c0);
  stage<FWD_THREADS>(sz, z, st.z_b, st.z_s, b, t0, steps, c0);
  stage<FWD_THREADS>(so, dout, (long long)S * Dc, Dc, b, t0, steps, c0);
  float a2[STATE], g[STATE];
#pragma unroll
  for (int n = 0; n < STATE; ++n) {
    a2[n] = A[c * STATE + n] * LOG2E;
    g[n] = 0.f;
  }
  const float bc = bias[c];
  __syncthreads();
  float sdl = 0.f;
  for (int j = steps - 1; j >= 0; --j) {
    const float d = softplus(__bfloat162float(sd[j * FWD_THREADS + tid])
                             + bc);
    const float zz = __bfloat162float(sz[j * FWD_THREADS + tid]);
    const float dy = __bfloat162float(so[j * FWD_THREADS + tid])
                     * (zz * sigmoid(zz));
    sdl += d;
    delta[((long long)b * S + t0 + j) * Dc + c] = d;
#pragma unroll
    for (int q = 0; q < STATE; q += 4) {
      float cq[4];
      row<4>(sC, j, q, cq);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        g[q + i] = ex2(d * a2[q + i]) * (g[q + i] + dy * cq[i]);
    }
  }
  const long long base = ((long long)b * nc + k) * STATE * Dc + c;
#pragma unroll
  for (int n = 0; n < STATE; ++n) gbuf[base + (long long)n * Dc] = g[n];
  sdelta[((long long)b * nc + k) * Dc + c] = sdl;
}

constexpr size_t ADJ_SMEM = sizeof(float) * CHUNK * STATE
                            + sizeof(__nv_bfloat16) * 3 * CHUNK * FWD_THREADS;

// Per (batch, state, channel), last chunk first: the chunks' own adjoints
// into the adjoint of the state leaving each chunk, in place.
__global__ void ss_adjoint_pass_kernel(float* __restrict__ gbuf,
                                       const float* __restrict__ sdelta,
                                       const float* __restrict__ A, int Bt,
                                       int nc, int Dc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)Bt * STATE * Dc) return;
  const int c = i % Dc, n = (i / Dc) % STATE, b = i / ((long long)STATE * Dc);
  const float a2 = A[c * STATE + n] * LOG2E;
  float carry = 0.f;
  for (int k = nc - 1; k >= 0; --k) {
    const long long at = (((long long)b * nc + k) * STATE + n) * Dc + c;
    const float own = gbuf[at];
    gbuf[at] = carry;
    carry = own + ex2(a2 * sdelta[((long long)b * nc + k) * Dc + c]) * carry;
  }
}

// The chunk's gradients. Lane l of a warp: channel warp * 8 + l / 4 of the
// block's 64, states 4 (l % 4) .. 4 (l % 4) + 3. Dynamic shared memory:
// BWD_SMEM.
__global__ void __launch_bounds__(BWD_THREADS, 2)
ss_bwd_chunk_kernel(const __nv_bfloat16* __restrict__ u,
                    const float* __restrict__ delta,
                    const float* __restrict__ A,
                    const __nv_bfloat16* __restrict__ Bm,
                    const __nv_bfloat16* __restrict__ Cm,
                    const float* __restrict__ Dv,
                    const __nv_bfloat16* __restrict__ z,
                    const float* __restrict__ kept,
                    const float* __restrict__ gbuf,
                    const __nv_bfloat16* __restrict__ dout,
                    __nv_bfloat16* __restrict__ du_out,
                    __nv_bfloat16* __restrict__ ddraw_out,
                    __nv_bfloat16* __restrict__ dz_out,
                    float* __restrict__ bc_part,   // (Bt, S, tiles, 2 N)
                    float* __restrict__ dA_part,   // (Bt, nc, N, Dc)
                    float* __restrict__ dD_part,   // (Bt, nc, Dc)
                    float* __restrict__ dbias_part,
                    int S, int Dc, Strides st) {
  extern __shared__ __align__(16) unsigned char smem[];
  float (*sB)[STATE] = reinterpret_cast<float (*)[STATE]>(smem);
  float (*sC)[STATE] = sB + CHUNK;
  float* sdl = reinterpret_cast<float*>(sC + CHUNK);       // delta
  __nv_bfloat16* su = reinterpret_cast<__nv_bfloat16*>(
      sdl + CHUNK * BWD_CHANNELS);
  __nv_bfloat16* sz = su + CHUNK * BWD_CHANNELS;
  __nv_bfloat16* so = sz + CHUNK * BWD_CHANNELS;             // dy
  // each step's dB and dC, summed over a warp's 8 channels
  float (*red)[WARPS][2 * STATE] = reinterpret_cast<float (*)[WARPS][2 * STATE]>(
      so + CHUNK * BWD_CHANNELS);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sg = lane % LANES, chl = lane / LANES, cl = warp * 8 + chl;
  const int c0 = blockIdx.x * BWD_CHANNELS, c = c0 + cl;
  const int k = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int tiles = gridDim.x;
  const int t0 = k * CHUNK, steps = min(CHUNK, S - t0);
  const long long nk = (S + SUB - 1) / SUB;
  load_tile(sB, Bm, st.B_b, st.B_s, b, t0, S);
  load_tile(sC, Cm, st.C_b, st.C_s, b, t0, S);
  stage<BWD_CHANNELS>(sdl, delta, (long long)S * Dc, Dc, b, t0, steps, c0);
  stage<BWD_CHANNELS>(su, u, st.u_b, st.u_s, b, t0, steps, c0);
  stage<BWD_CHANNELS>(sz, z, st.z_b, st.z_s, b, t0, steps, c0);
  stage<BWD_CHANNELS>(so, dout, (long long)S * Dc, Dc, b, t0, steps, c0);

  float a2[NS], av[NS], g[NS], dA[NS];
  const long long gbase = ((long long)b * nc + k) * STATE * Dc + c;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int n = sg * NS + i;
    av[i] = A[c * STATE + n];
    a2[i] = av[i] * LOG2E;
    g[i] = gbuf[gbase + (long long)n * Dc];
    dA[i] = 0.f;
  }
  const float dc = Dv[c];
  float dD = 0.f, dbias = 0.f;
  __syncthreads();

  for (int s = SUBS - 1; s >= 0; --s) {
    if (s * SUB >= steps) continue;    // the same for the whole block
    // the SUB steps' states (after each step) and decays, again, from the
    // state kept before the first of them
    float hs[SUB][NS], as[SUB][NS], ds[SUB], start[NS], h[NS];
    const long long kat = ((long long)b * nk + (t0 + s * SUB) / SUB) * STATE
                          * Dc + c;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      start[i] = kept[kat + (long long)(sg * NS + i) * Dc];
      h[i] = start[i];
    }
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      const int jj = s * SUB + j;
      const float d = sdl[jj * BWD_CHANNELS + cl];       // 0 past the steps
      const float du = d * __bfloat162float(su[jj * BWD_CHANNELS + cl]);
      float bj[NS];
      row<NS>(sB, jj, sg * NS, bj);
      ds[j] = d;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        as[j][i] = ex2(d * a2[i]);
        h[i] = as[j][i] * h[i] + du * bj[i];
        hs[j][i] = h[i];
      }
    }
#pragma unroll
    for (int j = SUB - 1; j >= 0; --j) {
      const int jj = s * SUB + j, t = t0 + jj;
      const bool ok = jj < steps;
      const float d = ds[j];
      const float uv = __bfloat162float(su[jj * BWD_CHANNELS + cl]);
      const float zz = __bfloat162float(sz[jj * BWD_CHANNELS + cl]);
      const float dov = __bfloat162float(so[jj * BWD_CHANNELS + cl]);
      const float sgz = sigmoid(zz);
      const float dy = dov * (zz * sgz);
      float bj[NS], cj[NS], ysum = 0.f, pg = 0.f, pa = 0.f, v[2 * NS];
      row<NS>(sB, jj, sg * NS, bj);
      row<NS>(sC, jj, sg * NS, cj);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float prev = j > 0 ? hs[j - 1][i] : start[i];
        ysum += cj[i] * hs[j][i];
        g[i] += dy * cj[i];
        pg += g[i] * bj[i];
        const float ga = g[i] * prev * as[j][i];
        pa += ga * av[i];
        dA[i] += ga * d;
        v[i] = g[i] * d * uv;          // dB
        v[NS + i] = dy * hs[j][i];     // dC
        g[i] *= as[j][i];
      }
#pragma unroll
      for (int m = 1; m < LANES; m *= 2) {
        ysum += __shfl_xor_sync(0xffffffffu, ysum, m);
        pg += __shfl_xor_sync(0xffffffffu, pg, m);
        pa += __shfl_xor_sync(0xffffffffu, pa, m);
      }
      const float yv = ysum + dc * uv;
      const float dz = dov * yv * (sgz * (1.f + zz * (1.f - sgz)));
      const float ddelta = pa + uv * pg;
      const float ddraw = ddelta * -expm1f(-d);     // softplus' = sigmoid
      const float duv = d * pg + dy * dc;
      if (ok) {
        const long long at = ((long long)b * S + t) * Dc + c;
        if (sg == 0) du_out[at] = __float2bfloat16(duv);
        if (sg == 1) ddraw_out[at] = __float2bfloat16(ddraw);
        if (sg == 2) dz_out[at] = __float2bfloat16(dz);
        dD += dy * uv;
        dbias += ddraw;
      }
      // dB and dC over the warp's 8 channels: a butterfly that leaves lane
      // (chl, sg) the sum of value chl (dB for chl < 4, else dC) of state
      // sg * 4 + chl % 4
      fold<4>(v, lane & 16, 16);
      fold<2>(v, lane & 8, 8);
      fold<1>(v, lane & 4, 4);
      red[j][warp][(chl / NS) * STATE + sg * NS + chl % NS] = v[0];
    }
    __syncthreads();
    {  // the SUB steps' rows of this tile: the warps summed in order
      const int j = tid / (2 * STATE), o = tid % (2 * STATE);
      const int jj = s * SUB + j;
      if (jj < steps) {
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) acc += red[j][w][o];
        bc_part[(((long long)b * S + t0 + jj) * tiles + blockIdx.x)
                * (2 * STATE) + o] = acc;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < NS; ++i)
    dA_part[gbase + (long long)(sg * NS + i) * Dc] = dA[i];
  if (sg == 0) {
    dD_part[((long long)b * nc + k) * Dc + c] = dD;
    dbias_part[((long long)b * nc + k) * Dc + c] = dbias;
  }
}

constexpr size_t BWD_SMEM =
    sizeof(float) * (2 * CHUNK * STATE + CHUNK * BWD_CHANNELS
                     + SUB * WARPS * 2 * STATE)
    + sizeof(__nv_bfloat16) * 3 * CHUNK * BWD_CHANNELS;

// dB and dC of each (batch, step, state): the tiles' rows summed in order.
__global__ void ss_bwd_bc_kernel(const float* __restrict__ bc_part,
                                 __nv_bfloat16* __restrict__ dB,
                                 __nv_bfloat16* __restrict__ dC,
                                 long long rows, int tiles) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * 2 * STATE) return;
  const long long r = i / (2 * STATE);
  const int o = i % (2 * STATE);
  float acc = 0.f;
  for (int tile = 0; tile < tiles; ++tile)
    acc += bc_part[(r * tiles + tile) * (2 * STATE) + o];
  __nv_bfloat16* out = o < STATE ? dB : dC;
  out[r * STATE + o % STATE] = __float2bfloat16(acc);
}

// dA (Dc, N), dD and d bias (Dc): the chunks of every batch row summed in
// order.
__global__ void ss_bwd_param_kernel(const float* __restrict__ dA_part,
                                    const float* __restrict__ dD_part,
                                    const float* __restrict__ dbias_part,
                                    float* __restrict__ dA,
                                    float* __restrict__ dD,
                                    float* __restrict__ dbias, int Bt, int nc,
                                    int Dc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (STATE + 2) * Dc) return;
  const int c = i % Dc, which = i / Dc;
  float acc = 0.f;
  for (long long bk = 0; bk < (long long)Bt * nc; ++bk) {
    if (which < STATE)
      acc += dA_part[(bk * STATE + which) * Dc + c];
    else
      acc += (which == STATE ? dD_part : dbias_part)[bk * Dc + c];
  }
  if (which < STATE)
    dA[c * STATE + which] = acc;
  else
    (which == STATE ? dD : dbias)[c] = acc;
}

// Let the kernels whose shared memory passes 48 KB have it.
cudaError_t set_smem() {
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t e = cudaFuncSetAttribute(ss_fwd_chunk_kernel<false>, attr,
                                       (int)fwd_smem(false));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ss_fwd_chunk_kernel<true>, attr,
                             (int)fwd_smem(true));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ss_bwd_adjoint_kernel, attr, (int)ADJ_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ss_bwd_chunk_kernel, attr, (int)BWD_SMEM);
  return e;
}

Strides strides_of(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9]};
}

}  // namespace

extern "C" {

// The forward: y and the kept states (Bt, ceil(S / SUB), N, Dc) float32,
// the state before every SUB-th step; ends (Bt, nc, N, Dc) and sdelta (Bt,
// nc, Dc) are float32 scratch, nc = ceil(S / CHUNK).
int ss_fwd(const void* u, const void* draw, const void* bias, const void* A,
           const void* Bm, const void* Cm, const void* Dv, const void* z,
           void* y, void* kept, void* ends, void* sdelta, long long Bt,
           long long S, long long Dc, const long long* strides,
           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st = strides_of(strides);
  const int nc = (int)((S + CHUNK - 1) / CHUNK);
  const dim3 grid((unsigned)(Dc / FWD_THREADS), nc, (unsigned)Bt);
  const auto* bu = static_cast<const __nv_bfloat16*>(u);
  const auto* bd = static_cast<const __nv_bfloat16*>(draw);
  const auto* bB = static_cast<const __nv_bfloat16*>(Bm);
  const auto* bC = static_cast<const __nv_bfloat16*>(Cm);
  const auto* bz = static_cast<const __nv_bfloat16*>(z);
  const auto* fb = static_cast<const float*>(bias);
  const auto* fA = static_cast<const float*>(A);
  const auto* fD = static_cast<const float*>(Dv);
  auto* fe = static_cast<float*>(ends);
  auto* fk = static_cast<float*>(kept);
  auto* fsd = static_cast<float*>(sdelta);
  cudaError_t e = set_smem();
  if (e != cudaSuccess) return e;
  ss_fwd_chunk_kernel<false><<<grid, FWD_THREADS, fwd_smem(false), s>>>(
      bu, bd, fb, fA, bB, bC, fD, bz, nullptr, fe, fk, fsd, (int)S, (int)Dc,
      st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long lanes = Bt * STATE * Dc;
  ss_state_pass_kernel<<<(unsigned)((lanes + 255) / 256), 256, 0, s>>>(
      fe, fsd, fA, (int)Bt, nc, (int)Dc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ss_fwd_chunk_kernel<true><<<grid, FWD_THREADS, fwd_smem(true), s>>>(
      bu, bd, fb, fA, bB, bC, fD, bz, static_cast<__nv_bfloat16*>(y), fe, fk,
      fsd, (int)S, (int)Dc, st);
  return cudaGetLastError();
}

// The backward given dout (Bt, S, Dc) contiguous and the kept states: du,
// ddraw, dz (Bt, S, Dc) and dB, dC (Bt, S, N) bfloat16, contiguous; dbias,
// dD (Dc) and dA (Dc, N) float32. Scratch, float32: gbuf and dA_part (Bt,
// nc, N, Dc), sdelta, dD_part and dbias_part (Bt, nc, Dc), delta (Bt, S,
// Dc), bc_part (Bt, S, Dc / 64, 2 N).
int ss_bwd(const void* u, const void* draw, const void* bias, const void* A,
           const void* Bm, const void* Cm, const void* Dv, const void* z,
           const void* kept, const void* dout, void* du, void* ddraw,
           void* dz, void* dbias, void* dA, void* dB, void* dC, void* dD,
           void* gbuf, void* sdelta, void* delta, void* bc_part,
           void* dA_part, void* dD_part, void* dbias_part, long long Bt,
           long long S, long long Dc, const long long* strides,
           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st = strides_of(strides);
  const int nc = (int)((S + CHUNK - 1) / CHUNK);
  const auto* bu = static_cast<const __nv_bfloat16*>(u);
  const auto* bd = static_cast<const __nv_bfloat16*>(draw);
  const auto* bB = static_cast<const __nv_bfloat16*>(Bm);
  const auto* bC = static_cast<const __nv_bfloat16*>(Cm);
  const auto* bz = static_cast<const __nv_bfloat16*>(z);
  const auto* bo = static_cast<const __nv_bfloat16*>(dout);
  const auto* fb = static_cast<const float*>(bias);
  const auto* fA = static_cast<const float*>(A);
  const auto* fD = static_cast<const float*>(Dv);
  auto* fg = static_cast<float*>(gbuf);
  auto* fsd = static_cast<float*>(sdelta);
  auto* fdl = static_cast<float*>(delta);
  cudaError_t e = set_smem();
  if (e != cudaSuccess) return e;
  ss_bwd_adjoint_kernel<<<dim3((unsigned)(Dc / FWD_THREADS), nc,
                               (unsigned)Bt), FWD_THREADS, ADJ_SMEM, s>>>(
      bd, fb, fA, bC, bz, bo, fg, fsd, fdl, (int)S, (int)Dc, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long lanes = Bt * STATE * Dc;
  ss_adjoint_pass_kernel<<<(unsigned)((lanes + 255) / 256), 256, 0, s>>>(
      fg, fsd, fA, (int)Bt, nc, (int)Dc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int tiles = (int)(Dc / BWD_CHANNELS);
  auto* fbc = static_cast<float*>(bc_part);
  auto* fdA = static_cast<float*>(dA_part);
  auto* fdD = static_cast<float*>(dD_part);
  auto* fdb = static_cast<float*>(dbias_part);
  ss_bwd_chunk_kernel<<<dim3((unsigned)tiles, nc, (unsigned)Bt), BWD_THREADS,
                        BWD_SMEM, s>>>(
      bu, fdl, fA, bB, bC, fD, bz, static_cast<const float*>(kept), fg, bo,
      static_cast<__nv_bfloat16*>(du), static_cast<__nv_bfloat16*>(ddraw),
      static_cast<__nv_bfloat16*>(dz), fbc, fdA, fdD, fdb, (int)S, (int)Dc,
      st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long rows = Bt * S;
  ss_bwd_bc_kernel<<<(unsigned)((rows * 2 * STATE + 255) / 256), 256, 0, s>>>(
      fbc, static_cast<__nv_bfloat16*>(dB), static_cast<__nv_bfloat16*>(dC),
      rows, tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ss_bwd_param_kernel<<<(unsigned)(((STATE + 2) * Dc + 255) / 256), 256, 0,
                        s>>>(fdA, fdD, fdb, static_cast<float*>(dA),
                             static_cast<float*>(dD),
                             static_cast<float*>(dbias), (int)Bt, nc,
                             (int)Dc);
  return cudaGetLastError();
}

}  // extern "C"
