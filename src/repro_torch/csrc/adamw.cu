// AdamW over every parameter in two launches, for Hopper (sm_90a), with a
// plain C interface loaded through ctypes by repro_torch/kernels/adamw.py.
//
// Replaces no Pallas kernel: the reference's update (src/repro/train/
// optimizer.py, apply_updates and global_norm) is jnp elementwise code that
// XLA fuses into a few loops over each array. Run eagerly, the same
// arithmetic is a chain of some twenty elementwise launches per tensor, each
// reading and writing float32 temporaries; this kernel is the fusion XLA
// does, written by hand.
//
// What bounds it on the card: bytes. Each element needs one read of the
// gradient for the norm (4 B) and then one read of p, g, m, v and one write
// of p, m, v: 28 B with float32 moments, 20 B with bfloat16 ones. That is
// 24 to 32 B an element, 108 GB (32 ms at 3.35 TB/s) for dbrx-132b-l1's
// 4.49 G parameters; 4.1 GB (1.2 ms) for mamba2-130m's 129 M. The design:
//
// - One table of chunks over all tensors (adamw.py builds it once and keeps
//   it on the card): a chunk is (row, offset, length) of at most kChunk
//   elements of one tensor; a row is one tensor's four pointers, its element
//   count, its decay flag and its replica count. One block per chunk, so a
//   large tensor is many blocks and a small one is one block of the same
//   launch: few huge tensors (bandwidth) and many small ones (launches)
//   both take one launch for the norm and one for the update.
// - sumsq_kernel: each block sums g*g over its chunk in float32 and divides
//   its sum by the tensor's replica count (a DTensor shard held by r ranks);
//   the last block to finish (an acq_rel counter, reset by that block) adds
//   the chunks' sums in chunk order in float64 and writes the float32 total.
//   No float atomics: the same gradients give the same bits on every call.
// - update_kernel<S>: S is the moments' type (float or __nv_bfloat16). Each
//   thread takes 8 elements a step with 16-byte loads and stores (two float4
//   of p and of g; of m and v two float4, or one uint4 of bf16), where the
//   four pointers are 16-byte aligned, else one element at a time; the
//   ragged tail of a chunk one element at a time. p, m and v are stored once.
// - The arithmetic is apply_updates' eager float32 chain, rounding after
//   every operation as each eager launch does: the __f*_rn intrinsics are
//   never contracted into an FMA, so the result equals the plain version's
//   bit for bit. The moments round to bfloat16 to nearest even, as torch's
//   copy_ does. The step's scale, lr and bias corrections are read from
//   their 0-d device tensors: the host does not wait for the device.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the cudaError_t of its launch.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;  // elements a thread takes per step

// One tensor, as adamw.py packs it: 8 int64 per row.
struct Row {
  long long p, g, m, v;  // device pointers
  long long n;           // elements
  long long decay;       // 1: decoupled weight decay applies
  long long replicas;    // ranks that hold each element (1 off a mesh)
  long long unused;
};

// A chunk of one tensor: 3 int64.
struct Chunk {
  long long row, offset, length;
};

// The optimizer's constants, each rounded from the host's double to float32
// as torch rounds a Python float operand of a float32 op.
struct Consts {
  float b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay;
};

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

// The sum of x over the block, in a fixed order, in thread 0.
template <typename T>
__device__ __forceinline__ T block_sum(T x, T* shared) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) shared[threadIdx.x >> 5] = x;
  __syncthreads();
  T total = T(0);
  if (threadIdx.x == 0)
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += shared[w];
  return total;
}

__global__ void __launch_bounds__(kThreads)
    sumsq_kernel(const Row* __restrict__ rows,
                 const Chunk* __restrict__ chunks, long long nchunks,
                 float* __restrict__ partials, int* done,
                 float* __restrict__ out) {
  __shared__ float warp_f[kWarps];
  __shared__ double warp_d[kWarps];
  __shared__ int last;
  const Chunk c = chunks[blockIdx.x];
  const Row r = rows[c.row];
  const float* g = reinterpret_cast<const float*>(r.g) + c.offset;
  float acc = 0.f;
  long long head = 0;
  if (aligned16(g)) {
    const long long n4 = c.length / 4;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (long long i = threadIdx.x; i < n4; i += kThreads) {
      const float4 x = __ldcs(g4 + i);
      acc = fmaf(x.x, x.x, acc);
      acc = fmaf(x.y, x.y, acc);
      acc = fmaf(x.z, x.z, acc);
      acc = fmaf(x.w, x.w, acc);
    }
    head = 4 * n4;
  }
  for (long long i = head + threadIdx.x; i < c.length; i += kThreads) {
    const float x = __ldcs(g + i);
    acc = fmaf(x, x, acc);
  }
  const float sum = block_sum(acc, warp_f);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = __fdiv_rn(sum, float(r.replicas));
    // release: this block's partial is visible on the card before its
    // count; acquire: the last block's loads below see every partial
    int before;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;"
                 : "=r"(before) : "l"(done) : "memory");
    last = before == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last) return;  // uniform
  double total = 0.0;
  for (long long i = threadIdx.x; i < nchunks; i += kThreads)
    total += double(__ldcg(partials + i));
  total = block_sum(total, warp_d);
  if (threadIdx.x == 0) {
    out[0] = float(total);
    *done = 0;  // ready for the next launch on this table
  }
}

// One element of apply_updates, rounded as the eager chain rounds.
__device__ __forceinline__ void adamw(float& p, float g, float& m, float& v,
                                      const Consts& k, float scale, float lr,
                                      float bc1, float bc2, bool decay) {
  g = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(k.b2, v),
                __fmul_rn(k.one_minus_b2, __fmul_rn(g, g)));
  float delta = __fdiv_rn(__fdiv_rn(m, bc1),
                          __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), k.eps));
  if (decay) delta = __fadd_rn(delta, __fmul_rn(k.weight_decay, p));
  p = __fsub_rn(p, __fmul_rn(lr, delta));
}

__device__ __forceinline__ float load1(const float* a) { return __ldcs(a); }
__device__ __forceinline__ float load1(const __nv_bfloat16* a) {
  return __bfloat162float(*a);
}
__device__ __forceinline__ void store1(float* a, float x) { __stcs(a, x); }
__device__ __forceinline__ void store1(__nv_bfloat16* a, float x) {
  *a = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void load8(const float* a, float (&x)[kVec]) {
  const float4 lo = __ldcs(reinterpret_cast<const float4*>(a));
  const float4 hi = __ldcs(reinterpret_cast<const float4*>(a) + 1);
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* a,
                                      float (&x)[kVec]) {
  uint4 u = __ldcs(reinterpret_cast<const uint4*>(a));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* a, const float (&x)[kVec]) {
  __stcs(reinterpret_cast<float4*>(a), make_float4(x[0], x[1], x[2], x[3]));
  __stcs(reinterpret_cast<float4*>(a) + 1,
         make_float4(x[4], x[5], x[6], x[7]));
}
__device__ __forceinline__ void store8(__nv_bfloat16* a,
                                       const float (&x)[kVec]) {
  uint4 u;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < kVec; ++j) h[j] = __float2bfloat16_rn(x[j]);
  __stcs(reinterpret_cast<uint4*>(a), u);
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
    update_kernel(const Row* __restrict__ rows,
                  const Chunk* __restrict__ chunks,
                  const float* __restrict__ scale_p,
                  const float* __restrict__ lr_p,
                  const float* __restrict__ bc1_p,
                  const float* __restrict__ bc2_p, Consts k) {
  const Chunk c = chunks[blockIdx.x];
  const Row r = rows[c.row];
  float* __restrict__ p = reinterpret_cast<float*>(r.p) + c.offset;
  const float* __restrict__ g = reinterpret_cast<const float*>(r.g) + c.offset;
  S* __restrict__ m = reinterpret_cast<S*>(r.m) + c.offset;
  S* __restrict__ v = reinterpret_cast<S*>(r.v) + c.offset;
  const float scale = *scale_p, lr = *lr_p, bc1 = *bc1_p, bc2 = *bc2_p;
  const bool decay = r.decay != 0;
  long long head = 0;
  if (aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v)) {
    const long long n8 = c.length / kVec;
    for (long long i = threadIdx.x; i < n8; i += kThreads) {
      float pp[kVec], gg[kVec], mm[kVec], vv[kVec];
      load8(p + kVec * i, pp);
      load8(g + kVec * i, gg);
      load8(m + kVec * i, mm);
      load8(v + kVec * i, vv);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        adamw(pp[j], gg[j], mm[j], vv[j], k, scale, lr, bc1, bc2, decay);
      store8(p + kVec * i, pp);
      store8(m + kVec * i, mm);
      store8(v + kVec * i, vv);
    }
    head = kVec * n8;
  }
  for (long long i = head + threadIdx.x; i < c.length; i += kThreads) {
    float pp = load1(p + i), mm = load1(m + i), vv = load1(v + i);
    adamw(pp, load1(g + i), mm, vv, k, scale, lr, bc1, bc2, decay);
    store1(p + i, pp);
    store1(m + i, mm);
    store1(v + i, vv);
  }
}

bool bad_grid(long long nchunks) {
  return nchunks <= 0 || nchunks > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// The float32 sum of squares of every tensor of `rows` (each divided by its
// replica count) into out[0]. partials: nchunks floats of scratch; done: one
// int, 0 before the launch and left 0 after it.
int adamw_sumsq(const void* rows, const void* chunks, long long nchunks,
                void* partials, void* done, void* out, void* stream) {
  if (bad_grid(nchunks)) return cudaErrorInvalidValue;
  sumsq_kernel<<<unsigned(nchunks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Row*>(rows), static_cast<const Chunk*>(chunks),
      nchunks, static_cast<float*>(partials), static_cast<int*>(done),
      static_cast<float*>(out));
  return cudaGetLastError();
}

// One AdamW step over every tensor of `rows`, in place. scale, lr, bc1 and
// bc2: float32 device scalars; state_dtype: 0 float32 moments, 1 bfloat16.
int adamw_update(const void* rows, const void* chunks, long long nchunks,
                 const void* scale, const void* lr, const void* bc1,
                 const void* bc2, float b1, float one_minus_b1, float b2,
                 float one_minus_b2, float eps, float weight_decay,
                 int state_dtype, void* stream) {
  if (bad_grid(nchunks)) return cudaErrorInvalidValue;
  const Consts k{b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* rw = static_cast<const Row*>(rows);
  const auto* ch = static_cast<const Chunk*>(chunks);
  const auto* sc = static_cast<const float*>(scale);
  const auto* lp = static_cast<const float*>(lr);
  const auto* b1p = static_cast<const float*>(bc1);
  const auto* b2p = static_cast<const float*>(bc2);
  if (state_dtype == 0)
    update_kernel<float><<<unsigned(nchunks), kThreads, 0, s>>>(
        rw, ch, sc, lp, b1p, b2p, k);
  else if (state_dtype == 1)
    update_kernel<__nv_bfloat16><<<unsigned(nchunks), kThreads, 0, s>>>(
        rw, ch, sc, lp, b1p, b2p, k);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // extern "C"
