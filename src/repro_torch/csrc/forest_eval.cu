// Packed-forest traversal and tree mean for Hopper (sm_90a), with a plain C
// interface loaded through ctypes by repro_torch/kernels/forest_eval.py.
//
// Replaces the two Pallas kernels of src/repro/kernels/forest_eval.py:
//   - leaf_values_grouped_pallas (:217, kernel body :273): a stack of G
//     forests, every row routed through its own group's forest;
//   - leaf_values_pallas (:158, kernel body :179): one forest. Here it is
//     the same device function with G = 1 and every row in group 0. The two
//     TPU kernels differ only in how scalar prefetch steers their blocks.
// and the host-side tree mean of the same file (tree_mean, :38).
//
// What bounds it on the card. One thread owns one (tree, row) pair and
// walks up to depth (17-21 at the paper grid) levels. Each level is a chain
// of dependent loads: feat[node] -> x[row, feat] and thr/left/right[node]
// -> the next node. The whole paper-grid bank, (G, T, N) = (12, 60, 461),
// is 9.3 MB and stays resident in the 50 MB L2, so the kernel is bound by
// L2 load latency along ~19 dependent gathers per thread, not by HBM bytes
// or by arithmetic (one float64 compare per level).
//
// What the simple design does about it. Nothing clever: enough independent
// (tree, row) threads are in flight to hide part of that latency (60 trees x
// a wave's rows = thousands of threads), loads go through the read-only
// path (__ldg), and a thread stops at its leaf instead of spinning to the
// depth bound. Sorting rows by group, tiling trees into shared memory and
// one warp per tree are later work.
//
// Numbers. Routing compares in float64, so the kernel is bitwise equal to
// repro's production traversal (leaf_values_grouped_numpy, :95); Pallas
// used float32 only because the TPU lacks float64. Flat offsets are int64.
// The tree mean sums trees t = 0..T-1 in order in float64 and divides by T,
// the same operations in the same order as tree_mean, so it too is bitwise.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() of its launch.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;

// Route one row through one tree for at most `dep` levels; returns the
// leaf's value. A node with feat < 0 is a leaf: it stays put, so the walk
// may stop there.
__device__ __forceinline__ double route(
    const double* __restrict__ x, const int32_t* __restrict__ feat,
    const double* __restrict__ thr, const int32_t* __restrict__ left,
    const int32_t* __restrict__ right, const double* __restrict__ value,
    int64_t base, int64_t dep) {
  int32_t nid = 0;
  for (int64_t s = 0; s < dep; ++s) {
    const int32_t f = __ldg(feat + base + nid);
    if (f < 0) break;
    const double th = __ldg(thr + base + nid);
    nid = (__ldg(x + f) <= th) ? __ldg(left + base + nid)
                               : __ldg(right + base + nid);
  }
  return __ldg(value + base + nid);
}

// One thread per (tree t, row r), t-major so that the writes of
// leaves[t, r] by neighbouring threads are contiguous. A row whose group id
// lies outside [0, G) reads no forest and gets NaN: the range is checked
// here rather than on the host, which would sync every wave.
__global__ void leaves_grouped_kernel(
    const double* __restrict__ X, const int64_t* __restrict__ gid,
    const int32_t* __restrict__ feat, const double* __restrict__ thr,
    const int32_t* __restrict__ left, const int32_t* __restrict__ right,
    const double* __restrict__ value, const int64_t* __restrict__ depth,
    int64_t G, int64_t m, int64_t D, int64_t T, int64_t N,
    double* __restrict__ leaves) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= T * m) return;
  const int64_t t = i / m;
  const int64_t r = i - t * m;
  const int64_t g = __ldg(gid + r);
  if (g < 0 || g >= G) {
    leaves[i] = CUDART_NAN;
    return;
  }
  leaves[i] = route(X + r * D, feat, thr, left, right, value,
                    (g * T + t) * N, __ldg(depth + g));
}

__global__ void leaves_single_kernel(
    const double* __restrict__ X, const int32_t* __restrict__ feat,
    const double* __restrict__ thr, const int32_t* __restrict__ left,
    const int32_t* __restrict__ right, const double* __restrict__ value,
    int64_t dep, int64_t m, int64_t D, int64_t T, int64_t N,
    double* __restrict__ leaves) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= T * m) return;
  const int64_t t = i / m;
  const int64_t r = i - t * m;
  leaves[i] = route(X + r * D, feat, thr, left, right, value, t * N, dep);
}

// One thread per row: sum the T leaf values in tree order, then divide.
__global__ void tree_mean_kernel(const double* __restrict__ leaves,
                                 int64_t T, int64_t m,
                                 double* __restrict__ out) {
  const int64_t r = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= m) return;
  double acc = 0.0;
  for (int64_t t = 0; t < T; ++t) acc += leaves[t * m + r];
  out[r] = acc / double(T);
}

unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int forest_leaves_grouped(const void* X, const void* gid, const void* feat,
                          const void* thr, const void* left,
                          const void* right, const void* value,
                          const void* depth, long long G, long long m,
                          long long D, long long T, long long N,
                          void* leaves, void* stream) {
  leaves_grouped_kernel<<<blocks_for(T * m), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(X), static_cast<const int64_t*>(gid),
      static_cast<const int32_t*>(feat), static_cast<const double*>(thr),
      static_cast<const int32_t*>(left), static_cast<const int32_t*>(right),
      static_cast<const double*>(value), static_cast<const int64_t*>(depth),
      G, m, D, T, N, static_cast<double*>(leaves));
  return static_cast<int>(cudaGetLastError());
}

int forest_leaves(const void* X, const void* feat, const void* thr,
                  const void* left, const void* right, const void* value,
                  long long depth, long long m, long long D, long long T,
                  long long N, void* leaves, void* stream) {
  leaves_single_kernel<<<blocks_for(T * m), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(X), static_cast<const int32_t*>(feat),
      static_cast<const double*>(thr), static_cast<const int32_t*>(left),
      static_cast<const int32_t*>(right), static_cast<const double*>(value),
      depth, m, D, T, N, static_cast<double*>(leaves));
  return static_cast<int>(cudaGetLastError());
}

int forest_tree_mean(const void* leaves, long long T, long long m, void* out,
                     void* stream) {
  tree_mean_kernel<<<blocks_for(m), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(leaves), T, m, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
