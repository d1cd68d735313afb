// Packed-forest traversal and tree mean for Hopper (sm_90a), with a plain C
// interface loaded through ctypes by repro_torch/kernels/forest_eval.py.
//
// Replaces the two Pallas kernels of src/repro/kernels/forest_eval.py:
//   - leaf_values_grouped_pallas (:217, kernel body :273): a stack of G
//     forests, every row routed through its own group's forest;
//   - leaf_values_pallas (:158, kernel body :179): one forest. Here it is
//     the same device code with G = 1 and every row in group 0. The two
//     TPU kernels differ only in how scalar prefetch steers their blocks.
// and the host-side tree mean of the same file (tree_mean, :38).
//
// What bounds it on the card. A walk is a chain of dependent loads, one
// level after another: feat[node] -> x[row, feat] and thr[node] -> the
// child -> the next level, up to depth (17-21 at the paper grid) levels.
// Out of L2 each link costs ~250-300 cycles, so one walk takes 6-9 us
// whatever else runs; the bytes (0.16 us at the HBM rate for a 76-row
// wave) and the float64 compares do not matter. Only a shorter link helps,
// and the staging that buys it must not cost more than it saves.
//
// The shared route (leaves_tile_kernel, the one the serving path takes):
//   - Grid (T, G, ceil(m / R)): block (t, g, s) routes the rows of tile s
//     (R = 128 min(G, 16) consecutive rows in row order) that belong to
//     group g through tree t of group g.
//   - Selection. The block reads its tile's gids (kUnroll loads in flight
//     a thread) and compacts the rows of group g into a list in shared
//     memory with a warp ballot and one shared atomic per warp: no host
//     sort and no extra launch. The list's order varies from run to run;
//     the leaves do not, since each row's walk is its own. The blocks of
//     group 0 also write NaN for their tile's rows whose gid lies outside
//     [0, G), which no block routes.
//   - Staging, with cp.async: the tree's four walk fields (feat, thr,
//     left, right; structure of arrays as the bank stores them) go out
//     right after the first gids, so they land during the compaction; the
//     selected rows of X, as one flat range of values, after it; the leaf
//     values last, in their own group, which the walks do not wait for.
//     The copies are 4 and 8 bytes: a tree starts at (g T + t) N elements
//     and N is odd, so 16-byte alignment is not given (16-byte copies of
//     the same bytes were no faster on the card). A block whose list is
//     empty routes nothing: it lets its tree's copies land and exits.
//     That one tree is what a group absent from the wave reads; waiting
//     for the compaction before starting it would put a gid round trip on
//     every block's path instead.
//   - Walk. One thread routes one selected row from shared memory,
//     comparing x <= thr in float64 for at most depth[g] levels and
//     stopping at a leaf. It loads a node's four fields at once, so a
//     level waits on two shared-memory loads (the node, then x[f]) of ~30
//     cycles each instead of two to three L2 round trips.
//   - Batches of B <= 128 rows (one per thread); a block with more
//     selected rows stages the next batch into the same buffer, under the
//     tree it already holds.
//   - Shared memory: 28 N + 8 B D + 4 min(R, m) + 4 bytes
//     (forest_eval.smem_bytes; 21.7 KB for the paper grid's serving wave),
//     above 48 KB after an opt-in. __launch_bounds__ asks for at least 7
//     blocks an SM (at most 72 registers a thread; ptxas gives 48 grouped
//     and 40 single-forest, no spills), so that the 720 blocks of a
//     serving wave over the paper grid stay resident at once.
//   - Every block stages its tree and its rows anew, so the route pays
//     only while its grid fits the card in one round; forest_eval.py
//     takes it only then (forest_tile_blocks_per_sm reads the occupancy)
//     and sends larger waves to the global route.
//
// The global route (leaves_grouped_kernel, leaves_single_kernel), for a
// tree too large for a block's shared memory or a wave too large for one
// round of the shared route's blocks, is the design before this one: one
// thread per (tree, row) walking out of L2 through the read-only path,
// which keeps every SM busy on a large wave. forest_eval.py chooses
// between the two by shape alone.
//
// Numbers. Routing compares in float64, so both routes are bitwise equal
// to repro's production traversal (leaf_values_grouped_numpy, :95); Pallas
// used float32 only because the TPU lacks float64. Flat offsets are int64.
// The tree mean sums trees t = 0..T-1 in order in float64 and divides by T,
// the same operations in the same order as tree_mean, so it too is bitwise.
//
// Every entry point but forest_tile_blocks_per_sm launches on the caller's
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() of its launch.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "tile_mma.cuh"

namespace {

constexpr int kThreads = 256;      // global route and tree mean
constexpr int kTileThreads = 128;  // shared route: the most rows a batch holds
constexpr int kTileBlocks = 7;     // shared route: fewest blocks an SM holds
constexpr int kUnroll = 4;         // gid loads in flight per thread

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

// Global route. One thread per (tree t, row r), t-major so that the
// writes of leaves[t, r] by neighbouring threads are contiguous. A row
// whose group id lies outside [0, G) reads no forest and gets NaN: the
// range is checked here rather than on the host, which would sync every
// wave.
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

// Shared route: block (t, g, s) routes the rows of tile s (rows s R ..
// s R + R - 1) that belong to group g through tree t of group g, batch by
// batch, from shared memory. kGrouped = false is the single forest: no
// gid, every row of the tile selected, the depth bound `dep1`. B rows of D
// per batch. Shared memory, 8-byte arrays first: thr[N], value[N],
// x[B][D], then feat[N], left[N], right[N], list[min(R, m)], count.
template <bool kGrouped>
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
    leaves_tile_kernel(
        const double* __restrict__ X, const int64_t* __restrict__ gid,
        const int32_t* __restrict__ feat, const double* __restrict__ thr,
        const int32_t* __restrict__ left, const int32_t* __restrict__ right,
        const double* __restrict__ value, const int64_t* __restrict__ depth,
        int64_t dep1, int64_t G, int64_t m, int64_t D, int64_t T, int64_t N,
        int64_t R, int B, double* __restrict__ leaves) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* s_thr = reinterpret_cast<double*>(smem);
  double* s_value = s_thr + N;
  double* s_x = s_value + N;
  int32_t* s_feat = reinterpret_cast<int32_t*>(s_x + int64_t(B) * D);
  int32_t* s_left = s_feat + N;
  int32_t* s_right = s_left + N;
  int32_t* s_list = s_right + N;
  int* s_count = s_list + (m < R ? m : R);

  const int64_t t = blockIdx.x;
  const int64_t g = blockIdx.y;
  const int64_t row0 = int64_t(blockIdx.z) * R;
  const int rows = static_cast<int>(m - row0 < R ? m - row0 : R);
  const int tid = threadIdx.x;
  const int64_t base = (g * T + t) * N;
  double* out = leaves + t * m + row0;

  // kUnroll gids a thread in flight; the first ones go out before the
  // tree's copies, which are then in flight during the compaction
  const auto gid_at = [&](int i) -> int64_t {
    return i < rows ? __ldg(gid + row0 + i) : 0;
  };
  int64_t v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    v[u] = kGrouped ? gid_at(u * kTileThreads + tid) : 0;
  // the four fields a walk reads; the leaf values, which only its end
  // reads, go out later in a group of their own
  for (int64_t k = tid; k < N; k += kTileThreads) {
    tile_mma::cp_async_small<4>(s_feat + k, feat + base + k);
    tile_mma::cp_async_small<8>(s_thr + k, thr + base + k);
    tile_mma::cp_async_small<4>(s_left + k, left + base + k);
    tile_mma::cp_async_small<4>(s_right + k, right + base + k);
  }
  tile_mma::cp_async_commit();

  int n = rows;
  if (kGrouped) {
    const int lane = tid & 31;
    if (tid == 0) *s_count = 0;
    __syncthreads();
    // every thread runs the same trips, so the ballots see full warps
    for (int j0 = 0; j0 < rows; j0 += kTileThreads * kUnroll) {
      if (j0 > 0) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          v[u] = gid_at(j0 + u * kTileThreads + tid);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i0 = j0 + u * kTileThreads;
        if (i0 < rows) {  // uniform
          const int i = i0 + tid;
          const bool in = i < rows;
          const bool hit = in && v[u] == g;
          if (g == 0 && in && (v[u] < 0 || v[u] >= G)) out[i] = CUDART_NAN;
          const unsigned ball = __ballot_sync(0xffffffffu, hit);
          int at = 0;
          if (lane == 0 && ball != 0u) at = atomicAdd(s_count, __popc(ball));
          at = __shfl_sync(0xffffffffu, at, 0);
          if (hit) s_list[at + __popc(ball & ((1u << lane) - 1u))] = i;
        }
      }
    }
    __syncthreads();
    n = *s_count;
    if (n == 0) {  // uniform: nothing to route; let the tree's copies land
      tile_mma::cp_async_wait<0>();
      return;
    }
  }

  const int dep = static_cast<int>(kGrouped ? __ldg(depth + g) : dep1);
  // the batch's rows as one flat range of nb D values, neighbouring threads
  // on neighbouring values: (j, c) is value e = j D + c, stepped by
  // kTileThreads = dj D + dc without a division in the loop
  const int64_t dj = kTileThreads / D, dc = kTileThreads % D;
  for (int b0 = 0; b0 < n; b0 += B) {  // uniform
    const int nb = n - b0 < B ? n - b0 : B;
    if (kGrouped) {
      int64_t j = tid / D, c = tid % D;
      for (int64_t e = tid; e < int64_t(nb) * D; e += kTileThreads) {
        const int64_t r = row0 + s_list[b0 + j];
        tile_mma::cp_async_small<8>(s_x + e, X + r * D + c);
        j += dj;
        c += dc;
        if (c >= D) {
          c -= D;
          ++j;
        }
      }
    } else {  // the tile's rows are contiguous in X
      const double* src = X + (row0 + b0) * D;
      for (int64_t e = tid; e < int64_t(nb) * D; e += kTileThreads)
        tile_mma::cp_async_small<8>(s_x + e, src + e);
    }
    tile_mma::cp_async_commit();
    if (b0 == 0) {
      for (int64_t k = tid; k < N; k += kTileThreads)
        tile_mma::cp_async_small<8>(s_value + k, value + base + k);
      tile_mma::cp_async_commit();
      // in flight, oldest first: walk fields, rows, leaf values
      tile_mma::cp_async_wait<1>();  // the walk fields and the rows
    } else {
      tile_mma::cp_async_wait<0>();  // the rows
    }
    __syncthreads();
    const int i = tid < nb ? (kGrouped ? s_list[b0 + tid] : b0 + tid) : 0;
    const double* x = s_x + int64_t(tid) * D;
    int32_t nid = 0;
    if (tid < nb) {
      for (int s = 0; s < dep; ++s) {
        // the node's four fields at once: a level waits on two loads (the
        // node, then x[f]), not three
        const int32_t f = s_feat[nid];
        const double th = s_thr[nid];
        const int32_t l = s_left[nid];
        const int32_t rt = s_right[nid];
        if (f < 0) break;
        nid = (x[f] <= th) ? l : rt;
      }
    }
    if (b0 == 0) {
      tile_mma::cp_async_wait<0>();  // the leaf values
      __syncthreads();
    }
    if (tid < nb) out[i] = s_value[nid];
    if (b0 + B < n) __syncthreads();  // the next batch reuses s_x
  }
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

// dynamic shared memory granted to leaves_tile_kernel<kGrouped>, per device
template <bool kGrouped>
cudaError_t opt_in_tile(long long smem) {
  static int opted[64];
  return tile_mma::opt_in_smem(leaves_tile_kernel<kGrouped>,
                               static_cast<int>(smem), opted);
}

template <bool kGrouped>
int launch_tile(const void* X, const void* gid, const void* feat,
                const void* thr, const void* left, const void* right,
                const void* value, const void* depth, long long dep1,
                long long G, long long m, long long D, long long T,
                long long N, long long R, long long B, long long smem,
                void* leaves, void* stream) {
  const cudaError_t err = opt_in_tile<kGrouped>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(T), static_cast<unsigned int>(G),
                  static_cast<unsigned int>((m + R - 1) / R));
  leaves_tile_kernel<kGrouped><<<grid, kTileThreads,
                                 static_cast<size_t>(smem),
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(X), static_cast<const int64_t*>(gid),
      static_cast<const int32_t*>(feat), static_cast<const double*>(thr),
      static_cast<const int32_t*>(left), static_cast<const int32_t*>(right),
      static_cast<const double*>(value), static_cast<const int64_t*>(depth),
      dep1, G, m, D, T, N, R, static_cast<int>(B),
      static_cast<double*>(leaves));
  return static_cast<int>(cudaGetLastError());
}

template <bool kGrouped>
int tile_blocks_per_sm(long long smem, int* blocks) {
  cudaError_t err = opt_in_tile<kGrouped>(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, leaves_tile_kernel<kGrouped>, kTileThreads,
        static_cast<size_t>(smem));
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Shared route. R (rows per tile), B (rows per batch, <= 128) and smem
// (bytes) come from forest_eval.tile_plan, which checks that they fit.
int forest_leaves_grouped(const void* X, const void* gid, const void* feat,
                          const void* thr, const void* left,
                          const void* right, const void* value,
                          const void* depth, long long G, long long m,
                          long long D, long long T, long long N, long long R,
                          long long B, long long smem, void* leaves,
                          void* stream) {
  return launch_tile<true>(X, gid, feat, thr, left, right, value, depth, 0,
                           G, m, D, T, N, R, B, smem, leaves, stream);
}

int forest_leaves(const void* X, const void* feat, const void* thr,
                  const void* left, const void* right, const void* value,
                  long long depth, long long m, long long D, long long T,
                  long long N, long long R, long long B, long long smem,
                  void* leaves, void* stream) {
  return launch_tile<false>(X, nullptr, feat, thr, left, right, value,
                            nullptr, depth, 1, m, D, T, N, R, B, smem, leaves,
                            stream);
}

// Blocks of the shared route (grouped != 0: the grouped kernel) one SM
// holds at once with smem bytes of dynamic shared memory each, as the
// runtime reads the kernel's registers and shared memory.
int forest_tile_blocks_per_sm(long long grouped, long long smem,
                              int* blocks) {
  return grouped ? tile_blocks_per_sm<true>(smem, blocks)
                 : tile_blocks_per_sm<false>(smem, blocks);
}

// Global route.
int forest_leaves_grouped_global(const void* X, const void* gid,
                                 const void* feat, const void* thr,
                                 const void* left, const void* right,
                                 const void* value, const void* depth,
                                 long long G, long long m, long long D,
                                 long long T, long long N, void* leaves,
                                 void* stream) {
  leaves_grouped_kernel<<<blocks_for(T * m), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(X), static_cast<const int64_t*>(gid),
      static_cast<const int32_t*>(feat), static_cast<const double*>(thr),
      static_cast<const int32_t*>(left), static_cast<const int32_t*>(right),
      static_cast<const double*>(value), static_cast<const int64_t*>(depth),
      G, m, D, T, N, static_cast<double*>(leaves));
  return static_cast<int>(cudaGetLastError());
}

int forest_leaves_global(const void* X, const void* feat, const void* thr,
                         const void* left, const void* right,
                         const void* value, long long depth, long long m,
                         long long D, long long T, long long N, void* leaves,
                         void* stream) {
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
