// window_agg: (count, sum, min, max) of the values of the first n objects
// inside one closed window — a whole stream reduced to one row. With no
// value plane (v null) it counts, reading x and y only, and gives the row
// of an all-zero value plane.
//
// Replaces the TPU kernel repro/kernels/window_agg.py window_agg_pallas
// (pallas_call at :77), which streams (256, 128) blocks of x, y, v and an
// int8 validity plane and writes one float32 partial per grid step for a
// later jnp reduction. Here the logical length n replaces both the
// (R, 128) packing and the validity plane; the count is a 64-bit integer
// and the sum a double.
//
// Bound on the H100: bytes. Every object's x and y and the v of the n_in
// objects inside the window must be read once, 8 n + 4 n_in bytes (8 n
// for a count) over 3.35 TB/s: 0.239 to 0.358 ms for the paper's 10^8
// objects, by how much of them the window holds. This kernel reads every
// v (12 n bytes), which is all of the bound only when the window holds
// everything. The work per object is four compares and one double add,
// far under the card's rates. What the design does about it:
// - the grid is sized from the SM count (as many 256-thread blocks as fit
//   on every SM at once), never from n beyond what n needs, and each
//   thread walks the stream grid-stride in 16-byte float4 loads of x, y
//   and v (streaming loads, evict-first): each warp reads whole 512-byte
//   runs and every SM keeps tens of kilobytes in flight;
// - each thread folds into registers, then warp shuffles, then one
//   shared-memory step per block write one 24-byte partial per block;
// - a second, one-block launch folds the partials in a fixed order, so
//   the double sum is the same from run to run (no atomics);
// - the planes share their offset mod 16 (the wrapper raises otherwise):
//   a scalar head up to the 16-byte boundary, the float4 body and a
//   scalar tail.
//
// Precision: the window is the float32 window (the wrapper rounds it),
// compared with float32 coordinates; extrema NaN-propagating (a NaN value
// counts and makes the sum, min and max NaN, as numpy's do; +-0 compare
// equal); an empty selection, n = 0 included, is (0, 0, +inf, -inf).
#include "agg_common.cuh"

#define WA_THREADS 256
#define WA_WARPS (WA_THREADS / 32)
#define WA_MAX_DEVICES 64

struct Partial {
  unsigned long long cnt;
  double sum;
  float mn;
  float mx;
};

__device__ __forceinline__ void acc_init(Partial& a) {
  a.cnt = 0ull;
  a.sum = 0.0;
  a.mn = INFINITY;
  a.mx = -INFINITY;
}

__device__ __forceinline__ void acc_merge(Partial& a, const Partial& b) {
  a.cnt += b.cnt;
  a.sum += b.sum;
  a.mn = min_nan(a.mn, b.mn);
  a.mx = max_nan(a.mx, b.mx);
}

template <bool kVals>
__device__ __forceinline__ void acc_add(Partial& a, float x, float y,
                                        float v, const float4& w) {
  if (x >= w.x && x <= w.z && y >= w.y && y <= w.w) {
    a.cnt += 1ull;
    if (kVals) {
      a.sum += (double)v;
      a.mn = min_nan(a.mn, v);
      a.mx = max_nan(a.mx, v);
    }
  }
}

// the block's fold of every thread's partial, in a fixed order; the
// result is valid in thread 0
__device__ __forceinline__ Partial block_reduce(Partial a) {
  __shared__ Partial warp[WA_WARPS];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Partial b;
    b.cnt = __shfl_down_sync(0xffffffffu, a.cnt, off);
    b.sum = __shfl_down_sync(0xffffffffu, a.sum, off);
    b.mn = __shfl_down_sync(0xffffffffu, a.mn, off);
    b.mx = __shfl_down_sync(0xffffffffu, a.mx, off);
    acc_merge(a, b);
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) warp[wid] = a;
  __syncthreads();
  if (wid == 0) {
    if (lane < WA_WARPS) a = warp[lane]; else acc_init(a);
#pragma unroll
    for (int off = WA_WARPS / 2; off > 0; off >>= 1) {
      Partial b;
      b.cnt = __shfl_down_sync(0xffffffffu, a.cnt, off);
      b.sum = __shfl_down_sync(0xffffffffu, a.sum, off);
      b.mn = __shfl_down_sync(0xffffffffu, a.mn, off);
      b.mx = __shfl_down_sync(0xffffffffu, a.mx, off);
      acc_merge(a, b);
    }
  }
  return a;
}

// One partial per block. The planes share their offset mod 16 and the
// first `head` (< 4) objects precede the 16-byte boundary.
template <bool kVals>
__global__ void __launch_bounds__(WA_THREADS) window_agg_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ v, long long n, long long head, float4 w,
    Partial* __restrict__ part) {
  Partial a;
  acc_init(a);
  const long long tid = (long long)blockIdx.x * WA_THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * WA_THREADS;
  if (tid < head) acc_add<kVals>(a, x[tid], y[tid], kVals ? v[tid] : 0.f, w);
  const long long nvec = (n - head) >> 2;
  const float4* x4 = reinterpret_cast<const float4*>(x + head);
  const float4* y4 = reinterpret_cast<const float4*>(y + head);
  const float4* v4 = reinterpret_cast<const float4*>(kVals ? v + head
                                                           : x + head);
  for (long long i = tid; i < nvec; i += stride) {
    const float4 xv = __ldcs(x4 + i);
    const float4 yv = __ldcs(y4 + i);
    float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (kVals) vv = __ldcs(v4 + i);
    acc_add<kVals>(a, xv.x, yv.x, vv.x, w);
    acc_add<kVals>(a, xv.y, yv.y, vv.y, w);
    acc_add<kVals>(a, xv.z, yv.z, vv.z, w);
    acc_add<kVals>(a, xv.w, yv.w, vv.w, w);
  }
  const long long t = head + (nvec << 2) + tid;
  if (t < n) acc_add<kVals>(a, x[t], y[t], kVals ? v[t] : 0.f, w);
  a = block_reduce(a);
  if (threadIdx.x == 0) part[blockIdx.x] = a;
}

// The partials folded in a fixed order into the float64 row.
template <bool kVals>
__global__ void __launch_bounds__(WA_THREADS) window_agg_final(
    const Partial* __restrict__ part, int nparts, double* __restrict__ out) {
  Partial a;
  acc_init(a);
  for (int i = threadIdx.x; i < nparts; i += WA_THREADS) acc_merge(a, part[i]);
  a = block_reduce(a);
  if (threadIdx.x == 0) {
    out[0] = (double)a.cnt;
    if (kVals) {
      out[1] = a.sum;
      out[2] = (double)a.mn;
      out[3] = (double)a.mx;
    } else {  // the row of an all-zero value plane
      out[1] = 0.0;
      out[2] = a.cnt ? 0.0 : (double)INFINITY;
      out[3] = a.cnt ? 0.0 : -(double)INFINITY;
    }
  }
}

// Blocks of `kernel` resident on the whole card at once, per device
// (computed once: the occupancy query and the SM count cost host time).
template <bool kVals>
static int resident_blocks(int dev, cudaError_t* err) {
  static int cache[WA_MAX_DEVICES];
  if (dev < WA_MAX_DEVICES && cache[dev] > 0) return cache[dev];
  int per_sm = 0, sms = 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, window_agg_kernel<kVals>, WA_THREADS, 0);
  if (*err != cudaSuccess) return 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return 0;
  const int blocks = per_sm * sms > 0 ? per_sm * sms : 1;
  if (dev < WA_MAX_DEVICES) cache[dev] = blocks;
  return blocks;
}

template <bool kVals>
static int launch(const float* x, const float* y, const float* v,
                  long long n, long long head, float4 w, Partial* part,
                  int max_parts, double* out, cudaStream_t st) {
  cudaError_t err = cudaSuccess;
  int nparts = 0;
  if (n > 0) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    long long blocks = resident_blocks<kVals>(dev, &err);
    if (err != cudaSuccess) return (int)err;
    // no more blocks than n needs (4 objects a thread), nor than the
    // scratch holds
    const long long need = (n + 4LL * WA_THREADS - 1) / (4LL * WA_THREADS);
    if (blocks > need) blocks = need;
    if (blocks > max_parts) blocks = max_parts;
    nparts = (int)blocks;
    window_agg_kernel<kVals><<<nparts, WA_THREADS, 0, st>>>(
        x, y, v, n, head, w, part);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  window_agg_final<kVals><<<1, WA_THREADS, 0, st>>>(part, nparts, out);
  return (int)cudaGetLastError();
}

// x, y (and v, or null to count only): device float32 planes of at least
// n objects that share their address mod 16; the window x0, y0, x1, y1 in float32; scratch: device memory
// for max_parts 24-byte partials (8-byte aligned); out: device float64
// (4,). Launches on `stream`, allocates nothing, returns the first launch
// error (0 on success).
extern "C" int window_agg_launch(const float* x, const float* y,
                                 const float* v, long long n, float wx0,
                                 float wy0, float wx1, float wy1,
                                 void* scratch, int max_parts, double* out,
                                 void* stream) {
  if (n < 0 || max_parts < 1) return (int)cudaErrorInvalidValue;
  const float4 w = make_float4(wx0, wy0, wx1, wy1);
  Partial* part = (Partial*)scratch;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned long long off = (unsigned long long)x & 15ull;
  if (((unsigned long long)y & 15ull) != off ||
      (v != nullptr && ((unsigned long long)v & 15ull) != off))
    return (int)cudaErrorMisalignedAddress;
  long long head = off ? (long long)((16ull - off) >> 2) : 0;
  if (head > n) head = n;
  if (v != nullptr)
    return launch<true>(x, y, v, n, head, w, part, max_parts, out, st);
  return launch<false>(x, y, v, n, head, w, part, max_parts, out, st);
}
