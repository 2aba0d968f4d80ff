// Shared pieces of the keyed (count, sum, min, max) reductions.
//
// Every kernel of this family is a keyed reduction: each object gets a
// key = segment * k + cell and folds into a table of (count, sum, min,
// max) cells. This header holds the cells and their encodings, the
// shared-memory tables, the register runs and the binning rule;
// agg_onepass.cuh holds how a call reaches the card (one launch, the
// last block's epilogue, the workspace each stream keeps).
//
// Channels: counts are integers (exact at any size), sums float64
// (native atomicAdd(double)), extrema float32 under the sign-flipped
// unsigned ordering, so atomicMin/atomicMax on the encoding order the
// floats. An empty cell decodes to (0, 0, +inf, -inf).
//
// NaN values, as numpy's min/max treat them: a NaN object counts, its
// sum is NaN (float64 addition gives it), and its cell's min and max are
// both NaN. The folds take NaN-propagating extrema (PTX min.NaN /
// max.NaN), and the encoding puts a NaN below everything on the min
// channel (0) and above everything on the max channel (0xffffffff), so
// it wins both atomics; o2f decodes either word to NaN. No float but a
// NaN encodes to 0 or 0xffffffff.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#define AGG_MAX_SEGMENTS 64
#define AGG_MAX_CELLS 2048
#define AGG_SMEM 49152  // dynamic shared memory without an opt-in

#define ENC_POS_INF 0xff800000u
#define ENC_NEG_INF 0x007fffffu

// global workspace cell (24 bytes; the wrapper hands an int64 (cells, 3)
// tensor)
struct Cell {
  unsigned long long cnt;
  double sum;
  unsigned int mn;
  unsigned int mx;
};

__device__ __forceinline__ unsigned int f2o(float f) {
  unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float o2f(unsigned int o) {
  unsigned int u = (o & 0x80000000u) ? (o & 0x7fffffffu) : ~o;
  return __uint_as_float(u);
}

// the min and max channels' encodings: f2o, a NaN at the channel's end
__device__ __forceinline__ unsigned int f2o_min(float f) {
  return isnan(f) ? 0u : f2o(f);
}

__device__ __forceinline__ unsigned int f2o_max(float f) {
  return isnan(f) ? 0xffffffffu : f2o(f);
}

// NaN-propagating extrema: NaN if either operand is (fminf/fmaxf, which
// compile to min.f32/max.f32, return the other operand); otherwise the
// same instruction, so -0 and +0 keep the order they had
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// last s in [0, S) with b[s] <= i, for b[0] <= i < b[S] (empty segments
// share a boundary and are skipped)
__device__ __forceinline__ int segment_of(const long long* b, int S,
                                          long long i) {
  int lo = 0, hi = S;
  while (hi - lo > 1) {
    int mid = (lo + hi) >> 1;
    if (b[mid] <= i) lo = mid; else hi = mid;
  }
  return lo;
}

// block-private table in dynamic shared memory
struct Table {
  double* sum;
  unsigned int* cnt;
  unsigned int* mn;
  unsigned int* mx;
};

__device__ __forceinline__ Table table_at(char* smem, int cells) {
  Table t;
  t.sum = reinterpret_cast<double*>(smem);
  t.cnt = reinterpret_cast<unsigned int*>(t.sum + cells);
  t.mn = t.cnt + cells;
  t.mx = t.mn + cells;
  return t;
}

__host__ __device__ __forceinline__ size_t table_bytes(int cells) {
  return (size_t)cells * (sizeof(double) + 3 * sizeof(unsigned int));
}

__device__ __forceinline__ void table_init(Table t, int cells) {
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    t.sum[c] = 0.0;
    t.cnt[c] = 0u;
    t.mn[c] = ENC_POS_INF;
    t.mx[c] = ENC_NEG_INF;
  }
}

// one thread's run of consecutive same-key objects, kept in registers:
// a block's span meets few segments, so most folds touch no shared
// memory at all
struct Run {
  int key;
  unsigned int cnt;
  double sum;
  float mn, mx;
};

__device__ __forceinline__ void run_reset(Run& r, int key) {
  r.key = key;
  r.cnt = 0u;
  r.sum = 0.0;
  r.mn = INFINITY;
  r.mx = -INFINITY;
}

// a run lands in a shared table when its key changes
__device__ __forceinline__ void run_flush(Run& r, Table t) {
  if (r.cnt) {
    atomicAdd(&t.cnt[r.key], r.cnt);
    atomicAdd(&t.sum[r.key], r.sum);
    atomicMin(&t.mn[r.key], f2o_min(r.mn));
    atomicMax(&t.mx[r.key], f2o_max(r.mx));
  }
}

__device__ __forceinline__ void run_add(Run& r, int key, float v, Table t) {
  if (key != r.key) {
    run_flush(r, t);
    run_reset(r, key);
  }
  r.cnt += 1u;
  r.sum += (double)v;
  r.mn = min_nan(r.mn, v);
  r.mx = max_nan(r.mx, v);
}

// numpy's clip(floor(q).astype(int64), 0, g - 1): an out-of-range
// float -> int64 cast yields INT64_MIN there, which the clip sends to 0
__device__ __forceinline__ int clip_cell(double q, int g) {
  double f = floor(q);
  if (!(f >= -9.2233720368547758e18 && f < 9.2233720368547758e18)) return 0;
  long long c = (long long)f;
  return c < 0 ? 0 : (c > g - 1 ? g - 1 : (int)c);
}

extern "C" const char* agg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
