// One-launch keyed reductions for Hopper: the device and launch pieces
// shared by the window read (segment_window_agg.cu: one window, the
// all-covering window, a window per segment), the even split
// (segment_bin_agg.cu), the heatmap read under one window or a window
// per segment (segment_window_bin_agg.cu) and the bin-aligned split
// (segment_bin_agg_edges.cu). The tables, cells and encodings are
// agg_common.cuh's; what differs is how a call reaches the card:
//
// - One launch a call. Every block flushes its shared table into the
//   global workspace with atomics, fences and takes a ticket; the block
//   that takes the last ticket writes the float64 rows (and any epilogue),
//   then puts the workspace and the ticket back to their identity state,
//   so the next call on the same stream finds them ready. The wrapper keeps
//   one workspace per (device, stream) and initialises it once.
// - A grid that fills the card: as many blocks as are resident at once
//   (occupancy x SM count, cached per device, cut by the dynamic shared
//   memory a block takes), fewer when the stream is short, so that each
//   thread still gets OP_MIN_UNITS float4s. Each block walks one contiguous
//   span of the stream, so it meets few segments and touches few cells of
//   its table; its threads take consecutive 16-byte float4 loads of x and y
//   (and v), two in flight a thread, with a scalar head to the 16-byte
//   boundary and a scalar tail; a walk of v alone takes four in flight.
//   Planes at different offsets mod 16 take a scalar walk. Every loop is
//   warp-uniform: a lane past the end still takes part, with nothing to
//   fold.
// - Tables private to each warp where they fit in shared memory (no warp
//   contends with another's atomics), merged cell by cell at the flush.
//   On sm_90a a shared-memory float64 atomicAdd is a compare-and-swap
//   loop (ATOMS.CAST.SPIN.64 in cuobjdump -sass; the global one is native,
//   ATOMG.E.ADD.F64), so contention on a cell costs retries.
// - Warp-combined folds (the heatmap read): a warp with nothing to fold
//   skips; the lanes of a warp that share the first lane's key fold their
//   values in registers (count by __popc, float64 sums, float32 extrema)
//   and one of them does the four atomics; see warp_fold. Where keys are
//   segments (the window read), each thread keeps a run of one key in
//   registers instead and the warp folds its runs by key at the end; see
//   warp_flush_runs.
#pragma once
#include <stdint.h>

#include "agg_common.cuh"

#define OP_THREADS 256
#define OP_MIN_UNITS 2  // float4s a thread gets before the grid grows
#define OP_COMBINE 8    // lanes of one key a warp folds in registers
#define OP_MAX_DEVICES 64
#define OP_FULL 0xffffffffu

__device__ __forceinline__ void cell_add(Table t, int key, unsigned int cnt,
                                         double sum, float mn, float mx) {
  atomicAdd(&t.cnt[key], cnt);
  atomicAdd(&t.sum[key], sum);
  atomicMin(&t.mn[key], f2o_min(mn));
  atomicMax(&t.mx[key], f2o_max(mx));
}

__device__ __forceinline__ void cell_add(Cell* ws, int key, unsigned int cnt,
                                         double sum, float mn, float mx) {
  atomicAdd(&ws[key].cnt, (unsigned long long)cnt);
  atomicAdd(&ws[key].sum, sum);
  atomicMin(&ws[key].mn, f2o_min(mn));
  atomicMax(&ws[key].mx, f2o_max(mx));
}

// Fold one value per lane into `sink`, called by all 32 lanes together;
// key < 0: the lane has nothing to fold. With kCombine, a warp with
// nothing to fold skips at once, and when at least OP_COMBINE lanes share
// the key of the first lane that has one (a tile inside one bin), those
// lanes fold in registers — a butterfly of shuffles, count by __popc,
// float64 sums, NaN-propagating float32 extrema — and the first does the
// four atomics.
// Every other lane with a key does its own. (__match_any_sync would group
// every key, but on the card it costs more than the atomics it saves on
// keys that rarely repeat within a warp; the split kernel, whose keys
// spread over a segment's cells, measured faster without any combining.)
template <bool kCombine, class Sink>
__device__ __forceinline__ void warp_fold(int key, float v, Sink sink) {
  bool mine = false;
  if (kCombine) {
    const unsigned int act = __ballot_sync(OP_FULL, key >= 0);
    if (act == 0u) return;
    const int lead = __ffs(act) - 1;
    const int k0 = __shfl_sync(OP_FULL, key, lead);
    const unsigned int peers = __ballot_sync(OP_FULL, key == k0);
    if (__popc(peers) >= OP_COMBINE) {
      mine = key == k0;
      double sum = mine ? (double)v : 0.0;
      float mn = mine ? v : INFINITY, mx = mine ? v : -INFINITY;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(OP_FULL, sum, off);
        mn = min_nan(mn, __shfl_xor_sync(OP_FULL, mn, off));
        mx = max_nan(mx, __shfl_xor_sync(OP_FULL, mx, off));
      }
      if ((int)(threadIdx.x & 31u) == lead)
        cell_add(sink, k0, __popc(peers), sum, mn, mx);
    }
  }
  if (key >= 0 && !mine) cell_add(sink, key, 1u, (double)v, v, v);
}

// Every lane's run (agg_common.cuh Run) folded into `sink`, called by all
// 32 lanes together: the lanes whose runs share the key of the first lane
// with one left fold them in registers (a butterfly of shuffles) and that
// lane does the four atomics; one round a distinct key, so a warp whose
// lanes all ended in one segment makes one set of atomics.
template <class Sink>
__device__ __forceinline__ void warp_flush_runs(const Run& r, Sink sink) {
  bool left = r.cnt > 0u;
  for (;;) {
    const unsigned int act = __ballot_sync(OP_FULL, left);
    if (act == 0u) return;
    const int lead = __ffs(act) - 1;
    const int k0 = __shfl_sync(OP_FULL, r.key, lead);
    const bool mine = left && r.key == k0;
    unsigned int cnt = mine ? r.cnt : 0u;
    double sum = mine ? r.sum : 0.0;
    float mn = mine ? r.mn : INFINITY, mx = mine ? r.mx : -INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      cnt += __shfl_xor_sync(OP_FULL, cnt, off);
      sum += __shfl_xor_sync(OP_FULL, sum, off);
      mn = min_nan(mn, __shfl_xor_sync(OP_FULL, mn, off));
      mx = max_nan(mx, __shfl_xor_sync(OP_FULL, mx, off));
    }
    if ((int)(threadIdx.x & 31u) == lead)
      cell_add(sink, k0, cnt, sum, mn, mx);
    left = left && !mine;
  }
}

// The segment of object i, found by binary search only when i leaves the
// last segment found (a thread meets few segments).
struct SegCache {
  int s = 0;
  long long lo = 0, hi = -1;
  // true when the segment changed
  __device__ __forceinline__ bool at(const long long* b, int S,
                                     long long i) {
    if (i >= lo && i < hi) return false;
    s = segment_of(b, S, i);
    lo = b[s];
    hi = b[s + 1];
    return true;
  }
};

// the closed window (x0, y0, x1, y1) in float32
__device__ __forceinline__ bool in_window(const float4& w, float x,
                                          float y) {
  return x >= w.x && x <= w.z && y >= w.y && y <= w.w;
}

// This block's share [a, e) of `units` work units: contiguous, balanced.
__device__ __forceinline__ void block_span(long long units, long long& a,
                                           long long& e) {
  a = units * blockIdx.x / gridDim.x;
  e = units * (blockIdx.x + 1) / gridDim.x;
}

// visit(i, x[i], y[i], vi, ok) once for every object i of [lo, hi), from
// every thread of the grid together: a call with ok false carries nothing
// but keeps the warp whole for visit's warp-level folds. vi is v[i]: with
// kV loaded beside x and y for every object; else loaded, one scalar load
// each, only for the objects where want(i, x[i], y[i]) holds, and all of
// a thread's loads of one step issued before its first visit (so a visit
// never waits on its own value).
template <bool kV, class Want, class Visit>
__device__ __forceinline__ void walk(const float* __restrict__ x,
                                     const float* __restrict__ y,
                                     const float* __restrict__ v,
                                     long long lo, long long hi, Want& want,
                                     Visit& visit) {
  const long long n = hi - lo;
  const uintptr_t off = (uintptr_t)(x + lo) & 15u;
  const bool vec = ((uintptr_t)(y + lo) & 15u) == off &&
                   (!kV || ((uintptr_t)(v + lo) & 15u) == off);
  long long head = vec ? (long long)(((16u - off) & 15u) >> 2) : n;
  if (head > n) head = n;
  const long long nvec = (n - head) >> 2;
  long long a, e;

  // the float4 body: units u of 4 objects from lo + head, two a thread
  // in flight
  const float* vb0 = v + lo + head;
  const float4* x4 = reinterpret_cast<const float4*>(x + lo + head);
  const float4* y4 = reinterpret_cast<const float4*>(y + lo + head);
  const float4* v4 = reinterpret_cast<const float4*>(kV ? vb0 : x + lo + head);
  block_span(nvec, a, e);
  for (long long base = a; base < e; base += 2 * OP_THREADS) {
    const long long u0 = base + threadIdx.x, u1 = u0 + OP_THREADS;
    const bool ok0 = u0 < e, ok1 = u1 < e;
    float4 xa = make_float4(0.f, 0.f, 0.f, 0.f), ya = xa, va = xa, xb = xa,
           yb = xa, vb = xa;
    if (ok0) {
      xa = __ldcs(x4 + u0);
      ya = __ldcs(y4 + u0);
      if (kV) va = __ldcs(v4 + u0);
    }
    if (ok1) {
      xb = __ldcs(x4 + u1);
      yb = __ldcs(y4 + u1);
      if (kV) vb = __ldcs(v4 + u1);
    }
    const long long i0 = lo + head + 4 * u0, i1 = lo + head + 4 * u1;
    if (!kV) {
      const float* p0 = vb0 + 4 * u0;
      const float* p1 = vb0 + 4 * u1;
      if (ok0 && want(i0, xa.x, ya.x)) va.x = __ldcs(p0);
      if (ok0 && want(i0 + 1, xa.y, ya.y)) va.y = __ldcs(p0 + 1);
      if (ok0 && want(i0 + 2, xa.z, ya.z)) va.z = __ldcs(p0 + 2);
      if (ok0 && want(i0 + 3, xa.w, ya.w)) va.w = __ldcs(p0 + 3);
      if (ok1 && want(i1, xb.x, yb.x)) vb.x = __ldcs(p1);
      if (ok1 && want(i1 + 1, xb.y, yb.y)) vb.y = __ldcs(p1 + 1);
      if (ok1 && want(i1 + 2, xb.z, yb.z)) vb.z = __ldcs(p1 + 2);
      if (ok1 && want(i1 + 3, xb.w, yb.w)) vb.w = __ldcs(p1 + 3);
    }
    visit(i0, xa.x, ya.x, va.x, ok0);
    visit(i0 + 1, xa.y, ya.y, va.y, ok0);
    visit(i0 + 2, xa.z, ya.z, va.z, ok0);
    visit(i0 + 3, xa.w, ya.w, va.w, ok0);
    visit(i1, xb.x, yb.x, vb.x, ok1);
    visit(i1 + 1, xb.y, yb.y, vb.y, ok1);
    visit(i1 + 2, xb.z, yb.z, vb.z, ok1);
    visit(i1 + 3, xb.w, yb.w, vb.w, ok1);
  }

  // scalar objects: the head and the tail around the body (at most 6),
  // or every object when the planes cannot share float4 loads
  block_span(n - 4 * nvec, a, e);
  for (long long base = a; base < e; base += OP_THREADS) {
    const long long k = base + threadIdx.x;
    const bool ok = k < e;
    const long long i = k < head ? lo + k : lo + 4 * nvec + k;
    float xi = 0.f, yi = 0.f, vi = 0.f;
    if (ok) {
      xi = x[i];
      yi = y[i];
      if (kV || want(i, xi, yi)) vi = v[i];
    }
    visit(i, xi, yi, vi, ok);
  }
}

// visit(i, v[i], ok) once for every object i of [lo, hi), as walk does
// for the one plane v: float4 loads, four in flight a thread, with a
// scalar head to the 16-byte boundary and a scalar tail.
template <class Visit>
__device__ __forceinline__ void walk_plane(const float* __restrict__ v,
                                           long long lo, long long hi,
                                           Visit& visit) {
  const long long n = hi - lo;
  const uintptr_t off = (uintptr_t)(v + lo) & 15u;
  long long head = (long long)(((16u - off) & 15u) >> 2);
  if (head > n) head = n;
  const long long nvec = (n - head) >> 2;
  const float4* v4 = reinterpret_cast<const float4*>(v + lo + head);
  long long a, e;
  block_span(nvec, a, e);
  for (long long base = a; base < e; base += 4 * OP_THREADS) {
    float4 q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long u = base + threadIdx.x + k * OP_THREADS;
      q[k] = u < e ? __ldcs(v4 + u) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long u = base + threadIdx.x + k * OP_THREADS;
      const bool ok = u < e;
      const long long i = lo + head + 4 * u;
      visit(i, q[k].x, ok);
      visit(i + 1, q[k].y, ok);
      visit(i + 2, q[k].z, ok);
      visit(i + 3, q[k].w, ok);
    }
  }
  block_span(n - 4 * nvec, a, e);
  for (long long base = a; base < e; base += OP_THREADS) {
    const long long k = base + threadIdx.x;
    const bool ok = k < e;
    const long long i = k < head ? lo + k : lo + 4 * nvec + k;
    visit(i, ok ? v[i] : 0.f, ok);
  }
}

// Where a block folds: one table per warp in shared memory (no warp
// contends with another), one table for the block, or — a table too
// large for shared memory — the global workspace itself.
#define SINK_WARP 0
#define SINK_BLOCK 1
#define SINK_GLOBAL 2
#define OP_WARPS (OP_THREADS / 32)

__host__ __device__ __forceinline__ size_t table_stride(int cells) {
  return (table_bytes(cells) + 15) & ~(size_t)15;
}

// dynamic shared memory the block's tables take
__host__ __device__ __forceinline__ size_t tables_bytes(int sink,
                                                        int cells) {
  return sink == SINK_WARP    ? OP_WARPS * table_stride(cells)
         : sink == SINK_BLOCK ? table_stride(cells)
                              : 0;
}

// The sink for a table of `cells` cells after `head` bytes of other
// shared memory: the most private one that fits without an opt-in (the
// last block's flag takes 16 bytes of its own).
__host__ __forceinline__ int sink_for(size_t head, int cells) {
  if (cells > AGG_MAX_CELLS) return SINK_GLOBAL;
  if (head + tables_bytes(SINK_WARP, cells) <= AGG_SMEM - 16)
    return SINK_WARP;
  if (head + tables_bytes(SINK_BLOCK, cells) <= AGG_SMEM - 16)
    return SINK_BLOCK;
  return SINK_GLOBAL;
}

// this thread's table: its warp's, or the block's
__device__ __forceinline__ Table my_table(char* tables, int sink,
                                          int cells) {
  return table_at(tables + (sink == SINK_WARP ? (threadIdx.x >> 5) : 0) *
                               table_stride(cells),
                  cells);
}

__device__ __forceinline__ void tables_init(char* tables, int sink,
                                            int cells) {
  const int n = sink == SINK_WARP ? OP_WARPS : 1;
  for (int k = 0; k < n; ++k)
    table_init(table_at(tables + k * table_stride(cells), cells), cells);
}

// every table of the block merged cell by cell into the workspace: four
// atomics a touched cell
__device__ __forceinline__ void tables_flush(char* tables, int sink,
                                             int cells, Cell* ws) {
  const int n = sink == SINK_WARP ? OP_WARPS : 1;
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    unsigned int cnt = 0u, mn = ENC_POS_INF, mx = ENC_NEG_INF;
    double sum = 0.0;
    for (int k = 0; k < n; ++k) {
      const Table t = table_at(tables + k * table_stride(cells), cells);
      cnt += t.cnt[c];
      sum += t.sum[c];
      mn = min(mn, t.mn[c]);
      mx = max(mx, t.mx[c]);
    }
    if (cnt) {
      atomicAdd(&ws[c].cnt, (unsigned long long)cnt);
      atomicAdd(&ws[c].sum, sum);
      atomicMin(&ws[c].mn, mn);
      atomicMax(&ws[c].mx, mx);
    }
  }
}

// True, in every thread, for the block that takes the last ticket; call
// once, after the block's last fold into the workspace. The barrier and
// then one thread's fence order every fold of the block before its
// ticket (a fence is cumulative), as a grid-wide barrier does; the last
// block fences again before it reads what the others folded.
__device__ __forceinline__ bool last_block(unsigned int* ticket) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  return last;
}

// The last block: (cells, 4) float64 rows count, sum, min, max (the
// workspace read past L1: other blocks wrote it with atomics)
__device__ __forceinline__ void rows_out(const Cell* ws, double* out,
                                         int cells) {
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    out[4 * c + 0] = (double)__ldcg(&ws[c].cnt);
    out[4 * c + 1] = __ldcg(&ws[c].sum);
    out[4 * c + 2] = (double)o2f(__ldcg(&ws[c].mn));
    out[4 * c + 3] = (double)o2f(__ldcg(&ws[c].mx));
  }
}

// The last block, after its epilogue has read the workspace: the identity
// state again, ready for the next call on the stream
__device__ __forceinline__ void workspace_reset(Cell* ws, int cells,
                                                unsigned int* ticket) {
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    ws[c].cnt = 0ull;
    ws[c].sum = 0.0;
    ws[c].mn = ENC_POS_INF;
    ws[c].mx = ENC_NEG_INF;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

struct Occupancy {
  int per_sm;   // blocks of OP_THREADS an SM holds, without shared memory
  int sms;
  int smem_sm;  // shared memory an SM holds (bytes)
};

// Blocks for one walk of `n` objects by `kernel` with `smem` bytes of
// dynamic shared memory a block: what is resident on the card at once,
// fewer when each thread would get under OP_MIN_UNITS float4s, at least 1
// (the last block's epilogue runs even for an empty stream). `cache`
// holds one entry per device (the queries cost host time).
template <class Kernel>
static int grid_for(Kernel kernel, Occupancy* cache, size_t smem,
                    long long n, cudaError_t* err) {
  int dev = 0;
  if ((*err = cudaGetDevice(&dev)) != cudaSuccess) return 0;
  Occupancy o = {0, 0, 0};
  if (dev < OP_MAX_DEVICES && cache[dev].sms > 0) {
    o = cache[dev];
  } else {
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.per_sm, kernel,
                                                         OP_THREADS, 0);
    if (*err != cudaSuccess) return 0;
    *err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev);
    if (*err != cudaSuccess) return 0;
    *err = cudaDeviceGetAttribute(
        &o.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (*err != cudaSuccess) return 0;
    if (dev < OP_MAX_DEVICES) cache[dev] = o;
  }
  long long per_sm = o.per_sm;
  // the SM keeps 1 KB of its shared memory for each resident block
  const long long by_smem = (long long)o.smem_sm / ((long long)smem + 1024);
  if (by_smem < per_sm) per_sm = by_smem;
  if (per_sm < 1) per_sm = 1;
  const long long units = (n + 3) / 4;
  long long blocks = (units + (long long)OP_THREADS * OP_MIN_UNITS - 1) /
                     ((long long)OP_THREADS * OP_MIN_UNITS);
  if (blocks > per_sm * o.sms) blocks = per_sm * o.sms;
  if (blocks < 1) blocks = 1;
  return (int)blocks;
}
