// segment_bin_agg: per-(segment, cell) (count, sum, min, max), each
// segment clip-binned into gx * gy cells of its own bbox — the child
// metadata of a batched split. bin_agg (one tile's split on the
// sequential path) is the S = 1 launch of the same kernel.
//
// Replaces the TPU kernels repro/kernels/segment_agg.py
// segment_bin_agg_pallas (pallas_call at :524) and repro/kernels/
// bin_agg.py bin_agg_pallas (pallas_call at :89), which unroll
// group * k masked reductions because the TPU has no scatter. Here it is
// a keyed reduction, key = segment * k + cy * gx + cx (S * k <= 2048
// cells), in agg_onepass.cuh's design: one launch a call (the last block
// writes the rows and resets the workspace and the ticket), a grid of
// what is resident on the card (cut when the stream is short, so one
// tile at S = 1 still spreads over the card), block-contiguous spans
// walked in float4 loads of x, y and v, a table per warp where eight fit
// in shared memory and one for the block otherwise. A segment's objects
// spread over its cells, so lanes of a warp rarely share a key:
// - k <= SBA_REG (the main path's 2x2 split): each thread keeps the k
//   cells of its current segment in registers, spills them to its
//   table when its segment changes (rarely: a block's span is
//   contiguous) and the warp folds them by key at the end, so the walk
//   makes no atomics;
// - larger grids: each lane folds its own object into the table, as
//   the edge split (segment_bin_agg_edges.cu) does.
//
// Bound on the H100: memory. Each object is read once (x, y, v: 12
// bytes), the output is S * k * 4 doubles; each object also takes two
// float64 subtracts, two float64 divides and a float64 add. At the main
// path's rounds (<= 8 segments of ~4e5 objects, k = 4) that is ~37 MB,
// ~11 us at 3.35 TB/s. An IEEE float64 divide is no single instruction
// but a sequence of float64 ones, so the arithmetic weighs beside the
// bytes.
//
// Precision: ownership is the host's float64 rule, not the TPU kernels'
// float32 re-binning: the wrapper passes each segment's (x0, y0, cw, ch)
// as doubles computed as the host computes them, and the kernel bins
// ((double)x - x0) / cw with IEEE double subtract and divide
// (__dsub_rn, __ddiv_rn: never fast math), floor, clip — the cell ids
// numpy gives. NaN values are kept (agg_common.cuh).
#include <string.h>

#include "agg_common.cuh"
#include "agg_onepass.cuh"

// The arguments, copied from a host buffer of the same layout (the
// wrapper builds it with numpy: no padding anywhere).
struct SbaArgs {
  long long b[AGG_MAX_SEGMENTS + 1];  // segment boundaries
  double p[AGG_MAX_SEGMENTS * 4];     // per segment: x0, y0, cw, ch
  int S, gx, gy, pad;
};
static_assert(sizeof(SbaArgs) == 2584, "SbaArgs layout");

#define SBA_REG 4  // cells a thread keeps in registers when k <= SBA_REG

template <int kSink, bool kReg>
__global__ void __launch_bounds__(OP_THREADS) segment_bin_agg_one(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ v, const __grid_constant__ SbaArgs a,
    Cell* __restrict__ ws, unsigned int* __restrict__ ticket,
    double* __restrict__ out) {
  extern __shared__ __align__(16) char smem[];
  const int S = a.S, gx = a.gx, gy = a.gy, k = gx * gy, cells = S * k;
  long long* b = reinterpret_cast<long long*>(smem);
  double* par = reinterpret_cast<double*>(b + (S + 1));
  char* tables = reinterpret_cast<char*>(par + 4 * S);
  for (int s = threadIdx.x; s <= S; s += blockDim.x) b[s] = a.b[s];
  for (int q = threadIdx.x; q < 4 * S; q += blockDim.x) par[q] = a.p[q];
  tables_init(tables, kSink, cells);
  const Table t = my_table(tables, kSink, cells);
  __syncthreads();

  auto any = [](long long, float, float) { return true; };
  int seg = 0;
  auto cell_of = [&](long long i, float xi, float yi) {
    if (i < b[seg] || i >= b[seg + 1]) seg = segment_of(b, S, i);
    const double* ps = par + 4 * seg;
    const int cx =
        clip_cell(__ddiv_rn(__dsub_rn((double)xi, ps[0]), ps[2]), gx);
    const int cy =
        clip_cell(__ddiv_rn(__dsub_rn((double)yi, ps[1]), ps[3]), gy);
    return cy * gx + cx;
  };
  if constexpr (kReg) {
    // the current segment's k cells in registers; spilled to the table
    // when the thread's segment changes, folded by the warp at the end
    unsigned int cnt[SBA_REG];
    double sum[SBA_REG];
    float mn[SBA_REG], mx[SBA_REG];
    int cseg = 0;
    auto reset = [&]() {
#pragma unroll
      for (int c = 0; c < SBA_REG; ++c) {
        cnt[c] = 0u;
        sum[c] = 0.0;
        mn[c] = INFINITY;
        mx[c] = -INFINITY;
      }
    };
    reset();
    auto visit = [&](long long i, float xi, float yi, float vi, bool ok) {
      if (!ok) return;
      const int c0 = cell_of(i, xi, yi);
      if (seg != cseg) {
#pragma unroll
        for (int c = 0; c < SBA_REG; ++c)
          if (cnt[c]) cell_add(t, cseg * k + c, cnt[c], sum[c], mn[c], mx[c]);
        reset();
        cseg = seg;
      }
#pragma unroll
      for (int c = 0; c < SBA_REG; ++c) {
        if (c0 == c) {
          cnt[c] += 1u;
          sum[c] += (double)vi;
          mn[c] = min_nan(mn[c], vi);
          mx[c] = max_nan(mx[c], vi);
        }
      }
    };
    walk<true>(x, y, v, b[0], b[S], any, visit);
#pragma unroll
    for (int c = 0; c < SBA_REG; ++c) {
      Run r;
      r.key = cseg * k + c;
      r.cnt = cnt[c];
      r.sum = sum[c];
      r.mn = mn[c];
      r.mx = mx[c];
      warp_flush_runs(r, t);
    }
  } else {
    auto visit = [&](long long i, float xi, float yi, float vi, bool ok) {
      int key = -1;
      if (ok) {
        const int c0 = cell_of(i, xi, yi);  // moves seg first
        key = seg * k + c0;
      }
      warp_fold<false>(key, vi, t);
    };
    walk<true>(x, y, v, b[0], b[S], any, visit);
  }
  tables_flush(tables, kSink, cells, ws);
  if (!last_block(ticket)) return;
  rows_out(ws, out, cells);
  workspace_reset(ws, cells, ticket);
}

template <int kSink, bool kReg>
static int launch_one(const float* x, const float* y, const float* v,
                      const SbaArgs& a, size_t smem, Cell* ws,
                      unsigned int* ticket, double* out, cudaStream_t st) {
  static Occupancy occ[OP_MAX_DEVICES];
  cudaError_t err = cudaSuccess;
  const int blocks = grid_for(segment_bin_agg_one<kSink, kReg>, occ, smem,
                              a.b[a.S] - a.b[0], &err);
  if (err != cudaSuccess) return (int)err;
  segment_bin_agg_one<kSink, kReg><<<blocks, OP_THREADS, smem, st>>>(
      x, y, v, a, ws, ticket, out);
  return (int)cudaGetLastError();
}

// h_args: host SbaArgs; ws: the caller's device workspace of at least
// S * gx * gy Cells in identity state, and ticket: its device counter at
// 0 (both left so by the call); out: device float64 (S, gx * gy, 4). One
// launch on `stream`; allocates nothing; returns the launch error (0 on
// success).
extern "C" int segment_bin_agg_one_launch(const float* x, const float* y,
                                          const float* v, const void* h_args,
                                          void* ws, void* ticket,
                                          double* out, void* stream) {
  SbaArgs a;
  memcpy(&a, h_args, sizeof(SbaArgs));
  if (a.S < 1 || a.S > AGG_MAX_SEGMENTS || a.gx < 1 || a.gy < 1 ||
      a.gx > AGG_MAX_CELLS || a.gy > AGG_MAX_CELLS ||
      (long long)a.S * a.gx * a.gy > AGG_MAX_CELLS || a.b[0] < 0)
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < a.S; ++s)
    if (a.b[s + 1] < a.b[s]) return (int)cudaErrorInvalidValue;
  const int cells = a.S * a.gx * a.gy;
  const size_t head =
      (a.S + 1) * sizeof(long long) + 4 * a.S * sizeof(double);
  const int sink = sink_for(head, cells);
  const size_t smem = head + tables_bytes(sink, cells);
  Cell* c = (Cell*)ws;
  unsigned int* t = (unsigned int*)ticket;
  cudaStream_t st = (cudaStream_t)stream;
  // S * k <= 2048 cells always fit one table a block, and k <= SBA_REG
  // (S * k <= 256) a table per warp
  if (sink == SINK_WARP && a.gx * a.gy <= SBA_REG)
    return launch_one<SINK_WARP, true>(x, y, v, a, smem, c, t, out, st);
  if (sink == SINK_WARP)
    return launch_one<SINK_WARP, false>(x, y, v, a, smem, c, t, out, st);
  return launch_one<SINK_BLOCK, false>(x, y, v, a, smem, c, t, out, st);
}

extern "C" int segment_bin_agg_args_size() { return (int)sizeof(SbaArgs); }
