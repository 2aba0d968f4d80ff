// segment_bin_agg_edges: per-(segment, cell) (count, sum, min, max), each
// segment cut along its own explicit split edges — the child metadata
// of a bin-aligned heatmap split (batched and sequential alike).
//
// Replaces the TPU kernel repro/kernels/segment_agg.py
// segment_bin_agg_edges_pallas (pallas_call at :448), which unrolls
// group * k masked reductions because the TPU has no scatter. Here it is
// a keyed reduction: key = segment * k + cy * gx + cx with
// cx = sum_i [(double)x >= x_edge[s][i]] over the interior edges, a
// block-private table in shared memory, one atomic flush per block (a
// table of more than AGG_MAX_CELLS cells, or of edges and cells past the
// shared memory a block takes without an opt-in, folds straight into the
// global workspace).
//
// Bound on the H100: memory. Each object is read once (x, y, v: 12
// bytes) and compared with at most (gx - 1) + (gy - 1) edges held in
// shared memory; the output is S * k * 4 doubles. At the heatmap path's
// rounds (<= 8 segments of ~4e5 objects, up to 4 x 4 cells) that is
// ~37 MB, ~11 us at 3.35 TB/s. The design is agg_onepass.cuh's: one
// launch a call (the last block writes the rows and resets the
// workspace), a grid of what is resident on the card, block-contiguous
// spans walked in float4 loads of x, y and v, a table per warp in shared
// memory where it fits. Each lane folds its own object (a block's span
// mostly lies in one segment, whose objects spread over its cells: lanes
// rarely share a key, and combining them measured slower on the card).
// The edges and the boundaries travel by value in the
// kernel's parameters (no host-to-device copy a call): at most
// EDGE_CAP interior edges, 32 760 bytes of parameters with the
// boundaries and the six pointers, under the 32 764 bytes a launch
// takes.
//
// Precision: ownership is the host's rule (repro/kernels/ref.py
// edge_cell_ids_np): the float32 coordinate widened to double against
// float64 edges. The Pallas kernel rounds the edges to float32 instead
// (repro/kernels/ops.py:320), which can put an object lying between
// f32(edge) and edge in another child than the host's reorganization.
#include <string.h>

#include "agg_common.cuh"
#include "agg_onepass.cuh"

// The boundaries and the grid, copied from the front of a host buffer of
// the same layout (the wrapper builds it with numpy: no padding); the
// buffer's ne interior edges follow it.
struct EdgeHead {
  long long b[AGG_MAX_SEGMENTS + 1];
  int S, gx, gy, ne;  // ne = S * ((gx - 1) + (gy - 1))
};
static_assert(sizeof(EdgeHead) == 536, "EdgeHead layout");

#define EDGE_CAP 4022  // 32 760 bytes of parameters, the pointers included

// e: S * (gx - 1) interior x edges (segment-major), then S * (gy - 1)
// interior y edges, float64
struct EdgeArgs {
  EdgeHead h;
  double e[EDGE_CAP];
};
// the kernel's six pointers take 48 bytes of parameters beside EdgeArgs
static_assert(sizeof(EdgeArgs) + 48 <= 32764, "EDGE_CAP");

template <int kSink>
__global__ void __launch_bounds__(OP_THREADS) segment_bin_agg_edges_one(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ v, const __grid_constant__ EdgeArgs a,
    Cell* __restrict__ ws, unsigned int* __restrict__ ticket,
    double* __restrict__ out) {
  extern __shared__ __align__(16) char smem[];
  const int S = a.h.S, gx = a.h.gx, k = gx * a.h.gy, cells = S * k;
  const int nx = gx - 1, ny = a.h.gy - 1;
  long long* b = reinterpret_cast<long long*>(smem);
  double* ex = reinterpret_cast<double*>(b + (S + 1));
  double* ey = ex + S * nx;
  char* tables = reinterpret_cast<char*>(ey + S * ny);
  for (int s = threadIdx.x; s <= S; s += blockDim.x) b[s] = a.h.b[s];
  for (int e = threadIdx.x; e < a.h.ne; e += blockDim.x) ex[e] = a.e[e];
  if (kSink != SINK_GLOBAL) tables_init(tables, kSink, cells);
  const Table t = my_table(tables, kSink, cells);
  __syncthreads();

  auto any = [](long long, float, float) { return true; };
  int seg = 0;
  auto visit = [&](long long i, float xi, float yi, float vi, bool ok) {
    int key = -1;
    if (ok) {
      if (i < b[seg] || i >= b[seg + 1]) seg = segment_of(b, S, i);
      const double xd = (double)xi, yd = (double)yi;
      int cx = 0, cy = 0;
      for (int e = 0; e < nx; ++e) cx += xd >= ex[seg * nx + e];
      for (int e = 0; e < ny; ++e) cy += yd >= ey[seg * ny + e];
      key = seg * k + cy * gx + cx;
    }
    if (kSink == SINK_GLOBAL) warp_fold<false>(key, vi, ws);
    else warp_fold<false>(key, vi, t);
  };
  walk<true>(x, y, v, b[0], b[S], any, visit);
  if (kSink != SINK_GLOBAL) tables_flush(tables, kSink, cells, ws);
  if (!last_block(ticket)) return;
  rows_out(ws, out, cells);
  workspace_reset(ws, cells, ticket);
}

template <int kSink>
static int launch_one(const float* x, const float* y, const float* v,
                      const EdgeArgs& a, size_t smem, Cell* ws,
                      unsigned int* ticket, double* out, cudaStream_t st) {
  static Occupancy occ[OP_MAX_DEVICES];
  cudaError_t err = cudaSuccess;
  const int blocks = grid_for(segment_bin_agg_edges_one<kSink>, occ, smem,
                              a.h.b[a.h.S] - a.h.b[0], &err);
  if (err != cudaSuccess) return (int)err;
  segment_bin_agg_edges_one<kSink><<<blocks, OP_THREADS, smem, st>>>(
      x, y, v, a, ws, ticket, out);
  return (int)cudaGetLastError();
}

// h_args: host EdgeHead followed by its ne float64 interior edges (see
// EdgeArgs); ws: the caller's device workspace of at least S * gx * gy
// Cells in identity state, and ticket: its device counter at 0 (both left
// so by the call); out: device float64 (S, gx * gy, 4). One launch on
// `stream`; allocates nothing; returns the launch error (0 on success).
extern "C" int segment_bin_agg_edges_one_launch(
    const float* x, const float* y, const float* v, const void* h_args,
    void* ws, void* ticket, double* out, void* stream) {
  EdgeHead h;
  memcpy(&h, h_args, sizeof(EdgeHead));
  if (h.S < 1 || h.S > AGG_MAX_SEGMENTS || h.gx < 1 || h.gy < 1 ||
      (long long)h.S * h.gx * h.gy > (1LL << 30) || h.b[0] < 0 ||
      h.ne != h.S * (h.gx + h.gy - 2) || h.ne > EDGE_CAP)
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < h.S; ++s)
    if (h.b[s + 1] < h.b[s]) return (int)cudaErrorInvalidValue;
  // 32 KB, off the stack; one a host thread (ctypes lets calls from
  // several threads run at once); the launch copies it
  static thread_local EdgeArgs a;
  a.h = h;
  memcpy(a.e, static_cast<const char*>(h_args) + sizeof(EdgeHead),
         (size_t)h.ne * sizeof(double));
  const int cells = h.S * h.gx * h.gy;
  const size_t head =
      (h.S + 1) * sizeof(long long) + (size_t)h.ne * sizeof(double);
  const int sink = sink_for(head, cells);
  const size_t smem = head + tables_bytes(sink, cells);
  Cell* c = (Cell*)ws;
  unsigned int* t = (unsigned int*)ticket;
  cudaStream_t st = (cudaStream_t)stream;
  if (sink == SINK_WARP)
    return launch_one<SINK_WARP>(x, y, v, a, smem, c, t, out, st);
  if (sink == SINK_BLOCK)
    return launch_one<SINK_BLOCK>(x, y, v, a, smem, c, t, out, st);
  return launch_one<SINK_GLOBAL>(x, y, v, a, smem, c, t, out, st);
}

extern "C" int segment_bin_agg_edges_limits(int* head_bytes, int* max_edges) {
  *head_bytes = (int)sizeof(EdgeHead);
  *max_edges = EDGE_CAP;
  return 0;
}
