// segment_window_agg: per-segment (count, sum, min, max) of the objects
// inside one closed window, over the concatenated segments of a batched
// refinement round. A +-inf window gives whole-segment statistics (the
// index's enrichment).
// segment_window_agg_multi: the same with each segment under its own
// window — the serving tick's scalar pass over several queries' tiles.
//
// Replaces the TPU kernels repro/kernels/segment_agg.py
// segment_window_agg_pallas (pallas_call at :154) and
// segment_window_agg_multi_pallas (pallas_call at :219), which unroll one
// masked reduction per segment because the TPU has no scatter. Here each
// is a keyed reduction, key = segment id, in agg_onepass.cuh's design:
// one launch a call (the last block writes the rows and resets the
// workspace and the ticket), a grid of what is resident on the card (cut
// when the stream is short), block-contiguous spans walked in float4
// loads, tables private to each warp (S <= 64 cells always fit). One
// template, three entries:
// - one window (row 1): x and y read for every object, v loaded only for
//   the objects inside the window;
// - the all-covering window (row 1's enrichment, recognised by the
//   wrapper as the host mirror recognises it: all four edges +-inf): v
//   alone is read and nothing is compared, so every object counts, NaN
//   values included, as in the mirror, which skips the mask there;
// - a window per segment (row 8): the object's segment is found before
//   the window test.
// A block's span meets few segments, so each thread keeps a run of one
// segment in registers (agg_common.cuh Run) and folds it into its warp's
// table only when the segment changes; at the end the lanes of a warp
// fold their runs in registers by segment (warp_flush_runs).
//
// Bound on the H100: memory. Each object is read once (x, y, and v for
// the objects inside the window: at most 12 bytes; v alone, 4 bytes,
// under the all-covering window), the output is S * 4 doubles. At the
// main path's rounds (<= 8 segments of ~4e5 objects) that is ~26-37 MB,
// ~8-11 us at 3.35 TB/s, and ~12.5 MB (~3.7 us) for the enrichment.
//
// Precision: the window test compares float32 coordinates with the
// window's float32 edges (the wrapper rounds each window to float32), as
// the host mirror does for Python-float windows. Counts are integers,
// sums float64, extrema exact float32, NaN values kept (agg_common.cuh).
#include <string.h>

#include "agg_common.cuh"
#include "agg_onepass.cuh"

#define SWA_WINDOW 0      // one window for every segment: w[0]
#define SWA_EVERYWHERE 1  // the all-covering window: v alone, no compare
#define SWA_MULTI 2       // segment s under w[s]

// The arguments, copied from a host buffer of the same layout (the
// wrapper builds it with numpy: no padding anywhere).
struct SwaArgs {
  long long b[AGG_MAX_SEGMENTS + 1];  // segment boundaries
  float w[AGG_MAX_SEGMENTS][4];       // windows: x0, y0, x1, y1 (float32)
  int S, mode;
};
static_assert(sizeof(SwaArgs) == 1552, "SwaArgs layout");

template <int kMode>
__global__ void __launch_bounds__(OP_THREADS) segment_window_agg_one(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ v, const __grid_constant__ SwaArgs a,
    Cell* __restrict__ ws, unsigned int* __restrict__ ticket,
    double* __restrict__ out) {
  extern __shared__ __align__(16) char smem[];
  const int S = a.S;
  long long* b = reinterpret_cast<long long*>(smem);
  // the windows of the multi entry, 16-byte aligned after the boundaries
  float4* win =
      reinterpret_cast<float4*>(smem + ((S + 1) * 8 + 15) / 16 * 16);
  char* tables =
      reinterpret_cast<char*>(win + (kMode == SWA_MULTI ? S : 0));
  for (int s = threadIdx.x; s <= S; s += blockDim.x) b[s] = a.b[s];
  if constexpr (kMode == SWA_MULTI)
    for (int s = threadIdx.x; s < S; s += blockDim.x)
      win[s] = make_float4(a.w[s][0], a.w[s][1], a.w[s][2], a.w[s][3]);
  tables_init(tables, SINK_WARP, S);
  const Table t = my_table(tables, SINK_WARP, S);
  __syncthreads();

  Run r;
  run_reset(r, 0);
  SegCache seg;
  if constexpr (kMode == SWA_EVERYWHERE) {
    auto visit = [&](long long i, float vi, bool ok) {
      if (!ok) return;
      seg.at(b, S, i);
      run_add(r, seg.s, vi, t);
    };
    walk_plane(v, b[0], b[S], visit);
  } else if constexpr (kMode == SWA_WINDOW) {
    const float4 w =
        make_float4(a.w[0][0], a.w[0][1], a.w[0][2], a.w[0][3]);
    auto want = [&](long long, float xi, float yi) {
      return in_window(w, xi, yi);
    };
    auto visit = [&](long long i, float xi, float yi, float vi, bool ok) {
      if (!ok || !in_window(w, xi, yi)) return;
      seg.at(b, S, i);
      run_add(r, seg.s, vi, t);
    };
    walk<false>(x, y, v, b[0], b[S], want, visit);
  } else {
    // the value loads run ahead of the visits: each keeps its own segment
    SegCache wseg;
    float4 ww = make_float4(0.f, 0.f, 0.f, 0.f), vw = ww;
    auto want = [&](long long i, float xi, float yi) {
      if (wseg.at(b, S, i)) ww = win[wseg.s];
      return in_window(ww, xi, yi);
    };
    auto visit = [&](long long i, float xi, float yi, float vi, bool ok) {
      if (!ok) return;
      if (seg.at(b, S, i)) vw = win[seg.s];
      if (in_window(vw, xi, yi)) run_add(r, seg.s, vi, t);
    };
    walk<false>(x, y, v, b[0], b[S], want, visit);
  }
  warp_flush_runs(r, t);
  tables_flush(tables, SINK_WARP, S, ws);
  if (!last_block(ticket)) return;
  rows_out(ws, out, S);
  workspace_reset(ws, S, ticket);
}

template <int kMode>
static int launch_one(const float* x, const float* y, const float* v,
                      const SwaArgs& a, size_t smem, Cell* ws,
                      unsigned int* ticket, double* out, cudaStream_t st) {
  static Occupancy occ[OP_MAX_DEVICES];
  cudaError_t err = cudaSuccess;
  const int blocks = grid_for(segment_window_agg_one<kMode>, occ, smem,
                              a.b[a.S] - a.b[0], &err);
  if (err != cudaSuccess) return (int)err;
  segment_window_agg_one<kMode><<<blocks, OP_THREADS, smem, st>>>(
      x, y, v, a, ws, ticket, out);
  return (int)cudaGetLastError();
}

// h_args: host SwaArgs (mode SWA_WINDOW: the window in w[0]; SWA_MULTI:
// segment s's in w[s]; SWA_EVERYWHERE: x and y are not read); ws: the
// caller's device workspace of at least S Cells in identity state, and
// ticket: its device counter at 0 (both left so by the call); out: device
// float64 (S, 4). One launch on `stream`; allocates nothing; returns the
// launch error (0 on success).
extern "C" int segment_window_agg_one_launch(
    const float* x, const float* y, const float* v, const void* h_args,
    void* ws, void* ticket, double* out, void* stream) {
  SwaArgs a;
  memcpy(&a, h_args, sizeof(SwaArgs));
  if (a.S < 1 || a.S > AGG_MAX_SEGMENTS || a.b[0] < 0 ||
      a.mode < SWA_WINDOW || a.mode > SWA_MULTI)
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < a.S; ++s)
    if (a.b[s + 1] < a.b[s]) return (int)cudaErrorInvalidValue;
  const size_t head = ((size_t)(a.S + 1) * 8 + 15) / 16 * 16 +
                      (a.mode == SWA_MULTI ? (size_t)a.S * 16 : 0);
  const size_t smem = head + tables_bytes(SINK_WARP, a.S);
  Cell* c = (Cell*)ws;
  unsigned int* t = (unsigned int*)ticket;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.mode == SWA_EVERYWHERE)
    return launch_one<SWA_EVERYWHERE>(x, y, v, a, smem, c, t, out, st);
  if (a.mode == SWA_MULTI)
    return launch_one<SWA_MULTI>(x, y, v, a, smem, c, t, out, st);
  return launch_one<SWA_WINDOW>(x, y, v, a, smem, c, t, out, st);
}

extern "C" int segment_window_agg_args_size() {
  return (int)sizeof(SwaArgs);
}

// the entries' mode numbers, one a byte (window, all-covering, multi),
// for the wrapper to check its own against
extern "C" int segment_window_agg_modes() {
  return SWA_WINDOW | SWA_EVERYWHERE << 8 | SWA_MULTI << 16;
}
