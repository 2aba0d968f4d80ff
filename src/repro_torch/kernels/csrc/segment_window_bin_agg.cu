// segment_window_bin_agg / segment_window_bin_select: per-(segment,
// window-bin) (count, sum, min, max) of the objects inside one closed
// window, every segment binned by the same bx * by grid laid on the
// window — the heatmap read. The select variant adds the selection
// epilogue: suffix_w (S + 1, bx * by), the reversed cumulative sum over
// segments of cnt * (vmax_s - vmin_s), last row exactly 0.
// The multi entry (segment_window_bin_agg_multi / _select_multi, the
// serving tick's heatmap pass) masks and bins each segment by its OWN
// window's contract params, and its epilogue takes the reversed
// cumulative sum within each query span (qb[q], qb[q + 1]) only:
// suffix_w (S, bx * by), no zero row (each consumer appends its own).
//
// Replaces the TPU kernels repro/kernels/segment_agg.py
// segment_window_bin_agg_pallas (pallas_call at :295) and
// segment_window_bin_agg_multi_pallas (:372), and
// repro/kernels/fused_select.py fused_table_pallas (pallas_call at :364,
// called by segment_window_bin_select_pallas at :389) and
// fused_table_multi_pallas (:498, called by
// segment_window_bin_select_multi_pallas at :523), which unroll one
// masked reduction per (segment, bin) because the TPU has no scatter.
// Here both are one keyed reduction, key = segment * nb + bin, in
// agg_onepass.cuh's design, two kernels over shared helpers: one launch a
// call (the last block writes the rows and suffix_w and resets the
// workspace and the ticket), a grid of what is resident on the card,
// block-contiguous spans walked in float4 loads of x and y, v loaded (one
// scalar load each) only for in-window objects and before the thread's
// first fold, and warp-combined folds (a warp out of the window skips;
// lanes of one bin fold in registers) into tables private to each warp,
// one table a block, or — past AGG_MAX_CELLS cells or the shared memory
// without an opt-in (many bins times many segments) — the global
// workspace itself. One window (the heatmap path's rounds and tiles)
// stays in registers and the segment is found only for in-window
// objects; a window per segment (the serving tick) lives in shared
// memory, and each object's segment is found before its window test, a
// segment cache each for the value loads and the folds (as the window
// read's multi entry, segment_window_agg.cu).
//
// Bound on the H100: memory. Each object's x and y are read once, v only
// for the objects inside the window; the output is S * nb * 4 doubles
// (plus S * nb or (S + 1) * nb for suffix_w). At the heatmap path's
// rounds (<= 8 segments of ~4e5 objects, 8 x 8 bins) that is ~26-37 MB,
// ~8-11 us at 3.35 TB/s; one tile of ~4e5 objects (process_heatmap's
// S = 1) is ~1 us, and the serving tick's median heatmap pass (~3.5e4
// objects) well under 1 us: both under a launch's own latency.
//
// Precision — the binning contract of repro/kernels/ref.py
// window_bin_params: the window (x0, y0, x1, y1) and the cell sizes
// (cw, ch) arrive as float32, with cw, ch derived in float64 on the host
// and only then rounded; the mask compares in float32 and the bin is
// clip(floor((x - x0) / cw)) in IEEE float32 (__fsub_rn, __fdiv_rn:
// never recomputed from the window in the kernel, never fast math). That
// is bit for bit the host rule window_bin_ids_np. The suffix epilogue
// multiplies and adds with __dmul_rn / __dadd_rn, which nvcc never
// contracts into an FMA, in the order numpy's reversed cumsum takes:
// suffix_w equals the host mirror's bit for bit, per span too (the
// Pallas multi epilogue takes a global float32 suffix minus the span's
// tail instead, repro/kernels/fused_select.py:179-182).
#include <string.h>

#include "agg_common.cuh"
#include "agg_onepass.cuh"

// a window's binning contract params (float32)
struct BinWindow {
  float x0, y0, x1, y1, cw, ch;
};

// The arguments, copied from a host buffer of the same layout (the
// wrapper builds each with numpy: no padding anywhere). One window:
struct WinArgs {
  long long b[AGG_MAX_SEGMENTS + 1];  // segment boundaries
  double dv[AGG_MAX_SEGMENTS];        // select: per segment vmax - vmin
  BinWindow w;                        // the binning contract params
  int S, bx, by, select;              // select: write suffix_w
};
static_assert(sizeof(WinArgs) == 1072, "WinArgs layout");

// A window per segment, and the query spans of the select epilogue:
struct MultiArgs {
  long long b[AGG_MAX_SEGMENTS + 1];  // segment boundaries
  double dv[AGG_MAX_SEGMENTS];        // select: per segment vmax - vmin
  BinWindow w[AGG_MAX_SEGMENTS];      // segment s's contract params
  int qb[AGG_MAX_SEGMENTS + 1];       // select: span q is [qb[q], qb[q+1])
  int S, bx, by, select, nq;          // nq: spans (select only)
};
static_assert(sizeof(MultiArgs) == 2848, "MultiArgs layout");

// Shared memory of the multi entry before its tables: the boundaries,
// each segment's window (16-byte aligned, at win_at) and cell sizes.
__host__ __device__ __forceinline__ size_t win_at(int S) {
  return ((size_t)(S + 1) * sizeof(long long) + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ size_t multi_head(int S) {
  return win_at(S) + (size_t)S * (sizeof(float4) + sizeof(float2));
}

// One window: the per-(segment, window-bin) table, then in the last block
// the (S, nb, 4) rows and, with a.select, suffix_w (S + 1, nb) by numpy's
// reversed cumsum order: thread `bin` walks bin's column from the last
// segment up (acc = w[S-1], then acc = acc + w[s]), then the zero row S.
// The window stays in registers and the segment is found only for
// in-window objects.
template <int kSink>
__global__ void __launch_bounds__(OP_THREADS) segment_window_bin_agg_one(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ v, const __grid_constant__ WinArgs a,
    Cell* __restrict__ ws, unsigned int* __restrict__ ticket,
    double* __restrict__ out, double* __restrict__ suffix) {
  extern __shared__ __align__(16) char smem[];
  const int S = a.S, bx = a.bx, by = a.by, nb = bx * by, cells = S * nb;
  const BinWindow w = a.w;
  long long* b = reinterpret_cast<long long*>(smem);
  char* tables = reinterpret_cast<char*>(b + S + 1);
  for (int s = threadIdx.x; s <= S; s += blockDim.x) b[s] = a.b[s];
  if (kSink != SINK_GLOBAL) tables_init(tables, kSink, cells);
  const Table t = my_table(tables, kSink, cells);
  __syncthreads();

  auto inside = [&](long long, float xi, float yi) {
    return xi >= w.x0 && xi <= w.x1 && yi >= w.y0 && yi <= w.y1;
  };
  int seg = 0;
  auto visit = [&](long long i, float xi, float yi, float vi, bool ok) {
    int key = -1;
    if (ok && inside(i, xi, yi)) {
      if (i < b[seg] || i >= b[seg + 1]) seg = segment_of(b, S, i);
      const int cx = clip_cell(__fdiv_rn(__fsub_rn(xi, w.x0), w.cw), bx);
      const int cy = clip_cell(__fdiv_rn(__fsub_rn(yi, w.y0), w.ch), by);
      key = seg * nb + cy * bx + cx;
    }
    if (kSink == SINK_GLOBAL) warp_fold<true>(key, vi, ws);
    else warp_fold<true>(key, vi, t);
  };
  walk<false>(x, y, v, b[0], b[S], inside, visit);
  if (kSink != SINK_GLOBAL) tables_flush(tables, kSink, cells, ws);
  if (!last_block(ticket)) return;
  rows_out(ws, out, cells);
  if (a.select) {
    // w = cnt * dv per cell, staged in the block's own (flushed) tables
    // when it has them, so that each bin's walk over the segments reads
    // shared memory
    double* wc = table_at(tables, cells).sum;
    if (kSink != SINK_GLOBAL) {
      for (int c = threadIdx.x; c < cells; c += blockDim.x)
        wc[c] = __dmul_rn((double)__ldcg(&ws[c].cnt), a.dv[c / nb]);
      __syncthreads();
    }
    auto width = [&](int s, int bin) {
      return kSink != SINK_GLOBAL
                 ? wc[s * nb + bin]
                 : __dmul_rn((double)__ldcg(&ws[s * nb + bin].cnt), a.dv[s]);
    };
    for (int bin = threadIdx.x; bin < nb; bin += blockDim.x) {
      double acc = width(S - 1, bin);
      suffix[(S - 1) * nb + bin] = acc;
      for (int s = S - 2; s >= 0; --s) {
        acc = __dadd_rn(acc, width(s, bin));
        suffix[s * nb + bin] = acc;
      }
      suffix[S * nb + bin] = 0.0;
    }
  }
  workspace_reset(ws, cells, ticket);
}

// A window per segment: the same table, each object's segment found
// before its window test (a segment cache each for the value loads,
// which run ahead, and the folds, as the window read's multi entry
// does), then the rows and, with a.select, suffix_w (S, nb), each of
// a.qb's spans walked as the one-window kernel walks its single span. A
// kernel of its own, so that the one-window kernel's code stays as it
// was: a template shared with it cost that kernel registers (48 -> 64 on
// sm_90a, so fewer resident blocks).
template <int kSink>
__global__ void __launch_bounds__(OP_THREADS) segment_window_bin_agg_multi(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ v, const __grid_constant__ MultiArgs a,
    Cell* __restrict__ ws, unsigned int* __restrict__ ticket,
    double* __restrict__ out, double* __restrict__ suffix) {
  extern __shared__ __align__(16) char smem[];
  const int S = a.S, bx = a.bx, by = a.by, nb = bx * by, cells = S * nb;
  long long* b = reinterpret_cast<long long*>(smem);
  float4* win = reinterpret_cast<float4*>(smem + win_at(S));
  float2* cwh = reinterpret_cast<float2*>(win + S);
  char* tables = reinterpret_cast<char*>(cwh + S);
  for (int s = threadIdx.x; s <= S; s += blockDim.x) b[s] = a.b[s];
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const BinWindow& w = a.w[s];
    win[s] = make_float4(w.x0, w.y0, w.x1, w.y1);
    cwh[s] = make_float2(w.cw, w.ch);
  }
  if (kSink != SINK_GLOBAL) tables_init(tables, kSink, cells);
  const Table t = my_table(tables, kSink, cells);
  __syncthreads();

  SegCache wseg, seg;
  float4 ww = make_float4(0.f, 0.f, 0.f, 0.f), vw = ww;
  float2 vc = make_float2(1.f, 1.f);
  auto want = [&](long long i, float xi, float yi) {
    if (wseg.at(b, S, i)) ww = win[wseg.s];
    return in_window(ww, xi, yi);
  };
  auto visit = [&](long long i, float xi, float yi, float vi, bool ok) {
    int key = -1;
    if (ok) {
      if (seg.at(b, S, i)) {
        vw = win[seg.s];
        vc = cwh[seg.s];
      }
      if (in_window(vw, xi, yi)) {
        const int cx = clip_cell(__fdiv_rn(__fsub_rn(xi, vw.x), vc.x), bx);
        const int cy = clip_cell(__fdiv_rn(__fsub_rn(yi, vw.y), vc.y), by);
        key = seg.s * nb + cy * bx + cx;
      }
    }
    if (kSink == SINK_GLOBAL) warp_fold<true>(key, vi, ws);
    else warp_fold<true>(key, vi, t);
  };
  walk<false>(x, y, v, b[0], b[S], want, visit);
  if (kSink != SINK_GLOBAL) tables_flush(tables, kSink, cells, ws);
  if (!last_block(ticket)) return;
  rows_out(ws, out, cells);
  if (a.select) {
    // as the one-window kernel's epilogue, one thread a (span, bin)
    // column; an empty span writes nothing
    double* wc = table_at(tables, cells).sum;
    if (kSink != SINK_GLOBAL) {
      for (int c = threadIdx.x; c < cells; c += blockDim.x)
        wc[c] = __dmul_rn((double)__ldcg(&ws[c].cnt), a.dv[c / nb]);
      __syncthreads();
    }
    auto width = [&](int s, int bin) {
      return kSink != SINK_GLOBAL
                 ? wc[s * nb + bin]
                 : __dmul_rn((double)__ldcg(&ws[s * nb + bin].cnt), a.dv[s]);
    };
    for (int col = threadIdx.x; col < a.nq * nb; col += blockDim.x) {
      const int q = col / nb, bin = col - q * nb;
      const int lo = a.qb[q], hi = a.qb[q + 1];
      if (hi > lo) {
        double acc = width(hi - 1, bin);
        suffix[(hi - 1) * nb + bin] = acc;
        for (int s = hi - 2; s >= lo; --s) {
          acc = __dadd_rn(acc, width(s, bin));
          suffix[s * nb + bin] = acc;
        }
      }
    }
  }
  workspace_reset(ws, cells, ticket);
}

template <int kSink>
static auto kernel_of(const WinArgs&) {
  return segment_window_bin_agg_one<kSink>;
}

template <int kSink>
static auto kernel_of(const MultiArgs&) {
  return segment_window_bin_agg_multi<kSink>;
}

template <int kSink, class Args>
static int launch_one(const float* x, const float* y, const float* v,
                      const Args& a, size_t smem, Cell* ws,
                      unsigned int* ticket, double* out, double* suffix,
                      cudaStream_t st) {
  static Occupancy occ[OP_MAX_DEVICES];
  const auto kernel = kernel_of<kSink>(a);
  cudaError_t err = cudaSuccess;
  const int blocks = grid_for(kernel, occ, smem, a.b[a.S] - a.b[0], &err);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, OP_THREADS, smem, st>>>(x, y, v, a, ws, ticket, out,
                                           suffix);
  return (int)cudaGetLastError();
}

// The checks both entries share, then the launch for the table's sink
// after `head` bytes of other shared memory.
template <class Args>
static int launch(const float* x, const float* y, const float* v,
                  const Args& a, size_t head, void* ws, void* ticket,
                  double* out, double* suffix, void* stream) {
  if (a.S < 1 || a.S > AGG_MAX_SEGMENTS || a.bx < 1 || a.by < 1 ||
      (long long)a.S * a.bx * a.by > (1LL << 30) || a.b[0] < 0 ||
      (a.select != 0) != (suffix != nullptr))
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < a.S; ++s)
    if (a.b[s + 1] < a.b[s]) return (int)cudaErrorInvalidValue;
  const int cells = a.S * a.bx * a.by;
  const int sink = sink_for(head, cells);
  const size_t smem = head + tables_bytes(sink, cells);
  Cell* c = (Cell*)ws;
  unsigned int* t = (unsigned int*)ticket;
  cudaStream_t st = (cudaStream_t)stream;
  if (sink == SINK_WARP)
    return launch_one<SINK_WARP>(x, y, v, a, smem, c, t, out, suffix, st);
  if (sink == SINK_BLOCK)
    return launch_one<SINK_BLOCK>(x, y, v, a, smem, c, t, out, suffix, st);
  return launch_one<SINK_GLOBAL>(x, y, v, a, smem, c, t, out, suffix, st);
}

// h_args: host WinArgs; ws: the caller's device workspace of at least
// S * bx * by Cells in identity state, and ticket: its device counter at 0
// (both left so by the call); out: device float64 (S, bx * by); with
// a.select also suffix: device float64 (S + 1, bx * by). One launch on
// `stream`; allocates nothing; returns the launch error (0 on success).
extern "C" int segment_window_bin_agg_one_launch(
    const float* x, const float* y, const float* v, const void* h_args,
    void* ws, void* ticket, double* out, double* suffix, void* stream) {
  WinArgs a;
  memcpy(&a, h_args, sizeof(WinArgs));
  return launch(x, y, v, a, (size_t)(a.S + 1) * sizeof(long long), ws,
                ticket, out, suffix, stream);
}

// The multi entry: h_args a host MultiArgs, with a.select its spans
// 0 = qb[0] <= ... <= qb[nq] = S (1 <= nq <= 64) and suffix: device
// float64 (S, bx * by); otherwise as the one-window entry.
extern "C" int segment_window_bin_agg_multi_launch(
    const float* x, const float* y, const float* v, const void* h_args,
    void* ws, void* ticket, double* out, double* suffix, void* stream) {
  MultiArgs a;
  memcpy(&a, h_args, sizeof(MultiArgs));
  if (a.select) {
    if (a.nq < 1 || a.nq > AGG_MAX_SEGMENTS || a.qb[0] != 0 ||
        a.qb[a.nq] != a.S)
      return (int)cudaErrorInvalidValue;
    for (int q = 0; q < a.nq; ++q)
      if (a.qb[q + 1] < a.qb[q]) return (int)cudaErrorInvalidValue;
  }
  return launch(x, y, v, a, multi_head(a.S), ws, ticket, out, suffix,
                stream);
}

extern "C" int segment_window_bin_agg_args_size() {
  return (int)sizeof(WinArgs);
}

extern "C" int segment_window_bin_agg_multi_args_size() {
  return (int)sizeof(MultiArgs);
}
