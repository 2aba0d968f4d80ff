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
// Here both are one keyed reduction: key = segment * nb + bin, a
// block-private table in shared memory and one atomic flush per block; a
// table of more than AGG_MAX_CELLS cells (many bins times many segments)
// folds straight into the global workspace.
//
// Bound on the H100: memory. Each object's x and y are read once, v only
// for the objects inside the window; the output is S * nb * 4 doubles
// (plus (S + 1) * nb for suffix_w). At the heatmap path's rounds (<= 8
// segments of ~4e5 objects, 8 x 8 bins) that is ~26-37 MB, ~8-11 us at
// 3.35 TB/s; one tile of ~4e5 objects (process_heatmap's S = 1) is ~1 us,
// under a launch's own latency.
//
// The one-window entry (segment_window_bin_agg_one_launch: the heatmap
// path's rounds and tiles) takes agg_onepass.cuh's design: one launch a
// call (the last block writes the rows and suffix_w and resets the
// workspace), a grid of what is resident on the card, block-contiguous
// spans walked in float4 loads of x and y, v loaded (one scalar load
// each) only for in-window objects and before the thread's first fold,
// tables private to each warp where they fit, and warp-combined folds
// (a warp out of the window skips; lanes of one bin fold in registers).
// The multi entry keeps the three-launch form below (per-thread register
// runs, workspace_init, the keyed kernel, finalize_select).
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

// one per segment (the multi entry), or only p[0] (one shared window)
struct BinWindows {
  BinWindow p[AGG_MAX_SEGMENTS];
};

struct SegWidths {
  double dv[AGG_MAX_SEGMENTS];  // per segment: vmax - vmin (float64)
};

// query spans: span q holds segments [qb[q], qb[q + 1])
struct Spans {
  int qb[AGG_MAX_SEGMENTS + 1];
};

template <bool kShared, bool kMulti>
__global__ void segment_window_bin_agg_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ v, Bounds bounds, int S, BinWindows wins,
    int bx, int by, Cell* __restrict__ ws) {
  extern __shared__ __align__(16) char smem[];
  const int nb = bx * by;
  const int nw = kMulti ? S : 1;
  long long* b = reinterpret_cast<long long*>(smem);
  BinWindow* win = reinterpret_cast<BinWindow*>(b + S + 1);
  Table t = table_at(reinterpret_cast<char*>(win + nw), S * nb);
  for (int s = threadIdx.x; s <= S; s += blockDim.x) b[s] = bounds.b[s];
  for (int k = threadIdx.x; k < nw; k += blockDim.x) win[k] = wins.p[k];
  if (kShared) table_init(t, S * nb);
  __syncthreads();

  const long long end = bounds.b[S];
  const long long i0 =
      bounds.b[0] + (long long)blockIdx.x * AGG_CHUNK + threadIdx.x;
  int s = i0 < end ? segment_of(b, S, i0) : 0;
  BinWindow w = win[kMulti ? s : 0];
  Run r;
  run_reset(r, s * nb);
  for (int j = 0; j < AGG_ITEMS; ++j) {
    const long long i = i0 + (long long)j * AGG_THREADS;
    if (i >= end) break;
    // one shared window: find the segment only for in-window objects;
    // a window per segment: before the window test
    if (kMulti && i >= b[s + 1]) {
      s = segment_of(b, S, i);
      w = win[s];
    }
    const float xi = x[i], yi = y[i];
    if (xi >= w.x0 && xi <= w.x1 && yi >= w.y0 && yi <= w.y1) {
      if (!kMulti && i >= b[s + 1]) s = segment_of(b, S, i);
      const int cx = clip_cell(__fdiv_rn(__fsub_rn(xi, w.x0), w.cw), bx);
      const int cy = clip_cell(__fdiv_rn(__fsub_rn(yi, w.y0), w.ch), by);
      if (kShared) run_add(r, s * nb + cy * bx + cx, v[i], t);
      else run_add(r, s * nb + cy * bx + cx, v[i], ws);
    }
  }
  if (kShared) {
    run_flush(r, t);
    __syncthreads();
    table_flush(t, S * nb, ws);
  } else {
    run_flush(r, ws);
  }
}

// The (S, nb, 4) rows, and with them suffix_w: thread q * nb + c walks
// bin c's column of span q from the span's last segment up —
// acc = w[e-1], then acc = acc + w[s] — as numpy's cumsum over the
// span's reversed rows does. zero_row: also write row S as 0.
__global__ void finalize_select(const Cell* ws, double* out, int S, int nb,
                                SegWidths widths, Spans spans, int nq,
                                int zero_row, double* suffix) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < S * nb) {
    out[4 * c + 0] = (double)ws[c].cnt;
    out[4 * c + 1] = ws[c].sum;
    out[4 * c + 2] = (double)o2f(ws[c].mn);
    out[4 * c + 3] = (double)o2f(ws[c].mx);
  }
  if (c < nq * nb) {
    const int q = c / nb, bin = c - q * nb;
    const int a = spans.qb[q], e = spans.qb[q + 1];
    if (e > a) {
      double acc =
          __dmul_rn((double)ws[(e - 1) * nb + bin].cnt, widths.dv[e - 1]);
      suffix[(e - 1) * nb + bin] = acc;
      for (int s = e - 2; s >= a; --s) {
        acc = __dadd_rn(
            acc, __dmul_rn((double)ws[s * nb + bin].cnt, widths.dv[s]));
        suffix[s * nb + bin] = acc;
      }
    }
  }
  if (zero_row && c < nb) suffix[S * nb + c] = 0.0;
}

// The one-window entry's arguments, copied from a host buffer of the same
// layout (the wrapper builds it with numpy: no padding anywhere).
struct WinArgs {
  long long b[AGG_MAX_SEGMENTS + 1];  // segment boundaries
  double dv[AGG_MAX_SEGMENTS];        // select: per segment vmax - vmin
  BinWindow w;                        // the binning contract params
  int S, bx, by, select;              // select: write suffix_w
};
static_assert(sizeof(WinArgs) == 1072, "WinArgs layout");

// One launch a call: per-(segment, window-bin) table, then in the last
// block the (S, nb, 4) rows and, with a.select, suffix_w (S + 1, nb) by
// numpy's reversed cumsum order (the single span of finalize_select).
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

template <int kSink>
static int launch_one(const float* x, const float* y, const float* v,
                      const WinArgs& a, size_t smem, Cell* ws,
                      unsigned int* ticket, double* out, double* suffix,
                      cudaStream_t st) {
  static Occupancy occ[OP_MAX_DEVICES];
  cudaError_t err = cudaSuccess;
  const int blocks = grid_for(segment_window_bin_agg_one<kSink>, occ, smem,
                              a.b[a.S] - a.b[0], &err);
  if (err != cudaSuccess) return (int)err;
  segment_window_bin_agg_one<kSink><<<blocks, OP_THREADS, smem, st>>>(
      x, y, v, a, ws, ticket, out, suffix);
  return (int)cudaGetLastError();
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
  if (a.S < 1 || a.S > AGG_MAX_SEGMENTS || a.bx < 1 || a.by < 1 ||
      (long long)a.S * a.bx * a.by > (1LL << 30) || a.b[0] < 0 ||
      (a.select != 0) != (suffix != nullptr))
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < a.S; ++s)
    if (a.b[s + 1] < a.b[s]) return (int)cudaErrorInvalidValue;
  const int cells = a.S * a.bx * a.by;
  const size_t head = (a.S + 1) * sizeof(long long);
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

extern "C" int segment_window_bin_agg_args_size() {
  return (int)sizeof(WinArgs);
}

// The multi entry's launch. h_dv == nullptr: the table only.
static int launch_multi(const float* x, const float* y, const float* v,
                        const long long* h_bounds, int S,
                        const BinWindows& wins, int bx, int by,
                        const double* h_dv, const Spans& spans, int nq,
                        void* ws, double* out, double* suffix,
                        void* stream) {
  const int nb = bx * by;
  const int cells = S * nb;
  Bounds bounds;
  for (int s = 0; s <= S; ++s) bounds.b[s] = h_bounds[s];
  cudaStream_t st = (cudaStream_t)stream;
  Cell* ws_cells = (Cell*)ws;
  cudaError_t err;
  workspace_init<<<(cells + 255) / 256, 256, 0, st>>>(ws_cells, cells);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long n = bounds.b[S] - bounds.b[0];
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + AGG_CHUNK - 1) / AGG_CHUNK);
    const size_t head = (S + 1) * sizeof(long long) + S * sizeof(BinWindow);
    const bool shared = cells <= AGG_MAX_CELLS;
    const size_t smem = head + (shared ? table_bytes(cells) : 0);
    if (shared)
      segment_window_bin_agg_kernel<true, true>
          <<<blocks, AGG_THREADS, smem, st>>>(x, y, v, bounds, S, wins, bx,
                                              by, ws_cells);
    else
      segment_window_bin_agg_kernel<false, true>
          <<<blocks, AGG_THREADS, smem, st>>>(x, y, v, bounds, S, wins, bx,
                                              by, ws_cells);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (h_dv == nullptr) {
    workspace_finalize<<<(cells + 255) / 256, 256, 0, st>>>(ws_cells, out,
                                                             cells);
  } else {
    SegWidths widths;
    for (int s = 0; s < S; ++s) widths.dv[s] = h_dv[s];
    const int threads = cells > nq * nb ? cells : nq * nb;
    finalize_select<<<(threads + 255) / 256, 256, 0, st>>>(
        ws_cells, out, S, nb, widths, spans, nq, 0, suffix);
  }
  return (int)cudaGetLastError();
}

// The multi entry: h_params host float32 (S, 6), one contract row per
// segment; with h_dv non-null also h_qb (host int64 (nq + 1,) query
// spans, 0 = qb[0] <= ... <= qb[nq] = S) and suffix: device float64
// (S, bx * by).
extern "C" int segment_window_bin_agg_multi_launch(
    const float* x, const float* y, const float* v,
    const long long* h_bounds, int S, const float* h_params, int bx,
    int by, const double* h_dv, const long long* h_qb, int nq, void* ws,
    double* out, double* suffix, void* stream) {
  if (S < 1 || S > AGG_MAX_SEGMENTS || bx < 1 || by < 1 ||
      (h_dv != nullptr) != (suffix != nullptr))
    return (int)cudaErrorInvalidValue;
  BinWindows wins;
  for (int s = 0; s < S; ++s) {
    const float* p = h_params + 6 * s;
    wins.p[s] = {p[0], p[1], p[2], p[3], p[4], p[5]};
  }
  Spans spans;
  if (h_dv != nullptr) {
    if (h_qb == nullptr || nq < 1 || nq > AGG_MAX_SEGMENTS || h_qb[0] != 0 ||
        h_qb[nq] != S)
      return (int)cudaErrorInvalidValue;
    for (int q = 0; q <= nq; ++q) {
      if (q > 0 && h_qb[q] < h_qb[q - 1]) return (int)cudaErrorInvalidValue;
      spans.qb[q] = (int)h_qb[q];
    }
  }
  return launch_multi(x, y, v, h_bounds, S, wins, bx, by, h_dv, spans, nq,
                      ws, out, suffix, stream);
}
