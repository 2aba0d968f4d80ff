// segment_window_agg: per-segment (count, sum, min, max) of the objects
// inside one closed window, over the concatenated segments of a batched
// refinement round. A +-inf window gives whole-segment statistics.
// segment_window_agg_multi: the same with each segment under its own
// window — the serving tick's scalar pass over several queries' tiles.
//
// Replaces the TPU kernels repro/kernels/segment_agg.py
// segment_window_agg_pallas (pallas_call at :154) and
// segment_window_agg_multi_pallas (pallas_call at :219), which unroll one
// masked reduction per segment because the TPU has no scatter. Here each
// is a keyed reduction (key = segment id, found by binary search of the
// segment boundaries held in shared memory): per-thread register runs,
// a block-private table in shared memory, one atomic flush per block.
// One template serves both: with one window per segment (kMulti) it
// finds every object's segment before the window test and keeps the
// segment's window in registers while the run lasts.
//
// Bound on the H100: memory. Each object is read once (x, y, and v for
// the objects inside the window: at most 12 bytes), the output is S * 4
// doubles. At the main path's rounds (<= 8 segments of ~4e5 objects)
// that is ~37 MB, ~11 us at 3.35 TB/s; at those sizes the three launches
// (init, reduce, finalize) and the host round trip dominate — a later
// change's problem.
//
// Precision: the window test compares float32 coordinates with the
// window's float32 edges (the wrapper rounds each window to float32), as
// the host mirror does for Python-float windows. Counts are integers,
// sums float64, extrema exact float32.
#include "agg_common.cuh"

// one window per segment (the multi entry), or only w[0] (one shared
// window): x0, y0, x1, y1 (float32)
struct SegWindows {
  float w[AGG_MAX_SEGMENTS][4];
};

template <bool kMulti>
__global__ void segment_window_agg_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ v, Bounds bounds, int S, SegWindows windows,
    Cell* __restrict__ ws) {
  extern __shared__ __align__(16) char smem[];
  const int nw = kMulti ? S : 1;
  long long* b = reinterpret_cast<long long*>(smem);
  float* win = reinterpret_cast<float*>(b + S + 1);
  Table t = table_at(reinterpret_cast<char*>(win + 4 * nw), S);
  for (int s = threadIdx.x; s <= S; s += blockDim.x) b[s] = bounds.b[s];
  for (int k = threadIdx.x; k < 4 * nw; k += blockDim.x)
    win[k] = windows.w[k >> 2][k & 3];
  table_init(t, S);
  __syncthreads();

  const long long end = bounds.b[S];
  const long long i0 =
      bounds.b[0] + (long long)blockIdx.x * AGG_CHUNK + threadIdx.x;
  int s = i0 < end ? segment_of(b, S, i0) : 0;
  const float* w = win + (kMulti ? 4 * s : 0);
  float wx0 = w[0], wy0 = w[1], wx1 = w[2], wy1 = w[3];
  Run r;
  run_reset(r, s);
  for (int j = 0; j < AGG_ITEMS; ++j) {
    const long long i = i0 + (long long)j * AGG_THREADS;
    if (i >= end) break;
    // one shared window: find the segment only for in-window objects;
    // a window per segment: before the window test
    if (kMulti && i >= b[s + 1]) {
      s = segment_of(b, S, i);
      w = win + 4 * s;
      wx0 = w[0];
      wy0 = w[1];
      wx1 = w[2];
      wy1 = w[3];
    }
    const float xi = x[i], yi = y[i];
    if (xi >= wx0 && xi <= wx1 && yi >= wy0 && yi <= wy1) {
      if (!kMulti && i >= b[s + 1]) s = segment_of(b, S, i);
      run_add(r, s, v[i], t);
    }
  }
  run_flush(r, t);
  __syncthreads();
  table_flush(t, S, ws);
}

// Shared launch of both entries.
static int launch(const float* x, const float* y, const float* v,
                  const long long* h_bounds, int S,
                  const SegWindows& windows, bool multi, void* ws,
                  double* out, void* stream) {
  Bounds bounds;
  for (int s = 0; s <= S; ++s) bounds.b[s] = h_bounds[s];
  cudaStream_t st = (cudaStream_t)stream;
  Cell* cells = (Cell*)ws;
  cudaError_t err;
  workspace_init<<<(S + 255) / 256, 256, 0, st>>>(cells, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long n = bounds.b[S] - bounds.b[0];
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + AGG_CHUNK - 1) / AGG_CHUNK);
    const size_t smem = (S + 1) * sizeof(long long) +
                        4 * (multi ? S : 1) * sizeof(float) +
                        table_bytes(S);
    if (multi)
      segment_window_agg_kernel<true><<<blocks, AGG_THREADS, smem, st>>>(
          x, y, v, bounds, S, windows, cells);
    else
      segment_window_agg_kernel<false><<<blocks, AGG_THREADS, smem, st>>>(
          x, y, v, bounds, S, windows, cells);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  workspace_finalize<<<(S + 255) / 256, 256, 0, st>>>(cells, out, S);
  return (int)cudaGetLastError();
}

// h_bounds: host int64 (S + 1,) segment boundaries; ws: device
// workspace of S Cells; out: device float64 (S, 4). Launches on `stream`,
// allocates nothing, returns the first launch error (0 on success).
extern "C" int segment_window_agg_launch(
    const float* x, const float* y, const float* v,
    const long long* h_bounds, int S, float wx0, float wy0, float wx1,
    float wy1, void* ws, double* out, void* stream) {
  if (S < 1 || S > AGG_MAX_SEGMENTS) return (int)cudaErrorInvalidValue;
  SegWindows windows;
  windows.w[0][0] = wx0;
  windows.w[0][1] = wy0;
  windows.w[0][2] = wx1;
  windows.w[0][3] = wy1;
  return launch(x, y, v, h_bounds, S, windows, false, ws, out, stream);
}

// The multi entry: h_windows host float32 (S, 4), one closed window per
// segment.
extern "C" int segment_window_agg_multi_launch(
    const float* x, const float* y, const float* v,
    const long long* h_bounds, int S, const float* h_windows, void* ws,
    double* out, void* stream) {
  if (S < 1 || S > AGG_MAX_SEGMENTS) return (int)cudaErrorInvalidValue;
  SegWindows windows;
  for (int s = 0; s < S; ++s)
    for (int k = 0; k < 4; ++k) windows.w[s][k] = h_windows[4 * s + k];
  return launch(x, y, v, h_bounds, S, windows, true, ws, out, stream);
}
