// segment_window_agg: per-segment (count, sum, min, max) of the objects
// inside one closed window, over the concatenated segments of a batched
// refinement round. A +-inf window gives whole-segment statistics.
//
// Replaces the TPU kernel repro/kernels/segment_agg.py
// segment_window_agg_pallas (pallas_call at :154), which unrolls one
// masked reduction per segment because the TPU has no scatter. Here it
// is a keyed reduction (key = segment id, found by binary search of the
// segment boundaries held in shared memory): per-thread register runs,
// a block-private table in shared memory, one atomic flush per block.
//
// Bound on the H100: memory. Each object is read once (x, y, and v for
// the objects inside the window: at most 12 bytes), the output is S * 4
// doubles. At the main path's rounds (<= 8 segments of ~4e5 objects)
// that is ~37 MB, ~11 us at 3.35 TB/s; at those sizes the three launches
// (init, reduce, finalize) and the host round trip dominate — a later
// change's problem.
//
// Precision: the window test compares float32 coordinates with the
// window's float32 edges (the wrapper rounds the window to float32), as
// the host mirror does for Python-float windows. Counts are integers,
// sums float64, extrema exact float32.
#include "agg_common.cuh"

__global__ void segment_window_agg_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ v, Bounds bounds, int S, float wx0,
    float wy0, float wx1, float wy1, Cell* __restrict__ ws) {
  extern __shared__ __align__(16) char smem[];
  long long* b = reinterpret_cast<long long*>(smem);
  Table t = table_at(smem + (S + 1) * sizeof(long long), S);
  for (int s = threadIdx.x; s <= S; s += blockDim.x) b[s] = bounds.b[s];
  table_init(t, S);
  __syncthreads();

  const long long end = bounds.b[S];
  const long long i0 =
      bounds.b[0] + (long long)blockIdx.x * AGG_CHUNK + threadIdx.x;
  int s = i0 < end ? segment_of(b, S, i0) : 0;
  Run r;
  run_reset(r, s);
  for (int j = 0; j < AGG_ITEMS; ++j) {
    const long long i = i0 + (long long)j * AGG_THREADS;
    if (i >= end) break;
    const float xi = x[i], yi = y[i];
    if (xi >= wx0 && xi <= wx1 && yi >= wy0 && yi <= wy1) {
      if (i >= b[s + 1]) s = segment_of(b, S, i);
      run_add(r, s, v[i], t);
    }
  }
  run_flush(r, t);
  __syncthreads();
  table_flush(t, S, ws);
}

// h_bounds: host int64 (S + 1,) segment boundaries; ws: device
// workspace of S Cells; out: device float64 (S, 4). Launches on `stream`,
// allocates nothing, returns the first launch error (0 on success).
extern "C" int segment_window_agg_launch(
    const float* x, const float* y, const float* v,
    const long long* h_bounds, int S, float wx0, float wy0, float wx1,
    float wy1, void* ws, double* out, void* stream) {
  if (S < 1 || S > AGG_MAX_SEGMENTS) return (int)cudaErrorInvalidValue;
  Bounds bounds;
  for (int s = 0; s <= S; ++s) bounds.b[s] = h_bounds[s];
  cudaStream_t st = (cudaStream_t)stream;
  Cell* cells = (Cell*)ws;
  cudaError_t err;
  workspace_init<<<(S + 255) / 256, 256, 0, st>>>(cells, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long n = bounds.b[S] - bounds.b[0];
  if (n > 0) {
    const long long blocks = (n + AGG_CHUNK - 1) / AGG_CHUNK;
    const size_t smem = (S + 1) * sizeof(long long) + table_bytes(S);
    segment_window_agg_kernel<<<(unsigned)blocks, AGG_THREADS, smem, st>>>(
        x, y, v, bounds, S, wx0, wy0, wx1, wy1, cells);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  workspace_finalize<<<(S + 255) / 256, 256, 0, st>>>(cells, out, S);
  return (int)cudaGetLastError();
}
