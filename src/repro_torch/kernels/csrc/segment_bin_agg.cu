// segment_bin_agg: per-(segment, cell) (count, sum, min, max), each
// segment clip-binned into gx * gy cells of its own bbox — the child
// metadata of a batched split. bin_agg (one tile's split on the
// sequential path) is the S = 1 launch of the same kernel.
//
// Replaces the TPU kernels repro/kernels/segment_agg.py
// segment_bin_agg_pallas (pallas_call at :524) and repro/kernels/
// bin_agg.py bin_agg_pallas (pallas_call at :89), which unroll
// group * k masked reductions because the TPU has no scatter. Here it is
// a keyed reduction: key = segment * k + cy * gx + cx, a block-private
// (S * k <= 2048)-cell table in shared memory, one atomic flush per block.
//
// Bound on the H100: memory. Each object is read once (x, y, v: 12
// bytes), the output is S * k * 4 doubles. At the main path's rounds
// (<= 8 segments of ~4e5 objects, k = 4) that is ~37 MB, ~11 us at
// 3.35 TB/s; at those sizes the launches and the host round trip
// dominate — a later change's problem.
//
// Precision: ownership is the host's float64 rule, not the TPU kernels'
// float32 re-binning: the wrapper passes each segment's (x0, y0, cw, ch)
// as doubles computed as the host computes them, and the kernel bins
// ((double)x - x0) / cw with IEEE double subtract and divide (no fast
// math), floor, clip — the cell ids numpy gives.
#include "agg_common.cuh"

struct SegParams {
  double p[AGG_MAX_SEGMENTS * 4];  // per segment: x0, y0, cw, ch
};

__global__ void segment_bin_agg_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ v, Bounds bounds, SegParams params, int S,
    int gx, int gy, Cell* __restrict__ ws) {
  extern __shared__ __align__(16) char smem[];
  const int k = gx * gy;
  long long* b = reinterpret_cast<long long*>(smem);
  double* par = reinterpret_cast<double*>(b + (S + 1));
  Table t = table_at(reinterpret_cast<char*>(par + 4 * S), S * k);
  for (int s = threadIdx.x; s <= S; s += blockDim.x) b[s] = bounds.b[s];
  for (int p = threadIdx.x; p < 4 * S; p += blockDim.x) par[p] = params.p[p];
  table_init(t, S * k);
  __syncthreads();

  const long long end = bounds.b[S];
  const long long i0 =
      bounds.b[0] + (long long)blockIdx.x * AGG_CHUNK + threadIdx.x;
  int s = i0 < end ? segment_of(b, S, i0) : 0;
  Run r;
  run_reset(r, s * k);
  for (int j = 0; j < AGG_ITEMS; ++j) {
    const long long i = i0 + (long long)j * AGG_THREADS;
    if (i >= end) break;
    if (i >= b[s + 1]) s = segment_of(b, S, i);
    const double* ps = par + 4 * s;
    const int cx = clip_cell(((double)x[i] - ps[0]) / ps[2], gx);
    const int cy = clip_cell(((double)y[i] - ps[1]) / ps[3], gy);
    run_add(r, s * k + cy * gx + cx, v[i], t);
  }
  run_flush(r, t);
  __syncthreads();
  table_flush(t, S * k, ws);
}

// h_bounds: host int64 (S + 1,); h_params: host float64 (S, 4) rows
// (x0, y0, cw, ch); ws: device workspace of S * gx * gy Cells; out:
// device float64 (S, gx * gy, 4). Launches on `stream`, allocates
// nothing, returns the first launch error (0 on success).
extern "C" int segment_bin_agg_launch(
    const float* x, const float* y, const float* v,
    const long long* h_bounds, const double* h_params, int S, int gx,
    int gy, void* ws, double* out, void* stream) {
  const int cells = S * gx * gy;
  if (S < 1 || S > AGG_MAX_SEGMENTS || gx < 1 || gy < 1 ||
      cells > AGG_MAX_CELLS)
    return (int)cudaErrorInvalidValue;
  Bounds bounds;
  SegParams params;
  for (int s = 0; s <= S; ++s) bounds.b[s] = h_bounds[s];
  for (int p = 0; p < 4 * S; ++p) params.p[p] = h_params[p];
  cudaStream_t st = (cudaStream_t)stream;
  Cell* ws_cells = (Cell*)ws;
  cudaError_t err;
  workspace_init<<<(cells + 255) / 256, 256, 0, st>>>(ws_cells, cells);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long n = bounds.b[S] - bounds.b[0];
  if (n > 0) {
    const long long blocks = (n + AGG_CHUNK - 1) / AGG_CHUNK;
    const size_t smem = (S + 1) * sizeof(long long) +
                        4 * S * sizeof(double) + table_bytes(cells);
    segment_bin_agg_kernel<<<(unsigned)blocks, AGG_THREADS, smem, st>>>(
        x, y, v, bounds, params, S, gx, gy, ws_cells);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  workspace_finalize<<<(cells + 255) / 256, 256, 0, st>>>(ws_cells, out,
                                                           cells);
  return (int)cudaGetLastError();
}
