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
// table of more than AGG_MAX_CELLS cells folds straight into the global
// workspace).
//
// Bound on the H100: memory. Each object is read once (x, y, v: 12
// bytes) and compared with at most (gx - 1) + (gy - 1) edges held in
// shared memory; the output is S * k * 4 doubles. At the heatmap path's
// rounds (<= 8 segments of ~4e5 objects, up to 4 x 4 cells) that is
// ~37 MB, ~11 us at 3.35 TB/s; at those sizes the launches and the host
// round trip dominate.
//
// Precision: ownership is the host's rule (repro/kernels/ref.py
// edge_cell_ids_np): the float32 coordinate widened to double against
// float64 edges. The Pallas kernel rounds the edges to float32 instead
// (repro/kernels/ops.py:320), which can put an object lying between
// f32(edge) and edge in another child than the host's reorganization.
#include "agg_common.cuh"

// edges: device float64, S * (gx - 1) interior x edges (segment-major)
// followed by S * (gy - 1) interior y edges
template <bool kShared>
__global__ void segment_bin_agg_edges_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ v, Bounds bounds,
    const double* __restrict__ edges, int S, int gx, int gy,
    Cell* __restrict__ ws) {
  extern __shared__ __align__(16) char smem[];
  const int k = gx * gy;
  const int nx = gx - 1, ny = gy - 1;
  long long* b = reinterpret_cast<long long*>(smem);
  double* ex = reinterpret_cast<double*>(b + (S + 1));
  double* ey = ex + S * nx;
  Table t = table_at(reinterpret_cast<char*>(ey + S * ny), S * k);
  for (int s = threadIdx.x; s <= S; s += blockDim.x) b[s] = bounds.b[s];
  for (int e = threadIdx.x; e < S * (nx + ny); e += blockDim.x)
    ex[e] = edges[e];
  if (kShared) table_init(t, S * k);
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
    const double xi = (double)x[i], yi = (double)y[i];
    int cx = 0, cy = 0;
    for (int e = 0; e < nx; ++e) cx += xi >= ex[s * nx + e];
    for (int e = 0; e < ny; ++e) cy += yi >= ey[s * ny + e];
    if (kShared) run_add(r, s * k + cy * gx + cx, v[i], t);
    else run_add(r, s * k + cy * gx + cx, v[i], ws);
  }
  if (kShared) {
    run_flush(r, t);
    __syncthreads();
    table_flush(t, S * k, ws);
  } else {
    run_flush(r, ws);
  }
}

// h_bounds: host int64 (S + 1,); edges: device float64 interior edges
// (see the kernel); ws: device workspace of S * gx * gy Cells; out:
// device float64 (S, gx * gy, 4). Launches on `stream`, allocates
// nothing, returns the first launch error (0 on success).
extern "C" int segment_bin_agg_edges_launch(
    const float* x, const float* y, const float* v,
    const long long* h_bounds, const double* edges, int S, int gx, int gy,
    void* ws, double* out, void* stream) {
  const int cells = S * gx * gy;
  const size_t head = (S + 1) * sizeof(long long) +
                      (size_t)S * (gx + gy - 2) * sizeof(double);
  if (S < 1 || S > AGG_MAX_SEGMENTS || gx < 1 || gy < 1 || head > 32768)
    return (int)cudaErrorInvalidValue;
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
    if (cells <= AGG_MAX_CELLS && head + table_bytes(cells) <= AGG_SMEM)
      segment_bin_agg_edges_kernel<true>
          <<<blocks, AGG_THREADS, head + table_bytes(cells), st>>>(
              x, y, v, bounds, edges, S, gx, gy, ws_cells);
    else
      segment_bin_agg_edges_kernel<false><<<blocks, AGG_THREADS, head, st>>>(
          x, y, v, bounds, edges, S, gx, gy, ws_cells);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  workspace_finalize<<<(cells + 255) / 256, 256, 0, st>>>(ws_cells, out,
                                                           cells);
  return (int)cudaGetLastError();
}
