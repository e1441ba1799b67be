// Point-splat soft-mask kernels for Hopper (sm_90a), plain C interface.
//
// Forward: replaces `splat_fwd_cells_idx` / `_splat_fwd_kernel_idx`
// (selfreconcode_tpu/ops/pallas_raster.py:203-258).  For every pixel of an
// active cs x cs image cell it sums
//     log1p(-clip(1 - d^2 / r^2, 0, 1 - 1e-5))
// over every splat binned to that cell; the caller forms 1 - exp(sum).
//
// Backward: replaces `splat_bwd_cells_idx` / `_splat_bwd_kernel_idx`
// (pallas_raster.py:261-311).  For every binned entry it sums
//     cot * 2 r^-2 / (1 - w) * (dc, dr)
// over the cell's pixels with 0 < w < 1 - 1e-5, and writes the pair at the
// entry's own position in the sorted entry list (no atomics: the caller
// reduces each point's <= 4 entries in a fixed order, so the gradient is
// deterministic).
//
// What bounds them on this card: both are bound by arithmetic, not bytes.
// A cell reads each candidate's (col, row) once (8 bytes) and then does
// cs*cs distance + log1p (forward) or divide + FMA (backward) evaluations
// with it, ~64 pairs per 8 bytes at cs = 8.  The design keeps every
// intermediate in registers and shared memory: one block per ACTIVE cell
// (cells no splat touches are never launched), one thread per pixel in the
// forward with the candidates staged through shared memory in tiles, one
// thread per candidate in the backward with the cell's cotangents in shared
// memory.  There is no per-cell candidate capacity: a block walks its
// cell's whole run of the sorted entry list, so no splat is ever dropped
// (the TPU kernels' cap, cap slicing and active-cell capacity were VMEM and
// static-shape bounds).
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;          // candidates staged per shared-memory tile
constexpr int kBwdThreads = 128;    // threads per block in the backward
constexpr float kWMax = 1.0f - 1e-5f;

__global__ void splat_fwd_kernel(const float* __restrict__ col,
                                 const float* __restrict__ row, int n_pts,
                                 const int* __restrict__ entries,
                                 const int* __restrict__ cell_ids,
                                 const int* __restrict__ starts,
                                 const int* __restrict__ counts,
                                 int cs, int ncx, int wp, float r2_inv,
                                 float* __restrict__ acc_img) {
  __shared__ float s_col[kTile];
  __shared__ float s_row[kTile];
  const int a = blockIdx.x;
  const int cell = cell_ids[a];
  const int start = starts[a];
  const int count = counts[a];
  const int t = threadIdx.x;
  const int cx0 = (cell % ncx) * cs;
  const int cy0 = (cell / ncx) * cs;
  const int lx = t % cs;
  const int ly = t / cs;
  const float px = static_cast<float>(cx0 + lx);
  const float py = static_cast<float>(cy0 + ly);
  float acc = 0.0f;
  for (int base = 0; base < count; base += kTile) {
    const int n = min(kTile, count - base);
    __syncthreads();
    for (int k = t; k < n; k += blockDim.x) {
      const int p = entries[start + base + k] % n_pts;
      s_col[k] = col[p];
      s_row[k] = row[p];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float dc = s_col[k] - px;
      const float dr = s_row[k] - py;
      const float w = 1.0f - (dc * dc + dr * dr) * r2_inv;
      if (w > 0.0f) acc += log1pf(-fminf(w, kWMax));
    }
  }
  acc_img[(cy0 + ly) * wp + cx0 + lx] = acc;
}

__global__ void splat_bwd_kernel(const float* __restrict__ col,
                                 const float* __restrict__ row, int n_pts,
                                 const int* __restrict__ entries,
                                 const int* __restrict__ cell_ids,
                                 const int* __restrict__ starts,
                                 const int* __restrict__ counts,
                                 int cs, int ncx, int wp, float r2_inv,
                                 const float* __restrict__ cot_img,
                                 float* __restrict__ g_sorted) {
  extern __shared__ float s_cot[];  // cs * cs
  const int a = blockIdx.x;
  const int cell = cell_ids[a];
  const int start = starts[a];
  const int count = counts[a];
  const int t = threadIdx.x;
  const int P = cs * cs;
  const int cx0 = (cell % ncx) * cs;
  const int cy0 = (cell / ncx) * cs;
  for (int k = t; k < P; k += blockDim.x) {
    s_cot[k] = cot_img[(cy0 + k / cs) * wp + cx0 + k % cs];
  }
  __syncthreads();
  for (int j = t; j < count; j += blockDim.x) {
    const int p = entries[start + j] % n_pts;
    const float c = col[p];
    const float r = row[p];
    float gc = 0.0f;
    float gr = 0.0f;
    for (int k = 0; k < P; ++k) {
      const float dc = c - static_cast<float>(cx0 + k % cs);
      const float dr = r - static_cast<float>(cy0 + k / cs);
      const float w = 1.0f - (dc * dc + dr * dr) * r2_inv;
      if (w > 0.0f && w < kWMax) {
        const float coef = 2.0f * r2_inv / (1.0f - w) * s_cot[k];
        gc += coef * dc;
        gr += coef * dr;
      }
    }
    g_sorted[2 * (start + j)] = gc;
    g_sorted[2 * (start + j) + 1] = gr;
  }
}

}  // namespace

extern "C" {

// acc_img: (hp, wp) float32, zero-filled by the caller; only the active
// cells' pixels are written.  Returns the launch's cudaError_t.
int srt_splat_fwd(const float* col, const float* row, int n_pts,
                  const int* entries, const int* cell_ids, const int* starts,
                  const int* counts, int n_active, int cs, int ncx, int wp,
                  float r2_inv, float* acc_img, void* stream) {
  if (n_active <= 0) return 0;
  splat_fwd_kernel<<<n_active, cs * cs, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      col, row, n_pts, entries, cell_ids, starts, counts, cs, ncx, wp,
      r2_inv, acc_img);
  return static_cast<int>(cudaGetLastError());
}

// cot_img: (hp, wp) float32 cotangent of the accumulator image.
// g_sorted: (n_entries, 2) float32, one (gcol, grow) per sorted entry.
int srt_splat_bwd(const float* col, const float* row, int n_pts,
                  const int* entries, const int* cell_ids, const int* starts,
                  const int* counts, int n_active, int cs, int ncx, int wp,
                  float r2_inv, const float* cot_img, float* g_sorted,
                  void* stream) {
  if (n_active <= 0) return 0;
  splat_bwd_kernel<<<n_active, kBwdThreads, cs * cs * sizeof(float),
                     static_cast<cudaStream_t>(stream)>>>(
      col, row, n_pts, entries, cell_ids, starts, counts, cs, ncx, wp,
      r2_inv, cot_img, g_sorted);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
