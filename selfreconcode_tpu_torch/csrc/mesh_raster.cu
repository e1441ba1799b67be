// Mesh-fragment rasterizer for Hopper (sm_90a), plain C interface.
//
// Replaces `mesh_fragments_cells` / `_mesh_kernel`
// (selfreconcode_tpu/ops/pallas_raster.py:57-136).  For every pixel of an
// active cs x cs image cell it finds, over every triangle binned to that
// cell, the nearest perspective-correct depth
//     z = 1 / max(b0/z0 + b1/z1 + b2/z2, 1e-12)
// among the triangles whose edge functions put the pixel inside (b_i >= 0,
// |area| > 1e-12), and writes z, the winner's face id and its normalized
// perspective-correct barycentrics (b_i/z_i) / sum straight into the
// (H, W) images.  A pixel no triangle covers keeps the caller's fill
// (z = +inf, face = -1, bary = 0).
//
// Tie rule: each thread scans its cell's run in sorted-entry order and keeps
// a new minimum only on a strict `<`, so among equal depths the first entry
// wins.  That is jnp.argmin's first-minimum rule over the JAX candidate
// table, whose slots follow the same stable sort.
//
// What bounds it on this card: arithmetic.  A cell reads each candidate's
// record once (40 bytes) and evaluates it at cs*cs pixels (~30 flops and
// four divides each).  The design: one block per ACTIVE cell (cells no
// triangle touches are never launched), one thread per pixel, the cell's run
// of face records staged through shared memory in tiles and read by every
// thread as a broadcast; the winner's barycentrics are recomputed once
// after the scan, so the loop carries only (z, face).  There is no
// per-cell capacity: a block walks its cell's whole run, so no triangle is
// ever dropped (the TPU kernel's cap was a VMEM and static-shape bound).
//
// Built with -fmad=false: every product and sum rounds on its own, as in
// the plain PyTorch version, so the two agree bit for bit.
#include <cuda_runtime.h>

#include <math_constants.h>

namespace {

constexpr int kTile = 128;   // face records staged per shared-memory tile
constexpr int kRec = 9;      // p0x p0y p1x p1y p2x p2y z0 z1 z2

struct Bary {
  float b0, b1, b2;
  bool inside;
};

__device__ __forceinline__ Bary edge_bary(const float* r, float X, float Y) {
  const float ax = r[0], ay = r[1], bx = r[2], by = r[3], cx = r[4],
              cy = r[5];
  const float area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
  const float w0 = (cx - bx) * (Y - by) - (cy - by) * (X - bx);
  const float w1 = (ax - cx) * (Y - cy) - (ay - cy) * (X - cx);
  const float w2 = (bx - ax) * (Y - ay) - (by - ay) * (X - ax);
  const bool ok_area = fabsf(area) > 1e-12f;
  const float denom = ok_area ? area : 1.0f;
  Bary b;
  b.b0 = w0 / denom;
  b.b1 = w1 / denom;
  b.b2 = w2 / denom;
  b.inside = ok_area && b.b0 >= 0.0f && b.b1 >= 0.0f && b.b2 >= 0.0f;
  return b;
}

__global__ void mesh_raster_kernel(const float* __restrict__ rec, int n_faces,
                                   const int* __restrict__ entries,
                                   const int* __restrict__ cell_ids,
                                   const int* __restrict__ starts,
                                   const int* __restrict__ counts, int cs,
                                   int ncx, int H, int W,
                                   float* __restrict__ zbuf,
                                   int* __restrict__ face_img,
                                   float* __restrict__ bary_img) {
  __shared__ float s_rec[kTile * kRec];
  __shared__ int s_fid[kTile];
  const int a = blockIdx.x;
  const int cell = cell_ids[a];
  const int start = starts[a];
  const int count = counts[a];
  const int t = threadIdx.x;
  const int x = (cell % ncx) * cs + t % cs;
  const int y = (cell / ncx) * cs + t / cs;
  const float X = static_cast<float>(x);
  const float Y = static_cast<float>(y);
  float best_z = CUDART_INF_F;
  int best_f = -1;
  for (int base = 0; base < count; base += kTile) {
    const int n = min(kTile, count - base);
    __syncthreads();
    for (int k = t; k < n; k += blockDim.x) {
      const int f = entries[start + base + k] % n_faces;
      s_fid[k] = f;
#pragma unroll
      for (int j = 0; j < kRec; ++j) s_rec[k * kRec + j] = rec[f * kRec + j];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float* r = s_rec + k * kRec;
      const Bary b = edge_bary(r, X, Y);
      if (!b.inside) continue;
      const float inv_z = b.b0 / r[6] + b.b1 / r[7] + b.b2 / r[8];
      const float z = 1.0f / fmaxf(inv_z, 1e-12f);
      if (z < best_z) {
        best_z = z;
        best_f = s_fid[k];
      }
    }
  }
  if (x >= W || y >= H) return;
  const int pix = y * W + x;
  if (best_f < 0) {
    zbuf[pix] = CUDART_INF_F;
    face_img[pix] = -1;
    bary_img[3 * pix] = 0.0f;
    bary_img[3 * pix + 1] = 0.0f;
    bary_img[3 * pix + 2] = 0.0f;
    return;
  }
  const float* r = rec + best_f * kRec;
  const Bary b = edge_bary(r, X, Y);
  const float t0 = b.b0 / r[6];
  const float t1 = b.b1 / r[7];
  const float t2 = b.b2 / r[8];
  const float ts = fmaxf(t0 + t1 + t2, 1e-12f);
  zbuf[pix] = best_z;
  face_img[pix] = best_f;
  bary_img[3 * pix] = t0 / ts;
  bary_img[3 * pix + 1] = t1 / ts;
  bary_img[3 * pix + 2] = t2 / ts;
}

}  // namespace

extern "C" {

// rec: (n_faces, 9) float32 face records; entries/cell_ids/starts/counts:
// the sorted binning (ops/rasterize.py::cell_bins).  zbuf (H, W) float32,
// face (H, W) int32 and bary (H, W, 3) float32 hold the fill on entry; only
// the active cells' pixels are written.  Returns the launch's cudaError_t.
int srt_mesh_raster(const float* rec, int n_faces, const int* entries,
                    const int* cell_ids, const int* starts, const int* counts,
                    int n_active, int cs, int ncx, int H, int W, float* zbuf,
                    int* face, float* bary, void* stream) {
  if (n_active <= 0) return 0;
  mesh_raster_kernel<<<n_active, cs * cs, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      rec, n_faces, entries, cell_ids, starts, counts, cs, ncx, H, W, zbuf,
      face, bary);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
