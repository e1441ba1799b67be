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
// Design: one block per ACTIVE cell, entry-parallel.  The block stages a
// chunk of its cell's sorted run (one entry per thread: the face decoded
// with compares, its record loaded once, its edge vectors and area formed
// once) and clips the face's pixel box (`pixel_box`) to the cell and the
// image.  The chunk's (entry, box pixel) pairs are then split evenly over
// the threads, each walking a contiguous share from pixel to pixel and from
// entry to entry, so neither a full cell nor a wide face is one thread's
// serial walk, and no pixel outside a face's box is tested.  A pair that
// passes the inside test (`staged_inside`: the plain version's b_i >= 0
// without its divides, exactly) queues up in its warp; 32 at a time go
// through the depth's divides on a full warp.  A pixel keeps one 64-bit key
// in shared memory, z's float bits above the entry's run position, updated
// with atomicMin: z is positive and finite, so the least key is the least
// z and, among equal z, the first entry in run order -- jnp.argmin's
// first-minimum rule over the JAX candidate table, whose slots follow the
// same stable sort.  A minimum over a total order does not depend on the
// order of the updates, so every launch gives the same bits.  After the
// run, the block decodes each key to its entry, recomputes the winner's
// barycentrics and writes z, face and bary.  There is no per-cell capacity:
// a block walks its cell's whole run, so no triangle is dropped.
//
// Uneven cells: a cell holds from one entry to ~2,500.  The launch takes
// 256 threads a block when the cells hold 192 entries or more on average
// (few, full cells), else 128 (many small cells, more blocks resident), and
// the wrapper hands the cells over fullest first, so the longest blocks
// start first and do not set the tail.
//
// What bounds it on this card: bytes (the face records of the binned
// faces, the entries, the per-cell arrays, and z / face / bary on the
// active cells' pixels; chip_smoke.py, `mesh_work` and `compare_mesh`);
// the (entry, box pixel) tests are a few µs of float32 work.
//
// Built with -fmad=false: every product and sum rounds on its own, as in
// the plain PyTorch version, so the two agree bit for bit.  `pixel_box`,
// `staged_inside` and `pack_key` mirror ops/mesh_kernels.py's `pixel_box`,
// `inside_by_signs` and `pack_key` line by line.
#include <cuda_runtime.h>

#include <math_constants.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxCell = 32;         // largest cs: 1,024 keys, 8 KB
constexpr int kRec = 9;              // p0x p0y p1x p1y p2x p2y z0 z1 z2
constexpr float kU = 0x1p-24f;       // float32 unit roundoff
constexpr float kTiny = 1e-37f;      // the edge functions' underflow
constexpr float kSlack = 1e-3f;      // px, the box's own rounding
constexpr unsigned long long kEmpty = 0x7fffffffffffffffull;

struct Edges {
  float area, w0, w1, w2;
};

__device__ __forceinline__ Edges edges(const float* r, float X, float Y) {
  const float ax = r[0], ay = r[1], bx = r[2], by = r[3], cx = r[4],
              cy = r[5];
  Edges e;
  e.area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
  e.w0 = (cx - bx) * (Y - by) - (cy - by) * (X - bx);
  e.w1 = (ax - cx) * (Y - cy) - (ay - cy) * (X - cx);
  e.w2 = (bx - ax) * (Y - ay) - (by - ay) * (X - ax);
  return e;
}

struct Bary {
  float b0, b1, b2;
  bool inside;
};

__device__ __forceinline__ Bary bary_of(const Edges& e) {
  const bool ok_area = fabsf(e.area) > 1e-12f;
  const float denom = ok_area ? e.area : 1.0f;
  Bary b;
  b.b0 = e.w0 / denom;
  b.b1 = e.w1 / denom;
  b.b2 = e.w2 / denom;
  b.inside = ok_area && b.b0 >= 0.0f && b.b1 >= 0.0f && b.b2 >= 0.0f;
  return b;
}

__device__ __forceinline__ Bary edge_bary(const float* r, float X, float Y) {
  return bary_of(edges(r, X, Y));
}

// inclusive prefix sum of v over the block (s_warp: one int per warp)
__device__ __forceinline__ int block_scan(int v, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kAll, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += s_warp[w];
  return v;
}

// The pixels (inclusive, integer-valued floats) outside which edge_bary
// puts nothing inside: the bbox widened by R.  The margin's argument is in
// ops/mesh_kernels.py::pixel_box; R = inf for a sliver whose area is not
// above its rounding error, R = -inf (empty) where edge_bary refuses the
// face.
struct Box {
  float x_lo, x_hi, y_lo, y_hi;
};

__device__ __forceinline__ Box pixel_box(const float* r) {
  const float ax = r[0], ay = r[1], bx = r[2], by = r[3], cx = r[4],
              cy = r[5];
  const float x0 = fminf(fminf(ax, bx), cx);
  const float x1 = fmaxf(fmaxf(ax, bx), cx);
  const float y0 = fminf(fminf(ay, by), cy);
  const float y1 = fmaxf(fmaxf(ay, by), cy);
  const float ext = fmaxf(x1 - x0, y1 - y0);
  const float e = fmaxf(fmaxf(fabsf(cx - bx) + fabsf(cy - by),
                              fabsf(ax - cx) + fabsf(ay - cy)),
                        fabsf(bx - ax) + fabsf(by - ay));
  const float t1 = (bx - ax) * (cy - ay);
  const float t2 = (by - ay) * (cx - ax);
  const float area = t1 - t2;
  const float a_lo = fabsf(area) - 8.0f * kU * (fabsf(t1) + fabsf(t2));
  const float q = 4.0f * kU * e * ext / a_lo;
  const float nu = kTiny * (1.0f + fabsf(area)) / a_lo;
  float R = (a_lo > 0.0f && q <= 0.125f) ? 4.0f * ext * (q + nu) + kSlack
                                         : CUDART_INF_F;
  if (!(fabsf(area) > 1e-12f)) R = -CUDART_INF_F;
  return {ceilf(x0 - R), floorf(x1 + R), ceilf(y0 - R), floorf(y1 + R)};
}

__device__ __forceinline__ unsigned long long pack_key(float z, int pos) {
  return (static_cast<unsigned long long>(__float_as_uint(z)) << 32) |
         static_cast<unsigned>(pos);
}

// face of an entry id k * n + f, k < 4 (ops/binning.py)
__device__ __forceinline__ int decode(int id, int n) {
  const int k = (id >= n) + (id >= 2 * n) + (id >= 3 * n);
  return id - k * n;
}

constexpr int kEnt = 19;        // floats per staged entry (18, padded)

// Stages a record in shared memory: its six screen coordinates, the edge
// vectors and the area as edges() rounds them, the three depths, and the
// two constants of staged_inside: k = sign(area) 2^100 (NaN where bary_of
// refuses the area or it is not finite) and -|area| 2^-50.
__device__ __forceinline__ void stage(float* s, const float* r) {
  const float ax = r[0], ay = r[1], bx = r[2], by = r[3], cx = r[4],
              cy = r[5];
  const float area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
  const float a = fabsf(area);
  const float v[18] = {ax,      ay,      bx,      by,      cx,      cy,
                       cx - bx, cy - by, ax - cx, ay - cy, bx - ax, by - ay,
                       area,    r[6],    r[7],    r[8],
                       a > 1e-12f && a < CUDART_INF_F ? copysignf(0x1p100f, area)
                                                      : CUDART_NAN_F,
                       -(a * 0x1p-50f)};
#pragma unroll
  for (int c = 0; c < 18; ++c) s[c] = v[c];
}

// edges() at (X, Y) from a staged entry: the same operations, the edge
// vectors' differences taken once per entry
__device__ __forceinline__ Edges staged_edges(const float* s, float X,
                                              float Y) {
  Edges e;
  e.area = s[12];
  e.w0 = s[6] * (Y - s[3]) - s[7] * (X - s[2]);
  e.w1 = s[8] * (Y - s[5]) - s[9] * (X - s[4]);
  e.w2 = s[10] * (Y - s[1]) - s[11] * (X - s[0]);
  return e;
}

// bary_of(e).inside without its divides, exactly.  w / area < 0 in float32
// when the signs differ and |w / area| > 2^-150 (at or below it the
// quotient rounds to -0, which passes b >= 0).  For finite, nonzero-enough
// area, w k = +-|w| 2^100 and -|area| 2^-50 are exact scalings (an
// overflow to inf still compares right), so b >= 0 is w k >= -|area|
// 2^-50; a NaN w fails it, as its NaN b fails b >= 0.  Other areas (k NaN)
// take bary_of itself.
__device__ __forceinline__ bool staged_inside(const float* s, const Edges& e) {
  const float k = s[16], lim = s[17];
  if (k != k) return bary_of(e).inside;
  return e.w0 * k >= lim && e.w1 * k >= lim && e.w2 * k >= lim;
}

// kThreads threads; at most 40 registers each, so 1,536 threads stay
// resident on an SM.
template <int kThreads>
__global__ void __launch_bounds__(kThreads, 1536 / kThreads)
    mesh_raster_kernel(const float* __restrict__ rec, int n_faces,
                       const int* __restrict__ entries,
                       const int* __restrict__ cell_ids,
                       const int* __restrict__ starts,
                       const int* __restrict__ counts, int cs, int ncx, int H,
                       int W, float* __restrict__ zbuf,
                       int* __restrict__ face_img,
                       float* __restrict__ bary_img) {
  extern __shared__ unsigned long long s_key[];   // cs * cs keys
  __shared__ float s_ent[kThreads * kEnt];   // the chunk's staged entries
  __shared__ int4 s_box[kThreads];           // lx, ly of the box, nx, pixels
  __shared__ int s_incl[kThreads];           // inclusive sums of box pixels
  __shared__ int s_pos[kThreads];            // run positions
  __shared__ int s_face[kThreads];           // face ids
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_queue[kThreads / 32][2 * 32];   // inside pairs per warp
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  int* queue = s_queue[tid >> 5];
  const int cell = cell_ids[blockIdx.x];
  const int start = starts[blockIdx.x];
  const int count = counts[blockIdx.x];
  const int cx0 = (cell % ncx) * cs;
  const int cy0 = (cell / ncx) * cs;
  // the cell's pixels inside the image, as floats for the box clip
  const float fx0 = static_cast<float>(cx0);
  const float fy0 = static_cast<float>(cy0);
  const float fx1 = static_cast<float>(min(cx0 + cs, W) - 1);
  const float fy1 = static_cast<float>(min(cy0 + cs, H) - 1);
  const int P = cs * cs;
  for (int p = tid; p < P; p += kThreads) s_key[p] = kEmpty;

  // An inside pair (staged entry j, cell pixel lx, ly): the plain
  // version's barycentrics and depth, then the key.
  auto settle = [&](int item) {
    const int j = item >> 10;
    const int lx = item & 31;
    const int ly = (item >> 5) & 31;
    const float* s = s_ent + j * kEnt;
    const Bary w = bary_of(staged_edges(s, static_cast<float>(cx0 + lx),
                                        static_cast<float>(cy0 + ly)));
    const float inv_z = w.b0 / s[13] + w.b1 / s[14] + w.b2 / s[15];
    const float z = 1.0f / fmaxf(inv_z, 1e-12f);
    if (!(z < CUDART_INF_F)) return;   // never wins, as in a strict <
    atomicMin(&s_key[ly * cs + lx], pack_key(z, s_pos[j]));
  };

  // Chunks of kThreads entries: each thread stages one entry and finds its
  // pixel box in the cell.  Every thread then walks an equal, contiguous
  // share of the chunk's (entry, box pixel) pairs, so a wide face's box is
  // not one lane's serial walk; a walk steps from pixel to pixel and from
  // entry to entry without a search.  A pair that passes the inside test
  // queues up in its warp; 32 at a time go through the depth's divides on
  // a full warp.
  for (int base = 0; base < count; base += kThreads) {
    int n = 0;
    const int pos = start + base + tid;
    if (base + tid < count) {
      const int f = decode(entries[pos], n_faces);
      float r[kRec];
#pragma unroll
      for (int j = 0; j < kRec; ++j) r[j] = __ldg(rec + f * kRec + j);
      stage(s_ent + tid * kEnt, r);
      const Box b = pixel_box(r);
      // clip to the cell in float (an infinite or NaN side takes the cell's)
      const int x_lo = static_cast<int>(fminf(fmaxf(b.x_lo, fx0), fx1 + 1.0f));
      const int y_lo = static_cast<int>(fminf(fmaxf(b.y_lo, fy0), fy1 + 1.0f));
      const int x_hi = static_cast<int>(fmaxf(fminf(b.x_hi, fx1), fx0 - 1.0f));
      const int y_hi = static_cast<int>(fmaxf(fminf(b.y_hi, fy1), fy0 - 1.0f));
      const int nx = max(x_hi - x_lo + 1, 0);
      n = nx * max(y_hi - y_lo + 1, 0);
      s_box[tid] = make_int4(x_lo - cx0, y_lo - cy0, nx, n);
      s_pos[tid] = pos;
      s_face[tid] = f;
    }
    s_incl[tid] = block_scan(n, s_warp);
    __syncthreads();
    const int total = s_incl[kThreads - 1];
    const int share = (total + kThreads - 1) / kThreads;
    int t = min(tid * share, total);
    const int t_end = min(t + share, total);
    int j = 0, lx = 0, ly = 0, x_lo = 0, x_end = 0, rem = 0;
    if (t < t_end) {
      // the chunk's entry holding pair t: the first j with s_incl[j] > t
#pragma unroll
      for (int step = kThreads / 2; step > 0; step >>= 1)
        if (s_incl[j + step - 1] <= t) j += step;
      const int4 bx = s_box[j];
      const int local = t - (s_incl[j] - bx.w);
      // local / nx, exact: (local + 1/2) / nx is >= 1/64 from an integer
      const int q = __float2int_rz((static_cast<float>(local) + 0.5f) /
                                   static_cast<float>(bx.z));
      x_lo = bx.x;
      x_end = bx.x + bx.z;
      lx = bx.x + local - q * bx.z;
      ly = bx.y + q;
      rem = bx.w - local;
    }
    int queued = 0;   // the same in every lane of the warp
    for (int i = 0; i < share; ++i) {
      bool in = false;
      int item = 0;
      if (t < t_end) {
        const float* s = s_ent + j * kEnt;
        in = staged_inside(s, staged_edges(s, static_cast<float>(cx0 + lx),
                                           static_cast<float>(cy0 + ly)));
        item = (j << 10) | (ly << 5) | lx;
        if (++t < t_end) {
          if (--rem == 0) {   // on to the next entry with pixels
            do ++j; while (s_box[j].w == 0);
            const int4 bx = s_box[j];
            x_lo = lx = bx.x;
            x_end = bx.x + bx.z;
            ly = bx.y;
            rem = bx.w;
          } else if (++lx == x_end) {
            lx = x_lo;
            ++ly;
          }
        }
      }
      const unsigned mask = __ballot_sync(kAll, in);
      if (in) queue[queued + __popc(mask & ((1u << lane) - 1))] = item;
      queued += __popc(mask);
      __syncwarp();
      if (queued >= 32) {
        queued -= 32;
        settle(queue[queued + lane]);
        __syncwarp();
      }
    }
    if (lane < queued) settle(queue[lane]);
    __syncthreads();   // the next chunk overwrites the staging and queues
  }

  const bool one_chunk = count <= kThreads;   // s_ent, s_face hold the run
  for (int p = tid; p < P; p += kThreads) {
    const int x = cx0 + p % cs;
    const int y = cy0 + p / cs;
    if (x >= W || y >= H) continue;
    const int pix = y * W + x;
    const unsigned long long key = s_key[p];
    if (key == kEmpty) {
      zbuf[pix] = CUDART_INF_F;
      face_img[pix] = -1;
      bary_img[3 * pix] = 0.0f;
      bary_img[3 * pix + 1] = 0.0f;
      bary_img[3 * pix + 2] = 0.0f;
      continue;
    }
    const int pos = static_cast<int>(static_cast<unsigned>(key));
    int f;
    Bary b;
    float z0, z1, z2;
    if (one_chunk) {
      const float* s = s_ent + (pos - start) * kEnt;
      f = s_face[pos - start];
      b = bary_of(staged_edges(s, static_cast<float>(x),
                               static_cast<float>(y)));
      z0 = s[13];
      z1 = s[14];
      z2 = s[15];
    } else {
      f = decode(entries[pos], n_faces);
      const float* r = rec + f * kRec;
      b = edge_bary(r, static_cast<float>(x), static_cast<float>(y));
      z0 = r[6];
      z1 = r[7];
      z2 = r[8];
    }
    const float t0 = b.b0 / z0;
    const float t1 = b.b1 / z1;
    const float t2 = b.b2 / z2;
    const float ts = fmaxf(t0 + t1 + t2, 1e-12f);
    zbuf[pix] = __uint_as_float(static_cast<unsigned>(key >> 32));
    face_img[pix] = f;
    bary_img[3 * pix] = t0 / ts;
    bary_img[3 * pix + 1] = t1 / ts;
    bary_img[3 * pix + 2] = t2 / ts;
  }
}

}  // namespace

extern "C" {

// rec: (n_faces, 9) float32 face records; entries (n_entries) and
// cell_ids/starts/counts (n_active): the sorted binning
// (ops/rasterize.py::cell_bins), its active cells in any order.  zbuf
// (H, W) float32, face (H, W) int32 and bary (H, W, 3) float32 hold the
// fill on entry; only the active cells' pixels are written.  Returns the
// launch's cudaError_t.
int srt_mesh_raster(const float* rec, int n_faces, const int* entries,
                    int n_entries, const int* cell_ids, const int* starts,
                    const int* counts, int n_active, int cs, int ncx, int H,
                    int W, float* zbuf, int* face, float* bary,
                    void* stream) {
  if (cs < 1 || cs > kMaxCell) return static_cast<int>(cudaErrorInvalidValue);
  if (n_active <= 0) return 0;
  const size_t keys = cs * cs * sizeof(unsigned long long);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_entries >= 192LL * n_active)
    mesh_raster_kernel<256><<<n_active, 256, keys, st>>>(
        rec, n_faces, entries, cell_ids, starts, counts, cs, ncx, H, W, zbuf,
        face, bary);
  else
    mesh_raster_kernel<128><<<n_active, 128, keys, st>>>(
        rec, n_faces, entries, cell_ids, starts, counts, cs, ncx, H, W, zbuf,
        face, bary);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
