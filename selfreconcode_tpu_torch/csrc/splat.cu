// Point-splat soft-mask kernels for Hopper (sm_90a), plain C interface.
//
// Forward: replaces `splat_fwd_cells_idx` / `_splat_fwd_kernel_idx`
// (selfreconcode_tpu/ops/pallas_raster.py:203-258).  For every pixel of an
// active cs x cs image cell it sums
//     acc = sum log1p(-clip(1 - d^2 / r^2, 0, 1 - 1e-5))
// over every splat binned to that cell, and writes the soft mask
// 1 - exp(acc) (or acc itself, for the dense-cell form) into the image.
//
// Backward: replaces `splat_bwd_cells_idx` / `_splat_bwd_kernel_idx`
// (pallas_raster.py:261-311).  With the cotangent cot = -g * (1 - mask)
// of the accumulator (formed here from the mask's gradient g and the
// mask), it sums for every binned entry
//     cot * 2 r^-2 / (1 - w) * (dc, dr)
// over the cell's pixels with 0 < w < 1 - 1e-5 and writes the pair at the
// entry's id (ids are unique, so no atomics; the caller sums each point's
// <= 4 entry slots in a fixed order).
//
// Both walk the sorted slot list of ops/rasterize.py::splat_bins: entry ids
// grouped by cell in ascending cell order, with each entry's cell beside it,
// the valid entries first and their number in device memory (`count`).  The
// list has a length the host knows without reading the device (4 slots a
// point), which sizes the grids; a warp whose chunk starts at or past the
// count returns at once, so the chunks, segments and partial sums are those
// of the valid entries alone.  An entry id is k * n_pts + point with k < 4;
// the dense form passes slot ids < n_pts (k = 0).  `decode` covers both
// without `%`.  The per-cell tables (run starts and lengths) hold every cell
// of the grid, empty ones with length 0.
//
// What bounds them on this card.  Little: at the fine stage's shape
// (1080^2, r = 2.2 px, ~750k entries) the bytes (points, entries, the mask
// image) take ~3-4 us at the memory rate and the arithmetic less.  What set
// the time of the first port (one block per active cell, one thread per
// pixel or candidate) was the spread of the work: cells hold from one entry
// at the silhouette's rim to ~1000, so the fullest cell's serial scan set
// the tail, most lanes idled, and every pixel paid a divergent log1p per
// candidate.  The design:
//  - The sorted entry list itself is cut into chunks of kChunk = 32
//    entries, one per warp, kWarps warps per block, so every warp has the
//    same work whatever the cells look like: a chunk may hold the ends of
//    several short cells (segments), and a long cell spreads over many
//    warps.  A lane loads one entry with coalesced reads of the entry list.
//  - Forward: the chunk's points go to shared memory.  For each 32-pixel
//    band of rows of a segment's cell the lanes take one pixel each and
//    walk only the segment's entries whose bbox reaches the band (a warp
//    ballot of each entry's bands, so the test costs nothing per pixel).
//    The sum of log1p(-w) is formed as the log of the product of the
//    (1 - w), logged whenever the product falls below kFlush and once at
//    the end: one log per pixel and segment instead of one per pair, with
//    no divergent branch in the loop.  A segment that holds its whole cell
//    writes the mask 1 - exp(acc) at once; a cell that crosses a chunk edge
//    leaves one partial sum per chunk, and a second small pass adds them in
//    chunk order.  No atomics: the mask is the same bit for bit on every
//    launch.
//  - Backward: a lane walks only the pixels of its entry's bbox that lie in
//    its cell (<= 5 x 5 at r = 2.2 px, not 64), as one loop, so a warp runs
//    as many turns as its largest box.  The segments' cotangents are formed
//    from g and the mask and staged in shared memory a few cells at a time.
//    The division by 1 - w is a correctly rounded reciprocal (__frcp_rn)
//    and a multiply.
// There is no per-cell capacity anywhere: no splat is ever dropped.
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;          // entries per warp (one per lane)
constexpr int kWarps = 4;           // warps per block
constexpr float kFlush = 1e-30f;    // forward: log the product below this
constexpr int kStage = 256;         // cotangent floats staged per warp
constexpr float kWMax = 1.0f - 1e-5f;
constexpr unsigned kAll = 0xffffffffu;

// w = 1 - (dc^2 + dr^2) r^-2 with every operation rounded on its own, as
// the plain version rounds it (the compiler would otherwise contract it into
// FMAs): the backward's coefficient 2 r^-2 / (1 - w) jumps where w crosses
// 0 and 1 - 1e-5, so both sides must see the same w there.
__device__ __forceinline__ float weight(float dc, float dr, float r2_inv) {
  return __fsub_rn(1.0f, __fmul_rn(__fadd_rn(__fmul_rn(dc, dc),
                                             __fmul_rn(dr, dr)),
                                   r2_inv));
}

// point of an entry id k * n + p, k < 4
__device__ __forceinline__ int decode(int id, int n) {
  const int k = (id >= n) + (id >= 2 * n) + (id >= 3 * n);
  return id - k * n;
}

// The chunk of this warp: its lane's entry (point col/row, cell; cell -1
// past the end) and the lanes where a cell's segment begins.
struct Chunk {
  int base, n, cell, id;
  float c, r;
  unsigned heads;
};

__device__ __forceinline__ Chunk load_chunk(const float* __restrict__ col,
                                            const float* __restrict__ row,
                                            int n_pts,
                                            const int* __restrict__ entries,
                                            const int* __restrict__ ecell,
                                            int m, int chunk, int lane) {
  Chunk ch;
  ch.base = chunk * kChunk;
  ch.n = min(kChunk, m - ch.base);
  ch.cell = -1;
  ch.id = 0;
  ch.c = 0.0f;
  ch.r = 0.0f;
  if (lane < ch.n) {
    ch.id = entries[ch.base + lane];
    ch.cell = ecell[ch.base + lane];
    const int p = decode(ch.id, n_pts);
    ch.c = col[p];
    ch.r = row[p];
  }
  const int up = __shfl_up_sync(kAll, ch.cell, 1);
  ch.heads = __ballot_sync(kAll, lane < ch.n && (lane == 0 || up != ch.cell));
  return ch;
}

// The pixels of a splat's bbox (centre +- r_box) that lie in its cell.
struct Box {
  int x0, x1, y0, y1;
};

__device__ __forceinline__ Box cell_box(float c, float r, int cx0, int cy0,
                                        int cs, float r_box) {
  Box b;
  b.x0 = static_cast<int>(fmaxf(static_cast<float>(cx0), ceilf(c - r_box)));
  b.x1 = static_cast<int>(
      fminf(static_cast<float>(cx0 + cs - 1), floorf(c + r_box)));
  b.y0 = static_cast<int>(fmaxf(static_cast<float>(cy0), ceilf(r - r_box)));
  b.y1 = static_cast<int>(
      fminf(static_cast<float>(cy0 + cs - 1), floorf(r + r_box)));
  return b;
}

__global__ void __launch_bounds__(kWarps * 32)
splat_fwd_kernel(const float* __restrict__ col, const float* __restrict__ row,
                 int n_pts, const int* __restrict__ entries,
                 const int* __restrict__ ecell, const int* __restrict__ count,
                 int cs, int ncx, int out_h, int out_w, float r2_inv,
                 float r_box, int to_mask, float* __restrict__ partial,
                 float* __restrict__ out) {
  __shared__ float2 s_cr[kWarps][kChunk];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kWarps + warp;
  const int m = *count;
  if (chunk * kChunk >= m) return;
  const Chunk ch = load_chunk(col, row, n_pts, entries, ecell, m, chunk, lane);
  s_cr[warp][lane] = make_float2(ch.c, ch.r);
  const int prev = ch.base > 0 ? ecell[ch.base - 1] : -1;
  const int next = ch.base + ch.n < m ? ecell[ch.base + ch.n] : -1;
  const int my_cy = ch.cell / ncx;
  const int my_cx0 = (ch.cell - my_cy * ncx) * cs;
  // a band is `band` cell rows, one pixel per lane; the bands this lane's
  // entry reaches (its bbox rows in the cell)
  const int band = 32 / cs;
  const int lq = lane / cs, lr = lane - lq * cs;
  unsigned my_bands = 0;
  if (lane < ch.n) {
    const Box box = cell_box(ch.c, ch.r, my_cx0, my_cy * cs, cs, r_box);
    for (int y = box.y0; y <= box.y1; ++y)
      my_bands |= 1u << ((y - my_cy * cs) / band);
  }
  __syncwarp();
  const int P = cs * cs;
  for (int yb = 0, b = 0; yb < cs; yb += band, ++b) {
    const unsigned reach = __ballot_sync(kAll, (my_bands >> b) & 1u);
    const int k = yb * cs + lane;           // this lane's pixel in the cell
    const bool pix_ok = lane < band * cs && yb + lq < cs;
    unsigned heads = ch.heads;
    while (heads) {
      const int s0 = __ffs(heads) - 1;
      heads &= heads - 1;
      const int s1 = heads ? __ffs(heads) - 1 : ch.n;
      const int cx0 = __shfl_sync(kAll, my_cx0, s0);
      const int cy0 = __shfl_sync(kAll, my_cy, s0) * cs;
      const float px = static_cast<float>(cx0 + lr);
      const float py = static_cast<float>(cy0 + yb + lq);
      // sum of log1p(-w) over the segment's entries that reach the band, as
      // the log of the product of the (1 - w): one log per pixel and
      // segment, flushed before the product could underflow
      unsigned todo =
          reach & (0xffffffffu >> (32 - s1)) & ~((1u << s0) - 1u);
      float prod = 1.0f, acc = 0.0f;
      while (todo) {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        const float2 cr = s_cr[warp][j];
        const float dc = cr.x - px;
        const float dr = cr.y - py;
        const float w = weight(dc, dr, r2_inv);
        prod *= 1.0f - fminf(fmaxf(w, 0.0f), kWMax);
        if (prod < kFlush) {
          acc += logf(prod);
          prod = 1.0f;
        }
      }
      acc += logf(prod);
      const int cell = __shfl_sync(kAll, ch.cell, s0);
      if (!pix_ok) continue;
      if ((s0 == 0 && prev == cell) || (s1 == ch.n && next == cell)) {
        partial[(2 * chunk + (s0 == 0 ? 0 : 1)) * P + k] = acc;
      } else {
        const int x = cx0 + lr, y = cy0 + yb + lq;
        if (x < out_w && y < out_h)
          out[y * out_w + x] = to_mask ? 1.0f - expf(acc) : acc;
      }
    }
  }
}

// Cells that cross a chunk edge: add their chunks' partial sums in chunk
// order.  One thread per (cell of the table, pixel); an empty cell and a
// cell within one chunk were written already.
__global__ void splat_fwd_merge_kernel(const int* __restrict__ starts,
                                       const int* __restrict__ counts,
                                       int n_cells, int cs, int ncx,
                                       int out_h, int out_w, int to_mask,
                                       const float* __restrict__ partial,
                                       float* __restrict__ out) {
  const int P = cs * cs;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int cell = t / P;
  if (cell >= n_cells) return;
  const int k = t - cell * P;
  const int s = starts[cell];
  const int c0 = s / kChunk;
  const int c1 = (s + counts[cell] - 1) / kChunk;
  if (c1 <= c0) return;   // within one chunk (or empty): written already
  float acc = partial[(2 * c0 + (s == c0 * kChunk ? 0 : 1)) * P + k];
  for (int c = c0 + 1; c <= c1; ++c) acc += partial[2 * c * P + k];
  const int cy = cell / ncx;
  const int ly = k / cs;
  const int x = (cell - cy * ncx) * cs + k - ly * cs, y = cy * cs + ly;
  if (x < out_w && y < out_h)
    out[y * out_w + x] = to_mask ? 1.0f - expf(acc) : acc;
}

__global__ void __launch_bounds__(kWarps * 32)
splat_bwd_kernel(const float* __restrict__ col, const float* __restrict__ row,
                 int n_pts, const int* __restrict__ entries,
                 const int* __restrict__ ecell, const int* __restrict__ count,
                 int cs, int ncx, int h, int w_img, float r2_inv, float r_box,
                 const float* __restrict__ g_img,
                 const float* __restrict__ mask_img,
                 float* __restrict__ g_slots) {
  extern __shared__ float s_cot[];       // kWarps x stage
  __shared__ int s_cell[kWarps][kChunk];  // each segment's cell
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kWarps + warp;
  const int m = *count;
  if (chunk * kChunk >= m) return;
  const int P = cs * cs;
  const int stage = max(kStage, P);
  const int per = stage / P;             // segments staged per round
  float* cot = s_cot + warp * stage;
  const Chunk ch = load_chunk(col, row, n_pts, entries, ecell, m, chunk, lane);
  const int nseg = __popc(ch.heads);
  const int seg = __popc(ch.heads & (0xffffffffu >> (31 - lane))) - 1;
  if ((ch.heads >> lane) & 1u) s_cell[warp][seg] = ch.cell;
  const int cy = ch.cell / ncx;
  const int cx0 = (ch.cell - cy * ncx) * cs;
  const int cy0 = cy * cs;
  const float two_r2 = 2.0f * r2_inv;
  float gc = 0.0f, gr = 0.0f;
  for (int r0 = 0; r0 < nseg; r0 += per) {
    __syncwarp();
    const int nst = min(per, nseg - r0) * P;
    for (int t = lane; t < nst; t += 32) {
      const int q = t / P;
      const int k = t - q * P;
      const int cell = s_cell[warp][r0 + q];
      const int qy = cell / ncx;
      const int ly = k / cs;
      const int x = (cell - qy * ncx) * cs + k - ly * cs, y = qy * cs + ly;
      float v = 0.0f;
      if (x < w_img && y < h) {
        const int pix = y * w_img + x;
        v = mask_img ? -g_img[pix] * (1.0f - mask_img[pix]) : g_img[pix];
      }
      cot[t] = v;
    }
    __syncwarp();
    if (lane >= ch.n || seg < r0 || seg >= r0 + per) continue;
    const float* cc = cot + (seg - r0) * P;
    // the bbox's pixels in the cell, row by row, as one loop (so that a
    // warp runs as many turns as its largest box has pixels)
    const Box box = cell_box(ch.c, ch.r, cx0, cy0, cs, r_box);
    const int nx = box.x1 - box.x0 + 1;
    const int cnt =
        nx > 0 && box.y1 >= box.y0 ? (box.y1 - box.y0 + 1) * nx : 0;
    int x = box.x0, y = box.y0;
    for (int t = 0; t < cnt; ++t) {
      const float dc = ch.c - static_cast<float>(x);
      const float dr = ch.r - static_cast<float>(y);
      const float w = weight(dc, dr, r2_inv);
      if (w > 0.0f && w < kWMax) {
        const float coef =
            two_r2 * __frcp_rn(1.0f - w) * cc[(y - cy0) * cs + x - cx0];
        gc += coef * dc;
        gr += coef * dr;
      }
      if (++x > box.x1) {
        x = box.x0;
        ++y;
      }
    }
  }
  if (lane < ch.n) {
    g_slots[2 * ch.id] = gc;
    g_slots[2 * ch.id + 1] = gr;
  }
}

}  // namespace

extern "C" {

// Entries per chunk; the plain version's chunk split must use the same.
int srt_splat_chunk() { return kChunk; }

// entries, ecell: m_max slots, the first *count of them valid (count is in
// device memory; m_max sizes the grid).  starts, counts: the n_cells cells'
// runs.  out: (out_h, out_w) float32 holding zeros; the pixels of the cells
// with entries are written (1 - exp(acc) when to_mask, else acc).  partial:
// scratch of ceil(m_max / kChunk) * 2 * cs * cs floats.  Two launches: the
// chunks, then the merge of cells that cross a chunk edge.  Returns the
// cudaError_t.
int srt_splat_fwd(const float* col, const float* row, int n_pts,
                  const int* entries, const int* ecell, int m_max,
                  const int* count, const int* starts, const int* counts,
                  int n_cells, int cs, int ncx, int out_h, int out_w,
                  float r2_inv, float r_box, int to_mask, float* partial,
                  float* out, void* stream) {
  if (m_max <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (m_max + kChunk - 1) / kChunk;
  splat_fwd_kernel<<<(chunks + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
      col, row, n_pts, entries, ecell, count, cs, ncx, out_h, out_w, r2_inv,
      r_box, to_mask, partial, out);
  const long long threads = static_cast<long long>(n_cells) * cs * cs;
  splat_fwd_merge_kernel<<<static_cast<int>((threads + 255) / 256), 256, 0,
                           st>>>(starts, counts, n_cells, cs, ncx, out_h,
                                 out_w, to_mask, partial, out);
  return static_cast<int>(cudaGetLastError());
}

// entries, ecell, count: as srt_splat_fwd's.  g_img, mask_img: (h, w)
// float32, the mask's gradient and the mask; with mask_img null, g_img is
// the accumulator's cotangent itself.  g_slots: (n_slots, 2) float32
// holding zeros; the pair of entry id e is written at row e.  Returns the
// launch's cudaError_t.
int srt_splat_bwd(const float* col, const float* row, int n_pts,
                  const int* entries, const int* ecell, int m_max,
                  const int* count, int cs, int ncx, int h, int w,
                  float r2_inv, float r_box, const float* g_img,
                  const float* mask_img, float* g_slots, void* stream) {
  if (m_max <= 0) return 0;
  const int chunks = (m_max + kChunk - 1) / kChunk;
  const int stage = cs * cs > kStage ? cs * cs : kStage;
  splat_bwd_kernel<<<(chunks + kWarps - 1) / kWarps, kWarps * 32,
                     kWarps * stage * sizeof(float),
                     static_cast<cudaStream_t>(stream)>>>(
      col, row, n_pts, entries, ecell, count, cs, ncx, h, w, r2_inv, r_box,
      g_img, mask_img, g_slots);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
