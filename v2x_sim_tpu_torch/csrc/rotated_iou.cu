// Exact rotated-box IoU on Hopper (sm_90a): a circle cull, then the clip
// of the pairs that pass, run densely from a per-block queue.
//
// Replaces the Pallas TPU kernels v2x_sim_tpu/ops/pallas/iou_pl.py::
// rotated_iou_pairs_soa (pallas_call at :149, body _iou_tile at :42) and
// rotated_iou_pairs_soa_periodic (pallas_call at :199, the same body with
// operand A's block index taken modulo the period), and computes what
// their body computes: corners of both quads, quad A clipped by B's 4
// edges, each stage's (kept vertex, crossing) stream compacted in order
// into at most 8 slots, then the shoelace area and
// inter / max(areaA + areaB - inter, 1e-8), 0 when fewer than 3 vertices
// remain. The plain PyTorch version is v2x_sim_tpu_torch/ops/iou_sh.py.
//
// What bounds it on this card: a clipped pair costs ~0.5k counted
// operations (below), most of them compares, selects and integer work,
// each one issued instruction, against 44 bytes moved; but the anchor
// assignment's pairs mostly lie far apart, and an exact 0 needs no clip.
// With the design below the periodic entry on the assignment's operands
// is bound by its bytes (20 a culled pair, 24 a clipped one). The design:
//
// 1. Cull. A pair whose circumscribed circles are separated,
//      |c_a - c_b|^2 > (r_a + r_b)^2 (1 + kCullRel) + kCullAbs,
//    r = sqrt(l^2 + w^2) / 2, is disjoint by a margin of at least
//    ~kCullRel/2 (r_a + r_b) + kCullAbs / (2 (r_a + r_b)) metres, far above
//    the rounding of the side tests. In the clip, every point of A that
//    survives B's first 3 edges then lies that margin outside the 4th, so
//    the clip ends with count 0 and IoU exactly 0, which the cull returns
//    directly. Boxes with a side under kCullMinSide (the zero-size padded
//    GT among them) or a non-finite size get an infinite radius: they are
//    never culled and go through the clip as before.
// 2. Queue. The periodic and matrix entries give a block a tile of pairs
//    (8 a thread in the periodic entry, 4 in the matrix). The cull phase
//    writes the zeros and appends the survivors' tile indices to a
//    shared-memory queue (one ballot, one popc and one shared atomic per
//    warp); after a barrier the clip phase runs the queue densely, so no
//    lane idles on a culled pair while others clip. One launch, no host
//    synchronisation. The aligned-pairs entry clips one pair a thread with
//    no cull, from field-major (5, N) operands: K1's literal counterpart,
//    which the main path no longer calls (5. replaced it there).
// 3. Clip. The polygon lives in this thread's slots in shared memory,
//    laid out [slot][threadIdx.x]: the row stride is a multiple of 32
//    words, so the bank is threadIdx.x % 32 whatever the slot, and two
//    buffers ping-pong between stages. A stage computes the side bits of
//    the count real vertices, and the stream's valid entries are written
//    straight to their positions: kept vertex i to
//    popc(kept below i) + popc(valid crossings below i), crossing i one
//    past kept vertex i; a position >= 8 is dropped, as the Pallas body's
//    compaction drops it. The duplicate padding of the Pallas body is
//    not stored: its slots emit nothing (vertices gated by count, edges of
//    length 0 never cross) and add exact zeros to the shoelace sum, so a
//    stage walks the count real vertices with the closing edge from the
//    last back to slot 0, in the same stream order.
// 4. The matrix entry stages each tile's row and column boxes (corners,
//    area, centre, radius) in shared memory once, so no pair evaluates
//    sinf/cosf.
// 5. The forced-anchor entry replaces K1 (iou_pl.py:121, pallas_call
//    :149) where the main path reached it: iou_pl.py:175 rotated_iou, from
//    the JAX package's ops/assign.py:269, each GT of the (B, M) padded set
//    against the K anchor shapes of its own BEV cell. The TPU wanted those
//    pairs as field-major (5, B*M*K) operands; built in PyTorch around the
//    aligned-pairs entry they took ~20 small launches (own cell, repeat,
//    two transposes, the anchor gather, argmax, amax, the mask). This entry
//    takes the assignment's own operands, (B, M, 5) GT, the (B, M) mask and
//    the (H, W, K, 5) anchor table, and does all of it in one launch:
//    kGroup = 8 lanes a GT, one (GT, anchor shape) pair a lane (K <= 8);
//    the GT row loaded once a group (5 lanes, shared by shuffles), its own
//    cell computed in every lane, the lane's anchor gathered from the
//    table, the IoU through the same make_quad/iou code as every entry,
//    then the first index of the maximum by a butterfly of __shfl_xor_sync
//    (the lower index wins ties, as torch.argmax and jnp.argmax), and
//    force = mask & (max > 0). Outputs own_iou (B, M, K), own_k, force and
//    the cell's flat index (B, M). What bounds it: at B=16 (96 x 32 GT, K
//    = 6) the work is 18,432 clips, ~7 M counted operations and ~0.56 MB
//    (the GT, the mask, the K anchors of each GT's cell in; the four
//    outputs), as chip_smoke.py::IouWork counts them: ~0.2 us at the
//    card's peaks, far under one launch's latency. So the design removes
//    launches and latency: one launch in place of ~20,
//    blocks of 128 threads (16 GT) so that 24,576 lanes make 192 blocks
//    over the 132 SMs where the aligned entry's 72 blocks of 256 left 60
//    SMs idle, and no pass over an intermediate in device memory.
//
// Built without --use_fast_math: parity with the plain version needs the
// precise sinf/cosf and IEEE division.
//
// Rounding. Every product that feeds a sum (the corners, the box areas,
// the clip's side tests, crossings and their points, the shoelace and the
// union) is written with __fmul_rn / __fadd_rn / __fsub_rn, which nvcc
// never contracts into FMAs, so each rounds on its own, in the plain
// version's order, and the kernel gives the plain version's values. Two
// places need it. Against a zero-size box (padded GT) the clip keeps the
// other box whole, inter is its shoelace area, the union l*w - inter is
// a few ulps, and the IoU inter / max(union, 1e-8) is that residual's
// reciprocal: an FMA in the corners, the shoelace or the union changes it
// by orders of magnitude. And where two boxes only touch, the clip leaves
// a degenerate polygon whose shoelace is rounding noise of ~1e-5 of the
// union: an FMA in the clip makes it 0 on one side and not on the other.
//
// Op count (each fp32 add/sub/mul/div/abs/compare/select or integer
// popc/and/add/compare = 1; ops/cuda/iou_cu.py holds these numbers, and
// chip_smoke.py counts a launch's work from its data with them):
//   a box's corners: sin, cos, 2 halvings, 4 x 8                       36
//   a box's cull radius: 2 mul, add, sqrt, half, 2 cmp, sel              8
//   the cull's test of a pair, radii given: centre deltas 2,
//     distance 3, sum 1, threshold 3, compare 1                         10
//   a clip stage that takes nv vertices, finds c side changes and
//     keeps k: edge vector 2, side tests 6 nv, per change (2 sub,
//     3 denom, 2 abs/cmp, 5 t_num, 1 div, 4 point, 5 place) 22 c,
//     per kept vertex (2 and, 2 popc, add, cmp) 6 k       2 + 6 nv + 22 c + 6 k
//   the area of nv final vertices: shoelace 4 nv, abs, half, select,
//     union 4, max, div                                            9 + 4 nv
// At the largest polygons that clipping two quads passes through (nv =
// 4, 5, 6, 7 into stages 1-4, two changes and nv kept each, 8 at the
// end) the clip costs 448 + 41 = 489. The periodic entry computes both
// boxes' radii for every pair and their corners for every pair it clips;
// the matrix entry stages corners and radii once a box of its tile; the
// aligned-pairs entry computes both boxes' corners for every pair, and so
// does the forced-anchor entry, whose work as counted is one GT's corners
// (its lanes repeat them rather than share them), its own cell (2 x sub,
// div, floor, 2 clamps; the flat index's mul and add: 12) and, a pair,
// the maximum's compare and select (2), plus the force test (2) a GT.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-8f;
constexpr int kSlots = 8;
constexpr int kThreads = 256;
// Pairs per thread in one block's tile: 8 for the periodic entry, 4 for
// the matrix (each measured fastest of 2, 4 and 8 on its main-path
// operands).
constexpr int kPerThread = 8;
constexpr int kTile = kPerThread * kThreads;
constexpr int kMatrixPerThread = 4;
constexpr int kMatrixTile = kMatrixPerThread * kThreads;
// Cull slack: relative on the squared radius sum, and absolute in m^2.
constexpr float kCullRel = 1.0f / 1024.0f;
constexpr float kCullAbs = 1e-3f;
// Boxes with a side under this (m) are never culled.
constexpr float kCullMinSide = 1e-2f;
// Matrix tile: at most kRows x kCols boxes staged, rows x cols <= kMatrixTile.
constexpr int kRows = 64;
constexpr int kCols = 128;

struct Quad {
  float x[4], y[4], area;
};

// Corners CCW from front-left, as the plain version's box_corners, each
// product and sum rounded on its own as there (no FMA contraction; see
// "Rounding" in the header).
__device__ __forceinline__ Quad make_quad(float x, float y, float l, float w, float yaw) {
  Quad q;
  const float c = cosf(yaw), s = sinf(yaw);
  const float hx = l * 0.5f, hy = w * 0.5f;
  const float lx[4] = {hx, -hx, -hx, hx};
  const float ly[4] = {hy, hy, -hy, -hy};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    q.x[i] = __fadd_rn(__fsub_rn(__fmul_rn(c, lx[i]), __fmul_rn(s, ly[i])), x);
    q.y[i] = __fadd_rn(__fadd_rn(__fmul_rn(s, lx[i]), __fmul_rn(c, ly[i])), y);
  }
  q.area = __fmul_rn(l, w);
  return q;
}

__device__ __forceinline__ float cull_radius(float l, float w) {
  return (l >= kCullMinSide && w >= kCullMinSide) ? 0.5f * sqrtf(l * l + w * w) : CUDART_INF_F;
}

// True when the circles of radius ra, rb about (ax, ay), (bx, by) are
// separated by the cull's margin (false for NaN or infinite operands).
__device__ __forceinline__ bool circles_apart(float ax, float ay, float ra, float bx, float by,
                                              float rb) {
  const float dx = ax - bx, dy = ay - by, s = ra + rb;
  return dx * dx + dy * dy > s * s * (1.0f + kCullRel) + kCullAbs;
}

// One clip stage: the polygon of `count` vertices in (px, py), clipped by
// the half-plane left of the edge (ea_x, ea_y) -> (eb_x, eb_y), into
// (qx, qy). Slot k of a buffer is at [k * kStride], kStride being the
// block's thread count. Returns the number of valid stream entries (those
// past slot 7 are dropped).
template <int kStride = kThreads>
__device__ __forceinline__ int clip_stage(float ea_x, float ea_y, float eb_x, float eb_y, int count,
                                          const float* px, const float* py, float* qx, float* qy) {
  const int nv = min(count, kSlots);
  const float ex = eb_x - ea_x, ey = eb_y - ea_y;
  unsigned in = 0u;  // bit i: vertex i on the inner side of the edge
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (i < nv) {
      const bool side = __fsub_rn(__fmul_rn(ex, py[i * kStride] - ea_y),
                                  __fmul_rn(ey, px[i * kStride] - ea_x)) >= -kEps;
      in |= static_cast<unsigned>(side) << i;
    }
  }
  // Bit i of `next`: the side of vertex (i + 1) % nv.
  const unsigned next = (in >> 1) | (nv > 0 ? (in & 1u) << (nv - 1) : 0u);
  unsigned crossed = 0u;  // bit i: stream entry 2i+1 (the crossing) is valid
  for (unsigned c = in ^ next; c != 0u; c &= c - 1u) {
    const int i = __ffs(c) - 1;
    const int j = i + 1 == nv ? 0 : i + 1;
    const float xi = px[i * kStride], yi = py[i * kStride];
    const float dx = px[j * kStride] - xi, dy = py[j * kStride] - yi;
    const float denom = __fsub_rn(__fmul_rn(ex, dy), __fmul_rn(ey, dx));
    if (fabsf(denom) > kEps) {
      const float t = __fsub_rn(__fmul_rn(ex, ea_y - yi), __fmul_rn(ey, ea_x - xi)) / denom;
      const int pos = __popc(in & ((2u << i) - 1u)) + __popc(crossed);
      if (pos < kSlots) {
        qx[pos * kStride] = __fadd_rn(xi, __fmul_rn(t, dx));
        qy[pos * kStride] = __fadd_rn(yi, __fmul_rn(t, dy));
      }
      crossed |= 1u << i;
    }
  }
  for (unsigned v = in; v != 0u; v &= v - 1u) {
    const int i = __ffs(v) - 1;
    const unsigned below = (1u << i) - 1u;
    const int pos = __popc(in & below) + __popc(crossed & below);
    if (pos < kSlots) {
      qx[pos * kStride] = px[i * kStride];
      qy[pos * kStride] = py[i * kStride];
    }
  }
  return __popc(in) + __popc(crossed);
}

// Area of quad a clipped by quad b's 4 edges. (px, py) and (qx, qy) are
// this thread's two slot buffers; the stages ping-pong between them.
template <int kStride = kThreads>
__device__ __forceinline__ float intersection(const Quad& a, const Quad& b, float* px, float* py,
                                              float* qx, float* qy) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    px[i * kStride] = a.x[i];
    py[i * kStride] = a.y[i];
  }
  int count = clip_stage<kStride>(b.x[0], b.y[0], b.x[1], b.y[1], 4, px, py, qx, qy);
  count = clip_stage<kStride>(b.x[1], b.y[1], b.x[2], b.y[2], count, qx, qy, px, py);
  count = clip_stage<kStride>(b.x[2], b.y[2], b.x[3], b.y[3], count, px, py, qx, qy);
  count = clip_stage<kStride>(b.x[3], b.y[3], b.x[0], b.y[0], count, qx, qy, px, py);

  const int nv = min(count, kSlots);
  float area2 = 0.0f;
  const float x0 = px[0], y0 = py[0];
  float xi = x0, yi = y0;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (i < nv) {
      const bool last = i + 1 == nv;
      const float xj = last ? x0 : px[((i + 1) % kSlots) * kStride];
      const float yj = last ? y0 : py[((i + 1) % kSlots) * kStride];
      area2 = __fadd_rn(area2, __fsub_rn(__fmul_rn(xi, yj), __fmul_rn(xj, yi)));
      xi = xj;
      yi = yj;
    }
  }
  return count >= 3 ? 0.5f * fabsf(area2) : 0.0f;
}

template <int kStride = kThreads>
__device__ __forceinline__ float iou(const Quad& a, const Quad& b, float* slots) {
  float* s = slots + threadIdx.x;
  const float inter = intersection<kStride>(a, b, s, s + kSlots * kStride, s + 2 * kSlots * kStride,
                                            s + 3 * kSlots * kStride);
  return inter / fmaxf(__fsub_rn(__fadd_rn(a.area, b.area), inter), kEps);
}

// One block's tile of `size` pairs: cull every pair (zeros written at
// once), queue the rest, then clip the queue densely. Src provides
// disjoint(q), quads(q, a, b) and store(q, v) for tile index q.
template <int kPer, class Src>
__device__ __forceinline__ void cull_then_clip(const Src& src, int size) {
  __shared__ float slots[4 * kSlots * kThreads];
  __shared__ unsigned short queue[kPer * kThreads];
  __shared__ int queued;
  if (threadIdx.x == 0) queued = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int q = r * kThreads + threadIdx.x;
    bool pass = false;
    if (q < size) {
      pass = !src.disjoint(q);
      if (!pass) src.store(q, 0.0f);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, pass);
    int base = 0;
    if (lane == 0 && ballot != 0u) base = atomicAdd(&queued, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (pass) queue[base + __popc(ballot & ((1u << lane) - 1u))] = static_cast<unsigned short>(q);
  }
  __syncthreads();
  const int total = queued;
  for (int k = threadIdx.x; k < total; k += kThreads) {
    const int q = queue[k];
    Quad a, b;
    src.quads(q, a, b);
    src.store(q, iou(a, b, slots));
  }
}

// (a) Aligned pairs, field-major: field f of pair p at soa[f * n + p], one
// pair a thread.
__global__ void __launch_bounds__(kThreads)
rotated_iou_pairs_kernel(const float* __restrict__ a, const float* __restrict__ b,
                         float* __restrict__ out, int64_t n) {
  __shared__ float slots[4 * kSlots * kThreads];
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n) return;
  const Quad qa = make_quad(a[p], a[n + p], a[2 * n + p], a[3 * n + p], a[4 * n + p]);
  const Quad qb = make_quad(b[p], b[n + p], b[2 * n + p], b[3 * n + p], b[4 * n + p]);
  out[p] = iou(qa, qb, slots);
}

// (b) Batched matrix: a (G, N, 5) x b (G, M, 5) -> out (G, N, M). A block
// takes group g, a tile of rows and a tile of columns, staged once.
enum Field { kX, kY, kR, kArea, kCx, kCy = kCx + 4, kFields = kCy + 4 };

struct MatrixSrc {
  float (*rows)[kRows];  // [field][row]
  float (*cols)[kCols];
  float* out;  // the tile's (0, 0) entry
  int64_t m;
  int nc;  // columns in this tile
  __device__ __forceinline__ bool disjoint(int q) const {
    const int r = q / nc, c = q - r * nc;
    return circles_apart(rows[kX][r], rows[kY][r], rows[kR][r], cols[kX][c], cols[kY][c], cols[kR][c]);
  }
  __device__ __forceinline__ void quads(int q, Quad& qa, Quad& qb) const {
    const int r = q / nc, c = q - r * nc;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa.x[i] = rows[kCx + i][r];
      qa.y[i] = rows[kCy + i][r];
      qb.x[i] = cols[kCx + i][c];
      qb.y[i] = cols[kCy + i][c];
    }
    qa.area = rows[kArea][r];
    qb.area = cols[kArea][c];
  }
  __device__ __forceinline__ void store(int q, float v) const {
    const int r = q / nc, c = q - r * nc;
    out[r * m + c] = v;
  }
};

template <int kCap>
__device__ __forceinline__ void stage_box(float (*dst)[kCap], int k, const float* box) {
  const Quad q = make_quad(box[0], box[1], box[2], box[3], box[4]);
  dst[kX][k] = box[0];
  dst[kY][k] = box[1];
  dst[kR][k] = cull_radius(box[2], box[3]);
  dst[kArea][k] = q.area;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dst[kCx + i][k] = q.x[i];
    dst[kCy + i][k] = q.y[i];
  }
}

__global__ void __launch_bounds__(kThreads)
rotated_iou_matrix_kernel(const float* __restrict__ a, const float* __restrict__ b,
                          float* __restrict__ out, int64_t n, int64_t m, int tr, int tc,
                          int64_t row_tiles, int64_t col_tiles) {
  __shared__ float rows[kFields][kRows];
  __shared__ float cols[kFields][kCols];
  const int64_t blk = blockIdx.x;
  const int64_t ct = blk % col_tiles, rest = blk / col_tiles;
  const int64_t rt = rest % row_tiles, g = rest / row_tiles;
  const int64_t row0 = rt * tr, col0 = ct * tc;
  const int nr = static_cast<int>(n - row0 < tr ? n - row0 : tr);
  const int nc = static_cast<int>(m - col0 < tc ? m - col0 : tc);
  for (int k = threadIdx.x; k < nr + nc; k += kThreads) {
    if (k < nr) stage_box<kRows>(rows, k, a + (g * n + row0 + k) * 5);
    else stage_box<kCols>(cols, k - nr, b + (g * m + col0 + k - nr) * 5);
  }
  __syncthreads();
  cull_then_clip<kMatrixPerThread>(MatrixSrc{rows, cols, out + (g * n + row0) * m + col0, m, nc},
                                   nr * nc);
}

// (c) Periodic pairs, field-major: pair p takes box A from column p % n of
// the (5, n) table a and box B from column p of the (5, nb) array b.
struct PeriodicSrc {
  const float* a;
  const float* b;
  float* out;
  int64_t n, nb, base, base_mod;  // base_mod = base % n
  __device__ __forceinline__ int64_t col(int q) const {
    const int64_t i = base_mod + q;  // < n + kTile
    return i < n ? i : (n >= kTile ? i - n : i % n);
  }
  __device__ __forceinline__ bool disjoint(int q) const {
    const int64_t i = col(q), p = base + q;
    return circles_apart(a[i], a[n + i], cull_radius(a[2 * n + i], a[3 * n + i]), b[p], b[nb + p],
                      cull_radius(b[2 * nb + p], b[3 * nb + p]));
  }
  __device__ __forceinline__ void quads(int q, Quad& qa, Quad& qb) const {
    const int64_t i = col(q), p = base + q;
    qa = make_quad(a[i], a[n + i], a[2 * n + i], a[3 * n + i], a[4 * n + i]);
    qb = make_quad(b[p], b[nb + p], b[2 * nb + p], b[3 * nb + p], b[4 * nb + p]);
  }
  __device__ __forceinline__ void store(int q, float v) const { out[base + q] = v; }
};

__global__ void __launch_bounds__(kThreads)
rotated_iou_pairs_periodic_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                  float* __restrict__ out, int64_t n, int64_t nb) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t left = nb - base;
  cull_then_clip<kPerThread>(PeriodicSrc{a, b, out, n, nb, base, base % n},
                             static_cast<int>(left < kTile ? left : kTile));
}

// (d) The forced-anchor test on the assignment's own operands: GT g of the
// (G, 5) array against the K anchors of its own BEV cell in the (H, W, K,
// 5) table, one (GT, anchor shape) pair a lane, kGroup lanes a GT.
constexpr int kGroup = 8;
constexpr int kForcedThreads = 128;

// True when (v, i) comes first in torch.argmax's order: the larger value
// (NaN the largest), the lower index on ties.
__device__ __forceinline__ bool argmax_first(float v, int i, float u, int j) {
  const bool vn = isnan(v), un = isnan(u);
  if (vn != un) return vn;
  if (vn || v == u) return i < j;
  return v > u;
}

// The own cell along one axis, as ops/assign.py::own_cell computes it on
// the CPU: floor((c - lo) / size) in float32 with IEEE division, clamped
// into [0, cells - 1] (in float, so that a NaN lands in cell 0 as torch's
// cast and clamp put it).
__device__ __forceinline__ int64_t own_index(float c, float lo, float size, int64_t cells) {
  const float f = floorf(__fdiv_rn(__fsub_rn(c, lo), size));
  return static_cast<int64_t>(fminf(fmaxf(f, 0.0f), static_cast<float>(cells - 1)));
}

__global__ void __launch_bounds__(kForcedThreads)
rotated_iou_forced_anchor_kernel(const float* __restrict__ gt, const bool* __restrict__ gt_mask,
                                 const float* __restrict__ anchors, float x0, float y0, float vx,
                                 float vy, int64_t h, int64_t w, int k, int64_t gts,
                                 float* __restrict__ own_iou, int64_t* __restrict__ own_k,
                                 bool* __restrict__ force, int64_t* __restrict__ cell) {
  __shared__ float slots[4 * kSlots * kForcedThreads];
  const int64_t g = (static_cast<int64_t>(blockIdx.x) * kForcedThreads + threadIdx.x) / kGroup;
  const int lane = threadIdx.x % kGroup;  // the anchor shape
  const bool live = g < gts;              // the same for the whole group
  // The GT row, loaded once a group: lane f < 5 reads field f.
  const float field = live && lane < 5 ? gt[g * 5 + lane] : 0.0f;
  float box[5];
#pragma unroll
  for (int f = 0; f < 5; ++f) box[f] = __shfl_sync(0xffffffffu, field, f, kGroup);
  const int64_t own = own_index(box[0], x0, vx, h) * w + own_index(box[1], y0, vy, w);
  float v = -CUDART_INF_F;
  if (live && lane < k) {
    const float* a = anchors + (own * k + lane) * 5;
    v = iou<kForcedThreads>(make_quad(box[0], box[1], box[2], box[3], box[4]),
                            make_quad(a[0], a[1], a[2], a[3], a[4]), slots);
    own_iou[g * k + lane] = v;
  }
  // The group's first maximum: a butterfly over the kGroup lanes, every
  // step keeping the pair that comes first (the order is total, so each
  // lane ends with the group's argmax). Idle lanes hold -inf and an index
  // >= k, so they never come first.
  int best = lane;
#pragma unroll
  for (int step = kGroup / 2; step > 0; step /= 2) {
    const float u = __shfl_xor_sync(0xffffffffu, v, step, kGroup);
    const int j = __shfl_xor_sync(0xffffffffu, best, step, kGroup);
    if (argmax_first(u, j, v, best)) {
      v = u;
      best = j;
    }
  }
  if (live && lane == 0) {
    own_k[g] = best;
    force[g] = gt_mask[g] && v > 0.0f;
    cell[g] = own;
  }
}

// Nothing: a launch's own cost, timed beside the entries in chip_smoke.py.
__global__ void empty_kernel() {}

int64_t ceil_div(int64_t x, int64_t y) { return (x + y - 1) / y; }

constexpr int64_t kMaxBlocks = 2147483647;
constexpr int kGridTooLarge = static_cast<int>(cudaErrorInvalidConfiguration);

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError()
// as an int (0 = launched), or cudaErrorInvalidConfiguration for a grid
// of more than 2^31 - 1 blocks. The caller guarantees n, g*n*m, nb >= 1,
// and nb a multiple of n.
int v2x_rotated_iou_pairs(const float* a, const float* b, float* out, int64_t n, void* stream) {
  const int64_t blocks = ceil_div(n, kThreads);
  if (blocks > kMaxBlocks) return kGridTooLarge;
  rotated_iou_pairs_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(a, b, out, n);
  return static_cast<int>(cudaGetLastError());
}

int v2x_rotated_iou_matrix(const float* a, const float* b, float* out, int64_t g, int64_t n,
                           int64_t m, void* stream) {
  const int tc = static_cast<int>(m < kCols ? m : kCols);
  const int tr = kMatrixTile / tc < kRows ? kMatrixTile / tc : kRows;
  const int64_t row_tiles = ceil_div(n, tr), col_tiles = ceil_div(m, tc);
  const int64_t blocks = g * row_tiles * col_tiles;
  if (blocks > kMaxBlocks) return kGridTooLarge;
  rotated_iou_matrix_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(a, b, out, n, m, tr, tc,
                                                                   row_tiles, col_tiles);
  return static_cast<int>(cudaGetLastError());
}

int v2x_rotated_iou_pairs_periodic(const float* a, const float* b, float* out, int64_t n,
                                   int64_t nb, void* stream) {
  const int64_t blocks = ceil_div(nb, kTile);
  if (blocks > kMaxBlocks) return kGridTooLarge;
  rotated_iou_pairs_periodic_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(a, b, out, n, nb);
  return static_cast<int>(cudaGetLastError());
}

// gts = B * M GT rows, 1 <= k <= 8; own_iou (gts, k), own_k, force, cell (gts,).
int v2x_forced_anchor(const float* gt, const bool* gt_mask, const float* anchors, float x0,
                      float y0, float vx, float vy, int64_t h, int64_t w, int k, int64_t gts,
                      float* own_iou, int64_t* own_k, bool* force, int64_t* cell, void* stream) {
  const int64_t blocks = ceil_div(gts * kGroup, kForcedThreads);
  if (blocks > kMaxBlocks) return kGridTooLarge;
  rotated_iou_forced_anchor_kernel<<<static_cast<unsigned>(blocks), kForcedThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      gt, gt_mask, anchors, x0, y0, vx, vy, h, w, k, gts, own_iou, own_k, force, cell);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on `blocks` blocks of the forced-anchor entry's size.
int v2x_empty_launch(int64_t blocks, void* stream) {
  if (blocks < 1 || blocks > kMaxBlocks) return kGridTooLarge;
  empty_kernel<<<static_cast<unsigned>(blocks), kForcedThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
