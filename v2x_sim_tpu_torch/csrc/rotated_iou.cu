// Exact rotated-box IoU on Hopper (sm_90a), one thread per box pair.
//
// Replaces the Pallas TPU kernels v2x_sim_tpu/ops/pallas/iou_pl.py::
// rotated_iou_pairs_soa (pallas_call at :149, body _iou_tile at :42) and
// rotated_iou_pairs_soa_periodic (pallas_call at :199, the same body with
// operand A's block index taken modulo the period), and repeats their
// arithmetic step for step: corners of both quads, quad A
// clipped by B's 4 edges in an 8-slot polygon padded by repeating its
// last vertex, a 16-entry (kept vertex, crossing) stream per clip stage
// compacted back to 8 slots in order, then the shoelace area and
// inter / max(areaA + areaB - inter, 1e-8), 0 when fewer than 3 vertices
// remain. The plain PyTorch version is v2x_sim_tpu_torch/ops/iou_sh.py.
//
// What bounds it on this card: scalar fp32 arithmetic, not memory. A pair
// reads 40 bytes (two boxes) and writes 4, but costs about 3.1k scalar
// operations (the count below, taken from this source), so at the
// H100's 67 TFLOP/s of non-tensor-core fp32 (700 W) the work takes at
// least 47 ps a pair, ~3.6x the 13 ps that its 44 bytes take at 3.35 TB/s. Tensor cores, TMA and
// shared-memory tiling buy nothing here. The design keeps the whole clip
// pipeline in registers: every loop below has a compile-time trip count
// and is fully unrolled, and the compaction writes slot k through a
// select chain (never a run-time array index, which would put the polygon
// in local memory). Neighbouring threads take neighbouring pairs, so the
// SoA loads of entry points (a) and (c) coalesce; in entry point (b) a
// warp shares box i and reads 32 consecutive boxes j. Entry point (c)
// reads the anchor table once per repeat: at production geometry it is
// 5 x 393,216 floats (7.9 MB), which stays in the 50 MB L2 across the B
// repeats, so only operand B and the output cross HBM and no shared-memory
// staging is needed. Its one 64-bit remainder per pair is integer work,
// not counted below.
//
// Built without --use_fast_math: parity with the plain version needs the
// precise sinf/cosf and IEEE division.
//
// Op count per pair (each fp32 add/sub/mul/div/abs/compare/select = 1):
//   corners, 2 boxes:            2 x (sin, cos, 2 halvings, 4 x 8)  =   72
//   per clip stage (x4):
//     edge vector                                                 2
//     side tests, 8 x (2 sub, 2 mul, 1 sub, 1 cmp)               48
//     crossings, 8 x (2 sub, 3 denom, 2 abs/cmp, 5 t_num,
//                     1 sel, 1 div, 4 point, 2 flags)             160
//     compaction, 16 x (8 x (cmp, and, 2 sel) + 1 add)           528
//     tail fill, 7 x (cmp, 2 sel)                                  21
//                                                     stage total 759
//   shoelace 8 x 4, abs, half, select, union 4, max, div            41
//   total                                     72 + 4 x 759 + 41 = 3149

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-8f;
constexpr int kSlots = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ void corners(float x, float y, float l, float w, float yaw,
                                        float cx[4], float cy[4]) {
  const float c = cosf(yaw), s = sinf(yaw);
  const float hx = l * 0.5f, hy = w * 0.5f;
  const float lx[4] = {hx, -hx, -hx, hx};
  const float ly[4] = {hy, hy, -hy, -hy};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    cx[i] = c * lx[i] - s * ly[i] + x;
    cy[i] = s * lx[i] + c * ly[i] + y;
  }
}

__device__ __forceinline__ float pair_iou(float ax, float ay, float al, float aw, float ayaw,
                                          float bx, float by, float bl, float bw, float byaw) {
  float cax[4], cay[4], cbx[4], cby[4];
  corners(ax, ay, al, aw, ayaw, cax, cay);
  corners(bx, by, bl, bw, byaw, cbx, cby);

  float px[kSlots], py[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    px[i] = cax[i < 4 ? i : 3];
    py[i] = cay[i < 4 ? i : 3];
  }
  int count = 4;

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float ea_x = cbx[e], ea_y = cby[e];
    const float ex = cbx[(e + 1) % 4] - ea_x, ey = cby[(e + 1) % 4] - ea_y;
    bool side[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) side[i] = ex * (py[i] - ea_y) - ey * (px[i] - ea_x) >= -kEps;

    float ox[kSlots], oy[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) ox[k] = oy[k] = 0.0f;
    int pos = 0;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int j = (i + 1) % kSlots;
      const float dx = px[j] - px[i], dy = py[j] - py[i];
      const float denom = ex * dy - ey * dx;
      const bool ok = fabsf(denom) > kEps;
      const float t_num = ex * (ea_y - py[i]) - ey * (ea_x - px[i]);
      const float t = t_num / (ok ? denom : 1.0f);
      // Stream entry 2i: the vertex, gated by the padding slots.
      // Stream entry 2i+1: the crossing of edge i -> i+1, ungated.
      const float sx[2] = {px[i], px[i] + t * dx};
      const float sy[2] = {py[i], py[i] + t * dy};
      const bool sv[2] = {side[i] && (count > i), (side[i] != side[j]) && ok};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          const bool hit = sv[u] && (pos == k);
          ox[k] = hit ? sx[u] : ox[k];
          oy[k] = hit ? sy[u] : oy[k];
        }
        pos += sv[u] ? 1 : 0;
      }
    }
    // Duplicate-fill the tail so padding stays degenerate.
#pragma unroll
    for (int k = 1; k < kSlots; ++k) {
      const bool filled = pos > k;
      ox[k] = filled ? ox[k] : ox[k - 1];
      oy[k] = filled ? oy[k] : oy[k - 1];
    }
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      px[k] = ox[k];
      py[k] = oy[k];
    }
    count = pos;
  }

  float area2 = 0.0f;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int j = (i + 1) % kSlots;
    area2 = area2 + (px[i] * py[j] - px[j] * py[i]);
  }
  const float inter = count >= 3 ? 0.5f * fabsf(area2) : 0.0f;
  const float uni = al * aw + bl * bw - inter;
  return inter / fmaxf(uni, kEps);
}

// (a) Aligned pairs, field-major: field f of pair p at soa[f * n + p].
__global__ void __launch_bounds__(kThreads)
rotated_iou_pairs_kernel(const float* __restrict__ a, const float* __restrict__ b,
                         float* __restrict__ out, int64_t n) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  out[p] = pair_iou(a[p], a[n + p], a[2 * n + p], a[3 * n + p], a[4 * n + p],
                    b[p], b[n + p], b[2 * n + p], b[3 * n + p], b[4 * n + p]);
}

// (b) Batched matrix: a (G, N, 5) x b (G, M, 5) -> out (G, N, M); the
// thread for (g, i, j) reads box i of a[g] and box j of b[g] directly.
__global__ void __launch_bounds__(kThreads)
rotated_iou_matrix_kernel(const float* __restrict__ a, const float* __restrict__ b,
                          float* __restrict__ out, int64_t g, int64_t n, int64_t m) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= g * n * m) return;
  const int64_t j = q % m;
  const int64_t gi = q / m;  // g * n + i
  const float* ba = a + gi * 5;
  const float* bb = b + ((gi / n) * m + j) * 5;
  out[q] = pair_iou(ba[0], ba[1], ba[2], ba[3], ba[4], bb[0], bb[1], bb[2], bb[3], bb[4]);
}

// (c) Periodic pairs, field-major: pair p takes box A from column p % n of
// the (5, n) table a and box B from column p of the (5, nb) array b.
__global__ void __launch_bounds__(kThreads)
rotated_iou_pairs_periodic_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                  float* __restrict__ out, int64_t n, int64_t nb) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= nb) return;
  const int64_t i = p % n;
  out[p] = pair_iou(a[i], a[n + i], a[2 * n + i], a[3 * n + i], a[4 * n + i],
                    b[p], b[nb + p], b[2 * nb + p], b[3 * nb + p], b[4 * nb + p]);
}

unsigned int blocks_for(int64_t total) {
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError()
// as an int (0 = launched). The caller guarantees n, g*n*m, nb in
// [1, 2^31 * 256), and nb a multiple of n.
int v2x_rotated_iou_pairs(const float* a, const float* b, float* out, int64_t n, void* stream) {
  rotated_iou_pairs_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, n);
  return static_cast<int>(cudaGetLastError());
}

int v2x_rotated_iou_matrix(const float* a, const float* b, float* out, int64_t g, int64_t n,
                           int64_t m, void* stream) {
  rotated_iou_matrix_kernel<<<blocks_for(g * n * m), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(a, b, out, g, n, m);
  return static_cast<int>(cudaGetLastError());
}

int v2x_rotated_iou_pairs_periodic(const float* a, const float* b, float* out, int64_t n,
                                   int64_t nb, void* stream) {
  rotated_iou_pairs_periodic_kernel<<<blocks_for(nb), kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(a, b, out, n, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
