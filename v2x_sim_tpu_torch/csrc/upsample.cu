// The STPN decoder's stage input on Hopper (sm_90a): the 2x bilinear
// upsample of a bf16 map written straight into its concatenation with the
// skip map, and the upsample's gradient read straight out of the
// concatenation's gradient. One launch each way.
//
// Replaces no TPU kernel. The JAX package's decoder resizes with
// jax.image.resize and concatenates under XLA (v2x_sim_tpu/models/
// backbone.py), which XLA fuses there. In the port the same stage input
// ran as PyTorch operators (models/backbone.py::upsample_bilinear, then
// torch.cat): two interpolate passes, rows then columns, each writing its
// map to memory, then the cat reading the upsampled map back beside the
// skip; backward, the cat gradient's channel slice made contiguous, two
// zero-filled gradients and two scatters of bf16 atomic adds. The plain
// PyTorch version of each entry is beside its wrapper in
// ops/cuda/upsample_cu.py, which also holds the autograd Function.
//
// Maps are channels-last bf16: x (N, h, w, C), skip (N, 2h, 2w, Cs), the
// concatenation (N, 2h, 2w, C + Cs); C and Cs multiples of 8 (one 16-byte
// load holds 8 channels). align_corners=False at scale 2 reads each output
// row (and column) from two input rows with the fixed weights 0.25 and
// 0.75, the neighbour's index clamped to the map:
//   out[2k]     = 0.25 * in[max(k - 1, 0)] + 0.75 * in[k]
//   out[2k + 1] = 0.75 * in[k] + 0.25 * in[min(k + 1, n - 1)]
// (at an edge both weights fall on one row, which gives it exactly, as
// interpolate's clamp does). The weights are exact in bf16, so each
// product of a bf16 value is exact in float32 and a pass rounds once, to
// float32, then to bf16:
//   forward   R = bf16(rows pass of x), Y = bf16(columns pass of R): the
//             bits of interpolate's two passes in bf16 (rows, then
//             columns, as XLA contracts jax.image.resize's two matrices);
//   backward  the transpose, columns first: dR = bf16(columns pass^T of dY),
//             dx = bf16(rows pass^T of dR), each a float32 sum of four
//             products in a fixed order,
//             in[k] <- ((0.25 * o[max(2k - 1, 0)] + 0.75 * o[2k])
//                       + 0.75 * o[2k + 1]) + 0.25 * o[min(2k + 2, 2n - 1)],
//             rounded where XLA's transpose of the two contractions rounds.
//             No atomics and no zero fill: a run gives the same bits.
//
// What bounds it on this card: bytes. A thread does ~10 float32
// operations a channel against 10 (forward) or 5 (backward) bf16
// elements moved an input element. The design moves each byte of device
// memory once:
// - forward: a thread takes one input pixel x 8 channels (16-byte loads),
//   reads its 3 x 3 neighbourhood (the neighbours from L1/L2: device memory
//   reads x once), forms the rows pass's 6 values in registers, rounds
//   them, forms the 2 x 2 output pixels and writes them into the first C
//   channels of the concatenation; the same launch's other threads copy
//   the skip's 16-byte vectors into the channels after C. x is read once
//   (1 element), the upsampled half written once (4), the skip read and
//   written once (2 + 2): 9 C h w elements, where the operators moved
//   interpolate's 1 + 2 + 2 + 4, then cat's 4 + 2 + 6;
// - backward: a thread takes one input pixel x 8 channels, reads the 4 x 4
//   output gradients of its stencil from the first C channels of the
//   concatenation's gradient where they lie (pixel stride C + Cs, no
//   contiguous copy of the slice), forms the 4 intermediate rows' values,
//   rounds them, and writes dx once: 4 C h w elements read, C h w written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // bf16 channels in one 16-byte load
// Threads a launch at most: its index math is 32-bit.
constexpr int64_t kMaxItems = (int64_t{1} << 31) - kThreads;

__device__ __forceinline__ void unpack(const uint4& v, float f[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack(const float f[kVec]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// bf16(wa * a + wb * b) of 8 channels, the sum in float32.
__device__ __forceinline__ void lerp2(const float a[kVec], const float b[kVec], float wa,
                                      float wb, float out[kVec]) {
#pragma unroll
  for (int k = 0; k < kVec; ++k) out[k] = round_bf16(__fadd_rn(__fmul_rn(wa, a[k]),
                                                               __fmul_rn(wb, b[k])));
}

// ((0.25 a + 0.75 b) + 0.75 c) + 0.25 d of 8 channels in float32: an input
// row's (or column's) share of its four output rows, in the fixed order.
__device__ __forceinline__ void gather4(const float a[kVec], const float b[kVec],
                                        const float c[kVec], const float d[kVec],
                                        float out[kVec]) {
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    float s = __fadd_rn(__fmul_rn(0.25f, a[k]), __fmul_rn(0.75f, b[k]));
    s = __fadd_rn(s, __fmul_rn(0.75f, c[k]));
    out[k] = __fadd_rn(s, __fmul_rn(0.25f, d[k]));
  }
}

// Threads [0, up_items) each take one input pixel x 8 channels of x and
// write its 2 x 2 output pixels' first C channels; threads [up_items,
// up_items + skip_items) each copy one 16-byte vector of the skip into the
// channels after C of its output pixel.
__global__ void __launch_bounds__(kThreads)
upsample_cat_forward_kernel(const uint4* __restrict__ x, const uint4* __restrict__ skip,
                            uint4* __restrict__ out, unsigned up_items, unsigned skip_items,
                            int h, int w, int gx, int gs) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  const int64_t go = gx + gs;  // 16-byte vectors an output pixel
  if (t >= up_items) {
    const unsigned s = t - up_items;
    if (s >= skip_items) return;
    const unsigned pixel = s / gs, g = s - pixel * gs;
    out[pixel * go + gx + g] = __ldg(skip + s);
    return;
  }
  unsigned p = t / gx;
  const int g = static_cast<int>(t - p * gx);
  const int j = static_cast<int>(p % w);
  p /= w;
  const int i = static_cast<int>(p % h);
  const int64_t b = p / h;
  const int rows[3] = {max(i - 1, 0), i, min(i + 1, h - 1)};
  const int cols[3] = {max(j - 1, 0), j, min(j + 1, w - 1)};
  uint4 v[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int q = 0; q < 3; ++q)
      v[r][q] = __ldg(x + ((b * h + rows[r]) * w + cols[q]) * gx + g);
  // The rows pass at the three columns: output rows 2i (top) and 2i + 1.
  float top[3][kVec], bot[3][kVec];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    float above[kVec], here[kVec], below[kVec];
    unpack(v[0][q], above);
    unpack(v[1][q], here);
    unpack(v[2][q], below);
    lerp2(above, here, 0.25f, 0.75f, top[q]);
    lerp2(here, below, 0.75f, 0.25f, bot[q]);
  }
  // The columns pass: output columns 2j and 2j + 1 of both rows.
  const int64_t w2 = 2 * static_cast<int64_t>(w);
  const int64_t row0 = (b * 2 * h + 2 * i) * w2 + 2 * j;
  float o[kVec];
  lerp2(top[0], top[1], 0.25f, 0.75f, o);
  out[row0 * go + g] = pack(o);
  lerp2(top[1], top[2], 0.75f, 0.25f, o);
  out[(row0 + 1) * go + g] = pack(o);
  lerp2(bot[0], bot[1], 0.25f, 0.75f, o);
  out[(row0 + w2) * go + g] = pack(o);
  lerp2(bot[1], bot[2], 0.75f, 0.25f, o);
  out[(row0 + w2 + 1) * go + g] = pack(o);
}

// Each thread takes one input pixel x 8 channels of dx: the 4 x 4 output
// gradients of its stencil (the first C channels of dy, gy = (C + Cs) / 8
// vectors a pixel), the columns pass's transpose at each of the 4 rows,
// rounded, then the rows pass's transpose, rounded.
__global__ void __launch_bounds__(kThreads)
upsample_cat_backward_kernel(const uint4* __restrict__ dy, uint4* __restrict__ dx,
                             unsigned items, int h, int w, int gx, int gy) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= items) return;
  unsigned p = t / gx;
  const int g = static_cast<int>(t - p * gx);
  const int j = static_cast<int>(p % w);
  p /= w;
  const int i = static_cast<int>(p % h);
  const int64_t b = p / h;
  const int h2 = 2 * h, w2 = 2 * w;
  const int rows[4] = {max(2 * i - 1, 0), 2 * i, 2 * i + 1, min(2 * i + 2, h2 - 1)};
  const int cols[4] = {max(2 * j - 1, 0), 2 * j, 2 * j + 1, min(2 * j + 2, w2 - 1)};
  uint4 v[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[r][q] = __ldg(dy + ((b * h2 + rows[r]) * w2 + cols[q]) * gy + g);
  float d[4][kVec];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float f[4][kVec];
#pragma unroll
    for (int q = 0; q < 4; ++q) unpack(v[r][q], f[q]);
    gather4(f[0], f[1], f[2], f[3], d[r]);
#pragma unroll
    for (int k = 0; k < kVec; ++k) d[r][k] = round_bf16(d[r][k]);
  }
  float o[kVec];
  gather4(d[0], d[1], d[2], d[3], o);
  dx[t] = pack(o);  // dx is (N, h, w, C): thread t's vector
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

bool bad_map(int64_t n, int64_t h, int64_t w) { return n < 1 || h < 1 || w < 1; }

bool bad_channels(int64_t c) { return c < kVec || c % kVec != 0; }

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError() as
// an int (0 = launched), or cudaErrorInvalidValue for a shape it does not
// take. Pointers are the tensors' data: channels-last bf16 maps, 16-byte
// aligned.

// out (n, 2h, 2w, c + cs) = cat([upsample(x (n, h, w, c)), skip (n, 2h, 2w, cs)]).
int v2x_upsample_cat_forward(const void* x, const void* skip, void* out, int64_t n,
                             int64_t h, int64_t w, int64_t c, int64_t cs, void* stream) {
  if (bad_map(n, h, w) || bad_channels(c) || bad_channels(cs))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t up_items = n * h * w * (c / kVec);
  const int64_t skip_items = n * 4 * h * w * (cs / kVec);
  if (up_items + skip_items > kMaxItems) return static_cast<int>(cudaErrorInvalidValue);
  upsample_cat_forward_kernel<<<static_cast<unsigned>(ceil_div(up_items + skip_items, kThreads)),
                                kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(skip), static_cast<uint4*>(out),
      static_cast<unsigned>(up_items), static_cast<unsigned>(skip_items), static_cast<int>(h),
      static_cast<int>(w), static_cast<int>(c / kVec), static_cast<int>(cs / kVec));
  return static_cast<int>(cudaGetLastError());
}

// dx (n, h, w, c) = the upsample's transpose of dy's first c channels,
// dy (n, 2h, 2w, cy), cy >= c + 8 channels a pixel.
int v2x_upsample_cat_backward(const void* dy, void* dx, int64_t n, int64_t h, int64_t w,
                              int64_t c, int64_t cy, void* stream) {
  if (bad_map(n, h, w) || bad_channels(c) || bad_channels(cy) || cy <= c)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t items = n * h * w * (c / kVec);
  if (items > kMaxItems) return static_cast<int>(cudaErrorInvalidValue);
  upsample_cat_backward_kernel<<<static_cast<unsigned>(ceil_div(items, kThreads)), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(dy), static_cast<uint4*>(dx), static_cast<unsigned>(items),
      static_cast<int>(h), static_cast<int>(w), static_cast<int>(c / kVec),
      static_cast<int>(cy / kVec));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
