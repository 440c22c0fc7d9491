// Train-mode BatchNorm + ReLU of bf16 maps on Hopper (sm_90a): four passes
// over channels-last rows, float32 statistics and arithmetic, one rounding.
//
// Replaces no TPU kernel. The JAX package's BatchNorm is flax's
// nn.BatchNorm under XLA (v2x_sim_tpu/models/backbone.py), which XLA
// fuses there. In the port the same function ran as PyTorch operators
// (models/backbone.py::_bn on a bf16 map, then torch.relu): the map cast
// to float32, two means, the normalisation broadcast over a channels-last
// map in float32, the rounding, the ReLU, and autograd's float32 replay of
// all of it backward, with two float32 copies of the map saved. The plain
// PyTorch version of each pass is beside its wrapper in ops/cuda/bn_cu.py,
// which also holds the autograd Function that strings the passes together.
//
// The map is (N, C, H, W) in channels-last memory: rows = N*H*W rows of C
// contiguous bf16 channels, C a multiple of 8 (one 16-byte load holds 8
// channels), 8 <= C <= 2048. Per channel, n = rows:
//   moments        mean = sum(x) / n, msq = sum(x*x) / n          reads x
//   normalize_relu y = relu(bf16((x - mean) * inv + bias))        reads x, writes y
//   backward_reduce s1 = sum(g), s2 = sum(g * (x - mean)),        reads dy, y, x
//                   g = (y <= 0) ? 0 : dy
//   backward_dx    dx = bf16(inv * ((g - c1) - c2 * (x - mean)))  reads dy, y, x, writes dx
// The wrapper computes the (C,) vectors between the passes (var, inv, c1,
// c2, the running stats, a process group's all-reduce) as PyTorch did.
//
// What bounds it on this card: bytes. A pass does a few float32
// operations an element against 2 to 8 bytes moved, far below the ~20
// operations a byte where the card's float32 rate would bind. The design
// moves each element's bytes once a pass, 20 bytes in all (2 + 4 forward,
// 6 + 8 backward), where the PyTorch operators moved ~56 forward and ~100
// backward:
// - 16-byte loads and stores, neighbouring threads on neighbouring
//   addresses, kUnroll loads a thread and operand in flight;
// - the elementwise passes launch a grid whose threads all keep one
//   channel group (the grid is a multiple of C / 8), so a thread loads its
//   8 channels' coefficients once into registers;
// - the reductions keep each thread's 8 channels' sums in registers over
//   its rows, sum the block's rows in shared memory in row order, and
//   write one partial row a block (a block takes kMinSteps row steps or
//   more, so on a small map the partial rows stay a small share of the
//   bytes read); a finishing launch sums the partial rows in a fixed
//   order. No atomics: a run gives the same bits on the same grid.
//
// Rounding. The per-element products and sums are written with __fmul_rn
// / __fadd_rn / __fsub_rn, which nvcc never contracts into FMAs, in the
// plain version's order: given the same (C,) vectors, normalize_relu and
// backward_dx give the plain version's bits. The sums themselves run in
// another order than PyTorch's reductions and differ from them by float32
// rounding. Built without --use_fast_math (ops/cuda/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;      // bf16 channels in one 16-byte load
constexpr int kUnroll = 4;   // loads in flight a thread and operand
constexpr int kMaxGroups = kThreads;  // C / 8 <= 256: a block covers at least one row
// Blocks of a reduction pass at most (8 a SM on 132 SMs); ops/cuda/bn_cu.py
// sizes its partial buffer from v2x_bn_max_partials().
constexpr int kMaxPartials = 1056;
constexpr int kMinSteps = 4 * kUnroll;  // row steps a reduction block takes at least
// Blocks of an elementwise pass at most, before rounding up to a multiple
// of C / 8.
constexpr int kElementwiseBlocks = 2112;
constexpr int kFinishCols = 32;   // outputs a finishing block sums
constexpr int kFinishRows = 32;   // partial-row slices it sums them in

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

__device__ __forceinline__ void load8(const float* p, float f[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// ReLU's gradient mask as PyTorch's threshold_backward takes it from the
// output: 0 where y <= 0, dy elsewhere (a NaN output passes dy).
__device__ __forceinline__ float relu_grad(float dy, float y) { return y <= 0.f ? 0.f : dy; }

// One reduction pass. Thread t keeps channel group t % groups of row
// t / groups of each block step (per = kThreads / groups rows a step; the
// threads past per * groups idle), accumulating sums a and b of its 8
// channels: moments a = x, b = x * x; backward a = g, b = g * (x - mean).
// Then the block sums its rows' a and b in row order and writes the
// partial row [a of C channels, b of C channels].
template <bool kBackward>
__global__ void __launch_bounds__(kThreads)
bn_reduce_kernel(const uint4* __restrict__ dy, const uint4* __restrict__ y,
                 const uint4* __restrict__ x, const float* __restrict__ mean,
                 float* __restrict__ partial, int64_t rows, int c) {
  __shared__ float sh[2 * kThreads * kVec];
  const int groups = c / kVec, per = kThreads / groups;
  const int r = threadIdx.x / groups, g = threadIdx.x % groups;
  const bool active = r < per;
  float a[kVec], b[kVec], m[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) a[j] = b[j] = m[j] = 0.f;
  if constexpr (kBackward) {
    if (active) load8(mean + g * kVec, m);
  }
  if (active) {
    const int64_t step = static_cast<int64_t>(gridDim.x) * per;
    for (int64_t row = static_cast<int64_t>(blockIdx.x) * per + r; row < rows;
         row += kUnroll * step) {
      uint4 vx[kUnroll], vy[kUnroll], vd[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t ru = row + u * step;
        const bool in = ru < rows;
        const int64_t at = ru * groups + g;
        vx[u] = in ? __ldg(x + at) : make_uint4(0, 0, 0, 0);
        if constexpr (kBackward) {
          vy[u] = in ? __ldg(y + at) : make_uint4(0, 0, 0, 0);  // 0: g = 0
          vd[u] = in ? __ldg(dy + at) : make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float fx[kVec];
        unpack(vx[u], fx);
        if constexpr (kBackward) {
          float fy[kVec], fd[kVec];
          unpack(vy[u], fy);
          unpack(vd[u], fd);
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            const float gj = relu_grad(fd[j], fy[j]);
            a[j] = __fadd_rn(a[j], gj);
            b[j] = __fadd_rn(b[j], __fmul_rn(gj, __fsub_rn(fx[j], m[j])));
          }
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            a[j] = __fadd_rn(a[j], fx[j]);  // a row past the end adds +0
            b[j] = __fadd_rn(b[j], __fmul_rn(fx[j], fx[j]));
          }
        }
      }
    }
  }
  // sh holds [a | b][row of the step][channel].
  const int span = per * c;
  if (active) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      sh[r * c + g * kVec + j] = a[j];
      sh[span + r * c + g * kVec + j] = b[j];
    }
  }
  __syncthreads();
  float* out = partial + static_cast<int64_t>(blockIdx.x) * 2 * c;
  for (int j = threadIdx.x; j < 2 * c; j += kThreads) {
    const int kind = j / c, ch = j - kind * c;
    const float* col = sh + kind * span + ch;
    float s = 0.f;
    for (int i = 0; i < per; ++i) s = __fadd_rn(s, col[i * c]);
    out[j] = s;
  }
}

// Sums the `partials` partial rows of `width` floats and divides by
// `count`, in a fixed order: thread (x, y) sums rows y, y + 32, ... of
// column x, then the 32 slices are summed in order.
__global__ void __launch_bounds__(kFinishCols * kFinishRows)
bn_finish_kernel(const float* __restrict__ partial, float* __restrict__ out, int partials,
                 int width, float count) {
  __shared__ float sh[kFinishRows][kFinishCols + 1];
  const int col = blockIdx.x * kFinishCols + threadIdx.x;
  float s = 0.f;
  if (col < width) {
#pragma unroll 4
    for (int p = threadIdx.y; p < partials; p += kFinishRows)
      s = __fadd_rn(s, partial[static_cast<int64_t>(p) * width + col]);
  }
  sh[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < width) {
    float t = 0.f;
    for (int i = 0; i < kFinishRows; ++i) t = __fadd_rn(t, sh[i][threadIdx.x]);
    out[col] = __fdiv_rn(t, count);
  }
}

// y = relu(bf16((x - mean) * inv + bias)), 8 channels a 16-byte vector.
// The grid is a multiple of C / 8, so every vector a thread visits holds
// the same 8 channels.
__global__ void __launch_bounds__(kThreads)
bn_normalize_relu_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                         const float* __restrict__ mean, const float* __restrict__ inv,
                         const float* __restrict__ bias, int64_t vecs, int c) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int g = static_cast<int>(first % (c / kVec));
  float m[kVec], k[kVec], bb[kVec];
  load8(mean + g * kVec, m);
  load8(inv + g * kVec, k);
  load8(bias + g * kVec, bb);
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = first; i < vecs; i += kUnroll * step) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t iu = i + u * step;
      v[u] = iu < vecs ? __ldg(x + iu) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t iu = i + u * step;
      if (iu >= vecs) break;
      float f[kVec];
      unpack(v[u], f);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float z = __fadd_rn(__fmul_rn(__fsub_rn(f[j], m[j]), k[j]), bb[j]);
        const float rz = __bfloat162float(__float2bfloat16_rn(z));  // the one rounding
        f[j] = rz <= 0.f ? 0.f : rz;  // then the ReLU, exact in bf16
      }
      y[iu] = pack(f);
    }
  }
}

// dx = bf16(inv * ((g - c1) - c2 * (x - mean))), g = relu_grad(dy, y).
__global__ void __launch_bounds__(kThreads)
bn_backward_dx_kernel(const uint4* __restrict__ dy, const uint4* __restrict__ y,
                      const uint4* __restrict__ x, const float* __restrict__ mean,
                      const float* __restrict__ inv, const float* __restrict__ c1,
                      const float* __restrict__ c2, uint4* __restrict__ dx, int64_t vecs,
                      int c) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int g = static_cast<int>(first % (c / kVec));
  float m[kVec], k[kVec], k1[kVec], k2[kVec];
  load8(mean + g * kVec, m);
  load8(inv + g * kVec, k);
  load8(c1 + g * kVec, k1);
  load8(c2 + g * kVec, k2);
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = first; i < vecs; i += kUnroll * step) {
    uint4 vd[kUnroll], vy[kUnroll], vx[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t iu = i + u * step;
      const bool in = iu < vecs;
      vd[u] = in ? __ldg(dy + iu) : make_uint4(0, 0, 0, 0);
      vy[u] = in ? __ldg(y + iu) : make_uint4(0, 0, 0, 0);
      vx[u] = in ? __ldg(x + iu) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t iu = i + u * step;
      if (iu >= vecs) break;
      float fd[kVec], fy[kVec], fx[kVec];
      unpack(vd[u], fd);
      unpack(vy[u], fy);
      unpack(vx[u], fx);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float gj = relu_grad(fd[j], fy[j]);
        const float xc = __fsub_rn(fx[j], m[j]);
        fx[j] = __fmul_rn(k[j], __fsub_rn(__fsub_rn(gj, k1[j]), __fmul_rn(k2[j], xc)));
      }
      dx[iu] = pack(fx);
    }
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

bool bad_shape(int64_t rows, int64_t c) {
  return rows < 1 || c < kVec || c % kVec != 0 || c / kVec > kMaxGroups;
}

// The reduction pass's grid: kMinSteps row steps a block or more, at most
// kMaxPartials blocks. Fewer blocks on a small map keep the partial rows
// (2C floats a block) a small share of the bytes the pass reads.
int reduce_blocks(int64_t rows, int64_t c) {
  const int64_t need = ceil_div(rows, static_cast<int64_t>(kThreads / (c / kVec)) * kMinSteps);
  return static_cast<int>(need < kMaxPartials ? need : kMaxPartials);
}

// The elementwise pass's grid: a multiple of C / 8.
unsigned elementwise_blocks(int64_t vecs, int64_t c) {
  const int64_t groups = c / kVec;
  int64_t blocks = ceil_div(vecs, kThreads);
  if (blocks > kElementwiseBlocks) blocks = kElementwiseBlocks;
  return static_cast<unsigned>(ceil_div(blocks, groups) * groups);
}

int finish(const float* partial, float* out, int partials, int64_t c, float count,
           cudaStream_t stream) {
  const int width = static_cast<int>(2 * c);
  bn_finish_kernel<<<static_cast<unsigned>(ceil_div(width, kFinishCols)),
                     dim3(kFinishCols, kFinishRows), 0, stream>>>(partial, out, partials, width,
                                                                  count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError() as
// an int (0 = launched), or cudaErrorInvalidValue for a shape it does not
// take. Pointers are the tensors' data: bf16 maps channels-last and
// 16-byte aligned, (C,) float32 vectors, `partial` v2x_bn_max_partials()
// x 2C float32 scratch, `out` 2C float32.

int v2x_bn_max_partials() { return kMaxPartials; }

// out = [sum(x) / count, sum(x*x) / count] over the rows, per channel.
int v2x_bn_moments(const void* x, float* partial, float* out, int64_t rows, int64_t c,
                   float count, void* stream) {
  if (bad_shape(rows, c)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = reduce_blocks(rows, c);
  bn_reduce_kernel<false><<<blocks, kThreads, 0, s>>>(
      nullptr, nullptr, static_cast<const uint4*>(x), nullptr, partial, rows,
      static_cast<int>(c));
  const int rc = static_cast<int>(cudaGetLastError());
  return rc != 0 ? rc : finish(partial, out, blocks, c, count, s);
}

int v2x_bn_normalize_relu(const void* x, void* y, const float* mean, const float* inv,
                          const float* bias, int64_t rows, int64_t c, void* stream) {
  if (bad_shape(rows, c)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t vecs = rows * (c / kVec);
  bn_normalize_relu_kernel<<<elementwise_blocks(vecs, c), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), mean, inv, bias, vecs,
      static_cast<int>(c));
  return static_cast<int>(cudaGetLastError());
}

// out = [sum(g), sum(g * (x - mean))] over the rows, per channel.
int v2x_bn_backward_reduce(const void* dy, const void* y, const void* x, const float* mean,
                           float* partial, float* out, int64_t rows, int64_t c, void* stream) {
  if (bad_shape(rows, c)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = reduce_blocks(rows, c);
  bn_reduce_kernel<true><<<blocks, kThreads, 0, s>>>(
      static_cast<const uint4*>(dy), static_cast<const uint4*>(y),
      static_cast<const uint4*>(x), mean, partial, rows, static_cast<int>(c));
  const int rc = static_cast<int>(cudaGetLastError());
  return rc != 0 ? rc : finish(partial, out, blocks, c, 1.f, s);
}

int v2x_bn_backward_dx(const void* dy, const void* y, const void* x, const float* mean,
                       const float* inv, const float* c1, const float* c2, void* dx,
                       int64_t rows, int64_t c, void* stream) {
  if (bad_shape(rows, c)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t vecs = rows * (c / kVec);
  bn_backward_dx_kernel<<<elementwise_blocks(vecs, c), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(dy), static_cast<const uint4*>(y),
      static_cast<const uint4*>(x), mean, inv, c1, c2, static_cast<uint4*>(dx), vecs,
      static_cast<int>(c));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
