// The VGGish style-loss trunk conv2 ... conv4_2, forward and pred-side
// input gradient (kernel E).
//
// Replaces music_style_transfer_ldm_tpu/ops/pallas/fused_trunk.py
// _trunk_call (fused_vggish_distance, fused_vggish_distance_value).  The
// TPU kernel runs one grid step per sample with the whole trunk in VMEM.
// Here the trunk is a chain of launches from ops/fused_trunk.py, every
// one from this file or from kernel D (normalized_mse.cu), which computes
// the six per-layer metrics and, with grad, each layer's direct metric
// gradient plus the ReLU mask:
//
//   conv3x3    3x3 stride-1 pad-1 conv, NHWC, both branches stacked on
//              the batch dimension: acc (f32) of dtype operands, + f32
//              bias, round to the dtype, ReLU (the TPU kernel's
//              maximum(acc.astype(dtype), 0));
//   maxpool2   2x2 stride-2 max-pool;
//   dgrad      the conv's input gradient: the incoming f32 gradient is
//              rounded to the dtype (as the TPU kernel casts g before each
//              conv input-grad), taps flipped, contraction over Cout, f32
//              out;
//   unpool2    the max-pool's backward: each pooled gradient goes to the
//              first maximum of its window in the order (0,0), (0,1),
//              (1,0), (1,1) of the pre-pool map, zeros elsewhere.
//
// What bounds it on the H100: operations.  At 128x128 the trunk is 8.46
// GFLOP per sample for the value (both branches) and 12.7 GFLOP with the
// gradient: 1.08 and 1.62 TFLOP at B = 128, 1.09 and 1.64 ms at the
// 989 TFLOP/s bf16 tensor-core rate.
//
// Design (the simple first version).  A sample's layer-1 maps do not fit
// one SM, so nothing is per sample: each conv is a tiled implicit GEMM
// over (pixels x output channels) with 128 x 64 tiles, one CTA each, K =
// 9 taps x input channels in steps of 16, staged through shared memory in
// f32 and multiplied on the CUDA cores (8 x 4 outputs a thread).  The
// tensor cores (wgmma with TMA-staged weights) and a metric epilogue
// fused into the conv are the redesign's work; this version sits one to
// two orders above its bound.
//
// Interface: plain C, bound with ctypes; each entry returns
// cudaGetLastError().  dtype 0: float32, 1: bfloat16.  Channel counts
// must be multiples of 4 (16-byte and 8-byte vector loads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 128;   // pixels per tile
constexpr int kBN = 64;    // output channels per tile
constexpr int kBK = 16;    // contraction step (channels of one tap)
constexpr int kTM = 8;     // pixels per thread
constexpr int kTN = 4;     // channels per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);   // 256

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// Round an f32 value to T and back (identity for T = float).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Four consecutive elements (16 bytes of f32, 8 of bf16), aligned.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// Forward:  in = x [M, Cin] (T), w9 [9, Cin, Cout] (T), out = y [M, Cout]
//           (T) = relu(round(sum_{tap, ci} x[src(m, tap)] w9[tap, ci, co]
//           + bias[co])), src = (y + dy, x + dx).
// Dgrad:    in = g [M, Cout] (f32, rounded to T), out = dx [M, Cin] (f32)
//           = sum_{tap, co} g[src(m, tap)] w9[tap, ci, co], src = (y - dy,
//           x - dx).
// M = NB * H * W pixels; (dy, dx) = (tap / 3 - 1, tap % 3 - 1).
template <typename T, bool kDgrad>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const void* __restrict__ in_, const T* __restrict__ w9,
               const float* __restrict__ bias, void* __restrict__ out_,
               int NB, int H, int W, int Cin, int Cout) {
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN + 4];
  using In = typename std::conditional<kDgrad, float, T>::type;
  const In* in = static_cast<const In*>(in_);
  const int Kc = kDgrad ? Cout : Cin;   // contraction channels per tap
  const int Nc = kDgrad ? Cin : Cout;   // output channels
  const int tid = threadIdx.x;
  const int ty = tid / (kBN / kTN), tx = tid % (kBN / kTN);
  const long long M = (long long)NB * H * W;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // A loader: rows tid / 4 and tid / 4 + 64 of the tile, channel quad
  // tid % 4 of the 16-channel step.
  const int a_q = tid % 4;
  int a_b[2], a_y[2], a_x[2];
  bool a_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long m = m0 + tid / 4 + 64 * r;
    a_ok[r] = m < M;
    const long long mm = a_ok[r] ? m : 0;
    a_x[r] = (int)(mm % W);
    a_y[r] = (int)((mm / W) % H);
    a_b[r] = (int)(mm / ((long long)W * H));
  }

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    for (int c0 = 0; c0 < Kc; c0 += kBK) {
      // ---- A tile: 128 pixels x 16 contraction channels, k-major ----
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int sy = a_y[r] + (kDgrad ? -dy : dy);
        const int sx = a_x[r] + (kDgrad ? -dx : dx);
        const int c = c0 + 4 * a_q;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (a_ok[r] && sy >= 0 && sy < H && sx >= 0 && sx < W && c < Kc) {
          load4(in + (((size_t)a_b[r] * H + sy) * W + sx) * Kc + c, v);
          if (kDgrad) {
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] = round_to<T>(v[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) As[4 * a_q + j][tid / 4 + 64 * r] = v[j];
      }
      // ---- B tile: 16 contraction channels x 64 output channels ----
      {
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (!kDgrad) {
          // Bs[k][n] = w9[tap, c0 + k, n0 + n]: 4 consecutive n.
          const int k = tid / 16, n = 4 * (tid % 16);
          if (c0 + k < Cin && n0 + n < Cout)
            load4(w9 + ((size_t)tap * Cin + c0 + k) * Cout + n0 + n, v);
#pragma unroll
          for (int j = 0; j < 4; ++j) Bs[k][n + j] = v[j];
        } else {
          // Bs[k][n] = w9[tap, n0 + n, c0 + k]: 4 consecutive k.
          const int n = tid / 4, k = 4 * (tid % 4);
          if (n0 + n < Cin && c0 + k < Cout)
            load4(w9 + ((size_t)tap * Cin + n0 + n) * Cout + c0 + k, v);
#pragma unroll
          for (int j = 0; j < 4; ++j) Bs[k + j][n] = v[j];
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * kTM]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[kk][ty * kTM + 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * kTN]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // ---- epilogue ----
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long m = m0 + ty * kTM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx * kTN + j;
      if (n >= Nc) continue;
      if (kDgrad) {
        static_cast<float*>(out_)[(size_t)m * Nc + n] = acc[i][j];
      } else {
        const T r = from_f<T>(acc[i][j] + bias[n]);
        static_cast<T*>(out_)[(size_t)m * Nc + n] =
            to_f(r) > 0.f ? r : from_f<T>(0.f);
      }
    }
  }
}

// y [NB, H/2, W/2, C] = max over each 2x2 window of x [NB, H, W, C].
template <typename T>
__global__ void maxpool2_kernel(const T* __restrict__ x, T* __restrict__ y,
                                long long total, int H, int W, int C) {
  const int Ho = H / 2, Wo = W / 2;
  for (long long o = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       o < total; o += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(o % C);
    long long r = o / C;
    const int xo = (int)(r % Wo);
    r /= Wo;
    const int yo = (int)(r % Ho);
    const long long nb = r / Ho;
    const size_t base = (((size_t)nb * H + 2 * yo) * W + 2 * xo) * C + c;
    const T v00 = x[base], v01 = x[base + C];
    const T v10 = x[base + (size_t)W * C], v11 = x[base + (size_t)W * C + C];
    const float a = fmaxf(to_f(v00), to_f(v01));
    const float b = fmaxf(to_f(v10), to_f(v11));
    y[o] = from_f<T>(fmaxf(a, b));   // a max of T values is exact in T
  }
}

// out [NB, H, W, C] (f32): gp [NB, H/2, W/2, C] scattered to the first
// maximum of each 2x2 window of f [NB, H, W, C].
template <typename T>
__global__ void unpool2_kernel(const float* __restrict__ gp,
                               const T* __restrict__ f, float* __restrict__ out,
                               long long total, int H, int W, int C) {
  const int Ho = H / 2, Wo = W / 2;
  for (long long o = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       o < total; o += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(o % C);
    long long r = o / C;
    const int xo = (int)(r % Wo);
    r /= Wo;
    const int yo = (int)(r % Ho);
    const long long nb = r / Ho;
    const size_t i00 = (((size_t)nb * H + 2 * yo) * W + 2 * xo) * C + c;
    const size_t i01 = i00 + C, i10 = i00 + (size_t)W * C, i11 = i10 + C;
    const float v00 = to_f(f[i00]), v01 = to_f(f[i01]);
    const float v10 = to_f(f[i10]), v11 = to_f(f[i11]);
    const float wmax = fmaxf(fmaxf(v00, v01), fmaxf(v10, v11));
    const float g = gp[o];
    const bool s00 = v00 == wmax;
    const bool s01 = !s00 && v01 == wmax;
    const bool s10 = !s00 && !s01 && v10 == wmax;
    const bool s11 = !s00 && !s01 && !s10 && v11 == wmax;
    out[i00] = s00 ? g : 0.f;
    out[i01] = s01 ? g : 0.f;
    out[i10] = s10 ? g : 0.f;
    out[i11] = s11 ? g : 0.f;
  }
}

inline dim3 conv_grid(int NB, int H, int W, int Nc) {
  const long long M = (long long)NB * H * W;
  return dim3((unsigned)((M + kBM - 1) / kBM), (unsigned)((Nc + kBN - 1) / kBN));
}

inline unsigned elem_blocks(long long total) {
  const long long b = (total + 255) / 256;
  return (unsigned)(b < 65535LL * 16 ? b : 65535LL * 16);
}

}  // namespace

extern "C" int trunk_conv3x3(const void* x, const void* w9, const float* bias,
                             void* y, int dtype, int NB, int H, int W, int Cin,
                             int Cout, void* stream) {
  if ((long long)NB * H * W == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid = conv_grid(NB, H, W, Cout);
  if (dtype == 1)
    conv3x3_kernel<__nv_bfloat16, false><<<grid, kThreads, 0, s>>>(
        x, static_cast<const __nv_bfloat16*>(w9), bias, y, NB, H, W, Cin, Cout);
  else
    conv3x3_kernel<float, false><<<grid, kThreads, 0, s>>>(
        x, static_cast<const float*>(w9), bias, y, NB, H, W, Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trunk_conv3x3_dgrad(const float* g, const void* w9, float* dx,
                                   int dtype, int NB, int H, int W, int Cin,
                                   int Cout, void* stream) {
  if ((long long)NB * H * W == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid = conv_grid(NB, H, W, Cin);
  if (dtype == 1)
    conv3x3_kernel<__nv_bfloat16, true><<<grid, kThreads, 0, s>>>(
        g, static_cast<const __nv_bfloat16*>(w9), nullptr, dx, NB, H, W, Cin,
        Cout);
  else
    conv3x3_kernel<float, true><<<grid, kThreads, 0, s>>>(
        g, static_cast<const float*>(w9), nullptr, dx, NB, H, W, Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}

// H, W: the pre-pool size (even).
extern "C" int trunk_maxpool2(const void* x, void* y, int dtype, int NB, int H,
                              int W, int C, void* stream) {
  const long long total = (long long)NB * (H / 2) * (W / 2) * C;
  if (total == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1)
    maxpool2_kernel<__nv_bfloat16><<<elem_blocks(total), 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        total, H, W, C);
  else
    maxpool2_kernel<float><<<elem_blocks(total), 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), total, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trunk_unpool2(const float* gp, const void* f, float* out,
                             int dtype, int NB, int H, int W, int C,
                             void* stream) {
  const long long total = (long long)NB * (H / 2) * (W / 2) * C;
  if (total == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1)
    unpool2_kernel<__nv_bfloat16><<<elem_blocks(total), 256, 0, s>>>(
        gp, static_cast<const __nv_bfloat16*>(f), out, total, H, W, C);
  else
    unpool2_kernel<float><<<elem_blocks(total), 256, 0, s>>>(
        gp, static_cast<const float*>(f), out, total, H, W, C);
  return static_cast<int>(cudaGetLastError());
}
