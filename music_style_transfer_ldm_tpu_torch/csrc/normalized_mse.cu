// One std-normalized feature-MSE layer, forward and backward (kernel D).
//
// Replaces music_style_transfer_ldm_tpu/ops/pallas/normalized_mse.py
// normalized_mse_pallas (_fwd_call and _bwd_call).  Per sample b of
// feature maps p, t flattened to [B, N] (bf16 or f32; every statistic in
// f32, eps = 1e-8):
//
//   mu_p = mean(p),  s_p = sqrt(mean((p - mu_p)^2))     (two passes)
//   mu_t, s_t likewise
//   m    = mean((p / (s_p + eps) - t / (s_t + eps))^2)
//
// and the closed-form backward, one launch chain for dp or for dt:
//
//   u  = (2 / N) uscale (p / (s_p + eps) - t / (s_t + eps))
//   dp = u / (s_p + eps) - a (p - mu_p) / ((s_p + eps)^2 N s_p),  a = sum(u p)
//   dt = -u / (s_t + eps) + b (t - mu_t) / ((s_t + eps)^2 N s_t), b = sum(u t)
//
// The backward also serves the VGGish trunk (kernel E, fused_trunk.cu):
// it can add an incoming f32 gradient, zero where p <= 0 (the ReLU mask
// of the stored post-ReLU map) and write f32 instead of the input type.
//
// What bounds it on the H100: bytes.  The forward must read p and t once
// (layer 1 of VGGish at B = 128 in bf16: 537 MB, 0.16 ms at 3.35 TB/s);
// it has a handful of operations per element.
//
// Design (the simple first version).  A sample does not fit one SM
// (layer 1 is 2 x 1 M elements), so each sample is cut into chunks of
// kChunk elements, one CTA each, grid (chunks, B).  Reductions are
// deterministic with no float atomics: each CTA writes its partial sum
// to a workspace, and every consumer reduces a sample's partials in one
// fixed order (a block reduction over a fixed assignment), so all CTAs
// of a sample see bit-identical statistics.  The forward is four
// launches (sums; centred squares; squared differences; finalize), so it
// reads p and t three times; the backward is two (the dot product a or
// b; the elementwise gradient), reading them twice.  A single pass over
// L2-resident samples is later work.
//
// Interface: plain C, bound with ctypes; each entry returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8192;   // elements per CTA, a multiple of 8 * kThreads
constexpr float kEps = 1e-8f;

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Sum over the block in a fixed order (warp shuffles, then warp 0 over
// the warps' sums); every thread gets the result.
__device__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  __shared__ float total;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) total = s;
  }
  __syncthreads();
  const float r = total;
  __syncthreads();  // the shared slots may be reused by the next call
  return r;
}

// Sum of a sample's per-chunk partials part[(b * nch + k) * stride + off]
// over k, in a fixed order: the same value in every CTA that asks.
__device__ float sample_sum(const float* part, int b, int nch, int stride,
                            int off) {
  float s = 0.f;
  for (int k = threadIdx.x; k < nch; k += kThreads)
    s += part[((size_t)b * nch + k) * stride + off];
  return block_sum(s);
}

struct Stats {
  float mu_p, s_p, mu_t, s_t;
};

__device__ Stats stats_from_parts(const float* part1, const float* part2,
                                  int b, int nch, float n) {
  Stats st;
  st.mu_p = sample_sum(part1, b, nch, 2, 0) / n;
  st.mu_t = sample_sum(part1, b, nch, 2, 1) / n;
  st.s_p = sqrtf(sample_sum(part2, b, nch, 2, 0) / n);
  st.s_t = sqrtf(sample_sum(part2, b, nch, 2, 1) / n);
  return st;
}

// Pass 1: per-chunk sums of p and of t.
template <typename T>
__global__ void __launch_bounds__(kThreads)
nm_sum_kernel(const T* __restrict__ p, const T* __restrict__ t, long long N,
              int nch, float* part1) {
  const int b = blockIdx.y, k = blockIdx.x;
  const long long lo = (long long)k * kChunk;
  const long long hi = min(lo + kChunk, N);
  const T* P = p + (size_t)b * N;
  const T* Q = t + (size_t)b * N;
  float sp = 0.f, st = 0.f;
  for (long long i = lo + 8 * threadIdx.x; i < hi; i += 8 * kThreads) {
    float a[8], c[8];
    load8(P + i, a);
    load8(Q + i, c);
#pragma unroll
    for (int j = 0; j < 8; ++j) { sp += a[j]; st += c[j]; }
  }
  sp = block_sum(sp);
  st = block_sum(st);
  if (threadIdx.x == 0) {
    part1[((size_t)b * nch + k) * 2] = sp;
    part1[((size_t)b * nch + k) * 2 + 1] = st;
  }
}

// Pass 2: per-chunk sums of the centred squares.
template <typename T>
__global__ void __launch_bounds__(kThreads)
nm_sq_kernel(const T* __restrict__ p, const T* __restrict__ t, long long N,
             int nch, const float* part1, float* part2) {
  const int b = blockIdx.y, k = blockIdx.x;
  const float n = (float)N;
  const float mu_p = sample_sum(part1, b, nch, 2, 0) / n;
  const float mu_t = sample_sum(part1, b, nch, 2, 1) / n;
  const long long lo = (long long)k * kChunk;
  const long long hi = min(lo + kChunk, N);
  const T* P = p + (size_t)b * N;
  const T* Q = t + (size_t)b * N;
  float sp = 0.f, st = 0.f;
  for (long long i = lo + 8 * threadIdx.x; i < hi; i += 8 * kThreads) {
    float a[8], c[8];
    load8(P + i, a);
    load8(Q + i, c);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float dp = a[j] - mu_p, dt = c[j] - mu_t;
      sp += dp * dp;
      st += dt * dt;
    }
  }
  sp = block_sum(sp);
  st = block_sum(st);
  if (threadIdx.x == 0) {
    part2[((size_t)b * nch + k) * 2] = sp;
    part2[((size_t)b * nch + k) * 2 + 1] = st;
  }
}

// Pass 3: per-chunk sums of the squared normalised difference.
template <typename T>
__global__ void __launch_bounds__(kThreads)
nm_d2_kernel(const T* __restrict__ p, const T* __restrict__ t, long long N,
             int nch, const float* part1, const float* part2, float* part3) {
  const int b = blockIdx.y, k = blockIdx.x;
  const Stats st = stats_from_parts(part1, part2, b, nch, (float)N);
  const float ep = st.s_p + kEps, et = st.s_t + kEps;
  const long long lo = (long long)k * kChunk;
  const long long hi = min(lo + kChunk, N);
  const T* P = p + (size_t)b * N;
  const T* Q = t + (size_t)b * N;
  float s = 0.f;
  for (long long i = lo + 8 * threadIdx.x; i < hi; i += 8 * kThreads) {
    float a[8], c[8];
    load8(P + i, a);
    load8(Q + i, c);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = a[j] / ep - c[j] / et;
      s += d * d;
    }
  }
  s = block_sum(s);
  if (threadIdx.x == 0) part3[(size_t)b * nch + k] = s;
}

// Pass 4: one block per sample writes stats [B, 4] and m [B].
__global__ void __launch_bounds__(kThreads)
nm_finalize_kernel(long long N, int nch, const float* part1,
                   const float* part2, const float* part3, float* m,
                   float* stats) {
  const int b = blockIdx.x;
  const float n = (float)N;
  const Stats st = stats_from_parts(part1, part2, b, nch, n);
  const float d2 = sample_sum(part3, b, nch, 1, 0);
  if (threadIdx.x == 0) {
    m[b] = d2 / n;
    stats[4 * b] = st.mu_p;
    stats[4 * b + 1] = st.s_p;
    stats[4 * b + 2] = st.mu_t;
    stats[4 * b + 3] = st.s_t;
  }
}

// Backward pass 1: per-chunk sums of u * ref, ref = p (dp) or t (dt).
template <typename T>
__global__ void __launch_bounds__(kThreads)
nm_dot_kernel(const T* __restrict__ p, const T* __restrict__ t, long long N,
              int nch, const float* stats, const float* uscale,
              int wrt_target, float* part) {
  const int b = blockIdx.y, k = blockIdx.x;
  const float ep = stats[4 * b + 1] + kEps, et = stats[4 * b + 3] + kEps;
  const float c = (2.f / (float)N) * uscale[b];
  const long long lo = (long long)k * kChunk;
  const long long hi = min(lo + kChunk, N);
  const T* P = p + (size_t)b * N;
  const T* Q = t + (size_t)b * N;
  float s = 0.f;
  for (long long i = lo + 8 * threadIdx.x; i < hi; i += 8 * kThreads) {
    float a[8], q[8];
    load8(P + i, a);
    load8(Q + i, q);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float u = c * (a[j] / ep - q[j] / et);
      s += u * (wrt_target ? q[j] : a[j]);
    }
  }
  s = block_sum(s);
  if (threadIdx.x == 0) part[(size_t)b * nch + k] = s;
}

// Backward pass 2: the elementwise gradient (+ gin, ReLU mask by p > 0).
template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
nm_grad_kernel(const T* __restrict__ p, const T* __restrict__ t, long long N,
               int nch, const float* stats, const float* uscale,
               int wrt_target, const float* part, const float* gin, int mask,
               O* out) {
  const int b = blockIdx.y, k = blockIdx.x;
  const float dot = sample_sum(part, b, nch, 1, 0);
  const float n = (float)N;
  const float mu_p = stats[4 * b], s_p = stats[4 * b + 1];
  const float mu_t = stats[4 * b + 2], s_t = stats[4 * b + 3];
  const float ep = s_p + kEps, et = s_t + kEps;
  const float c = (2.f / n) * uscale[b];
  const float den = wrt_target ? et * et * n * s_t : ep * ep * n * s_p;
  const long long lo = (long long)k * kChunk;
  const long long hi = min(lo + kChunk, N);
  const T* P = p + (size_t)b * N;
  const T* Q = t + (size_t)b * N;
  const float* G = gin ? gin + (size_t)b * N : nullptr;
  O* Out = out + (size_t)b * N;
  for (long long i = lo + 8 * threadIdx.x; i < hi; i += 8 * kThreads) {
    float a[8], q[8], g[8], r[8];
    load8(P + i, a);
    load8(Q + i, q);
    if (G) load8(G + i, g);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float u = c * (a[j] / ep - q[j] / et);
      float v = wrt_target ? -u / et + dot * (q[j] - mu_t) / den
                           : u / ep - dot * (a[j] - mu_p) / den;
      if (G) v = g[j] + v;
      if (mask && !(a[j] > 0.f)) v = 0.f;
      r[j] = v;
    }
    store8(Out + i, r);
  }
}

inline int num_chunks(long long N) { return (int)((N + kChunk - 1) / kChunk); }

template <typename T>
int forward(const void* p, const void* t, int B, long long N, float* m,
            float* stats, float* work, cudaStream_t s) {
  const int nch = num_chunks(N);
  float* part1 = work;
  float* part2 = part1 + (size_t)2 * B * nch;
  float* part3 = part2 + (size_t)2 * B * nch;
  const T* P = static_cast<const T*>(p);
  const T* Q = static_cast<const T*>(t);
  const dim3 grid(nch, B);
  nm_sum_kernel<T><<<grid, kThreads, 0, s>>>(P, Q, N, nch, part1);
  nm_sq_kernel<T><<<grid, kThreads, 0, s>>>(P, Q, N, nch, part1, part2);
  nm_d2_kernel<T><<<grid, kThreads, 0, s>>>(P, Q, N, nch, part1, part2, part3);
  nm_finalize_kernel<<<B, kThreads, 0, s>>>(N, nch, part1, part2, part3, m,
                                            stats);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward(const void* p, const void* t, int B, long long N,
             const float* stats, const float* uscale, int wrt_target,
             const float* gin, int mask, void* out, int out_f32, float* work,
             cudaStream_t s) {
  const int nch = num_chunks(N);
  const T* P = static_cast<const T*>(p);
  const T* Q = static_cast<const T*>(t);
  const dim3 grid(nch, B);
  nm_dot_kernel<T><<<grid, kThreads, 0, s>>>(P, Q, N, nch, stats, uscale,
                                             wrt_target, work);
  if (out_f32)
    nm_grad_kernel<T, float><<<grid, kThreads, 0, s>>>(
        P, Q, N, nch, stats, uscale, wrt_target, work, gin, mask,
        static_cast<float*>(out));
  else
    nm_grad_kernel<T, T><<<grid, kThreads, 0, s>>>(
        P, Q, N, nch, stats, uscale, wrt_target, work, gin, mask,
        static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Chunks per sample: the workspace holds 5 * B * chunks floats for the
// forward and B * chunks for the backward.
extern "C" int nm_chunks(long long N) { return num_chunks(N); }

// dtype 0: float32, 1: bfloat16.  N % 8 == 0 and 16-byte aligned rows.
extern "C" int nm_forward(const void* p, const void* t, int dtype, int B,
                          long long N, float* m, float* stats, float* work,
                          void* stream) {
  if (B <= 0 || N <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return dtype == 1 ? forward<__nv_bfloat16>(p, t, B, N, m, stats, work, s)
                    : forward<float>(p, t, B, N, m, stats, work, s);
}

extern "C" int nm_backward(const void* p, const void* t, int dtype, int B,
                           long long N, const float* stats,
                           const float* uscale, int wrt_target,
                           const float* gin, int mask, void* out, int out_f32,
                           float* work, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return dtype == 1
             ? backward<__nv_bfloat16>(p, t, B, N, stats, uscale, wrt_target,
                                       gin, mask, out, out_f32, work, s)
             : backward<float>(p, t, B, N, stats, uscale, wrt_target, gin,
                               mask, out, out_f32, work, s);
}
