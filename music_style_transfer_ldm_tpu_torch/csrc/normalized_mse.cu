// One std-normalized feature-MSE layer, forward and backward (kernel D).
//
// Replaces music_style_transfer_ldm_tpu/ops/pallas/normalized_mse.py
// normalized_mse_pallas (_fwd_call and _bwd_call).  Per sample b of
// feature maps p, t flattened to [B, N] (bf16 or f32; every statistic in
// f32, eps = 1e-8):
//
//   mu_p = mean(p),  s_p = sqrt(mean((p - mu_p)^2))
//   mu_t, s_t likewise
//   m    = mean((p / (s_p + eps) - t / (s_t + eps))^2)
//
// and the closed-form backward, one launch for dp or for dt:
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
// the backward reads them once and writes the gradient once (805 MB,
// 0.24 ms).  Each has a handful of operations per element.  A sample
// (2 x 1 M elements at layer 1) fits neither one SM nor, across the
// batch, the 50 MB L2, so the statistics cannot take two passes over a
// kept chunk.
//
// Forward: one launch, one read.  Grid (chunks, B), kChunk elements per
// CTA, 32 per thread.  A thread keeps its 32 p and t values in registers,
// shifted by the sample's first element (K_p = p[b, 0], K_t = t[b, 0]:
// the moments stay exact where |mean| >> std), and reduces them in two
// passes to centred moments (n, mu_p - K_p, mu_t - K_t, M2_p, M2_t, C_pt);
// the CTA merges its threads' moments by Chan's formula in a fixed tree
// (a warp butterfly, then the warps in order),
// writes the chunk's moments to the workspace and takes a per-sample
// ticket (atomicAdd after __threadfence).  The CTA that draws the last
// ticket merges the sample's chunks by the same fixed tree over chunk
// index, computes m and the statistics [B, 6] from the merged moments in
// f64 (one thread per sample), and resets the ticket to 0 for the next
// call.  No float atomics, and the merge order does not
// depend on which CTA finishes last, so the result is bit-identical from
// run to run.  With A = s_p + eps, B = s_t + eps, e = mu_p / A - mu_t / B:
//
//   m  = (M2_p / A^2 - 2 C_pt / (A B) + M2_t / B^2) / N + e^2
//   a0 = sum p (p / A - t / B) = M2_p / A - C_pt / B + N mu_p e
//   b0 = sum t (p / A - t / B) = C_pt / A - M2_t / B + N mu_t e
//
// stats = (mu_p, s_p, mu_t, s_t, a0, b0).  m's first form cancels where
// p and t nearly agree (m much below 1): its absolute error is then a
// few f32 ulps of 1, from the f32 moments.
//
// Backward: one elementwise launch.  a = (2 / N) uscale a0 (b likewise)
// comes from the statistics, so the launch reads p, t and, where given,
// gin once and writes the output once.
//
// Interface: plain C, bound with ctypes; each entry returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 32;                  // elements of p (and of t)
constexpr int kChunk = kThreads * kPerThread;   // 8192 elements per CTA
constexpr float kEps = 1e-8f;

// Eight consecutive elements as loaded (16-byte vectors), kept packed in
// registers until used: a thread's loads are all issued before any is
// used, and bf16 data costs half the registers.
template <typename T> struct Pack8;
template <> struct Pack8<float> { float4 a, b; };
template <> struct Pack8<__nv_bfloat16> { uint4 u; };

__device__ __forceinline__ Pack8<float> load8(const float* p) {
  return {reinterpret_cast<const float4*>(p)[0],
          reinterpret_cast<const float4*>(p)[1]};
}

__device__ __forceinline__ Pack8<__nv_bfloat16> load8(
    const __nv_bfloat16* p) {
  return {*reinterpret_cast<const uint4*>(p)};
}

__device__ __forceinline__ void unpack(const Pack8<float>& x, float v[8]) {
  v[0] = x.a.x; v[1] = x.a.y; v[2] = x.a.z; v[3] = x.a.w;
  v[4] = x.b.x; v[5] = x.b.y; v[6] = x.b.z; v[7] = x.b.w;
}

__device__ __forceinline__ void unpack(const Pack8<__nv_bfloat16>& x,
                                       float v[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float first(const float* p) { return p[0]; }
__device__ __forceinline__ float first(const __nv_bfloat16* p) {
  return __bfloat162float(p[0]);
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

// Centred moments of a set of (p, t) pairs.
struct Moments {
  float n, mu_p, mu_t, m2_p, m2_t, c_pt;
};

// Chan's merge of two disjoint sets, x before y.
__device__ __forceinline__ Moments merge(const Moments& x, const Moments& y) {
  if (y.n == 0.f) return x;
  if (x.n == 0.f) return y;
  Moments r;
  r.n = x.n + y.n;
  const float f = y.n / r.n, w = x.n * f;   // w = x.n y.n / n
  const float dp = y.mu_p - x.mu_p, dt = y.mu_t - x.mu_t;
  r.mu_p = x.mu_p + dp * f;
  r.mu_t = x.mu_t + dt * f;
  r.m2_p = x.m2_p + y.m2_p + dp * dp * w;
  r.m2_t = x.m2_t + y.m2_t + dt * dt * w;
  r.c_pt = x.c_pt + y.c_pt + dp * dt * w;
  return r;
}

__device__ __forceinline__ Moments shfl_xor(const Moments& m, int off) {
  Moments r;
  r.n = __shfl_xor_sync(0xffffffffu, m.n, off);
  r.mu_p = __shfl_xor_sync(0xffffffffu, m.mu_p, off);
  r.mu_t = __shfl_xor_sync(0xffffffffu, m.mu_t, off);
  r.m2_p = __shfl_xor_sync(0xffffffffu, m.m2_p, off);
  r.m2_t = __shfl_xor_sync(0xffffffffu, m.m2_t, off);
  r.c_pt = __shfl_xor_sync(0xffffffffu, m.c_pt, off);
  return r;
}

// The block's merge in a fixed tree: a butterfly over each warp's lanes
// (lower lane first, so both partners compute the same value), then warp
// 0 ... 7 in order.  Thread 0 gets the result.
__device__ Moments block_merge(Moments m) {
  __shared__ Moments warp_m[kThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Moments o = shfl_xor(m, off);
    m = (lane & off) ? merge(o, m) : merge(m, o);
  }
  if (lane == 0) warp_m[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = merge(m, warp_m[w]);
  }
  return m;
}

// Forward: chunk blockIdx.x of sample blockIdx.y; work holds 6 floats of
// moments per (sample, chunk); tickets [B] are 0 on entry and on exit.
template <typename T>
__global__ void __launch_bounds__(kThreads)
nm_forward_kernel(const T* __restrict__ p, const T* __restrict__ t,
                  long long N, int nch, float* __restrict__ work,
                  unsigned* __restrict__ tickets, float* __restrict__ m_out,
                  float* __restrict__ stats) {
  const int b = blockIdx.y, k = blockIdx.x;
  const long long lo = (long long)k * kChunk;
  const long long hi = min(lo + kChunk, N);
  const T* P = p + (size_t)b * N;
  const T* Q = t + (size_t)b * N;
  const float kp = first(P), kt = first(Q);   // the sample's shift
  // This thread's elements: lo + 8 tid + 8 kThreads j + e, j < 4, e < 8;
  // the first cnt of them exist.
  constexpr int kLoads = kPerThread / 8;
  Pack8<T> rp[kLoads], rt[kLoads];
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const long long i = lo + 8 * threadIdx.x + 8 * kThreads * j;
    if (i < hi) {
      rp[j] = load8(P + i);
      rt[j] = load8(Q + i);
      cnt += 8;
    }
  }
  Moments mo{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (cnt > 0) {
    float sp = 0.f, st = 0.f;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      if (8 * j < cnt) {
        float a[8], c[8];
        unpack(rp[j], a);
        unpack(rt[j], c);
#pragma unroll
        for (int e = 0; e < 8; ++e) { sp += a[e] - kp; st += c[e] - kt; }
      }
    }
    mo.n = (float)cnt;
    mo.mu_p = sp / mo.n;
    mo.mu_t = st / mo.n;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      if (8 * j < cnt) {
        float a[8], c[8];
        unpack(rp[j], a);
        unpack(rt[j], c);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float dp = (a[e] - kp) - mo.mu_p, dt = (c[e] - kt) - mo.mu_t;
          mo.m2_p += dp * dp;
          mo.m2_t += dt * dt;
          mo.c_pt += dp * dt;
        }
      }
    }
  }
  mo = block_merge(mo);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    float* w = work + ((size_t)b * nch + k) * 6;
    w[0] = mo.n; w[1] = mo.mu_p; w[2] = mo.mu_t;
    w[3] = mo.m2_p; w[4] = mo.m2_t; w[5] = mo.c_pt;
    __threadfence();
    last = atomicAdd(&tickets[b], 1u) == (unsigned)(nch - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The last CTA of the sample: chunks tid, tid + kThreads, ... in order,
  // then the fixed block tree.
  Moments s{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int q = threadIdx.x; q < nch; q += kThreads) {
    const float* w = work + ((size_t)b * nch + q) * 6;
    const Moments o{__ldcg(w), __ldcg(w + 1), __ldcg(w + 2), __ldcg(w + 3),
                    __ldcg(w + 4), __ldcg(w + 5)};
    s = merge(s, o);
  }
  s = block_merge(s);
  if (threadIdx.x == 0) {
    const double n = (double)N;
    const double mu_p = (double)kp + s.mu_p, mu_t = (double)kt + s.mu_t;
    const double m2_p = s.m2_p, m2_t = s.m2_t, c_pt = s.c_pt;
    // s_p, s_t rounded to f32 first: the eps the backward and the plain
    // version add is to the f32 deviation.
    const float s_p = (float)sqrt(m2_p / n), s_t = (float)sqrt(m2_t / n);
    const double A = (double)(s_p + kEps), Bt = (double)(s_t + kEps);
    const double e = mu_p / A - mu_t / Bt;
    m_out[b] = (float)((m2_p / (A * A) - 2.0 * c_pt / (A * Bt) +
                        m2_t / (Bt * Bt)) / n + e * e);
    float* st = stats + 6 * b;
    st[0] = (float)mu_p; st[1] = s_p; st[2] = (float)mu_t; st[3] = s_t;
    st[4] = (float)(m2_p / A - c_pt / Bt + n * mu_p * e);
    st[5] = (float)(c_pt / A - m2_t / Bt + n * mu_t * e);
    tickets[b] = 0u;
  }
}

// Backward: the elementwise gradient dp (or dt), + gin, ReLU mask by
// p > 0, with a (or b) from the statistics.
template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
nm_backward_kernel(const T* __restrict__ p, const T* __restrict__ t,
                   long long N, const float* __restrict__ stats,
                   const float* __restrict__ uscale, int wrt_target,
                   const float* __restrict__ gin, int mask,
                   O* __restrict__ out) {
  const int b = blockIdx.y, k = blockIdx.x;
  const float n = (float)N;
  const float* sb = stats + 6 * b;
  const float mu_p = sb[0], s_p = sb[1], mu_t = sb[2], s_t = sb[3];
  // reciprocals once: the per-element work is multiplies
  const float rp = 1.f / (s_p + kEps), rt = 1.f / (s_t + kEps);
  const float c = (2.f / n) * uscale[b];
  const float dot = c * (wrt_target ? sb[5] : sb[4]);
  // the centred term's factor: a / ((s_p + eps)^2 N s_p), b likewise
  const float f = wrt_target ? dot * rt * rt / (n * s_t)
                             : dot * rp * rp / (n * s_p);
  const long long lo = (long long)k * kChunk;
  const long long hi = min(lo + kChunk, N);
  const T* P = p + (size_t)b * N;
  const T* Q = t + (size_t)b * N;
  const float* G = gin ? gin + (size_t)b * N : nullptr;
  O* Out = out + (size_t)b * N;
  constexpr int kLoads = kPerThread / 8;
  Pack8<T> lp[kLoads], lt[kLoads];
  Pack8<float> lg[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const long long i = lo + 8 * threadIdx.x + 8 * kThreads * j;
    if (i < hi) {
      lp[j] = load8(P + i);
      lt[j] = load8(Q + i);
      if (G) lg[j] = load8(G + i);
    }
  }
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const long long i = lo + 8 * threadIdx.x + 8 * kThreads * j;
    if (i < hi) {
      float a[8], q[8], g[8], r[8];
      unpack(lp[j], a);
      unpack(lt[j], q);
      if (G) unpack(lg[j], g);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float u = c * (a[e] * rp - q[e] * rt);
        float v = wrt_target ? f * (q[e] - mu_t) - u * rt
                             : u * rp - f * (a[e] - mu_p);
        if (G) v = g[e] + v;
        if (mask && !(a[e] > 0.f)) v = 0.f;
        r[e] = v;
      }
      store8(Out + i, r);
    }
  }
}

inline int num_chunks(long long N) { return (int)((N + kChunk - 1) / kChunk); }

}  // namespace

// Chunks per sample: the forward's workspace holds 6 * B * chunks floats.
extern "C" int nm_chunks(long long N) { return num_chunks(N); }

// dtype 0: float32, 1: bfloat16.  N % 8 == 0 and 16-byte aligned rows.
// tickets: B zeroed unsigned ints, left zeroed.
extern "C" int nm_forward(const void* p, const void* t, int dtype, int B,
                          long long N, float* m, float* stats, float* work,
                          unsigned* tickets, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int nch = num_chunks(N);
  const dim3 grid(nch, B);
  if (dtype == 1)
    nm_forward_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(p),
        static_cast<const __nv_bfloat16*>(t), N, nch, work, tickets, m, stats);
  else
    nm_forward_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(p), static_cast<const float*>(t), N, nch,
        work, tickets, m, stats);
  return static_cast<int>(cudaGetLastError());
}

// stats [B, 6] from nm_forward; out in the input dtype or f32 (out_f32).
extern "C" int nm_backward(const void* p, const void* t, int dtype, int B,
                           long long N, const float* stats,
                           const float* uscale, int wrt_target,
                           const float* gin, int mask, void* out, int out_f32,
                           void* stream) {
  if (B <= 0 || N <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(num_chunks(N), B);
  if (dtype == 1) {
    const __nv_bfloat16* P = static_cast<const __nv_bfloat16*>(p);
    const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(t);
    if (out_f32)
      nm_backward_kernel<__nv_bfloat16, float><<<grid, kThreads, 0, s>>>(
          P, Q, N, stats, uscale, wrt_target, gin, mask,
          static_cast<float*>(out));
    else
      nm_backward_kernel<__nv_bfloat16, __nv_bfloat16><<<grid, kThreads, 0,
                                                         s>>>(
          P, Q, N, stats, uscale, wrt_target, gin, mask,
          static_cast<__nv_bfloat16*>(out));
  } else {
    nm_backward_kernel<float, float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(p), static_cast<const float*>(t), N, stats,
        uscale, wrt_target, gin, mask, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
