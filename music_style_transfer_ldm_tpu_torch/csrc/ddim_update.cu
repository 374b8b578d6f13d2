// One DDIM state update, in place or out of place (kernel B).
//
// Replaces music_style_transfer_ldm_tpu/ops/pallas/ddim_update.py
// fused_ddim_update.  Per element of the latent x (f32) and the UNet's
// noise prediction eps (f32 or bf16), with the step's four f32 scalars
// folded on the host (ops/ddim_update.py step_scalars):
//
//   t1     = sq1m_t * eps                    sq1m_t = sqrt(1 - ab_t)
//   x0_hat = (x - t1) * rs_t                 rs_t   = 1 / sqrt(ab_t)
//   out    = sq_n * x0_hat + coeff * eps     sq_n   = sqrt(ab_next)
//
// and, when asked, x0_hat to a log slot (the sampler's pred_x0 log).
//
// What bounds it on the H100: bytes, and far below them the launch.  At
// the scan sampler's shape [8, 16, 16, 32] a call reads x and eps once
// and writes out once: 786,432 B with f32 eps (0.23 us at 3.35 TB/s),
// 655,360 B with bf16 eps.  Its device work is a few microseconds of
// launch latency; what a sampler step paid for it before was the host's
// launch path (Triton's Python launcher and per-call casts and scalar
// folding), so this kernel has a plain C entry that ctypes calls with
// its argument types set once, and the sampler folds its scalars once
// per trajectory.
//
// Design: a grid sized to the work, 256 threads a CTA, four elements a
// thread: 16-byte loads of x (float4), eps as float4 or as four bf16 in
// one 8-byte load (converted exactly by intrinsics), 16-byte stores, and
// a scalar tail for n % 4 in the thread after the last full vector.  The
// host takes the vector path only where every pointer is aligned for it
// (16 bytes; eps 8 bytes in bf16); otherwise one element a thread.
//
// Rounding: built with --fmad=false and written with explicit _rn ops in
// the plain version's order (ddim_update_reference), so each op rounds
// as PyTorch's eager ops do and the result agrees exactly.
//
// Interface: plain C, bound with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Scalars {
  float sq1m_t, rs_t, sq_n, coeff;
};

__device__ __forceinline__ void step(float x, float e, const Scalars& s,
                                     float* out, float* x0) {
  const float x0_hat = __fmul_rn(__fsub_rn(x, __fmul_rn(s.sq1m_t, e)), s.rs_t);
  *out = __fadd_rn(__fmul_rn(s.sq_n, x0_hat), __fmul_rn(s.coeff, e));
  *x0 = x0_hat;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Four elements a thread; thread n / 4 also takes the n % 4 tail.  x and
// out may be one buffer (the in-place update), so neither is __restrict__.
template <typename E>
__global__ void __launch_bounds__(kThreads)
ddim_update_vec_kernel(const float* x, const E* __restrict__ eps, float* out,
                       float* x0_out, long long n, Scalars s) {
  const long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n4 = n / 4;
  if (v < n4) {
    const float4 xv = load4(x + 4 * v);
    const float4 ev = load4(eps + 4 * v);
    float4 o, z;
    step(xv.x, ev.x, s, &o.x, &z.x);
    step(xv.y, ev.y, s, &o.y, &z.y);
    step(xv.z, ev.z, s, &o.z, &z.z);
    step(xv.w, ev.w, s, &o.w, &z.w);
    *reinterpret_cast<float4*>(out + 4 * v) = o;
    if (x0_out) *reinterpret_cast<float4*>(x0_out + 4 * v) = z;
  } else if (v == n4) {
    for (long long i = 4 * n4; i < n; ++i) {
      float o, z;
      step(x[i], load1(eps + i), s, &o, &z);
      out[i] = o;
      if (x0_out) x0_out[i] = z;
    }
  }
}

// One element a thread, for pointers the vector path cannot take.
template <typename E>
__global__ void __launch_bounds__(kThreads)
ddim_update_scalar_kernel(const float* x, const E* eps, float* out,
                          float* x0_out, long long n, Scalars s) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) {
    float o, z;
    step(x[i], load1(eps + i), s, &o, &z);
    out[i] = o;
    if (x0_out) x0_out[i] = z;
  }
}

bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

template <typename E>
void launch(const float* x, const E* eps, float* out, float* x0_out,
            long long n, Scalars s, cudaStream_t stream) {
  const bool vec = aligned(x, 16) && aligned(out, 16) &&
                   aligned(eps, 4 * sizeof(E)) &&
                   (x0_out == nullptr || aligned(x0_out, 16));
  if (vec) {
    // n / 4 full vectors and one more thread for the tail
    const long long threads = n / 4 + 1;
    const unsigned grid = (unsigned)((threads + kThreads - 1) / kThreads);
    ddim_update_vec_kernel<E><<<grid, kThreads, 0, stream>>>(x, eps, out,
                                                            x0_out, n, s);
  } else {
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    ddim_update_scalar_kernel<E><<<grid, kThreads, 0, stream>>>(x, eps, out,
                                                               x0_out, n, s);
  }
}

}  // namespace

// x, out, x0_out: f32 [n] (out may be x; x0_out may be null); eps: f32
// (eps_bf16 = 0) or bf16 (eps_bf16 = 1) [n].
extern "C" int ddim_update(const float* x, const void* eps, int eps_bf16,
                           float* out, float* x0_out, long long n,
                           float sq1m_t, float rs_t, float sq_n, float coeff,
                           void* stream) {
  if (n <= 0) return 0;
  const Scalars s{sq1m_t, rs_t, sq_n, coeff};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (eps_bf16)
    launch(x, static_cast<const __nv_bfloat16*>(eps), out, x0_out, n, s, st);
  else
    launch(x, static_cast<const float*>(eps), out, x0_out, n, s, st);
  return static_cast<int>(cudaGetLastError());
}
