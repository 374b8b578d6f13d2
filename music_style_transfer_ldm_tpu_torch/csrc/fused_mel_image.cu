// Mel projection -> per-item dB -> uint8-grid unit image, one launch
// (kernel C).
//
// Replaces music_style_transfer_ldm_tpu/ops/pallas/fused_mel_image.py
// fused_mel_unit_image.  Per item b of a batch of power spectra S[b]
// [F, T] and a mel filterbank FB [n_mels, F], all float32:
//
//   mel = FB . S[b]                                   [n_mels, T]
//   L   = 10 log10(max(mel, 1e-10))
//   ref = max(L)          (per item, over ALL T frames: librosa ref=max)
//   db  = max(L - ref, -top_db)
//   x   = clip((db + max_db) * (255 / max_db), 0, 255)
//   img = floor(x + 0.5) * (1/255)      (quantize; else x * (1/255))
//
// What bounds it on the H100: operations.  At the front end's shapes
// (n_mels 128, F 1025, T 130) an item is 34.1 MFLOP of f32 products
// against 0.6 MB of input, so the bound is the f32 CUDA-core rate
// (67 TFLOP/s): 0.51 us for B = 1.  Tensor cores are not used on
// purpose: TF32 keeps 10 mantissa bits and would move values across
// the uint8 grid.
//
// Design (the simple first version): one block per item, matching the
// TPU grid (B,).  The data-dependent ref = max stays inside the block,
// so there are no atomics and no second launch, and the result does not
// depend on the batch.  The product is tiled through shared memory
// (128 mel rows x 32 frames x 16 frequencies a tile; each thread holds
// a 4 x 4 register tile); the first pass writes L to the output and
// keeps a running max, a block reduction gives ref, and a second pass
// over the block's own output applies the epilogue.  An item uses one
// SM with 8 warps, and each tile is loaded, synchronised and then
// computed with no prefetch of the next, so the kernel waits on load
// latency and sits far above the bound (times in PERF.md).  Prefetching
// tiles and spreading an item over several SMs are later work.
//
// Rounding: build with --fmad=false, so no mul+add in the epilogue is
// contracted into an fma (the plain PyTorch version rounds each op);
// the product uses explicit fmaf, as cuBLAS does, and the last step
// multiplies by 1/255 as PyTorch's CUDA division by a scalar does.  Only
// the sum order and log10f's last bit differ from the plain version on
// the card, which can move a value by exactly one grid step (1/255).
//
// Interface: plain C, bound with ctypes; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTM = 128;      // mel rows per tile
constexpr int kTN = 32;       // frames per tile
constexpr int kTK = 16;       // frequencies per tile
constexpr int kPad = 4;       // keeps float4 rows aligned, halves conflicts
constexpr int kThreads = 256; // 32 x 8 threads, 4 x 4 outputs each
constexpr float kAmin = 1e-10f;

__global__ void __launch_bounds__(kThreads)
mel_unit_image_kernel(const float* __restrict__ fb,
                      const float* __restrict__ spec, float* out,
                      int n_mels, int F, int T, float max_db, float top_db,
                      float scale, int quantize) {
  __shared__ __align__(16) float fbs[kTK][kTM + kPad];
  __shared__ __align__(16) float ss[kTK][kTN];
  __shared__ float warp_max[kThreads / 32];

  const int tid = threadIdx.x;
  const int ty = tid / 8;    // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid % 8;    // frames tx*4 .. tx*4+3 of the tile
  const float* S = spec + (size_t)blockIdx.x * F * T;
  float* O = out + (size_t)blockIdx.x * n_mels * T;
  float local_max = -INFINITY;

  for (int m0 = 0; m0 < n_mels; m0 += kTM) {
    for (int t0 = 0; t0 < T; t0 += kTN) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

      for (int k0 = 0; k0 < F; k0 += kTK) {
        // FB tile [kTM rows, kTK freqs], stored k-major; S tile
        // [kTK freqs, kTN frames].  Out-of-range entries are zero.
        for (int i = tid; i < kTM * kTK; i += kThreads) {
          const int r = i / kTK, k = i % kTK;
          const int m = m0 + r, f = k0 + k;
          fbs[k][r] = (m < n_mels && f < F) ? fb[(size_t)m * F + f] : 0.f;
        }
        for (int i = tid; i < kTK * kTN; i += kThreads) {
          const int k = i / kTN, c = i % kTN;
          const int f = k0 + k, t = t0 + c;
          ss[k][c] = (f < F && t < T) ? S[(size_t)f * T + t] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kTK; ++k) {
          const float4 a = *reinterpret_cast<const float4*>(&fbs[k][ty * 4]);
          const float4 s = *reinterpret_cast<const float4*>(&ss[k][tx * 4]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(av[i], sv[j], acc[i][j]);
        }
        __syncthreads();
      }
      // First pass: L = 10 log10(max(mel, amin)) and the running max.
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = t0 + tx * 4 + j;
          if (m < n_mels && t < T) {
            const float L = __fmul_rn(10.f, log10f(fmaxf(acc[i][j], kAmin)));
            O[(size_t)m * T + t] = L;
            local_max = fmaxf(local_max, L);
          }
        }
      }
    }
  }

  // ref = max over the whole item (max is exact in any order).
  for (int off = 16; off > 0; off >>= 1)
    local_max = fmaxf(local_max, __shfl_xor_sync(0xffffffffu, local_max, off));
  if (tid % 32 == 0) warp_max[tid / 32] = local_max;
  // Also makes every thread's first-pass stores visible to the block.
  __syncthreads();
  float ref = warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) ref = fmaxf(ref, warp_max[w]);

  // Second pass: dB, top_db clip, the uint8 grid, / 255.
  const int n = n_mels * T;
  for (int i = tid; i < n; i += kThreads) {
    const float db = fmaxf(__fsub_rn(O[i], ref), -top_db);
    float x = __fmul_rn(__fadd_rn(db, max_db), scale);
    x = fminf(fmaxf(x, 0.f), 255.f);
    if (quantize) x = floorf(__fadd_rn(x, 0.5f));
    O[i] = __fmul_rn(x, 1.f / 255.f);  // as PyTorch's CUDA x / 255
  }
}

}  // namespace

extern "C" int fused_mel_unit_image(const float* fb, const float* spec,
                                    float* out, int batch, int n_mels, int F,
                                    int T, float max_db, float top_db,
                                    float scale, int quantize, void* stream) {
  if (batch <= 0 || n_mels <= 0 || T <= 0) return 0;
  mel_unit_image_kernel<<<batch, kThreads, 0,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      fb, spec, out, n_mels, F, T, max_db, top_db, scale, quantize);
  return static_cast<int>(cudaGetLastError());
}
