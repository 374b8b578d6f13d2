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
// What bounds it on the H100.  Dense, an item is 34.1 MFLOP of f32
// products (n_mels 128, F 1025, T 130) against 0.6 MB of input, so the
// dense bound is the f32 CUDA-core rate (67 TFLOP/s): 0.51 us for B = 1.
// But a Slaney filterbank is one contiguous band of nonzero bins per row
// (4 to 53 bins wide at 22,050 Hz and n_fft 2048; 2,018 nonzeros of
// 131,200), so the work that matters is 2,018 x 130 multiply-adds per
// item, and the kernel is bound by the latency of one read of S and of
// the per-item reduction, not by either rate.  Tensor cores are not used
// on purpose: TF32 keeps 10 mantissa bits and would move values across
// the uint8 grid.
//
// Design.
// - Band-limited sums.  The host gives each row's band [lo, hi) (first
//   nonzero column, one past the last; ops/fused_mel_image.py mel_bands)
//   and groups of consecutive rows balanced by band width (row_groups);
//   a group's bins are the union of its rows' bands.  Each output sums
//   its own row's band only, in ascending k with fmaf from +0.  That is
//   the order of a dense ascending sum, and outside the band every
//   product is fmaf(0, s, acc) = acc for finite s, so the mel values are
//   those of the dense sum bit for bit.  A non-finite S value outside a
//   row's band is skipped and no longer makes that row NaN (the STFT of
//   finite audio is finite).  A dense filterbank gives full-width bands
//   and the same answer, slower.
// - Spread over the SMs.  Grid (frame tile x row group, B): at the front
//   end's B = 1 the Slaney filterbank (128 mels, n_fft 2048) gives 67
//   groups, so as many CTAs; each item is spread over all of them.  A CTA stages S[its
//   group's bins, its 160-frame tile] through shared memory in slices of
//   kSlice bins with cp.async, the next slice in flight while the warps
//   compute on the current one.  A warp owns (row, 32 frames): lanes are
//   frames, so the slice reads are conflict-free, and the row's
//   coefficients are loaded 32 at a time, one per lane, and broadcast by
//   shuffle.  Sums carry across slices in shared memory.
// - S in its own strides.  The STFT gives S frame-major (bins
//   contiguous), and a contiguous [F, T] item has rows of T floats (520
//   bytes at T = 130): only 4-byte copies are aligned in both, so
//   cp.async moves 4 bytes a lane, and the lanes of a warp walk the
//   unit-stride axis (frames, or bins) so its reads are contiguous; the
//   staged rows are padded to kTileT + 1 floats so both orders write
//   shared memory without bank conflicts.  No copy to a contiguous
//   layout is made.
// - ref = max(L) across CTAs in the same launch, by ticket (as kernel D,
//   csrc/normalized_mse.cu): each CTA writes its L values and its own
//   maximum, fences, and takes its item's ticket; the item's last CTA
//   merges the maxima (exact in any order), applies the epilogue to the
//   whole item and resets the ticket.  Tickets are per (device, stream)
//   on the host side, so launches that can overlap never share one.
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

// The frame tile and the largest row group come from the wrapper, which
// plans the row groups by them (ops/fused_mel_image.py TILE_FRAMES,
// MAX_ROWS): 160 and 24.
#if !defined(MEL_TILE_T) || !defined(MEL_MAX_ROWS)
#error "build with -DMEL_TILE_T and -DMEL_MAX_ROWS (ops/fused_mel_image.py)"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileT = MEL_TILE_T;     // frames per CTA
constexpr int kChunks = kTileT / 32;   // 32-frame chunks per frame tile
constexpr int kRow = kTileT + 1;       // staged row stride (bank padding)
constexpr int kSlice = 24;             // bins per staged slice
constexpr int kMaxRows = MEL_MAX_ROWS; // rows per group (row_groups)
constexpr float kAmin = 1e-10f;
static_assert(kTileT % 32 == 0, "a frame tile is whole 32-frame chunks");
// 2 slices (30,912 B) + sums (15,360 B) at 160 x 24: static, under 48 KB.
static_assert(4 * (2 * kSlice * kRow + kMaxRows * kTileT) <= 48 * 1024,
              "static shared memory over 48 KB");

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 fills the word with zero and reads nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float image_value(float L, float ref, float max_db,
                                             float top_db, float scale,
                                             int quantize) {
  const float db = fmaxf(__fsub_rn(L, ref), -top_db);
  float x = __fmul_rn(__fadd_rn(db, max_db), scale);
  x = fminf(fmaxf(x, 0.f), 255.f);
  if (quantize) x = floorf(__fadd_rn(x, 0.5f));
  return __fmul_rn(x, 1.f / 255.f);  // as PyTorch's CUDA x / 255
}

// bands [n_mels, 2] (lo, hi); groups [n_groups, 4] (row0, row1, bin_lo,
// bin_hi); S[b, k, t] at spec[b sb + k sf + t st]; blockIdx.x = group *
// n_tiles + tile, blockIdx.y = item.  cta_max [B, gridDim.x]; tickets
// [B], 0 on entry and on exit.
__global__ void __launch_bounds__(kThreads)
mel_unit_image_kernel(const float* __restrict__ fb,
                      const float* __restrict__ spec, long long sb,
                      long long sf, long long st,
                      const int2* __restrict__ bands,
                      const int4* __restrict__ groups, int n_tiles,
                      int n_mels, int F, int T, float* out,
                      float* cta_max, unsigned* tickets, float max_db,
                      float top_db, float scale, int quantize) {
  __shared__ __align__(16) float stage[2][kSlice * kRow];
  __shared__ __align__(16) float sums[kMaxRows * kTileT];
  __shared__ float red[kWarps];
  __shared__ bool last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int tile = blockIdx.x % n_tiles;
  const int4 g = groups[blockIdx.x / n_tiles];
  const int row0 = g.x, n_rows = g.y - g.x, bin_lo = g.z, bin_hi = g.w;
  const int t0 = tile * kTileT, tn = min(kTileT, T - t0);
  const float* S = spec + b * sb;
  float* O = out + (size_t)b * n_mels * T;

  for (int i = tid; i < n_rows * kTileT; i += kThreads) sums[i] = 0.f;

  // S[k0 .. k0 + kSlice) x [t0, t0 + kTileT) -> dst [k][kRow]; frames
  // past T are 0.  Consecutive threads take consecutive elements of the
  // unit-stride axis.
  auto load_slice = [&](int k0, float* dst) {
    const int nk = min(kSlice, bin_hi - k0), n = nk * kTileT;
    for (int i = tid; i < n; i += kThreads) {
      int k, c;
      if (st == 1) {
        k = i / kTileT;
        c = i - k * kTileT;
      } else {
        c = i / nk;
        k = i - c * nk;
      }
      const bool ok = c < tn;
      cp_async4(dst + k * kRow + c, ok ? S + (k0 + k) * sf + (t0 + c) * st : S,
                ok);
    }
    cp_async_commit();
  };

  const int n_slices = (bin_hi - bin_lo + kSlice - 1) / kSlice;
  const int n_tasks = n_rows * kChunks;
  if (n_slices > 0) load_slice(bin_lo, stage[0]);
  for (int s = 0; s < n_slices; ++s) {
    const int k0 = bin_lo + s * kSlice, k1 = min(k0 + kSlice, bin_hi);
    if (s + 1 < n_slices) {
      load_slice(k1, stage[(s + 1) & 1]);   // in flight during this slice
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // slice s has landed for every thread
    const float* cur = stage[s & 1];
    for (int task = warp; task < n_tasks; task += kWarps) {
      const int r = task / kChunks, col = (task - r * kChunks) * 32 + lane;
      const int2 band = bands[row0 + r];
      const int a = max(band.x, k0), e = min(band.y, k1);
      if (a >= e) continue;   // uniform across the warp
      const float* frow = fb + (size_t)(row0 + r) * F;
      float acc = sums[r * kTileT + col];
      for (int kc = a; kc < e; kc += 32) {
        const int n = min(32, e - kc);
        const float coef = lane < n ? __ldg(frow + kc + lane) : 0.f;
        const float* sv = cur + (kc - k0) * kRow + col;
        for (int j = 0; j < n; ++j)
          acc = fmaf(__shfl_sync(0xffffffffu, coef, j), sv[j * kRow], acc);
      }
      sums[r * kTileT + col] = acc;
    }
    __syncthreads();   // sums updated; stage[s & 1] may be refilled
  }
  __syncthreads();

  // L = 10 log10(max(mel, amin)) for this CTA's outputs, and their max.
  float local_max = -INFINITY;
  for (int i = tid; i < n_rows * kTileT; i += kThreads) {
    const int r = i / kTileT, c = i - r * kTileT;
    if (c < tn) {
      const float L = __fmul_rn(10.f, log10f(fmaxf(sums[i], kAmin)));
      O[(size_t)(row0 + r) * T + t0 + c] = L;
      local_max = fmaxf(local_max, L);
    }
  }
  __threadfence();   // this thread's L stores before the CTA's ticket
  local_max = warp_max(local_max);
  if (lane == 0) red[warp] = local_max;
  __syncthreads();
  if (tid == 0) {
    float m = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
    cta_max[(size_t)b * gridDim.x + blockIdx.x] = m;
    __threadfence();
    last = atomicAdd(&tickets[b], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The item's last CTA: ref = max of the CTAs' maxima, then the epilogue
  // over the whole item (L as the other CTAs wrote it, read past L1).
  float ref = -INFINITY;
  for (int q = tid; q < (int)gridDim.x; q += kThreads)
    ref = fmaxf(ref, __ldcg(cta_max + (size_t)b * gridDim.x + q));
  ref = warp_max(ref);
  if (lane == 0) red[warp] = ref;
  __syncthreads();
  ref = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) ref = fmaxf(ref, red[w]);

  const int n = n_mels * T;
  if (n % 4 == 0) {   // O is then 16-byte aligned: rows of float4
    float4* O4 = reinterpret_cast<float4*>(O);
    for (int i = tid; i < n / 4; i += kThreads) {
      float4 v = __ldcg(O4 + i);
      v.x = image_value(v.x, ref, max_db, top_db, scale, quantize);
      v.y = image_value(v.y, ref, max_db, top_db, scale, quantize);
      v.z = image_value(v.z, ref, max_db, top_db, scale, quantize);
      v.w = image_value(v.w, ref, max_db, top_db, scale, quantize);
      O4[i] = v;
    }
  } else {
    for (int i = tid; i < n; i += kThreads)
      O[i] = image_value(__ldcg(O + i), ref, max_db, top_db, scale, quantize);
  }
  if (tid == 0) tickets[b] = 0u;
}

}  // namespace

// fb [n_mels, F] contiguous, spec [batch, F, T] in strides (sb, sf, st)
// elements, out [batch, n_mels, T] contiguous (16-byte aligned); bands
// [n_mels, 2] and groups [n_groups, 4] int32 from ops/fused_mel_image.py
// (every group at most kMaxRows rows, max_rows its largest); cta_max
// [batch, n_groups * ceil(T / kTileT)] scratch; tickets [batch] zeroed
// unsigned ints, left zeroed.
extern "C" int fused_mel_unit_image(const float* fb, const float* spec,
                                    long long sb, long long sf, long long st,
                                    const int* bands, const int* groups,
                                    int n_groups, int max_rows, float* out,
                                    float* cta_max, unsigned* tickets,
                                    int batch, int n_mels, int F, int T,
                                    float max_db, float top_db, float scale,
                                    int quantize, void* stream) {
  if (batch <= 0 || n_mels <= 0 || T <= 0) return 0;
  if (n_groups <= 0 || max_rows > kMaxRows || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (T + kTileT - 1) / kTileT;
  const dim3 grid(n_groups * n_tiles, batch);
  mel_unit_image_kernel<<<grid, kThreads, 0,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      fb, spec, sb, sf, st, reinterpret_cast<const int2*>(bands),
      reinterpret_cast<const int4*>(groups), n_tiles, n_mels, F, T, out,
      cta_max, tickets, max_db, top_db, scale, quantize);
  return static_cast<int>(cudaGetLastError());
}
