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
//   dgrad      the conv's input gradient: the incoming gradient in the
//              dtype (kernel D's backward rounds it once, as the TPU
//              kernel casts g before each conv input-grad), taps flipped,
//              contraction over Cout, f32 out;
//   unpool2    the max-pool's backward: each pooled gradient goes to the
//              first maximum of its window in the order (0,0), (0,1),
//              (1,0), (1,1) of the pre-pool map, zeros elsewhere.
//
// What bounds it on the H100: operations.  At 128x128 the trunk is 8.46
// GFLOP per sample for the value (both branches) and 12.7 GFLOP with the
// gradient: 1.08 and 1.62 TFLOP at B = 128, 1.09 and 1.64 ms at the
// 989 TFLOP/s bf16 tensor-core rate.  Every conv is a large product
// (2,048 to 8,192 tiles of 128 x 128 at B = 128), far above the 295
// FLOP/B line, so the convs must run on the tensor cores.
//
// bf16 (the product path): each conv and each input gradient is a
// tensor-core implicit GEMM, conv3x3_wgmma_kernel.  A CTA owns 128 pixels
// (8 rows x 16 columns of one image) x BN output channels: 256 where they
// are a multiple of 256, else 128 or 64.  K runs over 9 taps x the
// contraction channels in steps of 64: one 64-channel bf16 row is 128
// bytes, the 128-byte swizzle atom.  One producer thread keeps a ring of
// stages full by TMA: a 4-D tensor map over the activation [NB, H, W, C]
// loads the box of 64 channels x 16 columns x 8 rows at coordinates
// shifted by the tap's (dy, dx), so TMA's out-of-bounds zero fill is the
// conv's pad-1 halo (no bounds checks), and a 2-D map over the packed
// weights loads BN x 64.  Two consumer warpgroups (64 pixels each) run wgmma.mma_async
// m64nBNk16 on the staged tiles, f32 accumulators in registers, and
// release a stage through an mbarrier once the next stage's products are
// issued.  288 threads: two consumer warpgroups and the producer's warp.
// BN = 256 (wgmma m64n256, the widest: the fewest shared-memory bytes per
// product) takes 4 stages of 48 KB and one CTA per SM; BN <= 128 takes 3
// stages (97 KB), so two CTAs share an SM and one CTA's epilogue overlaps
// the other's products (conv2's K is only 9 steps).  Weights are packed by
// ops/fused_trunk.py: forward [9, Cout, Cin], input gradient [9, Cin,
// Cout] with the taps taken at (-dy, -dx); both are K-major.
// Epilogues: forward + f32 bias, round to bf16, ReLU (the rounding points
// of conv_relu); input gradient f32 out.  The incoming gradient is bf16
// (kernel D's backward writes it so).  Limits: channels a multiple of 64,
// H a multiple of 8, W of 16.
//
// f32 (a parity instrument, not the product path): the first version's
// CUDA-core conv3x3_kernel, a 128 x 64 tile implicit GEMM staged through
// shared memory in f32 with exact fmaf products; channels a multiple of 4.
//
// Interface: plain C, bound with ctypes; each entry returns a CUDA error
// (cudaGetLastError() after the launch).  dtype 0: float32, 1: bfloat16.
// The tensor maps are built on the host with cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cuda.h>   // CUtensorMap and its enums (types only; no -lcuda)
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

// Four consecutive f32 elements (16 bytes), aligned.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
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


// ---- bf16: the tensor-core implicit GEMM --------------------------------

namespace tc {

constexpr int kBoxW = 16, kBoxH = 8;     // a tile's pixels: 8 rows x 16 columns
constexpr int kBM = kBoxW * kBoxH;       // 128 pixels per tile
constexpr int kBK = 64;                  // contraction channels per step
constexpr int kConsumers = 2;            // warpgroups, 64 pixels each
constexpr int kThreads = 128 * kConsumers + 32;   // + the producer warp
constexpr uint32_t kATileBytes = kBM * kBK * 2;    // 16 KB

// BN <= 128: 3 stages, two CTAs per SM; BN = 256: 4 stages, one.
template <int BN> struct Layout {
  static constexpr int kStages = BN == 256 ? 4 : 3;
  static constexpr int kMinBlocks = BN == 256 ? 1 : 2;
  static constexpr uint32_t kStageBytes = kATileBytes + BN * kBK * 2;
  // the ring, its 2 x kStages mbarriers, and slack to align to 1024 B
  static constexpr uint32_t kSmemBytes = kStages * kStageBytes +
                                         2 * kStages * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A wait this long means a stage will never arrive (a fault): trap rather
// than hang the card.
constexpr uint64_t kWaitLimitNs = 2000000000ull;

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try(a, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try(a, parity)) {
    if (global_ns() - t0 > kWaitLimitNs) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows written by TMA with
// the 128-byte swizzle (1024-byte aligned): stride between 8-row groups
// 1024 B, layout 1 (128B swizzle).  Advancing K by 16 elements adds 32 B
// (2 units of 16 B) to the start address.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// D[64, 128] += A[64, 16] B[16, 128]: both operands K-major in shared
// memory (128-byte swizzle descriptors), f32 accumulators; scale_d = 0
// overwrites D.
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64, 64] += A[64, 16] B[16, 64]: both operands K-major in shared
// memory (128-byte swizzle descriptors), f32 accumulators; scale_d = 0
// overwrites D.
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 256) wgmma_n256(d, da, db, 1);
  else if constexpr (BN == 128) wgmma_n128(d, da, db, 1);
  else wgmma_n64(d, da, db, 1);
}

// Forward (kDgrad false): act = x [NB, H, W, Kc = Cin] bf16, wts = [9,
//   Nc = Cout, Cin], out = y [NB, H, W, Cout] bf16 = relu(round(acc +
//   bias)), src = (y + dy, x + dx).
// Input gradient (kDgrad true): act = g [NB, H, W, Kc = Cout] bf16, wts =
//   [9, Nc = Cin, Cout], out = dx [NB, H, W, Cin] f32 = acc, src = (y -
//   dy, x - dx).
// Grid: one CTA per (128-pixel tile, BN-channel tile), the channel tile
// fastest so that neighbouring CTAs share the activation tile in L2.
template <bool kDgrad, int BN>
__global__ void __launch_bounds__(kThreads, Layout<BN>::kMinBlocks)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap act,
                     const __grid_constant__ CUtensorMap wts,
                     const float* __restrict__ bias, void* __restrict__ out,
                     int H, int W, int Kc, int Nc) {
  using L = Layout<BN>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + kStages * L::kStageBytes);
  uint64_t* empty = full + kStages;

  const int n_tiles = Nc / BN;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int p_tile = blockIdx.x / n_tiles;
  const int tiles_x = W / kBoxW, per_img = tiles_x * (H / kBoxH);
  const int img = p_tile / per_img;
  const int y0 = (p_tile % per_img) / tiles_x * kBoxH;
  const int x0 = (p_tile % per_img) % tiles_x * kBoxW;
  const int cblocks = Kc / kBK;
  const int nk = 9 * cblocks;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer: one thread keeps the ring full.
    if (threadIdx.x == kConsumers * 128) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
        const int tap = it / cblocks, c0 = (it % cblocks) * kBK;
        const int dy = kDgrad ? 1 - tap / 3 : tap / 3 - 1;
        const int dx = kDgrad ? 1 - tap % 3 : tap % 3 - 1;
        uint8_t* stage = smem + s * L::kStageBytes;
        mbar_expect_tx(&full[s], L::kStageBytes);
        tma_load_4d(stage, &act, &full[s], c0, x0 + dx, y0 + dy, img);
        tma_load_2d(stage + kATileBytes, &wts, &full[s], c0, tap * Nc + n0);
      }
    }
    return;
  }

  // Consumers: warpgroup wg multiplies pixels 64 wg ... 64 wg + 63.
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < nk; ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const uint8_t* stage = smem + s * L::kStageBytes;
    const uint64_t da = sw128_desc(stage + wg * (kATileBytes / 2));
    const uint64_t db = sw128_desc(stage + kATileBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_tile<BN>(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();   // the previous stage's products are done: release it
    if (it > 0) mbar_arrive(&empty[(it - 1) % kStages]);
  }
  wgmma_wait<0>();

  // Epilogue.  Accumulator v of a thread: pixel 16 warp + lane / 4 +
  // 8 ((v / 2) % 2) of the warpgroup's 64, channel 8 (v / 4) + 2 (lane %
  // 4) + v % 2.
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wg * 64 + warp * 16 + lane / 4 + 8 * i;
    const int y = y0 + r / kBoxW, x = x0 + r % kBoxW;
    const size_t row = (((size_t)img * H + y) * W + x) * Nc + n0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      const float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
      if constexpr (kDgrad) {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + row + c) =
            make_float2(v0, v1);
      } else {
        const float2 b = *reinterpret_cast<const float2*>(bias + n0 + c);
        const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
        __nv_bfloat16 r0 = __float2bfloat16_rn(v0 + b.x);
        __nv_bfloat16 r1 = __float2bfloat16_rn(v1 + b.y);
        r0 = __bfloat162float(r0) > 0.f ? r0 : zero;
        r1 = __bfloat162float(r1) > 0.f ? r1 : zero;
        __nv_bfloat162 h;
        h.x = r0;
        h.y = r1;
        *reinterpret_cast<__nv_bfloat162*>(
            static_cast<__nv_bfloat16*>(out) + row + c) = h;
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor map with the 128-byte swizzle; OOB elements read as zero.
int encode(CUtensorMap* map, const void* base, int rank,
           const cuuint64_t* dims, const cuuint64_t* strides,
           const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<void*>(base), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <bool kDgrad, int BN>
int launch(const void* act, const void* wts, const float* bias, void* out,
           int NB, int H, int W, int Kc, int Nc, cudaStream_t s) {
  CUtensorMap amap, wmap;
  const cuuint64_t adims[4] = {(cuuint64_t)Kc, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)NB};
  const cuuint64_t astrides[3] = {(cuuint64_t)Kc * 2, (cuuint64_t)W * Kc * 2,
                                  (cuuint64_t)H * W * Kc * 2};
  const cuuint32_t abox[4] = {kBK, kBoxW, kBoxH, 1};
  const cuuint64_t wdims[2] = {(cuuint64_t)Kc, (cuuint64_t)9 * Nc};
  const cuuint64_t wstrides[1] = {(cuuint64_t)Kc * 2};
  const cuuint32_t wbox[2] = {kBK, BN};
  int err = encode(&amap, act, 4, adims, astrides, abox);
  if (err) return err;
  err = encode(&wmap, wts, 2, wdims, wstrides, wbox);
  if (err) return err;
  auto kern = conv3x3_wgmma_kernel<kDgrad, BN>;
  static bool opted_in = false;   // once per instantiation
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Layout<BN>::kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const unsigned grid = (unsigned)((long long)NB * (H / kBoxH) * (W / kBoxW) *
                                   (Nc / BN));
  kern<<<grid, kThreads, Layout<BN>::kSmemBytes, s>>>(amap, wmap, bias, out,
                                                      H, W, Kc, Nc);
  return static_cast<int>(cudaGetLastError());
}

// The tile geometry: channels in 64s, whole 8 x 16 pixel tiles.
inline bool fits(int H, int W, int Kc, int Nc) {
  return Kc % kBK == 0 && Nc % 64 == 0 && H % kBoxH == 0 && W % kBoxW == 0;
}

template <bool kDgrad>
int conv(const void* act, const void* wts, const float* bias, void* out,
         int NB, int H, int W, int Kc, int Nc, cudaStream_t s) {
  if (!fits(H, W, Kc, Nc)) return static_cast<int>(cudaErrorInvalidValue);
  if (Nc % 256 == 0)
    return launch<kDgrad, 256>(act, wts, bias, out, NB, H, W, Kc, Nc, s);
  return Nc % 128 == 0
             ? launch<kDgrad, 128>(act, wts, bias, out, NB, H, W, Kc, Nc, s)
             : launch<kDgrad, 64>(act, wts, bias, out, NB, H, W, Kc, Nc, s);
}

}  // namespace tc

}  // namespace

// dtype 1 (bf16): w = [9, Cout, Cin] (the tensor-core kernel); dtype 0
// (f32): w = [9, Cin, Cout] (the CUDA-core kernel).
extern "C" int trunk_conv3x3(const void* x, const void* w, const float* bias,
                             void* y, int dtype, int NB, int H, int W, int Cin,
                             int Cout, void* stream) {
  if ((long long)NB * H * W == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return tc::conv<false>(x, w, bias, y, NB, H, W, Cin, Cout, s);
  conv3x3_kernel<float, false><<<conv_grid(NB, H, W, Cout), kThreads, 0, s>>>(
      x, static_cast<const float*>(w), bias, y, NB, H, W, Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}

// g [NB, H, W, Cout] in the dtype (bf16 or f32), w = [9, Cin, Cout] for
// both dtypes; dx [NB, H, W, Cin] f32.
extern "C" int trunk_conv3x3_dgrad(const void* g, const void* w, float* dx,
                                   int dtype, int NB, int H, int W, int Cin,
                                   int Cout, void* stream) {
  if ((long long)NB * H * W == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return tc::conv<true>(g, w, nullptr, dx, NB, H, W, Cout, Cin, s);
  conv3x3_kernel<float, true><<<conv_grid(NB, H, W, Cin), kThreads, 0, s>>>(
      g, static_cast<const float*>(w), nullptr, dx, NB, H, W, Cin, Cout);
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
