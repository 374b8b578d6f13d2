// The whole DDIM / DPM-Solver++(2M) sampling trajectory in one launch
// (kernel A).
//
// Replaces music_style_transfer_ldm_tpu/ops/pallas/fused_sampler.py
// fused_ddim_sample (the pallas_call at :522): S-1 steps of the
// style-attending UNet plus the folded update
//     x <- A x + B eps + C prev,   prev <- P x + Q eps
// with no host in the step loop.  It ports what that kernel computes and
// what it keeps out of device memory (every weight stays on chip for all
// steps), not its TPU formulation.
//
// Bound on the H100 (B = 1, 49 steps): 51.5 M MAC per element-step (47.2 M
// in the nine convs, 4.3 M in attention), 5.05 GFLOP, about 5.1 us at 989
// TFLOP/s bf16; the 12.3 MB of bf16 weights read once take 3.7 us at 3.35
// TB/s.  At B <= 8 the real floor is the dependency chain: 15 layer
// phases per step, each waiting for the one before across the whole
// UNet, so 735 grid-wide barriers per trajectory.
//
// Design: one persistent cooperative launch per trajectory.
// - Grid = the card's SM count (cudaGetDeviceProperties), one 512-thread
//   block per SM, launched with cudaLaunchCooperativeKernel so that all
//   blocks are resident; a refused launch returns its error (no
//   fallback).  Phases are separated by a hand-written grid barrier: one
//   arrival counter in global memory, red.release.gpu to arrive,
//   ld.acquire.gpu to wait.
// - Weight-stationary blocks.  Every conv and q/out projection is a
//   [Cout, K] matrix (K = 9 Cin tap-major, or Cin) cut into 16-row tiles;
//   small layers' tiles are replicated, replica r taking batch elements
//   r, r + R, ...  The host plan (ops/fused_sampler.py launch_plan) maps
//   each (layer, tile, replica) slot to one block, never two slots of one
//   layer to a block, so a phase's tiles run side by side.  In the bf16
//   instance a block copies its tiles once per launch from HBM into its
//   dynamic shared memory with TMA bulk copies (cp.async.bulk behind one
//   mbarrier) and reuses them for every step: the biggest tile, 16
//   channels of the bottleneck, is 147 KB; with the 72 KB of scratch a
//   block needs at most 221 KB of its 227 KB.
// - Tensor cores: each conv is an implicit GEMM, output channels on M
//   (the stationary weight tile), pixels x batch on N, K = 9 Cin.  N is
//   small (4 B at 2x2, 256 B at 16x16), so mma.sync.m16n8k16 (bf16 in,
//   f32 accumulate) fits the 16-channel tiles as they are; wgmma's 64-row
//   tile would need 64-channel tiles (590 KB at the bottleneck) and so
//   split-K across blocks.  The weights are packed in A-fragment order,
//   so a lane reads its fragment as one 16-byte word.  The unit's input
//   maps are staged from global memory (L2-resident) into shared memory,
//   one pass of G elements at a time, pixel rows padded by 16 bytes
//   against bank conflicts; ldmatrix.x4 reads the B fragments of two
//   8-column tiles straight from those rows, each lane pointing at the
//   source pixel of its column under the tap (stride-1, stride-2,
//   transpose or one-tap geometry), or at a zero row where there is none.
//   A warp runs one k-part of a group of four tiles, one A fragment for
//   four independent products; a tap that no column of the group uses is
//   skipped, and a transpose conv's columns run by output parity class
//   so that a group shares its one, two or four live taps.  K is split
//   over warps by a fixed per-layer factor; the partial sums go to shared
//   memory and are added in k-part order, then bias, ReLU, the
//   time-embedding or skip add (prefetched before the gather), and
//   rounding to T, two channels per store.  dec1's epilogue writes f32
//   eps straight into the update of the f32 x and prev carries; enc1's
//   gather rounds the next step's x to T.
// - Cross-attention is three phases: q projection (a one-tap GEMM), the
//   core per (element, head) on CUDA cores against this element's K/V
//   (softmax in f32, probabilities rounded to T), out projection.
// - The f32 instance keeps the same structure and plan, and exact f32 FMA
//   on CUDA cores (TF32 would miss the 1e-4 bar); its 24.6 MB of weights
//   stay in global memory, L2-resident, read through the same packed
//   layout.
// - Batched equals per element: every output sums its own element's K in
//   an order fixed by the layer (k-part split and mma order do not depend
//   on B or on the pass size), with no atomics, so one request alone and
//   inside a batch give the same bits.
// Activations cross blocks through a workspace in global memory that the
// caller allocates (read with ld.global.cg, so no stale L1 line is seen);
// the kernel allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLayers = 13;
constexpr int kPhases = 15;
constexpr int kMaxSlots = kLayers;
constexpr int kGroup = 4;        // 8-column mma tiles per warp item
constexpr int kOutPairs = 4;     // bf16 epilogue: channel pairs per thread
constexpr int kHeads = 4;
constexpr int kLatPix = 256;   // 16 x 16 latent pixels
constexpr int kLat = 32;       // latent channels
constexpr int kTemb = 128;

enum Kind { kS1 = 0, kS2 = 1, kT = 2, kProj = 3 };

}  // namespace

// Mirrored by ctypes structures in ops/fused_sampler.py.
struct LayerDesc {
  int kind, cin, cout, hin, hout, replicas, group, ksplit;
  int w_off, b_off;        // elements into weights / biases
  int in_off, out_off;     // elements into the workspace; -1 = x / eps
  int skip_off;            // -1 = none
  int temb, relu, eps_out;
};

struct AttnDesc {
  int q_off, att_off, rows, channels, keys, kv, pad0, pad1;
};

struct SamplerArgs {
  const void* weights;     // T, every layer's tiles in fragment order
  const void* biases;      // T
  const void* kv[4];       // T [B, Tk, C]: k5 v5 k6 v6
  const void* temb;        // T [n_steps, 128]
  const float* coefs;      // [n_steps, 5]: A B C P Q
  const float* x_in;       // [B, 256, 32]
  float* x_out;            // [B, 256, 32], the x carry
  void* workspace;         // T activations
  float* prev;             // [B, 256, 32], the prev carry
  unsigned* barrier;       // one zeroed arrival counter
  const int* plan;         // [grid][kMaxSlots][layer, tile, replica, smem]
  LayerDesc layers[kLayers];
  AttnDesc attn[2];
  int phases[kPhases];     // a layer, or -1 - a for attention a's core
  int n_steps, batch, scratch_off, smem_bytes;
};

namespace {

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
  return __float2bfloat16(v);
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A wait longer than this means a block will never arrive (a fault, or a
// grid that is not all resident): trap rather than hang the card.
constexpr uint64_t kWaitLimitNs = 2000000000ull;

// Grid-wide barrier: every block arrives once; the counter only grows,
// so barrier n completes at n x gridDim.x arrivals.  The block's writes
// are ordered before thread 0's release by __syncthreads, and its reads
// after thread 0's acquire likewise (the pattern of CUTLASS's
// GenericBarrier).
__device__ __forceinline__ void grid_sync(unsigned* counter,
                                          unsigned& target) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
                 :: "l"(counter), "r"(1u) : "memory");
    const uint64_t t0 = global_ns();
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen) : "l"(counter) : "memory");
      if (global_ns() - t0 > kWaitLimitNs) __trap();
    } while (seen < target);
  }
  __syncthreads();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// Input pixel (iy, ix) of output pixel (oy, ox) under tap (ky, kx);
// false where there is none (a negative oy has none).
__device__ __forceinline__ bool src_pixel(int kind, int hin, int oy, int ox,
                                          int ky, int kx, int& iy, int& ix) {
  if (kind == kProj) {
    iy = oy;
    ix = ox;
  } else if (kind == kT) {   // ConvTranspose2d(k3, s2, p1, op1)
    const int ty = oy + 1 - ky, tx = ox + 1 - kx;   // = 2 iy, 2 ix
    iy = (ty & 1) ? -1 : ty >> 1;
    ix = (tx & 1) ? -1 : tx >> 1;
  } else {
    const int step = kind == kS2 ? 2 : 1;
    iy = step * oy - 1 + ky;
    ix = step * ox - 1 + kx;
  }
  return iy >= 0 && iy < hin && ix >= 0 && ix < hin;
}

// Element of the packed weight tile holding W[m][k] (fragment order; see
// ops/fused_sampler.py pack_tiles).
__device__ __forceinline__ int frag_index(int m, int k) {
  const int kk = k & 15;
  return (((((k >> 4) * 8 + (m & 7)) * 4 + ((kk & 7) >> 1)) * 2 + (kk >> 3))
              * 2 + (m >> 3)) * 2 + (kk & 1);
}

// Every map side and channel count is a power of two: divide by shifts.
__device__ __forceinline__ int ilog2(int x) { return 31 - __clz(x); }

template <typename T>
struct Step {
  const T* temb;     // this step's row
  float A, B, C, P, Q;
};

// 16 bytes of T of the unit's input at element offset `src`: a plain
// load, or for enc1 four or eight floats of the f32 x carry rounded to T.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const LayerDesc& L,
                                            const SamplerArgs& a,
                                            size_t src) {
  if (L.in_off >= 0) {
    return __ldcg(reinterpret_cast<const uint4*>(
        static_cast<const T*>(a.workspace) + L.in_off + src));
  }
  constexpr int kVec = 16 / sizeof(T);
  uint4 out;
  T* o = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int v = 0; v < kVec; v += 4) {
    const float4 f = __ldcg(reinterpret_cast<const float4*>(
        a.x_out + src + v));
    o[v] = from_f<T>(f.x);
    o[v + 1] = from_f<T>(f.y);
    o[v + 2] = from_f<T>(f.z);
    o[v + 3] = from_f<T>(f.w);
  }
  return out;
}

// Stage the input maps of g elements (e = rep + R (j0 + el)) in shared
// memory: [el][pixel][cin + 16 bytes of padding].  Each thread issues
// kBatch loads before it stores any, so their latencies overlap.
template <typename T>
__device__ __forceinline__ void gather(const LayerDesc& L,
                                       const SamplerArgs& a, int rep,
                                       int j0, int g, T* stage) {
  constexpr int kVec = 16 / sizeof(T), kBatch = 4;
  const int cvec = L.cin / kVec;
  const int lc = ilog2(cvec), lp = 2 * ilog2(L.hin);
  const int stride = L.cin + kVec;
  const int total = g * cvec << lp;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kThreads) {
    uint4 buf[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < total) {
        // i = (el, pixel, chunk); element el of the pass is element e
        const int e = rep + L.replicas * (j0 + (i >> (lc + lp)));
        const size_t chunk = ((size_t)e << (lc + lp))
                             + (i & ((1 << (lc + lp)) - 1));
        buf[u] = load_chunk<T>(L, a, chunk * kVec);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < total) {
        *reinterpret_cast<uint4*>(stage + (i >> lc) * stride
                                  + (i & (cvec - 1)) * kVec) = buf[u];
      }
    }
  }
}

// Output pixel of an element's column c.  A transpose conv's columns run
// by parity class (oy & 1, ox & 1), each class taking one, two or four of
// the nine taps, so that a tile of columns skips the taps none of them
// uses; the other layers' columns are the pixels in row order.
__device__ __forceinline__ int col_pixel(const LayerDesc& L, int c) {
  if (L.kind != kT) return c;
  const int lh = ilog2(L.hout);
  const int cls = c >> (2 * lh - 2), w = c & ((1 << (2 * lh - 2)) - 1);
  const int oy = 2 * (w >> (lh - 1)) + (cls >> 1);
  const int ox = 2 * (w & ((1 << (lh - 1)) - 1)) + (cls & 1);
  return (oy << lh) + ox;
}

// Output element of column `col` (pass-local) and channel co.
__device__ __forceinline__ size_t out_index(const LayerDesc& L, int rep,
                                            int j0, int col, int co) {
  const int lo = 2 * ilog2(L.hout);
  const int e = rep + L.replicas * (j0 + (col >> lo));
  const int pix = col_pixel(L, col & ((1 << lo) - 1));
  return ((((size_t)e << lo) + pix) * L.cout) + co;
}

// The epilogue's global operands of one output, read before any store:
// the time-embedding or skip value, or dec1's x and prev.
template <typename T>
__device__ __forceinline__ void epilogue_load(const LayerDesc& L,
                                              const SamplerArgs& a,
                                              const Step<T>& st, int co,
                                              size_t o, float& add,
                                              float& pv) {
  add = 0.f;
  pv = 0.f;
  if (L.temb) add = to_f(st.temb[co]);
  if (L.skip_off >= 0) {
    add = to_f(__ldcg(static_cast<const T*>(a.workspace) + L.skip_off + o));
  }
  if (L.eps_out) {
    add = __ldcg(a.x_out + o);
    pv = __ldcg(a.prev + o);
  }
}

// Bias, ReLU, then the time-embedding or skip add and rounding to T into
// the output map, or (dec1) the f32 update of the carries.
template <typename T>
__device__ __forceinline__ void epilogue_store(const LayerDesc& L,
                                               const SamplerArgs& a,
                                               const Step<T>& st, size_t o,
                                               float v, float bias,
                                               float add, float pv) {
  v += bias;
  if (L.relu) v = fmaxf(v, 0.f);
  if (L.eps_out) {
    a.x_out[o] = st.A * add + st.B * v + st.C * pv;
    a.prev[o] = st.P * add + st.Q * v;
  } else {
    static_cast<T*>(a.workspace)[L.out_off + o] = from_f<T>(v + add);
  }
}

// The bf16 epilogue on channel pairs (co even): one 4-byte load or store
// where the scalar version makes two.
__device__ __forceinline__ void epilogue_load2(
    const LayerDesc& L, const SamplerArgs& a,
    const Step<__nv_bfloat16>& st, int co, size_t o, float2& add,
    float2& pv) {
  add = make_float2(0.f, 0.f);
  pv = make_float2(0.f, 0.f);
  if (L.temb) {
    add = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(st.temb + co));
  }
  if (L.skip_off >= 0) {
    add = __bfloat1622float2(__ldcg(reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const __nv_bfloat16*>(a.workspace) + L.skip_off + o)));
  }
  if (L.eps_out) {
    add = __ldcg(reinterpret_cast<const float2*>(a.x_out + o));
    pv = __ldcg(reinterpret_cast<const float2*>(a.prev + o));
  }
}

__device__ __forceinline__ void epilogue_store2(
    const LayerDesc& L, const SamplerArgs& a,
    const Step<__nv_bfloat16>& st, size_t o, float2 v, float2 bias,
    float2 add, float2 pv) {
  v.x += bias.x;
  v.y += bias.y;
  if (L.relu) {
    v.x = fmaxf(v.x, 0.f);
    v.y = fmaxf(v.y, 0.f);
  }
  if (L.eps_out) {
    *reinterpret_cast<float2*>(a.x_out + o) = make_float2(
        st.A * add.x + st.B * v.x + st.C * pv.x,
        st.A * add.y + st.B * v.y + st.C * pv.y);
    *reinterpret_cast<float2*>(a.prev + o) = make_float2(
        st.P * add.x + st.Q * v.x, st.P * add.y + st.Q * v.y);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(
        static_cast<__nv_bfloat16*>(a.workspace) + L.out_off + o) =
        __floats2bfloat162_rn(v.x + add.x, v.y + add.y);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// `run` k-steps of the mma chains of NJ column tiles (NJ fixed, so no
// branch sits between the loads and the products): per step one A
// fragment (a 16-byte load in the packed order) and the B fragments of
// two tiles per ldmatrix.x4, whose lanes point at the tiles' staged
// pixel rows (rows[0]: tiles 0 and 1, rows[1]: tiles 2 and 3).
template <int NJ>
__device__ __forceinline__ void mma_run(float (*acc)[4], const uint4* ap,
                                        const uint32_t* rows, int run) {
#pragma unroll 2
  for (int r = 0; r < run; ++r) {
    const uint4 af = ap[r * 32];
    uint32_t b[8];
    ldsm_x4(rows[0] + r * 32, b);
    if (NJ > 2) ldsm_x4(rows[1] + r * 32, b + 4);
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_bf16(acc[j], af, b[2 * j], b[2 * j + 1]);
  }
}

// One pass of a bf16 unit on the tensor cores.  A warp's item is one
// k-part of a group of four 8-column tiles: it reads each A fragment
// once for four independent mma chains.  The partial sums go through
// shared memory (over the staged maps) and are added in k-part order.
// A thread's epilogue outputs are channels m, m + 1 (m = 2 (threadIdx.x
// % 8)) of columns threadIdx.x / 8 + 64 r; add / pv hold their operands,
// loaded before the gather.
__device__ __forceinline__ void mma_pass(
    const LayerDesc& L, const SamplerArgs& a, const Step<__nv_bfloat16>& st,
    int tile, int rep, int j0, int g, const __nv_bfloat16* wtile,
    const float* bias, __nv_bfloat16* stage, const __nv_bfloat16* zeros,
    const float2* add, const float2* pv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int npo = L.hout * L.hout;
  const int ncols = g * npo, ntiles = (ncols + 7) / 8, ncp = ntiles * 8;
  const int taps = L.kind == kProj ? 1 : 9;
  const int kper = taps * L.cin / 16 / L.ksplit;
  const int items = L.ksplit * ((ntiles + kGroup - 1) / kGroup);
  const int stride = L.cin + 8;
  const int lh = ilog2(L.hout), lpo = 2 * lh;
  // Partial sums [k-part][16][pitch]: a pitch of 2 mod 32 words keeps the
  // epilogue's reads (16 channels x 2 columns a warp) free of conflicts.
  const int pitch = ncp + 2;
  float acc[kGroup][4];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  const int kp = warp % L.ksplit, grp = warp / L.ksplit;
  if (warp < items) {
    // The staged row this lane points ldmatrix at, per x4: column n of
    // tile grp * 4 + 2 q + lane / 16, channels from 8 ((lane / 8) % 2); a
    // column without a source pixel under a tap reads the zero row.
    const uint32_t stage_u32 = smem_u32(stage);
    const int lhi = ilog2(L.hin);
    int oy[2], ox[2];
    uint32_t ebase[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = (grp * kGroup + 2 * q + (lane >> 4)) * 8 + (lane & 7);
      const bool valid = n < ncols;
      const int el = valid ? n >> lpo : 0;
      const int pix = valid ? col_pixel(L, n & (npo - 1)) : 0;
      oy[q] = valid ? pix >> lh : -4 * L.hin;     // no source pixel
      ox[q] = pix & (L.hout - 1);
      ebase[q] = stage_u32 + 2 * ((el << (2 * lhi)) * stride
                                  + 8 * ((lane >> 3) & 1));
    }
    const uint32_t zero_u32 = smem_u32(zeros) + 16 * ((lane >> 3) & 1);
    // k = 16 s = tap Cin + ci0: walk the taps without dividing.  A tap
    // that no column of the group uses is skipped.
    const int s0 = kp * kper, steps_per_tap = L.cin >> 4;
    const int nj = min(kGroup, ntiles - grp * kGroup);
    int tap = (s0 * 16) >> ilog2(L.cin), ci0 = s0 * 16 - tap * L.cin;
    const uint4* ap = reinterpret_cast<const uint4*>(wtile) + s0 * 32 + lane;
    for (int s = 0; s < kper;) {
      const int ky = tap / 3, kx = tap - 3 * ky;
      uint32_t rows[2];
      bool ok[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        int iy, ix;
        ok[q] = src_pixel(L.kind, L.hin, oy[q], ox[q], ky, kx, iy, ix);
        rows[q] = ok[q] ? ebase[q] + 2 * (((iy << lhi) + ix) * stride + ci0)
                        : zero_u32;
      }
      const bool any = __any_sync(0xffffffffu, ok[0] || (nj > 2 && ok[1]));
      const int run = min(kper - s, steps_per_tap - (ci0 >> 4));
      if (any) {
        switch (nj) {
          case 1: mma_run<1>(acc, ap, rows, run); break;
          case 2: mma_run<2>(acc, ap, rows, run); break;
          case 3: mma_run<3>(acc, ap, rows, run); break;
          default: mma_run<4>(acc, ap, rows, run); break;
        }
      }
      ap += run * 32;
      s += run;
      ci0 = 0;
      ++tap;
    }
  }
  __syncthreads();   // the partials overwrite the staged maps
  float* part = reinterpret_cast<float*>(stage);
  if (warp < items) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int nt = grp * kGroup + j;
      if (nt < ntiles) {
        float* row = part + (kp * 16 + gq) * pitch + nt * 8 + 2 * tq;
        row[0] = acc[j][0];
        row[1] = acc[j][1];
        row[8 * pitch] = acc[j][2];
        row[8 * pitch + 1] = acc[j][3];
      }
    }
  }
  __syncthreads();
  const int m = 2 * (threadIdx.x & 7);
  const float2 b2 = make_float2(bias[m], bias[m + 1]);
#pragma unroll
  for (int r = 0; r < kOutPairs; ++r) {
    const int col = (threadIdx.x >> 3) + 64 * r;
    if (col < ncols) {
      float2 v = make_float2(0.f, 0.f);
      for (int k = 0; k < L.ksplit; ++k) {
        v.x += part[(k * 16 + m) * pitch + col];
        v.y += part[(k * 16 + m + 1) * pitch + col];
      }
      epilogue_store2(L, a, st, out_index(L, rep, j0, col, tile * 16 + m),
                      v, b2, add[r], pv[r]);
    }
  }
  __syncthreads();
}

// One pass of an f32 unit: each thread sums one output over the whole K
// in order, exact f32 FMA, weights through L2.
__device__ __forceinline__ void fma_pass(
    const LayerDesc& L, const SamplerArgs& a, const Step<float>& st,
    int tile, int rep, int j0, int g, const float* bias,
    const float* stage) {
  const int npo = L.hout * L.hout;
  const int ncols = g * npo;
  const int taps = L.kind == kProj ? 1 : 9;
  const int stride = L.cin + 4;
  const int lhi = ilog2(L.hin);
  const float* w = static_cast<const float*>(a.weights) + L.w_off
                   + (size_t)tile * 16 * taps * L.cin;
  for (int i = threadIdx.x; i < ncols * 16; i += kThreads) {
    const int m = i & 15, col = i >> 4;
    const int lh = ilog2(L.hout);
    const int el = col >> (2 * lh), pix = col_pixel(L, col & (npo - 1));
    const int oy = pix >> lh, ox = pix & (L.hout - 1);
    const size_t o = out_index(L, rep, j0, col, tile * 16 + m);
    float add, pv;
    epilogue_load<float>(L, a, st, tile * 16 + m, o, add, pv);
    float acc = 0.f;
    for (int tap = 0; tap < taps; ++tap) {
      int iy, ix;
      if (!src_pixel(L.kind, L.hin, oy, ox, tap / 3, tap % 3, iy, ix)) {
        continue;
      }
      const float* sp = stage + ((el << (2 * lhi)) + (iy << lhi) + ix)
                                * stride;
      const int k0 = tap * L.cin;
      for (int ci = 0; ci < L.cin; ++ci) {
        acc = fmaf(__ldg(w + frag_index(m, k0 + ci)), sp[ci], acc);
      }
    }
    epilogue_store<float>(L, a, st, o, acc, bias[m], add, pv);
  }
  __syncthreads();
}

// All passes of one (layer, tile, replica) unit; bias = the tile's 16
// biases (shared memory).
template <typename T>
__device__ __forceinline__ void run_unit(const LayerDesc& L,
                                         const SamplerArgs& a,
                                         const Step<T>& st, int tile, int rep,
                                         const T* wtile, const float* bias,
                                         T* stage, const T* zeros) {
  const int n_e = rep < a.batch
                      ? (a.batch - rep + L.replicas - 1) / L.replicas : 0;
  for (int j0 = 0; j0 < n_e; j0 += L.group) {
    const int g = min(L.group, n_e - j0);
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      const int ncols = g * L.hout * L.hout;
      if (ncols > kOutPairs * kThreads / 8) __trap();   // the plan bounds it
      float2 add[kOutPairs], pv[kOutPairs];
      const int co = tile * 16 + 2 * (threadIdx.x & 7);
#pragma unroll
      for (int r = 0; r < kOutPairs; ++r) {
        const int col = (threadIdx.x >> 3) + 64 * r;
        add[r] = pv[r] = make_float2(0.f, 0.f);
        if (col < ncols) {
          epilogue_load2(L, a, st, co, out_index(L, rep, j0, col, co),
                         add[r], pv[r]);
        }
      }
      gather<T>(L, a, rep, j0, g, stage);
      __syncthreads();
      mma_pass(L, a, st, tile, rep, j0, g, wtile, bias, stage, zeros, add,
               pv);
    } else {
      gather<T>(L, a, rep, j0, g, stage);
      __syncthreads();
      fma_pass(L, a, st, tile, rep, j0, g, bias, stage);
    }
  }
}

// Cross-attention core of element e, head h: the head's q rows and the
// element's own keys and values staged in shared memory as f32, logits,
// softmax in f32 (m tk <= 256 threads), probabilities rounded to T, PV.
template <typename T>
__device__ __forceinline__ void attention_unit(
    const AttnDesc& D, const SamplerArgs& a, const T* k, const T* v, int e,
    int h, float* smem) {
  constexpr int kBatch = 8;
  const int m = D.rows, c = D.channels, tk = D.keys, hd = c / kHeads;
  T* ws = static_cast<T*>(a.workspace);
  const T* q = ws + D.q_off + (size_t)e * m * c + h * hd;
  T* att = ws + D.att_off + (size_t)e * m * c + h * hd;
  k += (size_t)e * tk * c + h * hd;
  v += (size_t)e * tk * c + h * hd;
  const int kpitch = hd + 1;        // keys read 16 rows at a time
  float* qs = smem;                 // [m][hd]
  float* vs = qs + m * hd;          // [tk][hd]
  float* ks = vs + tk * hd;         // [tk][kpitch]
  float* probs = ks + tk * kpitch;  // [m][tk]
  const int total = (m + 2 * tk) * hd;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kThreads) {
    float buf[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < total) {
        const int r = i / hd, d = i % hd;
        buf[u] = r < m ? to_f(__ldcg(q + r * c + d))
                 : r < m + tk ? to_f(v[(r - m) * c + d])
                              : to_f(k[(r - m - tk) * c + d]);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < total) {
        const int r = i / hd;
        if (r < m + tk) {
          qs[i] = buf[u];        // q rows, then v rows
        } else {
          ks[(r - m - tk) * kpitch + i % hd] = buf[u];
        }
      }
    }
  }
  __syncthreads();
  // Thread i < m tk takes logit (i / tk, i % tk); a row's tk lanes sit in
  // one warp, so its max and sum are warp shuffles.
  const float scale = 1.f / sqrtf((float)hd);
  if (threadIdx.x < ((m * tk + 31) & ~31)) {
    const int i = threadIdx.x, r = i / tk, j = i % tk;
    const bool live = i < m * tk;
    float l = 0.f;
    if (live) {
      for (int d = 0; d < hd; ++d) l += qs[r * hd + d] * ks[j * kpitch + d];
    }
    l *= scale;
    float mx = l;
    for (int o = tk >> 1; o > 0; o >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    const float ex = expf(l - mx);
    float sum = ex;
    for (int o = tk >> 1; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    }
    if (live) probs[i] = to_f(from_f<T>(ex / sum));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const float* pr = probs + r * tk;
    float acc = 0.f;
    for (int j = 0; j < tk; ++j) acc += pr[j] * vs[j * hd + d];
    att[r * c + d] = from_f<T>(acc);
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fused_sampler_kernel(const SamplerArgs a) {
  constexpr bool kSmemWeights = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ LayerDesc s_layers[kLayers];
  __shared__ AttnDesc s_attn[2];
  __shared__ int s_phases[kPhases];
  __shared__ int s_slot[kMaxSlots][4];
  __shared__ const T* s_kv[4];
  __shared__ __align__(16) float s_bias[kMaxSlots][16];
  // A zero pixel row for the transpose convs' unused taps (ldmatrix
  // reads 16 channels at a time from any of 512).
  __shared__ __align__(16) T s_zeros[512 + 16];
  __shared__ __align__(8) uint64_t s_mbar;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < kLayers; ++j) s_layers[j] = a.layers[j];
#pragma unroll
    for (int j = 0; j < 2; ++j) s_attn[j] = a.attn[j];
#pragma unroll
    for (int j = 0; j < kPhases; ++j) s_phases[j] = a.phases[j];
#pragma unroll
    for (int j = 0; j < 4; ++j) s_kv[j] = static_cast<const T*>(a.kv[j]);
  }
  for (int i = threadIdx.x; i < kMaxSlots * 4; i += kThreads) {
    s_slot[i / 4][i % 4] = a.plan[blockIdx.x * kMaxSlots * 4 + i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 512 + 16; i += kThreads) {
    s_zeros[i] = from_f<T>(0.f);
  }
  for (int i = threadIdx.x; i < kMaxSlots * 16; i += kThreads) {
    const int sl = i / 16;
    if (s_slot[sl][0] >= 0) {
      s_bias[sl][i % 16] = to_f(static_cast<const T*>(a.biases)[
          s_layers[s_slot[sl][0]].b_off + s_slot[sl][1] * 16 + i % 16]);
    }
  }

  // bf16: this block's weight tiles, once, HBM -> shared memory by TMA.
  const uint32_t mbar = smem_u32(&s_mbar);
  uint32_t tile_bytes = 0;
  if constexpr (kSmemWeights) {
    for (int sl = 0; sl < kMaxSlots; ++sl) {
      if (s_slot[sl][0] < 0) continue;
      const LayerDesc& L = s_layers[s_slot[sl][0]];
      tile_bytes += (L.kind == kProj ? 1 : 9) * L.cin * 16 * 2;
    }
    if (threadIdx.x == 0 && tile_bytes > 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(mbar), "r"(1) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(mbar), "r"(tile_bytes) : "memory");
      for (int sl = 0; sl < kMaxSlots; ++sl) {
        if (s_slot[sl][0] < 0) continue;
        const LayerDesc& L = s_layers[s_slot[sl][0]];
        const uint32_t bytes = (L.kind == kProj ? 1 : 9) * L.cin * 16 * 2;
        const T* src = static_cast<const T*>(a.weights) + L.w_off
                       + (size_t)s_slot[sl][1] * (bytes / 2);
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];"
            :: "r"(smem_u32(smem + s_slot[sl][3])), "l"(src), "r"(bytes),
               "r"(mbar) : "memory");
      }
    }
  }

  // The carries: x <- x_in, prev <- 0.
  const int n = a.batch * kLatPix * kLat;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    a.x_out[i] = a.x_in[i];
    a.prev[i] = 0.f;
  }
  unsigned target = 0;
  grid_sync(a.barrier, target);
  if constexpr (kSmemWeights) {
    if (tile_bytes > 0) {
      uint32_t done = 0;
      const uint64_t t0 = global_ns();
      while (!done) {
        if (global_ns() - t0 > kWaitLimitNs) __trap();
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(mbar) : "memory");
      }
    }
  }

  T* stage = reinterpret_cast<T*>(smem + a.scratch_off);
  for (int step = 0; step < a.n_steps; ++step) {
    Step<T> st;
    st.temb = static_cast<const T*>(a.temb) + (size_t)step * kTemb;
    st.A = a.coefs[step * 5 + 0];
    st.B = a.coefs[step * 5 + 1];
    st.C = a.coefs[step * 5 + 2];
    st.P = a.coefs[step * 5 + 3];
    st.Q = a.coefs[step * 5 + 4];
    for (int ph = 0; ph < kPhases; ++ph) {
      const int p = s_phases[ph];
      if (p < 0) {
        const AttnDesc& D = s_attn[-1 - p];
        for (int u = blockIdx.x; u < a.batch * kHeads; u += gridDim.x) {
          attention_unit<T>(D, a, s_kv[D.kv], s_kv[D.kv + 1], u / kHeads,
                            u % kHeads, reinterpret_cast<float*>(stage));
        }
      } else {
        for (int sl = 0; sl < kMaxSlots; ++sl) {
          if (s_slot[sl][0] != p) continue;
          run_unit<T>(s_layers[p], a, st, s_slot[sl][1], s_slot[sl][2],
                      reinterpret_cast<const T*>(smem + s_slot[sl][3]),
                      s_bias[sl], stage, s_zeros);
        }
      }
      grid_sync(a.barrier, target);
    }
  }
}

template <typename T>
int launch(const SamplerArgs* args, int blocks, cudaStream_t s) {
  auto kern = fused_sampler_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, args->smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads,
                                                      args->smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  err = cudaMemsetAsync(args->barrier, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {const_cast<SamplerArgs*>(args)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                    dim3(blocks), dim3(kThreads), params,
                                    args->smem_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

size_t fused_sampler_args_size() { return sizeof(SamplerArgs); }

// The card's SM count (the grid) and the shared memory a block may opt
// into; returns the CUDA error.
int fused_sampler_device_limits(int device, int* sms, int* smem_optin) {
  cudaDeviceProp prop;
  const cudaError_t err = cudaGetDeviceProperties(&prop, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *sms = prop.multiProcessorCount;
  *smem_optin = static_cast<int>(prop.sharedMemPerBlockOptin);
  return 0;
}

// Launches the trajectory on `stream` as one cooperative grid of `blocks`
// blocks; dtype 0 = float32, 1 = bfloat16.  Returns the CUDA error of the
// launch (0 = launched).
int fused_ddim_sample(const SamplerArgs* args, int dtype, int blocks,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(args, blocks, s)
                    : launch<__nv_bfloat16>(args, blocks, s);
}

}  // extern "C"
