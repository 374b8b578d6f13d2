// GroupNorm over channels-last (NHWC) tensors, with SiLU and a
// per-(item, channel) addend fused in.
//
// Replaces no TPU kernel: the JAX package's models have no GroupNorm.  It
// was added for Riffusion's UNet and VAE (models/sd_layers.py, sd_unet.py,
// vae_kl.py), whose weights and activations are channels-last on the
// card.  PyTorch's CUDA group_norm makes such an input contiguous NCHW,
// normalises it and returns NCHW; SiLU then runs on NCHW and the next
// convolution copies it back to channels-last.  This kernel reads and
// writes channels-last in place.  Per item n and group g of C / groups
// channels, over every position and channel of the group:
//
//   v      = x + add[n, c]        rounded to x's type (add absent: v = x)
//   mean   = mean(v),  var = mean((v - mean)^2)       (biased, in f32)
//   y      = (v - mean) rsqrt(var + eps) weight[c] + bias[c]
//   y      = y sigmoid(y)         when silu
//
// y rounded once to x's type.  The addend is the ResNet's time embedding
// (time_emb_proj(silu(temb)) [N, C]), whose sum with conv1's output only
// norm2 reads; it is rounded to x's type before the statistics, as the
// unfused add rounds it.
//
// What bounds it on the H100: bytes.  The least the function needs is to
// read x once and write y once: 2 x 2 bytes an element in bf16 (Riffusion
// at 512x512: [8, 320, 64, 64] 21.0 MB each way, 12.5 us at 3.35 TB/s;
// [4, 128, 512, 512] 268 MB, 160 us).  The kernel reads x twice, once for
// the statistics and once to apply them, so where the tensor does not
// stay in the 50 MB L2 between its two launches it moves 1.5x those
// bytes.  The apply pass walks its chunks newest-first, so it starts on
// what the statistics pass left in L2.  Each element takes a handful of
// f32 operations (SiLU with __expf and __fdividef), well below the
// card's issue rate at this byte rate.
//
// Design: two launches, no host synchronise.
// - Layout: an item is a row-major [HW, C] matrix.  Thread t of a CTA owns
//   the VEC channels at (t % V) VEC (V = C / VEC) in every R-th row of its
//   chunk (R = blockDim / V row slots), so its loads are 16 bytes (8 bf16
//   or 4 f32) and a warp's are contiguous along C.  Widths that are not a
//   multiple of VEC (or pointers that are not 16-byte aligned) take VEC =
//   1.  Group widths need not be a multiple of VEC (Riffusion's 10, 20,
//   30 and 60 are not): a thread's channels may straddle two groups.
// - Grid: items x chunks of HW rows, about 4 CTAs an SM (at least 32 KB
//   of input a CTA, at most 128 chunks an item), so B = 1 at 8x8 and B =
//   4 at 512x512 both spread over the card.  Each thread keeps kUnroll
//   rows' loads in flight.
// - Statistics: f32 throughout.  Each thread runs Welford's update per
//   channel over its rows; the CTA writes its per-channel (mean, M2) to
//   shared memory and one warp a group merges the group's entries (two
//   passes: the chunk's mean, then M2 by Chan's formula) into the chunk's
//   (count, mean, M2).  The CTA stores that, fences and takes its item's
//   ticket (as kernel D, normalized_mse.cu); the item's last CTA merges
//   the item's chunks in chunk order by the same formula, writes (mean,
//   rstd) per group and resets the ticket.  No float atomics, and no sum
//   depends on which CTA finishes last: two runs give the same bits.
// - Apply: each CTA folds (mean, rstd, weight, bias) into a per-channel
//   scale and shift in shared memory, then streams its chunk: y = v scale
//   + shift, SiLU, one rounding, 16-byte stores.
//
// Interface: plain C, bound with ctypes; returns cudaGetLastError(), or
// -1 for a shape it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunks = 128;          // chunks an item, a multiple of 32
constexpr int kTargetCtas = 4 * 132;     // about 4 CTAs an SM
constexpr long long kMinChunkBytes = 32 * 1024;
constexpr int kSlotThreads = 256;        // threads a CTA where C allows
constexpr int kMaxThreads = 768;         // C / VEC at most this
constexpr int kUnroll = 4;
constexpr int kMaxSharedBytes = 48 * 1024;

struct Params {
  const void* x;
  void* y;
  const void* weight;   // [C] in x's type
  const void* bias;     // [C] in x's type
  const void* add;      // [N, C] in x's type, or null
  float* stats;         // [N, groups, 2]: mean, rstd
  float* partial;       // [N, chunks, groups, 3]: count, mean, M2
  unsigned* tickets;    // [N], zero between launches
  int n, c, hw, groups, chunks, rows_per_chunk, slots;
  float eps;
};

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The value the statistics see: x + add rounded to x's type.
template <typename T, bool ADD>
__device__ __forceinline__ float value(T x, float a) {
  return ADD ? to_f(from_f<T>(to_f(x) + a)) : to_f(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;   // the butterfly leaves every lane the same bits
}

// The thread's addend for its VEC channels of item n (zeros without one).
template <typename T, int VEC, bool ADD>
__device__ __forceinline__ void load_add(const Params& p, int item, int c0,
                                         float (&a)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    a[j] = ADD ? to_f(static_cast<const T*>(p.add)[(size_t)item * p.c + c0 +
                                                    j])
               : 0.f;
}

template <typename T, int VEC, bool ADD>
__global__ void __launch_bounds__(kMaxThreads)
gn_stats_kernel(Params p) {
  extern __shared__ float smem[];
  __shared__ bool last;
  const int V = p.c / VEC;
  const int tid = threadIdx.x, col = tid % V, slot = tid / V;
  const int item = blockIdx.x / p.chunks, chunk = blockIdx.x % p.chunks;
  const int r0 = chunk * p.rows_per_chunk;
  const int r1 = min(p.hw, r0 + p.rows_per_chunk);
  const int R = p.slots;
  float* s_mean = smem;                  // [R, C]
  float* s_m2 = smem + R * p.c;          // [R, C]
  float* s_cnt = s_m2 + R * p.c;         // [R]

  if (slot < R) {
    const T* x = static_cast<const T*>(p.x) + (size_t)item * p.hw * p.c +
                 col * VEC;
    float a[VEC], mean[VEC], m2[VEC];
    load_add<T, VEC, ADD>(p, item, col * VEC, a);
#pragma unroll
    for (int j = 0; j < VEC; ++j) mean[j] = m2[j] = 0.f;
    int cnt = 0;
    auto take = [&](const Pack<T, VEC>& q) {
      ++cnt;
      const float inv = __frcp_rn((float)cnt);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float v = value<T, ADD>(q.v[j], a[j]);
        const float d = v - mean[j];
        mean[j] += d * inv;
        m2[j] += d * (v - mean[j]);
      }
    };
    int r = r0 + slot;
    for (; r + (kUnroll - 1) * R < r1; r += kUnroll * R) {
      Pack<T, VEC> q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        q[u] = *reinterpret_cast<const Pack<T, VEC>*>(
            x + (size_t)(r + u * R) * p.c);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) take(q[u]);
    }
    for (; r < r1; r += R)
      take(*reinterpret_cast<const Pack<T, VEC>*>(x + (size_t)r * p.c));
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      s_mean[slot * p.c + col * VEC + j] = mean[j];
      s_m2[slot * p.c + col * VEC + j] = m2[j];
    }
    if (col == 0) s_cnt[slot] = (float)cnt;
  }
  __syncthreads();

  // The chunk's (count, mean, M2) of each group: a warp a group over its
  // R x (C / groups) entries.
  const int gw = p.c / p.groups, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5, entries = R * gw;
  for (int g = warp; g < p.groups; g += warps) {
    float n = 0.f, nm = 0.f;
    for (int e = lane; e < entries; e += 32) {
      const int r = e / gw, ch = g * gw + e % gw;
      n += s_cnt[r];
      nm += s_cnt[r] * s_mean[r * p.c + ch];
    }
    n = warp_sum(n);
    nm = warp_sum(nm);
    const float gm = n > 0.f ? nm / n : 0.f;
    float m2 = 0.f;
    for (int e = lane; e < entries; e += 32) {
      const int r = e / gw, ch = g * gw + e % gw;
      const float d = s_mean[r * p.c + ch] - gm;
      m2 += s_m2[r * p.c + ch] + s_cnt[r] * d * d;
    }
    m2 = warp_sum(m2);
    if (lane == 0) {
      float* o = p.partial +
                 (((size_t)item * p.chunks + chunk) * p.groups + g) * 3;
      o[0] = n;
      o[1] = gm;
      o[2] = m2;
    }
  }
  __threadfence();   // this CTA's partials before its ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(&p.tickets[item], 1u) == (unsigned)p.chunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The item's last CTA: merge its chunks in chunk order, per group, a
  // lane holding chunks lane, lane + 32, ... in registers (one round trip
  // to L2 a group).
  constexpr int kPerLane = kMaxChunks / 32;
  for (int g = warp; g < p.groups; g += warps) {
    const float* base = p.partial + (size_t)item * p.chunks * p.groups * 3 +
                        g * 3;
    float kn[kPerLane], km[kPerLane], k2[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int k = lane + 32 * i;
      const float* q = base + (size_t)k * p.groups * 3;
      kn[i] = k < p.chunks ? __ldcg(q) : 0.f;
      km[i] = k < p.chunks ? __ldcg(q + 1) : 0.f;
      k2[i] = k < p.chunks ? __ldcg(q + 2) : 0.f;
    }
    float n = 0.f, nm = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      n += kn[i];
      nm += kn[i] * km[i];
    }
    n = warp_sum(n);
    nm = warp_sum(nm);
    const float gm = n > 0.f ? nm / n : 0.f;
    float m2 = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const float d = km[i] - gm;
      m2 += k2[i] + kn[i] * d * d;
    }
    m2 = warp_sum(m2);
    if (lane == 0) {
      const float var = n > 0.f ? fmaxf(m2 / n, 0.f) : 0.f;
      p.stats[((size_t)item * p.groups + g) * 2] = gm;
      p.stats[((size_t)item * p.groups + g) * 2 + 1] = rsqrtf(var + p.eps);
    }
  }
  if (tid == 0) p.tickets[item] = 0u;
}

template <typename T, int VEC, bool ADD, bool SILU>
__global__ void __launch_bounds__(kMaxThreads)
gn_apply_kernel(Params p) {
  extern __shared__ float smem[];
  float* s_scale = smem;            // [C]
  float* s_shift = smem + p.c;      // [C]
  const int V = p.c / VEC;
  const int tid = threadIdx.x, col = tid % V, slot = tid / V;
  // newest chunk first: the statistics pass left it in L2
  const int lin = gridDim.x - 1 - blockIdx.x;
  const int item = lin / p.chunks, chunk = lin % p.chunks;
  const int gw = p.c / p.groups;
  for (int ch = tid; ch < p.c; ch += blockDim.x) {
    const float* st = p.stats + ((size_t)item * p.groups + ch / gw) * 2;
    const float w = to_f(static_cast<const T*>(p.weight)[ch]);
    const float b = to_f(static_cast<const T*>(p.bias)[ch]);
    const float s = st[1] * w;
    s_scale[ch] = s;
    s_shift[ch] = b - st[0] * s;
  }
  __syncthreads();
  const int R = p.slots;
  if (slot >= R) return;

  const int r0 = chunk * p.rows_per_chunk;
  const int r1 = min(p.hw, r0 + p.rows_per_chunk);
  const size_t base = (size_t)item * p.hw * p.c + col * VEC;
  const T* x = static_cast<const T*>(p.x) + base;
  T* y = static_cast<T*>(p.y) + base;
  float a[VEC], scale[VEC], shift[VEC];
  load_add<T, VEC, ADD>(p, item, col * VEC, a);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    scale[j] = s_scale[col * VEC + j];
    shift[j] = s_shift[col * VEC + j];
  }
  auto put = [&](const Pack<T, VEC>& q, T* dst) {
    Pack<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float v = fmaf(value<T, ADD>(q.v[j], a[j]), scale[j], shift[j]);
      if (SILU) v = __fdividef(v, 1.f + __expf(-v));
      o.v[j] = from_f<T>(v);
    }
    *reinterpret_cast<Pack<T, VEC>*>(dst) = o;
  };
  int r = r0 + slot;
  for (; r + (kUnroll - 1) * R < r1; r += kUnroll * R) {
    Pack<T, VEC> q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      q[u] = *reinterpret_cast<const Pack<T, VEC>*>(
          x + (size_t)(r + u * R) * p.c);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) put(q[u], y + (size_t)(r + u * R) * p.c);
  }
  for (; r < r1; r += R)
    put(*reinterpret_cast<const Pack<T, VEC>*>(x + (size_t)r * p.c),
        y + (size_t)r * p.c);
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, int VEC, bool ADD>
int launch(Params p, int threads, cudaStream_t st, int silu) {
  const int grid = p.n * p.chunks;
  const size_t stats_smem = (2 * (size_t)p.slots * p.c + p.slots) *
                            sizeof(float);
  const size_t apply_smem = 2 * (size_t)p.c * sizeof(float);
  if (stats_smem > kMaxSharedBytes || apply_smem > kMaxSharedBytes) return -1;
  gn_stats_kernel<T, VEC, ADD><<<grid, threads, stats_smem, st>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (silu)
    gn_apply_kernel<T, VEC, ADD, true><<<grid, threads, apply_smem, st>>>(p);
  else
    gn_apply_kernel<T, VEC, ADD, false><<<grid, threads, apply_smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_vec(Params p, cudaStream_t st, int silu) {
  const int V = p.c / VEC;
  if (V > kMaxThreads) return -1;
  p.slots = V >= kSlotThreads ? 1 : kSlotThreads / V;
  const int threads = (p.slots * V + 31) / 32 * 32;
  // chunks: about kTargetCtas CTAs, at least kMinChunkBytes each, at most
  // kMaxChunks an item, no chunk empty
  const long long item_bytes = (long long)p.hw * p.c * sizeof(T);
  long long k = (kTargetCtas + p.n - 1) / p.n;
  k = k < item_bytes / kMinChunkBytes ? k : item_bytes / kMinChunkBytes;
  k = k < kMaxChunks ? k : kMaxChunks;
  k = k > 1 ? k : 1;
  p.rows_per_chunk = (int)((p.hw + k - 1) / k);
  p.chunks = (p.hw + p.rows_per_chunk - 1) / p.rows_per_chunk;
  return p.add ? launch<T, VEC, true>(p, threads, st, silu)
               : launch<T, VEC, false>(p, threads, st, silu);
}

template <typename T>
int dispatch(Params p, cudaStream_t st, int silu) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = p.c % kVec == 0 && aligned(p.x) && aligned(p.y) &&
                   (p.add == nullptr || aligned(p.add));
  return vec ? launch_vec<T, kVec>(p, st, silu) : launch_vec<T, 1>(p, st, silu);
}

}  // namespace

extern "C" int group_norm_nhwc_max_chunks() { return kMaxChunks; }

// x, y: [n, c, h, w] channels-last (row-major [n, hw, c]), f32
// (x_bf16 = 0) or bf16 (1); weight, bias: [c] and add: [n, c] or null, in
// x's type; scratch: f32, at least n * groups * (2 + 3 *
// group_norm_nhwc_max_chunks()); tickets: [n] zeros (left zero).
extern "C" int group_norm_nhwc(const void* x, void* y, int x_bf16,
                               const void* weight, const void* bias,
                               const void* add, float* scratch,
                               unsigned* tickets, int n,
                               int c, int hw, int groups, float eps, int silu,
                               void* stream) {
  if (n <= 0 || hw <= 0) return 0;
  if (c <= 0 || groups <= 0 || c % groups != 0) return -1;
  Params p{};
  p.x = x;
  p.y = y;
  p.weight = weight;
  p.bias = bias;
  p.add = add;
  p.stats = scratch;
  p.partial = scratch + (size_t)n * groups * 2;
  p.tickets = tickets;
  p.n = n;
  p.c = c;
  p.hw = hw;
  p.groups = groups;
  p.eps = eps;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return x_bf16 ? dispatch<__nv_bfloat16>(p, st, silu)
                : dispatch<float>(p, st, silu);
}
