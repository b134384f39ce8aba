// Per-tensor LARS update for Hopper (sm_90a), plain C entry points.
//
// Replaces the two TPU kernels of src/repro/kernels/lars_update.py (the
// use_kernel="per_tensor" path of the layer-wise optimizers):
//   _norm2_kernel -> lars_norm2_kernel   sum w^2, sum g^2 of each segment
//   _apply_kernel -> lars_apply_kernel   scaled = lr*ratio*(g + wd*w),
//                                        m' = mu*m + scaled,
//                                        delta = -(scaled + mu*m') | -m'
// The TPU runs the pair once per segment. Here one optimizer step is ONE
// launch of each over every kernel segment of the step (a "pass"). A
// segment is one leaf of the JAX package's tree: one tensor, or on an LM
// tree the per-layer member tensors of one stacked leaf (all of one
// shape), which share one trust ratio.
//
// What bounds it on this card: bytes. The norm reads w and g once (4 B
// an element in bf16, 8 B in f32) for 4 flops; the apply reads w, g and
// the f32 momentum and writes the momentum and an f32 delta (16 B an
// element with bf16 w, g) for 7 flops: far below the f32 units' rate.
// So both kernels stream every element once with vector loads where a
// member's pointers are 16-byte aligned (the scalar path takes the
// others and the ragged end of a member), keep the sums in registers
// and shared memory, and read nothing back to the host: the apply turns
// the norm's sums into the trust ratio and the scale itself. Loads: the
// norm 16 B a thread (8 bf16 or 4 f32; 4 elements where w is bf16 and g
// f32, so the f32 lanes stay 16 B apart); the apply 4 elements a
// thread, its f32 momentum and delta 16 B a lane with the lanes 16 B
// apart, bf16 w and g 8 B. A pass may mix (w, g) dtype pairs: each
// member's record carries its dtypes.
//
// The work list. The pass's members are cut into tiles of at most kTile
// elements: tile (segment s, member k, element range [e0, e1)), numbered
// segment by segment, member by member, range by range, so the split
// depends on the shapes alone. The grid is the card's SM count times
// kBlocksPerSm (the tile count where that is fewer). Block b starts on
// tile b and claims each next tile from an atomic counter of the pass,
// so SMs that free up take the next tiles; the last block to leave sets
// the counter back to 0. A block's tiles only grow, so it finds a
// tile's segment from the last one (the next segment, else a binary
// search over the segments' first tiles): no host work per segment or
// tile. Which tile a block takes does not change any result. (A first
// design, a fixed round-robin of 32,768-element tiles over the grid,
// left the apply at 86% of its bound in chip_smoke.py's phase 7c on
// the H100, this one at 88%.)
//
// The member table lives in device memory: one record of 64 B a segment
// (first tile, elements a member, tiles a member, first member, member
// count, column of the sums table) and one of 32 B a member (w, g, m
// pointers, delta offset and dtype bits), then a uint32 ticket a
// segment and the two counters of the tile claims. A pass of hundreds
// of members (whisper-large-v3, qwen2-72b: 4 pointers each) does not
// fit the kernel parameter space (32,764 B), so the wrapper
// (kernels/lars_update.py) fills the table on the host for every pass,
// tickets and counters zeroed, and copies it from pinned memory on the
// launch's stream, in front of the launch.
//
// The norm's sums are deterministic, without float atomics: each tile's
// block sums its range in a fixed order (thread t takes the vectors t,
// t + 256, ..., one accumulator a sum) and reduces the block in a fixed
// order (a 32-lane butterfly, then the 8 warps in turn); the partial
// goes to the tile's slot. After a __threadfence the block takes an
// integer ticket of its segment; the block that draws the segment's
// last ticket adds the segment's partials in tile order (thread t takes
// t, t + 256, ... then the same block reduction), writes column s of
// the [2, S] table, and sets the ticket back to 0. So no launch zeroes
// the tickets or the counters: the table's copy brings them zeroed and
// the kernel leaves them so. Summation depth of a term: kTile / 256 = 32 terms a thread,
// 13 steps of block sum, ceil(tiles / 256) partials a thread and 13
// more: on the deepest segment checked, qwen2.5-3b's 36 x 22.5M-element
// MLP segment (99,072 tiles), 32 + 13 + 387 + 13 = 445, the depth of the
// per-segment launches this replaces (chip_smoke.LARS_NORM_RTOL rests on
// 445).
//
// The apply reads its segment's column of the sums table (after the
// mesh has summed it), forms the ratio and the scale in lars_ratio's
// order of operations, updates the momentum in place and writes every
// member's delta into one f32 buffer of the pass at a 16-byte aligned
// offset. With telemetry, the block of a segment's first tile writes
// (w_norm, g_norm, ratio) into column s of a [3, S] table.
//
// Rounding: every operation of the apply, the ratio included, is a
// __f*_rn intrinsic, so nvcc contracts nothing into an FMA and each op
// rounds where the plain PyTorch version (kernels/ref.py lars_ratio,
// lars_apply) rounds: given the same sums, the apply is bitwise equal to
// it. bf16 -> f32 loads are exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kTile = 8192;      // elements of one member per tile
constexpr int kBlocksPerSm = 4;     // resident at <= 64 registers a thread
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Seg {               // 8 x int64, written by lars_update.py
  long long tile0;         // first tile of the segment
  long long n;             // elements of each member
  long long tiles;         // tiles of each member: ceil(n / kTile)
  long long member0;       // first member record
  long long count;         // members
  long long col;           // column of the sums table (apply)
  long long pad0, pad1;
};

struct Member {            // 4 x int64
  long long w, g, m;       // device pointers (m: 0 in a norm pass)
  long long d;             // delta offset << kFlagBits | dtype bits | kVec
};

// Member::d's low bits: all pointers 16-byte aligned, g bf16 (else f32),
// w bf16 (else f32). A pass may mix dtype pairs (mamba2-1.3b keeps some
// leaves in f32), so each tile picks its loads from its member's bits.
constexpr long long kVec = 1, kGBf16 = 2, kWBf16 = 4;
constexpr int kFlagBits = 3;

static_assert(sizeof(Seg) == 64 && sizeof(Member) == 32, "record sizes");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __uint_as_float(static_cast<uint32_t>(__bfloat16_as_ushort(x))
                         << 16);
}

// V elements from p (16-byte aligned): V / 4 float4 loads
template <int V>
__device__ __forceinline__ void loadv(const float* p, float (&v)[V]) {
#pragma unroll
  for (int j = 0; j < V / 4; ++j) {
    const float4 x = reinterpret_cast<const float4*>(p)[j];
    v[4 * j] = x.x; v[4 * j + 1] = x.y; v[4 * j + 2] = x.z;
    v[4 * j + 3] = x.w;
  }
}

// V elements from p: V / 8 16-byte loads of 8 bf16 (p 16-byte
// aligned), or for V = 4 one 8-byte load
template <int V>
__device__ __forceinline__ void loadv(const __nv_bfloat16* p,
                                      float (&v)[V]) {
  uint32_t u[V / 2];
  if constexpr (V == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    u[0] = x.x; u[1] = x.y;
  } else {
#pragma unroll
    for (int j = 0; j < V / 8; ++j) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[j];
      u[4 * j] = x.x; u[4 * j + 1] = x.y; u[4 * j + 2] = x.z;
      u[4 * j + 3] = x.w;
    }
  }
#pragma unroll
  for (int q = 0; q < V / 2; ++q) {
    v[2 * q] = __uint_as_float(u[q] << 16);
    v[2 * q + 1] = __uint_as_float(u[q] & 0xFFFF0000u);
  }
}

template <int V>
__device__ __forceinline__ void storev(float* p, const float (&v)[V]) {
#pragma unroll
  for (int j = 0; j < V / 4; ++j)
    reinterpret_cast<float4*>(p)[j] =
        make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Sum (a, b) over the block in a fixed order; the result is valid in
// thread 0. Every thread of the block calls it.
__device__ __forceinline__ float2 block_sum(float a, float b) {
  __shared__ float red_a[kWarps], red_b[kWarps];
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) { red_a[warp] = a; red_b[warp] = b; }
  __syncthreads();
  float sa = 0.0f, sb = 0.0f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWarps; ++i) {
      sa = __fadd_rn(sa, red_a[i]);
      sb = __fadd_rn(sb, red_b[i]);
    }
  }
  return make_float2(sa, sb);
}

// The segment of tile t, searching from segment s (tiles only grow
// along a block's walk): the next segment, else a binary search over
// the segments' first tiles.
__device__ __forceinline__ int segment_of(const Seg* __restrict__ segs,
                                          int nseg, int s, long long t) {
  if (s + 1 >= nseg || segs[s + 1].tile0 > t) return s;
  int lo = s + 1, hi = nseg - 1;       // segs[lo].tile0 <= t
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (segs[mid].tile0 <= t) lo = mid; else hi = mid - 1;
  }
  return lo;
}

struct Tile {
  long long member, e0, e1;
};

// Block b starts on tile b and claims its next tile from the pass's
// counter (claim[0]) while it works on this one, so the SMs take tiles
// as they free up.
__device__ __forceinline__ void claim_next(unsigned long long* claim,
                                           long long& next) {
  if (threadIdx.x == 0)
    next = gridDim.x + static_cast<long long>(atomicAdd(claim, 1ull));
}

// The last block to leave sets the counters back to 0 for the next
// launch (claim[1] counts the blocks that left).
__device__ __forceinline__ void leave(unsigned long long* claim) {
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(claim + 1, 1ull) == gridDim.x - 1) {
      claim[0] = 0ull;
      claim[1] = 0ull;
    }
  }
}

__device__ __forceinline__ Tile tile_of(const Seg& sg, long long t) {
  const long long local = t - sg.tile0;
  const long long k = local / sg.tiles;
  const long long e0 = (local - k * sg.tiles) * kTile;
  return {sg.member0 + k, e0, e0 + kTile < sg.n ? e0 + kTile : sg.n};
}

// ---- norm: out[s] = sum w^2, out[S + s] = sum g^2 of segment s --------

// Thread t's part of sum w^2, sum g^2 over [e0, e1) of one member:
// whole vectors of V (16-byte loads where the member allows), then the
// ragged end one element a thread.
template <typename TW, typename TG, int V>
__device__ __forceinline__ float2 norm_range(const Member& mb, long long e0,
                                             long long e1) {
  const TW* w = reinterpret_cast<const TW*>(mb.w);
  const TG* g = reinterpret_cast<const TG*>(mb.g);
  float sw = 0.0f, sg = 0.0f;
  long long ev = e0;
  if (mb.d & kVec) {
    ev = e0 + (e1 - e0) / V * V;
#pragma unroll 2
    for (long long e = e0 + static_cast<long long>(V) * threadIdx.x; e < ev;
         e += static_cast<long long>(V) * kThreads) {
      float wv[V], gv[V];
      loadv<V>(w + e, wv);
      loadv<V>(g + e, gv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        sw = __fadd_rn(sw, __fmul_rn(wv[k], wv[k]));
        sg = __fadd_rn(sg, __fmul_rn(gv[k], gv[k]));
      }
    }
  }
  for (long long e = ev + threadIdx.x; e < e1; e += kThreads) {
    const float wv = to_f32(w[e]), gv = to_f32(g[e]);
    sw = __fadd_rn(sw, __fmul_rn(wv, wv));
    sg = __fadd_rn(sg, __fmul_rn(gv, gv));
  }
  return make_float2(sw, sg);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) lars_norm2_kernel(
    const Seg* __restrict__ segs, int nseg,
    const Member* __restrict__ mems, long long ntiles,
    unsigned* __restrict__ tickets, float2* __restrict__ partial,
    float* __restrict__ out, unsigned long long* __restrict__ claim) {
  __shared__ bool is_last;
  __shared__ long long next;
  int s = 0;
  for (long long t = blockIdx.x; t < ntiles;) {
    claim_next(claim, next);
    s = segment_of(segs, nseg, s, t);
    const Seg sg = segs[s];
    const Tile tl = tile_of(sg, t);
    const Member mb = mems[tl.member];
    // bf16 w and g: 8 elements (16 B) a load; otherwise 4, so that the
    // f32 operand's lanes stay 16 B apart
    const float2 acc =
        (mb.d & kWBf16) && (mb.d & kGBf16)
            ? norm_range<__nv_bfloat16, __nv_bfloat16, 8>(mb, tl.e0, tl.e1)
        : (mb.d & kWBf16)
            ? norm_range<__nv_bfloat16, float, 4>(mb, tl.e0, tl.e1)
            : norm_range<float, float, 4>(mb, tl.e0, tl.e1);
    const float2 part = block_sum(acc.x, acc.y);
    const long long seg_tiles = sg.tiles * sg.count;
    if (threadIdx.x == 0) {
      partial[t] = part;
      __threadfence();
      is_last = atomicAdd(tickets + s, 1u) ==
                static_cast<unsigned>(seg_tiles - 1);
    }
    __syncthreads();
    if (is_last) {           // uniform over the block
      __threadfence();
      float aw = 0.0f, ag = 0.0f;
      for (long long i = sg.tile0 + threadIdx.x; i < sg.tile0 + seg_tiles;
           i += kThreads) {
        const float2 p = __ldcg(partial + i);
        aw = __fadd_rn(aw, p.x);
        ag = __fadd_rn(ag, p.y);
      }
      const float2 tot = block_sum(aw, ag);
      if (threadIdx.x == 0) {
        out[s] = tot.x;
        out[nseg + s] = tot.y;
        tickets[s] = 0u;     // ready for the next launch
      }
    }
    __syncthreads();         // is_last and next are rewritten next tile
    t = next;
    __syncthreads();
  }
  leave(claim);
}

// ---- apply ---------------------------------------------------------------

template <bool kNesterov>
__device__ __forceinline__ void step(float scale, float wd, float mu,
                                     float w, float g, float& m, float& d) {
  const float scaled = __fmul_rn(scale, __fadd_rn(g, __fmul_rn(wd, w)));
  const float new_m = __fadd_rn(__fmul_rn(mu, m), scaled);
  d = kNesterov ? -__fadd_rn(scaled, __fmul_rn(mu, new_m)) : -new_m;
  m = new_m;
}

// Thread t's part of the apply over [e0, e1) of one member. 4 elements a
// lane: the f32 momentum and delta, 3/4 of the bytes with bf16 w and g,
// take 16-byte accesses with the lanes 16 B apart (8 elements a lane put
// them 32 B apart: 24.9 ms against 18.5 on qwen2.5-3b's pass).
template <typename TW, typename TG, bool kNesterov>
__device__ __forceinline__ void apply_range(const Member& mb, float* d,
                                            long long e0, long long e1,
                                            float scale, float wd,
                                            float mu) {
  constexpr int V = 4;
  const TW* w = reinterpret_cast<const TW*>(mb.w);
  const TG* g = reinterpret_cast<const TG*>(mb.g);
  float* m = reinterpret_cast<float*>(mb.m);
  long long ev = e0;
  if (mb.d & kVec) {
    ev = e0 + (e1 - e0) / V * V;
#pragma unroll 2
    for (long long e = e0 + static_cast<long long>(V) * threadIdx.x; e < ev;
         e += static_cast<long long>(V) * kThreads) {
      float wv[V], gv[V], mv[V], dv[V];
      loadv<V>(w + e, wv);
      loadv<V>(g + e, gv);
      loadv<V>(m + e, mv);
#pragma unroll
      for (int k = 0; k < V; ++k)
        step<kNesterov>(scale, wd, mu, wv[k], gv[k], mv[k], dv[k]);
      storev<V>(m + e, mv);
      storev<V>(d + e, dv);
    }
  }
  for (long long e = ev + threadIdx.x; e < e1; e += kThreads) {
    float mv = m[e], dv;
    step<kNesterov>(scale, wd, mu, to_f32(w[e]), to_f32(g[e]), mv, dv);
    m[e] = mv;
    d[e] = dv;
  }
}

template <bool kNesterov>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) lars_apply_kernel(
    const Seg* __restrict__ segs, int nseg,
    const Member* __restrict__ mems, long long ntiles,
    const float* __restrict__ sums, long long ld,
    const float* __restrict__ base_lr, float eta, float wd, float eps,
    float mu, float* __restrict__ delta, float* __restrict__ stats,
    unsigned long long* __restrict__ claim) {
  __shared__ long long next;
  const float lr = *base_lr;
  int s = 0;
  for (long long t = blockIdx.x; t < ntiles;) {
    claim_next(claim, next);
    s = segment_of(segs, nseg, s, t);
    const Seg sg = segs[s];
    const Tile tl = tile_of(sg, t);
    // the trust ratio and the scale, in lars_ratio's op order
    const float wn = __fsqrt_rn(sums[sg.col]);
    const float gn = __fsqrt_rn(sums[ld + sg.col]);
    const float ratio =
        (wn > 0.0f && gn > 0.0f)
            ? __fdiv_rn(__fmul_rn(eta, wn),
                        __fadd_rn(__fadd_rn(gn, __fmul_rn(wd, wn)), eps))
            : 1.0f;
    const float scale = __fmul_rn(lr, ratio);
    if (stats != nullptr && t == sg.tile0 && threadIdx.x == 0) {
      stats[s] = wn;
      stats[nseg + s] = gn;
      stats[2 * nseg + s] = ratio;
    }
    const Member mb = mems[tl.member];
    float* d = delta + (mb.d >> kFlagBits);
    if ((mb.d & kWBf16) && (mb.d & kGBf16))
      apply_range<__nv_bfloat16, __nv_bfloat16, kNesterov>(
          mb, d, tl.e0, tl.e1, scale, wd, mu);
    else if (mb.d & kWBf16)
      apply_range<__nv_bfloat16, float, kNesterov>(mb, d, tl.e0, tl.e1,
                                                   scale, wd, mu);
    else
      apply_range<float, float, kNesterov>(mb, d, tl.e0, tl.e1, scale, wd,
                                           mu);
    __syncthreads();
    t = next;
    __syncthreads();
  }
  leave(claim);
}

// ---- dispatch ------------------------------------------------------------

int grid_of(long long ntiles) {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 0;
  const long long cap = static_cast<long long>(sms[dev]) * kBlocksPerSm;
  return static_cast<int>(ntiles < cap ? ntiles : cap);
}

}  // namespace

extern "C" {

// Elements of one member per tile (the wrapper cuts its work list by it).
long long repro_lars_tile() { return kTile; }

// Norm pass. table: nseg segment records then the member records
// (device memory); tickets: nseg uint32 that are 0 (and are left 0);
// partial: ntiles float2; out: [2, nseg] f32. Returns the CUDA error of
// the launch (0 = launched).
int repro_lars_norm2(const void* table, int nseg, long long ntiles,
                     void* tickets, void* partial, void* out, void* counters,
                     void* stream) {
  if (nseg < 1 || ntiles < 1) return -1;
  const int grid = grid_of(ntiles);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidDevice);
  const auto* segs = static_cast<const Seg*>(table);
  lars_norm2_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      segs, nseg, reinterpret_cast<const Member*>(segs + nseg), ntiles,
      static_cast<unsigned*>(tickets), static_cast<float2*>(partial),
      static_cast<float*>(out), static_cast<unsigned long long*>(counters));
  return static_cast<int>(cudaGetLastError());
}

// Apply pass. table as the norm's (member records with m and the delta
// offsets); sums: [2, ld] f32 read at column Seg::col of each segment;
// base_lr: 1 f32 on the card; delta: the pass's f32 buffer; stats:
// [3, nseg] f32 (w_norm, g_norm, ratio) written, or null. Returns the
// CUDA error of the launch.
int repro_lars_apply(int nesterov, const void* table, int nseg,
                     long long ntiles, const void* sums, long long ld,
                     const void* base_lr, float eta, float wd, float eps,
                     float mu, void* delta, void* stats, void* counters,
                     void* stream) {
  if (nseg < 1 || ntiles < 1) return -1;
  const int grid = grid_of(ntiles);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidDevice);
  const auto* segs = static_cast<const Seg*>(table);
  const auto* mems = reinterpret_cast<const Member*>(segs + nseg);
  const auto* sm = static_cast<const float*>(sums);
  const auto* lr = static_cast<const float*>(base_lr);
  auto* d = static_cast<float*>(delta);
  auto* st = static_cast<float*>(stats);
  auto* cl = static_cast<unsigned long long*>(counters);
  auto cs = static_cast<cudaStream_t>(stream);
  if (nesterov)
    lars_apply_kernel<true><<<grid, kThreads, 0, cs>>>(
        segs, nseg, mems, ntiles, sm, ld, lr, eta, wd, eps, mu, d, st, cl);
  else
    lars_apply_kernel<false><<<grid, kThreads, 0, cs>>>(
        segs, nseg, mems, ntiles, sm, ld, lr, eta, wd, eps, mu, d, st, cl);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
