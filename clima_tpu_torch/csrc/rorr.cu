// RORR (random overlap, resort, rebin) k-distribution mixing chain for
// Hopper (sm_90a), float and double, any nbin in 1..16.
//
// Replaces the JAX package's Pallas TPU kernel
//   clima_tpu/ops/pallas_rorr.py::k_rorr_mix_pallas_t
//     (_kernel_factory + _mix_one_rank)
// which computes k_rorr (clima_radtran_types.f90:780-888): per lane and
// species pair, the nbin^2 pair keys key[p] = a[p / nbin] + b[p % nbin] (a
// the running mix, b the next species) with weights wxy[p], stably sorted;
// each pair's window [lower, lower + wxy[p]) in the cumulative weight of the
// sorted order is rebinned conservatively onto the nbin master bins. The
// stable order is the composite (bits of the key, p) compared
// lexicographically: the bit patterns of non-negative keys order as their
// values, and p breaks exact ties as the sort twin's stable sort does
// (ops/rorr.py). The index is never folded into the key: that is not
// injective and gives two pairs the same window (an O(pair weight) error,
// seen only in float32).
//
// Design. A group of G threads (a power of two, G <= 32, so a group lies in
// one warp) handles one lane (one (column, bin, layer) of the flattened batch
// R); a block of 256 threads holds 256 / G lanes. Each species' (nbin, lanes)
// slice is staged into shared memory with loads coalesced along R; the
// running mix of each lane stays in shared memory across the whole species
// chain and is stored once, coalesced, at the end. Per species pair:
//   1. each thread forms E = NP / G pair keys once (one add each) and keeps
//      them as composites (bits, p) in registers, in the blocked layout
//      (sorted position = t * E + slot);
//   2. a bitonic network sorts the NP composites: partners in the same
//      thread are compare-exchanged in registers with compile-time slots,
//      partners in other threads are reached with __shfl_xor_sync of width
//      G; NP (log2 NP)(log2 NP + 1) / 4 compare-exchanges per lane, 672 at
//      nbin 8 and 4608 at nbin 16 (the rank form needed nbin^4);
//   3. two group scans (sequential within the thread, Hillis-Steele
//      shuffles across) give each pair's lower edge in the cumulative weight
//      and the integral of key over the weight below each thread's pairs;
//   4. the rebin is the sort twin's: F(e) = sum key * clamp(e - lower, 0, w)
//      at the nbin + 1 master edges, mix[j] = (F(e[j+1]) - F(e[j])) / (e[j+1]
//      - e[j]). Each edge is taken by its owner, the last thread whose first
//      pair starts at or below it (a warp ballot), which adds its own E
//      pairs' terms to the integral below it; the owners' F go through
//      shared memory to the thread of each bin. So the rebin costs E terms
//      per owned edge, not nbin * E per thread.
// nbin 8 (NP 64, G 8) and 16 (NP 256, G 32) are compiled with nbin fixed.
// Any other nbin runs an instance with nbin read at run time whose NP is the
// next of 16, 64 or 256 (G 4, 8, 32): the NP - nbin^2 pad composites carry
// the largest key bits, so they sort last, weigh 0 and are masked out of the
// rebin (a pad's key bits are a NaN). Every array index is a compile-time
// constant after unrolling, so nothing is spilled to local memory.
// What bounds it: operations, not memory (each input is read once and the
// output written once): the network's integer compares, selects and
// shuffles, then the scans and the edge work.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }

template <typename T>
struct Pair;

// float: one 64-bit integer, (key bits with the sign bit flipped) << 32 | p,
// whose unsigned order is the composite's.
template <>
struct Pair<float> {
  unsigned long long c;
  __device__ static Pair make(float key, int p) {
    const unsigned u = unsigned(__float_as_int(key)) ^ 0x80000000u;
    return {(static_cast<unsigned long long>(u) << 32) | unsigned(p)};
  }
  __device__ static Pair pad(int p) { return {(0xffffffffull << 32) | unsigned(p)}; }
  __device__ float key() const { return __int_as_float(int(unsigned(c >> 32) ^ 0x80000000u)); }
  __device__ int index() const { return int(unsigned(c)); }
  __device__ bool operator<(const Pair& o) const { return c < o.c; }
  __device__ Pair shfl_xor(int mask, int width) const {
    return {__shfl_xor_sync(FULL, c, mask, width)};
  }
};

// double: the key's bits (signed order) and p.
template <>
struct Pair<double> {
  long long bits;
  int p;
  __device__ static Pair make(double key, int p) { return {__double_as_longlong(key), p}; }
  __device__ static Pair pad(int p) { return {LLONG_MAX, p}; }
  __device__ double key() const { return __longlong_as_double(bits); }
  __device__ int index() const { return p; }
  __device__ bool operator<(const Pair& o) const {
    return (bits < o.bits) | ((bits == o.bits) & (p < o.p));
  }
  __device__ Pair shfl_xor(int mask, int width) const {
    return {__shfl_xor_sync(FULL, bits, mask, width), __shfl_xor_sync(FULL, p, mask, width)};
  }
};

// One stage of the bitonic network over the group's NP = G * E composites,
// thread t holding positions t * E .. t * E + E - 1: merge size 2^LK,
// partner distance 2^LJ.
template <typename T, int E, int G, int LK, int LJ>
__device__ __forceinline__ void bitonic_stage(Pair<T> (&x)[E], int t) {
  constexpr int k = 1 << LK, j = 1 << LJ;
  if constexpr (j >= E) {
    constexpr int m = j / E;  // the partner is thread t ^ m, same slot
    const bool keep_min = ((t & m) == 0) == (((t * E) & k) == 0);
#pragma unroll
    for (int q = 0; q < E; ++q) {
      const Pair<T> y = x[q].shfl_xor(m, G);
      x[q] = ((y < x[q]) == keep_min) ? y : x[q];
    }
  } else {
#pragma unroll
    for (int q = 0; q < E; ++q) {
      const int q2 = q ^ j;
      if (q2 > q) {
        const bool asc = ((t * E + q) & k) == 0;
        const bool swap = (x[q2] < x[q]) == asc;
        const Pair<T> lo = swap ? x[q2] : x[q];
        const Pair<T> hi = swap ? x[q] : x[q2];
        x[q] = lo;
        x[q2] = hi;
      }
    }
  }
}

// The network's stages in order: (LK, LJ) = (1, 0), (2, 1), (2, 0), (3, 2), ...
// Unrolled by template recursion, so every slot index is a constant.
template <typename T, int E, int G, int LOG_NP, int LK = 1, int LJ = 0>
__device__ __forceinline__ void bitonic_sort(Pair<T> (&x)[E], int t) {
  bitonic_stage<T, E, G, LK, LJ>(x, t);
  if constexpr (LJ > 0) {
    bitonic_sort<T, E, G, LOG_NP, LK, LJ - 1>(x, t);
  } else if constexpr (LK < LOG_NP) {
    bitonic_sort<T, E, G, LOG_NP, LK + 1, LK>(x, t);
  }
}

// The group's exclusive prefix sum of v over its threads t = 0 .. G - 1
// (Hillis-Steele with shuffles).
template <typename T, int G>
__device__ __forceinline__ T group_exclusive_scan(T v, int t) {
#pragma unroll
  for (int ld = 0; ld < ilog2(G); ++ld) {
    const T u = __shfl_up_sync(FULL, v, 1 << ld, G);
    if (t >= (1 << ld)) v += u;
  }
  const T ex = __shfl_up_sync(FULL, v, 1, G);
  return t == 0 ? T(0) : ex;
}

// NBIN > 0: nbin fixed at compile time (NP == NBIN^2); NBIN == 0: nbin_rt,
// with nbin_rt^2 <= NP. NB = sqrt(NP) is the largest nbin of the instance.
template <typename T, int NBIN, int NP, int G>
__global__ void __launch_bounds__(BLOCK)
rorr_chain_kernel(const T* __restrict__ tau_ks, int nk, int nbin_rt, int64_t R,
                  const T* __restrict__ wxy_g, const T* __restrict__ wbin_e_g,
                  T* __restrict__ out) {
  constexpr int LOG_NP = ilog2(NP), LOG_G = ilog2(G);
  constexpr int NB = 1 << (LOG_NP / 2);
  constexpr int E = NP / G;        // pair slots per thread
  constexpr int LPB = BLOCK / G;   // lanes per block
  constexpr int LS = NB + 1;       // per-lane row stride in shared memory (odd)
  static_assert(NB * NB == NP && (1 << LOG_G) == G && G <= 32 && G >= NB && E >= 1,
                "unsupported RORR instance");
  static_assert(NBIN == 0 || NBIN == NB, "a fixed nbin fills NP");
  const int nbin = NBIN > 0 ? NBIN : nbin_rt;
  const int np = nbin * nbin;

  __shared__ T wxy[NP];
  __shared__ T edges[NB + 1];
  __shared__ T mix[LPB * LS];  // running mix of each lane
  __shared__ T nxt[LPB * LS];  // next species of each lane
  __shared__ T Fe[LPB * LS];   // the cumulative integral at each master edge

  const int64_t r0 = int64_t(blockIdx.x) * LPB;
  const int l = threadIdx.x / G;  // the thread's lane in the block
  const int t = threadIdx.x % G;  // its rank in the lane's group
  const int gbase = threadIdx.x % 32 - t;  // the group's first bit in a warp ballot
  const unsigned gmask = G == 32 ? FULL : (1u << G) - 1u;

  // species s of the block's lanes into dst, coalesced along R
  auto stage = [&](T* dst, int s) {
    for (int i = threadIdx.x; i < nbin * LPB; i += BLOCK) {
      const int row = i / LPB, ll = i % LPB;
      const int64_t r = r0 + ll;
      dst[ll * LS + row] = r < R ? tau_ks[(int64_t(s) * nbin + row) * R + r] : T(0);
    }
  };

  for (int i = threadIdx.x; i < NP; i += BLOCK) wxy[i] = i < np ? wxy_g[i] : T(0);
  for (int i = threadIdx.x; i <= nbin; i += BLOCK) edges[i] = wbin_e_g[i];
  stage(mix, 0);

  for (int s = 1; s < nk; ++s) {
    __syncthreads();  // the previous pair is done with nxt (and mix, wxy, edges are staged)
    stage(nxt, s);
    __syncthreads();
    const T* a = mix + l * LS;
    const T* b = nxt + l * LS;

    // 1. pair keys, formed once: p = i * nbin + j, key = a[i] + b[j]
    Pair<T> x[E];
#pragma unroll
    for (int q = 0; q < E; ++q) {
      const int e = t * E + q;
      if (NBIN > 0 || e < np) {
        const int i = e / nbin, j = e - i * nbin;
        x[q] = Pair<T>::make(a[i] + b[j], e);
      } else {
        x[q] = Pair<T>::pad(e);
      }
    }

    // 2. bitonic sort of the composites, ascending in position t * E + q
    bitonic_sort<T, E, G, LOG_NP>(x, t);

    // 3. lower edges: the group's exclusive scan of the weights in sorted
    //    order; and of key * weight, the integral below the thread's pairs.
    //    A pair's key and weight are read again from its composite when
    //    needed, so only the composites stay in registers.
    T run = T(0), run_kw = T(0);
#pragma unroll
    for (int q = 0; q < E; ++q) {
      const int p = x[q].index();
      const T w = wxy[p];  // pads weigh 0
      run_kw += (p < np ? x[q].key() : T(0)) * w;  // a pad's key is masked
      run += w;
    }
    const T off = group_exclusive_scan<T, G>(run, t);
    const T below = group_exclusive_scan<T, G>(run_kw, t);

    // 4. rebin: F(e) = sum key * clamp(e - lower, 0, w) at each master edge e,
    //    taken by the edge's owner (the last thread whose first pair starts
    //    at or below e), then mix[j] = (F(e[j+1]) - F(e[j])) / (e[j+1] - e[j])
    int first = 0, count = 0;
#pragma unroll
    for (int jb = 0; jb <= NB; ++jb) {
      if (NBIN > 0 || jb <= nbin) {  // the same for the whole warp
        const unsigned bal = (__ballot_sync(FULL, off <= edges[jb]) >> gbase) & gmask;
        if ((bal ? 31 - __clz(bal) : 0) == t) {
          first = count == 0 ? jb : first;
          ++count;
        }
      }
    }
    for (int c = 0; c < count; ++c) {
      const T e = edges[first + c];
      T F = below, r = T(0);
#pragma unroll
      for (int q = 0; q < E; ++q) {
        const int p = x[q].index();
        const T w = wxy[p];
        F += (p < np ? x[q].key() : T(0)) * fmin(fmax(e - (r + off), T(0)), w);
        r += w;  // r + off is the pair's lower edge
      }
      Fe[l * LS + first + c] = F;
    }
    __syncwarp();  // F is written, and the group has read a before it is overwritten
    if (t < nbin)
      mix[l * LS + t] = (Fe[l * LS + t + 1] - Fe[l * LS + t]) / (edges[t + 1] - edges[t]);
  }

  __syncthreads();
  for (int i = threadIdx.x; i < nbin * LPB; i += BLOCK) {
    const int row = i / LPB, ll = i % LPB;
    const int64_t r = r0 + ll;
    if (r < R) out[int64_t(row) * R + r] = mix[ll * LS + row];
  }
}

template <typename T, int NBIN, int NP, int G>
int launch(const void* tau_ks, int nk, int nbin, long long R, const void* wxy,
           const void* wbin_e, void* out, cudaStream_t stream) {
  constexpr int LPB = BLOCK / G;
  const long long blocks = (R + LPB - 1) / LPB;
  rorr_chain_kernel<T, NBIN, NP, G><<<dim3(unsigned(blocks)), BLOCK, 0, stream>>>(
      (const T*)tau_ks, nk, nbin, R, (const T*)wxy, (const T*)wbin_e, (T*)out);
  return int(cudaGetLastError());
}

// instance by nbin: (NBIN, NP, G); ops/rorr_cuda.py::_INSTANCES mirrors it
template <typename T>
int dispatch(int nbin, int nk, long long R, const void* tau_ks, const void* wxy,
             const void* wbin_e, void* out, cudaStream_t s) {
  if (nbin == 8) return launch<T, 8, 64, 8>(tau_ks, nk, nbin, R, wxy, wbin_e, out, s);
  if (nbin == 16) return launch<T, 16, 256, 32>(tau_ks, nk, nbin, R, wxy, wbin_e, out, s);
  if (nbin <= 4) return launch<T, 0, 16, 4>(tau_ks, nk, nbin, R, wxy, wbin_e, out, s);
  if (nbin <= 8) return launch<T, 0, 64, 8>(tau_ks, nk, nbin, R, wxy, wbin_e, out, s);
  return launch<T, 0, 256, 32>(tau_ks, nk, nbin, R, wxy, wbin_e, out, s);
}

}  // namespace

// Plain C entry point. Device pointers, contiguous: tau_ks (nk, nbin, R),
// wxy (nbin*nbin,) with wxy[p] = wbin[p % nbin] * wbin[p / nbin],
// wbin_e (nbin+1,) master weight edges, out (nbin, R). 1 <= nbin <= 16,
// nk >= 1. Returns the launch's cudaError_t, or -1 for an unsupported nbin.
extern "C" int clima_rorr_chain(int is_f64, int nbin, int nk, long long R, const void* tau_ks,
                                const void* wxy, const void* wbin_e, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nbin < 1 || nbin > 16) return -1;
  return is_f64 ? dispatch<double>(nbin, nk, R, tau_ks, wxy, wbin_e, out, s)
                : dispatch<float>(nbin, nk, R, tau_ks, wxy, wbin_e, out, s);
}
