// RORR (random overlap, resort, rebin) k-distribution mixing chain for
// Hopper (sm_90a), float and double, any nbin in 1..16.
//
// Replaces the JAX package's Pallas TPU kernel
//   clima_tpu/ops/pallas_rorr.py::k_rorr_mix_pallas_t
//     (_kernel_factory + _mix_one_rank)
// which computes k_rorr (clima_radtran_types.f90:780-888) without a sort:
// the conservative rebin only needs each pair's lower cumulative-weight edge
// in the sorted order, its weighted rank
//   lower[p] = sum_k wxy[k] * [ikey_k < ikey_p + (p > k)]
// on the bit patterns of the non-negative keys (order-isomorphic to their
// values). The "+ (p > k)" term is the stable-sort index tie-break, exact:
// folding the index into the key instead is not injective and gives two
// pairs the same rank window (an O(pair weight) error, seen only in float32).
//
// Design. One thread per lane (one (column, bin, layer) of the flattened
// batch R). The lane's nk x nbin inputs are read from the (nk, nbin, R)
// layout with R on the thread index, so every load and the (nbin, R) store
// are coalesced. The running mix stays in registers across the whole species
// chain. Pair keys are formed as keys[p] = a[p % nbin] + b[p / nbin] (a the
// running mix, b the next species) with the inner rank loop unrolled, so key
// indices are compile-time and both small operand arrays live in registers;
// each pair's rank window is then rebinned by overlap onto the nbin master
// edges. What bounds it: the nbin^4 integer compares per lane and species
// pair (4096 at nbin 8, 65536 at nbin 16) — compute, not memory. nbin 8
// and 16 are compiled with nbin known, so every small array stays in
// registers; any other nbin up to 16 runs the same code with nbin read at run
// time (NBIN = 0), its arrays then indexed dynamically in local memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int32_t key_bits(float x) { return __float_as_int(x); }
__device__ __forceinline__ long long key_bits(double x) { return __double_as_longlong(x); }

template <typename T, int NBIN>
__global__ void rorr_chain_kernel(const T* __restrict__ tau_ks, int nk, int nbin_rt, int64_t R,
                                  const T* __restrict__ wxy_g, const T* __restrict__ wbin_e_g,
                                  T* __restrict__ out) {
  // NBIN > 0: nbin fixed at compile time; NBIN == 0: nbin_rt (<= CAP)
  constexpr int CAP = NBIN > 0 ? NBIN : 16;
  const int nbin = NBIN > 0 ? NBIN : nbin_rt;
  const int np = nbin * nbin;
  using I = decltype(key_bits(T(0)));
  __shared__ T wxy[CAP * CAP];
  __shared__ T edges[CAP + 1];
  for (int i = threadIdx.x; i < np; i += blockDim.x) wxy[i] = wxy_g[i];
  for (int i = threadIdx.x; i <= nbin; i += blockDim.x) edges[i] = wbin_e_g[i];
  __syncthreads();

  const int64_t r = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= R) return;

  T a[CAP];
#pragma unroll
  for (int i = 0; i < nbin; ++i) a[i] = tau_ks[int64_t(i) * R + r];

  for (int s = 1; s < nk; ++s) {
    T b[CAP];
#pragma unroll
    for (int i = 0; i < nbin; ++i) b[i] = tau_ks[(int64_t(s) * nbin + i) * R + r];

    T acc[CAP];
#pragma unroll
    for (int j = 0; j < nbin; ++j) acc[j] = T(0);

    for (int p = 0; p < np; ++p) {
      // key_p = a[p % nbin] + b[p / nbin], selected without dynamic indexing
      T ap = a[0], bp = b[0];
#pragma unroll
      for (int i = 1; i < nbin; ++i) {
        ap = (p % nbin == i) ? a[i] : ap;
        bp = (p / nbin == i) ? b[i] : bp;
      }
      const T key_p = ap + bp;
      const I ip = key_bits(key_p);
      T lower = T(0);
#pragma unroll
      for (int k = 0; k < np; ++k) {
        const I ik = key_bits(a[k % nbin] + b[k / nbin]);
        const I tgt = ip + (p > k ? 1 : 0);
        lower += (ik < tgt) ? wxy[k] : T(0);
      }
      const T upper = lower + wxy[p];
#pragma unroll
      for (int j = 0; j < nbin; ++j) {
        T ov = fmin(upper, edges[j + 1]) - fmax(lower, edges[j]);
        acc[j] += key_p * (ov > T(0) ? ov : T(0));
      }
    }
#pragma unroll
    for (int j = 0; j < nbin; ++j) a[j] = acc[j] * (T(1) / (edges[j + 1] - edges[j]));
  }

#pragma unroll
  for (int j = 0; j < nbin; ++j) out[int64_t(j) * R + r] = a[j];
}

template <typename T, int NBIN>
int launch(const void* tau_ks, int nk, int nbin, long long R, const void* wxy,
           const void* wbin_e, void* out, cudaStream_t stream) {
  const int threads = 128;
  long long blocks = (R + threads - 1) / threads;
  rorr_chain_kernel<T, NBIN><<<dim3(unsigned(blocks)), threads, 0, stream>>>(
      (const T*)tau_ks, nk, nbin, R, (const T*)wxy, (const T*)wbin_e, (T*)out);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(int nbin, int nk, long long R, const void* tau_ks, const void* wxy,
             const void* wbin_e, void* out, cudaStream_t s) {
  if (nbin == 8) return launch<T, 8>(tau_ks, nk, nbin, R, wxy, wbin_e, out, s);
  if (nbin == 16) return launch<T, 16>(tau_ks, nk, nbin, R, wxy, wbin_e, out, s);
  return launch<T, 0>(tau_ks, nk, nbin, R, wxy, wbin_e, out, s);
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
