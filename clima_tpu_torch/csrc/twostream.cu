// Toon et al. (1989) two-stream solves for Hopper (sm_90a), float and double:
// weight-fused (the gauss and zenith sums done in the kernel) and unreduced
// (every row's edge fluxes written out). Four kernels live here.
//
// 1. The row template (twostream_kernel) replaces the JAX package's Pallas
//    TPU kernels
//   clima_tpu/ops/pallas_twostream.py::two_stream_ir_pallas (_ir_kernel):
//     IR per row, unreduced
//   clima_tpu/ops/pallas_twostream.py::two_stream_solar_pallas
//     (_solar_kernel): single-zenith solar, one zenith cosine per row
// 2. The weighted solar kernel (solar_weighted_kernel, designed below the
//    template) replaces
//   clima_tpu/ops/pallas_twostream.py::two_stream_solar_multi_weighted_pallas
//     (_solar_multi_weighted_kernel): delta-Eddington quadrature solar for
//     any number of zenith angles, zenith- and gauss-weighted, amean optional
// 3. The unreduced multi-zenith solar kernel (solar_rows_kernel, designed
//    after it) replaces
//   clima_tpu/ops/pallas_twostream.py::two_stream_solar_multi_pallas
//     (_solar_multi_kernel): multi-zenith solar per row, unreduced, with the
//     surface radiance
// 4. The weighted IR kernel (ir_weighted_kernel, designed last) replaces
//   clima_tpu/ops/pallas_twostream.py::two_stream_ir_weighted_pallas
//     (_ir_weighted_kernel): hemispheric-mean IR, linear-in-tau Planck
//     source, gauss-weighted
// Each computes what clima_tpu/ops/twostream.py computes for it.
//
// Template design. One thread owns one (column, bin, gauss point) row and
// solves its 2nz system by 2x2-block Thomas elimination (never scalar Thomas:
// scalar pivots vanish in optically thin layers; the 2x2 blocks stay well
// conditioned). Block row k couples u_{k-1}[1] through L01 and u_{k+1}[0]
// through U10, so the forward sweep only changes M00 and f0, and each block
// leaves p = inv(M') f' and q = inv(M')[:, 1] * U10 for the back
// substitution u_k = p_k - q_k * u_{k+1}[0]. The template carries NR
// right-hand sides a thread; both of its instances take NR = 1 (its
// shared-zenith instances gave way to solar_rows_kernel). Written for NR = 1
// alone, its single-zenith solar instance ran 1.3 ms slower at the roofline
// shape (PERF.md), so the template stays as it is until #4 and #6 have
// their own kernels.
//   pass 1  forward: layer coefficients, elimination, p and q to scratch
//   pass 2  backward: u_k overwrites p_k in scratch
//   pass 3  forward: recompute the layer coefficients (bit-identical to
//           pass 1) and store each row's edge fluxes (and the surface
//           radiance).
// Scratch is laid out (nz, values, rows), rows fastest, so its accesses are
// coalesced. What bounds it: the per-thread sequential recurrence over nz
// (latency of dependent double-precision divides and exps) at low occupancy
// (one thread per row), and, at the flagship shapes, the strided (rows, nz)
// reads of tau/w0/g; recomputing the coefficients in pass 3 trades cheap
// arithmetic for not storing them. The unreduced stores are strided too (a
// thread writes one (rows, nz+1) row), so they are not coalesced; that is left
// as it is for now.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr double kPi = 3.14159265358979323846;
constexpr double kSqrt3 = 1.7320508075688772;  // 3.0**0.5

template <typename T, int NR>
struct Layer {
  T e1, e2, e3, e4;
  T cp0[NR], cpb[NR], cm0[NR], cmb[NR];
  T dir_b[NR];  // solar: direct beam at the layer bottom (u0 * etb)
  T tau;        // solar: delta-scaled optical depth (advances tauc)
};

// The zenith cosines a thread works with: shared by the block (multi-zenith
// kernels) or one per row (ROW, the single-zenith kernel).
template <typename T, bool ROW>
struct ZenithCosines {
  const T* shared;
  T row;
  __device__ __forceinline__ T operator[](int r) const {
    if constexpr (ROW) return row;
    else return shared[r];
  }
};

template <typename T, int NR>
__device__ __forceinline__ void set_es(T lam, T cap_gam, T tau, Layer<T, NR>& c) {
  T wrk = exp(-lam * tau);
  c.e1 = T(1) + cap_gam * wrk;
  c.e2 = T(1) - cap_gam * wrk;
  c.e3 = cap_gam + wrk;
  c.e4 = cap_gam - wrk;
}

template <typename T>
__device__ __forceinline__ void ir_layer(T tau, T w0, T gt, T b_top, T b_bot, T tau_min,
                                         Layer<T, 1>& c) {
  const T norm = T(kPi);  // 2*pi*u1 with u1 = 0.5
  T gam1 = T(2) - w0 * (T(1) + gt);
  T gam2 = w0 * (T(1) - gt);
  T lam = sqrt(gam1 * gam1 - gam2 * gam2);
  T cap_gam = gam2 / (gam1 + lam);
  set_es(lam, cap_gam, tau, c);
  bool thin = tau <= tau_min;
  T b0n = thin ? T(0.5) * (b_top + b_bot) : b_top;
  T b1n = thin ? T(0) : (b_bot - b_top) / tau;
  T inv_g = T(1) / (gam1 + gam2);
  c.cp0[0] = norm * (b0n + b1n * inv_g);
  c.cpb[0] = norm * (b0n + b1n * (tau + inv_g));
  c.cm0[0] = norm * (b0n - b1n * inv_g);
  c.cmb[0] = norm * (b0n + b1n * (tau - inv_g));
}

template <typename T, int NR, typename U0>
__device__ __forceinline__ void solar_layer(T tau_in, T w0_in, T gt_in, T tauc,
                                            const U0& u0s, int nzen, Layer<T, NR>& c) {
  const T s3 = T(kSqrt3);
  T gg = gt_in * gt_in;
  T tau = tau_in * (T(1) - w0_in * gg);
  T w0 = w0_in * (T(1) - gg) / (T(1) - w0_in * gg);
  T gt = gt_in / (T(1) + gt_in);
  T gam1 = s3 * (T(2) - w0 * (T(1) + gt)) / T(2);
  T gam2 = s3 * w0 * (T(1) - gt) / T(2);
  T lam = sqrt(gam1 * gam1 - gam2 * gam2);
  T cap_gam = gam2 / (gam1 + lam);
  set_es(lam, cap_gam, tau, c);
  c.tau = tau;
#pragma unroll
  for (int z = 0; z < NR; ++z) {
    if (z < nzen) {
      T u0 = u0s[z];
      T inv_u0 = T(1) / u0;
      T gam3 = (T(1) - s3 * gt * u0) / T(2);
      T gam4 = T(1) - gam3;
      T facp = w0 * ((gam1 - inv_u0) * gam3 + gam4 * gam2);
      T facm = w0 * ((gam1 + inv_u0) * gam4 + gam2 * gam3);
      T et0 = exp(-tauc / u0);
      T etb = et0 * exp(-tau / u0);
      T denom = lam * lam - inv_u0 * inv_u0;
      c.cp0[z] = et0 * facp / denom;
      c.cpb[z] = etb * facp / denom;
      c.cm0[z] = et0 * facm / denom;
      c.cmb[z] = etb * facm / denom;
      c.dir_b[z] = u0 * etb;
    }
  }
}

template <typename T, bool SOLAR, int NR, typename U0>
__device__ __forceinline__ void load_layer(int64_t row, int k, int nz, const T* tau,
                                           const T* w0, const T* gt, const T* bpl,
                                           T tau_min, T tauc, const U0& u0s, int nzen,
                                           Layer<T, NR>& c) {
  int64_t i = row * nz + k;
  if constexpr (SOLAR) {
    solar_layer<T, NR>(tau[i], w0[i], gt[i], tauc, u0s, nzen, c);
  } else {
    int64_t ib = row * (nz + 1) + k;
    ir_layer<T>(tau[i], w0[i], gt[i], bpl[ib], bpl[ib + 1], tau_min, c);
  }
}

// Outputs (nzen, rows, nz+1) (IR: (rows, nz+1)); out_srad (nzen, rows).
// ROW: one zenith cosine per row, u0s_g (rows,), NR = 1.
template <typename T, bool SOLAR, bool AMEAN, int NR, bool ROW>
__global__ void twostream_kernel(
    const T* __restrict__ tau, const T* __restrict__ w0, const T* __restrict__ gt,
    const T* __restrict__ surf, const T* __restrict__ bpl, const T* __restrict__ u0s_g,
    int nzen, int64_t rows, int nz, int hard, T tau_min, T* __restrict__ scratch,
    T* __restrict__ out_am, T* __restrict__ out_fup, T* __restrict__ out_fdn,
    T* __restrict__ out_srad) {
  __shared__ T u0s[NR];
  const int nrhs = SOLAR ? nzen : 1;
  if (SOLAR && !ROW && threadIdx.x < nzen) u0s[threadIdx.x] = u0s_g[threadIdx.x];
  __syncthreads();

  const int64_t row = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool active = row < rows;
  const int nval = 2 + 2 * NR;  // q0, q1, then (p0, p1) per right-hand side
  const int64_t stride_v = rows, stride_k = int64_t(nval) * rows;
  T* sc = scratch + row;
  const T u1 = SOLAR ? T(1) / T(kSqrt3) : T(0.5);
  ZenithCosines<T, ROW> u0v{u0s, (ROW && active) ? u0s_g[row] : T(1)};

  // surface boundary: reflectivity Rs and source Ss (solar: per zenith)
  T Rs = T(0), Ss_ir = T(0);
  if (active) {
    if constexpr (SOLAR) {
      Rs = surf[row];
    } else {
      T emis = surf[row];
      const T* b = bpl + row * (nz + 1);
      if (hard) {
        Rs = T(1) - emis;
        Ss_ir = emis * T(kPi) * b[nz];
      } else {
        T tb = tau[row * nz + nz - 1];
        T b1_bot = (tb <= tau_min) ? T(0) : (b[nz] - b[nz - 1]) / tb;
        Ss_ir = T(kPi) * (b[nz] + u1 * b1_bot);
      }
    }
  }

  // ---- pass 1: forward elimination ----
  if (active) {
    Layer<T, NR> cur, nxt;
    T tauc = T(0);
    load_layer<T, SOLAR, NR>(row, 0, nz, tau, w0, gt, bpl, tau_min, tauc, u0v, nzen, cur);
    T Aev = T(0), Bev = cur.e1, Dev = -cur.e2;
    T Eev[NR], p1prev[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) { Eev[r] = -cur.cm0[r]; p1prev[r] = T(0); }
    T q1prev = T(0);
    for (int k = 0; k < nz; ++k) {
      T Aod, Bod, Dod, Eod[NR], nAev = T(0), nBev = T(0), nDev = T(0), nEev[NR];
      if (k < nz - 1) {
        if constexpr (SOLAR) tauc += cur.tau;
        load_layer<T, SOLAR, NR>(row, k + 1, nz, tau, w0, gt, bpl, tau_min, tauc, u0v,
                                 nzen, nxt);
        Aod = nxt.e2 * cur.e1 - cur.e3 * nxt.e4;
        Bod = cur.e2 * nxt.e2 - cur.e4 * nxt.e4;
        Dod = nxt.e1 * nxt.e4 - nxt.e2 * nxt.e3;
        nAev = cur.e2 * cur.e3 - cur.e4 * cur.e1;
        nBev = cur.e1 * nxt.e1 - cur.e3 * nxt.e3;
        nDev = cur.e3 * nxt.e4 - cur.e1 * nxt.e2;
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          Eod[r] = nxt.e2 * (nxt.cp0[r] - cur.cpb[r]) - nxt.e4 * (nxt.cm0[r] - cur.cmb[r]);
          nEev[r] = cur.e3 * (nxt.cp0[r] - cur.cpb[r]) + cur.e1 * (cur.cmb[r] - nxt.cm0[r]);
        }
      } else {
        Aod = cur.e1 - Rs * cur.e3;
        Bod = cur.e2 - Rs * cur.e4;
        Dod = T(0);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          T Ss = Ss_ir;
          if constexpr (SOLAR) Ss = Rs * cur.dir_b[r];
          Eod[r] = Ss - cur.cpb[r] + Rs * cur.cmb[r];
          nEev[r] = T(0);
        }
      }
      // block k: M = [[Bev, Dev], [Aod, Bod]], L01 = Aev, U10 = Dod
      T M00 = Bev - Aev * q1prev;
      T inv_det = T(1) / (M00 * Bod - Dev * Aod);
      T X00 = Bod * inv_det, X01 = -Dev * inv_det;
      T X10 = -Aod * inv_det, X11 = M00 * inv_det;
      T* s = sc + k * stride_k;
      q1prev = X11 * Dod;
      s[0] = X01 * Dod;
      s[stride_v] = q1prev;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (r < nrhs) {
          T f0 = Eev[r] - Aev * p1prev[r];
          T p0 = X00 * f0 + X01 * Eod[r];
          p1prev[r] = X10 * f0 + X11 * Eod[r];
          s[(2 + 2 * r) * stride_v] = p0;
          s[(3 + 2 * r) * stride_v] = p1prev[r];
        }
      }
      cur = nxt;
      Aev = nAev; Bev = nBev; Dev = nDev;
#pragma unroll
      for (int r = 0; r < NR; ++r) Eev[r] = nEev[r];
    }

    // ---- pass 2: back substitution, u_k over p_k ----
    T unext[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) unext[r] = T(0);
    for (int k = nz - 1; k >= 0; --k) {
      T* s = sc + k * stride_k;
      T q0 = s[0], q1 = s[stride_v];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (r < nrhs) {
          T y1 = s[(2 + 2 * r) * stride_v] - q0 * unext[r];
          T y2 = s[(3 + 2 * r) * stride_v] - q1 * unext[r];
          s[(2 + 2 * r) * stride_v] = y1;
          s[(3 + 2 * r) * stride_v] = y2;
          unext[r] = y1;
        }
      }
    }
  }

  // ---- pass 3: edge fluxes, stored per row ----
  const int64_t ne = nz + 1;
  T tauc = T(0);
  for (int k = 0; k < nz; ++k) {
    if (active) {
      Layer<T, NR> c;
      load_layer<T, SOLAR, NR>(row, k, nz, tau, w0, gt, bpl, tau_min, tauc, u0v, nzen, c);
      if constexpr (SOLAR) tauc += c.tau;
      const T* s = sc + k * stride_k;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (r < nrhs) {
          T y1 = s[(2 + 2 * r) * stride_v], y2 = s[(3 + 2 * r) * stride_v];
          T fup_t = y1 * c.e3 - y2 * c.e4 + c.cp0[r];
          T fup_b = y1 * c.e1 + y2 * c.e2 + c.cpb[r];
          T fdn_b = y1 * c.e3 + y2 * c.e4 + c.cmb[r];
          if constexpr (SOLAR) {
            T u0 = u0v[r];
            T dir_t = u0;  // u0 * Fs_pi, Fs_pi = 1
            T am_t = (T(1) / u1) * fup_t + dir_t / u0;
            T am_b = (T(1) / u1) * (y1 * (c.e1 + c.e3) + y2 * (c.e2 + c.e4) + c.cpb[r]
                                    + c.cmb[r])
                     + c.dir_b[r] / u0;
            const int64_t base = (int64_t(r) * rows + row) * ne;
            if (k == 0) {
              out_fup[base] = fup_t;
              out_fdn[base] = dir_t;
              out_am[base] = am_t;
            }
            out_fup[base + k + 1] = fup_b;
            out_fdn[base + k + 1] = fdn_b + c.dir_b[r];
            out_am[base + k + 1] = am_b;
            if (k == nz - 1) out_srad[int64_t(r) * rows + row] = fdn_b / u1 + exp(-tauc / u0);
          } else {
            const int64_t base = row * ne;
            if (k == 0) {
              out_fup[base] = fup_t;
              out_fdn[base] = T(0);
            }
            out_fup[base + k + 1] = fup_b;
            out_fdn[base + k + 1] = fdn_b;
          }
        }
      }
    }
  }
}

template <typename T, bool SOLAR, bool AMEAN, int NR, bool ROW>
int launch(const void* tau, const void* w0, const void* gt, const void* surf,
           const void* bpl, const void* u0s, int nzen, long long rows, int nz, int hard,
           double tau_min, void* scratch, void* out_am, void* out_fup, void* out_fdn,
           void* out_srad, cudaStream_t stream) {
  const int threads = 128;
  const long long blocks = (rows + threads - 1) / threads;
  twostream_kernel<T, SOLAR, AMEAN, NR, ROW><<<dim3(unsigned(blocks)), threads, 0, stream>>>(
      (const T*)tau, (const T*)w0, (const T*)gt, (const T*)surf, (const T*)bpl,
      (const T*)u0s, nzen, rows, nz, hard, T(tau_min), (T*)scratch, (T*)out_am,
      (T*)out_fup, (T*)out_fdn, (T*)out_srad);
  return int(cudaGetLastError());
}

// ---- The weighted multi-zenith solar kernel ----
//
// Replaces clima_tpu/ops/pallas_twostream.py::two_stream_solar_multi_weighted_pallas
// (_solar_multi_weighted_kernel) and computes what ops/twostream.py's
// two_stream_solar_multi_weighted computes: the solar solve for every zenith
// angle, summed over the zeniths with zw and over each gauss group with wbin.
//
// What held the template back for this solve (one thread per row carrying NR
// zenith right-hand sides): few threads with many registers each (177 in
// float64 at NR = 4), each running a chain of dependent double-precision
// exps and divides per layer at low occupancy; three passes over scratch in
// device memory (p and q written, p rewritten as u, u read again); and at
// most 8 zenith angles per launch.
//
// Design. One thread owns one (row, zenith) pair, zenith fastest; a block holds
// whole gauss groups with all their zeniths (nG * nzen threads per group,
// several groups per block up to ~128 threads). Each thread computes the
// zenith-independent part of a layer itself (delta scaling, lam, cap_gam,
// e1-e4, repeated across a row's zeniths) and runs the template's 2x2-block
// Thomas elimination with one right-hand side, unchanged in its operations:
// a thread holds one zenith (~104 registers in float64) whatever nzen is, and
// nzen is a run-time value.
//   forward: layer coefficients and elimination, top to bottom, the next
//            layer's inputs read one layer ahead. The row's zenith-0 thread
//            stores q and the running tauc of each layer, every thread its p.
//   backward (after one block barrier, bottom to top, scratch and inputs read
//            one layer ahead): u_k = p_k - q_k * u_{k+1}[0], the layer's
//            coefficients recomputed from the stored tauc (bit-identical to
//            the forward's), and its edge fluxes (the lower edge, at the top
//            layer also the upper) put in shared memory. Every 16 edges (fewer
//            where the block's values would pass 48 KB), between two block
//            barriers, one thread per (gauss group, edge, output) sums the
//            group's zeniths in order with zw for each gauss row, then the
//            gauss rows in order with wbin: the order of the template's
//            reduction, without atomics, so results repeat bit for bit.
// Scratch: q (nz, 2, rows), tauc (nz, rows) and p (nz, 2, rows * nzen), each
// written once and read once, coalesced in the thread order. What bounds it:
// the latency of each thread's chain of double-precision divides, sqrt and
// exps (about 2 of every 5 instructions the zenith-independent part), at ~16
// resident warps per SM, with the scratch traffic under it. Threads of one
// warp hold different zeniths, so anything that branches on u0 splits the
// warp: source_quot keeps the underflowed sources off the division's slow
// path.

// x / d where x may be zero: deep in the column exp(-tauc/u0) underflows to
// zero at the small zenith cosines first, and a zero numerator sends the
// division down its slow path, which splits a warp whose threads hold
// different zeniths. A zero x gets the signed zero IEEE division gives it
// without dividing; any other x is divided as usual.
template <typename T>
__device__ __forceinline__ T source_quot(T x, T d) {
  const bool zero = x == T(0) && d != T(0);
  const T q = (zero ? T(1) : x) / d;
  return zero ? (signbit(d) ? -x : x) : q;
}

// One zenith's layer coefficients: solar_layer's arithmetic with one zenith
// cosine, the source quotients through source_quot.
template <typename T>
__device__ __forceinline__ void solar_layer_1(T tau_in, T w0_in, T gt_in, T tauc, T u0,
                                              Layer<T, 1>& c) {
  const T s3 = T(kSqrt3);
  T gg = gt_in * gt_in;
  T tau = tau_in * (T(1) - w0_in * gg);
  T w0 = w0_in * (T(1) - gg) / (T(1) - w0_in * gg);
  T gt = gt_in / (T(1) + gt_in);
  T gam1 = s3 * (T(2) - w0 * (T(1) + gt)) / T(2);
  T gam2 = s3 * w0 * (T(1) - gt) / T(2);
  T lam = sqrt(gam1 * gam1 - gam2 * gam2);
  T cap_gam = gam2 / (gam1 + lam);
  set_es(lam, cap_gam, tau, c);
  c.tau = tau;
  T inv_u0 = T(1) / u0;
  T gam3 = (T(1) - s3 * gt * u0) / T(2);
  T gam4 = T(1) - gam3;
  T facp = w0 * ((gam1 - inv_u0) * gam3 + gam4 * gam2);
  T facm = w0 * ((gam1 + inv_u0) * gam4 + gam2 * gam3);
  T et0 = exp(-tauc / u0);
  T etb = et0 * exp(-tau / u0);
  T denom = lam * lam - inv_u0 * inv_u0;
  c.cp0[0] = source_quot(et0 * facp, denom);
  c.cpb[0] = source_quot(etb * facp, denom);
  c.cm0[0] = source_quot(et0 * facm, denom);
  c.cmb[0] = source_quot(etb * facm, denom);
  c.dir_b[0] = u0 * etb;
}

// The weighted sums of a chunk of ne edges (descending from edge j0): one
// (gauss group, edge, output) item per thread, each summing its group's
// zeniths in order with zw for every gauss row, then the gauss rows in order
// with wbin. vals holds (NOUT, slots, blockDim) per-thread values. With one
// zenith of weight 1 (the IR kernel) a gauss row's sum is its value, bit for
// bit.
template <typename T, int NOUT>
__device__ __forceinline__ void reduce_edges(const T* vals, int slots, int ne, int j0,
                                             const T* zw, const T* wbin, int nzen, int nG,
                                             int64_t grp0, int64_t groups, int nz, T* out_fup,
                                             T* out_fdn, T* out_am) {
  const int bd = blockDim.x, gpb = bd / (nG * nzen);
  for (int it = threadIdx.x; it < gpb * ne * NOUT; it += bd) {
    const int gl = it / (ne * NOUT), e = (it / NOUT) % ne, o = it % NOUT;
    if (grp0 + gl >= groups) continue;
    const T* v = vals + (o * slots + e) * bd + gl * nG * nzen;
    T s = T(0);
    for (int g = 0; g < nG; ++g) {
      T acc = T(0);
      for (int r = 0; r < nzen; ++r) acc += zw[r] * v[g * nzen + r];
      s += wbin[g] * acc;
    }
    T* out = o == 0 ? out_fup : (o == 1 ? out_fdn : out_am);
    out[(grp0 + gl) * (nz + 1) + (j0 - e)] = s;
  }
}

// outputs (rows/nG, nz+1) each: fup, fdn and (AMEAN) amean, weighted.
// Dynamic shared memory: zw (nzen), wbin (nG), vals (NOUT, E + 1, blockDim).
template <typename T, bool AMEAN>
__global__ void solar_weighted_kernel(
    const T* __restrict__ tau, const T* __restrict__ w0, const T* __restrict__ gt,
    const T* __restrict__ surf, const T* __restrict__ u0s, const T* __restrict__ zw_g,
    int nzen, const T* __restrict__ wbin_g, int nG, int64_t rows, int nz, int E,
    T* __restrict__ q_s, T* __restrict__ tauc_s, T* __restrict__ p_s,
    T* __restrict__ out_am, T* __restrict__ out_fup, T* __restrict__ out_fdn) {
  constexpr int NOUT = AMEAN ? 3 : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bd = blockDim.x, tid = threadIdx.x, slots = E + 1;
  T* zw = reinterpret_cast<T*>(smem_raw);
  T* wbin = zw + nzen;
  T* vals = wbin + nG;
  for (int i = tid; i < nzen; i += bd) zw[i] = zw_g[i];
  for (int i = tid; i < nG; i += bd) wbin[i] = wbin_g[i];
  __syncthreads();

  const int z = tid % nzen, rpb = bd / nzen;
  const int64_t row = int64_t(blockIdx.x) * rpb + tid / nzen;
  const bool active = row < rows;
  const int64_t np = rows * nzen, pc = row * nzen + z;  // p's columns; this thread's
  const T u0 = u0s[z];
  const T u1 = T(1) / T(kSqrt3);
  const T* tau_r = tau + row * nz;
  const T* w0_r = w0 + row * nz;
  const T* gt_r = gt + row * nz;

  // ---- forward: elimination; q and tauc per (layer, row), p per thread ----
  if (active) {
    const T Rs = surf[row];
    Layer<T, 1> cur, nxt;
    T tauc = T(0);
    solar_layer_1(tau_r[0], w0_r[0], gt_r[0], tauc, u0, cur);
    if (z == 0) tauc_s[row] = tauc;
    T Aev = T(0), Bev = cur.e1, Dev = -cur.e2, Eev = -cur.cm0[0];
    T p1prev = T(0), q1prev = T(0);
    T ta = T(0), wa = T(0), ga = T(0);  // the inputs of layer k + 1
    if (nz > 1) { ta = tau_r[1]; wa = w0_r[1]; ga = gt_r[1]; }
    for (int k = 0; k < nz; ++k) {
      T Aod, Bod, Dod, Eod, nAev = T(0), nBev = T(0), nDev = T(0), nEev = T(0);
      if (k < nz - 1) {
        const T tk = ta, wk = wa, gk = ga;
        if (k + 2 < nz) { ta = tau_r[k + 2]; wa = w0_r[k + 2]; ga = gt_r[k + 2]; }
        tauc += cur.tau;
        solar_layer_1(tk, wk, gk, tauc, u0, nxt);
        if (z == 0) tauc_s[int64_t(k + 1) * rows + row] = tauc;
        Aod = nxt.e2 * cur.e1 - cur.e3 * nxt.e4;
        Bod = cur.e2 * nxt.e2 - cur.e4 * nxt.e4;
        Dod = nxt.e1 * nxt.e4 - nxt.e2 * nxt.e3;
        nAev = cur.e2 * cur.e3 - cur.e4 * cur.e1;
        nBev = cur.e1 * nxt.e1 - cur.e3 * nxt.e3;
        nDev = cur.e3 * nxt.e4 - cur.e1 * nxt.e2;
        Eod = nxt.e2 * (nxt.cp0[0] - cur.cpb[0]) - nxt.e4 * (nxt.cm0[0] - cur.cmb[0]);
        nEev = cur.e3 * (nxt.cp0[0] - cur.cpb[0]) + cur.e1 * (cur.cmb[0] - nxt.cm0[0]);
      } else {
        Aod = cur.e1 - Rs * cur.e3;
        Bod = cur.e2 - Rs * cur.e4;
        Dod = T(0);
        T Ss = Rs * cur.dir_b[0];
        Eod = Ss - cur.cpb[0] + Rs * cur.cmb[0];
      }
      // block k: M = [[Bev, Dev], [Aod, Bod]], L01 = Aev, U10 = Dod
      T M00 = Bev - Aev * q1prev;
      T inv_det = T(1) / (M00 * Bod - Dev * Aod);
      T X00 = Bod * inv_det, X01 = -Dev * inv_det;
      T X10 = -Aod * inv_det, X11 = M00 * inv_det;
      q1prev = X11 * Dod;
      if (z == 0) {
        q_s[int64_t(2 * k) * rows + row] = X01 * Dod;
        q_s[int64_t(2 * k + 1) * rows + row] = q1prev;
      }
      T f0 = Eev - Aev * p1prev;
      T p0 = X00 * f0 + X01 * Eod;
      p1prev = X10 * f0 + X11 * Eod;
      p_s[int64_t(2 * k) * np + pc] = p0;
      p_s[int64_t(2 * k + 1) * np + pc] = p1prev;
      cur = nxt;
      Aev = nAev; Bev = nBev; Dev = nDev; Eev = nEev;
    }
  }
  __syncthreads();  // the row's q and tauc, stored by its zenith-0 thread

  // ---- backward: back substitution, edge fluxes and their reduction ----
  const int64_t groups = rows / nG, grp0 = int64_t(blockIdx.x) * (bd / (nG * nzen));
  // the layer's inputs and scratch, read one layer ahead
  T pa = T(0), pb = T(0), qa = T(0), qb = T(0), tca = T(0), ta = T(0), wa = T(0), ga = T(0);
  auto fetch = [&](int k) {
    pa = p_s[int64_t(2 * k) * np + pc];
    pb = p_s[int64_t(2 * k + 1) * np + pc];
    qa = q_s[int64_t(2 * k) * rows + row];
    qb = q_s[int64_t(2 * k + 1) * rows + row];
    tca = tauc_s[int64_t(k) * rows + row];
    ta = tau_r[k]; wa = w0_r[k]; ga = gt_r[k];
  };
  if (active) fetch(nz - 1);
  T unext = T(0);
  int slot = 0, j0 = nz;
  for (int k = nz - 1; k >= 0; --k) {
    T top[NOUT], bot[NOUT];
#pragma unroll
    for (int o = 0; o < NOUT; ++o) { top[o] = T(0); bot[o] = T(0); }
    if (active) {
      const T p0 = pa, p1 = pb, q0 = qa, q1 = qb, tck = tca, tk = ta, wk = wa, gk = ga;
      if (k > 0) fetch(k - 1);
      T y1 = p0 - q0 * unext;
      T y2 = p1 - q1 * unext;
      unext = y1;
      Layer<T, 1> c;
      solar_layer_1(tk, wk, gk, tck, u0, c);
      T dir_t = u0;  // u0 * Fs_pi, Fs_pi = 1
      T fup_t = y1 * c.e3 - y2 * c.e4 + c.cp0[0];
      T fup_b = y1 * c.e1 + y2 * c.e2 + c.cpb[0];
      T fdn_b = y1 * c.e3 + y2 * c.e4 + c.cmb[0];
      top[0] = fup_t;
      top[1] = dir_t;
      bot[0] = fup_b;
      bot[1] = fdn_b + c.dir_b[0];
      if constexpr (AMEAN) {
        top[2] = (T(1) / u1) * fup_t + dir_t / u0;
        bot[2] = (T(1) / u1) * (y1 * (c.e1 + c.e3) + y2 * (c.e2 + c.e4) + c.cpb[0] + c.cmb[0])
                 + source_quot(c.dir_b[0], u0);
      }
    }
#pragma unroll
    for (int o = 0; o < NOUT; ++o) vals[(o * slots + slot) * bd + tid] = bot[o];
    ++slot;
    if (k == 0) {
#pragma unroll
      for (int o = 0; o < NOUT; ++o) vals[(o * slots + slot) * bd + tid] = top[o];
      ++slot;
    }
    if (slot >= E || k == 0) {  // the same at every thread
      __syncthreads();
      reduce_edges<T, NOUT>(vals, slots, slot, j0, zw, wbin, nzen, nG, grp0, groups, nz, out_fup,
                            out_fdn, out_am);
      __syncthreads();
      j0 -= slot;
      slot = 0;
    }
  }
}

constexpr int kSolarThreads = 128;  // threads a block aims at (whole gauss groups)
constexpr int kSolarEdges = 16;     // edges reduced per pair of block barriers, at most

template <typename T, bool AMEAN>
int solar_max_group() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, solar_weighted_kernel<T, AMEAN>);
  return err == cudaSuccess ? attr.maxThreadsPerBlock : -int(err);
}

// scratch: q (nz, 2, rows), then tauc (nz, rows), then p (nz, 2, rows*nzen)
template <typename T, bool AMEAN>
int launch_solar_weighted(const void* tau, const void* w0, const void* gt, const void* surf,
                          const void* u0s, const void* zw, int nzen, const void* wbin, int nG,
                          long long rows, int nz, void* scratch, void* out_am, void* out_fup,
                          void* out_fdn, cudaStream_t stream) {
  constexpr int NOUT = AMEAN ? 3 : 2;
  const int group = nG * nzen;
  const int max_group = solar_max_group<T, AMEAN>();
  if (max_group < 0) return -max_group;
  if (nzen < 1 || group > max_group) return int(cudaErrorInvalidConfiguration);
  int per = kSolarThreads / group;
  if (per < 1) per = 1;
  const int threads = per * group;
  const long long blocks = (rows / nG + per - 1) / per;
  // edges per reduction: as many as fit beside the block in the 48 KB of
  // dynamic shared memory a launch gets by default, 1 to kSolarEdges (a
  // block that cannot hold 2 slots there fails to launch, reported below)
  const size_t per_slot = size_t(NOUT) * threads * sizeof(T);
  int E = int((48 * 1024 - size_t(nzen + nG) * sizeof(T)) / per_slot) - 1;
  E = E < 1 ? 1 : (E > kSolarEdges ? kSolarEdges : E);
  const size_t smem = size_t(nzen + nG) * sizeof(T) + (E + 1) * per_slot;
  T* q = (T*)scratch;
  T* tauc = q + 2LL * nz * rows;
  T* p = tauc + 1LL * nz * rows;
  solar_weighted_kernel<T, AMEAN><<<dim3(unsigned(blocks)), threads, smem, stream>>>(
      (const T*)tau, (const T*)w0, (const T*)gt, (const T*)surf, (const T*)u0s, (const T*)zw,
      nzen, (const T*)wbin, nG, rows, nz, E, q, tauc, p, (T*)out_am, (T*)out_fup, (T*)out_fdn);
  return int(cudaGetLastError());
}

// ---- The unreduced multi-zenith solar kernel ----
//
// Replaces clima_tpu/ops/pallas_twostream.py::two_stream_solar_multi_pallas
// (_solar_multi_kernel) and computes what ops/twostream.py's
// two_stream_solar_multi computes: the solar solve of every row for each
// zenith cosine of u0s (shared by all rows), written out per (zenith, row):
// amean, fup and fdn at every edge and the surface radiance.
//
// What held the row template back for this solve: one thread per row
// carrying NR = 4 or 8 zenith right-hand sides in registers (few resident
// warps; the 8-zenith float64 instance spilled), at most 8 zenith angles a
// launch; three passes over a (nz, 2 + 2 NR, rows) scratch; the (rows, nz)
// inputs read twice; and each row's edges stored by its own thread, so a
// warp's stores lay nz + 1 values apart.
//
// Design. The weighted solar kernel's solve, a thread per (row, zenith) pair
// running the template's 2x2-block Thomas elimination with one right-hand
// side, without the weighted sums. Pairs are numbered zenith fastest (row *
// nzen + z) and a block takes kRowsThreads consecutive pairs, so nzen is a
// run-time value and one launch takes any number of zenith angles; a row's
// zeniths may straddle two blocks. Zenith fastest (not a warp per zenith):
// a row's threads sit side by side, so its inputs, q and tauc are read once
// for all its zeniths, and the block barrier that publishes q needs no block
// to hold a whole row; source_quot keeps the zenith-dependent underflow off
// the divisions' slow path, which would otherwise split the warp (plain
// divisions measured 21% slower at 12 zeniths, PERF.md).
//   forward: layer coefficients and elimination, top to bottom, the next
//            layer's inputs read one layer ahead (per-warp cp.async tiles,
//            as in ir_weighted_kernel, measured slower here: a warp's 32
//            pairs span few rows at several zeniths). The row's first thread in
//            the block stores q and the running tauc of each layer (zenith
//            independent and the same bits in every thread of the row, so a
//            row split between two blocks has both store the same values),
//            every thread its p.
//   backward (after one block barrier, bottom to top, scratch and inputs read
//            one layer ahead): u_k = p_k - q_k * u_{k+1}[0], the layer's
//            coefficients recomputed from the stored tauc (bit-identical to
//            the forward's), its edge fluxes and amean staged in the warp's
//            shared memory, the surface radiance stored at the bottom layer.
//            Every 128 bytes' worth of edges (16 float64, 32 float32) the
//            warp writes them out: each pair's edges form one contiguous run
//            of a (nzen, rows, nz+1) output, and neighbouring lanes store
//            neighbouring edges of a run (a warp store covers whole runs).
// Scratch: q (nz, 2, rows), tauc (nz, rows) and p (nz, 2, rows * nzen), each
// written once and read once, coalesced in the thread order. What bounds it:
// the per-thread chain of dependent double-precision divides, sqrt and exps
// (the zenith-independent part repeated in each of a row's threads, and the
// coefficients computed twice), with the scratch and the outputs (3 nzen
// rows (nz + 1) values) streamed beneath it.

constexpr int kRowsThreads = 128;  // pairs per block

// dynamic shared memory: each pair's output base (blockDim) and each warp's
// staged values (3 outputs, 32 lanes, 128 / sizeof(T) + 1 slots)
template <typename T>
constexpr size_t solar_rows_smem() {
  return kRowsThreads * sizeof(int64_t) + size_t(kRowsThreads) * 3 * (128 / sizeof(T) + 1) * sizeof(T);
}

// outputs (nzen, rows, nz+1): amean, fup, fdn; out_srad (nzen, rows)
template <typename T>
__global__ void solar_rows_kernel(
    const T* __restrict__ tau, const T* __restrict__ w0, const T* __restrict__ gt,
    const T* __restrict__ surf, const T* __restrict__ u0s, int nzen, int64_t rows, int nz,
    T* __restrict__ q_s, T* __restrict__ tauc_s, T* __restrict__ p_s, T* __restrict__ out_am,
    T* __restrict__ out_fup, T* __restrict__ out_fdn, T* __restrict__ out_srad) {
  constexpr int E = int(128 / sizeof(T)), SLOTS = E + 1, WVALS = 3 * 32 * SLOTS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int64_t* bases = reinterpret_cast<int64_t*>(smem_raw) + warp * 32;  // this warp's
  T* vals = reinterpret_cast<T*>(smem_raw + kRowsThreads * sizeof(int64_t)) + warp * WVALS;

  const int64_t np = rows * nzen, pc = int64_t(blockIdx.x) * kRowsThreads + tid;  // pair
  const bool active = pc < np;
  const int64_t row = active ? pc / nzen : 0;
  const int z = active ? int(pc - row * nzen) : 0;
  const bool first = z == 0 || tid == 0;  // the row's first thread in this block
  const int64_t ne = nz + 1;
  bases[lane] = active ? (int64_t(z) * rows + row) * ne : -1;
  const T u0 = u0s[z];
  const T u1 = T(1) / T(kSqrt3);
  const T* tau_r = tau + row * nz;
  const T* w0_r = w0 + row * nz;
  const T* gt_r = gt + row * nz;

  // ---- forward: elimination; q and tauc per (layer, row), p per thread ----
  if (active) {
    const T Rs = surf[row];
    Layer<T, 1> cur, nxt;
    T tauc = T(0);
    solar_layer_1(tau_r[0], w0_r[0], gt_r[0], tauc, u0, cur);
    if (first) tauc_s[row] = tauc;
    T Aev = T(0), Bev = cur.e1, Dev = -cur.e2, Eev = -cur.cm0[0];
    T p1prev = T(0), q1prev = T(0);
    T ta = T(0), wa = T(0), ga = T(0);  // the inputs of layer k + 1
    if (nz > 1) { ta = tau_r[1]; wa = w0_r[1]; ga = gt_r[1]; }
    for (int k = 0; k < nz; ++k) {
      T Aod, Bod, Dod, Eod, nAev = T(0), nBev = T(0), nDev = T(0), nEev = T(0);
      if (k < nz - 1) {
        const T tk = ta, wk = wa, gk = ga;
        if (k + 2 < nz) { ta = tau_r[k + 2]; wa = w0_r[k + 2]; ga = gt_r[k + 2]; }
        tauc += cur.tau;
        solar_layer_1(tk, wk, gk, tauc, u0, nxt);
        if (first) tauc_s[int64_t(k + 1) * rows + row] = tauc;
        Aod = nxt.e2 * cur.e1 - cur.e3 * nxt.e4;
        Bod = cur.e2 * nxt.e2 - cur.e4 * nxt.e4;
        Dod = nxt.e1 * nxt.e4 - nxt.e2 * nxt.e3;
        nAev = cur.e2 * cur.e3 - cur.e4 * cur.e1;
        nBev = cur.e1 * nxt.e1 - cur.e3 * nxt.e3;
        nDev = cur.e3 * nxt.e4 - cur.e1 * nxt.e2;
        Eod = nxt.e2 * (nxt.cp0[0] - cur.cpb[0]) - nxt.e4 * (nxt.cm0[0] - cur.cmb[0]);
        nEev = cur.e3 * (nxt.cp0[0] - cur.cpb[0]) + cur.e1 * (cur.cmb[0] - nxt.cm0[0]);
      } else {
        Aod = cur.e1 - Rs * cur.e3;
        Bod = cur.e2 - Rs * cur.e4;
        Dod = T(0);
        T Ss = Rs * cur.dir_b[0];
        Eod = Ss - cur.cpb[0] + Rs * cur.cmb[0];
      }
      // block k: M = [[Bev, Dev], [Aod, Bod]], L01 = Aev, U10 = Dod
      T M00 = Bev - Aev * q1prev;
      T inv_det = T(1) / (M00 * Bod - Dev * Aod);
      T X00 = Bod * inv_det, X01 = -Dev * inv_det;
      T X10 = -Aod * inv_det, X11 = M00 * inv_det;
      q1prev = X11 * Dod;
      if (first) {
        q_s[int64_t(2 * k) * rows + row] = X01 * Dod;
        q_s[int64_t(2 * k + 1) * rows + row] = q1prev;
      }
      T f0 = Eev - Aev * p1prev;
      T p0 = X00 * f0 + X01 * Eod;
      p1prev = X10 * f0 + X11 * Eod;
      p_s[int64_t(2 * k) * np + pc] = p0;
      p_s[int64_t(2 * k + 1) * np + pc] = p1prev;
      cur = nxt;
      Aev = nAev; Bev = nBev; Dev = nDev; Eev = nEev;
    }
  }
  __syncthreads();  // the row's q and tauc, stored by its first thread in the block

  // ---- backward: back substitution, edge fluxes, staged and written per warp ----
  // the layer's inputs and scratch, read one layer ahead
  T pa = T(0), pb = T(0), qa = T(0), qb = T(0), tca = T(0), ta = T(0), wa = T(0), ga = T(0);
  auto fetch = [&](int k) {
    pa = p_s[int64_t(2 * k) * np + pc];
    pb = p_s[int64_t(2 * k + 1) * np + pc];
    qa = q_s[int64_t(2 * k) * rows + row];
    qb = q_s[int64_t(2 * k + 1) * rows + row];
    tca = tauc_s[int64_t(k) * rows + row];
    ta = tau_r[k]; wa = w0_r[k]; ga = gt_r[k];
  };
  if (active) fetch(nz - 1);
  // lane's value of output o (amean, fup, fdn) at staging slot s
  auto stage = [&](int o, int s, T v) { vals[(o * 32 + lane) * SLOTS + s] = v; };
  T unext = T(0);
  int slot = 0, j0 = nz;  // staged edges j0, j0 - 1, ... in slots 0, 1, ...
  for (int k = nz - 1; k >= 0; --k) {
    if (active) {
      const T p0 = pa, p1 = pb, q0 = qa, q1 = qb, tck = tca, tk = ta, wk = wa, gk = ga;
      if (k > 0) fetch(k - 1);
      T y1 = p0 - q0 * unext;
      T y2 = p1 - q1 * unext;
      unext = y1;
      Layer<T, 1> c;
      solar_layer_1(tk, wk, gk, tck, u0, c);
      T fdn_b = y1 * c.e3 + y2 * c.e4 + c.cmb[0];
      stage(0, slot, (T(1) / u1) * (y1 * (c.e1 + c.e3) + y2 * (c.e2 + c.e4) + c.cpb[0] + c.cmb[0])
                         + source_quot(c.dir_b[0], u0));
      stage(1, slot, y1 * c.e1 + y2 * c.e2 + c.cpb[0]);
      stage(2, slot, fdn_b + c.dir_b[0]);
      if (k == nz - 1) out_srad[int64_t(z) * rows + row] = fdn_b / u1 + exp(-(tck + c.tau) / u0);
      if (k == 0) {
        T dir_t = u0;  // u0 * Fs_pi, Fs_pi = 1
        T fup_t = y1 * c.e3 - y2 * c.e4 + c.cp0[0];
        stage(0, slot + 1, (T(1) / u1) * fup_t + dir_t / u0);
        stage(1, slot + 1, fup_t);
        stage(2, slot + 1, dir_t);
      }
    }
    slot += k == 0 ? 2 : 1;
    if (slot >= E || k == 0) {  // the same at every lane
      __syncwarp();
      // edges j0 - slot + 1 .. j0 of each pair, ascending, as one run per
      // pair and output; element i of the warp's runs: pair l, edge e
      const int n = slot;
      for (int i = lane; i < 32 * n; i += 32) {
        const int l = n == E ? i / E : i / n, e = i - l * n;
        const int64_t base = bases[l];
        if (base < 0) continue;
        const int64_t o = base + (j0 - n + 1 + e);
        const T* v = vals + l * SLOTS + (n - 1 - e);
        out_am[o] = v[0];
        out_fup[o] = v[32 * SLOTS];
        out_fdn[o] = v[64 * SLOTS];
      }
      __syncwarp();
      j0 -= n;
      slot = 0;
    }
  }
}

// scratch: q (nz, 2, rows), then tauc (nz, rows), then p (nz, 2, rows*nzen)
template <typename T>
int launch_solar_rows(const void* tau, const void* w0, const void* gt, const void* surf,
                      const void* u0s, int nzen, long long rows, int nz, void* scratch,
                      void* out_am, void* out_fup, void* out_fdn, void* out_srad,
                      cudaStream_t stream) {
  if (nzen < 1 || nz < 1 || rows < 1) return int(cudaErrorInvalidValue);
  const long long blocks = (rows * nzen + kRowsThreads - 1) / kRowsThreads;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  constexpr size_t smem = solar_rows_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(solar_rows_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  T* q = (T*)scratch;
  T* tauc = q + 2LL * nz * rows;
  T* p = tauc + 1LL * nz * rows;
  solar_rows_kernel<T><<<dim3(unsigned(blocks)), kRowsThreads, smem, stream>>>(
      (const T*)tau, (const T*)w0, (const T*)gt, (const T*)surf, (const T*)u0s, nzen, rows, nz,
      q, tauc, p, (T*)out_am, (T*)out_fup, (T*)out_fdn, (T*)out_srad);
  return int(cudaGetLastError());
}

// ---- The weighted IR kernel ----
//
// Replaces clima_tpu/ops/pallas_twostream.py::two_stream_ir_weighted_pallas
// (_ir_weighted_kernel) and computes what ops/twostream.py's
// two_stream_ir_weighted computes: the IR solve of every row, summed over
// each gauss group with wbin.
//
// What held the row template back for this solve: two block barriers per
// edge (~400 per thread at nz 202), with one thread in nG summing its group
// in series between them; three passes over a (nz, 4, rows) scratch (p and q
// written, p rewritten as u, u read again); and the (rows, nz) inputs read
// twice by a thread per row, each warp load touching 32 sectors nz values
// apart. The L1 does not hide that stride: the same two-pass kernel reading
// its inputs through the tiles below is faster (PERF.md).
//
// Design. One thread owns one (column, bin, gauss point) row; a block holds
// whole gauss groups (about kIrThreads threads). It runs the template's
// 2x2-block Thomas elimination, its operations unchanged, in two passes.
// Each warp reads the inputs of its 32 rows in chunks of 8 layers (fewer
// where a large gauss group leaves no room for 8 in shared memory) through two tiles of its own in shared memory: while it works on one
// chunk, cp.async copies the next into the other tile, coalesced
// (neighbouring lanes copy neighbouring layers of one row) and without
// holding registers; a lane then reads its row's column of the tile. Warps
// synchronise only with themselves there.
//   forward: top to bottom, the layer coefficients and the elimination; each
//            layer's q and p stored once.
//   backward (bottom to top, scratch read one layer ahead):
//            u_k = p_k - q_k * u_{k+1}[0], the layer's coefficients
//            recomputed (bit-identical to the forward's: an IR layer needs
//            only its own tau, w0, g and two Planck values), and its edge
//            fluxes put in shared memory. Every kIrEdges edges, between two
//            block barriers, one thread per (gauss group, edge, output) sums
//            the staged edges over the group's rows in order with wbin: the
//            template's order, without atomics, so results repeat bit for
//            bit.
// Scratch (nz, 4, rows): q0, q1, p0, p1 of each layer, written once and read
// once, coalesced in the thread order. What bounds it is not apportioned
// (PERF.md): in float64 a block's 88 KB of shared memory leave room for 2
// blocks (8 warps) an SM, each thread a dependent chain of divides, sqrt and
// exp per layer.

// An asynchronous copy of one value from device to shared memory (cp.async:
// no register holds it while it is in flight); copy_commit closes this
// thread's group of copies, copy_wait waits for all its groups.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"(int(sizeof(T))));
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_group 0;\n" ::); }

constexpr int kIrThreads = 128;  // threads a block aims at (whole gauss groups)
constexpr int kIrLayersLog2 = 3;  // 8 layers per tile (fewer where 8 do not fit: large groups)
constexpr int kIrEdges = 8;       // edges per reduction

// Outputs (rows/nG, nz+1) each: fup and fdn, weighted. Tiles hold TK =
// 1 << tk_log2 layers. Dynamic shared memory: the zenith weight 1 and wbin
// (nG) for reduce_edges, two tiles (4, TK, 32 + 16 bytes' worth) per warp
// (the pad keeps the copies into a tile apart in the banks), the staged
// fluxes (2, kIrEdges + 1, blockDim).
template <typename T>
__global__ void ir_weighted_kernel(
    const T* __restrict__ tau, const T* __restrict__ w0, const T* __restrict__ gt,
    const T* __restrict__ emis, const T* __restrict__ bpl, const T* __restrict__ wbin_g,
    int nG, int64_t rows, int nz, int hard, T tau_min, int tk_log2, T* __restrict__ scratch,
    T* __restrict__ out_fup, T* __restrict__ out_fdn) {
  constexpr int NOUT = 2, slots = kIrEdges + 1;
  constexpr int LDW = 32 + int(16 / sizeof(T));
  const int TK = 1 << tk_log2, WTILE = 4 * TK * LDW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bd = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* one = reinterpret_cast<T*>(smem_raw);
  T* wbin = one + 1;
  T* tiles = wbin + nG + warp * 2 * WTILE;  // this warp's two
  T* vals = wbin + nG + ((bd + 31) / 32) * 2 * WTILE;
  if (tid == 0) one[0] = T(1);
  for (int i = tid; i < nG; i += bd) wbin[i] = wbin_g[i];

  const int64_t row0 = int64_t(blockIdx.x) * bd, row = row0 + tid;
  const int nrows = int(rows - row0 < bd ? rows - row0 : bd);
  const bool active = tid < nrows;
  const int wlanes = bd - 32 * warp < 32 ? bd - 32 * warp : 32;  // the warp's threads
  const unsigned wmask = wlanes == 32 ? 0xffffffffu : (1u << wlanes) - 1u;
  const int wrows = nrows - 32 * warp < 0 ? 0 : (nrows - 32 * warp < 32 ? nrows - 32 * warp : 32);
  const int64_t wrow0 = row0 + 32 * warp;
  // Chunk c's layers k0 .. k0 + n - 1, counted from the top (forward) or
  // from the bottom (up: backward).
  auto chunk = [&](int c, bool up, int& k0, int& n) {
    const int k1 = up ? nz - c * TK : (c + 1) * TK;
    k0 = up ? (k1 > TK ? k1 - TK : 0) : c * TK;
    n = (k1 < nz ? k1 : nz) - k0;
  };
  // Start copying chunk c's tau/w0/g and Planck edges (the lower ones going
  // down, the upper ones going up) of the warp's rows into tile c % 2; lane
  // l copies elements l, l + wlanes, ... of the (row, layer) tile, row-major.
  auto fetch_tile = [&](int c, bool up) {
    int k0, n;
    chunk(c, up, k0, n);
    const int eoff = up ? 0 : 1;
    T* t = tiles + (c & 1) * WTILE;
    for (int i = lane; i < wrows * TK; i += wlanes) {
      const int r = i >> tk_log2, kk = i & (TK - 1);
      if (kk < n) {
        const int64_t g = (wrow0 + r) * nz + k0 + kk;
        copy_async(t + kk * LDW + r, tau + g);
        copy_async(t + (TK + kk) * LDW + r, w0 + g);
        copy_async(t + (2 * TK + kk) * LDW + r, gt + g);
        copy_async(t + (3 * TK + kk) * LDW + r, bpl + (wrow0 + r) * (nz + 1) + k0 + eoff + kk);
      }
    }
    copy_commit();
  };
  // wait for tile c, and let the next copy start once every lane is done
  // with tile c - 1, whose buffer it takes
  const int nch = (nz + TK - 1) / TK;
  auto next_tile = [&](int c, bool up) {
    copy_wait();
    __syncwarp(wmask);
    if (c + 1 < nch) fetch_tile(c + 1, up);
  };
  // this row's value a (tau, w0, g, Planck) at layer kk of tile c
  auto at = [&](int c, int a, int kk) { return tiles[(c & 1) * WTILE + (a * TK + kk) * LDW + lane]; };
  const int64_t sk = 4 * rows;  // scratch: layer k's value v at sc[k * sk + v * rows]
  T* sc = scratch + row;

  // ---- forward: layer coefficients and elimination; q and p per layer ----
  fetch_tile(0, false);
  // surface boundary: reflectivity Rs and source Ss
  T Rs = T(0), Ss = T(0), b_top = T(0);  // b_top: the upper Planck edge of the next layer
  if (active) {
    const T* b = bpl + row * (nz + 1);
    const T em = emis[row];
    if (hard) {
      Rs = T(1) - em;
      Ss = em * T(kPi) * b[nz];
    } else {
      const T tb = tau[row * nz + nz - 1];
      const T b1_bot = (tb <= tau_min) ? T(0) : (b[nz] - b[nz - 1]) / tb;
      Ss = T(kPi) * (b[nz] + T(0.5) * b1_bot);
    }
    b_top = b[0];
  }
  Layer<T, 1> cur, nxt;
  T Aev = T(0), Bev = T(0), Dev = T(0), Eev = T(0), p1prev = T(0), q1prev = T(0);
  // elimination step k: layer k (cur) with layer k + 1 (nxt) or the surface
  auto eliminate = [&](int k, bool surface) {
    T Aod, Bod, Dod, Eod, nAev = T(0), nBev = T(0), nDev = T(0), nEev = T(0);
    if (!surface) {
      Aod = nxt.e2 * cur.e1 - cur.e3 * nxt.e4;
      Bod = cur.e2 * nxt.e2 - cur.e4 * nxt.e4;
      Dod = nxt.e1 * nxt.e4 - nxt.e2 * nxt.e3;
      nAev = cur.e2 * cur.e3 - cur.e4 * cur.e1;
      nBev = cur.e1 * nxt.e1 - cur.e3 * nxt.e3;
      nDev = cur.e3 * nxt.e4 - cur.e1 * nxt.e2;
      Eod = nxt.e2 * (nxt.cp0[0] - cur.cpb[0]) - nxt.e4 * (nxt.cm0[0] - cur.cmb[0]);
      nEev = cur.e3 * (nxt.cp0[0] - cur.cpb[0]) + cur.e1 * (cur.cmb[0] - nxt.cm0[0]);
    } else {
      Aod = cur.e1 - Rs * cur.e3;
      Bod = cur.e2 - Rs * cur.e4;
      Dod = T(0);
      Eod = Ss - cur.cpb[0] + Rs * cur.cmb[0];
    }
    // block k: M = [[Bev, Dev], [Aod, Bod]], L01 = Aev, U10 = Dod
    T M00 = Bev - Aev * q1prev;
    T inv_det = T(1) / (M00 * Bod - Dev * Aod);
    T X00 = Bod * inv_det, X01 = -Dev * inv_det;
    T X10 = -Aod * inv_det, X11 = M00 * inv_det;
    T* s = sc + k * sk;
    q1prev = X11 * Dod;
    s[0] = X01 * Dod;
    s[rows] = q1prev;
    T f0 = Eev - Aev * p1prev;
    s[2 * rows] = X00 * f0 + X01 * Eod;
    p1prev = X10 * f0 + X11 * Eod;
    s[3 * rows] = p1prev;
    Aev = nAev; Bev = nBev; Dev = nDev; Eev = nEev;
  };
  for (int c = 0; c < nch; ++c) {
    int k0, n;
    chunk(c, false, k0, n);
    next_tile(c, false);
    if (!active) continue;
    for (int kk = 0; kk < n; ++kk) {  // layer j = k0 + kk, lower edge j + 1
      const T b_bot = at(c, 3, kk);
      if (k0 + kk == 0) {
        ir_layer<T>(at(c, 0, kk), at(c, 1, kk), at(c, 2, kk), b_top, b_bot, tau_min, cur);
        Bev = cur.e1; Dev = -cur.e2; Eev = -cur.cm0[0];
      } else {
        ir_layer<T>(at(c, 0, kk), at(c, 1, kk), at(c, 2, kk), b_top, b_bot, tau_min, nxt);
        eliminate(k0 + kk - 1, false);
        cur = nxt;
      }
      b_top = b_bot;
    }
  }
  if (active) eliminate(nz - 1, true);

  // ---- backward: back substitution, edge fluxes and their reduction ----
  const int64_t groups = rows / nG, grp0 = int64_t(blockIdx.x) * (bd / nG);
  T q0a = T(0), q1a = T(0), p0a = T(0), p1a = T(0);  // layer k's scratch, read one layer ahead
  auto fetch = [&](int k) {
    const T* s = sc + k * sk;
    q0a = s[0]; q1a = s[rows]; p0a = s[2 * rows]; p1a = s[3 * rows];
  };
  T unext = T(0), b_bot = T(0);  // b_bot: the lower Planck edge of layer k
  if (active) {
    b_bot = bpl[row * (nz + 1) + nz];
    fetch(nz - 1);
  }
  __syncwarp(wmask);  // every lane is done with the forward's tiles
  fetch_tile(0, true);
  int slot = 0, j0 = nz;  // staged edges j0, j0 - 1, ... in vals
  for (int c = 0; c < nch; ++c) {
    int k0, n;
    chunk(c, true, k0, n);
    next_tile(c, true);
    for (int kk = n - 1; kk >= 0; --kk) {  // layer k = k0 + kk, upper edge k
      const int k = k0 + kk;
      T top[NOUT], bot[NOUT];
#pragma unroll
      for (int o = 0; o < NOUT; ++o) { top[o] = T(0); bot[o] = T(0); }
      if (active) {
        const T q0 = q0a, q1 = q1a, p0 = p0a, p1 = p1a;
        if (k > 0) fetch(k - 1);
        T y1 = p0 - q0 * unext;
        T y2 = p1 - q1 * unext;
        unext = y1;
        const T b_top = at(c, 3, kk);
        Layer<T, 1> lay;
        ir_layer<T>(at(c, 0, kk), at(c, 1, kk), at(c, 2, kk), b_top, b_bot, tau_min, lay);
        b_bot = b_top;
        top[0] = y1 * lay.e3 - y2 * lay.e4 + lay.cp0[0];  // fup at the top edge; fdn there is 0
        bot[0] = y1 * lay.e1 + y2 * lay.e2 + lay.cpb[0];
        bot[1] = y1 * lay.e3 + y2 * lay.e4 + lay.cmb[0];
      }
#pragma unroll
      for (int o = 0; o < NOUT; ++o) vals[(o * slots + slot) * bd + tid] = bot[o];
      ++slot;
      if (k == 0) {
#pragma unroll
        for (int o = 0; o < NOUT; ++o) vals[(o * slots + slot) * bd + tid] = top[o];
        ++slot;
      }
      if (slot >= kIrEdges || k == 0) {  // the same at every thread
        __syncthreads();
        reduce_edges<T, NOUT>(vals, slots, slot, j0, one, wbin, 1, nG, grp0, groups, nz, out_fup,
                              out_fdn, nullptr);
        __syncthreads();
        j0 -= slot;
        slot = 0;
      }
    }
  }
}

// dynamic shared memory of a block of `threads` with tiles of 1 << tk_log2 layers
template <typename T>
size_t ir_smem(int nG, int threads, int tk_log2) {
  constexpr int LDW = 32 + int(16 / sizeof(T));
  return (size_t(1 + nG) + size_t((threads + 31) / 32) * 2 * 4 * (size_t(1) << tk_log2) * LDW
          + size_t(2) * (kIrEdges + 1) * threads) * sizeof(T);
}

// scratch (nz, 4, rows); a gauss group must fit one block, with tiles of at
// least one layer in its shared memory
template <typename T>
int launch_ir_weighted(const void* tau, const void* w0, const void* gt, const void* emis,
                       const void* bpl, const void* wbin, int nG, long long rows, int nz,
                       int hard, double tau_min, void* scratch, void* out_fup, void* out_fdn,
                       cudaStream_t stream) {
  int per = kIrThreads / nG;
  if (per < 1) per = 1;
  const int threads = per * nG;
  // the deepest tiles that fit: 8 layers but for large gauss groups
  int tk_log2 = kIrLayersLog2;
  while (tk_log2 > 0 && ir_smem<T>(nG, threads, tk_log2) > 227 * 1024) --tk_log2;
  const size_t smem = ir_smem<T>(nG, threads, tk_log2);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, ir_weighted_kernel<T>);
  if (err != cudaSuccess) return int(err);
  if (nG < 1 || nG > attr.maxThreadsPerBlock || smem > 227 * 1024)
    return int(cudaErrorInvalidConfiguration);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ir_weighted_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const long long blocks = (rows / nG) / per + ((rows / nG) % per != 0);
  ir_weighted_kernel<T><<<dim3(unsigned(blocks)), threads, smem, stream>>>(
      (const T*)tau, (const T*)w0, (const T*)gt, (const T*)emis, (const T*)bpl, (const T*)wbin,
      nG, rows, nz, hard, T(tau_min), tk_log2, (T*)scratch, (T*)out_fup, (T*)out_fdn);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_weighted(int solar, int with_amean, const void* tau, const void* w0,
                      const void* gt, const void* surf, const void* bpl, const void* u0s,
                      const void* zw, int nzen, const void* wbin, int nG, long long rows,
                      int nz, int hard, double tau_min, void* scratch, void* out_am,
                      void* out_fup, void* out_fdn, cudaStream_t s) {
  if (!solar)
    return launch_ir_weighted<T>(tau, w0, gt, surf, bpl, wbin, nG, rows, nz, hard, tau_min,
                                 scratch, out_fup, out_fdn, s);
  if (with_amean)
    return launch_solar_weighted<T, true>(tau, w0, gt, surf, u0s, zw, nzen, wbin, nG, rows, nz,
                                          scratch, out_am, out_fup, out_fdn, s);
  return launch_solar_weighted<T, false>(tau, w0, gt, surf, u0s, zw, nzen, wbin, nG, rows, nz,
                                         scratch, out_am, out_fup, out_fdn, s);
}

template <typename T>
int dispatch_rows(int solar, int u0_per_row, const void* tau, const void* w0, const void* gt,
                  const void* surf, const void* bpl, const void* u0, int nzen, long long rows,
                  int nz, int hard, double tau_min, void* scratch, void* out_am, void* out_fup,
                  void* out_fdn, void* out_srad, cudaStream_t s) {
#define CLIMA_ARGS tau, w0, gt, surf, bpl, u0, nzen, rows, nz, hard, tau_min, scratch, out_am, \
                   out_fup, out_fdn, out_srad, s
  if (!solar) return launch<T, false, false, 1, false>(CLIMA_ARGS);
  if (u0_per_row) return launch<T, true, true, 1, true>(CLIMA_ARGS);
  return int(cudaErrorInvalidValue);  // shared zenith cosines: clima_twostream_solar_multi
#undef CLIMA_ARGS
}

}  // namespace

// Plain C entry points. Pointers are device pointers; arrays are contiguous:
// tau/w0/gt (rows, nz), surf (rows,) emissivity (IR) or albedo (solar),
// bpl (rows, nz+1) (IR only). Each returns the launch's cudaError_t.

// Weighted: u0s/zw (nzen,) (solar only), wbin (nG,), outputs (rows/nG, nz+1).
// Scratch: IR (nz, 4, rows); solar nz * rows * (3 + 2*nzen) values (q, tauc,
// p). Requires rows % nG == 0, 1 <= nG <= 1024, nz >= 1; for IR, nG at most
// the IR kernel's block (its registers bound it; an error otherwise); for
// solar, nG * nzen <= clima_twostream_solar_max_group(...).
extern "C" int clima_twostream_weighted(int is_f64, int solar, int with_amean,
                                        const void* tau, const void* w0, const void* gt,
                                        const void* surf, const void* bpl, const void* u0s,
                                        const void* zw, int nzen, const void* wbin, int nG,
                                        long long rows, int nz, int hard, double tau_min,
                                        void* scratch, void* out_am, void* out_fup,
                                        void* out_fdn, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64)
    return dispatch_weighted<double>(solar, with_amean, tau, w0, gt, surf, bpl, u0s, zw, nzen,
                                     wbin, nG, rows, nz, hard, tau_min, scratch, out_am,
                                     out_fup, out_fdn, s);
  return dispatch_weighted<float>(solar, with_amean, tau, w0, gt, surf, bpl, u0s, zw, nzen,
                                  wbin, nG, rows, nz, hard, tau_min, scratch, out_am, out_fup,
                                  out_fdn, s);
}

// The largest gauss group times zenith count (threads) one launch of the
// weighted solar kernel takes on this device (its registers bound it), or a
// negated cudaError_t.
extern "C" int clima_twostream_solar_max_group(int is_f64, int with_amean) {
  if (is_f64)
    return with_amean ? solar_max_group<double, true>() : solar_max_group<double, false>();
  return with_amean ? solar_max_group<float, true>() : solar_max_group<float, false>();
}

// Unreduced, the row template: IR, or solar with one zenith cosine per row
// (u0_per_row = 1, u0 (rows,), nzen = 1; shared zenith cosines go to
// clima_twostream_solar_multi). Scratch (nz, 4, rows); outputs amean/fup/fdn
// (rows, nz+1) and srad (rows,) for solar, fup/fdn (rows, nz+1) for IR
// (out_am and out_srad unused). Requires nz >= 1.
extern "C" int clima_twostream_rows(int is_f64, int solar, int u0_per_row, const void* tau,
                                    const void* w0, const void* gt, const void* surf,
                                    const void* bpl, const void* u0, int nzen, long long rows,
                                    int nz, int hard, double tau_min, void* scratch,
                                    void* out_am, void* out_fup, void* out_fdn,
                                    void* out_srad, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64)
    return dispatch_rows<double>(solar, u0_per_row, tau, w0, gt, surf, bpl, u0, nzen, rows, nz,
                                 hard, tau_min, scratch, out_am, out_fup, out_fdn, out_srad, s);
  return dispatch_rows<float>(solar, u0_per_row, tau, w0, gt, surf, bpl, u0, nzen, rows, nz,
                              hard, tau_min, scratch, out_am, out_fup, out_fdn, out_srad, s);
}

// Unreduced multi-zenith solar: u0s (nzen,) shared by all rows, surf the
// albedo (rows,); scratch nz * rows * (3 + 2*nzen) values (q, tauc, p);
// outputs amean/fup/fdn (nzen, rows, nz+1) and srad (nzen, rows). Any
// nzen >= 1 in one launch; requires nz >= 1, rows >= 1 and
// ceil(rows * nzen / 128) < 2^31.
extern "C" int clima_twostream_solar_multi(int is_f64, const void* tau, const void* w0,
                                           const void* gt, const void* surf, const void* u0s,
                                           int nzen, long long rows, int nz, void* scratch,
                                           void* out_am, void* out_fup, void* out_fdn,
                                           void* out_srad, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64)
    return launch_solar_rows<double>(tau, w0, gt, surf, u0s, nzen, rows, nz, scratch, out_am,
                                     out_fup, out_fdn, out_srad, s);
  return launch_solar_rows<float>(tau, w0, gt, surf, u0s, nzen, rows, nz, scratch, out_am,
                                  out_fup, out_fdn, out_srad, s);
}
