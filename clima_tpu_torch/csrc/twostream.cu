// Toon et al. (1989) two-stream solves for Hopper (sm_90a), float and double:
// weight-fused (the gauss and zenith sums done in the kernel) and unreduced
// (every row's edge fluxes written out).
//
// Replaces the JAX package's Pallas TPU kernels
//   clima_tpu/ops/pallas_twostream.py::two_stream_ir_weighted_pallas
//     (_ir_weighted_kernel): hemispheric-mean IR, linear-in-tau Planck source
//   clima_tpu/ops/pallas_twostream.py::two_stream_solar_multi_weighted_pallas
//     (_solar_multi_weighted_kernel): delta-Eddington quadrature solar, all
//     zenith angles through one elimination, amean optional
//   clima_tpu/ops/pallas_twostream.py::two_stream_ir_pallas (_ir_kernel):
//     IR per row, unreduced
//   clima_tpu/ops/pallas_twostream.py::two_stream_solar_multi_pallas
//     (_solar_multi_kernel): multi-zenith solar per row, unreduced, with the
//     surface radiance
//   clima_tpu/ops/pallas_twostream.py::two_stream_solar_pallas
//     (_solar_kernel): single-zenith solar, one zenith cosine per row
// and computes what clima_tpu/ops/twostream.py computes for them.
//
// Design. One thread owns one (column, bin, gauss point) row and solves its
// 2nz system by 2x2-block Thomas elimination (never scalar Thomas: scalar
// pivots vanish in optically thin layers; the 2x2 blocks stay well
// conditioned). Block row k couples u_{k-1}[1] through L01 and u_{k+1}[0]
// through U10, so the forward sweep only changes M00 and f0, and each block
// leaves p = inv(M') f' and q = inv(M')[:, 1] * U10 for the back
// substitution u_k = p_k - q_k * u_{k+1}[0]. The matrix is zenith independent:
// q is shared and only p is carried per zenith right-hand side.
//   pass 1  forward: layer coefficients, elimination, p and q to scratch
//   pass 2  backward: u_k overwrites p_k in scratch
//   pass 3  forward: recompute the layer coefficients (bit-identical to
//           pass 1) and rebuild the edge fluxes. Weighted (REDUCE): sum the
//           zenith angles in registers and the nG rows of a gauss group in
//           shared memory in a fixed order; a block holds whole gauss groups;
//           no atomics, so results repeat bit for bit. Unreduced: each thread
//           stores its own row's edges (and the surface radiance), per zenith.
// Scratch is laid out (nz, values, rows), rows fastest, so its accesses are
// coalesced. What bounds it: the per-thread sequential recurrence over nz
// (latency of dependent double-precision divides and exps) and, at the
// flagship shapes, the strided (rows, nz) reads of tau/w0/g; recomputing
// the coefficients in pass 3 trades cheap arithmetic for not storing them.
// The unreduced stores are strided too (a thread writes one (rows, nz+1)
// row), so they are not coalesced; that is left as it is for now.

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

// Weighted sum over the nG rows of each gauss group at edge j, in a fixed
// order, then one store per group and output.
template <typename T, int NOUT>
__device__ __forceinline__ void reduce_store(T* sm, const T* v, bool lead, const T* wbin,
                                             int nG, int64_t grp, int j, int nz,
                                             T* const* outs) {
  const int bd = blockDim.x, tid = threadIdx.x;
#pragma unroll
  for (int o = 0; o < NOUT; ++o) sm[o * bd + tid] = v[o];
  __syncthreads();
  if (lead) {
#pragma unroll
    for (int o = 0; o < NOUT; ++o) {
      T s = T(0);
      for (int g = 0; g < nG; ++g) s += wbin[g] * sm[o * bd + tid + g];
      outs[o][grp * (nz + 1) + j] = s;
    }
  }
  __syncthreads();
}

// REDUCE: outputs (rows/nG, nz+1), zenith- and gauss-weighted.
// !REDUCE: outputs (nzen, rows, nz+1) (IR: (rows, nz+1)); out_srad (nzen, rows).
// ROW: one zenith cosine per row, u0s_g (rows,), NR = 1.
template <typename T, bool SOLAR, bool AMEAN, int NR, bool REDUCE, bool ROW>
__global__ void twostream_kernel(
    const T* __restrict__ tau, const T* __restrict__ w0, const T* __restrict__ gt,
    const T* __restrict__ surf, const T* __restrict__ bpl, const T* __restrict__ u0s_g,
    const T* __restrict__ zw_g, int nzen, const T* __restrict__ wbin_g, int nG,
    int64_t rows, int nz, int hard, T tau_min, T* __restrict__ scratch,
    T* __restrict__ out_am, T* __restrict__ out_fup, T* __restrict__ out_fdn,
    T* __restrict__ out_srad) {
  constexpr int NOUT = AMEAN ? 3 : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);  // NOUT * blockDim (REDUCE only)
  __shared__ T u0s[NR], zw[NR], wbin[REDUCE ? 1024 : 1];
  const int nrhs = SOLAR ? nzen : 1;
  if constexpr (REDUCE) {
    for (int i = threadIdx.x; i < nG; i += blockDim.x) wbin[i] = wbin_g[i];
  }
  if (SOLAR && !ROW && threadIdx.x < nzen) {
    u0s[threadIdx.x] = u0s_g[threadIdx.x];
    if (REDUCE) zw[threadIdx.x] = zw_g[threadIdx.x];
  }
  __syncthreads();

  const int64_t row = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool active = row < rows;
  const int64_t grp = row / nG;
  const bool lead = active && (row % nG == 0);
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

  // ---- pass 3: edge fluxes, reduced or stored per row ----
  T* outs[3];
  if (AMEAN) { outs[0] = out_fup; outs[1] = out_fdn; outs[2] = out_am; }
  else { outs[0] = out_fup; outs[1] = out_fdn; outs[2] = nullptr; }
  const int64_t ne = nz + 1;
  T tauc = T(0);
  for (int k = 0; k < nz; ++k) {
    T top[NOUT], bot[NOUT];
#pragma unroll
    for (int o = 0; o < NOUT; ++o) { top[o] = T(0); bot[o] = T(0); }
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
            if constexpr (REDUCE) {
              T wz = zw[r];
              top[0] += wz * fup_t;
              top[1] += wz * dir_t;
              bot[0] += wz * fup_b;
              bot[1] += wz * (fdn_b + c.dir_b[r]);
              if (AMEAN) {
                top[NOUT - 1] += wz * am_t;
                bot[NOUT - 1] += wz * am_b;
              }
            } else {
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
            }
          } else if constexpr (REDUCE) {
            top[0] = fup_t;
            bot[0] = fup_b;
            bot[1] = fdn_b;
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
    if constexpr (REDUCE) {
      if (k == 0) reduce_store<T, NOUT>(sm, top, lead, wbin, nG, grp, 0, nz, outs);
      reduce_store<T, NOUT>(sm, bot, lead, wbin, nG, grp, k + 1, nz, outs);
    }
  }
}

template <typename T, bool SOLAR, bool AMEAN, int NR, bool REDUCE, bool ROW>
int launch(const void* tau, const void* w0, const void* gt, const void* surf,
           const void* bpl, const void* u0s, const void* zw, int nzen, const void* wbin,
           int nG, long long rows, int nz, int hard, double tau_min, void* scratch,
           void* out_am, void* out_fup, void* out_fdn, void* out_srad, cudaStream_t stream) {
  constexpr int NOUT = AMEAN ? 3 : 2;
  int threads = 128;
  long long blocks = (rows + threads - 1) / threads;
  size_t smem = 0;
  if (REDUCE) {
    int per = 128 / nG;
    if (per < 1) per = 1;
    threads = per * nG;
    long long groups = rows / nG;
    blocks = (groups + per - 1) / per;
    smem = size_t(NOUT) * threads * sizeof(T);
  }
  twostream_kernel<T, SOLAR, AMEAN, NR, REDUCE, ROW><<<dim3(unsigned(blocks)), threads, smem,
                                                       stream>>>(
      (const T*)tau, (const T*)w0, (const T*)gt, (const T*)surf, (const T*)bpl,
      (const T*)u0s, (const T*)zw, nzen, (const T*)wbin, nG, rows, nz, hard, T(tau_min),
      (T*)scratch, (T*)out_am, (T*)out_fup, (T*)out_fdn, (T*)out_srad);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_weighted(int solar, int with_amean, const void* tau, const void* w0,
                      const void* gt, const void* surf, const void* bpl, const void* u0s,
                      const void* zw, int nzen, const void* wbin, int nG, long long rows,
                      int nz, int hard, double tau_min, void* scratch, void* out_am,
                      void* out_fup, void* out_fdn, cudaStream_t s) {
#define CLIMA_ARGS tau, w0, gt, surf, bpl, u0s, zw, nzen, wbin, nG, rows, nz, hard, tau_min, \
                   scratch, out_am, out_fup, out_fdn, nullptr, s
  if (!solar) return launch<T, false, false, 1, true, false>(CLIMA_ARGS);
  if (nzen <= 4) {
    if (with_amean) return launch<T, true, true, 4, true, false>(CLIMA_ARGS);
    return launch<T, true, false, 4, true, false>(CLIMA_ARGS);
  }
  if (with_amean) return launch<T, true, true, 8, true, false>(CLIMA_ARGS);
  return launch<T, true, false, 8, true, false>(CLIMA_ARGS);
#undef CLIMA_ARGS
}

template <typename T>
int dispatch_rows(int solar, int u0_per_row, const void* tau, const void* w0, const void* gt,
                  const void* surf, const void* bpl, const void* u0, int nzen, long long rows,
                  int nz, int hard, double tau_min, void* scratch, void* out_am, void* out_fup,
                  void* out_fdn, void* out_srad, cudaStream_t s) {
#define CLIMA_ARGS tau, w0, gt, surf, bpl, u0, nullptr, nzen, nullptr, 1, rows, nz, hard, \
                   tau_min, scratch, out_am, out_fup, out_fdn, out_srad, s
  if (!solar) return launch<T, false, false, 1, false, false>(CLIMA_ARGS);
  if (u0_per_row) return launch<T, true, true, 1, false, true>(CLIMA_ARGS);
  if (nzen <= 4) return launch<T, true, true, 4, false, false>(CLIMA_ARGS);
  return launch<T, true, true, 8, false, false>(CLIMA_ARGS);
#undef CLIMA_ARGS
}

}  // namespace

// Plain C entry points. Pointers are device pointers; arrays are contiguous:
// tau/w0/gt (rows, nz), surf (rows,) emissivity (IR) or albedo (solar),
// bpl (rows, nz+1) (IR only). Each returns the launch's cudaError_t.

// Weighted: u0s/zw (nzen,) (solar only), wbin (nG,), scratch
// (nz, 2 + 2*nrhs, rows) with nrhs = 4 if nzen <= 4 else 8 (solar) or 1 (IR),
// outputs (rows/nG, nz+1). Requires rows % nG == 0, 1 <= nG <= 1024, nz >= 1,
// 1 <= nzen <= 8.
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

// Unreduced: u0 (nzen,) shared, or (rows,) with u0_per_row (then nzen = 1);
// scratch (nz, 2 + 2*nrhs, rows) with nrhs = 1 (IR, per-row u0), 4 (nzen <= 4)
// or 8; outputs amean/fup/fdn (nzen, rows, nz+1) and srad (nzen, rows) for
// solar, fup/fdn (rows, nz+1) for IR (out_am and out_srad unused).
// Requires nz >= 1 and 1 <= nzen <= 8.
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
