// Moist-adiabat march of a batch of columns for Hopper (sm_90a), float and
// double: every column from the surface to P_top in one launch.
//
// Replaces no TPU kernel. The JAX package jits the same march
// (clima_tpu/adiabat/profile.py make_profile_core, a scan over the grid's
// intervals); the port ran it as a CUDA graph of one interval, some 28000
// small tensor operations over the batch, captured on every call and
// replayed for the other intervals (adiabat/profile.py _march_torch, which
// stays as this kernel's twin). A replay ran at 1.2-1.7 us a graph node, so
// the card spent the march launching kernels of a few hundred threads.
//
// What a column computes is the twin's, function by function: each grid
// interval of the 2 nz + 1 log-P edges is K substeps (_substep), each the
// event-split RK4 of _rk4_event_split (latent-heat kinks at T_triple and
// T_critical, dry -> condensing switches; the first event by torch.argmin's
// order over the 3 ng candidates, two secant refinements, the second piece
// on the far branch or under the grown condensing set), the tropopause
// crossing re-stepped to P_cross, the isothermal stratosphere above it, and
// update_mask's n_condensible passes; at each interval's end the mixing
// ratios. Where the twin computes every branch for every column and selects
// with torch.where, a column here takes its own branch: the secant and the
// second piece only on an event, the re-step only on a crossing, and
// nothing but the isothermal altitude above the tropopause. Out-of-range
// heat capacities are NaN and propagate as in the twin. Beside the profile a
// column writes, once, its `events` as the twin counts them: the substeps
// below the tropopause whose step to the substep's end was split (a re-step
// to the crossing is not counted), and whether its condensing set grew
// above the surface. The library is
// built with -fmad=false (ops/cuda_build.py): every operation rounds as the
// twin's tensor operation does, in the twin's order, so the march's discrete
// choices (events, the condensing set, the tropopause) fall as the twin's.
//
// Design. A group of G lanes, G the smallest power of two >= ng (<= 32),
// marches one column; lane g owns gas g: its saturation regimes, kinks,
// heat-capacity ranges and polynomials (its row of the per-gas table, staged
// in shared memory), its mass, RH and surface dry proportion, and its bit of
// the condensing set. Sums over gases and the argmin over the event
// candidates are __shfl_xor_sync butterflies of width G, so every lane of a
// group holds the same column state and takes the same branch; the shuffles
// name only the group's lanes, since groups of one warp branch apart. A
// block of 64 threads holds 64 / G columns, so 1024 columns of 7 gases fill
// 128 blocks of two warps over the 132 SMs. The state stays in registers
// from the surface to the top; each level's T, z and mixing ratios are
// written once.
//
// What bounds it: the serial chain of each column (K * 2 nz substeps, each
// 4-10 RHS evaluations whose log, exp and divisions are FP64 latency), not
// memory or throughput: a group's lanes split the per-gas work of an RHS,
// and nothing overlaps one substep with the next. On an H100 one column
// alone takes 4.6 ms at nz 100, K 6, and 1024 columns 6.2-6.4 ms.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BLOCK = 64;

// a gas's row of the table (ops/march_cuda.py, pack_tables)
constexpr int BRANCH = 0;  // 3 regimes x (-a, b, K, D, a)
constexpr int T_TRIPLE = 15, T_CRITICAL = 16, MU_R = 17, P_REF = 18, MASS = 19, HAS_SAT = 20;
constexpr int TEMPS = 21;  // nr + 1 range edges, then nr x 7 polynomial coefficients

// the constants (ops/march_cuda.py, pack_tables)
enum { C_RGAS, C_RGAS_SI, C_GM, C_RADIUS, C_NK, C_GM_CGS, C_BIG, C_F_DRY_MIN };

__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }

// torch.clamp: NaN stays NaN
template <typename T>
__device__ __forceinline__ T at_least(T x, T lo) { return x < lo ? lo : x; }
template <typename T>
__device__ __forceinline__ T at_most(T x, T hi) { return x > hi ? hi : x; }

template <typename T>
struct Args {
  int B, ng, nr, ne, K, n_cond, G;
  const T* tab;
  const T* consts;
  const T* T_surf;
  const T* T_trop;
  const T* RH;  // (B, ng)
  const T* r_dry;
  const unsigned char* mask0;
  const T* f_surf;
  const T* P_e;
  const T* lP;
  T* T_e;
  T* z_e;
  T* f_e;
  T* P_trop;
  int* events;  // (B, 2): event-split substeps, onset above the surface
};

template <typename T>
struct Branch {
  T neg_a, b, K, D, a;
};

// what is fixed over one RK4 piece (profile._Piece): this lane's bit of the
// condensing set, its normalized dry proportion, its regime constants
template <typename T>
struct Piece {
  bool m;
  T rn;
  Branch<T> br;
};

// one lane of a column's group: its gas and the column's constants
template <typename T>
struct Lane {
  const T* row;
  int g, G, ng, nr;
  unsigned gm;
  bool act, sat;
  T RH, r_dry, mu_R, P_ref, mass, T_triple, T_critical;
  T Rgas, Rsi, GM, R, NK, GMc, BIG, FMIN;

  // the sum over the column's gases, the same in every lane
  __device__ __forceinline__ T sum(T v) const {
    v = act ? v : T(0);
    for (int o = G >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(gm, v, o, G);
    return v;
  }
  __device__ __forceinline__ T from(T v, int lane) const { return __shfl_sync(gm, v, lane, G); }
};

// saturation.select_branch: the regime at Tb
template <typename T>
__device__ __forceinline__ Branch<T> branch(const Lane<T>& q, T Tb) {
  const T* p = q.row + BRANCH + 5 * (int(Tb > q.T_triple) + int(Tb >= q.T_critical));
  return {p[0], p[1], p[2], p[3], p[4]};
}

// RH * saturation.sat_pressure_branch
template <typename T>
__device__ __forceinline__ T psat(const Lane<T>& q, const Branch<T>& br, T Tv) {
  T s = q.BIG;
  if (q.sat) s = q.P_ref * exp_(q.mu_R * ((br.K + (br.neg_a / Tv + br.b * log_(Tv))) - br.D));
  return q.RH * s;
}

// profile._mix: this lane's mixing ratio, and f_dry
template <typename T>
__device__ __forceinline__ T mix(const Lane<T>& q, T ps, T P, bool m, T rn, T& f_dry) {
  const T fc = at_most(ps / P, T(1));
  f_dry = at_least(T(1) - q.sum(m ? fc : T(0)), q.FMIN);
  return m ? fc : f_dry * rn;
}

// profile._norm_dry
template <typename T>
__device__ __forceinline__ T norm_dry(const Lane<T>& q, bool m) {
  const T r = m ? T(0) : q.r_dry;
  return r / at_least(q.sum(r), T(1e-200));
}

// config.species.heat_capacity, J/(mol K); NaN outside the ranges
template <typename T>
__device__ __forceinline__ T heat_capacity(const Lane<T>& q, T Tv) {
  const T* edges = q.row + TEMPS;
  int idx = -1;
  for (int r = 0; r < q.nr; ++r) idx += int(Tv >= edges[r]);
  idx = idx < 0 ? 0 : (idx > q.nr - 1 ? q.nr - 1 : idx);
  const T* c = edges + q.nr + 1 + 7 * idx;
  const T inv = T(1) / Tv, T2 = Tv * Tv;
  const T cp = c[0] * (inv * inv) + c[1] * inv + c[2] + c[3] * Tv + c[4] * T2 + c[5] * (T2 * Tv) +
               c[6] * (T2 * T2);
  return (Tv >= edges[0] && Tv < edges[q.nr]) ? cp : T(NAN);
}

// profile._rhs: [dT/dP, dz/dP]
template <typename T>
__device__ __forceinline__ void rhs(const Lane<T>& q, const Piece<T>& pc, T P, T Tv, T zv, T& dT,
                                    T& dz) {
  T f_dry;
  const T fi = mix(q, psat(q, pc.br, Tv), P, pc.m, pc.rn, f_dry);
  // profile._lapse
  const T cp = heat_capacity(q, Tv);
  const T cp_dry = q.sum(pc.m ? T(0) : pc.rn * cp) + T(1e-300);
  const T beta = (((pc.br.a + pc.br.b * Tv) * q.mass) * T(1e-7)) / (q.Rsi * Tv);
  const T first = q.sum(pc.m ? fi * ((cp - q.Rsi * beta) + q.Rsi * (beta * beta)) : T(0));
  const T second = q.sum(pc.m ? beta * fi : T(0));
  const T lapse =
      T(1) / (f_dry * ((cp_dry * f_dry + first) / (q.Rsi * (f_dry + second))) + second);
  dT = lapse * (Tv / P);
  // profile._gravity (a division by a number is a product with its inverse
  // on the card, a number over a tensor the tensor's reciprocal times it)
  const T r = (q.R + zv) * (T(1) / T(100));
  const T grav = ((T(1) / (r * r)) * q.GM) * T(100);
  dz = -(q.Rgas * Tv) / ((grav * P) * q.sum(fi * q.mass));
}

// profile._rk4, its four stages in one loop
template <typename T>
__device__ __forceinline__ void rk4(const Lane<T>& q, const Piece<T>& pc, T P0, T P1, T& Tv,
                                    T& zv) {
  const T h = P1 - P0, hh = T(0.5) * h, Pm = P0 + hh;
  T kT = T(0), kz = T(0), sT = T(0), sz = T(0);
#pragma unroll 1
  for (int s = 0; s < 4; ++s) {
    const T d = s == 3 ? h : hh;
    const T Ts = s == 0 ? Tv : Tv + d * kT, zs = s == 0 ? zv : zv + d * kz;
    rhs(q, pc, s == 0 ? P0 : (s == 3 ? P1 : Pm), Ts, zs, kT, kz);
    if (s == 0) {
      sT = kT;
      sz = kz;
    } else if (s == 3) {
      sT = sT + kT;
      sz = sz + kz;
    } else {
      sT = sT + T(2) * kT;
      sz = sz + T(2) * kz;
    }
  }
  const T h6 = h * (T(1) / T(6));
  Tv = Tv + h6 * sT;
  zv = zv + h6 * sz;
}

// the saturation excess f_i * P - RH_i * psat_i under the piece's set
template <typename T>
__device__ __forceinline__ T g_sat(const Lane<T>& q, const Piece<T>& pc, T P, T Tv) {
  const T ps = psat(q, pc.br, Tv);
  T f_dry;
  return mix(q, ps, P, pc.m, pc.rn, f_dry) * P - ps;
}

// torch.argmin's order: NaN first, then the smaller value, ties to the
// smaller index
template <typename T>
__device__ __forceinline__ bool before(T a, int ia, T b, int ib) {
  if (isnan(a)) return isnan(b) ? ia < ib : true;
  return a == b ? ia < ib : a < b;
}

// One substep over log-P [la, lb] from (Tv, zv) (profile._substep's step):
// with condensible gases profile._rk4_event_split, else one RK4. Returns
// whether the step was split at an event.
template <typename T>
__device__ __forceinline__ bool step(const Lane<T>& q, bool m, T rn, T la, T lb, int n_cond, T& Tv,
                                     T& zv) {
  const T Pa = exp_(la), Pb = exp_(lb);
  const T T0 = Tv, z0 = zv;
  const Piece<T> p0{m, rn, branch(q, T0)};
  T T1 = T0, z1 = z0;
  rk4(q, p0, Pa, Pb, T1, z1);
  Tv = T1;
  zv = z1;
  if (n_cond == 0) return false;

  // candidate events with linear-in-theta first estimates: [T_triple kinks,
  // T_critical kinks, condensation onsets], gas g's at g, ng + g, 2 ng + g
  const T INF = T(INFINITY);
  const T dT = T0 - T1;
  const T denT = abs_(dT) > T(1e-300) ? dT : T(1e-300);
  const T dKt = T0 - q.T_triple, dKc = T0 - q.T_critical;
  const T th_t = (q.sat && dKt * (T1 - q.T_triple) < T(0)) ? dKt / denT : INF;
  const T th_c = (q.sat && dKc * (T1 - q.T_critical) < T(0)) ? dKc / denT : INF;
  const T g0 = g_sat(q, p0, Pa, T0), g1 = g_sat(q, p0, Pb, T1);
  const T dg = g0 - g1;
  const T denG = abs_(dg) > T(1e-300) ? dg : T(1e-300);
  const T th_m = (q.sat && !m && g0 < T(0) && g1 >= T(0)) ? g0 / denG : INF;
  T th = th_t;
  int j = q.g;
  if (before(th_c, q.ng + q.g, th, j)) th = th_c, j = q.ng + q.g;
  if (before(th_m, 2 * q.ng + q.g, th, j)) th = th_m, j = 2 * q.ng + q.g;
  if (!q.act) th = INF, j = 3 * q.ng + q.g;
  for (int o = q.G >> 1; o > 0; o >>= 1) {
    const T th_o = __shfl_xor_sync(q.gm, th, o, q.G);
    const int j_o = __shfl_xor_sync(q.gm, j, o, q.G);
    if (before(th_o, j_o, th, j)) th = th_o, j = j_o;
  }
  if (!(isfinite(th) && th < T(1))) return false;  // no event: the unsplit step

  const bool kink = j < 2 * q.ng;
  const int jg = kink ? 0 : j - 2 * q.ng;  // the gas of an onset
  const T K_sel = q.from(j < q.ng ? q.T_triple : q.T_critical, kink ? j % q.ng : 0);
  const T r0 = kink ? T0 - K_sel : q.from(g0, jg);
  const T dl = lb - la;
  // two secant iterations on the piece-0 trajectory
  T theta = at_most(at_least(th, T(1e-6)), T(1.0 - 1e-6));
#pragma unroll 1
  for (int it = 0; it < 2; ++it) {
    const T Pc = exp_(la + theta * dl);
    T Tc = T0, zc = z0;
    rk4(q, p0, Pa, Pc, Tc, zc);
    const T ra = kink ? Tc - K_sel : q.from(g_sat(q, p0, Pc, Tc), jg);
    const T dr = r0 - ra;
    const T t = (theta * r0) / (abs_(dr) > T(1e-300) ? dr : T(1e-300));
    theta = at_most(at_least(isfinite(t) ? t : theta, T(1e-6)), T(1.0 - 1e-6));
  }
  // to the event, then on: the far latent-heat branch, or the grown set
  const T Pc = exp_(la + theta * dl);
  T Tc = T0, zc = z0;
  rk4(q, p0, Pa, Pc, Tc, zc);
  const bool m2 = m || (!kink && q.g == jg);
  const Piece<T> p2{m2, norm_dry(q, m2), branch(q, T1)};
  rk4(q, p2, Pc, Pb, Tc, zc);
  Tv = Tc;
  zv = zc;
  return true;
}

// profile.update_mask: the condensing set's growth at (P, Tv)
template <typename T>
__device__ __forceinline__ bool update_mask(const Lane<T>& q, bool m, T P, T Tv, int n_cond) {
  const T ps = psat(q, branch(q, Tv), Tv);
#pragma unroll 1
  for (int k = 0; k < n_cond; ++k) {
    T f_dry;
    const T fi = mix(q, ps, P, m, norm_dry(q, m), f_dry);
    m = m || (q.sat && fi * P > ps);
  }
  return m;
}

// profile._altitude_isothermal
template <typename T>
__device__ __forceinline__ T z_isothermal(const Lane<T>& q, T P, T Tt, T mubar, T P0, T z0) {
  return T(1) / ((q.NK * Tt) / (q.GMc * mubar) * log_(P / P0) + T(1) / (q.R + z0)) - q.R;
}

template <typename T>
__global__ void __launch_bounds__(BLOCK, 1) march_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tab = reinterpret_cast<T*>(smem);
  const int W = TEMPS + 8 * a.nr + 1;
  for (int i = threadIdx.x; i < a.ng * W; i += blockDim.x) tab[i] = a.tab[i];
  __syncthreads();
  const int G = a.G, g = threadIdx.x & (G - 1), ng = a.ng, ne = a.ne;
  const int b = blockIdx.x * (BLOCK / G) + threadIdx.x / G;
  if (b >= a.B) return;

  Lane<T> q;
  q.g = g, q.G = G, q.ng = ng, q.nr = a.nr, q.act = g < ng;
  q.gm = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (threadIdx.x & 31 & ~(G - 1));
  q.row = tab + (q.act ? g : ng - 1) * W;
  q.sat = q.act && q.row[HAS_SAT] != T(0);
  q.RH = q.act ? a.RH[(size_t)b * ng + g] : T(0);
  q.r_dry = q.act ? a.r_dry[(size_t)b * ng + g] : T(0);
  q.mu_R = q.row[MU_R], q.P_ref = q.row[P_REF], q.mass = q.row[MASS];
  q.T_triple = q.row[T_TRIPLE], q.T_critical = q.row[T_CRITICAL];
  q.Rgas = a.consts[C_RGAS], q.Rsi = a.consts[C_RGAS_SI], q.GM = a.consts[C_GM];
  q.R = a.consts[C_RADIUS], q.NK = a.consts[C_NK], q.GMc = a.consts[C_GM_CGS];
  q.BIG = a.consts[C_BIG], q.FMIN = a.consts[C_F_DRY_MIN];

  const T* lP = a.lP + (size_t)b * ne;
  T* Te = a.T_e + (size_t)b * ne;
  T* ze = a.z_e + (size_t)b * ne;
  T* fe = a.f_e + (size_t)b * ne * ng;
  const T Tt = a.T_trop[b];
  T Tv = a.T_surf[b], zv = T(0), P_trop = T(-1), z_trop = T(0), mubar_trop = T(0);
  bool m = q.act && a.mask0[(size_t)b * ng + g] != 0, tropped = false;
  const bool m0 = m;
  int splits = 0;
  if (g == 0) Te[0] = Tv, ze[0] = T(0);
  if (q.act) fe[g] = a.f_surf[(size_t)b * ng + g];
  const T ps_trop = psat(q, branch(q, Tt), Tt);
  const T inv_K = T(1) / T(a.K);

#pragma unroll 1
  for (int i = 0; i < ne - 1; ++i) {
    const T la_i = lP[i], dl_i = lP[i + 1] - lP[i];
#pragma unroll 1
    for (int k = 0; k < a.K; ++k) {
      const T la = la_i + (dl_i * T(k)) * inv_K, lb = la_i + (dl_i * T(k + 1)) * inv_K;
      const T Pb = exp_(lb);
      if (!tropped) {
        const T rn = norm_dry(q, m);
        // the step to lb; where it ends below T_trop, the tropopause lies
        // inside it and a second pass re-steps to P_cross (one call site)
        T lP_end = lb, Tn = Tv, zn = zv;
#pragma unroll 1
        for (int pass = 0; pass < 2; ++pass) {
          T Ts = Tv, zs = zv;
          const bool split = step(q, m, rn, la, lP_end, a.n_cond, Ts, zs);
          if (pass == 1) {
            z_trop = zs;
            break;
          }
          Tn = Ts, zn = zs;
          splits += int(split);
          if (!(Tn <= Tt)) break;
          const T theta = (Tv - Tt) / at_least(Tv - Tn, T(1e-30));
          lP_end = la + theta * (lb - la);
        }
        if (Tn <= Tt) {
          P_trop = exp_(lP_end);
          T f_dry;
          mubar_trop = q.sum(mix(q, ps_trop, P_trop, m, rn, f_dry) * q.mass);
          tropped = true;
        } else {
          Tv = Tn, zv = zn;
          m = update_mask(q, m, Pb, Tv, a.n_cond);
        }
      }
      if (tropped) Tv = Tt, zv = z_isothermal(q, Pb, Tt, mubar_trop, P_trop, z_trop);
    }
    // profile.mixing_ratios at the interval's end
    const T P_end = tropped ? P_trop : a.P_e[(size_t)b * ne + i + 1];
    const T Tx = tropped ? Tt : Tv;
    T f_dry;
    const T fi = mix(q, psat(q, branch(q, Tx), Tx), P_end, m, norm_dry(q, m), f_dry);
    if (g == 0) Te[i + 1] = Tv, ze[i + 1] = zv;
    if (q.act) fe[(size_t)(i + 1) * ng + g] = fi;
  }
  const bool grew = q.sum(T(m && !m0)) > T(0);
  if (g == 0) {
    a.P_trop[b] = tropped ? P_trop : T(-1);
    a.events[2 * (size_t)b] = splits;
    a.events[2 * (size_t)b + 1] = int(grew);
  }
}

template <typename T>
int launch(int B, int ng, int nr, int ne, int K, int n_cond, const void* tab, const void* consts,
           const void* T_surf, const void* T_trop, const void* RH, const void* r_dry,
           const void* mask0, const void* f_surf, const void* P_e, const void* lP, void* T_e,
           void* z_e, void* f_e, void* P_trop, void* events, cudaStream_t s) {
  int G = 1;
  while (G < ng) G <<= 1;
  const Args<T> a{B, ng, nr, ne, K, n_cond, G,
                  static_cast<const T*>(tab), static_cast<const T*>(consts),
                  static_cast<const T*>(T_surf), static_cast<const T*>(T_trop),
                  static_cast<const T*>(RH), static_cast<const T*>(r_dry),
                  static_cast<const unsigned char*>(mask0), static_cast<const T*>(f_surf),
                  static_cast<const T*>(P_e), static_cast<const T*>(lP),
                  static_cast<T*>(T_e), static_cast<T*>(z_e), static_cast<T*>(f_e),
                  static_cast<T*>(P_trop), static_cast<int*>(events)};
  const int per_block = BLOCK / G;
  const size_t smem = size_t(ng) * (TEMPS + 8 * nr + 1) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        march_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  march_kernel<T><<<(B + per_block - 1) / per_block, BLOCK, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The march of B columns (ops/march_cuda.py, moist_adiabat_march_cuda);
// events is (B, 2) int32.
// Returns a CUDA error code (0 on success); -1 for arguments out of range.
extern "C" int clima_march(int is_f64, int B, int ng, int nr, int ne, int K, int n_cond,
                           const void* tab, const void* consts, const void* T_surf,
                           const void* T_trop, const void* RH, const void* r_dry,
                           const void* mask0, const void* f_surf, const void* P_e, const void* lP,
                           void* T_e, void* z_e, void* f_e, void* P_trop, void* events,
                           void* stream) {
  if (B < 1 || ng < 1 || ng > 32 || nr < 1 || ne < 2 || K < 1 || n_cond < 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  return is_f64 ? launch<double>(B, ng, nr, ne, K, n_cond, tab, consts, T_surf, T_trop, RH, r_dry,
                                 mask0, f_surf, P_e, lP, T_e, z_e, f_e, P_trop, events, s)
                : launch<float>(B, ng, nr, ne, K, n_cond, tab, consts, T_surf, T_trop, RH, r_dry,
                                mask0, f_surf, P_e, lP, T_e, z_e, f_e, P_trop, events, s);
}
