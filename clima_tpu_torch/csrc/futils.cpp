// Native host-side numerics for clima_tpu_torch's data layer.
//
// The reference implements its rebinning/regridding utilities natively
// (vendored Fortran `futils`, used by clima_radtran_types_create.f90 for
// every opacity table at load time). This is the equivalent: single-pass
// O(n+m) merge-sweep implementations of the conservative rebin and the
// piecewise-linear bin-average (inter2), exposed through a plain C ABI,
// built with g++ at first use and loaded via ctypes
// (clima_tpu_torch/ops/rebin.py).
//
// The test suite holds both against numpy versions of the same semantics.

#include <cstdint>
#include <algorithm>

extern "C" {

// Conservative rebin of piecewise-constant data.
//   old_bins: n_old+1 ascending edges;  old_vals: n_old values
//   new_bins: n_new+1 ascending edges;  new_vals: n_new outputs
// Regions outside the old grid contribute zero. Returns 0 on success.
int clima_rebin(int64_t n_old, const double* old_bins, const double* old_vals,
                int64_t n_new, const double* new_bins, double* new_vals) {
  if (n_old < 1 || n_new < 1) return 1;
  int64_t i = 0;  // old-bin cursor
  for (int64_t j = 0; j < n_new; ++j) {
    const double lo = new_bins[j];
    const double hi = new_bins[j + 1];
    if (hi <= lo) return 2;
    double total = 0.0;
    // advance to the first old bin that can overlap [lo, hi)
    while (i < n_old && old_bins[i + 1] <= lo) ++i;
    int64_t k = i;
    while (k < n_old && old_bins[k] < hi) {
      const double a = std::max(old_bins[k], lo);
      const double b = std::min(old_bins[k + 1], hi);
      if (b > a) total += (b - a) * old_vals[k];
      ++k;
    }
    new_vals[j] = total / (hi - lo);
  }
  return 0;
}

// Average of the piecewise-linear function (x, y) over each bin of edges xg.
// The source grid must cover [xg[0], xg[ng]]. Returns 0 on success.
int clima_inter2(int64_t ng, const double* xg, double* yg, int64_t n,
                 const double* x, const double* y) {
  if (ng < 1 || n < 2) return 1;
  if (x[0] > xg[0] || x[n - 1] < xg[ng]) return 3;

  int64_t i = 0;  // source-segment cursor
  for (int64_t j = 0; j < ng; ++j) {
    const double lo = xg[j];
    const double hi = xg[j + 1];
    if (hi <= lo) return 2;
    while (i + 1 < n - 1 && x[i + 1] <= lo) ++i;
    int64_t k = i;
    double area = 0.0;
    while (k < n - 1 && x[k] < hi) {
      const double xa = std::max(x[k], lo);
      const double xb = std::min(x[k + 1], hi);
      if (xb > xa) {
        const double dxk = x[k + 1] - x[k];
        const double ya =
            (dxk > 0.0) ? y[k] + (y[k + 1] - y[k]) * (xa - x[k]) / dxk : y[k];
        const double yb =
            (dxk > 0.0) ? y[k] + (y[k + 1] - y[k]) * (xb - x[k]) / dxk : y[k];
        area += 0.5 * (ya + yb) * (xb - xa);
      }
      ++k;
    }
    yg[j] = area / (hi - lo);
  }
  return 0;
}

}  // extern "C"
