// Cost functors for the quadrature kernel.
//
// The JAX package traces a Python callable (``lanes_cost``) into its Pallas
// kernel; CUDA cannot take one.  Each nonlinear cost the kernels support is
// instead a functor here, passed to the kernel as a template parameter.  A
// factor batch names its functor with ``kernel_cost`` (Python side:
// gaussianvi_tpu_torch/kernels/quad.py, KERNEL_COSTS) and carries its
// params packed per factor, leaves in sorted-key order, as ``[.., K, P]``,
// and, for a cost that reads one, a field shared by all its factors (one
// device tensor, read in place).
//
// Contract: ``kParams`` is P; ``kField`` says whether the cost reads a
// field; ``eval(x, p, field)`` returns phi at the point x of the factor's
// local dimension D given the factor's P params and the batch's field (a
// cost that reads none ignores it).
#pragma once

#include "smallmat.cuh"

namespace gvi {

enum CostId : int {
  kRangeCost = 0,
  kPlanarSdfCost = 1,
  kSdf3dCost = 2,
  kPlanarPatchCost = 3,
  kSdf3dPatchCost = 4,
};

// A batch's field: nz x rows x cols values, row-major (data[z, row, col]),
// in device memory, shared by every factor and problem of the batch and
// read through the read-only path; nz is 1 for a planar field, data null
// for a cost that reads no field.
template <typename T>
struct Field {
  const T* data;
  int rows, cols, nz;
};

// A launch of Cost may go ahead with this field: present where the cost
// reads one, with the depth its dimension allows (one plane for a planar
// cost, kFieldDims == 2).
template <typename Cost, typename T>
inline bool field_ok(const Field<T>& f) {
  if (!Cost::kField) return true;
  return f.data != nullptr && f.rows >= 1 && f.cols >= 1 &&
         (Cost::kFieldDims == 3 ? f.nz >= 1 : f.nz == 1);
}

template <typename T>
__device__ __forceinline__ T clip(T v, T lo, T hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// Range measurement (gaussianvi_tpu/examples/chain_estimation.py,
// range_cost_lanes): phi = (r - |pos - beacon|)^2 / (2 sig_r^2) with pos the
// leading DX entries of x.  Params: beacon[DX], r, sig_r_sq.
template <int DX>
struct RangeCost {
  static constexpr int kParams = DX + 2;
  static constexpr bool kField = false;
  static constexpr int kFieldDims = 0;

  template <typename T, int D>
  __device__ __forceinline__ static T eval(const T (&x)[D],
                                           const T (&p)[kParams],
                                           const Field<T>&) {
    static_assert(DX <= D, "range cost reads the leading DX coordinates");
    T d2 = T(0);
#pragma unroll
    for (int j = 0; j < DX; ++j) {
      const T t = x[j] - p[j];
      d2 = d2 + t * t;
    }
    const T dist = dsqrt(d2 + T(1e-12));
    const T res = p[DX] - dist;
    return res * res / (T(2) * p[DX + 1]);
  }
};

// Planar point robot against a 2-D signed-distance field
// (gaussianvi_tpu/factors/robots.py make_planar_obstacle_factor with
// planar_point_balls: one ball at (x[0], x[1])): the clamped bilinear
// lookup of PlanarSDF.signed_distance (gaussianvi_tpu/factors/sdf.py),
// then the hinge of hinge_obstacle_cost,
//   phi = sigma * (slope * max(0, eps + radius - sd))^2.
// The field is data[row, col], row <-> y and col <-> x, origin (x0, y0),
// square cells.  Params (the geometry rides in them, the descriptor is the
// bare array): eps, radius, sigma, slope, x0, y0, cell.
//
// The arithmetic is the plain version's, step for step: the clip to the
// field's extent, the division by the cell (not a reciprocal multiply),
// floor, the corner indices clamped to the last row and column, the
// four-corner blend in the same order.  The selects are written so that a
// NaN coordinate (a failed Cholesky upstream) stays NaN through the clip
// and the hinge, as torch.clamp / torch.maximum keep it: its corner index
// converts to 0 and its weights are NaN.
//
// What it costs: two divisions, two floors and four gathers a point.  The
// gathers are data-dependent but stay on chip (the planner's 100 x 100
// f32 field is 40 KB, read through the read-only path, and every factor
// reads the same field): on an H100, K3 phi on the planner's trial batch
// (225,280 factors, 13 nodes) takes 0.024 ms, 4.3x its byte bound
// (PERF.md, section 6).
struct PlanarSdfCost {
  static constexpr int kParams = 7;
  static constexpr bool kField = true;
  static constexpr int kFieldDims = 2;

  template <typename T, int D>
  __device__ __forceinline__ static T eval(const T (&x)[D],
                                           const T (&p)[kParams],
                                           const Field<T>& f) {
    static_assert(D >= 2, "the planar SDF cost reads (x[0], x[1])");
    const T x0 = p[4], y0 = p[5], cell = p[6];
    const T px = clip(x[0], x0, x0 + T(f.cols - 1) * cell);
    const T py = clip(x[1], y0, y0 + T(f.rows - 1) * cell);
    const T c = (px - x0) / cell;
    const T r = (py - y0) / cell;
    const T lr = dfloor(r), lc = dfloor(c);
    const int lri = min(max(static_cast<int>(lr), 0), f.rows - 1);
    const int lci = min(max(static_cast<int>(lc), 0), f.cols - 1);
    const int hri = min(lri + 1, f.rows - 1);
    const int hci = min(lci + 1, f.cols - 1);
    const T wr = r - lr, wc = c - lc;
    const T* lo_row = f.data + (int64_t)lri * f.cols;
    const T* hi_row = f.data + (int64_t)hri * f.cols;
    const T sd = (T(1) - wr) * (T(1) - wc) * __ldg(lo_row + lci) +
                 wr * (T(1) - wc) * __ldg(hi_row + lci) +
                 (T(1) - wr) * wc * __ldg(lo_row + hci) +
                 wr * wc * __ldg(hi_row + hci);
    const T e = p[0] + p[1] - sd;
    const T err = (e < T(0) ? T(0) : e) * p[3];
    return err * err * p[2];
  }
};

// 3-D point robot against a 3-D signed-distance field
// (gaussianvi_tpu/factors/robots.py make_point3d_obstacle_factor: one ball
// at (x[0], x[1], x[2])): the clamped trilinear lookup of
// SDF3D.signed_distance (gaussianvi_tpu/factors/sdf.py), then the hinge of
// hinge_obstacle_cost, as PlanarSdfCost does in the plane.  The field is
// data[z, row, col], row <-> y, col <-> x, origin (x0, y0, z0), cubic
// cells.  Params: eps, radius, sigma, slope, x0, y0, z0, cell.
//
// The plain version's arithmetic step for step: the clip to the extent,
// the division by the cell, floor, the corner indices clamped, the blend
// along rows, then columns, then z; a NaN coordinate stays NaN.
//
// What it costs: three divisions, three floors and eight gathers a point.
// The point planner's 50^3 field is 500 KB in float32 (1 MB in float64):
// it stays in L2, not in one SM's L1, so a gather is an L2 hit; the
// factors of one warp sit near one another on the trajectory and share
// cache lines.  On an H100, K3 phi on the planner's trial batch (225,280
// factors, 25 nodes) takes 0.076 ms, 6.4x its byte bound (PERF.md,
// section 6).
struct Sdf3dCost {
  static constexpr int kParams = 8;
  static constexpr bool kField = true;
  static constexpr int kFieldDims = 3;

  template <typename T, int D>
  __device__ __forceinline__ static T eval(const T (&x)[D],
                                           const T (&p)[kParams],
                                           const Field<T>& f) {
    static_assert(D >= 3, "the 3-D SDF cost reads (x[0], x[1], x[2])");
    const T x0 = p[4], y0 = p[5], z0 = p[6], cell = p[7];
    const T px = clip(x[0], x0, x0 + T(f.cols - 1) * cell);
    const T py = clip(x[1], y0, y0 + T(f.rows - 1) * cell);
    const T pz = clip(x[2], z0, z0 + T(f.nz - 1) * cell);
    const T c = (px - x0) / cell;
    const T r = (py - y0) / cell;
    const T zz = (pz - z0) / cell;
    const T lr = dfloor(r), lc = dfloor(c), lz = dfloor(zz);
    const int lri = min(max(static_cast<int>(lr), 0), f.rows - 1);
    const int lci = min(max(static_cast<int>(lc), 0), f.cols - 1);
    const int lzi = min(max(static_cast<int>(lz), 0), f.nz - 1);
    const int hri = min(lri + 1, f.rows - 1);
    const int hci = min(lci + 1, f.cols - 1);
    const int hzi = min(lzi + 1, f.nz - 1);
    const T wr = r - lr, wc = c - lc, wz = zz - lz;
    const int64_t plane = (int64_t)f.rows * f.cols;
    const T* lo = f.data + lzi * plane;
    const T* hi = f.data + hzi * plane;
    const int64_t l_l = (int64_t)lri * f.cols + lci;
    const int64_t h_l = (int64_t)hri * f.cols + lci;
    const int64_t l_h = (int64_t)lri * f.cols + hci;
    const int64_t h_h = (int64_t)hri * f.cols + hci;
    const T c00 = (T(1) - wr) * __ldg(lo + l_l) + wr * __ldg(lo + h_l);
    const T c01 = (T(1) - wr) * __ldg(hi + l_l) + wr * __ldg(hi + h_l);
    const T c10 = (T(1) - wr) * __ldg(lo + l_h) + wr * __ldg(lo + h_h);
    const T c11 = (T(1) - wr) * __ldg(hi + l_h) + wr * __ldg(hi + h_h);
    const T c0 = (T(1) - wc) * c00 + wc * c10;
    const T c1 = (T(1) - wc) * c01 + wc * c11;
    const T sd = (T(1) - wz) * c0 + wz * c1;
    const T e = p[0] + p[1] - sd;
    const T err = (e < T(0) ? T(0) : e) * p[3];
    return err * err * p[2];
  }
};

// The patch mode's lookup along one axis of a window of P cells that
// starts at cell o (gaussianvi_tpu/factors/robots.py make_patch_cost_2d /
// _3d): the coordinate relative to the window, q = (v - v0) / cell - o,
// clipped to [0, P - 1], so a point outside the window takes the value at
// its edge.  The TPU kernel sums P hat functions max(0, 1 - |q - j|) over
// a pre-gathered copy of the window; at most two of them are nonzero, at
// j = floor(q) and floor(q) + 1, and this keeps those two, with their
// weights taken as the hat sum takes them (1 - (q - j) and
// 1 - ((j + 1) - q)), and reads the field in place.  The high corner is
// clamped to the window (at q = P - 1 its weight is exactly 0), and both
// corners to the field, so that no params can make a read leave it.  A
// NaN coordinate converts to corner 0 with NaN weights and stays NaN.
template <typename T>
struct WindowAxis {
  int lo, hi;  // field indices of the two corners
  T w0, w1;    // their weights

  __device__ __forceinline__ WindowAxis(T v, T v0, T cell, T o, T patch,
                                        int extent) {
    const T q = clip((v - v0) / cell - o, T(0), patch - T(1));
    const T l = dfloor(q);
    const int last = static_cast<int>(patch) - 1;
    const int li = min(max(static_cast<int>(l), 0), last);
    const int hi_w = min(li + 1, last);
    const int base = static_cast<int>(o);
    lo = min(max(base + li, 0), extent - 1);
    hi = min(max(base + hi_w, 0), extent - 1);
    w0 = T(1) - (q - l);
    w1 = T(1) - ((l + T(1)) - q);
  }
};

// Planar point robot, patch mode (make_planar_obstacle_factor with
// patch_size, gaussianvi_tpu/factors/robots.py make_patch_cost_2d): the
// bilinear lookup of PlanarSdfCost with the clip bounds set to the
// factor's window of P x P cells, then the hinge.  The window's origin
// follows the factor's marginal mean; the batch's kernel_prep
// (factors/robots.py) forms it per call, so it rides in the params.
// Params: eps, radius, sigma, slope, x0, y0, cell, P, then the window's
// first column and row (cell units).  The blend is the hat sum's order:
// along the row (columns) first, then across the two rows.
//
// What it costs: PlanarSdfCost's two divisions, two floors and four
// gathers a point, from a window that P x P cells bound.
struct PlanarPatchCost {
  static constexpr int kParams = 10;
  static constexpr bool kField = true;
  static constexpr int kFieldDims = 2;

  template <typename T, int D>
  __device__ __forceinline__ static T eval(const T (&x)[D],
                                           const T (&p)[kParams],
                                           const Field<T>& f) {
    static_assert(D >= 2, "the planar SDF cost reads (x[0], x[1])");
    const WindowAxis<T> c(x[0], p[4], p[6], p[8], p[7], f.cols);
    const WindowAxis<T> r(x[1], p[5], p[6], p[9], p[7], f.rows);
    const T* row0 = f.data + (int64_t)r.lo * f.cols;
    const T* row1 = f.data + (int64_t)r.hi * f.cols;
    const T sd = r.w0 * (c.w0 * __ldg(row0 + c.lo) + c.w1 * __ldg(row0 + c.hi)) +
                 r.w1 * (c.w0 * __ldg(row1 + c.lo) + c.w1 * __ldg(row1 + c.hi));
    const T e = p[0] + p[1] - sd;
    const T err = (e < T(0) ? T(0) : e) * p[3];
    return err * err * p[2];
  }
};

// 3-D point robot, patch mode (make_point3d_obstacle_factor with
// patch_size, make_patch_cost_3d): the trilinear lookup of Sdf3dCost with
// the clip bounds set to the factor's window of P^3 voxels, then the
// hinge.  Params: eps, radius, sigma, slope, x0, y0, z0, cell, P, then the
// window's first column, row and plane.  The blend is the hat sum's
// order: along the row (columns), across rows, across planes.
//
// What it costs: Sdf3dCost's three divisions, three floors and eight
// gathers a point.
struct Sdf3dPatchCost {
  static constexpr int kParams = 12;
  static constexpr bool kField = true;
  static constexpr int kFieldDims = 3;

  template <typename T, int D>
  __device__ __forceinline__ static T eval(const T (&x)[D],
                                           const T (&p)[kParams],
                                           const Field<T>& f) {
    static_assert(D >= 3, "the 3-D SDF cost reads (x[0], x[1], x[2])");
    const WindowAxis<T> c(x[0], p[4], p[7], p[9], p[8], f.cols);
    const WindowAxis<T> r(x[1], p[5], p[7], p[10], p[8], f.rows);
    const WindowAxis<T> z(x[2], p[6], p[7], p[11], p[8], f.nz);
    const int64_t plane = (int64_t)f.rows * f.cols;
    T planes[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const T* zp = f.data + (k == 0 ? z.lo : z.hi) * plane;
      const T* row0 = zp + (int64_t)r.lo * f.cols;
      const T* row1 = zp + (int64_t)r.hi * f.cols;
      planes[k] =
          r.w0 * (c.w0 * __ldg(row0 + c.lo) + c.w1 * __ldg(row0 + c.hi)) +
          r.w1 * (c.w0 * __ldg(row1 + c.lo) + c.w1 * __ldg(row1 + c.hi));
    }
    const T sd = z.w0 * planes[0] + z.w1 * planes[1];
    const T e = p[0] + p[1] - sd;
    const T err = (e < T(0) ? T(0) : e) * p[3];
    return err * err * p[2];
  }
};

}  // namespace gvi
