// Native sparse Gauss-Hermite (Smolyak) table generator.
//
// The reference ships this capability only as a MATLAB-Compiler binary
// (libSpGH.so wrapping nwspgr.m; reference quadrature/libSpGH/,
// quadrature/GH/SparseGH/nwspgr.m:66-134) and calls it through the MATLAB
// runtime (generateSpGHWeights.h:23-84).  This is a dependency-free C++17
// implementation of the same mathematics:
//
//   1-D probabilists' Gauss-Hermite rules by Golub-Welsch (symmetric
//   tridiagonal QL eigenvalue iteration), Smolyak combination over the
//   non-negative orthant, exact-equality dedup, mirroring, normalization.
//
// Exposed as a C ABI for ctypes (gaussianvi_tpu_torch/quadrature/native.py,
// which builds it into gaussianvi_tpu_torch/_build/ on first use);
// cross-validated against the NumPy implementation in tests.  A copy of
// the JAX package's csrc/spgh.cpp, so that the port builds from its own
// sources.
//
// Build:  g++ -O2 -shared -fPIC -std=c++17 -o libspgh.so spgh.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <vector>

namespace {

// --- 1-D rule: Golub-Welsch on the Jacobi matrix of He_n ------------------
// Jacobi matrix for probabilists' Hermite: diag 0, off-diag sqrt(i).
// Eigenvalues -> nodes; weights = first eigenvector component squared.
// Symmetric tridiagonal QL with implicit shifts (standard tql2 iteration).
bool tql2(std::vector<double>& d, std::vector<double>& e,
          std::vector<double>& z_first) {
  const int n = static_cast<int>(d.size());
  z_first.assign(n, 0.0);
  // full eigenvector matrix restricted to first row
  std::vector<double> z(static_cast<size_t>(n) * n, 0.0);
  for (int i = 0; i < n; ++i) z[i * n + i] = 1.0;
  e.push_back(0.0);

  for (int l = 0; l < n; ++l) {
    int iter = 0;
    int m;
    do {
      for (m = l; m < n - 1; ++m) {
        double dd = std::fabs(d[m]) + std::fabs(d[m + 1]);
        if (std::fabs(e[m]) <= 1e-300 + 2.3e-16 * dd) break;
      }
      if (m != l) {
        if (iter++ == 50) return false;
        double g = (d[l + 1] - d[l]) / (2.0 * e[l]);
        double r = std::hypot(g, 1.0);
        g = d[m] - d[l] + e[l] / (g + (g >= 0 ? std::fabs(r) : -std::fabs(r)));
        double s = 1.0, c = 1.0, p = 0.0;
        for (int i = m - 1; i >= l; --i) {
          double f = s * e[i];
          double b = c * e[i];
          r = std::hypot(f, g);
          e[i + 1] = r;
          if (r == 0.0) {
            d[i + 1] -= p;
            e[m] = 0.0;
            break;
          }
          s = f / r;
          c = g / r;
          g = d[i + 1] - p;
          r = (d[i] - g) * s + 2.0 * c * b;
          p = s * r;
          d[i + 1] = g + p;
          g = c * r - b;
          for (int k = 0; k < n; ++k) {
            f = z[k * n + i + 1];
            z[k * n + i + 1] = s * z[k * n + i] + c * f;
            z[k * n + i] = c * z[k * n + i] - s * f;
          }
        }
        if (r == 0.0 && m - 1 >= l) continue;
        d[l] -= p;
        e[l] = g;
        e[m] = 0.0;
      }
    } while (m != l);
  }
  for (int i = 0; i < n; ++i) z_first[i] = z[0 * n + i];
  // sort ascending by eigenvalue
  std::vector<int> idx(n);
  for (int i = 0; i < n; ++i) idx[i] = i;
  std::sort(idx.begin(), idx.end(),
            [&](int a, int b) { return d[a] < d[b]; });
  std::vector<double> d2(n), zf2(n);
  for (int i = 0; i < n; ++i) {
    d2[i] = d[idx[i]];
    zf2[i] = z_first[idx[i]];
  }
  d = d2;
  z_first = zf2;
  return true;
}

struct Rule1D {
  std::vector<double> nodes;    // ascending
  std::vector<double> weights;  // sum to 1
};

Rule1D gh_1d(int deg) {
  std::vector<double> d(deg, 0.0), e;
  e.reserve(deg);
  for (int i = 1; i < deg; ++i) e.push_back(std::sqrt(static_cast<double>(i)));
  e.resize(deg - 1);
  std::vector<double> zf;
  std::vector<double> dd = d, ee = e;
  tql2(dd, ee, zf);
  Rule1D r;
  r.nodes = dd;
  r.weights.resize(deg);
  double sum = 0.0;
  for (int i = 0; i < deg; ++i) {
    r.weights[i] = zf[i] * zf[i];
    sum += r.weights[i];
  }
  for (auto& w : r.weights) w /= sum;
  // exact symmetry: average mirrored entries, zero the center node
  for (int i = 0; i < deg / 2; ++i) {
    double n0 = 0.5 * (r.nodes[deg - 1 - i] - r.nodes[i]);
    double w0 = 0.5 * (r.weights[i] + r.weights[deg - 1 - i]);
    r.nodes[i] = -n0;
    r.nodes[deg - 1 - i] = n0;
    r.weights[i] = r.weights[deg - 1 - i] = w0;
  }
  if (deg % 2 == 1) r.nodes[deg / 2] = 0.0;
  return r;
}

Rule1D gh_1d_half(int deg) {
  Rule1D full = gh_1d(deg);
  Rule1D half;
  for (int i = deg / 2; i < deg; ++i) {
    half.nodes.push_back(full.nodes[i]);
    half.weights.push_back(full.weights[i]);
  }
  return half;
}

int64_t binom(int n, int k) {
  if (k < 0 || k > n) return 0;
  int64_t r = 1;
  for (int i = 0; i < k; ++i) r = r * (n - i) / (i + 1);
  return r;
}

// all sequences of dim positive ints summing to total
void sequences(int dim, int total, std::vector<std::vector<int>>& out) {
  std::vector<int> cur(dim, 1);
  // iterate compositions of (total - dim) over dim slots
  std::vector<int> excess(dim, 0);
  int rem = total - dim;
  // recursive lambda
  struct Rec {
    int dim;
    std::vector<std::vector<int>>& out;
    std::vector<int> cur;
    Rec(int d, std::vector<std::vector<int>>& o) : dim(d), out(o), cur(d, 1) {}
    void go(int pos, int rem) {
      if (pos == dim - 1) {
        cur[pos] = 1 + rem;
        out.push_back(cur);
        return;
      }
      for (int take = rem; take >= 0; --take) {
        cur[pos] = 1 + take;
        go(pos + 1, rem - take);
      }
    }
  } rec(dim, out);
  rec.go(0, rem);
}

struct Grid {
  std::vector<std::vector<double>> nodes;  // each row dim entries
  std::vector<double> weights;
};

void sort_dedup(Grid& g) {
  const size_t n = g.nodes.size();
  std::vector<size_t> idx(n);
  for (size_t i = 0; i < n; ++i) idx[i] = i;
  std::sort(idx.begin(), idx.end(), [&](size_t a, size_t b) {
    return g.nodes[a] < g.nodes[b];
  });
  Grid out;
  for (size_t ii = 0; ii < n; ++ii) {
    size_t i = idx[ii];
    if (!out.nodes.empty() && out.nodes.back() == g.nodes[i]) {
      out.weights.back() += g.weights[i];
    } else {
      out.nodes.push_back(g.nodes[i]);
      out.weights.push_back(g.weights[i]);
    }
  }
  g = std::move(out);
}

Grid sparse_gh(int dim, int k) {
  std::map<int, Rule1D> half;
  for (int l = 1; l <= k; ++l) half[l] = gh_1d_half(l);

  Grid g;
  const int minq = std::max(0, k - dim);
  for (int q = minq; q <= k - 1; ++q) {
    double bq = ((k - 1 - q) % 2 == 0 ? 1.0 : -1.0) *
                static_cast<double>(binom(dim - 1, dim + q - k));
    std::vector<std::vector<int>> seqs;
    sequences(dim, dim + q, seqs);
    for (const auto& levels : seqs) {
      // tensor product of half rules
      std::vector<std::vector<double>> pts{{}};
      std::vector<double> wts{1.0};
      for (int j = 0; j < dim; ++j) {
        const Rule1D& r = half[levels[j]];
        std::vector<std::vector<double>> pts2;
        std::vector<double> wts2;
        for (size_t p = 0; p < pts.size(); ++p) {
          for (size_t m = 0; m < r.nodes.size(); ++m) {
            auto row = pts[p];
            row.push_back(r.nodes[m]);
            pts2.push_back(std::move(row));
            wts2.push_back(wts[p] * r.weights[m]);
          }
        }
        pts = std::move(pts2);
        wts = std::move(wts2);
      }
      for (size_t i = 0; i < pts.size(); ++i) {
        g.nodes.push_back(std::move(pts[i]));
        g.weights.push_back(bq * wts[i]);
      }
    }
    sort_dedup(g);
  }

  // mirror to all orthants, axis by axis
  for (int j = 0; j < dim; ++j) {
    size_t nr = g.nodes.size();
    for (size_t i = 0; i < nr; ++i) {
      if (g.nodes[i][j] != 0.0) {
        auto row = g.nodes[i];
        row[j] = -row[j];
        g.nodes.push_back(std::move(row));
        g.weights.push_back(g.weights[i]);
      }
    }
  }
  sort_dedup(g);  // final sort (no duplicates remain; keeps row order canon)

  double sum = 0.0;
  for (double w : g.weights) sum += w;
  for (auto& w : g.weights) w /= sum;
  return g;
}

}  // namespace

extern "C" {

// Number of nodes of the (dim, k) sparse rule; < 0 on error.
int64_t spgh_count(int dim, int k) {
  if (dim < 1 || k < 1) return -1;
  return static_cast<int64_t>(sparse_gh(dim, k).nodes.size());
}

// Fill nodes (n x dim, row-major) and weights (n); returns n or < 0.
int64_t spgh_generate(int dim, int k, double* nodes_out, double* weights_out,
                      int64_t max_nodes) {
  if (dim < 1 || k < 1) return -1;
  Grid g = sparse_gh(dim, k);
  const int64_t n = static_cast<int64_t>(g.nodes.size());
  if (n > max_nodes) return -2;
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(nodes_out + i * dim, g.nodes[i].data(),
                sizeof(double) * dim);
    weights_out[i] = g.weights[i];
  }
  return n;
}

// 1-D full rule (deg nodes); returns deg or < 0.
int64_t spgh_gh1d(int deg, double* nodes_out, double* weights_out) {
  if (deg < 1) return -1;
  Rule1D r = gh_1d(deg);
  std::memcpy(nodes_out, r.nodes.data(), sizeof(double) * deg);
  std::memcpy(weights_out, r.weights.data(), sizeof(double) * deg);
  return deg;
}

}  // extern "C"
