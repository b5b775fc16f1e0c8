// Sparse simplicial Cholesky (LLT) for the large-steps system matrix.
//
// TPU-native equivalent of the reference's cholespy/CHOLMOD dependency
// (reference: largesteps/solvers.py:26-39 — factorize M = I + lambda*L once
// per topology epoch, then back-substitute every iteration).  M is SPD,
// sparse (mesh Laplacian + identity), and fixed per epoch, so an
// up-looking simplicial LLT with a reverse-Cuthill-McKee fill-reducing
// ordering is ample: factorization runs once on host; the per-iteration
// triangular solves are O(nnz(L)) for 3 right-hand sides.
//
// C API (ctypes-friendly):
//   void*  ls_chol_factorize(n, nnz, rows, cols, vals)  -> handle or NULL
//   int    ls_chol_solve(handle, b, x, nrhs)            -> 0 on success
//   long   ls_chol_nnz_factor(handle)
//   void   ls_chol_free(handle)
//
// b and x are (n, nrhs) row-major double arrays.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <queue>
#include <algorithm>

namespace {

struct CSC {
  int n = 0;
  std::vector<int64_t> colptr;  // n+1
  std::vector<int> rowidx;      // nnz
  std::vector<double> val;      // nnz
};

struct Factor {
  int n = 0;
  std::vector<int> perm;     // new -> old
  std::vector<int> iperm;    // old -> new
  CSC L;                     // lower-triangular factor (columns sorted)
};

// ---- reverse Cuthill-McKee ordering on the matrix graph ----------------
std::vector<int> rcm_order(int n, const std::vector<std::vector<int>>& adj) {
  std::vector<int> degree(n);
  for (int i = 0; i < n; ++i) degree[i] = (int)adj[i].size();
  std::vector<char> visited(n, 0);
  std::vector<int> order;
  order.reserve(n);
  for (;;) {
    // pick the unvisited vertex of minimum degree as the next BFS root
    int root = -1, best = INT32_MAX;
    for (int i = 0; i < n; ++i)
      if (!visited[i] && degree[i] < best) { best = degree[i]; root = i; }
    if (root < 0) break;
    std::queue<int> q;
    q.push(root);
    visited[root] = 1;
    while (!q.empty()) {
      int u = q.front(); q.pop();
      order.push_back(u);
      std::vector<int> nbrs;
      for (int v : adj[u]) if (!visited[v]) { nbrs.push_back(v); visited[v] = 1; }
      std::sort(nbrs.begin(), nbrs.end(),
                [&](int a, int b) { return degree[a] < degree[b]; });
      for (int v : nbrs) q.push(v);
    }
  }
  std::reverse(order.begin(), order.end());
  return order;  // order[k] = old index of new position k
}

Factor* factorize(int n, int64_t nnz, const int* rows, const int* cols,
                  const double* vals) {
  // adjacency for RCM (off-diagonal pattern)
  std::vector<std::vector<int>> adj(n);
  for (int64_t t = 0; t < nnz; ++t) {
    int i = rows[t], j = cols[t];
    if (i != j) adj[i].push_back(j);
  }
  for (auto& a : adj) {
    std::sort(a.begin(), a.end());
    a.erase(std::unique(a.begin(), a.end()), a.end());
  }

  auto* F = new Factor();
  F->n = n;
  F->perm = rcm_order(n, adj);
  F->iperm.assign(n, 0);
  for (int k = 0; k < n; ++k) F->iperm[F->perm[k]] = k;

  // Build permuted UPPER triangle in CSC (column k holds rows i <= k).
  std::vector<int64_t> cnt(n + 1, 0);
  {
    for (int64_t t = 0; t < nnz; ++t) {
      int i = F->iperm[rows[t]], j = F->iperm[cols[t]];
      if (i > j) std::swap(i, j);
      // keep (i, j) with i <= j: column j
      if (rows[t] == cols[t] || F->iperm[rows[t]] < F->iperm[cols[t]])
        cnt[j + 1]++;
    }
  }
  CSC A;
  A.n = n;
  A.colptr.assign(n + 1, 0);
  for (int j = 0; j < n; ++j) A.colptr[j + 1] = A.colptr[j] + cnt[j + 1];
  int64_t total = A.colptr[n];
  A.rowidx.resize(total);
  A.val.resize(total);
  std::vector<int64_t> fill(A.colptr.begin(), A.colptr.end() - 1);
  for (int64_t t = 0; t < nnz; ++t) {
    int pi = F->iperm[rows[t]], pj = F->iperm[cols[t]];
    if (pi > pj) continue;  // use only one of the symmetric pair
    if (pi == pj && rows[t] != cols[t]) continue;
    int64_t pos = fill[pj]++;
    A.rowidx[pos] = pi;
    A.val[pos] = vals[t];
  }
  // sort each column by row index (merge duplicates)
  CSC A2;
  A2.n = n;
  A2.colptr.assign(n + 1, 0);
  std::vector<std::pair<int, double>> tmp;
  std::vector<int> r2;
  std::vector<double> v2;
  for (int j = 0; j < n; ++j) {
    tmp.clear();
    for (int64_t p = A.colptr[j]; p < A.colptr[j + 1]; ++p)
      tmp.push_back({A.rowidx[p], A.val[p]});
    std::sort(tmp.begin(), tmp.end());
    for (size_t k = 0; k < tmp.size(); ++k) {
      if (!r2.empty() && (int64_t)r2.size() > A2.colptr[j] &&
          r2.back() == tmp[k].first)
        v2.back() += tmp[k].second;
      else {
        r2.push_back(tmp[k].first);
        v2.push_back(tmp[k].second);
      }
    }
    A2.colptr[j + 1] = (int64_t)r2.size();
  }
  A2.rowidx = std::move(r2);
  A2.val = std::move(v2);

  // elimination tree from the upper-per-column layout:
  // parent[] via walking rows of each column (classic Liu algorithm).
  std::vector<int> parent(n, -1), ancestor(n, -1);
  for (int j = 0; j < n; ++j) {
    for (int64_t p = A2.colptr[j]; p < A2.colptr[j + 1]; ++p) {
      int i = A2.rowidx[p];
      while (i != -1 && i < j) {
        int next = ancestor[i];
        ancestor[i] = j;
        if (next == -1) { parent[i] = j; i = -1; }
        else i = next;
      }
    }
  }

  // Up-looking numeric factorization, building L row by row.
  // L stored by columns; we append entries L(k, :) as we finish row k,
  // so use per-column dynamic arrays first.
  std::vector<std::vector<int>> Lrow(n);
  std::vector<std::vector<double>> Lval(n);
  std::vector<double> diag(n, 0.0);
  std::vector<double> x(n, 0.0);
  std::vector<int> mark(n, -1);  // mark[q] == k ⇔ q visited for row k
  std::vector<int> stack(n);
  std::vector<int> path;
  path.reserve(64);

  for (int k = 0; k < n; ++k) {
    // scatter row k of upper(A): entries A(i, k), i <= k
    double akk = 0.0;
    int top = n;
    mark[k] = k;
    for (int64_t p = A2.colptr[k]; p < A2.colptr[k + 1]; ++p) {
      int i = A2.rowidx[p];
      if (i == k) { akk = A2.val[p]; continue; }
      x[i] = A2.val[p];
      // ereach walk up the etree until an already-visited node
      path.clear();
      int q = i;
      while (mark[q] != k) { path.push_back(q); mark[q] = k; q = parent[q]; }
      for (int t = (int)path.size() - 1; t >= 0; --t) stack[--top] = path[t];
    }
    // triangular solve along the pattern (topological order)
    double dk = akk;
    for (int s = top; s < n; ++s) {
      int j = stack[s];
      double xj = x[j] / diag[j];
      x[j] = 0.0;
      // x -= L(:, j) * xj for rows in pattern below j
      const auto& rj = Lrow[j];
      const auto& vj = Lval[j];
      for (size_t t = 0; t < rj.size(); ++t) {
        int r = rj[t];
        if (r == k) continue;  // handled via dk below
        x[r] -= vj[t] * xj;
      }
      // subtract contribution to diagonal
      dk -= xj * xj;
      // append L(k, j) = xj to column j
      Lrow[j].push_back(k);
      Lval[j].push_back(xj);
    }
    if (dk <= 0.0) { delete F; return nullptr; }  // not SPD
    diag[k] = std::sqrt(dk);
  }

  // pack columns: L(k, k) = diag[k] first, then strictly-lower entries
  int64_t nnzL = n;
  for (int j = 0; j < n; ++j) nnzL += (int64_t)Lrow[j].size();
  F->L.n = n;
  F->L.colptr.assign(n + 1, 0);
  F->L.rowidx.resize(nnzL);
  F->L.val.resize(nnzL);
  int64_t pos = 0;
  for (int j = 0; j < n; ++j) {
    F->L.colptr[j] = pos;
    F->L.rowidx[pos] = j;
    F->L.val[pos] = diag[j];
    ++pos;
    // entries were appended with increasing k, already sorted
    for (size_t t = 0; t < Lrow[j].size(); ++t) {
      F->L.rowidx[pos] = Lrow[j][t];
      F->L.val[pos] = Lval[j][t];
      ++pos;
    }
  }
  F->L.colptr[n] = pos;
  return F;
}

}  // namespace

extern "C" {

void* ls_chol_factorize(int n, int64_t nnz, const int* rows, const int* cols,
                        const double* vals) {
  if (n <= 0 || nnz <= 0) return nullptr;
  return factorize(n, nnz, rows, cols, vals);
}

int64_t ls_chol_nnz_factor(void* handle) {
  if (!handle) return -1;
  auto* F = static_cast<Factor*>(handle);
  return F->L.colptr[F->n];
}

int ls_chol_solve(void* handle, const double* b, double* x, int nrhs) {
  if (!handle) return 1;
  auto* F = static_cast<Factor*>(handle);
  int n = F->n;
  std::vector<double> y(n);
  for (int r = 0; r < nrhs; ++r) {
    // permute rhs: y = P b
    for (int k = 0; k < n; ++k) y[k] = b[(int64_t)F->perm[k] * nrhs + r];
    // forward solve L z = y (in place)
    for (int j = 0; j < n; ++j) {
      int64_t p0 = F->L.colptr[j], p1 = F->L.colptr[j + 1];
      double zj = y[j] / F->L.val[p0];
      y[j] = zj;
      for (int64_t p = p0 + 1; p < p1; ++p) y[F->L.rowidx[p]] -= F->L.val[p] * zj;
    }
    // backward solve L^T w = z (in place)
    for (int j = n - 1; j >= 0; --j) {
      int64_t p0 = F->L.colptr[j], p1 = F->L.colptr[j + 1];
      double s = y[j];
      for (int64_t p = p0 + 1; p < p1; ++p) s -= F->L.val[p] * y[F->L.rowidx[p]];
      y[j] = s / F->L.val[p0];
    }
    // un-permute: x = P^T w
    for (int k = 0; k < n; ++k) x[(int64_t)F->perm[k] * nrhs + r] = y[k];
  }
  return 0;
}

void ls_chol_free(void* handle) {
  delete static_cast<Factor*>(handle);
}

}  // extern "C"
