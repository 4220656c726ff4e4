// Native graph-ingest kernels: parallel CSR construction and per-row
// neighbor shuffling.
//
// The Python path (numpy lexsort) is fine to ~100M edges; billion-edge
// ingest (twitter-follower scale, reference README.md:28-32) wants an
// O(E) counting-sort build and an O(E) per-row Fisher-Yates shuffle.
// C++17 + OpenMP, exposed via a C ABI for ctypes (no pybind11 in this
// environment).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Build CSR from an edge list. If symmetrize != 0 both directions are
// inserted. Self loops dropped. Duplicate edges are KEPT (callers coalesce
// if needed; landing-count walks are invariant to parallel edges only in
// proportion, matching weighted graphs).
// indptr_out: int64[n+1]; indices_out: int32[capacity] where capacity =
// num_edges * (symmetrize ? 2 : 1). Returns number of entries written.
int64_t build_csr(const int32_t* src, const int32_t* dst,
                  int64_t num_edges, int32_t num_nodes, int32_t symmetrize,
                  int32_t drop_self_loops, int64_t* indptr_out,
                  int32_t* indices_out) {
  std::vector<std::atomic<int64_t>> counts(num_nodes);
  for (auto& c : counts) c.store(0, std::memory_order_relaxed);

#pragma omp parallel for schedule(static)
  for (int64_t e = 0; e < num_edges; ++e) {
    const int32_t u = src[e], v = dst[e];
    if (drop_self_loops && u == v) continue;
    counts[u].fetch_add(1, std::memory_order_relaxed);
    if (symmetrize) counts[v].fetch_add(1, std::memory_order_relaxed);
  }

  indptr_out[0] = 0;
  for (int32_t i = 0; i < num_nodes; ++i)
    indptr_out[i + 1] = indptr_out[i] + counts[i].load();

  std::vector<std::atomic<int64_t>> cursor(num_nodes);
  for (int32_t i = 0; i < num_nodes; ++i)
    cursor[i].store(indptr_out[i], std::memory_order_relaxed);

#pragma omp parallel for schedule(static)
  for (int64_t e = 0; e < num_edges; ++e) {
    const int32_t u = src[e], v = dst[e];
    if (drop_self_loops && u == v) continue;
    indices_out[cursor[u].fetch_add(1, std::memory_order_relaxed)] = v;
    if (symmetrize)
      indices_out[cursor[v].fetch_add(1, std::memory_order_relaxed)] = u;
  }

  // sort neighbors within each row (downstream joins need ascending rows)
#pragma omp parallel for schedule(dynamic, 1024)
  for (int32_t i = 0; i < num_nodes; ++i)
    std::sort(indices_out + indptr_out[i], indices_out + indptr_out[i + 1]);

  return indptr_out[num_nodes];
}

// Per-row uniform shuffle of CSR indices (the step-0 without-replacement
// source, replacing np.lexsort at scale). Deterministic per (seed, row).
void shuffle_rows(const int64_t* indptr, const int32_t* indices,
                  int32_t num_nodes, uint64_t seed, int32_t* out) {
#pragma omp parallel for schedule(dynamic, 1024)
  for (int32_t i = 0; i < num_nodes; ++i) {
    const int64_t beg = indptr[i], end = indptr[i + 1];
    const int64_t d = end - beg;
    std::memcpy(out + beg, indices + beg, d * sizeof(int32_t));
    if (d <= 1) continue;
    std::mt19937_64 rng(seed * 0x9E3779B97F4A7C15ULL + (uint64_t)i);
    for (int64_t k = d - 1; k > 0; --k) {
      const int64_t j = (int64_t)(rng() % (uint64_t)(k + 1));
      std::swap(out[beg + k], out[beg + j]);
    }
  }
}

// Weighted CSR build with optional duplicate coalescing (sum of weights),
// matching the numpy path in graph/csr.py:csr_from_edges and the implicit
// duplicate-summing of the reference's scipy csr_matrix construction
// (dataloader.py:120-138). w may be null (unit weights). Returns entries
// written; indices/weights are row-sorted ascending.
int64_t build_csr_w(const int32_t* src, const int32_t* dst, const float* w,
                    int64_t num_edges, int32_t num_nodes, int32_t symmetrize,
                    int32_t drop_self_loops, int32_t coalesce,
                    int64_t* indptr_out, int32_t* indices_out,
                    float* weights_out) {
  std::vector<std::atomic<int64_t>> counts(num_nodes);
  for (auto& c : counts) c.store(0, std::memory_order_relaxed);

#pragma omp parallel for schedule(static)
  for (int64_t e = 0; e < num_edges; ++e) {
    const int32_t u = src[e], v = dst[e];
    if (drop_self_loops && u == v) continue;
    counts[u].fetch_add(1, std::memory_order_relaxed);
    if (symmetrize) counts[v].fetch_add(1, std::memory_order_relaxed);
  }

  std::vector<int64_t> raw_ptr(num_nodes + 1);
  raw_ptr[0] = 0;
  for (int32_t i = 0; i < num_nodes; ++i)
    raw_ptr[i + 1] = raw_ptr[i] + counts[i].load();
  const int64_t total_raw = raw_ptr[num_nodes];

  std::vector<std::atomic<int64_t>> cursor(num_nodes);
  for (int32_t i = 0; i < num_nodes; ++i)
    cursor[i].store(raw_ptr[i], std::memory_order_relaxed);

  std::vector<int32_t> tmp_idx(total_raw);
  std::vector<float> tmp_w(total_raw);
#pragma omp parallel for schedule(static)
  for (int64_t e = 0; e < num_edges; ++e) {
    const int32_t u = src[e], v = dst[e];
    if (drop_self_loops && u == v) continue;
    const float we = w ? w[e] : 1.0f;
    int64_t p = cursor[u].fetch_add(1, std::memory_order_relaxed);
    tmp_idx[p] = v;
    tmp_w[p] = we;
    if (symmetrize) {
      p = cursor[v].fetch_add(1, std::memory_order_relaxed);
      tmp_idx[p] = u;
      tmp_w[p] = we;
    }
  }

  // per-row: sort (col, weight) pairs by col, then optionally fold
  // duplicate columns by summing weights in place (row-local compaction)
  std::vector<int64_t> new_len(num_nodes);
#pragma omp parallel
  {
    std::vector<std::pair<int32_t, float>> row;
#pragma omp for schedule(dynamic, 1024)
    for (int32_t i = 0; i < num_nodes; ++i) {
      const int64_t beg = raw_ptr[i], end = raw_ptr[i + 1];
      row.clear();
      for (int64_t p = beg; p < end; ++p) row.emplace_back(tmp_idx[p], tmp_w[p]);
      std::sort(row.begin(), row.end(),
                [](const auto& a, const auto& b) { return a.first < b.first; });
      int64_t out = beg;
      for (size_t k = 0; k < row.size(); ++k) {
        if (coalesce && out > beg && tmp_idx[out - 1] == row[k].first) {
          tmp_w[out - 1] += row[k].second;
        } else {
          tmp_idx[out] = row[k].first;
          tmp_w[out] = row[k].second;
          ++out;
        }
      }
      new_len[i] = out - beg;
    }
  }

  indptr_out[0] = 0;
  for (int32_t i = 0; i < num_nodes; ++i)
    indptr_out[i + 1] = indptr_out[i] + new_len[i];

#pragma omp parallel for schedule(dynamic, 1024)
  for (int32_t i = 0; i < num_nodes; ++i) {
    std::memcpy(indices_out + indptr_out[i], tmp_idx.data() + raw_ptr[i],
                new_len[i] * sizeof(int32_t));
    std::memcpy(weights_out + indptr_out[i], tmp_w.data() + raw_ptr[i],
                new_len[i] * sizeof(float));
  }
  return indptr_out[num_nodes];
}

}  // extern "C"
