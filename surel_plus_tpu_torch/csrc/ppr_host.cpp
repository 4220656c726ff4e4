// Andersen push-flow personalized PageRank with top-k truncation, on the
// host (a copy of the JAX package's native/ppr.cpp, with the OpenMP thread
// count exposed).
//
// Per-seed local push with residual threshold alpha*eps*deg (the
// reference's Numba kernel, sampler/pprgo.py:9-62, itself derived from
// TUM-DAML/pprgo), parallel over seeds with OpenMP. Each thread keeps
// dense p/r arrays of size N plus a touched-list, so resets are
// O(|touched|) and nothing is allocated per seed.
//
// A C ABI, loaded with ctypes by surel_plus_tpu_torch/ops/ppr.py, which
// builds this file with the host compiler at first use.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Returns number of (node, score) entries written for each seed in
// out_count; entries are packed at out_nodes/out_scores[seed*topk ...].
void ppr_topk(const int32_t* indptr, const int32_t* indices, int32_t n,
              const int32_t* seeds, int32_t num_seeds, float alpha,
              float eps, int32_t topk, int32_t nthreads,
              int32_t* out_nodes, float* out_scores, int32_t* out_count) {
#ifdef _OPENMP
  if (nthreads > 0) omp_set_num_threads(nthreads);
#endif
#pragma omp parallel
  {
    std::vector<float> p(n, 0.0f), r(n, 0.0f);
    std::vector<int32_t> touched;
    std::vector<int32_t> stack;
    std::vector<uint8_t> in_queue(n, 0);
    touched.reserve(4096);
    stack.reserve(4096);

#pragma omp for schedule(dynamic, 16)
    for (int32_t s = 0; s < num_seeds; ++s) {
      const int32_t seed = seeds[s];
      const float alpha_eps = alpha * eps;

      touched.clear();
      stack.clear();
      r[seed] = alpha;
      p[seed] = 0.0f;
      touched.push_back(seed);
      stack.push_back(seed);
      in_queue[seed] = 1;

      while (!stack.empty()) {
        const int32_t u = stack.back();
        stack.pop_back();
        in_queue[u] = 0;
        const float res = r[u];
        p[u] += res;
        r[u] = 0.0f;
        const int32_t beg = indptr[u], end = indptr[u + 1];
        const int32_t du = end - beg;
        if (du == 0) continue;
        const float push = (1.0f - alpha) * res / (float)du;
        for (int32_t e = beg; e < end; ++e) {
          const int32_t v = indices[e];
          if (r[v] == 0.0f && p[v] == 0.0f) touched.push_back(v);
          r[v] += push;
          const int32_t dv = indptr[v + 1] - indptr[v];
          if (r[v] >= alpha_eps * (float)dv && !in_queue[v]) {
            stack.push_back(v);
            in_queue[v] = 1;
          }
        }
      }

      // top-k by score over touched nodes with p > 0
      std::vector<std::pair<float, int32_t>> cand;
      cand.reserve(touched.size());
      for (int32_t v : touched) {
        if (p[v] > 0.0f) cand.emplace_back(p[v], v);
      }
      const int32_t k =
          std::min<int32_t>(topk, (int32_t)cand.size());
      std::partial_sort(cand.begin(), cand.begin() + k, cand.end(),
                        [](const auto& a, const auto& b) {
                          return a.first > b.first;
                        });
      out_count[s] = k;
      for (int32_t i = 0; i < k; ++i) {
        out_nodes[(int64_t)s * topk + i] = cand[i].second;
        out_scores[(int64_t)s * topk + i] = cand[i].first;
      }
      // reset scratch
      for (int32_t v : touched) {
        p[v] = 0.0f;
        r[v] = 0.0f;
        in_queue[v] = 0;
      }
    }
  }
}

// The number of threads `ppr_topk` runs on when passed nthreads <= 0.
int32_t ppr_num_threads(void) {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
