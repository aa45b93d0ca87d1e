// Native Leiden community detection (Traag, Waltman & van Eck 2019).
//
// C++ replacement for the reference stack's leidenalg/igraph dependency
// (reference: tl/__init__.py:24-30 via scanpy).  Quality function is
// RBConfiguration (modularity with a resolution parameter) on an undirected
// weighted graph in CSR form.  Exposed through a plain C ABI and loaded from
// Python via ctypes (no pybind11 dependency).
//
// The same source as infercnvpy_tpu/native/leiden.cpp, built with the same
// flags (native/__init__.py::LEIDEN_FLAGS), so both packages give the same
// labels for the same graph and seed.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC leiden.cpp -o libleiden.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <random>
#include <unordered_map>
#include <vector>

namespace {

struct Graph {
  std::vector<int64_t> indptr;
  std::vector<int32_t> indices;
  std::vector<double> weights;
  std::vector<double> strength;  // weighted degree incl. self-loops
  double total_weight = 0.0;     // sum of edge weights (each edge once)
  int64_t n = 0;
};

Graph make_graph(const int64_t* indptr, const int32_t* indices,
                 const double* weights, int64_t n) {
  Graph g;
  g.n = n;
  g.indptr.assign(indptr, indptr + n + 1);
  int64_t nnz = indptr[n];
  g.indices.assign(indices, indices + nnz);
  g.weights.assign(weights, weights + nnz);
  g.strength.assign(n, 0.0);
  double tot = 0.0;
  for (int64_t v = 0; v < n; ++v) {
    for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e) {
      g.strength[v] += weights[e];
      tot += weights[e];
    }
  }
  g.total_weight = tot / 2.0;
  return g;
}

// Queue-based fast local moving (Leiden phase 1).
bool local_move(const Graph& g, std::vector<int64_t>& comm, double resolution,
                std::mt19937_64& rng) {
  const double two_m = 2.0 * g.total_weight;
  if (two_m <= 0) return false;

  int64_t max_label = 0;
  for (int64_t v = 0; v < g.n; ++v) max_label = std::max(max_label, comm[v]);
  std::vector<double> comm_strength(max_label + 1 + g.n, 0.0);
  for (int64_t v = 0; v < g.n; ++v) comm_strength[comm[v]] += g.strength[v];

  std::vector<int64_t> order(g.n);
  for (int64_t i = 0; i < g.n; ++i) order[i] = i;
  std::shuffle(order.begin(), order.end(), rng);

  std::vector<uint8_t> in_queue(g.n, 1);
  std::queue<int64_t> queue;
  for (int64_t v : order) queue.push(v);

  std::unordered_map<int64_t, double> edge_to;
  bool improved = false;

  while (!queue.empty()) {
    int64_t v = queue.front();
    queue.pop();
    in_queue[v] = 0;
    int64_t c_old = comm[v];
    double k_v = g.strength[v];

    edge_to.clear();
    for (int64_t e = g.indptr[v]; e < g.indptr[v + 1]; ++e) {
      int64_t u = g.indices[e];
      if (u == v) continue;
      edge_to[comm[u]] += g.weights[e];
    }

    comm_strength[c_old] -= k_v;
    int64_t best_c = c_old;
    auto it_old = edge_to.find(c_old);
    double base = (it_old == edge_to.end() ? 0.0 : it_old->second) -
                  resolution * k_v * comm_strength[c_old] / two_m;
    double best_gain = base;
    for (const auto& kv : edge_to) {
      if (kv.first == c_old) continue;
      double gain =
          kv.second - resolution * k_v * comm_strength[kv.first] / two_m;
      if (gain > best_gain + 1e-12) {
        best_gain = gain;
        best_c = kv.first;
      }
    }
    comm_strength[best_c] += k_v;

    if (best_c != c_old) {
      comm[v] = best_c;
      improved = true;
      for (int64_t e = g.indptr[v]; e < g.indptr[v + 1]; ++e) {
        int64_t u = g.indices[e];
        if (u != v && comm[u] != best_c && !in_queue[u]) {
          in_queue[u] = 1;
          queue.push(u);
        }
      }
    }
  }
  return improved;
}

// Refinement: merge singletons within each phase-1 community (phase 2).
std::vector<int64_t> refine(const Graph& g, const std::vector<int64_t>& comm,
                            double resolution, std::mt19937_64& rng) {
  const double two_m = 2.0 * g.total_weight;
  std::vector<int64_t> refined(g.n);
  for (int64_t i = 0; i < g.n; ++i) refined[i] = i;
  std::vector<double> ref_strength(g.strength);
  std::vector<int64_t> ref_size(g.n, 1);

  std::vector<int64_t> order(g.n);
  for (int64_t i = 0; i < g.n; ++i) order[i] = i;
  std::shuffle(order.begin(), order.end(), rng);

  std::unordered_map<int64_t, double> edge_to;
  for (int64_t v : order) {
    if (ref_size[refined[v]] > 1 || ref_size[v] > 1) continue;
    int64_t c_v = comm[v];
    edge_to.clear();
    for (int64_t e = g.indptr[v]; e < g.indptr[v + 1]; ++e) {
      int64_t u = g.indices[e];
      if (u == v || comm[u] != c_v) continue;
      edge_to[refined[u]] += g.weights[e];
    }
    if (edge_to.empty()) continue;
    double k_v = g.strength[v];
    int64_t best_r = refined[v];
    double best_gain = 0.0;
    for (const auto& kv : edge_to) {
      if (kv.first == refined[v]) continue;
      double gain =
          kv.second - resolution * k_v * ref_strength[kv.first] / two_m;
      if (gain > best_gain + 1e-12) {
        best_gain = gain;
        best_r = kv.first;
      }
    }
    if (best_r != refined[v]) {
      ref_strength[best_r] += k_v;
      ref_size[best_r] += ref_size[v];
      ref_size[refined[v]] -= 1;
      refined[v] = best_r;
    }
  }
  return refined;
}

// Aggregate the graph on the refined partition.
Graph aggregate(const Graph& g, const std::vector<int64_t>& refined,
                std::vector<int64_t>& inverse /*out: node -> agg node*/) {
  std::unordered_map<int64_t, int64_t> compact;
  inverse.assign(g.n, 0);
  int64_t k = 0;
  for (int64_t v = 0; v < g.n; ++v) {
    auto it = compact.find(refined[v]);
    if (it == compact.end()) {
      compact.emplace(refined[v], k);
      inverse[v] = k;
      ++k;
    } else {
      inverse[v] = it->second;
    }
  }

  std::vector<std::unordered_map<int64_t, double>> adj(k);
  for (int64_t v = 0; v < g.n; ++v) {
    int64_t cv = inverse[v];
    for (int64_t e = g.indptr[v]; e < g.indptr[v + 1]; ++e) {
      adj[cv][inverse[g.indices[e]]] += g.weights[e];
    }
  }
  Graph out;
  out.n = k;
  out.indptr.assign(k + 1, 0);
  for (int64_t c = 0; c < k; ++c) out.indptr[c + 1] = out.indptr[c] + (int64_t)adj[c].size();
  out.indices.resize(out.indptr[k]);
  out.weights.resize(out.indptr[k]);
  out.strength.assign(k, 0.0);
  double tot = 0.0;
  for (int64_t c = 0; c < k; ++c) {
    int64_t pos = out.indptr[c];
    for (const auto& kv : adj[c]) {
      out.indices[pos] = (int32_t)kv.first;
      out.weights[pos] = kv.second;
      out.strength[c] += kv.second;
      tot += kv.second;
      ++pos;
    }
  }
  out.total_weight = tot / 2.0;
  return out;
}

}  // namespace

extern "C" int64_t leiden_cluster(const int64_t* indptr,
                                  const int32_t* indices,
                                  const double* weights, int64_t n_nodes,
                                  double resolution, uint64_t seed,
                                  int64_t max_rounds, int64_t* labels_out) {
  if (n_nodes <= 0) return 0;
  Graph g = make_graph(indptr, indices, weights, n_nodes);
  std::mt19937_64 rng(seed);

  std::vector<int64_t> membership(g.n);
  for (int64_t i = 0; i < g.n; ++i) membership[i] = i;
  std::vector<int64_t> mapping(n_nodes);
  for (int64_t i = 0; i < n_nodes; ++i) mapping[i] = i;

  for (int64_t round = 0; round < max_rounds; ++round) {
    std::vector<int64_t> comm(membership);
    bool improved = local_move(g, comm, resolution, rng);
    std::unordered_map<int64_t, int64_t> uniq;
    for (int64_t v = 0; v < g.n; ++v) uniq.emplace(comm[v], 1);
    if (!improved && (int64_t)uniq.size() == g.n) {
      membership = comm;
      break;
    }
    std::vector<int64_t> refined = refine(g, comm, resolution, rng);
    std::vector<int64_t> inverse;
    Graph g_new = aggregate(g, refined, inverse);
    if (g_new.n == g.n) {
      membership = comm;
      break;
    }
    // initial partition of the aggregate = phase-1 communities
    std::vector<int64_t> agg_comm(g_new.n, 0);
    for (int64_t v = 0; v < g.n; ++v) agg_comm[inverse[v]] = comm[v];
    for (int64_t i = 0; i < n_nodes; ++i) mapping[i] = inverse[mapping[i]];
    g = std::move(g_new);
    membership = std::move(agg_comm);
  }

  // final labels, renumbered by decreasing cluster size
  std::vector<int64_t> final_labels(n_nodes);
  for (int64_t i = 0; i < n_nodes; ++i) final_labels[i] = membership[mapping[i]];
  std::unordered_map<int64_t, int64_t> counts;
  for (int64_t i = 0; i < n_nodes; ++i) counts[final_labels[i]]++;
  std::vector<std::pair<int64_t, int64_t>> by_size(counts.begin(), counts.end());
  std::sort(by_size.begin(), by_size.end(), [](const auto& a, const auto& b) {
    if (a.second != b.second) return a.second > b.second;
    return a.first < b.first;
  });
  std::unordered_map<int64_t, int64_t> remap;
  for (size_t i = 0; i < by_size.size(); ++i) remap[by_size[i].first] = (int64_t)i;
  for (int64_t i = 0; i < n_nodes; ++i) labels_out[i] = remap[final_labels[i]];
  return (int64_t)by_size.size();
}
