// Cycle performance model + optimal agglomeration-schedule search.
//
// A copy of cedar_tpu's native model (cedar_tpu/native/perf_model.cc),
// kept in the port so that the port imports nothing of the JAX package;
// the model is unchanged.  It is the native counterpart of the reference's
// C++ performance subsystem (src/perf/vcycle_model.cc, src/perf/search.cc,
// include/cedar/ss/astar.h): an analytic model of one V-cycle level's time
// under a candidate sharding, and an A* search over per-level agglomeration
// schedules.
//
//  * the unit of placement is a MESH-AXIS SUBSET (a level is block-
//    partitioned over the axes in the subset and replicated along the
//    rest), as in cedar_tpu_torch.parallel.policy, where coarse levels
//    drop mesh axes until fully replicated (the reference's "redundant"
//    mode);
//  * per-level cost = max(memory-traffic time on the largest shard,
//    compute time) + halo time over the interconnect (bytes/bw +
//    hops*latency);
//  * an agglomeration step (dropping axes between levels) pays an
//    all-gather of the coarse level over the dropped axes;
//  * schedules are monotone (axes only dropped as levels coarsen), so the
//    state space is a DAG over (level, axis-subset); A* with a
//    remaining-levels-at-peak-bandwidth heuristic finds the optimum.
//
// Exposed via a C ABI for ctypes (cedar_tpu_torch/perf); the Python
// fallback implements the identical model.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <queue>
#include <vector>
#include <limits>

namespace {

struct Machine {
  double hbm_bw;       // bytes/s per chip
  double ici_bw;       // bytes/s per link
  double ici_lat;      // seconds per hop
  double flop_rate;    // flops/s per chip
  double op_overhead;  // fixed seconds per launched device op
};

struct Level {
  int64_t shape[3];
  int ndim;
  int stencil_size;   // 5/9 (2D), 7/27 (3D)
  int nsweeps;        // pre+post relaxation sweeps
};

constexpr int kMaxAxes = 3;

int64_t shard_points(const Level& lv, const int* mesh, unsigned mask) {
  int64_t pts = 1;
  for (int d = 0; d < lv.ndim; ++d) {
    int64_t n = lv.shape[d];
    if (mask >> d & 1) n = (n + mesh[d] - 1) / mesh[d];
    pts *= n;
  }
  return pts;
}

int64_t halo_bytes(const Level& lv, const int* mesh, unsigned mask,
                   int dtype_bytes) {
  // one slab of the shard's surface per sharded axis, both directions
  int64_t bytes = 0;
  for (int d = 0; d < lv.ndim; ++d) {
    if (!(mask >> d & 1) || mesh[d] <= 1) continue;
    int64_t face = 1;
    for (int e = 0; e < lv.ndim; ++e) {
      if (e == d) continue;
      int64_t n = lv.shape[e];
      if (mask >> e & 1) n = (n + mesh[e] - 1) / mesh[e];
      face *= n;
    }
    bytes += 2 * face * dtype_bytes;
  }
  return bytes;
}

// Time of one level's work within a V-cycle under `mask` sharding.
double level_time(const Level& lv, const int* mesh, unsigned mask,
                  const Machine& m, int dtype_bytes) {
  int64_t pts = shard_points(lv, mesh, mask);
  // streams per sweep: stencil planes (stored form ~ (s+1)/2 + center),
  // q, b reads + q write; residual+transfers ~ 3 more passes
  int planes = (lv.stencil_size + 1) / 2 + 1;
  double sweep_bytes = double(pts) * dtype_bytes * (planes + 3);
  double passes = lv.nsweeps + 3;  // sweeps + residual + restrict + interp
  double hbm_t = sweep_bytes * passes / m.hbm_bw;
  double flops = 2.0 * lv.stencil_size * double(pts) * passes;
  double comp_t = flops / m.flop_rate;
  double comm_t = 0.0;
  int exchanges = lv.nsweeps + 2;  // per sweep + residual + transfer ghosts
  int64_t hb = halo_bytes(lv, mesh, mask, dtype_bytes);
  if (hb > 0) comm_t = exchanges * (hb / m.ici_bw + m.ici_lat);
  double local = hbm_t > comp_t ? hbm_t : comp_t;
  return local + comm_t + passes * m.op_overhead;
}

// Direct coarse solve: dense inverse applied by matmul on the REPLICATED
// coarse system (the implementation always replicates the coarsest level
// — "redundant" mode); the TPU analogue of the reference's DPBTRS term
// (vcycle_model.cc:162 tcgsolve).  Mask-independent by construction.
double cg_solve_time(const Level& lv, const int* mesh, unsigned mask,
                     const Machine& m, int dtype_bytes) {
  (void)mesh; (void)mask;
  int64_t pts = shard_points(lv, mesh, 0);
  double flops = 2.0 * double(pts) * double(pts);
  double bytes = double(pts) * double(pts) * dtype_bytes;  // read A^-1
  double comp_t = flops / m.flop_rate;
  double hbm_t = bytes / m.hbm_bw;
  return (hbm_t > comp_t ? hbm_t : comp_t) + m.op_overhead;
}

// All-gather cost of agglomerating a level from mask `from` to `to`.
double agglom_time(const Level& lv, const int* mesh, unsigned from,
                   unsigned to, const Machine& m, int dtype_bytes) {
  unsigned dropped = from & ~to;
  if (!dropped) return 0.0;
  int64_t shard = shard_points(lv, mesh, from) * dtype_bytes;
  double t = 0.0;
  for (int d = 0; d < lv.ndim; ++d) {
    if (!(dropped >> d & 1) || mesh[d] <= 1) continue;
    // ring all-gather along the axis: (p-1)/p of the gathered bytes
    double p = mesh[d];
    t += shard * (p - 1.0) / m.ici_bw + (p - 1.0) * m.ici_lat;
    shard *= mesh[d];
  }
  return t;
}

struct Node {
  int level;
  unsigned mask;
  double cost;
  bool operator<(const Node& o) const { return cost > o.cost; }  // min-heap
};

}  // namespace

extern "C" {

// Predict the time of one V-cycle for a FIXED per-level mask schedule.
double cedar_perf_cycle_time(
    const int64_t* shapes,     // nlevels * 3
    int nlevels, int ndim, int stencil_fine, int stencil_coarse,
    int nsweeps, const int* mesh_dims, const unsigned* masks,
    double hbm_bw, double ici_bw, double ici_lat, double flop_rate,
    int dtype_bytes, double op_overhead) {
  Machine m{hbm_bw, ici_bw, ici_lat, flop_rate, op_overhead};
  double total = 0.0;
  for (int l = 0; l < nlevels; ++l) {
    Level lv;
    lv.ndim = ndim;
    for (int d = 0; d < 3; ++d) lv.shape[d] = shapes[l * 3 + d];
    lv.stencil_size = l == 0 ? stencil_fine : stencil_coarse;
    lv.nsweeps = nsweeps;
    if (l == nlevels - 1)
      total += cg_solve_time(lv, mesh_dims, masks[l], m, dtype_bytes);
    else
      total += level_time(lv, mesh_dims, masks[l], m, dtype_bytes);
    if (l + 1 < nlevels) {
      // agglomeration gathers the COARSE level's data (matches the
      // search's step cost)
      Level lc;
      lc.ndim = ndim;
      for (int d = 0; d < 3; ++d) lc.shape[d] = shapes[(l + 1) * 3 + d];
      lc.stencil_size = stencil_coarse;
      lc.nsweeps = nsweeps;
      // the coarsest level is always replicated (redundant coarse solve)
      unsigned to = l + 1 == nlevels - 1 ? 0u : masks[l + 1];
      total += agglom_time(lc, mesh_dims, masks[l], to, m, dtype_bytes);
    }
  }
  return total;
}

// A* search for the optimal monotone agglomeration schedule.
// Writes the chosen mask per level into `out_masks`; returns the predicted
// cycle time.  `allowed` holds a bitmask per level of axes that MAY be
// sharded there (divisibility/size constraints from the caller).
double cedar_perf_search(
    const int64_t* shapes, int nlevels, int ndim, int stencil_fine,
    int stencil_coarse, int nsweeps, const int* mesh_dims,
    const unsigned* allowed, double hbm_bw, double ici_bw, double ici_lat,
    double flop_rate, int dtype_bytes, double op_overhead,
    unsigned* out_masks) {
  Machine m{hbm_bw, ici_bw, ici_lat, flop_rate, op_overhead};
  const unsigned nmasks = 1u << ndim;

  auto lvl = [&](int l) {
    Level lv;
    lv.ndim = ndim;
    for (int d = 0; d < 3; ++d) lv.shape[d] = shapes[l * 3 + d];
    lv.stencil_size = l == 0 ? stencil_fine : stencil_coarse;
    lv.nsweeps = nsweeps;
    return lv;
  };

  // admissible heuristic: remaining levels at fully-sharded HBM speed
  std::vector<double> h(nlevels + 1, 0.0);
  for (int l = nlevels - 1; l >= 0; --l) {
    Level lv = lvl(l);
    unsigned full = (1u << ndim) - 1;
    int64_t pts = shard_points(lv, mesh_dims, full);
    int planes = (lv.stencil_size + 1) / 2 + 1;
    double best = double(pts) * dtype_bytes * (planes + 3) *
                  (lv.nsweeps + 3) / m.hbm_bw;
    if (l == nlevels - 1) best = 0.0;  // coarse solve may be cheaper
    h[l] = h[l + 1] + best;
  }

  std::vector<double> dist(size_t(nlevels + 1) * nmasks,
                           std::numeric_limits<double>::infinity());
  std::vector<int> parent(size_t(nlevels + 1) * nmasks, -1);
  std::priority_queue<Node> open;

  unsigned allow0 = nlevels == 1 ? 0u : allowed[0];
  for (unsigned mk = 0; mk < nmasks; ++mk) {
    if ((mk & ~allow0) != 0) continue;
    Level lv = lvl(0);
    double c = nlevels == 1
                   ? cg_solve_time(lv, mesh_dims, mk, m, dtype_bytes)
                   : level_time(lv, mesh_dims, mk, m, dtype_bytes);
    size_t idx = 1 * nmasks + mk;  // state: about to place level 1
    if (c < dist[idx]) {
      dist[idx] = c;
      parent[idx] = int(mk);
      open.push({1, mk, c + h[1]});
    }
  }

  double best_cost = std::numeric_limits<double>::infinity();
  unsigned best_final = 0;
  while (!open.empty()) {
    Node nd = open.top();
    open.pop();
    size_t idx = size_t(nd.level) * nmasks + nd.mask;
    if (nd.cost - h[nd.level] > dist[idx] + 1e-18) continue;
    if (nd.level == nlevels) {
      best_cost = dist[idx];
      best_final = nd.mask;
      break;
    }
    Level lv = lvl(nd.level);
    Level prev = lvl(nd.level - 1);
    // the coarsest level is always replicated (redundant coarse solve)
    unsigned allow_l = nd.level == nlevels - 1 ? 0u : allowed[nd.level];
    for (unsigned mk = 0; mk < nmasks; ++mk) {
      if ((mk & ~allow_l) != 0) continue;
      if ((mk & ~nd.mask) != 0) continue;  // monotone: only drop axes
      double lvl_t = nd.level == nlevels - 1
                         ? cg_solve_time(lv, mesh_dims, mk, m, dtype_bytes)
                         : level_time(lv, mesh_dims, mk, m, dtype_bytes);
      double step = agglom_time(lv, mesh_dims, nd.mask, mk, m, dtype_bytes)
                    + lvl_t;
      (void)prev;
      size_t nidx = size_t(nd.level + 1) * nmasks + mk;
      double c = dist[idx] + step;
      if (c < dist[nidx]) {
        dist[nidx] = c;
        parent[nidx] = int(nd.mask);
        open.push({nd.level + 1, mk, c + h[nd.level + 1]});
      }
    }
  }

  // reconstruct schedule
  unsigned mk = best_final;
  for (int l = nlevels; l >= 1; --l) {
    out_masks[l - 1] = mk;
    mk = unsigned(parent[size_t(l) * nmasks + mk]);
  }
  return best_cost;
}

}  // extern "C"
