// Native Pascal-VOC bbox F1 matrix over all (generated x reference) scene pairs.
//
// C++ counterpart of diffusesg_torch/eval/voc_f1.py (same math; see that module
// for the derivation from the reference implementation,
// DiffuseSG/evaluation/bbox_metrics.py:62-111,379-440 + bbox_utils.py:337-466):
// the reference names boxes by node index, so matching is aligned-index +
// same-class + IoU >= threshold with the vendored +1-pixel IoU convention.
// The reference parallelizes the per-pair greedy matcher with mp.Pool; this
// runs the closed-form cumulative-sum formulation in tight loops —
// O(Bg * Br * classes * D * T) with tiny constants.
//
// Exposed via ctypes (see eval/native/__init__.py); the numpy version runs
// when the shared object does not build.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline double aligned_iou(const double* a, const double* b) {
  // Evaluator.iou with the +1 inclusive-pixel quirk (bbox_utils.py:703-747)
  const double x1a = a[0], y1a = a[1], x2a = a[2], y2a = a[3];
  const double x1b = b[0], y1b = b[1], x2b = b[2], y2b = b[3];
  if (x1a > x2b || x1b > x2a || y1a > y2b || y1b > y2a) return 0.0;
  const double xA = x1a > x1b ? x1a : x1b;
  const double yA = y1a > y1b ? y1a : y1b;
  const double xB = x2a < x2b ? x2a : x2b;
  const double yB = y2a < y2b ? y2a : y2b;
  const double inter = (xB - xA + 1.0) * (yB - yA + 1.0);
  const double area_a = (x2a - x1a + 1.0) * (y2a - y1a + 1.0);
  const double area_b = (x2b - x1b + 1.0) * (y2b - y1b + 1.0);
  const double uni = area_a + area_b - inter;
  return uni == 0.0 ? 0.0 : inter / uni;
}

}  // namespace

extern "C" void compute_f1_matrix(
    const double* boxes_gen,   // [Bg, N, 4] xyxy
    const int64_t* types_gen,  // [Bg, N]
    const uint8_t* valid_gen,  // [Bg, N]
    const double* boxes_ref,   // [Br, N, 4]
    const int64_t* types_ref,  // [Br, N]
    const uint8_t* valid_ref,  // [Br, N]
    int bg, int br, int n,
    const double* thresholds, int num_thr,
    const double* weights,     // [W, num_classes]
    int num_weights, int num_classes,
    double* out)               // [Bg, Br, W]
{
  // per-ref-scene: class presence, positive counts, weight sums
  std::vector<uint8_t> pres_ref((size_t)br * num_classes, 0);
  std::vector<int32_t> npos((size_t)br * num_classes, 0);
  std::vector<double> wsum_ref((size_t)br * num_weights, 0.0);
  for (int r = 0; r < br; ++r) {
    for (int i = 0; i < n; ++i) {
      if (!valid_ref[(size_t)r * n + i]) continue;
      const int c = (int)types_ref[(size_t)r * n + i];
      uint8_t& p = pres_ref[(size_t)r * num_classes + c];
      if (!p) {
        p = 1;
        for (int w = 0; w < num_weights; ++w)
          wsum_ref[(size_t)r * num_weights + w] += weights[(size_t)w * num_classes + c];
      }
      npos[(size_t)r * num_classes + c] += 1;
    }
  }

  std::vector<int> det_idx(n);
  std::vector<int> g_classes(num_classes);
  std::vector<uint8_t> pres_g(num_classes);
  std::vector<double> f1_num((size_t)num_thr * num_weights);
  std::vector<double> prec(n), interp(n);
  std::vector<uint8_t> tp(n);

  for (int g = 0; g < bg; ++g) {
    // classes present in the gen scene + per-weight sums
    std::memset(pres_g.data(), 0, num_classes);
    int n_gcls = 0;
    for (int i = 0; i < n; ++i) {
      if (!valid_gen[(size_t)g * n + i]) continue;
      const int c = (int)types_gen[(size_t)g * n + i];
      if (!pres_g[c]) { pres_g[c] = 1; g_classes[n_gcls++] = c; }
    }
    double wsum_g[16] = {0};  // num_weights <= 16 in practice
    for (int k = 0; k < n_gcls; ++k)
      for (int w = 0; w < num_weights; ++w)
        wsum_g[w] += weights[(size_t)w * num_classes + g_classes[k]];

    for (int r = 0; r < br; ++r) {
      double* out_gr = out + ((size_t)g * br + r) * num_weights;
      // union weights and common-class check
      bool has_common = false;
      double winter[16] = {0};
      for (int k = 0; k < n_gcls; ++k) {
        const int c = g_classes[k];
        if (pres_ref[(size_t)r * num_classes + c]) {
          has_common = true;
          for (int w = 0; w < num_weights; ++w)
            winter[w] += weights[(size_t)w * num_classes + c];
        }
      }
      if (!has_common) {
        for (int w = 0; w < num_weights; ++w) out_gr[w] = 0.0;
        continue;
      }
      std::fill(f1_num.begin(), f1_num.end(), 0.0);

      for (int k = 0; k < n_gcls; ++k) {
        const int c = g_classes[k];
        int D = 0;
        for (int i = 0; i < n; ++i)
          if (valid_gen[(size_t)g * n + i] && (int)types_gen[(size_t)g * n + i] == c)
            det_idx[D++] = i;
        const int np = npos[(size_t)r * num_classes + c];

        for (int t = 0; t < num_thr; ++t) {
          const double thr = thresholds[t];
          int cum = 0;
          double sum_prec = 0.0, sum_rec = 0.0, ap = 0.0;
          for (int d = 0; d < D; ++d) {
            const int i = det_idx[d];
            bool hit = valid_ref[(size_t)r * n + i] &&
                       (int)types_ref[(size_t)r * n + i] == c;
            if (hit) {
              const double iou = aligned_iou(
                  boxes_gen + ((size_t)g * n + i) * 4,
                  boxes_ref + ((size_t)r * n + i) * 4);
              hit = iou >= thr;
            }
            tp[d] = hit ? 1 : 0;
            cum += hit ? 1 : 0;
            prec[d] = (double)cum / (double)(d + 1);
            sum_prec += prec[d];
            if (np > 0) sum_rec += (double)cum / (double)np;
          }
          if (np > 0 && D > 0) {
            double best = 0.0;  // suffix max of precision
            for (int d = D - 1; d >= 0; --d) {
              if (prec[d] > best) best = prec[d];
              interp[d] = best;
            }
            for (int d = 0; d < D; ++d)
              if (tp[d]) ap += interp[d] / (double)np;
          }
          double p_mean = 0.0, r_mean = 0.0;
          if (ap > 0.0 && D > 0) {
            p_mean = sum_prec / D;
            r_mean = sum_rec / D;
          }
          double denom = p_mean + r_mean;
          if (denom < 1e-6) denom = 1e-6;
          const double f1 = (p_mean == 0.0 && r_mean == 0.0)
                                ? 0.0
                                : 2.0 * p_mean * r_mean / denom;
          for (int w = 0; w < num_weights; ++w)
            f1_num[(size_t)t * num_weights + w] +=
                f1 * weights[(size_t)w * num_classes + c];
        }
      }

      for (int w = 0; w < num_weights; ++w) {
        const double uw = wsum_g[w] + wsum_ref[(size_t)r * num_weights + w] - winter[w];
        double acc = 0.0;
        for (int t = 0; t < num_thr; ++t)
          acc += f1_num[(size_t)t * num_weights + w] / (uw > 0.0 ? uw : 1.0);
        out_gr[w] = acc / num_thr;
      }
    }
  }
}
