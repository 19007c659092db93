// Native F0 extractor: YIN (de Cheveigne & Kawahara 2002) with parabolic
// refinement. Plays the role pyworld's harvest/dio+stonemask plays in the
// reference GAN data pipeline (cosyvoice/dataset/processor.py:200-222):
// per-frame F0 at a fixed hop for the HiFT F0 loss and NSF source.
//
// Algorithm (public):
//   d(tau)  = sum_t (x[t] - x[t+tau])^2                 (difference fn)
//   d'(tau) = d(tau) * tau / sum_{j<=tau} d(j)          (cumulative-mean norm)
//   pick the first tau where d'(tau) < threshold (else global min),
//   refine tau by parabolic interpolation of d' and return sr/tau.
// Unvoiced frames (no dip below the voicing threshold / low energy) -> 0.
//
// C ABI for ctypes; no external dependencies.

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// wav: float32 [n]; out_f0: float32 [n_frames] (caller-allocated).
// Returns n_frames actually written.
int yin_f0(const float* wav, int n, int sample_rate, int hop, int frame,
           float fmin, float fmax, float threshold, float* out_f0,
           int max_frames) {
  if (frame <= 0) frame = 4 * hop;
  const int tau_min = (int)(sample_rate / fmax);
  int tau_max = (int)(sample_rate / fmin);
  if (tau_max > frame - 1) tau_max = frame - 1;
  const int n_frames_total = n / hop;
  const int n_frames = n_frames_total < max_frames ? n_frames_total : max_frames;

  std::vector<float> d(tau_max + 1), dn(tau_max + 1);

  for (int fidx = 0; fidx < n_frames; ++fidx) {
    out_f0[fidx] = 0.0f;
    const int start = fidx * hop;
    if (start + frame + tau_max >= n) {
      // tail frames: shrink the window if possible, else leave unvoiced
      if (start + 2 * tau_max >= n) continue;
    }
    const int w = (start + frame + tau_max < n) ? frame : (n - start - tau_max - 1);
    if (w < tau_max) continue;
    const float* x = wav + start;

    // energy gate
    double energy = 0.0;
    for (int t = 0; t < w; ++t) energy += (double)x[t] * x[t];
    if (energy / w < 1e-8) continue;

    // difference function
    d[0] = 0.0f;
    for (int tau = 1; tau <= tau_max; ++tau) {
      double acc = 0.0;
      for (int t = 0; t < w; ++t) {
        const float diff = x[t] - x[t + tau];
        acc += (double)diff * diff;
      }
      d[tau] = (float)acc;
    }

    // cumulative-mean-normalized difference
    dn[0] = 1.0f;
    double running = 0.0;
    for (int tau = 1; tau <= tau_max; ++tau) {
      running += d[tau];
      dn[tau] = running > 0.0 ? (float)(d[tau] * tau / running) : 1.0f;
    }

    // absolute threshold: first local dip under threshold in [tau_min, tau_max]
    int tau_est = -1;
    for (int tau = tau_min; tau <= tau_max - 1; ++tau) {
      if (dn[tau] < threshold) {
        while (tau + 1 <= tau_max - 1 && dn[tau + 1] < dn[tau]) ++tau;
        tau_est = tau;
        break;
      }
    }
    if (tau_est < 0) {
      // no dip under threshold: voiced only if the global min is convincing
      float best = 1e30f;
      int best_tau = -1;
      for (int tau = tau_min; tau <= tau_max; ++tau)
        if (dn[tau] < best) { best = dn[tau]; best_tau = tau; }
      if (best < 2.0f * threshold) tau_est = best_tau; else continue;
    }

    // parabolic interpolation around tau_est (the stonemask-style refinement)
    float tau_ref = (float)tau_est;
    if (tau_est > tau_min && tau_est < tau_max) {
      const float a = dn[tau_est - 1], b = dn[tau_est], c = dn[tau_est + 1];
      const float denom = a - 2.0f * b + c;
      if (std::fabs(denom) > 1e-12f) {
        float shift = 0.5f * (a - c) / denom;
        if (shift > -1.0f && shift < 1.0f) tau_ref += shift;
      }
    }
    if (tau_ref > 0.0f) out_f0[fidx] = (float)sample_rate / tau_ref;
  }
  return n_frames;
}

}  // extern "C"
