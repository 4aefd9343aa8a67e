// Binary cutpoint elliptical-slice update: one whole ESS step per lane.
//
// Replaces the TPU kernel gpirt_tpu/ops/pallas_threshold.py ::
// binary_threshold_ess_pallas (body `_kernel`). A lane is one
// (chain k, horizon h, item j) interior cutpoint t_1; its log-likelihood is
//
//     ll(t) = sum_i obs_i * log(0.5 * (1 + erf(sgn_i * (t - g_i) * c)) + 1e-6)
//
// over the n respondents i, with sgn = +1 for y = 1, -1 for y = 2 and
// obs = (y > 0). The slice level is ll(t0) + log u, each proposal is
// t0 cos(eps) + nu sin(eps), and the bracket starts at [eps - 2 pi, 2 pi]
// and shrinks toward 0 with the uniform rs[r, lane] of round r. A lane
// still active after R rounds keeps t0 (the identity move of the round cap).
//
// What bounds it: transcendentals. Every round costs each active lane n
// erff + logf (n = 100 on senate116) against n loads of 4 + 4 bytes that
// stay in L2 after the first round (g is 10.7 MB at K = 64), so the block
// is arithmetic-bound on the special-function pipes, not on HBM.
//
// Design:
//   * one thread per lane; neighbouring threads hold neighbouring items j,
//     so for a fixed respondent i the loads of g (K, H, n, m) and y (H, n, m)
//     are coalesced in the sweep's own layout, with no transpose;
//   * sgn and obs are derived from y in registers, not materialised per
//     chain; y is shared by all chains;
//   * the whole round loop runs inside the launch, and a warp leaves it as
//     soon as all its lanes have accepted (__any_sync), so no host
//     synchronisation per round and no global "any lane active" test;
//   * the ragged edge (L not a multiple of the block) is masked here.
//
// Plain C interface for ctypes; returns cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kFloor = 1e-6f;
constexpr int kThreads = 128;

__device__ __forceinline__ float lane_ll(const float* __restrict__ g,
                                         const int32_t* __restrict__ y,
                                         int n, int m, float t, float c) {
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) {
    const int32_t yy = __ldg(y + static_cast<int64_t>(i) * m);
    if (yy > 0) {
      const float s = (yy == 1) ? 1.0f : -1.0f;
      const float x = s * (t - __ldg(g + static_cast<int64_t>(i) * m)) * c;
      acc += logf(0.5f * (1.0f + erff(x)) + kFloor);
    }
  }
  return acc;
}

__global__ void binary_threshold_ess_kernel(
    const float* __restrict__ g, const int32_t* __restrict__ y,
    const float* __restrict__ t1, const float* __restrict__ nu,
    const float* __restrict__ logu, const float* __restrict__ eps0,
    const float* __restrict__ rs, float c, float* __restrict__ out,
    int K, int H, int n, int m, int R) {
  const int64_t L = static_cast<int64_t>(K) * H * m;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool valid = lane < L;

  float t0 = 0.0f, v = 0.0f, log_y = 0.0f, eps = 0.0f;
  float eps_min = 0.0f, eps_max = kTwoPi, x_out = 0.0f;
  const float* gl = g;
  const int32_t* yl = y;
  bool active = valid;
  if (valid) {
    const int64_t hm = static_cast<int64_t>(H) * m;
    const int64_t k = lane / hm;
    const int64_t h = (lane % hm) / m;
    const int64_t j = lane % m;
    gl = g + ((k * H + h) * n) * m + j;
    yl = y + (h * n) * m + j;
    t0 = t1[lane];
    v = nu[lane];
    eps = eps0[lane];
    eps_min = eps - kTwoPi;
    x_out = t0;
    log_y = lane_ll(gl, yl, n, m, t0, c) + logu[lane];
  }
  for (int r = 0; r < R; ++r) {
    // every thread of the warp reaches this vote, the masked tail included
    if (!__any_sync(0xffffffffu, active)) break;
    if (active) {
      const float prop = t0 * cosf(eps) + v * sinf(eps);
      if (lane_ll(gl, yl, n, m, prop, c) > log_y) {
        x_out = prop;
        active = false;
      } else {
        if (eps < 0.0f) eps_min = eps; else eps_max = eps;
        eps = eps_min + rs[static_cast<int64_t>(r) * L + lane] * (eps_max - eps_min);
      }
    }
  }
  if (valid) out[lane] = x_out;
}

}  // namespace

extern "C" int gpirt_binary_threshold_ess(
    const float* g, const int32_t* y, const float* t1, const float* nu,
    const float* logu, const float* eps0, const float* rs, float c,
    float* out, int K, int H, int n, int m, int R, void* stream) {
  const int64_t L = static_cast<int64_t>(K) * H * m;
  const unsigned blocks = static_cast<unsigned>((L + kThreads - 1) / kThreads);
  binary_threshold_ess_kernel<<<blocks, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      g, y, t1, nu, logu, eps0, rs, c, out, K, H, n, m, R);
  return static_cast<int>(cudaGetLastError());
}
