// Ordinal cutpoint elliptical-slice update: one whole ESS step per lane.
//
// Replaces no TPU kernel: the JAX package's ordinal cutpoint update is
// plain jnp (gpirt_tpu/models/gibbs.py, draw_threshold's ordinal branch),
// and the port ran it as ops/ess.ess_update's host loop, one
// device-to-host sync and ~10 elementwise launches over the whole
// (K, H, n, m, C) cube a round. A lane is one (chain k, horizon h, item j)
// vector of C - 1 deltas d; its cutpoints are t_0 = -inf, t_1 = d_0,
// t_{c+1} = t_1 + (exp(d_1) + ... + exp(d_c)), t_C = +inf
// (ops/likelihood.delta_to_threshold), and its log-likelihood is
//
//     ll(d) = sum_i log(Phi(t_{y_i} - g_i) - Phi(t_{y_i - 1} - g_i) + 1e-6)
//
// over the respondents i with a category 1 <= y_i <= C, where
// Phi(x) = 0.5 * (1 + erf(x * c)) and c = c[k] is 1/sqrt(2) over sqrt(T),
// the chain's own under parallel tempering. Phi(-inf) = 0 and
// Phi(+inf) = 1 exactly, so the end cutpoints need no branch. Each site
// evaluates only its own category (two erfs and a log) where the plain
// version evaluates all C. The slice level is ll(d) + log u, each proposal
// is d cos(eps) + nu sin(eps), and the bracket starts at [eps - 2 pi, 2 pi]
// and shrinks toward 0 with the uniform rs[r, lane] of round r. A lane
// still active after R rounds keeps d.
//
// What bounds it on an H100. SDO's main path at 512 chains is L = 8,192
// lanes of n = 1,500 sites (m = 16, C = 5); at ~5 proposals a lane a launch
// evaluates ~74 M sites, at >= 20 FP32 operations each (two erfs and a log)
// ~1.5 GFLOP, 22 us at 67 TFLOP/s; it reads g (49 MB) once, 15 us at
// 3.35 TB/s. The bound is the operations, and in practice the issue rate
// of erff's and logf's instruction sequences.
//
// Design (the binary kernel's, csrc/threshold_ess.cu, with the cutpoints of
// each proposal in shared memory):
//   * a block takes a tile of TJ neighbouring items of one (k, h) and reads
//     the tile's (n x TJ) slab of g and y row by row (items innermost, so
//     the reads are coalesced), each item's column packed to its observed
//     sites in shared memory;
//   * a group of 256 threads runs one lane: its sites rank, rank + 256, ...
//     in registers while n <= 2,048, from the slab beyond; the partial sums
//     meet by a warp's shuffles, then in shared memory in warp order, and
//     every thread reads the same total, so the group takes one accept
//     decision with no broadcast. A group that is done takes the tile's
//     next item from a queue;
//   * each round one thread of the group writes the proposal's C + 1
//     cutpoints to the group's slot in shared memory (two slots, by the
//     round's parity, so no barrier guards their reuse), and every site
//     looks up its two;
//   * the path follows from n (and the shared memory that C needs) at
//     launch: the sites in registers up to n = 2,048, then the slab in
//     shared memory as far as one block holds it, and past that a block a
//     lane streaming its sites from device memory each round, at any n;
//   * a lane's sum is taken in an order fixed by n and its own y alone
//     (each thread's sites in row order, then the group's butterfly), so a
//     lane's bits never depend on K or on the lanes beside it.
// Every float operation that the plain PyTorch version rounds on its own is
// rounded on its own here too (__fmul_rn and friends stop contraction into
// FMAs), so a site's value is torch's on the card; only the order of the
// site sum differs.
//
// Plain C interface for ctypes; the entry returns cudaGetLastError() of its
// launch.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kFloor = 1e-6f;
constexpr int kMaxDevices = 64;

// A barrier of the G threads of this thread's group in a block of NT: a
// named barrier of the group's own (ids 1, 2, ...; 0 is __syncthreads') or
// the whole block.
template <int G, int NT>
__device__ __forceinline__ void group_barrier() {
  if constexpr (G < NT) {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + static_cast<int>(threadIdx.x) / G), "r"(G)
                 : "memory");
  } else {
    __syncthreads();
  }
}

// Sum over the G threads of a group in a block of NT; every thread of the
// group gets the same bits. The warps' sums meet in `red` (two rows of
// NT / 32, alternated by `parity`, so one barrier a call suffices) and are
// added in warp order.
template <int G, int NT>
__device__ __forceinline__ float group_sum(float v, float* red, int& parity) {
  static_assert(G % 32 == 0 && NT % G == 0, "a group of whole warps");
  constexpr int W = G / 32, NW = NT / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  float* buf = red + parity * NW + (warp / W) * W;
  parity ^= 1;
  if ((threadIdx.x & 31) == 0) buf[warp % W] = v;
  group_barrier<G, NT>();
  float s = buf[0];
#pragma unroll
  for (int w = 1; w < W; ++w) s += buf[w];
  return s;
}

// One site's term at the cutpoints t (t[0] = -inf, t[C] = +inf) for its
// category q in 1..C: log(Phi(t_q - g) - Phi(t_{q-1} - g) + 1e-6).
__device__ __forceinline__ float site_ll(const float* t, float g, int q, float c) {
  const float hi = __fmul_rn(0.5f, __fadd_rn(1.0f, erff(__fmul_rn(__fsub_rn(t[q], g), c))));
  const float lo = __fmul_rn(0.5f, __fadd_rn(1.0f, erff(__fmul_rn(__fsub_rn(t[q - 1], g), c))));
  return logf(__fadd_rn(__fsub_rn(hi, lo), kFloor));
}

// The deltas v[c] = d[c] cos + nu[c] sin of a proposal (d itself when
// `current`), written by one thread as cutpoints t[0..C] or, with t null,
// as the deltas `out`.
__device__ __forceinline__ void write_cuts(const float* dv, const float* nv, bool current,
                                           float cs, float sn, int C, float* t,
                                           float* out) {
  float first = 0.0f, s = 0.0f;
  for (int c = 0; c < C - 1; ++c) {
    const float v = current ? dv[c] : __fadd_rn(__fmul_rn(dv[c], cs), __fmul_rn(nv[c], sn));
    if (t == nullptr) {
      out[c] = v;
    } else if (c == 0) {
      first = v;
      t[1] = v;
    } else {
      s = __fadd_rn(s, expf(v));
      t[c + 1] = __fadd_rn(first, s);
    }
  }
  if (t != nullptr) {
    t[0] = -CUDART_INF_F;
    t[C] = CUDART_INF_F;
  }
}

// The ESS rounds of one lane, run alike by the G threads of its group;
// `partial(t)` is this thread's share of ll at the cutpoints t. `dn` holds
// the lane's d and nu (2 (C - 1) floats), `st` the group's two cutpoint
// slots (2 (C + 1) floats), both in shared memory. Writes the new deltas.
template <int G, int NT, typename Partial>
__device__ __forceinline__ void ordinal_lane(
    Partial partial, float* red, float* dn, float* st, int rank, int64_t lane, int64_t L,
    int C, int R, const float* __restrict__ d, const float* __restrict__ nu,
    const float* __restrict__ logu, const float* __restrict__ eps0,
    const float* __restrict__ rs, float* __restrict__ out) {
  const int D = C - 1;
  int parity = 0;
  if (rank == 0) {
    for (int c = 0; c < D; ++c) {
      dn[c] = __ldg(d + lane * D + c);
      dn[D + c] = __ldg(nu + lane * D + c);
    }
    write_cuts(dn, dn + D, true, 0.0f, 0.0f, C, st, nullptr);
  }
  float eps = __ldg(eps0 + lane);
  const float lu = __ldg(logu + lane);
  group_barrier<G, NT>();
  const float log_y = __fadd_rn(group_sum<G, NT>(partial(st), red, parity), lu);
  float eps_min = __fsub_rn(eps, kTwoPi), eps_max = kTwoPi;
  for (int r = 0; r < R; ++r) {
    const float u = __ldg(rs + r * L + lane);  // needed only after the ll
    float sn, cs;
    sincosf(eps, &sn, &cs);
    float* t = st + ((r + 1) & 1) * (C + 1);
    if (rank == 0) write_cuts(dn, dn + D, false, cs, sn, C, t, nullptr);
    group_barrier<G, NT>();
    if (group_sum<G, NT>(partial(t), red, parity) > log_y) {
      if (rank == 0) write_cuts(dn, dn + D, false, cs, sn, C, nullptr, out + lane * D);
      return;
    }
    if (eps < 0.0f) eps_min = eps; else eps_max = eps;
    eps = __fadd_rn(eps_min, __fmul_rn(u, __fsub_rn(eps_max, eps_min)));
  }
  if (rank == 0)
    for (int c = 0; c < D; ++c) out[lane * D + c] = dn[c];
}

// Tile path: a block of NT threads holds a tile of TJ neighbouring items of
// one (k, h), its (n x TJ) slab in shared memory (g a float and y a 16-bit
// category a site, each item in a column of pitch pf packed to its observed
// sites), and NT / G groups of G threads that take the tile's items from a
// queue. With S > 0 (n <= G S) a thread copies its sites into registers
// before the rounds.
template <int G, int NT, int TJ, int S>
__global__ void __launch_bounds__(NT) ordinal_cut_tile_kernel(
    const float* __restrict__ g, const int32_t* __restrict__ y,
    const float* __restrict__ d, const float* __restrict__ nu,
    const float* __restrict__ logu, const float* __restrict__ eps0,
    const float* __restrict__ rs, const float* __restrict__ c,
    float* __restrict__ out, int H, int n, int m, int C, int R, int pf) {
  constexpr int NW = NT / 32, NG = NT / G;
  static_assert(32 % TJ == 0 && TJ % 2 == 0, "whole rows a warp; the y block ends on a float");
  extern __shared__ float smem[];
  float* sg = smem;                                              // (TJ, pf) g
  uint16_t* sy = reinterpret_cast<uint16_t*>(sg + TJ * pf);      // (TJ, pf) y
  float* red = reinterpret_cast<float*>(sy + TJ * pf);           // (2, NW)
  int* scnt = reinterpret_cast<int*>(red + 2 * NW);              // (TJ)
  int* next = scnt + TJ;                                         // the queue's head
  int* gq = next + 1;                                            // (NG) a group's item
  float* sdn = reinterpret_cast<float*>(gq + NG);                // (NG, 2 (C - 1))
  float* sst = sdn + NG * 2 * (C - 1);                           // (NG, 2 (C + 1))

  const int tiles = (m + TJ - 1) / TJ;
  const int64_t kh = blockIdx.x / tiles;
  const int j0 = static_cast<int>(blockIdx.x % tiles) * TJ;
  const int tile = min(TJ, m - j0);
  const int64_t h = kh % H;
  const int64_t L = static_cast<int64_t>(gridDim.x / tiles) * m;
  const float ck = __ldg(c + kh / H);  // the chain's scale

  // 1. the slab, row by row: neighbouring items on neighbouring threads;
  //    a category outside 1..C is missing (0), as its all-zero one-hot
  const float* gb = g + kh * n * m + j0;
  const int32_t* yb = y + h * n * m + j0;
  for (int idx = threadIdx.x; idx < n * TJ; idx += NT) {
    const int i = idx / TJ, jj = idx - i * TJ;
    if (jj < tile) {
      const int64_t off = static_cast<int64_t>(i) * m + jj;
      const int32_t yy = __ldg(yb + off);
      sg[jj * pf + i] = __ldg(gb + off);
      sy[jj * pf + i] = (yy >= 1 && yy <= C) ? static_cast<uint16_t>(yy) : 0;
    }
  }
  if (threadIdx.x == 0) *next = NG;
  __syncthreads();

  // 2. each column packed in place to its observed sites, in row order, by
  //    a warp: 32 rows read, then written to their places
  const int warp = threadIdx.x >> 5, l32 = threadIdx.x & 31;
  for (int jj = warp; jj < tile; jj += NW) {
    float* cg = sg + jj * pf;
    uint16_t* cy = sy + jj * pf;
    int cnt = 0;
    for (int base = 0; base < n; base += 32) {
      const int i = base + l32;
      const float gv = i < n ? cg[i] : 0.0f;
      const uint16_t yv = i < n ? cy[i] : 0;
      const unsigned obs = __ballot_sync(0xffffffffu, yv != 0);
      __syncwarp();  // the chunk is read before any of it is overwritten
      if (yv != 0) {
        const int pos = cnt + __popc(obs & ((1u << l32) - 1u));
        cg[pos] = gv;
        cy[pos] = yv;
      }
      cnt += __popc(obs);
      __syncwarp();
    }
    if (l32 == 0) scnt[jj] = cnt;
  }
  __syncthreads();

  // 3. per item: its rounds over its packed column (sites rank, rank + G,
  //    ...), its output; then the tile's next item, passed to the group
  //    through its slot of gq
  const int grp = threadIdx.x / G, rank = threadIdx.x % G;
  float* dn = sdn + grp * 2 * (C - 1);
  float* st = sst + grp * 2 * (C + 1);
  for (int jj = grp; jj < tile;) {
    const int cnt = scnt[jj];
    const float* cg = sg + jj * pf;
    const uint16_t* cy = sy + jj * pf;
    const int64_t lane = kh * m + j0 + jj;
    if constexpr (S > 0) {
      const int mine = cnt > rank ? (cnt - rank + G - 1) / G : 0;
      float gr[S];
      int yr[S];
#pragma unroll
      for (int q = 0; q < S; ++q) {
        const int p = rank + G * q;
        gr[q] = q < mine ? cg[p] : 0.0f;
        yr[q] = q < mine ? cy[p] : 1;
      }
      auto partial = [&](const float* t) {
        float acc = 0.0f;
#pragma unroll
        for (int q = 0; q < S; ++q)
          if (q < mine) acc += site_ll(t, gr[q], yr[q], ck);
        return acc;
      };
      ordinal_lane<G, NT>(partial, red, dn, st, rank, lane, L, C, R, d, nu, logu, eps0,
                          rs, out);
    } else {
      auto partial = [&](const float* t) {
        float acc = 0.0f;
#pragma unroll 4
        for (int p = rank; p < cnt; p += G) acc += site_ll(t, cg[p], cy[p], ck);
        return acc;
      };
      ordinal_lane<G, NT>(partial, red, dn, st, rank, lane, L, C, R, d, nu, logu, eps0,
                          rs, out);
    }
    if (rank == 0) gq[grp] = atomicAdd(next, 1);
    group_barrier<G, NT>();
    jj = gq[grp];
  }
}

// Streaming path for any n: a block a lane reads its column from device
// memory every round.
constexpr int kStreamNT = 256;

__global__ void __launch_bounds__(kStreamNT) ordinal_cut_stream_kernel(
    const float* __restrict__ g, const int32_t* __restrict__ y,
    const float* __restrict__ d, const float* __restrict__ nu,
    const float* __restrict__ logu, const float* __restrict__ eps0,
    const float* __restrict__ rs, const float* __restrict__ c,
    float* __restrict__ out, int H, int n, int m, int C, int R) {
  extern __shared__ float smem[];
  float* red = smem;                        // (2, kStreamNT / 32)
  float* dn = red + 2 * (kStreamNT / 32);   // 2 (C - 1)
  float* st = dn + 2 * (C - 1);             // 2 (C + 1)
  const int64_t lane = blockIdx.x;
  const int64_t L = gridDim.x;
  const int64_t kh = lane / m;
  const int64_t j = lane % m;
  const float ck = __ldg(c + kh / H);  // the chain's scale
  const float* gl = g + kh * n * m + j;
  const int32_t* yl = y + (kh % H) * n * m + j;
  auto partial = [&](const float* t) {
    float acc = 0.0f;
    for (int i = threadIdx.x; i < n; i += kStreamNT) {
      const int64_t off = static_cast<int64_t>(i) * m;
      const int32_t yy = __ldg(yl + off);
      if (yy >= 1 && yy <= C) acc += site_ll(t, __ldg(gl + off), yy, ck);
    }
    return acc;
  };
  ordinal_lane<kStreamNT, kStreamNT>(partial, red, dn, st, threadIdx.x, lane, L, C, R, d,
                                     nu, logu, eps0, rs, out);
}

enum Path { kPathRegs = 0, kPathTile = 1, kPathStream = 2 };

// How a launch runs: the path, threads a lane (G) and a block (NT), items a
// block (TJ), sites a thread in registers (S), dynamic shared memory and
// the slab's column pitch.
struct Plan {
  Path path;
  int G, NT, TJ, S;
  size_t smem;
  int pf;
};

// A tile path's plan at n rows and C categories: the column pitch keeps a
// warp's stores of 32 / TJ rows of g in distinct banks.
Plan tile_plan(Path path, int G, int NT, int TJ, int S, int n, int C) {
  Plan p{path, G, NT, TJ, S, 0, 0};
  p.pf = (n + 31) / 32 * 32 + 32 / TJ;
  const size_t NG = NT / G;
  p.smem = static_cast<size_t>(TJ) * p.pf * (sizeof(float) + sizeof(uint16_t)) +
           (2 * (NT / 32) + TJ + 1 + NG + NG * 4 * static_cast<size_t>(C)) * sizeof(float);
  return p;
}

size_t stream_smem(int C) {
  return (2 * (kStreamNT / 32) + 4 * static_cast<size_t>(C)) * sizeof(float);
}

// The plan at n and C on a device whose blocks may opt in to `optin` bytes
// of shared memory: the sites in registers while n fits, then the slab in
// shared memory while it fits, then streaming.
Plan choose(int n, int C, int optin) {
  const Plan cands[] = {
      tile_plan(kPathRegs, 256, 1024, 8, 8, n, C),
      tile_plan(kPathTile, 256, 1024, 8, 0, n, C),
  };
  for (const Plan& p : cands)
    if ((p.S == 0 || n <= p.G * p.S) && p.smem <= static_cast<size_t>(optin)) return p;
  return {kPathStream, kStreamNT, kStreamNT, 1, 0, stream_smem(C), 0};
}

// The current device's index and the shared memory a block may opt in to,
// read once a device.
cudaError_t device_optin(int* dev, int* bytes) {
  static int optin[kMaxDevices] = {};
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  if (*dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (optin[*dev] == 0) {
    e = cudaDeviceGetAttribute(&optin[*dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    if (e != cudaSuccess) return e;
  }
  *bytes = optin[*dev];
  return cudaSuccess;
}

// Raise `kernel`'s dynamic shared memory to `optin` once a device, before
// any capture of a launch.
template <typename Kernel>
cudaError_t raise_smem(Kernel kernel, bool* raised, int dev, int optin) {
  if (raised[dev]) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e == cudaSuccess) raised[dev] = true;
  return e;
}

template <int G, int NT, int TJ, int S>
int launch_tile(const float* g, const int32_t* y, const float* d, const float* nu,
                const float* logu, const float* eps0, const float* rs, const float* c,
                float* out, int K, int H, int n, int m, int C, int R, cudaStream_t stream,
                const Plan& p, int dev, int optin) {
  static bool raised[kMaxDevices] = {};
  const int64_t blocks = static_cast<int64_t>(K) * H * ((m + TJ - 1) / TJ);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = raise_smem(ordinal_cut_tile_kernel<G, NT, TJ, S>, raised, dev, optin);
  if (e != cudaSuccess) return static_cast<int>(e);
  ordinal_cut_tile_kernel<G, NT, TJ, S><<<static_cast<unsigned>(blocks), NT, p.smem, stream>>>(
      g, y, d, nu, logu, eps0, rs, c, out, H, n, m, C, R, p.pf);
  return static_cast<int>(cudaGetLastError());
}

int launch_stream(const float* g, const int32_t* y, const float* d, const float* nu,
                  const float* logu, const float* eps0, const float* rs, const float* c,
                  float* out, int H, int n, int m, int C, int R, int64_t L,
                  cudaStream_t stream, const Plan& p, int dev, int optin) {
  static bool raised[kMaxDevices] = {};
  if (L > 0x7fffffff || p.smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = raise_smem(ordinal_cut_stream_kernel, raised, dev, optin);
  if (e != cudaSuccess) return static_cast<int>(e);
  ordinal_cut_stream_kernel<<<static_cast<unsigned>(L), kStreamNT, p.smem, stream>>>(
      g, y, d, nu, logu, eps0, rs, c, out, H, n, m, C, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch on the path that choose() gives for n and C. d, nu and out are
// (K, H, m, C - 1); c is a (K,) vector, one scale a chain.
extern "C" int gpirt_ordinal_threshold_ess(
    const float* g, const int32_t* y, const float* d, const float* nu, const float* logu,
    const float* eps0, const float* rs, const float* c, float* out, int K, int H, int n,
    int m, int C, int R, void* stream) {
  const int64_t L = static_cast<int64_t>(K) * H * m;
  if (L == 0) return static_cast<int>(cudaSuccess);
  if (C < 3) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev, optin;
  const cudaError_t e = device_optin(&dev, &optin);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Plan p = choose(n, C, optin);
  switch (p.path) {
    case kPathRegs:
      return launch_tile<256, 1024, 8, 8>(g, y, d, nu, logu, eps0, rs, c, out, K, H, n, m, C, R, st, p, dev, optin);
    case kPathTile:
      return launch_tile<256, 1024, 8, 0>(g, y, d, nu, logu, eps0, rs, c, out, K, H, n, m, C, R, st, p, dev, optin);
    default:
      return launch_stream(g, y, d, nu, logu, eps0, rs, c, out, H, n, m, C, R, L, st, p, dev, optin);
  }
}

// The plan that the entry above launches at n and C on the current device:
// info[0] the path (0 registers, 1 the slab in shared memory, 2 streaming),
// info[1] the threads a lane, info[2] the items a block, info[3] the
// block's dynamic shared memory in bytes, info[4] the threads a block,
// info[5] the sites a thread in registers.
extern "C" int gpirt_ordinal_threshold_ess_plan(int n, int C, int* info) {
  int dev, optin;
  const cudaError_t e = device_optin(&dev, &optin);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Plan p = choose(n, C, optin);
  info[0] = p.path;
  info[1] = p.G;
  info[2] = p.TJ;
  info[3] = static_cast<int>(p.smem);
  info[4] = p.NT;
  info[5] = p.S;
  return static_cast<int>(cudaSuccess);
}
