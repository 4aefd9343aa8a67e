// Binary cutpoint elliptical-slice update: one whole ESS step per lane.
//
// Replaces the TPU kernel gpirt_tpu/ops/pallas_threshold.py ::
// binary_threshold_ess_pallas (body `_kernel`). A lane is one
// (chain k, horizon h, item j) interior cutpoint t_1; its log-likelihood is
//
//     ll(t) = sum_i obs_i * log(0.5 * (1 + erf(sgn_i * (t - g_i) * c)) + 1e-6)
//
// over the n respondents i, with sgn = +1 for y = 1, -1 for y = 2 and
// obs = (y > 0), and c = c[k] the scale of the lane's chain: 1/sqrt(2) over
// sqrt(T), one value for every chain in a plain or SMC sweep and the
// chain's own under parallel tempering, where each lane keeps its
// temperature. A lane reads c[k] once, before its rounds. The slice level
// is ll(t0) + log u, each proposal is
// t0 cos(eps) + nu sin(eps), and the bracket starts at [eps - 2 pi, 2 pi]
// and shrinks toward 0 with the uniform rs[r, lane] of round r. A lane
// still active after R rounds keeps t0 (the identity move of the round cap).
//
// What bounds it on an H100. senate116's main path has K = 64 chains,
// H = 1, n = 100, m = 418: L = 26,752 lanes over 39,402 observed cells, so
// one ll of every lane is 2.52 M site evaluations. At a sampling sweep's
// state the mean lane takes 2.65 proposals (p99 10, max 18), so a launch
// evaluates 9.2 M sites: at ~20 FP32 operations a site (erff and logf
// included) 0.18 GFLOP, 2.7 us at 67 TFLOP/s; one MUFU.EX2 a site (erff;
// logf is a polynomial) is 2.2 us on the special-function pipes. It moves
// 11.6 MB (g 10.7 MB once, y, the lane vectors, the rs values a shrink
// uses, the output): 3.5 us at 3.35 TB/s, the bound. chip_smoke.py counts
// each launch's work from its inputs and prints the bound beside the time.
//
// Design, against what held the one-thread-per-lane kernel at 1-2% of it
// (a serial loop over the n sites, ~6 warps an SM, every round reloading
// the lane's column, and each warp waiting for its slowest lane):
//   * a group of G threads per lane splits the site sum; the partial sums
//     meet by __shfl_xor_sync (G <= 32) or through shared memory (G = 256),
//     and the butterfly leaves the same bits in every thread, so the whole
//     group takes the same accept decision with no broadcast. A round's
//     critical path is ceil(n_obs / G) site evaluations plus log2(G)
//     shuffles, and the launch has G times the threads in flight. G is
//     chosen from n at launch: 8 threads up to n = 32, a warp up to 256
//     (senate116's n = 100, where it beat 8, 16 and 256 threads in
//     PERF.md's timings) and the whole block up to 2048;
//   * a block takes a tile of neighbouring items of one (k, h), reads the
//     (n x tile) slab of g and y once, row by row (coalesced, no padding of
//     g), and packs each column's observed sites to the front in shared
//     memory. Each thread then holds its ceil(n_obs / G) sites in registers
//     as (g, sgn * c): the round loop does no global load but the round's
//     shrink uniform, issued before the ll that precedes its use, and no
//     branch on y;
//   * a group leaves the loop as soon as its lane accepts and takes the
//     tile's next item from a queue in shared memory, so a block waits for
//     the tile's total rounds over its warps rather than for its slowest
//     lane;
//   * past the register cap (n > 2048) the tile path: a block of 1024
//     threads holds a tile of 8 items' whole (n x 8) slab in shared memory
//     (g a float and y a byte a site, ~202 KB at n = 5000; each item's
//     column packed to its observed sites), read from device memory once,
//     row by row (a row of 8 items is one 32-byte sector), and four groups
//     of 256 threads take the tile's items from a queue. Blocks run with
//     the chain fastest, so the chains' blocks of one tile share y's slab
//     in L2. At the synthetic state (64 chains, n = 5000, m = 1000, 8.08
//     ll a lane: 2.33 G site evaluations) the bound is 0.69 ms by
//     operations at 20 a site, but the build's site loop issues 59 SASS
//     instructions a site (erff and logf as torch rounds them; counted by
//     scripts/torch_threshold_ess_measure.py --sass), so the issue rate
//     alone needs ~4.1 ms, and the slab's read (~1.9 ms) does not overlap
//     the rounds at one block an SM: 7.25 ms, against 47.3 ms for the
//     streaming kernel there on an H100 (PERF.md);
//   * past the tile's capacity (one block's 232,448 bytes: n = 5760) a
//     block of 256 threads a lane streams its sites from global memory
//     each round, correct at any n.
// Every float operation that the plain PyTorch version rounds on its own
// is rounded on its own here too (__fmul_rn and friends stop contraction
// into FMAs), so a site's value matches torch's bit for bit and only the
// order of the site sum differs.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError() of
// its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kFloor = 1e-6f;
constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
// Items in a tile for a warp per lane: the 8 warps of a block share 16
// through the queue of ess_regs_kernel (8 gives each warp one item).
constexpr int kTile32 = 16;

// One site's term: log(0.5 * (1 + erf(sc * (t - g))) + 1e-6), sc = sgn * c.
__device__ __forceinline__ float site_ll(float t, float g, float sc) {
  const float x = __fmul_rn(sc, __fsub_rn(t, g));
  return logf(__fadd_rn(__fmul_rn(0.5f, __fadd_rn(1.0f, erff(x))), kFloor));
}

// The lanes of this thread's warp that belong to its group of G <= 32.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  return G == 32 ? 0xffffffffu
                 : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
}

// A barrier of the G threads (whole warps) of this thread's group: a named
// barrier of the group's own (ids 1, 2, ...; 0 is __syncthreads').
template <int G>
__device__ __forceinline__ void group_sync() {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + static_cast<int>(threadIdx.x) / G), "r"(G)
               : "memory");
}

// Sum over the G threads of a group in a block of NT; every thread of the
// group gets the same bits. G = NT is the whole block: `red` holds two rows
// of NT / 32 partial sums, alternated by `parity` so that one __syncthreads
// a call suffices. A narrower group of whole warps does the same through
// its own slots of `red` and group_sync.
template <int G, int NT = kBlock>
__device__ __forceinline__ float group_sum(float v, float* red, int& parity) {
  constexpr int NW = NT / 32;
  if constexpr (G <= 32) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      v += __shfl_xor_sync(group_mask<G>(), v, o, G);
    return v;
  } else if constexpr (G < NT) {
    static_assert(G % 32 == 0 && NT % G == 0, "a group of whole warps");
    constexpr int W = G / 32;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const int warp = threadIdx.x >> 5;
    float* buf = red + parity * NW + (warp / W) * W;
    parity ^= 1;
    if ((threadIdx.x & 31) == 0) buf[warp % W] = v;
    group_sync<G>();
    float s = buf[0];
#pragma unroll
    for (int w = 1; w < W; ++w) s += buf[w];
    return s;
  } else {
    static_assert(G == NT, "a group wider than a warp is the block");
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    float* buf = red + parity * NW;
    parity ^= 1;
    if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
    __syncthreads();
    float s = buf[0];
#pragma unroll
    for (int w = 1; w < NW; ++w) s += buf[w];
    return s;
  }
}

// The ESS rounds of one lane, run alike by the G threads of its group;
// `partial(t)` is this thread's share of ll(t). Returns the new cutpoint.
template <int G, int NT = kBlock, typename Partial>
__device__ __forceinline__ float ess_lane(
    Partial partial, float* red, int64_t lane, int64_t L, int R,
    const float* __restrict__ t1, const float* __restrict__ nu,
    const float* __restrict__ logu, const float* __restrict__ eps0,
    const float* __restrict__ rs) {
  int parity = 0;
  const float t0 = __ldg(t1 + lane);
  const float v = __ldg(nu + lane);
  float eps = __ldg(eps0 + lane);
  const float log_y =
      __fadd_rn(group_sum<G, NT>(partial(t0), red, parity), __ldg(logu + lane));
  float eps_min = __fsub_rn(eps, kTwoPi), eps_max = kTwoPi;
  for (int r = 0; r < R; ++r) {
    const float u = __ldg(rs + r * L + lane);  // needed only after the ll
    float sn, cs;
    sincosf(eps, &sn, &cs);
    const float prop = __fadd_rn(__fmul_rn(t0, cs), __fmul_rn(v, sn));
    if (group_sum<G, NT>(partial(prop), red, parity) > log_y) return prop;
    if (eps < 0.0f) eps_min = eps; else eps_max = eps;
    eps = __fadd_rn(eps_min, __fmul_rn(u, __fsub_rn(eps_max, eps_min)));
  }
  return t0;
}

// Register path: a block holds a tile of TJ neighbouring items of one
// (k, h) and kBlock / G groups of G threads, with up to S observed sites a
// thread (n <= G * S). With as many groups as items each group takes one;
// with fewer, a group that is done takes the tile's next item from a queue
// in shared memory, so the block waits for the tile's total rounds over
// its groups and not for its slowest lane.
template <int G, int S, int TJ>
__global__ void __launch_bounds__(kBlock) ess_regs_kernel(
    const float* __restrict__ g, const int32_t* __restrict__ y,
    const float* __restrict__ t1, const float* __restrict__ nu,
    const float* __restrict__ logu, const float* __restrict__ eps0,
    const float* __restrict__ rs, const float* __restrict__ c,
    float* __restrict__ out, int H, int n, int m, int R) {
  constexpr int NG = kBlock / G;  // groups in the block
  static_assert(TJ % NG == 0 && (G <= 32 || TJ == NG), "tile of whole groups");
  constexpr int P = TJ + 1;  // odd row pitch: a column walk is conflict-free
  extern __shared__ float smem[];
  float* sg = smem;                                     // (n, P) g
  float* ss = sg + static_cast<int64_t>(n) * P;         // (n, P) sgn, 0 = missing
  int* scnt = reinterpret_cast<int*>(ss + static_cast<int64_t>(n) * P);  // (TJ)
  int* next = scnt + TJ;                                // the queue's head
  float* red = reinterpret_cast<float*>(next + 1);      // (2, kWarps)

  const int tiles = (m + TJ - 1) / TJ;
  const int64_t kh = blockIdx.x / tiles;
  const int j0 = static_cast<int>(blockIdx.x % tiles) * TJ;
  const int tile = min(TJ, m - j0);  // items of this tile
  const int64_t h = kh % H;
  const int64_t L = static_cast<int64_t>(gridDim.x / tiles) * m;
  const float ck = __ldg(c + kh / H);  // the chain's scale

  // 1. the (n x tile) slab, row by row: neighbouring items on neighbouring
  //    threads
  const float* gb = g + kh * n * m + j0;
  const int32_t* yb = y + h * n * m + j0;
  for (int idx = threadIdx.x; idx < n * TJ; idx += kBlock) {
    const int i = idx / TJ, jj = idx - i * TJ;
    if (jj < tile) {
      const int64_t off = static_cast<int64_t>(i) * m + jj;
      const int32_t yy = __ldg(yb + off);
      sg[i * P + jj] = __ldg(gb + off);
      ss[i * P + jj] = yy > 0 ? (yy == 1 ? 1.0f : -1.0f) : 0.0f;
    }
  }
  if (threadIdx.x == 0) *next = NG;
  __syncthreads();

  // 2. each column's observed sites packed to its front, in row order;
  //    a warp packs kCols columns, 32 rows at a time
  const int warp = threadIdx.x >> 5, l32 = threadIdx.x & 31;
  constexpr int kCols = TJ >= kWarps ? TJ / kWarps : 1;
  for (int cc = 0; cc < kCols; ++cc) {
    const int jj = warp * kCols + cc;
    if (jj >= TJ) break;
    int cnt = 0;
    if (jj < tile) {
      for (int base = 0; base < n; base += 32) {
        const int i = base + l32;
        float gv = 0.0f, sv = 0.0f;
        if (i < n) {
          gv = sg[i * P + jj];
          sv = ss[i * P + jj];
        }
        const unsigned obs = __ballot_sync(0xffffffffu, sv != 0.0f);
        __syncwarp();  // the chunk is read before any of it is overwritten
        if (sv != 0.0f) {
          const int pos = cnt + __popc(obs & ((1u << l32) - 1u));
          sg[pos * P + jj] = gv;
          ss[pos * P + jj] = sv;
        }
        cnt += __popc(obs);
      }
    }
    if (l32 == 0) scnt[jj] = cnt;
  }
  __syncthreads();

  // 3. per item: its sites into registers (packed sites rank, rank + G,
  //    ...), its ESS rounds, its output
  const int grp = threadIdx.x / G, rank = threadIdx.x % G;
  for (int jj = grp; jj < tile;) {
    const int cnt = scnt[jj];
    const int mine = cnt > rank ? (cnt - rank + G - 1) / G : 0;
    float gr[S], sr[S];
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int p = rank + G * q;
      gr[q] = q < mine ? sg[p * P + jj] : 0.0f;
      sr[q] = q < mine ? ss[p * P + jj] * ck : 0.0f;
    }
    auto partial = [&](float t) {
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < S; ++q)
        if (q < mine) acc += site_ll(t, gr[q], sr[q]);
      return acc;
    };
    const int64_t lane = kh * m + j0 + jj;
    const float x = ess_lane<G>(partial, red, lane, L, R, t1, nu, logu, eps0, rs);
    if (rank == 0) out[lane] = x;
    if constexpr (NG == TJ) {
      break;
    } else {
      int nj = 0;
      if (rank == 0) nj = atomicAdd(next, 1);
      jj = __shfl_sync(group_mask<G>(), nj, 0, G);
    }
  }
}

// Streaming path for any n: a block per lane reads its column from global
// memory every round.
__global__ void __launch_bounds__(kBlock) ess_stream_kernel(
    const float* __restrict__ g, const int32_t* __restrict__ y,
    const float* __restrict__ t1, const float* __restrict__ nu,
    const float* __restrict__ logu, const float* __restrict__ eps0,
    const float* __restrict__ rs, const float* __restrict__ c,
    float* __restrict__ out, int H, int n, int m, int R) {
  __shared__ float red[2 * kWarps];
  const int64_t lane = blockIdx.x;
  const int64_t L = gridDim.x;
  const int64_t kh = lane / m;
  const int64_t j = lane % m;
  const float ck = __ldg(c + kh / H);  // the chain's scale
  const float* gl = g + kh * n * m + j;
  const int32_t* yl = y + (kh % H) * n * m + j;
  auto partial = [&](float t) {
    float acc = 0.0f;
    for (int i = threadIdx.x; i < n; i += kBlock) {
      const int64_t off = static_cast<int64_t>(i) * m;
      const int32_t yy = __ldg(yl + off);
      if (yy > 0) acc += site_ll(t, __ldg(gl + off), yy == 1 ? ck : -ck);
    }
    return acc;
  };
  const float x = ess_lane<kBlock>(partial, red, lane, L, R, t1, nu, logu, eps0, rs);
  if (threadIdx.x == 0) out[lane] = x;
}

// Tile path, past the register cap (n > 2048) up to the capacity of one
// block's shared memory: a block of kTileNT threads takes a tile of kTileJ
// neighbouring items of one (k, h) and holds the tile's whole (n x kTileJ)
// slab on chip, g as floats and y as a byte a site (1 = yes, 2 = no,
// 0 = missing), each item in a column of its own, packed to its observed
// sites. Groups of kTileG threads then run the items' rounds from shared
// memory, taking the tile's items from a queue as the register path does.
// The blocks are ordered with (k, h) fastest, so that the chains' blocks of
// one tile run together and share y's slab in L2. PERF.md times the other
// designs that were tried.
constexpr int kTileNT = 1024;  // threads a block
constexpr int kTileG = 256;    // threads a lane
constexpr int kTileJ = 8;      // items a tile: a row of the slab is one 32-byte sector

__global__ void __launch_bounds__(kTileNT) ess_tile_kernel(
    const float* __restrict__ g, const int32_t* __restrict__ y,
    const float* __restrict__ t1, const float* __restrict__ nu,
    const float* __restrict__ logu, const float* __restrict__ eps0,
    const float* __restrict__ rs, const float* __restrict__ c,
    float* __restrict__ out, int KH, int H, int n, int m, int R, int pf, int pb) {
  constexpr int NT = kTileNT, G = kTileG, TJ = kTileJ;
  constexpr int NW = NT / 32;   // warps in the block
  constexpr int NG = NT / G;    // groups in the block
  constexpr int RP = NT / TJ;   // slab rows a pass of the block
  constexpr int U = 8;          // passes in flight a thread
  static_assert(32 % TJ == 0 && G % 32 == 0 && NG < TJ,
                "whole rows a warp, groups of whole warps, fewer groups than items");
  extern __shared__ float smem[];
  float* sg = smem;                                          // (TJ, pf) g
  float* red = sg + TJ * pf;                                 // (2, NW)
  int* scnt = reinterpret_cast<int*>(red + 2 * NW);          // (TJ)
  int* next = scnt + TJ;                                     // the queue's head
  int* gq = next + 1;                                        // (NW) a group's item
  unsigned char* sb = reinterpret_cast<unsigned char*>(gq + NW);  // (TJ, pb) y

  const int64_t kh = blockIdx.x % KH;
  const int j0 = static_cast<int>(blockIdx.x / KH) * TJ;
  const int tile = min(TJ, m - j0);
  const int64_t h = kh % H;
  const int64_t L = static_cast<int64_t>(KH) * m;
  const float ck = __ldg(c + kh / H);  // the chain's scale

  // 1. the slab, row by row (neighbouring items on neighbouring threads, a
  //    row of 8 items one 32-byte sector), U rows a thread in flight; row i
  //    of item jj goes to its column's slot i (pf and pb are chosen so that
  //    a warp's stores meet no bank conflict)
  const int jl = threadIdx.x % TJ;
  if (jl < tile) {
    const float* gc = g + kh * n * m + j0 + jl;
    const int32_t* yc = y + h * n * m + j0 + jl;
    float* cg = sg + jl * pf;
    unsigned char* cb = sb + jl * pb;
    auto code = [](int32_t v) -> unsigned char { return v > 0 ? (v == 1 ? 1 : 2) : 0; };
    for (int i = threadIdx.x / TJ; i < n; i += U * RP) {
      float gv[U];
      int32_t yv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i + u * RP < n) {
          const int64_t off = static_cast<int64_t>(i + u * RP) * m;
          gv[u] = __ldg(gc + off);
          yv[u] = __ldg(yc + off);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i + u * RP < n) {
          cg[i + u * RP] = gv[u];
          cb[i + u * RP] = code(yv[u]);
        }
      }
    }
  }
  if (threadIdx.x == 0) *next = NG;
  __syncthreads();

  // 2. each column packed in place to its observed sites, in row order, by
  //    a warp: PK chunks of 32 rows read, then written to their places
  const int warp = threadIdx.x >> 5, l32 = threadIdx.x & 31;
  constexpr int PK = 4;
  for (int jj = warp; jj < tile; jj += NW) {
    float* cg = sg + jj * pf;
    unsigned char* cb = sb + jj * pb;
    int cnt = 0;
    for (int base = 0; base < n; base += 32 * PK) {
      float gv[PK];
      unsigned char yv[PK];
#pragma unroll
      for (int q = 0; q < PK; ++q) {
        const int i = base + 32 * q + l32;
        gv[q] = i < n ? cg[i] : 0.0f;
        yv[q] = i < n ? cb[i] : 0;
      }
      __syncwarp();  // the chunks are read before any of them is overwritten
#pragma unroll
      for (int q = 0; q < PK; ++q) {
        const unsigned obs = __ballot_sync(0xffffffffu, yv[q] != 0);
        if (yv[q] != 0) {
          const int pos = cnt + __popc(obs & ((1u << l32) - 1u));
          cg[pos] = gv[q];
          cb[pos] = yv[q];
        }
        cnt += __popc(obs);
      }
    }
    if (l32 == 0) scnt[jj] = cnt;
  }
  __syncthreads();

  // 3. per item: its ESS rounds over its packed column (sites rank,
  //    rank + G, ...), its output; then the tile's next item, passed to the
  //    group through its slot of gq (the slot's next write is a sum later)
  const int grp = threadIdx.x / G, rank = threadIdx.x % G;
  for (int jj = grp; jj < tile;) {
    const int cnt = scnt[jj];
    const float* cg = sg + jj * pf;
    const unsigned char* cb = sb + jj * pb;
    auto partial = [&](float t) {
      float acc = 0.0f;
#pragma unroll 4
      for (int p = rank; p < cnt; p += G)
        acc += site_ll(t, cg[p], cb[p] == 1 ? ck : -ck);
      return acc;
    };
    const int64_t lane = kh * m + j0 + jj;
    const float x = ess_lane<G, NT>(partial, red, lane, L, R, t1, nu, logu, eps0, rs);
    if (rank == 0) out[lane] = x;
    if (rank == 0) gq[grp] = atomicAdd(next, 1);
    group_sync<G>();
    jj = gq[grp];
  }
}

constexpr int kMaxDevices = 64;
constexpr int kRegsMaxN = 2048;  // the register path's largest n

enum Path { kPathRegs = 0, kPathTile = 1, kPathStream = 2 };

// How a launch at n runs: the path, its threads a lane (G), sites a thread
// in registers (S, register path), items a block (TJ), threads a block,
// the block's dynamic shared memory, and the tile path's column pitches.
struct Plan {
  Path path;
  int G, S, TJ, threads;
  size_t smem;
  int pf, pb;
};

// The register path's dynamic shared memory for n rows of TJ items.
size_t regs_smem(int n, int TJ) {
  return (2 * static_cast<size_t>(n) * (TJ + 1) + TJ + 1 + 2 * kWarps) * sizeof(float);
}

// The tile path's column pitches for n rows (g in floats, y in bytes),
// padded so that a warp's stores of 32 / kTileJ rows of each item fall in
// distinct banks, and its dynamic shared memory in bytes.
size_t tile_smem(int n, int* pf, int* pb) {
  *pf = (n + 31) / 32 * 32 + 32 / kTileJ;
  *pb = (n + 127) / 128 * 128 + 32 / kTileJ;
  return (static_cast<size_t>(kTileJ) * *pf + 3 * (kTileNT / 32) + kTileJ + 1) *
             sizeof(float) +
         static_cast<size_t>(kTileJ) * *pb;
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

// The path at n on a device whose blocks may opt in to `optin` bytes of
// shared memory: a group of 8 threads a lane up to n = 32, a warp up to 256
// and the block up to 2048, each with the sites in registers; past that the
// tile path as far as one block's shared memory holds the slab, and the
// streaming path beyond.
Plan choose(int n, int optin) {
  if (n <= 32) return {kPathRegs, 8, 4, kBlock / 8, kBlock, regs_smem(n, kBlock / 8), 0, 0};
  if (n <= 128) return {kPathRegs, 32, 4, kTile32, kBlock, regs_smem(n, kTile32), 0, 0};
  if (n <= 256) return {kPathRegs, 32, 8, kTile32, kBlock, regs_smem(n, kTile32), 0, 0};
  if (n <= kRegsMaxN) return {kPathRegs, kBlock, 8, 1, kBlock, regs_smem(n, 1), 0, 0};
  Plan p{kPathTile, kTileG, 0, kTileJ, kTileNT, 0, 0, 0};
  p.smem = tile_smem(n, &p.pf, &p.pb);
  if (p.smem <= static_cast<size_t>(optin)) return p;
  return {kPathStream, kBlock, 0, 1, kBlock, 0, 0, 0};
}

// The plan at n on the current device; the device is read only past the
// register path, whose launches need none of it.
cudaError_t plan_at(int n, Plan* p, int* dev, int* optin) {
  *dev = 0;
  *optin = 0;
  if (n > kRegsMaxN) {
    const cudaError_t e = device_optin(dev, optin);
    if (e != cudaSuccess) return e;
  }
  *p = choose(n, *optin);
  return cudaSuccess;
}

// The largest n the tile path holds in `optin` bytes a block.
int tile_capacity(int optin) {
  int pf, pb, n = optin / (kTileJ * 5);
  while (n > 0 && tile_smem(n, &pf, &pb) > static_cast<size_t>(optin)) --n;
  while (tile_smem(n + 1, &pf, &pb) <= static_cast<size_t>(optin)) ++n;
  return n;
}

template <int G, int S, int TJ>
int launch_regs(const float* g, const int32_t* y, const float* t1,
                const float* nu, const float* logu, const float* eps0,
                const float* rs, const float* c, float* out, int K, int H,
                int n, int m, int R, cudaStream_t stream, const Plan& p) {
  const int64_t blocks = static_cast<int64_t>(K) * H * ((m + TJ - 1) / TJ);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  ess_regs_kernel<G, S, TJ><<<static_cast<unsigned>(blocks), kBlock, p.smem, stream>>>(
      g, y, t1, nu, logu, eps0, rs, c, out, H, n, m, R);
  return static_cast<int>(cudaGetLastError());
}

int launch_tile(const float* g, const int32_t* y, const float* t1,
                const float* nu, const float* logu, const float* eps0,
                const float* rs, const float* c, float* out, int K, int H,
                int n, int m, int R, cudaStream_t stream, const Plan& p, int dev,
                int optin) {
  static bool raised[kMaxDevices] = {};
  const int64_t KH = static_cast<int64_t>(K) * H;
  const int64_t blocks = KH * ((m + kTileJ - 1) / kTileJ);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (!raised[dev]) {  // once a device, before any capture of a launch
    const cudaError_t e = cudaFuncSetAttribute(
        ess_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised[dev] = true;
  }
  ess_tile_kernel<<<static_cast<unsigned>(blocks), kTileNT, p.smem, stream>>>(
      g, y, t1, nu, logu, eps0, rs, c, out, static_cast<int>(KH), H, n, m, R, p.pf, p.pb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch on the path that choose() gives for n. c is a (K,) vector, one
// scale a chain.
extern "C" int gpirt_binary_threshold_ess(
    const float* g, const int32_t* y, const float* t1, const float* nu,
    const float* logu, const float* eps0, const float* rs, const float* c,
    float* out, int K, int H, int n, int m, int R, void* stream) {
  const int64_t L = static_cast<int64_t>(K) * H * m;
  if (L == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Plan p;
  int dev, optin;
  const cudaError_t e = plan_at(n, &p, &dev, &optin);
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (p.path) {
    case kPathRegs:
      if (p.G == 8) return launch_regs<8, 4, kBlock / 8>(g, y, t1, nu, logu, eps0, rs, c, out, K, H, n, m, R, st, p);
      if (p.G == 32 && p.S == 4) return launch_regs<32, 4, kTile32>(g, y, t1, nu, logu, eps0, rs, c, out, K, H, n, m, R, st, p);
      if (p.G == 32) return launch_regs<32, 8, kTile32>(g, y, t1, nu, logu, eps0, rs, c, out, K, H, n, m, R, st, p);
      return launch_regs<kBlock, 8, 1>(g, y, t1, nu, logu, eps0, rs, c, out, K, H, n, m, R, st, p);
    case kPathTile:
      return launch_tile(g, y, t1, nu, logu, eps0, rs, c, out, K, H, n, m, R, st, p, dev, optin);
    default:
      if (L > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
      ess_stream_kernel<<<static_cast<unsigned>(L), kBlock, 0, st>>>(
          g, y, t1, nu, logu, eps0, rs, c, out, H, n, m, R);
      return static_cast<int>(cudaGetLastError());
  }
}

// The plan that the entry above launches at n on the current device:
// info[0] the path (0 registers, 1 tile, 2 streaming), info[1] the threads
// a lane, info[2] the items a block, info[3] the block's dynamic shared
// memory in bytes, info[4] the tile path's largest n, info[5] the threads a
// block.
extern "C" int gpirt_binary_threshold_ess_plan(int n, int* info) {
  int dev, optin;
  const cudaError_t e = device_optin(&dev, &optin);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Plan p = choose(n, optin);
  info[0] = p.path;
  info[1] = p.G;
  info[2] = p.TJ;
  info[3] = static_cast<int>(p.smem);
  info[4] = tile_capacity(optin);
  info[5] = p.threads;
  return static_cast<int>(cudaSuccess);
}
