// Min-path delineation DP for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel oct_image_segmentation_models_tpu/ops/
// minpath_pallas.py::delineate_pallas (kernel body _build_kernel, launcher
// _run_packed). It computes what ops/minpath.py::delineate_reference in the
// PyTorch package computes, bit for bit, in both tie modes: the column DP
// d_0 = 255 - m_0, d_j = min over candidate offsets [0, +1..+g, -1..-g] of
// (d_{j-1} - m_{j-1}) + 510 - m_j; the zero-weight-edge settle race over the
// packed ancestor chains c1/c2/rw; the per-column settle rank (exact mode);
// the exit-row choice; and the backtrack.
//
// Design. One CTA per map, P = max(32, next_pow2(H)) threads, one row per
// thread. The column loop runs inside the kernel. Each column's state
// (d, pri, m_prev, c1, c2, rw and, in exact mode, the settle rank) lives in
// shared memory, where the +-g neighbours read it: one __syncthreads() before
// the reads and one before the writes. Rows >= H are walled off (never a
// candidate; distance BIG in the rank sort). Exact mode ranks each column by
// a bitonic sort of (key, row) pairs in shared memory followed by the
// scatter rank[row_sorted[i]] = i; the key is the packed 32-bit
// d * 2^FB + (pri_eff * P + ctr) when it fits, else a 64-bit (d, sub) pair.
// Choices are stored as uint8 in an (N, W, H) scratch; after the last
// column the block picks the exit row and one thread walks the choices back.
//
// Bound on the H100. Not bytes: the kernel reads N*W*H map bytes and writes
// N*W*H choice bytes plus 4*N*W row bytes, ~2*N*W*H in all (25 MB at the
// flagship 24 x 1024 x 512, under 10 us at 3.35 TB/s). It is bound by
// latency: W sequential column steps, each a shared-memory exchange with two
// barriers and, in exact mode, a log2(P)*(log2(P)+1)/2-stage bitonic sort
// (45 barriers at P = 512), then a W-step dependent backtrack.
//
// This first design leaves 24 CTAs on 132 SMs at the flagship shape (one map
// each), so most of the card idles; splitting a map's rows across a cluster
// or packing several maps per SM is the first thing a later change fixes.
//
// Two map layouts share the kernel, a template parameter that decides only
// the address of (map, column, row); the exit row reads the last column
// through the same address, so nothing else differs:
// - LayoutWH, (N, W, H): column j, row r at j*H + r. Entry
//   minpath_delineate; replaces minpath_pallas.py::delineate_pallas.
// - LayoutS2D, (N, H/2, W/2, 4) with channels (q_h, q_w): column j, row r at
//   ((r>>1) * W/2 + (j>>1)) * 4 + 2*(r&1) + (j&1). Entry minpath_delineate_s2d;
//   replaces minpath_pallas.py::delineate_pallas_s2d, which packs the s2d
//   maps with a 6-D transpose first. Here nothing is transposed: the kernel
//   reads the s2d maps in place. Neighbouring rows then sit 4*W/2 bytes
//   apart, so a warp's column load touches 16 sectors where LayoutWH touches
//   one. That is accepted in this design; the yardstick it has to beat is the
//   transpose to (N, W, H) followed by the LayoutWH kernel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 30;

struct LayoutWH {
  __device__ static size_t at(int j, int r, int w, int h) {
    return (size_t)j * h + r;
  }
};

struct LayoutS2D {
  __device__ static size_t at(int j, int r, int w, int h) {
    return ((size_t)(r >> 1) * (w >> 1) + (j >> 1)) * 4 + 2 * (r & 1) + (j & 1);
  }
};

struct Params {
  int n, w, h, g;
  int pb, lb, lmask, p1m, p2m, rb, rmask, vlvl;
  int fb;  // shift of the distance in a packed 32-bit rank key
};

__device__ __forceinline__ int cand_offset(int k, int g) {
  return k == 0 ? 0 : (k <= g ? k : -(k - g));
}

// Heap-entry priority of candidate k for target row r (reference neighbour
// order): same row 1, from row+k 1+k, from row-k 1+min(g, row-k)+k.
__device__ __forceinline__ int cand_pri(int k, int r, int g) {
  if (k == 0) return 1;
  if (k <= g) return 1 + k;
  const int i = k - g;
  return 1 + min(g, r - i) + i;
}

__device__ __forceinline__ bool wfield(int c, int shift) {
  return ((c >> shift) & 511) == 510;
}

// Minimum of v over the block. Every thread must call it; it returns the
// same value to all of them.
__device__ __forceinline__ int block_min(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_min_sync(0xffffffffu, v);
  __syncthreads();  // the previous call's readers are done with red
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int out = red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) out = min(out, red[i]);
  return out;
}

template <typename Key>
__device__ __forceinline__ Key make_key(int d, int sub, int fb);

template <>
__device__ __forceinline__ uint32_t make_key<uint32_t>(int d, int sub, int fb) {
  return ((uint32_t)d << fb) | (uint32_t)sub;
}

template <>
__device__ __forceinline__ uint64_t make_key<uint64_t>(int d, int sub, int) {
  return ((uint64_t)(uint32_t)d << 32) | (uint32_t)sub;
}

// Dense rank of the block's keys, written to rank[row]: a bitonic sort of
// (key, row) pairs over P = blockDim.x slots (the same compare-exchange
// network as the JAX reference), then rank[row_sorted[i]] = i. The caller
// has written keys[t] and synchronised.
template <typename Key>
__device__ void settle_rank(Key* keys, int* idx, int* rank) {
  const int t = threadIdx.x, p = blockDim.x;
  idx[t] = t;
  __syncthreads();
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j >= 1; j >>= 1) {
      const int l = t ^ j;
      if (l > t) {
        const Key a = keys[t], b = keys[l];
        const bool asc = (t & k) == 0;
        if (asc ? (a > b) : (a < b)) {
          keys[t] = b;
          keys[l] = a;
          const int ia = idx[t];
          idx[t] = idx[l];
          idx[l] = ia;
        }
      }
      __syncthreads();
    }
  }
  rank[idx[t]] = t;
}

template <bool kExact, typename Key, typename Layout>
__global__ void minpath_kernel(const uint8_t* __restrict__ maps,
                               uint8_t* __restrict__ choices,
                               int32_t* __restrict__ rows_out, Params prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = blockDim.x;
  Key* s_key = reinterpret_cast<Key*>(smem);
  int* s_d = reinterpret_cast<int*>(s_key + p);
  int* s_pri = s_d + p;
  int* s_m = s_pri + p;
  int* s_c1 = s_m + p;
  int* s_c2 = s_c1 + p;
  int* s_rw = s_c2 + p;
  int* s_rank = s_rw + p;
  int* s_idx = s_rank + p;
  int* s_red = s_idx + p;

  const int r = threadIdx.x;
  const int w = prm.w, h = prm.h, g = prm.g;
  const int PB = prm.pb, LB = prm.lb, RB = prm.rb;
  const bool real = r < h;
  const Key key_pad = ~Key(0);
  const size_t map_off = (size_t)blockIdx.x * w * h;
  const uint8_t* mp = maps + map_off;
  uint8_t* cp = choices + map_off;

  // Column 0: entry edge from the virtual all-ones column.
  int m_cur = real ? (int)mp[Layout::at(0, r, w, h)] : 0;
  if (real) {
    const int vl = prm.vlvl;
    s_d[r] = 255 - m_cur;
    s_pri[r] = 1;
    s_m[r] = m_cur;
    s_c1[r] = ((((255 + m_cur) << PB) | 1) << LB) | (r >= 1 ? vl : 0);
    s_c2[r] = ((r >= 2 ? vl : 0) << LB) | (r >= 3 ? vl : 0);
    s_rw[r] = (r << RB) | max(r - 1, 0);
  }
  if (kExact) {
    s_key[r] = real ? make_key<Key>(255 - m_cur, r, prm.fb) : key_pad;
    settle_rank<Key>(s_key, s_idx, s_rank);
  }
  int m_next = (real && w > 1) ? (int)mp[Layout::at(1, r, w, h)] : 0;

  const int n_cand = 2 * g + 1;
  for (int j = 1; j < w; ++j) {
    m_cur = m_next;
    if (real && j + 1 < w) m_next = (int)mp[Layout::at(j + 1, r, w, h)];
    __syncthreads();  // column j-1's state is visible

    int d_new = kBig, pri_new = 0, c1_new = 0, c2_new = 0, rw_new = 0;
    int sort_sub = 0, choice = 0;
    if (real) {
      // Best candidate distance.
      int best = kBig;
      for (int k = 0; k < n_cand; ++k) {
        const int pr = r + cand_offset(k, g);
        if (pr < 0 || pr >= h) continue;
        best = min(best, s_d[pr] - s_m[pr]);
      }
      // Tied candidates; the strict (positive-weight) pop representative:
      // lexicographic min of (priority, rank or c1), first index on ties.
      const bool m_cur255 = m_cur == 255;
      uint64_t tied = 0, zero = 0;
      int bsp = kBig, s_key_min = kBig, s_choice = 0;
      for (int k = 0; k < n_cand; ++k) {
        const int pr = r + cand_offset(k, g);
        if (pr < 0 || pr >= h) continue;
        if (s_d[pr] - s_m[pr] != best) continue;
        tied |= 1ull << k;
        if (m_cur255 && s_m[pr] == 255) {
          zero |= 1ull << k;
          continue;
        }
        const int pk = cand_pri(k, r, g);
        const int sk = kExact ? s_rank[pr] : s_c1[pr];
        if (pk < bsp || (pk == bsp && sk < s_key_min)) {
          bsp = pk;
          s_key_min = sk;
          s_choice = k;
        }
      }
      const int ps_row = r + cand_offset(s_choice, g);
      const int s_pack = ((s_m[ps_row] + m_cur) << PB) | (s_pri[ps_row] + 1);
      const int s_gc1 = s_c1[ps_row];
      const int S_c1 = (s_pack << LB) | (s_gc1 >> LB);
      const int S_c2 = ((s_gc1 & prm.lmask) << LB) | (s_c2[ps_row] >> LB);
      const int S_rw = s_rw[ps_row];

      // Zero-weight entries are valid when their predecessor settles before
      // the strict pop.
      uint64_t valid = tied & ~zero;
      for (int k = 0; k < n_cand; ++k) {
        if (!((zero >> k) & 1)) continue;
        const int pr = r + cand_offset(k, g);
        const int u1 = s_c1[pr], u2 = s_c2[pr], urw = s_rw[pr];
        const bool supp1 = wfield(u1, PB) || wfield(S_c1, PB);
        const bool supp2 = wfield(u2, LB + PB) || wfield(S_c2, LB + PB);
        const bool supp3 = wfield(u2, PB) || wfield(S_c2, PB);
        const int keep1 = ~(supp1 ? prm.p1m : 0) & ~(supp2 ? prm.p2m : 0);
        int u_c1 = u1 & keep1;
        int sv_c1 = S_c1 & keep1;
        const int keep2 = ~(supp3 ? prm.p1m : 0) & ~prm.p2m;
        const int u_c2 = u2 & keep2;
        const int sv_c2 = S_c2 & keep2;
        const bool m1 = (urw >> RB) == (S_rw >> RB);
        const bool m2 = (urw & prm.rmask) == (S_rw & prm.rmask);
        const int merged = (m1 ? prm.p1m : 0) | (m2 ? prm.p2m : 0);
        u_c1 &= ~merged;
        sv_c1 |= merged;
        const int pu = s_pri[pr];
        const bool ok =
            pu < bsp ||
            (pu == bsp && (u_c1 < sv_c1 || (u_c1 == sv_c1 && u_c2 <= sv_c2)));
        if (ok) valid |= 1ull << k;
      }
      if (valid == 0) valid = tied;

      // Pop entry: min priority, then (exact) min predecessor rank or
      // (fast) min (d, pri, c1, c2, row) of the predecessor.
      int best_pri = kBig;
      for (int k = 0; k < n_cand; ++k)
        if ((valid >> k) & 1) best_pri = min(best_pri, cand_pri(k, r, g));
      int entry_ctr = kBig;
      int fd = kBig, fp = kBig, f1 = kBig, f2 = kBig, frow = kBig;
      for (int k = 0; k < n_cand; ++k) {
        if (!((valid >> k) & 1) || cand_pri(k, r, g) != best_pri) continue;
        const int pr = r + cand_offset(k, g);
        if (kExact) {
          if (s_rank[pr] < entry_ctr) {
            entry_ctr = s_rank[pr];
            choice = k;
          }
        } else {
          const int a0 = s_d[pr], a1 = s_pri[pr], a2 = s_c1[pr], a3 = s_c2[pr];
          const bool less =
              a0 < fd ||
              (a0 == fd &&
               (a1 < fp ||
                (a1 == fp &&
                 (a2 < f1 || (a2 == f1 && (a3 < f2 || (a3 == f2 && pr < frow)))))));
          if (less) {
            fd = a0;
            fp = a1;
            f1 = a2;
            f2 = a3;
            frow = pr;
            choice = k;
          }
        }
      }
      const int pc = r + cand_offset(choice, g);
      const int pm = s_m[pc], pp = s_pri[pc], gc1 = s_c1[pc];
      if (kExact) {
        const bool zero_chosen = (zero >> choice) & 1;
        const int pri_eff = zero_chosen ? max(best_pri, pp) : best_pri;
        sort_sub = pri_eff * p + entry_ctr;
      }
      d_new = best + 510 - m_cur;
      pri_new = best_pri;
      const int c_pack = ((pm + m_cur) << PB) | (pp + 1);
      c1_new = (c_pack << LB) | (gc1 >> LB);
      c2_new = ((gc1 & prm.lmask) << LB) | (s_c2[pc] >> LB);
      rw_new = (pc << RB) | (s_rw[pc] >> RB);
      cp[(size_t)j * h + r] = (uint8_t)choice;
    }
    __syncthreads();  // every read of column j-1's state is done
    if (real) {
      s_d[r] = d_new;
      s_pri[r] = pri_new;
      s_m[r] = m_cur;
      s_c1[r] = c1_new;
      s_c2[r] = c2_new;
      s_rw[r] = rw_new;
    }
    if (kExact) {
      s_key[r] = real ? make_key<Key>(d_new, sort_sub, prm.fb) : key_pad;
      settle_rank<Key>(s_key, s_idx, s_rank);
    }
  }
  __syncthreads();

  // Exit row: the earliest-settled last-column node among those of minimal
  // exit distance (exact: settle rank; fast: (d, pri, c1, c2)), then the
  // top row. Every thread calls block_min (it holds barriers), so no call
  // sits behind a short-circuit.
  const int exit_d = real ? s_d[r] + 255 - s_m[r] : kBig;
  const int exit_min = block_min(exit_d, s_red);
  bool tied_e = real && exit_d == exit_min;
  if (kExact) {
    const int rk = real ? s_rank[r] : kBig;
    const int rk_min = block_min(tied_e ? rk : kBig, s_red);
    tied_e = tied_e && rk == rk_min;
  } else {
    const int keys[4] = {real ? s_d[r] : kBig, real ? s_pri[r] : kBig,
                         real ? s_c1[r] : kBig, real ? s_c2[r] : kBig};
    for (int i = 0; i < 4; ++i) {
      const int key_min = block_min(tied_e ? keys[i] : kBig, s_red);
      tied_e = tied_e && keys[i] == key_min;
    }
  }
  const int r_last = block_min(tied_e ? r : kBig, s_red);

  // Backtrack over the stored choices; block_min's barriers made every
  // thread's choice stores visible to thread 0.
  if (r == 0) {
    int32_t* out = rows_out + (size_t)blockIdx.x * w;
    int row = r_last;
    out[w - 1] = row;
    for (int j = w - 1; j >= 1; --j) {
      row += cand_offset(cp[(size_t)j * h + row], g);
      out[j - 1] = row;
    }
  }
}

template <bool kExact, typename Key, typename Layout>
cudaError_t launch(const uint8_t* maps, uint8_t* choices, int32_t* rows,
                   const Params& prm, int p, cudaStream_t stream) {
  const size_t smem = (size_t)p * sizeof(Key) + (size_t)8 * p * sizeof(int) +
                      32 * sizeof(int);
  minpath_kernel<kExact, Key, Layout><<<prm.n, p, smem, stream>>>(maps, choices,
                                                                  rows, prm);
  return cudaGetLastError();
}

template <typename Layout>
int delineate(const uint8_t* maps, uint8_t* choices, int32_t* rows, int n, int w,
              int h, int max_grad, int exact, void* stream) {
  if (n <= 0 || w <= 0 || h <= 0 || h > 1024 || max_grad < 0 || max_grad > 30)
    return (int)cudaErrorInvalidValue;
  int p = 32;
  while (p < h) p <<= 1;
  Params prm;
  prm.n = n;
  prm.w = w;
  prm.h = h;
  prm.g = max_grad;
  int pb = 0;
  for (int v = 3 + 2 * max_grad; v; v >>= 1) ++pb;
  prm.pb = pb;
  prm.lb = 9 + pb;
  prm.lmask = (1 << prm.lb) - 1;
  prm.p1m = ((1 << pb) - 1) << prm.lb;
  prm.p2m = (1 << pb) - 1;
  int hb = 0;
  for (int v = h - 1; v; v >>= 1) ++hb;
  prm.rb = hb > 9 ? hb : 9;
  prm.rmask = (1 << prm.rb) - 1;
  prm.vlvl = (510 << pb) | 1;
  // Rank sub-keys are pri_eff * P + ctr < (2 + 2g) * P <= 2^fb. The packed
  // 32-bit key holds d_max << fb below the all-ones pad key when it fits.
  int fb = 0;
  while ((1ll << fb) < (long long)(2 + 2 * max_grad) * p) ++fb;
  prm.fb = fb;
  const long long d_max = 255 + 510ll * (w - 1);
  const bool pack32 = fb < 32 && ((d_max + 1) << fb) <= 0xffffffffll;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!exact)
    return (int)launch<false, uint32_t, Layout>(maps, choices, rows, prm, p, s);
  if (pack32)
    return (int)launch<true, uint32_t, Layout>(maps, choices, rows, prm, p, s);
  return (int)launch<true, uint64_t, Layout>(maps, choices, rows, prm, p, s);
}

}  // namespace

// maps (n, w, h) uint8, choices (n, w, h) uint8 scratch, rows (n, w) int32,
// all contiguous on the current device. Returns the cudaError_t of the launch.
extern "C" int minpath_delineate(const uint8_t* maps, uint8_t* choices,
                                 int32_t* rows, int n, int w, int h,
                                 int max_grad, int exact, void* stream) {
  return delineate<LayoutWH>(maps, choices, rows, n, w, h, max_grad, exact, stream);
}

// maps (n, h/2, w/2, 4) uint8 in s2d layout, channels (q_h, q_w); w and h
// even. choices and rows as for minpath_delineate.
extern "C" int minpath_delineate_s2d(const uint8_t* maps, uint8_t* choices,
                                     int32_t* rows, int n, int w, int h,
                                     int max_grad, int exact, void* stream) {
  if (w % 2 || h % 2) return (int)cudaErrorInvalidValue;
  return delineate<LayoutS2D>(maps, choices, rows, n, w, h, max_grad, exact,
                              stream);
}
