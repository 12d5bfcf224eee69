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
// Bound on the H100. Not bytes: the kernel reads N*W*H map bytes and writes
// 4*N*W row bytes (13 MB at the flagship 24 x 1024 x 512, 4 us at 3.35
// TB/s). It is bound by latency: W sequential column steps, each an exchange
// of the +-g neighbours' state and, in exact mode, a rank of the column's H
// keys, then a W-step dependent backtrack.
//
// Design. One CTA per map, P = max(32, next_pow2(H)) threads, one row per
// thread; the column loop runs inside the kernel. Per column:
// - The state of column j (d, pri, m, c1, c2, rw and the settle rank) is
//   written to one of two shared-memory buffers by column parity, so the
//   column reads j-1's buffer while it writes j's: one __syncthreads() per
//   column, not one before the reads and one before the writes.
// - max_grad 1, the serving paths' value, is a compile-time variant (kG =
//   1): the candidate loops unroll, each neighbour's fields are loaded
//   once, and the tie rules run without branches on the loop count. Any
//   other max_grad runs the same code with the count at run time (kG = 0).
// - Exact mode ranks the column's keys (unique among real rows:
//   ops/minpath.py::_dense_rank) with a bitonic network of (key, row)
//   pairs, the same network as the JAX reference. Its stages within a warp
//   (distance < 32) exchange by warp shuffles in registers; only the
//   log2(P/32) * (log2(P/32) + 1) / 2 stages across warps go through shared
//   memory, each behind one barrier (10 at P = 512, against 45 before). The
//   key is the packed 32-bit d * 2^FB + (pri_eff * P + ctr) when it fits,
//   else a 64-bit (d, sub) pair.
// - The map is read four columns ahead into registers.
// - The choices (an index into the candidate list) go to shared memory as
//   bit planes, one __ballot_sync word per warp, column and bit (2 bits at
//   max_grad 1: 128 KB for W = 1024 at P = 512), and the backtrack reads them
//   there. Shapes whose planes do not fit in shared memory store uint8
//   choices in the (N, W, H) device scratch instead (kSmemChoices = false);
//   the C entry picks the store by shape.
// After the last column the block picks the exit row and one thread walks
// the choices back.
//
// Grid: one CTA per map, so 24 CTAs fill 24 of 132 SMs at the flagship
// shape; splitting a map's rows across a cluster is left for a later change.
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
//   reads the s2d maps in place; neighbouring rows sit 4*W/2 bytes apart, so
//   a warp's column load touches 16 sectors, issued four columns ahead.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 227 * 1024;

struct LayoutWH {
  static constexpr bool kPaired = false;
  __device__ static size_t at(int j, int r, int w, int h) {
    return (size_t)j * h + r;
  }
};

struct LayoutS2D {
  // Columns 2i and 2i+1 of a row are neighbouring bytes: one 16-bit load.
  static constexpr bool kPaired = true;
  __device__ static size_t at(int j, int r, int w, int h) {
    return ((size_t)(r >> 1) * (w >> 1) + (j >> 1)) * 4 + 2 * (r & 1) + (j & 1);
  }
};

struct Params {
  int n, w, h, g;
  int pb, lb, lmask, p1m, p2m, rb, rmask, vlvl;
  int fb;     // shift of the distance in a packed 32-bit rank key
  int nbits;  // bits of a choice index (bit planes in shared memory)
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
  v = __reduce_min_sync(kFull, v);
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

// Rank of each thread's key among the block's P = blockDim.x keys, written
// to rank[row]: a bitonic sort of (key, row) pairs over the P threads (the
// compare-exchange network of the JAX reference), then rank[row_sorted[t]]
// = t. Stages of distance < 32 pair lanes of one warp and exchange by
// shuffles; wider ones exchange through xk/xi (two halves of P, alternated
// so one barrier per stage suffices). Every thread must call it.
template <typename Key>
__device__ __forceinline__ void settle_rank(Key key, int* rank, Key* xk, int* xi) {
  const int t = threadIdx.x, p = blockDim.x;
  int idx = t, half = 0;
  // Stage distances are compile-time constants (unrolled up to P = 1024).
#pragma unroll
  for (int lk = 1; lk <= 10; ++lk) {
    const int k = 1 << lk;
    if (k > p) break;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      Key other;
      int oidx;
      if (j >= 32) {
        Key* kb = xk + half * p;
        int* ib = xi + half * p;
        kb[t] = key;
        ib[t] = idx;
        __syncthreads();
        other = kb[t ^ j];
        oidx = ib[t ^ j];
        half ^= 1;
      } else {
        other = __shfl_xor_sync(kFull, key, j);
        oidx = __shfl_xor_sync(kFull, idx, j);
      }
      // The lower of the pair keeps the min in an ascending run, the
      // upper the max; descending runs the other way round.
      const bool take_min = ((t & j) == 0) == ((t & k) == 0);
      if (take_min ? other < key : other > key) {
        key = other;
        idx = oidx;
      }
    }
  }
  rank[idx] = t;
}

// The state fields of one candidate predecessor.
struct Cand {
  int d, m, pri, c1, c2, rw, rk;
};

// One column's state, one int array each, P entries.
struct State {
  int *d, *pri, *m, *c1, *c2, *rw, *rank;
};

__device__ __forceinline__ State state_at(int* base, int p) {
  return State{base, base + p, base + 2 * p, base + 3 * p,
               base + 4 * p, base + 5 * p, base + 6 * p};
}

template <bool kExact, typename Key, typename Layout, int kG, bool kSmemChoices>
__global__ void __launch_bounds__(1024)
    minpath_kernel(const uint8_t* __restrict__ maps, uint8_t* __restrict__ choices,
                   int32_t* __restrict__ rows_out, Params prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = blockDim.x;
  int* s_state = reinterpret_cast<int*>(smem);  // two column buffers
  auto buf = [&](int j) { return state_at(s_state + (j & 1) * 7 * p, p); };
  Key* s_xk = reinterpret_cast<Key*>(smem + (size_t)14 * p * sizeof(int));
  int* s_xi = reinterpret_cast<int*>(s_xk + 2 * p);
  int* s_red = s_xi + 2 * p;
  uint32_t* s_ch = reinterpret_cast<uint32_t*>(s_red + 32);

  const int r = threadIdx.x, lane = r & 31, warp = r >> 5, nwarps = p >> 5;
  const int w = prm.w, h = prm.h;
  const int g = kG > 0 ? kG : prm.g;
  const int n_cand = 2 * g + 1;
  const int PB = prm.pb, LB = prm.lb, RB = prm.rb;
  const bool real = r < h;
  const Key key_pad = ~Key(0);
  const size_t map_off = (size_t)blockIdx.x * w * h;
  const uint8_t* mp = maps + map_off;
  uint8_t* cp = choices + map_off;
  auto load_m = [&](int j) -> int {
    return (real && j < w) ? (int)mp[Layout::at(j, r, w, h)] : 0;
  };
  // Candidate masks are 32-bit when max_grad is fixed and small.
  using Mask = typename std::conditional<(kG > 0 && kG < 16), uint32_t, uint64_t>::type;
  // With kG > 0 each candidate's priority and whether its row exists are
  // fixed per row: computed once, before the column loop.
  constexpr int kN = kG > 0 ? 2 * kG + 1 : 1;
  int cpri[kN];
  Mask in_mask = 0;
  if constexpr (kG > 0) {
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int pr = r + cand_offset(k, g);
      cpri[k] = cand_pri(k, r, g);
      if (pr >= 0 && pr < h) in_mask |= Mask(1) << k;
    }
  }
  auto pri_of = [&](int k) {
    if constexpr (kG > 0)
      return cpri[k];
    else
      return cand_pri(k, r, g);
  };
  auto inside = [&](int k) -> bool {
    if constexpr (kG > 0) {
      return (in_mask >> k) & 1;
    } else {
      const int pr = r + cand_offset(k, g);
      return pr >= 0 && pr < h;
    }
  };

  // Column 0: entry edge from the virtual all-ones column.
  int m_cur = load_m(0);
  {
    const State s = buf(0);
    if (real) {
      const int vl = prm.vlvl;
      s.d[r] = 255 - m_cur;
      s.pri[r] = 1;
      s.m[r] = m_cur;
      s.c1[r] = ((((255 + m_cur) << PB) | 1) << LB) | (r >= 1 ? vl : 0);
      s.c2[r] = ((r >= 2 ? vl : 0) << LB) | (r >= 3 ? vl : 0);
      s.rw[r] = (r << RB) | max(r - 1, 0);
    }
    if (kExact)
      settle_rank<Key>(real ? make_key<Key>(255 - m_cur, r, prm.fb) : key_pad, s.rank,
                       s_xk, s_xi);
  }
  // Map values of the next four columns, loaded ahead (paired layouts:
  // the odd column of each pair waits in m_odd).
  int m1 = load_m(1), m2 = load_m(2), m3 = load_m(3), m4 = load_m(4);
  int m_odd = Layout::kPaired ? load_m(5) : 0;

  for (int j = 1; j < w; ++j) {
    m_cur = m1;
    m1 = m2;
    m2 = m3;
    m3 = m4;
    const int jn = j + 4;
    if constexpr (Layout::kPaired) {
      if (jn & 1) {
        m4 = m_odd;
      } else {
        // w is even, so jn + 1 < w whenever jn < w.
        const int pair = (real && jn < w)
                             ? (int)*reinterpret_cast<const uint16_t*>(
                                   mp + Layout::at(jn, r, w, h))
                             : 0;
        m4 = pair & 255;
        m_odd = pair >> 8;
      }
    } else {
      m4 = load_m(jn);
    }
    __syncthreads();  // column j-1's state is complete and visible
    const State sp = buf(j - 1), sn = buf(j);

    int d_new = kBig, pri_new = 0, c1_new = 0, c2_new = 0, rw_new = 0;
    int sort_sub = 0, choice = 0;
    if (real) {
      // Candidate k's fields. With max_grad fixed at compile time (kG > 0)
      // every candidate is loaded once, in one wave, and get(k) picks from
      // registers; otherwise get(k) reads shared memory.
      auto load = [&](int k) -> Cand {
        const int pr = min(max(r + cand_offset(k, g), 0), h - 1);
        return Cand{sp.d[pr],  sp.m[pr],  sp.pri[pr], sp.c1[pr],
                    sp.c2[pr], sp.rw[pr], kExact ? sp.rank[pr] : 0};
      };
      Cand cs[kN];
      if constexpr (kG > 0) {
#pragma unroll
        for (int k = 0; k < kN; ++k) cs[k] = load(k);
      }
      auto get = [&](int k) -> Cand {
        if constexpr (kG > 0) {
          Cand c = cs[0];
#pragma unroll
          for (int i = 1; i < kN; ++i)
            if (i == k) c = cs[i];
          return c;
        } else {
          return load(k);
        }
      };
      // Best candidate distance.
      int best = kBig;
#pragma unroll
      for (int k = 0; k < n_cand; ++k) {
        const Cand c = get(k);
        if (inside(k)) best = min(best, c.d - c.m);
      }
      // Tied candidates, and among them the zero-weight entries.
      const bool m_cur255 = m_cur == 255;
      Mask tied = 0, zero = 0;
#pragma unroll
      for (int k = 0; k < n_cand; ++k) {
        const Cand c = get(k);
        if (!inside(k) || c.d - c.m != best) continue;
        tied |= Mask(1) << k;
        if (m_cur255 && c.m == 255) zero |= Mask(1) << k;
      }
      Mask valid = tied & ~zero;
      if (zero) {
        // The strict (positive-weight) pop representative: lexicographic
        // min of (priority, rank or c1), first index on ties.
        int bsp = kBig, s_key_min = kBig, s_choice = 0;
#pragma unroll
        for (int k = 0; k < n_cand; ++k) {
          if (!((valid >> k) & 1)) continue;
          const int pk = pri_of(k);
          const int sk = kExact ? get(k).rk : get(k).c1;
          if (pk < bsp || (pk == bsp && sk < s_key_min)) {
            bsp = pk;
            s_key_min = sk;
            s_choice = k;
          }
        }
        const Cand sc = get(s_choice);
        const int s_pack = ((sc.m + m_cur) << PB) | (sc.pri + 1);
        const int S_c1 = (s_pack << LB) | (sc.c1 >> LB);
        const int S_c2 = ((sc.c1 & prm.lmask) << LB) | (sc.c2 >> LB);
        const int S_rw = sc.rw;

        // Zero-weight entries are valid when their predecessor settles
        // before the strict pop.
#pragma unroll
        for (int k = 0; k < n_cand; ++k) {
          if (!((zero >> k) & 1)) continue;
          const Cand u = get(k);
          const int u1 = u.c1, u2 = u.c2, urw = u.rw;
          const bool supp1 = wfield(u1, PB) || wfield(S_c1, PB);
          const bool supp2 = wfield(u2, LB + PB) || wfield(S_c2, LB + PB);
          const bool supp3 = wfield(u2, PB) || wfield(S_c2, PB);
          const int keep1 = ~(supp1 ? prm.p1m : 0) & ~(supp2 ? prm.p2m : 0);
          int u_c1 = u1 & keep1;
          int sv_c1 = S_c1 & keep1;
          const int keep2 = ~(supp3 ? prm.p1m : 0) & ~prm.p2m;
          const int u_c2 = u2 & keep2;
          const int sv_c2 = S_c2 & keep2;
          const bool mm1 = (urw >> RB) == (S_rw >> RB);
          const bool mm2 = (urw & prm.rmask) == (S_rw & prm.rmask);
          const int merged = (mm1 ? prm.p1m : 0) | (mm2 ? prm.p2m : 0);
          u_c1 &= ~merged;
          sv_c1 |= merged;
          const int pu = u.pri;
          const bool ok =
              pu < bsp ||
              (pu == bsp && (u_c1 < sv_c1 || (u_c1 == sv_c1 && u_c2 <= sv_c2)));
          if (ok) valid |= Mask(1) << k;
        }
      }
      if (valid == 0) valid = tied;

      // Pop entry: min priority, then (exact) min predecessor rank or
      // (fast) min (d, pri, c1, c2, row) of the predecessor. Priorities
      // mostly differ between candidates, so a single candidate of the
      // best priority is taken without the comparisons.
      int best_pri = kBig;
#pragma unroll
      for (int k = 0; k < n_cand; ++k)
        if ((valid >> k) & 1) best_pri = min(best_pri, pri_of(k));
      Mask top = 0;
#pragma unroll
      for (int k = 0; k < n_cand; ++k)
        if (((valid >> k) & 1) && pri_of(k) == best_pri) top |= Mask(1) << k;
      int entry_ctr = kBig;
      if ((top & (top - 1)) == 0) {
        choice = sizeof(Mask) == 4 ? __ffs((unsigned)top) - 1
                                   : __ffsll((unsigned long long)top) - 1;
        if (kExact) entry_ctr = get(choice).rk;
      } else {
        int fd = kBig, fp = kBig, f1 = kBig, f2 = kBig, frow = kBig;
#pragma unroll
        for (int k = 0; k < n_cand; ++k) {
          if (!((top >> k) & 1)) continue;
          const Cand c = get(k);
          const int pr = r + cand_offset(k, g);
          if (kExact) {
            if (c.rk < entry_ctr) {
              entry_ctr = c.rk;
              choice = k;
            }
          } else {
            const int a0 = c.d, a1 = c.pri, a2 = c.c1, a3 = c.c2;
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
      }
      const Cand pcand = get(choice);
      const int pc = r + cand_offset(choice, g);
      const int pm = pcand.m, pp = pcand.pri, gc1 = pcand.c1;
      if (kExact) {
        const bool zero_chosen = (zero >> choice) & 1;
        const int pri_eff = zero_chosen ? max(best_pri, pp) : best_pri;
        sort_sub = pri_eff * p + entry_ctr;
      }
      d_new = best + 510 - m_cur;
      pri_new = best_pri;
      const int c_pack = ((pm + m_cur) << PB) | (pp + 1);
      c1_new = (c_pack << LB) | (gc1 >> LB);
      c2_new = ((gc1 & prm.lmask) << LB) | (pcand.c2 >> LB);
      rw_new = (pc << RB) | (pcand.rw >> RB);
      if (!kSmemChoices) cp[(size_t)j * h + r] = (uint8_t)choice;
      // Column j's buffer was last read in column j-1, before this
      // column's barrier.
      sn.d[r] = d_new;
      sn.pri[r] = pri_new;
      sn.m[r] = m_cur;
      sn.c1[r] = c1_new;
      sn.c2[r] = c2_new;
      sn.rw[r] = rw_new;
    }
    if (kSmemChoices) {
      uint32_t* planes = s_ch + ((size_t)j * nwarps + warp) * prm.nbits;
      for (int b = 0; b < prm.nbits; ++b) {
        const uint32_t word = __ballot_sync(kFull, (choice >> b) & 1);
        if (lane == 0) planes[b] = word;
      }
    }
    if (kExact)
      settle_rank<Key>(real ? make_key<Key>(d_new, sort_sub, prm.fb) : key_pad, sn.rank,
                       s_xk, s_xi);
  }
  __syncthreads();

  // Exit row: the earliest-settled last-column node among those of minimal
  // exit distance (exact: settle rank; fast: (d, pri, c1, c2)), then the
  // top row. Every thread calls block_min (it holds barriers), so no call
  // sits behind a short-circuit.
  const State sl = buf(w - 1);
  const int exit_d = real ? sl.d[r] + 255 - sl.m[r] : kBig;
  const int exit_min = block_min(exit_d, s_red);
  bool tied_e = real && exit_d == exit_min;
  if (kExact) {
    const int rk = real ? sl.rank[r] : kBig;
    const int rk_min = block_min(tied_e ? rk : kBig, s_red);
    tied_e = tied_e && rk == rk_min;
  } else {
    const int keys[4] = {real ? sl.d[r] : kBig, real ? sl.pri[r] : kBig,
                         real ? sl.c1[r] : kBig, real ? sl.c2[r] : kBig};
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
      int c;
      if (kSmemChoices) {
        const uint32_t* planes = s_ch + ((size_t)j * nwarps + (row >> 5)) * prm.nbits;
        c = 0;
        for (int b = 0; b < prm.nbits; ++b) c |= ((planes[b] >> (row & 31)) & 1) << b;
      } else {
        c = cp[(size_t)j * h + row];
      }
      row += cand_offset(c, g);
      out[j - 1] = row;
    }
  }
}

// Shared memory of the state buffers, the rank exchange and the reduction.
template <typename Key>
size_t base_smem(int p) {
  return (size_t)14 * p * sizeof(int) + (size_t)2 * p * (sizeof(Key) + sizeof(int)) +
         32 * sizeof(int);
}

size_t plane_smem(const Params& prm, int p) {
  return (size_t)prm.w * (p / 32) * prm.nbits * sizeof(uint32_t);
}

// The choice store: bit planes in shared memory when they fit beside the
// state (with the 64-bit rank exchange, the larger of the two).
bool smem_choices(const Params& prm, int p) {
  return base_smem<uint64_t>(p) + plane_smem(prm, p) <= kMaxSmem;
}

template <bool kExact, typename Key, typename Layout, int kG, bool kSmem>
cudaError_t launch_store(const uint8_t* maps, uint8_t* choices, int32_t* rows,
                         const Params& prm, int p, cudaStream_t stream) {
  const size_t smem = base_smem<Key>(p) + (kSmem ? plane_smem(prm, p) : 0);
  auto kernel = minpath_kernel<kExact, Key, Layout, kG, kSmem>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<prm.n, p, smem, stream>>>(maps, choices, rows, prm);
  return cudaGetLastError();
}

template <bool kExact, typename Key, typename Layout, int kG>
cudaError_t launch_g(const uint8_t* maps, uint8_t* choices, int32_t* rows,
                     const Params& prm, int p, cudaStream_t stream) {
  if (smem_choices(prm, p))
    return launch_store<kExact, Key, Layout, kG, true>(maps, choices, rows, prm, p, stream);
  return launch_store<kExact, Key, Layout, kG, false>(maps, choices, rows, prm, p, stream);
}

template <bool kExact, typename Key, typename Layout>
cudaError_t launch(const uint8_t* maps, uint8_t* choices, int32_t* rows,
                   const Params& prm, int p, cudaStream_t stream) {
  if (prm.g == 1)
    return launch_g<kExact, Key, Layout, 1>(maps, choices, rows, prm, p, stream);
  return launch_g<kExact, Key, Layout, 0>(maps, choices, rows, prm, p, stream);
}

bool make_params(int n, int w, int h, int max_grad, Params& prm, int& p) {
  if (n <= 0 || w <= 0 || h <= 0 || h > 1024 || max_grad < 0 || max_grad > 30)
    return false;
  p = 32;
  while (p < h) p <<= 1;
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
  // Rank sub-keys are pri_eff * P + ctr < (2 + 2g) * P <= 2^fb.
  int fb = 0;
  while ((1ll << fb) < (long long)(2 + 2 * max_grad) * p) ++fb;
  prm.fb = fb;
  // A choice index is at most 2g.
  int nbits = 0;
  for (int v = 2 * max_grad; v; v >>= 1) ++nbits;
  prm.nbits = nbits > 0 ? nbits : 1;
  return true;
}

template <typename Layout>
int delineate(const uint8_t* maps, uint8_t* choices, int32_t* rows, int n, int w,
              int h, int max_grad, int exact, void* stream) {
  Params prm;
  int p;
  if (!make_params(n, w, h, max_grad, prm, p)) return (int)cudaErrorInvalidValue;
  // The packed 32-bit key holds d_max << fb below the all-ones pad key when
  // it fits.
  const long long d_max = 255 + 510ll * (w - 1);
  const bool pack32 = prm.fb < 32 && ((d_max + 1) << prm.fb) <= 0xffffffffll;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!exact)
    return (int)launch<false, uint32_t, Layout>(maps, choices, rows, prm, p, s);
  if (pack32)
    return (int)launch<true, uint32_t, Layout>(maps, choices, rows, prm, p, s);
  return (int)launch<true, uint64_t, Layout>(maps, choices, rows, prm, p, s);
}

}  // namespace

// maps (n, w, h) uint8, choices (n, w, h) uint8 scratch, rows (n, w) int32,
// all contiguous on the current device. The scratch is read and written only
// when minpath_smem_choices(w, h, max_grad) is 0; otherwise any pointer will
// do. Returns the cudaError_t of the launch.
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

// Which choice store a launch on w columns and h rows takes: 1 for the bit
// planes in shared memory (the scratch is not touched), 0 for the (n, w, h)
// device scratch, -1 for a shape the kernel refuses.
extern "C" int minpath_smem_choices(int w, int h, int max_grad) {
  Params prm;
  int p;
  if (!make_params(1, w, h, max_grad, prm, p)) return -1;
  return smem_choices(prm, p) ? 1 : 0;
}
