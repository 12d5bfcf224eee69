// Fused s2d encoder pair for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel oct_image_segmentation_models_tpu/ops/
// s2d_pallas.py::fused_enc_pair (body _build_kernel, masks _masks). It
// computes what ops/s2d_enc_pair.py::fused_enc_pair_reference in the PyTorch
// package computes, to float32 accuracy: for one s2d U-Net encoder level with
// x (B, nh, nw, 4Cin) in block space,
//   y1[r, s] = relu(b1 + sum_{a, e in {0,1}} x[r-1+a, s-1+e] . w1[a, e]),
//              r in [0, nh], s in [0, nw], zero outside x, then the shifted
//              edge masks (phase q_h = 0 of row 0, q_h = 1 of row nh, q_w = 0
//              of column 0, q_w = 1 of column nw are zeroed);
//   y2[r, s] = relu(b2 + sum_{a, e in {0,1}} y1[r+a, s+e] . w2[a, e]);
//   pooled[r, s, c] = max_q y2[r, s, q*C + c]   (channel order (q_h, q_w, c)).
//
// Bound on the H100. At the flagship level-1 shape (B 8, nh 128, nw 256,
// 4Cin 128, 4C 256) the dense block-space work is 2.07e11 FLOP per call
// against 0.47 GB of traffic (x read once, y2 and pooled written once: 0.14
// ms at 3.35 TB/s), so operations bound it. On the float32 CUDA cores (67
// TFLOP/s) that is 3.1 ms. On the tensor cores the same float32-accurate work
// is three TF32 products per multiply-add: 3 * 2.07e11 / 495e12 = 1.25 ms.
//
// Design. Both convs are implicit GEMMs per CTA tile on the tensor cores,
// mma.sync.m16n8k8 with TF32 operands in the 3xTF32 scheme: each float32
// operand v is split into hi = tf32(v) (round to nearest) and lo = v - hi,
// and the product is accumulated in float32 as lo*hi + hi*lo + hi*hi. That
// keeps float32 accuracy (plain TF32 misses the 1e-4 tolerance by 10x).
//
// One CTA of 8 warps per (batch, TR block rows, TC block columns).
// - conv1: M = the (TR+1) x (TC+1) y1 pixels of the tile with its halo row
//   and column (padded to whole 16-row MMA tiles), N = 4C, K = 4 taps x 4Cin
//   (4Cin padded to 8 with zeros). A comes from x through the read-only
//   cache; bias, ReLU and the edge masks are applied in registers and y1 is
//   stored in shared memory as float32, so y1 never touches device memory.
// - conv2: M = TR x TC, N = 4C, K = 4 x 4C; A is read from y1 in shared
//   memory (row stride 4C + 4 floats: the 8 rows of a fragment hit 32
//   distinct banks) and split as it is loaded into fragments.
// - N is dealt out to warps in groups of 8 channels c of one phase: a warp
//   owns the four MMA column tiles q*C + [8 cg, 8 cg + 8), q = 0..3, so the
//   phase max of pooled is taken in the thread's own registers, and y2 and
//   pooled are written straight from them.
// - Weights are read as B fragments from device memory (they stay in L2:
//   0.4 M floats at the flagship shape), each warp only its own columns, so
//   a CTA reads the weights once; the next k-step's fragments are loaded
//   while the current one runs.
// - Tiles: TR x TC = 8 x 16 (y1: 153 pixels x (4C + 4) floats = 159 KB at
//   4C = 256, one CTA of 8 warps per SM, 244 registers a thread and no
//   spills) while y1 fits in shared memory, else 4 x 8. Every tile is
//   masked at the level's ragged edge. A 4 x 16 tile with two CTAs per SM
//   (capped at 128 registers, some stack) ran slower than 8 x 16 at the
//   flagship shape on the H100: the halo costs conv1 1.5x its useful rows
//   there against 1.25x, and the 16 warps did not make up for it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Shape {
  int nh, nw, cin4, c4;
  int c;   // channels per phase group, 4C / 4
  int ng;  // groups of 8 channels per phase, ceil(c / 8)
  int ld;  // y1 row stride in shared memory, floats
};

__device__ __forceinline__ uint32_t tf32_round(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo exactly; the tensor cores read the top 19 bits of lo.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_round(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += a * b, one m16n8k8 tile, TF32 operands, float32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: d += a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms first.
// The k-step's 24 products are summed in a fresh fragment and added to the
// running sum in float32 (round to nearest): accumulating the whole K = 4 x
// 4C inside the MMAs measured up to 1.2e-4 off the float32 cuDNN chain at
// 4C = 512 on the H100, past the 1e-4 tolerance.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma(part, al, bh[0], bh[1]);
  mma(part, ah, bl[0], bl[1]);
  mma(part, ah, bh[0], bh[1]);
#pragma unroll
  for (int v = 0; v < 4; ++v) d[v] += part[v];
}

// B fragments of one k-step for the warp's four column tiles: rows k0 + t
// and k0 + t + 4 of the (taps x K, 4C) weight matrix at tap row base
// `wrow`, column q*C + col. Rows past K and columns past C read as 0.
__device__ __forceinline__ void load_b(float (&b)[4][2], const float* __restrict__ w,
                                       int wrow, int k0, int kdim, int col,
                                       const Shape& sh, int t) {
  const bool c_ok = col < sh.c;
  const bool r0 = c_ok && k0 + t < kdim, r1 = c_ok && k0 + t + 4 < kdim;
  const float* p0 = w + (size_t)(wrow + k0 + t) * sh.c4 + col;
  const float* p1 = p0 + (size_t)4 * sh.c4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    b[q][0] = r0 ? __ldg(p0 + q * sh.c) : 0.f;
    b[q][1] = r1 ? __ldg(p1 + q * sh.c) : 0.f;
  }
}

__device__ __forceinline__ void split_b(const float (&b)[4][2], uint32_t (&bh)[4][2],
                                        uint32_t (&bl)[4][2]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    split(b[q][0], bh[q][0], bl[q][0]);
    split(b[q][1], bh[q][1], bl[q][1]);
  }
}

// Accumulators start at the bias of the thread's columns 2t, 2t+1 of each
// phase tile.
template <int kMT>
__device__ __forceinline__ void init_acc(float (&acc)[kMT][4][4],
                                         const float* __restrict__ bias, int col2,
                                         const Shape& sh) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float2 bv = make_float2(0.f, 0.f);
    if (col2 < sh.c) bv = *reinterpret_cast<const float2*>(bias + q * sh.c + col2);
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      acc[i][q][0] = bv.x;
      acc[i][q][1] = bv.y;
      acc[i][q][2] = bv.x;
      acc[i][q][3] = bv.y;
    }
  }
}

// conv1 for the warp's m-tiles mt0 + mstep*i (i < kMT, those < n_mt) and its
// channel group cg, into y1 in shared memory.
template <int TR, int TC, int kMT>
__device__ void conv1_pass(const float* __restrict__ xb, const float* __restrict__ w1,
                           const float* __restrict__ b1, float* y1s, const Shape& sh,
                           int r0, int s0, int cg, int mt0, int mstep) {
  constexpr int kCols = TC + 1;
  constexpr int kPix = (TR + 1) * kCols;
  constexpr int kMtiles = (kPix + 15) / 16;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int col = cg * 8 + g, col2 = cg * 8 + 2 * t;
  const int cin4 = sh.cin4, nh = sh.nh, nw = sh.nw;
  const int ksteps_tap = (cin4 + 7) / 8;
  const int ksteps = 4 * ksteps_tap;

  bool on[kMT];
#pragma unroll
  for (int i = 0; i < kMT; ++i) on[i] = mt0 + mstep * i < kMtiles;

  float acc[kMT][4][4];
  init_acc<kMT>(acc, b1, col2, sh);

  // x offsets of the fragment rows g and g+8 of each m-tile for one tap;
  // -1 where the y1 pixel reads outside x (or is past the tile).
  int off[kMT][2];
  auto offsets = [&](int tap) {
    const int a = tap >> 1, e = tap & 1;
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 16 * (mt0 + mstep * i) + g + 8 * h;
        const int xr = r0 + p / kCols - 1 + a, xc = s0 + p % kCols - 1 + e;
        const bool in = on[i] && p < kPix && xr >= 0 && xr < nh && xc >= 0 && xc < nw;
        off[i][h] = in ? (xr * nw + xc) * cin4 : -1;
      }
    }
  };
  auto load_a = [&](float (&a)[kMT][4], int k0) {
    const bool k_lo = k0 + t < cin4, k_hi = k0 + t + 4 < cin4;
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      a[i][0] = off[i][0] >= 0 && k_lo ? __ldg(xb + off[i][0] + k0 + t) : 0.f;
      a[i][1] = off[i][1] >= 0 && k_lo ? __ldg(xb + off[i][1] + k0 + t) : 0.f;
      a[i][2] = off[i][0] >= 0 && k_hi ? __ldg(xb + off[i][0] + k0 + t + 4) : 0.f;
      a[i][3] = off[i][1] >= 0 && k_hi ? __ldg(xb + off[i][1] + k0 + t + 4) : 0.f;
    }
  };

  int tap = 0, k0 = 0;
  offsets(0);
  float an[kMT][4], bn[4][2];
  load_a(an, 0);
  load_b(bn, w1, 0, 0, cin4, col, sh, t);
#pragma unroll 1
  for (int ks = 0; ks < ksteps; ++ks) {
    float a[kMT][4], b[4][2];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int v = 0; v < 4; ++v) a[i][v] = an[i][v];
#pragma unroll
    for (int q = 0; q < 4; ++q) b[q][0] = bn[q][0], b[q][1] = bn[q][1];
    if (ks + 1 < ksteps) {  // prefetch the next k-step
      k0 += 8;
      if (k0 >= cin4) {
        k0 = 0;
        offsets(++tap);
      }
      load_a(an, k0);
      load_b(bn, w1, tap * cin4, k0, cin4, col, sh, t);
    }
    uint32_t bh[4][2], bl[4][2];
    split_b(b, bh, bl);
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      if (!on[i]) continue;
      uint32_t ah[4], al[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) split(a[i][v], ah[v], al[v]);
#pragma unroll
      for (int q = 0; q < 4; ++q) mma3(acc[i][q], ah, al, bh[q], bl[q]);
    }
  }

  // Bias is in; ReLU, the shifted-edge masks, 0 past the level's edge.
  if (col2 >= sh.c) return;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    if (!on[i]) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 16 * (mt0 + mstep * i) + g + 8 * h;
      if (p >= kPix) continue;
      const int r = r0 + p / kCols, s = s0 + p % kCols;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int qh = q >> 1, qw = q & 1;
        const bool keep = r <= nh && s <= nw && !(r == 0 && qh == 0) &&
                          !(r == nh && qh == 1) && !(s == 0 && qw == 0) &&
                          !(s == nw && qw == 1);
        float2 out = make_float2(0.f, 0.f);
        if (keep)
          out = make_float2(fmaxf(acc[i][q][2 * h], 0.f), fmaxf(acc[i][q][2 * h + 1], 0.f));
        *reinterpret_cast<float2*>(y1s + p * sh.ld + q * sh.c + col2) = out;
      }
    }
  }
}

// conv2 for the warp's m-tiles and channel group, y1 from shared memory;
// writes y2 and the phase max from registers.
template <int TR, int TC, int kMT>
__device__ void conv2_pass(const float* y1s, const float* __restrict__ w2,
                           const float* __restrict__ b2, float* __restrict__ y2,
                           float* __restrict__ pooled, const Shape& sh, int bi, int r0,
                           int s0, int cg, int mt0, int mstep) {
  constexpr int kCols = TC + 1;
  constexpr int kMtiles = TR * TC / 16;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int col = cg * 8 + g, col2 = cg * 8 + 2 * t;
  const int c4 = sh.c4, ld = sh.ld;
  const int ksteps_tap = c4 / 8;
  const int ksteps = 4 * ksteps_tap;

  bool on[kMT];
#pragma unroll
  for (int i = 0; i < kMT; ++i) on[i] = mt0 + mstep * i < kMtiles;

  float acc[kMT][4][4];
  init_acc<kMT>(acc, b2, col2, sh);

  // y1 offset of fragment row g of each m-tile for one tap; row g + 8 sits
  // 8 pixels further in a 16-column tile and one y1 row further in an
  // 8-column one.
  static_assert(TC == 16 || TC == 8, "m-tiles are one 16-pixel row or two 8-pixel rows");
  const int row8 = (TC == 16 ? 8 : kCols) * ld;
  int src[kMT];
  auto offsets = [&](int tap) {
    const int a = tap >> 1, e = tap & 1;
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const int p = on[i] ? 16 * (mt0 + mstep * i) + g : 0;
      src[i] = ((p / TC + a) * kCols + p % TC + e) * ld + t;
    }
  };

  int tap = 0, k0 = 0;
  offsets(0);
  float bn[4][2];
  load_b(bn, w2, 0, 0, c4, col, sh, t);
#pragma unroll 1
  for (int ks = 0; ks < ksteps; ++ks) {
    float b[4][2];
#pragma unroll
    for (int q = 0; q < 4; ++q) b[q][0] = bn[q][0], b[q][1] = bn[q][1];
    if (ks + 1 < ksteps) {  // prefetch the next k-step's weights
      const int k1 = k0 + 8 < c4 ? k0 + 8 : 0;
      load_b(bn, w2, (k1 ? tap : tap + 1) * c4, k1, c4, col, sh, t);
    }
    uint32_t bh[4][2], bl[4][2];
    split_b(b, bh, bl);
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      if (!on[i]) continue;
      const float* p0 = y1s + src[i] + k0;
      const float* p1 = p0 + row8;
      uint32_t ah[4], al[4];
      split(p0[0], ah[0], al[0]);
      split(p1[0], ah[1], al[1]);
      split(p0[4], ah[2], al[2]);
      split(p1[4], ah[3], al[3]);
#pragma unroll
      for (int q = 0; q < 4; ++q) mma3(acc[i][q], ah, al, bh[q], bl[q]);
    }
    k0 += 8;
    if (k0 >= c4 && ks + 1 < ksteps) {
      k0 = 0;
      offsets(++tap);
    }
  }

  if (col2 >= sh.c) return;
  const int nh = sh.nh, nw = sh.nw, c = sh.c;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    if (!on[i]) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 16 * (mt0 + mstep * i) + g + 8 * h;
      const int r = r0 + p / TC, s = s0 + p % TC;
      if (r >= nh || s >= nw) continue;
      const size_t pix = ((size_t)bi * nh + r) * nw + s;
      float2 mx = make_float2(0.f, 0.f);  // ReLU outputs are >= 0
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 v = make_float2(fmaxf(acc[i][q][2 * h], 0.f),
                                     fmaxf(acc[i][q][2 * h + 1], 0.f));
        *reinterpret_cast<float2*>(y2 + pix * c4 + q * c + col2) = v;
        mx = make_float2(fmaxf(mx.x, v.x), fmaxf(mx.y, v.y));
      }
      *reinterpret_cast<float2*>(pooled + pix * c + col2) = mx;
    }
  }
}

template <int TR, int TC, int kMT1, int kMT2>
__global__ void __launch_bounds__(kThreads, 1)
    enc_pair_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, float* __restrict__ y2,
                    float* __restrict__ pooled, Shape sh) {
  constexpr int kMt1 = ((TR + 1) * (TC + 1) + 15) / 16;
  constexpr int kMt2 = TR * TC / 16;
  extern __shared__ __align__(16) float y1s[];  // [(TR+1)(TC+1)][ld]

  const int warp = threadIdx.x >> 5;
  const int s0 = blockIdx.x * TC, r0 = blockIdx.y * TR, bi = blockIdx.z;
  const float* xb = x + (size_t)bi * sh.nh * sh.nw * sh.cin4;

  // Warp roles: with 8 or more channel groups each warp takes groups
  // warp, warp + 8, ... and every m-tile; with fewer, the warps that share
  // a group split its m-tiles (ms of mstep).
  int cg0, cgstep, ms, mstep;
  if (sh.ng >= kWarps) {
    cg0 = warp, cgstep = kWarps, ms = 0, mstep = 1;
  } else {
    mstep = kWarps / sh.ng;
    cg0 = warp % sh.ng, cgstep = sh.ng, ms = warp / sh.ng;
    if (ms >= mstep) cg0 = sh.ng;  // idle warp
  }

  for (int cg = cg0; cg < sh.ng; cg += cgstep)
    for (int base = ms; base < kMt1; base += mstep * kMT1)
      conv1_pass<TR, TC, kMT1>(xb, w1, b1, y1s, sh, r0, s0, cg, base, mstep);
  __syncthreads();  // the whole y1 tile is in shared memory
  for (int cg = cg0; cg < sh.ng; cg += cgstep)
    for (int base = ms; base < kMt2; base += mstep * kMT2)
      conv2_pass<TR, TC, kMT2>(y1s, w2, b2, y2, pooled, sh, bi, r0, s0, cg, base, mstep);
}

constexpr size_t kMaxSmem = 227 * 1024;

template <int TR, int TC>
size_t smem_bytes(int ld) {
  return (size_t)(TR + 1) * (TC + 1) * ld * sizeof(float);
}

template <int TR, int TC>
bool fits(int c4) {
  return smem_bytes<TR, TC>(c4) <= kMaxSmem;
}

template <int TR, int TC, int kMT1, int kMT2>
cudaError_t launch(const float* x, const float* w1, const float* b1, const float* w2,
                   const float* b2, float* y2, float* pooled, int b, Shape sh,
                   cudaStream_t stream) {
  // Pad the y1 row stride by 4 floats (bank-conflict-free fragment loads)
  // where shared memory allows.
  sh.ld = smem_bytes<TR, TC>(sh.c4 + 4) <= kMaxSmem ? sh.c4 + 4 : sh.c4;
  const size_t smem = smem_bytes<TR, TC>(sh.ld);
  auto kernel = enc_pair_kernel<TR, TC, kMT1, kMT2>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.nw + TC - 1) / TC, (sh.nh + TR - 1) / TR, b);
  kernel<<<grid, kThreads, smem, stream>>>(x, w1, b1, w2, b2, y2, pooled, sh);
  return cudaGetLastError();
}

}  // namespace

// x (b, nh, nw, cin4), w1 (2, 2, cin4, c4), b1 (c4), w2 (2, 2, c4, c4), b2 (c4)
// in; y2 (b, nh, nw, c4), pooled (b, nh, nw, c4/4) out; float32, contiguous,
// 16-byte aligned, on the current device. cin4 % 4 == 0, c4 % 8 == 0. Returns
// the cudaError_t of the launch.
extern "C" int s2d_enc_pair(const float* x, const float* w1, const float* b1,
                            const float* w2, const float* b2, float* y2,
                            float* pooled, int b, int nh, int nw, int cin4, int c4,
                            void* stream) {
  if (b <= 0 || nh <= 0 || nw <= 0 || cin4 <= 0 || c4 <= 0 || cin4 % 4 || c4 % 8 ||
      b > 65535 || (long long)nh * nw * cin4 >= (1ll << 31))
    return (int)cudaErrorInvalidValue;  // x offsets within a batch are int
  Shape sh;
  sh.nh = nh, sh.nw = nw, sh.cin4 = cin4, sh.c4 = c4;
  sh.c = c4 / 4;
  sh.ng = (sh.c + 7) / 8;
  sh.ld = c4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 8 x 16: y1 153 pixels = 10 m-tiles in two passes of 5; y2 8 m-tiles.
  if (fits<8, 16>(c4))
    return (int)launch<8, 16, 5, 8>(x, w1, b1, w2, b2, y2, pooled, b, sh, s);
  // 4 x 8: y1 45 pixels = 3 m-tiles; y2 2 m-tiles.
  if (fits<4, 8>(c4))
    return (int)launch<4, 8, 3, 2>(x, w1, b1, w2, b2, y2, pooled, b, sh, s);
  return (int)cudaErrorInvalidValue;
}

// Which tile s2d_enc_pair takes for 4C = c4: 100 * TR + TC (8 x 16 -> 816,
// 4 x 8 -> 408), or 0 if it refuses the shape.
extern "C" int s2d_enc_pair_tile(int c4) {
  if (fits<8, 16>(c4)) return 100 * 8 + 16;
  if (fits<4, 8>(c4)) return 100 * 4 + 8;
  return 0;
}
