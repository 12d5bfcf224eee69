// Fused s2d encoder pair for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel oct_image_segmentation_models_tpu/ops/
// s2d_pallas.py::fused_enc_pair (body _build_kernel, masks _masks). It
// computes what ops/s2d_enc_pair.py::fused_enc_pair_reference in the PyTorch
// package computes, up to float32 summation order: for one s2d U-Net encoder
// level with x (B, nh, nw, 4Cin) in block space,
//   y1[r, s] = relu(b1 + sum_{a, e in {0,1}} x[r-1+a, s-1+e] . w1[a, e]),
//              r in [0, nh], s in [0, nw], zero outside x, then the shifted
//              edge masks (phase q_h = 0 of row 0, q_h = 1 of row nh, q_w = 0
//              of column 0, q_w = 1 of column nw are zeroed);
//   y2[r, s] = relu(b2 + sum_{a, e in {0,1}} y1[r+a, s+e] . w2[a, e]);
//   pooled[r, s, c] = max_q y2[r, s, q*C + c]   (channel order (q_h, q_w, c)).
//
// Design. One CTA of 256 threads per (batch, strip of TR block rows, tile of
// TC block columns). Phase 1 computes the y1 tile for those rows and columns
// plus one halo row and one halo column, (TR+1) x (TC+1) pixels x 4C, into
// shared memory, with bias, ReLU and the edge masks. Phase 2 computes y2
// reading y1 only from shared memory and writes it to device memory; phase 3
// reads the CTA's own y2 back (after a barrier) and writes the phase max. So
// y1 never touches device memory. Both convs run output channels in chunks
// of 64: lane l owns channels 2l and 2l+1 of the chunk, warp w owns pixels
// w, w+8, w+16, ... of the tile; each input value is a warp-wide broadcast
// (x through the read-only cache, y1 from shared memory) and each weight pair
// a float2 load from device memory and L2 shared by the CTA's warps. float32
// FMA on the CUDA cores: TF32 stays off, as in the reference forward.
//
// Shared memory: (TR+1)(TC+1) * 4C * 4 bytes. TR x TC = 8 x 16 takes 153 KB at
// 4C = 256 (the flagship level 1), so one CTA per SM; 4C > 379 uses 4 x 8.
//
// Bound on the H100. Compute: at the flagship level-1 shape (B 8, nh 128,
// nw 256, 4Cin 128, 4C 256) the dense block-space work is 2.1e11 FLOP per
// call, 3.1 ms at the 67 TFLOP/s float32 rate, against 0.47 GB of traffic
// (x read once, y2 and pooled written once: 0.14 ms at 3.35 TB/s). This first
// design is plain SIMT FMA with weights from L2; wgmma and TMA (which need
// TF32 or bf16 operands, or a 3xTF32 split to keep float32 accuracy) are left
// for a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;  // output channels per pass: 32 lanes x 2

struct Shape {
  int nh, nw, cin4, c4;
};

// Four k-steps of the dot products of kPx pixels with one weight pair each:
// acc[i] += v_i[0..3] . (wv[0..3].x, wv[0..3].y).
template <int kPx>
__device__ __forceinline__ void fma4(float (&acc)[kPx][2], const float4& v, int i,
                                     const float2 (&wv)[4]) {
  acc[i][0] = fmaf(v.x, wv[0].x, acc[i][0]);
  acc[i][1] = fmaf(v.x, wv[0].y, acc[i][1]);
  acc[i][0] = fmaf(v.y, wv[1].x, acc[i][0]);
  acc[i][1] = fmaf(v.y, wv[1].y, acc[i][1]);
  acc[i][0] = fmaf(v.z, wv[2].x, acc[i][0]);
  acc[i][1] = fmaf(v.z, wv[2].y, acc[i][1]);
  acc[i][0] = fmaf(v.w, wv[3].x, acc[i][0]);
  acc[i][1] = fmaf(v.w, wv[3].y, acc[i][1]);
}

template <int TR, int TC>
__global__ void __launch_bounds__(kThreads, 1)
    enc_pair_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, float* y2, float* __restrict__ pooled,
                    Shape sh) {
  constexpr int kY1Cols = TC + 1;
  constexpr int kY1Pix = (TR + 1) * kY1Cols;
  constexpr int kY2Pix = TR * TC;
  constexpr int kPx1 = (kY1Pix + kWarps - 1) / kWarps;
  constexpr int kPx2 = (kY2Pix + kWarps - 1) / kWarps;
  extern __shared__ __align__(16) float y1s[];  // [kY1Pix][c4]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s0 = blockIdx.x * TC, r0 = blockIdx.y * TR, bi = blockIdx.z;
  const int nh = sh.nh, nw = sh.nw, cin4 = sh.cin4, c4 = sh.c4, c = c4 / 4;
  const float* xb = x + (size_t)bi * nh * nw * cin4;

  // Phase 1: y1 tile, shifted rows r0..r0+TR and columns s0..s0+TC.
  for (int ch0 = 0; ch0 < c4; ch0 += kChunk) {
    const int ch = ch0 + 2 * lane;
    const bool lane_on = ch < c4;
    const int chl = lane_on ? ch : c4 - 2;  // in-bounds loads for idle lanes
    float acc[kPx1][2];
    const float2 bias = *reinterpret_cast<const float2*>(b1 + chl);
#pragma unroll
    for (int i = 0; i < kPx1; ++i) {
      acc[i][0] = bias.x;
      acc[i][1] = bias.y;
    }
    for (int tap = 0; tap < 4; ++tap) {
      const int a = tap >> 1, e = tap & 1;
      int src[kPx1];  // x pixel offset of each y1 pixel for this tap, -1 = zero
#pragma unroll
      for (int i = 0; i < kPx1; ++i) {
        const int p = warp + kWarps * i;
        const int xr = r0 + p / kY1Cols - 1 + a;
        const int xc = s0 + p % kY1Cols - 1 + e;
        const bool in = p < kY1Pix && xr >= 0 && xr < nh && xc >= 0 && xc < nw;
        src[i] = in ? (xr * nw + xc) * cin4 : -1;
      }
      const float* wt = w1 + (size_t)tap * cin4 * c4 + chl;
#pragma unroll 2
      for (int k = 0; k < cin4; k += 4) {
        float2 wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wv[q] = __ldg(reinterpret_cast<const float2*>(wt + (size_t)(k + q) * c4));
#pragma unroll
        for (int i = 0; i < kPx1; ++i) {
          if (src[i] >= 0) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(xb + src[i] + k));
            fma4<kPx1>(acc, v, i, wv);
          }
        }
      }
    }
    // ReLU and the shifted-edge masks; pixels past the level's edge are 0.
    if (lane_on) {
      const int q = ch / c;  // ch and ch+1 share a phase group (c is even)
      const int qh = q >> 1, qw = q & 1;
#pragma unroll
      for (int i = 0; i < kPx1; ++i) {
        const int p = warp + kWarps * i;
        if (p >= kY1Pix) continue;
        const int r = r0 + p / kY1Cols, s = s0 + p % kY1Cols;
        const bool keep = r <= nh && s <= nw && !(r == 0 && qh == 0) &&
                          !(r == nh && qh == 1) && !(s == 0 && qw == 0) &&
                          !(s == nw && qw == 1);
        float2 out = make_float2(0.f, 0.f);
        if (keep) out = make_float2(fmaxf(acc[i][0], 0.f), fmaxf(acc[i][1], 0.f));
        *reinterpret_cast<float2*>(y1s + p * c4 + ch) = out;
      }
    }
  }
  __syncthreads();

  // Phase 2: y2 tile from y1 in shared memory.
  for (int ch0 = 0; ch0 < c4; ch0 += kChunk) {
    const int ch = ch0 + 2 * lane;
    const bool lane_on = ch < c4;
    const int chl = lane_on ? ch : c4 - 2;
    float acc[kPx2][2];
    const float2 bias = *reinterpret_cast<const float2*>(b2 + chl);
#pragma unroll
    for (int i = 0; i < kPx2; ++i) {
      acc[i][0] = bias.x;
      acc[i][1] = bias.y;
    }
    for (int tap = 0; tap < 4; ++tap) {
      const int a = tap >> 1, e = tap & 1;
      int src[kPx2];  // y1 offset in shared memory, -1 = no such pixel
#pragma unroll
      for (int i = 0; i < kPx2; ++i) {
        const int p = warp + kWarps * i;
        src[i] = p < kY2Pix ? ((p / TC + a) * kY1Cols + p % TC + e) * c4 : -1;
      }
      const float* wt = w2 + (size_t)tap * c4 * c4 + chl;
#pragma unroll 2
      for (int k = 0; k < c4; k += 4) {
        float2 wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wv[q] = __ldg(reinterpret_cast<const float2*>(wt + (size_t)(k + q) * c4));
#pragma unroll
        for (int i = 0; i < kPx2; ++i) {
          if (src[i] >= 0) {
            const float4 v = *reinterpret_cast<const float4*>(y1s + src[i] + k);
            fma4<kPx2>(acc, v, i, wv);
          }
        }
      }
    }
    if (lane_on) {
#pragma unroll
      for (int i = 0; i < kPx2; ++i) {
        const int p = warp + kWarps * i;
        if (p >= kY2Pix) continue;
        const int r = r0 + p / TC, s = s0 + p % TC;
        if (r >= nh || s >= nw) continue;
        float* out = y2 + (((size_t)bi * nh + r) * nw + s) * c4 + ch;
        *reinterpret_cast<float2*>(out) =
            make_float2(fmaxf(acc[i][0], 0.f), fmaxf(acc[i][1], 0.f));
      }
    }
  }
  // The barrier makes this CTA's y2 stores visible to all its threads.
  __syncthreads();

  // Phase 3: max over the 4 phase groups of the CTA's own y2.
  for (int t = threadIdx.x; t < kY2Pix * c; t += kThreads) {
    const int p = t / c, cc = t % c;
    const int r = r0 + p / TC, s = s0 + p % TC;
    if (r >= nh || s >= nw) continue;
    const size_t pix = ((size_t)bi * nh + r) * nw + s;
    const float* yp = y2 + pix * c4 + cc;
    pooled[pix * c + cc] = fmaxf(fmaxf(yp[0], yp[c]), fmaxf(yp[2 * c], yp[3 * c]));
  }
}

template <int TR, int TC>
size_t smem_bytes(int c4) {
  return (size_t)(TR + 1) * (TC + 1) * c4 * sizeof(float);
}

template <int TR, int TC>
cudaError_t launch(const float* x, const float* w1, const float* b1, const float* w2,
                   const float* b2, float* y2, float* pooled, int b, const Shape& sh,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<TR, TC>(sh.c4);
  cudaError_t err = cudaFuncSetAttribute(
      enc_pair_kernel<TR, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.nw + TC - 1) / TC, (sh.nh + TR - 1) / TR, b);
  enc_pair_kernel<TR, TC><<<grid, kThreads, smem, stream>>>(x, w1, b1, w2, b2, y2,
                                                           pooled, sh);
  return cudaGetLastError();
}

constexpr size_t kMaxSmem = 227 * 1024;

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
  const Shape sh{nh, nw, cin4, c4};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem_bytes<8, 16>(c4) <= kMaxSmem)
    return (int)launch<8, 16>(x, w1, b1, w2, b2, y2, pooled, b, sh, s);
  if (smem_bytes<4, 8>(c4) <= kMaxSmem)
    return (int)launch<4, 8>(x, w1, b1, w2, b2, y2, pooled, b, sh, s);
  return (int)cudaErrorInvalidValue;
}
