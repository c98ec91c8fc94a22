// Fused streaming analysis frontend for one frame of S streams (Hopper, sm_90a).
//
// Replaces the TPU kernel deepfilternet_tpu/ops/pallas_frontend.py::_kernel,
// launched by fused_analysis_frontend. For each stream row it computes
//
//   buf      = [mem | frame]                                   [S, N]
//   re, im   = buf @ cos, buf @ sin                            [S, F]  (window + wnorm folded in)
//   power    = re^2 + im^2
//   erb_db   = 10 * log10(power @ fb + 1e-10)                  [S, E]
//   mean'    = (1 - a) * erb_db + a * mean,   feat_erb = (erb_db - mean') / 40
//   unit'    = (1 - a) * sqrt(power[:, :FD]) + a * unit,      fc = spec[:, :FD] * rsqrt(unit')
//   new_mem  = buf[:, H:]
//
// and writes the eight outputs. Only the ERB band sums of each bin chunk
// (S x E floats per chunk) pass through device memory.
//
// What bounds it: at N = 960, F = 481 the two DFT products are 2*S*N*2F flops
// (7.57 GFLOP at S = 4096) against about 11.5 KB of input and output per stream,
// some 160 flops per byte, so in float32 on the CUDA cores the kernel is bound
// by operations (an H100 SXM does about 67 TFLOP/s in float32 outside the
// tensor cores: ~115 us per frame at S = 4096, against ~15 us to move the bytes).
//
// What the design does about it: it keeps the operands of the products on chip
// and spreads them over enough blocks. Block (i, j) owns the tile of TS = 32
// streams i and the chunk of NC = 128 bins j, so even a few streams fill
// several SMs. The tile's buf sits in shared memory, transposed so that one
// 16-byte load gives a thread the four rows it owns. The cos and sin columns
// of the chunk (resident in L2 across blocks) stream through shared memory in
// K-slices of KS rows; the next slice is fetched into registers while the
// current one is multiplied. Each thread accumulates a 4 x 4 tile of re and of
// im in registers (32 FMAs per three shared-memory loads), in float32 on the
// CUDA cores. The chunk's epilogue writes re/im and the unit-norm outputs and
// keeps the power in shared memory for the chunk's ERB band sums, which go to
// a scratch buffer. The last block of a stream tile to finish (an atomic
// counter per tile) adds the chunks' band sums in chunk order, so the result
// does not depend on block timing, and writes the dB, mean-norm outputs. The
// ragged last tile is masked, so any S works. Tensor cores (wgmma, 3xTF32
// splitting) and TMA are left for later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TS = 32;          // stream rows per block
constexpr int NC = 128;         // DFT bins per block
constexpr int KS = 16;          // K rows of cos/sin staged per shared-memory slice
constexpr int THREADS = 256;    // 8 warps: warp ty owns rows 4ty..4ty+3, lane tx bins 4tx..4tx+3
constexpr int BUF_LD = TS + 4;  // stride of the transposed buf; keeps float4 loads aligned
constexpr int SLICE_V4 = KS * NC / 4 / THREADS;  // float4 of cos (and of sin) per thread per slice

static_assert(KS * NC % (4 * THREADS) == 0, "a slice must split evenly over the threads");

// Loads this thread's part of the K-slice [k0, k0 + KS) x [c0, c0 + NC) of
// cos_m and sin_m (row stride FP) into registers.
__device__ __forceinline__ void fetch_slice(const float* __restrict__ cos_m,
                                            const float* __restrict__ sin_m, int FP, int k0,
                                            int c0, int tid, float4* pre_c, float4* pre_s) {
#pragma unroll
  for (int v = 0; v < SLICE_V4; ++v) {
    const int i = tid + v * THREADS;
    const size_t g = (size_t)(k0 + i / (NC / 4)) * FP + c0 + (i % (NC / 4)) * 4;
    pre_c[v] = __ldg(reinterpret_cast<const float4*>(cos_m + g));
    pre_s[v] = __ldg(reinterpret_cast<const float4*>(sin_m + g));
  }
}

__global__ void __launch_bounds__(THREADS, 1) fused_frontend_kernel(
    const float* __restrict__ mem,      // [S, D]
    const float* __restrict__ frame,    // [S, H]
    const float* __restrict__ mean,     // [S, E]
    const float* __restrict__ unit,     // [S, FD]
    const float* __restrict__ cos_m,    // [N, FP], zero beyond F
    const float* __restrict__ sin_m,    // [N, FP], zero beyond F
    const float* __restrict__ fb,       // [F, E]
    float* __restrict__ new_mem,        // [S, D]
    float* __restrict__ re_out,         // [S, F]
    float* __restrict__ im_out,         // [S, F]
    float* __restrict__ fe_out,         // [S, E]
    float* __restrict__ fc_re,          // [S, FD]
    float* __restrict__ fc_im,          // [S, FD]
    float* __restrict__ mean_out,       // [S, E]
    float* __restrict__ unit_out,       // [S, FD]
    float* __restrict__ band_part,      // [FP / NC, S, E] scratch: per-chunk band sums
    unsigned int* __restrict__ done,    // [ceil(S / TS)], zero at launch
    int S, int D, int H, int F, int FP, int E, int FD,
    float alpha, float one_minus_alpha) {
  extern __shared__ __align__(16) float smem[];
  __shared__ bool last_chunk;
  const int N = D + H;
  float* buf_t = smem;                  // [N][BUF_LD]
  float* cs = buf_t + N * BUF_LD;       // [KS][NC]
  float* sn = cs + KS * NC;             // [KS][NC]
  float* pw = sn + KS * NC;             // [TS][NC]

  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int row0 = blockIdx.x * TS;
  const int chunk = blockIdx.y;
  const int c0 = chunk * NC;

  // stage buf = [mem | frame] transposed; chunk 0 writes new_mem = buf[:, H:]
  const bool write_mem = chunk == 0;
  for (int idx = tid; idx < TS * D; idx += THREADS) {
    const int r = idx / D;
    const int k = idx - r * D;
    const int row = row0 + r;
    const float v = row < S ? mem[(size_t)row * D + k] : 0.f;
    buf_t[k * BUF_LD + r] = v;
    if (write_mem && row < S && k >= H) new_mem[(size_t)row * D + (k - H)] = v;
  }
  for (int idx = tid; idx < TS * H; idx += THREADS) {
    const int r = idx / H;
    const int k = idx - r * H;
    const int row = row0 + r;
    const float v = row < S ? frame[(size_t)row * H + k] : 0.f;
    buf_t[(D + k) * BUF_LD + r] = v;
    if (write_mem && row < S && D + k >= H) new_mem[(size_t)row * D + (D + k - H)] = v;
  }

  float acc_re[4][4];
  float acc_im[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc_re[i][j] = 0.f;
      acc_im[i][j] = 0.f;
    }
  }
  float4 pre_c[SLICE_V4];
  float4 pre_s[SLICE_V4];
  fetch_slice(cos_m, sin_m, FP, 0, c0, tid, pre_c, pre_s);
  for (int k0 = 0; k0 < N; k0 += KS) {
    __syncthreads();  // buf staged / previous slice consumed
#pragma unroll
    for (int v = 0; v < SLICE_V4; ++v) {
      const int i = tid + v * THREADS;
      const int off = (i / (NC / 4)) * NC + (i % (NC / 4)) * 4;
      *reinterpret_cast<float4*>(cs + off) = pre_c[v];
      *reinterpret_cast<float4*>(sn + off) = pre_s[v];
    }
    __syncthreads();
    if (k0 + KS < N) fetch_slice(cos_m, sin_m, FP, k0 + KS, c0, tid, pre_c, pre_s);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(buf_t + (k0 + kk) * BUF_LD + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(cs + kk * NC + tx * 4);
      const float4 s = *reinterpret_cast<const float4*>(sn + kk * NC + tx * 4);
      const float bv[4] = {b.x, b.y, b.z, b.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_re[i][j] = fmaf(bv[i], cv[j], acc_re[i][j]);
          acc_im[i][j] = fmaf(bv[i], sv[j], acc_im[i][j]);
        }
      }
    }
  }

  // chunk epilogue: re/im, power to shared memory, unit norm of the DF bins
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int row = row0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = tx * 4 + j;
      const int bin = c0 + b;
      const float re = acc_re[i][j];
      const float im = acc_im[i][j];
      const float p = re * re + im * im;
      pw[r * NC + b] = p;  // zero beyond F: those DFT columns are zero
      if (row >= S || bin >= F) continue;
      re_out[(size_t)row * F + bin] = re;
      im_out[(size_t)row * F + bin] = im;
      if (bin < FD) {
        const size_t o = (size_t)row * FD + bin;
        const float u = sqrtf(p) * one_minus_alpha + unit[o] * alpha;
        const float scale = rsqrtf(u);
        unit_out[o] = u;
        fc_re[o] = re * scale;
        fc_im[o] = im * scale;
      }
    }
  }
  __syncthreads();

  // this chunk's ERB band sums -> scratch
  const int nb = min(NC, F - c0);
  for (int idx = tid; idx < TS * E; idx += THREADS) {
    const int r = idx / E;
    const int e = idx - r * E;
    const int row = row0 + r;
    if (row >= S) continue;
    const float* prow = pw + r * NC;
    const float* fcol = fb + (size_t)c0 * E + e;
    float a0 = 0.f, a1 = 0.f;  // two independent FMA chains
    int b = 0;
    for (; b + 1 < nb; b += 2) {
      a0 = fmaf(prow[b], __ldg(fcol + (size_t)b * E), a0);
      a1 = fmaf(prow[b + 1], __ldg(fcol + (size_t)(b + 1) * E), a1);
    }
    if (b < nb) a0 = fmaf(prow[b], __ldg(fcol + (size_t)b * E), a0);
    band_part[((size_t)chunk * S + row) * E + e] = a0 + a1;
  }

  // the last chunk of this stream tile to finish adds the chunks' sums in order
  __threadfence();
  __syncthreads();
  if (tid == 0) last_chunk = atomicAdd(done + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last_chunk) return;
  __threadfence();
  for (int idx = tid; idx < TS * E; idx += THREADS) {
    const int r = idx / E;
    const int e = idx - r * E;
    const int row = row0 + r;
    if (row >= S) continue;
    float acc = 0.f;
    for (int c = 0; c < (int)gridDim.y; ++c) acc += __ldcg(band_part + ((size_t)c * S + row) * E + e);
    const float db = 10.f * log10f(acc + 1e-10f);
    const size_t o = (size_t)row * E + e;
    const float m = db * one_minus_alpha + mean[o] * alpha;
    fe_out[o] = (db - m) / 40.f;
    mean_out[o] = m;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). The caller owns every buffer; all are float32 (`done`: uint32),
// contiguous and row-major. cos_m/sin_m are [D + H, FP] with FP a multiple of
// 128, zero in the columns at and beyond F. band_part is [FP / 128, S, E];
// done holds ceil(S / 32) zeros.
int dfn_fused_frontend(const float* mem, const float* frame, const float* mean,
                       const float* unit, const float* cos_m, const float* sin_m,
                       const float* fb, float* new_mem, float* re_out, float* im_out,
                       float* fe_out, float* fc_re, float* fc_im, float* mean_out,
                       float* unit_out, float* band_part, unsigned int* done, int S, int D,
                       int H, int F, int FP, int E, int FD, float alpha,
                       float one_minus_alpha, void* stream) {
  if (S <= 0) return 0;
  if (D < 0 || H <= 0 || (D + H) % KS != 0 || FP % NC != 0 || FP < F || F <= FP - NC ||
      FD > F) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = ((size_t)(D + H) * BUF_LD + 2 * KS * NC + TS * NC) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_frontend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + TS - 1) / TS), (unsigned)(FP / NC));
  fused_frontend_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      mem, frame, mean, unit, cos_m, sin_m, fb, new_mem, re_out, im_out, fe_out, fc_re,
      fc_im, mean_out, unit_out, band_part, done, S, D, H, F, FP, E, FD, alpha,
      one_minus_alpha);
  return (int)cudaGetLastError();
}

}  // extern "C"
