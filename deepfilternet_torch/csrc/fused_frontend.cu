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
// (7.57 GFLOP at S = 4096) against about 11.5 KB of input and output per
// stream, some 160 flops per byte: bound by operations. On the CUDA cores an
// H100 SXM does 67 TFLOP/s in float32 (115 us a frame at S = 4096); on the
// tensor cores 495 TFLOP/s with TF32 operands, of which float32 accuracy
// costs three passes (46 us), against 15 us to move the bytes. That rate is
// wgmma's; this kernel issues mma.sync, which stays well below it on this
// card, and its time at S = 4096 follows the number of mma.sync it issues. At
// S = 64 the work is 0.12 GFLOP and the time is the latency of one block's K
// loop: 30 slices, each a wait for its copies and a chain of dependent
// products.
//
// What the design does about it:
//   * the products run on the tensor cores (mma.sync m16n8k8, TF32 operands,
//     float32 accumulators) with error compensation ("3xTF32"): every operand
//     is split in registers into hi (rounded to TF32's 10 mantissa bits by
//     integer arithmetic on the bit pattern) and lo = x - hi (exact; the
//     tensor core reads its upper 19 bits), and
//     a * b ~ a_lo * b_hi + a_hi * b_lo + a_hi * b_hi, small terms first.
//     The tensor core cuts every sum it returns towards zero; chained over
//     360 products that bias left less than twice the head-room under the
//     limit of 1e-5 of an output's largest value, so each K-slice's 12
//     products are summed from zero and join the running sum by one rounded
//     add (then 1.4e-6 at S = 4096, 5e-7 at S = 64);
//   * block (i, j) owns TS stream rows and NC bins (re and im of each), and
//     both buf and the cos/sin columns stream through shared memory in
//     K-slices of KS rows in a ring of STAGES stages, so shared memory no
//     longer caps the tile or the blocks per multiprocessor. A
//     multiprocessor gets about 27 bytes a clock from L2, and cp.async from
//     every thread stalls the threads at that rate: the cos/sin slice, two
//     thirds of the bytes, comes by one bulk copy (TMA) from a copy the
//     wrapper packs per bin chunk, and only buf's slice by cp.async. The
//     kernel is a template over the tile: 64 streams x 64 bins, 8 warps, for
//     many streams (fewer passes over the DFT columns); 16 streams x 32 bins,
//     4 warps, for few, so that S = 64 starts 64 blocks. The wrapper chooses
//     by S and the card's multiprocessor count;
//   * a warp owns re and im of the same bins, so power, the unit norm and the
//     complex features are finished in registers; the power goes to shared
//     memory for the chunk's ERB band sums, which go to a scratch buffer. The
//     last block of a stream tile to finish (an atomic counter per tile) adds
//     the chunks' band sums in chunk order, so the result does not depend on
//     block timing, and writes the dB, mean-norm outputs;
//   * the ragged last tile is zero-filled on load and masked on store, so any
//     S works. Every block sees every K-slice of buf, so slice sl's part of
//     new_mem is written by the blocks of chunk sl % gridDim.y: the copy is
//     spread over the chunks, and no block's K loop, the time at small S,
//     carries all of it;
//   * __launch_bounds__(THREADS, 2): the large tile's shared memory fits two
//     blocks a multiprocessor, and the bound holds its registers to what two
//     blocks can have (unbounded, ptxas gives it over 128 and one block runs
//     alone);
//   * any D >= 0 and H > 0 works, as for the TPU kernel, whose blocks are
//     whole rows. A K-slice must come from one source, so the packed DFT
//     holds mem's rows padded with zero rows to Dp = ceil(D / KS) * KS, then
//     frame's padded to a multiple of KS; the loads of buf zero-fill the
//     columns past D or H (cp.async with src-size 0, as for rows past S), so
//     that no load leaves its row and no stale stage is multiplied by a zero
//     row. Where a source's rows are not all 16-byte aligned (D or H not a
//     multiple of 4, or an unaligned base) buf is copied 4 bytes at a time,
//     by a build of its own, so that the 16-byte build keeps its code.
//     new_mem[:, j] = buf[:, H + j] is written by index: where H < D it takes
//     columns of both sources, and H need not start a slice.
//
// Measured times, error and the card they were taken on: PERF.md, kernel table.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int KS = 32;      // K rows per shared-memory stage
constexpr int STAGES = 3;   // cp.async ring depth
constexpr int A_LD = KS + 4;  // row stride of the buf slice: conflict-free fragment loads

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;  // 0: nothing is read, 16 zero bytes are written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- bulk copy (TMA, no tensor map) with an mbarrier that counts its bytes
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned ok = 0;
  while (!ok) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// x = hi + lo with hi on TF32's grid (round half away from zero on the bit
// pattern); lo is exact in float32 and is cut to TF32 by the tensor core.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(  // not volatile: a pure function of its operands, free to be scheduled among the loads
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// TS stream rows x NC bins a block; WM x WN warps, each MT m-tiles of 16 rows
// by BT tiles of 8 bins (re and im of each).
template <int TS, int NC, int WM, int WN>
struct Tile {
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int MT = TS / WM / 16;
  static constexpr int BT = NC / WN / 8;
  static constexpr int B_LD = 2 * NC + 8;  // [cos NC | sin NC | pad]
  static constexpr int A_FLOATS = TS * A_LD;
  static constexpr int B_FLOATS = KS * B_LD;
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
  static constexpr int PW_LD = NC + 1;
  static constexpr size_t SMEM = sizeof(float) * (size_t)(STAGES * STAGE_FLOATS);
  static_assert(TS % (16 * WM) == 0 && NC % (8 * WN) == 0, "warp tiles must divide the block tile");
  static_assert(TS * PW_LD <= STAGES * STAGE_FLOATS, "the power tile reuses the ring");
};

// VEC16: buf is copied 16 bytes at a time (every row of mem and frame
// 16-byte aligned), else 4
template <int TS, int NC, int WM, int WN, bool VEC16>
__global__ void __launch_bounds__(Tile<TS, NC, WM, WN>::THREADS, 2) fused_frontend_kernel(
    const float* __restrict__ mem,      // [S, D]
    const float* __restrict__ frame,    // [S, H]
    const float* __restrict__ mean,     // [S, E]
    const float* __restrict__ unit,     // [S, FD]
    const float* __restrict__ dft,      // [FP / NC, Dp + Hp, B_LD]: per bin chunk, K rows of [cos | sin | pad]
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
  using T = Tile<TS, NC, WM, WN>;
  constexpr int THREADS = T::THREADS;
  extern __shared__ __align__(128) float smem[];
  __shared__ bool last_chunk;
  __shared__ __align__(8) unsigned long long full[STAGES];
  constexpr int VEC = VEC16 ? 4 : 1;  // floats a copy
  const int Dp = (D + KS - 1) / KS * KS;  // K rows of mem and of frame in the packed DFT
  const int Np = Dp + (H + KS - 1) / KS * KS;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int row0 = blockIdx.x * TS;
  const int chunk = blockIdx.y;
  const int c0 = chunk * NC;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(full + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::);
  }
  __syncthreads();

  // K-slice k0 of the packed rows lies in one source: columns [col0, col0 +
  // KS) of mem (k0 < Dp) or of frame, of which those below `len` exist
  struct Slice {
    const float* src;
    int len, col0, b0;  // b0: buf column of the slice's first column
  };
  auto slice_at = [&](int k0) {
    return k0 < Dp ? Slice{mem, D, k0, k0} : Slice{frame, H, k0 - Dp, D + k0 - Dp};
  };

  // stage `st` <- K-slice k0: the chunk's rows of [cos | sin] by one bulk copy
  // (the wrapper packs them contiguously, padded as shared memory wants
  // them), buf by cp.async from every thread (rows beyond S and columns
  // beyond the source's: zeros)
  auto issue = [&](int st, int k0) {
    float* As = smem + st * T::STAGE_FLOATS;
    float* Bs = As + T::A_FLOATS;
    if (tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect(full + st, (unsigned)(T::B_FLOATS * sizeof(float)));
      bulk_copy(Bs, dft + ((size_t)chunk * Np + k0) * T::B_LD,
                (unsigned)(T::B_FLOATS * sizeof(float)), full + st);
    }
    const Slice from = slice_at(k0);
    // VEC16: len % 4 == 0, so a group of 4 lies wholly inside or past it
    for (int i = tid; i < TS * (KS / VEC); i += THREADS) {
      const int r = i / (KS / VEC), c = i % (KS / VEC) * VEC;
      const int row = row0 + r;
      const bool ok = row < S && from.col0 + c < from.len;
      const float* src = from.src + (ok ? (size_t)row * from.len + from.col0 + c : 0);
      if constexpr (VEC16)
        cp_async16(As + r * A_LD + c, src, ok);
      else
        cp_async4(As + r * A_LD + c, src, ok);
    }
  };

  float acc_re[T::MT][T::BT][4];
  float acc_im[T::MT][T::BT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::BT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc_re[i][j][q] = acc_im[i][j][q] = 0.f;

  const int n_slices = Np / KS;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_slices) issue(s, s * KS);
    cp_async_commit();
  }
  for (int sl = 0; sl < n_slices; ++sl) {
    cp_async_wait<STAGES - 2>();
    mbar_wait(full + sl % STAGES, (sl / STAGES) & 1);
    __syncthreads();  // slice sl has landed; the stage refilled below is drained
    if (sl + STAGES - 1 < n_slices) issue((sl + STAGES - 1) % STAGES, (sl + STAGES - 1) * KS);
    cp_async_commit();
    const float* As = smem + (sl % STAGES) * T::STAGE_FLOATS;
    const float* Bs = As + T::A_FLOATS;
    const Slice here = slice_at(sl * KS);
    if (sl % (int)gridDim.y == chunk && here.b0 + KS > H) {  // new_mem[:, j] = buf[:, H + j]
      for (int i = tid; i < TS * KS; i += THREADS) {
        const int r = i / KS, c = i % KS;
        if (row0 + r < S && here.col0 + c < here.len && here.b0 + c >= H)
          new_mem[(size_t)(row0 + r) * D + (here.b0 + c - H)] = As[r * A_LD + c];
      }
    }
    // The tensor core cuts each sum it returns towards zero, a bias that
    // grows with the number of chained adds: a slice's 12 products are summed
    // from zero and join the running sum by one rounded add.
    float t_re[T::MT][T::BT][4];
    float t_im[T::MT][T::BT][4];
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int j = 0; j < T::BT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) t_re[i][j][q] = t_im[i][j][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 8) {
      uint32_t a_hi[T::MT][4], a_lo[T::MT][4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        const float* ap = As + (wm * T::MT * 16 + i * 16 + g) * A_LD + kk + t;
        split_tf32(ap[0], a_hi[i][0], a_lo[i][0]);
        split_tf32(ap[8 * A_LD], a_hi[i][1], a_lo[i][1]);
        split_tf32(ap[4], a_hi[i][2], a_lo[i][2]);
        split_tf32(ap[8 * A_LD + 4], a_hi[i][3], a_lo[i][3]);
      }
      uint32_t c_hi[T::BT][2], c_lo[T::BT][2], s_hi[T::BT][2], s_lo[T::BT][2];
#pragma unroll
      for (int j = 0; j < T::BT; ++j) {
        const float* bp = Bs + (kk + t) * T::B_LD + wn * T::BT * 8 + j * 8 + g;
        split_tf32(bp[0], c_hi[j][0], c_lo[j][0]);
        split_tf32(bp[4 * T::B_LD], c_hi[j][1], c_lo[j][1]);
        split_tf32(bp[NC], s_hi[j][0], s_lo[j][0]);
        split_tf32(bp[4 * T::B_LD + NC], s_hi[j][1], s_lo[j][1]);
      }
      // one term of every accumulator before the next term of any: a warp
      // issues in order, and back-to-back products into one accumulator
      // would each wait for the last
#pragma unroll
      for (int j = 0; j < T::BT; ++j)
#pragma unroll
        for (int i = 0; i < T::MT; ++i) {
          mma_tf32(t_re[i][j], a_lo[i], c_hi[j]);
          mma_tf32(t_im[i][j], a_lo[i], s_hi[j]);
        }
#pragma unroll
      for (int j = 0; j < T::BT; ++j)
#pragma unroll
        for (int i = 0; i < T::MT; ++i) {
          mma_tf32(t_re[i][j], a_hi[i], c_lo[j]);
          mma_tf32(t_im[i][j], a_hi[i], s_lo[j]);
        }
#pragma unroll
      for (int j = 0; j < T::BT; ++j)
#pragma unroll
        for (int i = 0; i < T::MT; ++i) {
          mma_tf32(t_re[i][j], a_hi[i], c_hi[j]);
          mma_tf32(t_im[i][j], a_hi[i], s_hi[j]);
        }
    }
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int j = 0; j < T::BT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc_re[i][j][q] += t_re[i][j][q];
          acc_im[i][j][q] += t_im[i][j][q];
        }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the power tile takes its place

  // chunk epilogue: re/im, power to shared memory, unit norm of the DF bins
  float* pw = smem;  // [TS][PW_LD]
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int j = 0; j < T::BT; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = wm * T::MT * 16 + i * 16 + g + (q >> 1) * 8;
        const int b = wn * T::BT * 8 + j * 8 + 2 * t + (q & 1);
        const int row = row0 + r, bin = c0 + b;
        const float re = acc_re[i][j][q];
        const float im = acc_im[i][j][q];
        const float p = re * re + im * im;
        pw[r * T::PW_LD + b] = p;  // zero beyond F: those DFT columns are zero
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
  }
  __syncthreads();

  // this chunk's ERB band sums -> scratch
  const int nb = min(NC, F - c0);
  for (int idx = tid; idx < TS * E; idx += THREADS) {
    const int r = idx / E;
    const int e = idx - r * E;
    const int row = row0 + r;
    if (row >= S) continue;
    const float* prow = pw + r * T::PW_LD;
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

struct Args {
  const float *mem, *frame, *mean, *unit, *dft, *fb;
  float *new_mem, *re_out, *im_out, *fe_out, *fc_re, *fc_im, *mean_out, *unit_out, *band_part;
  unsigned int* done;
  int S, D, H, F, FP, E, FD;
  float alpha, one_minus_alpha;
};

template <int TS, int NC, int WM, int WN, bool VEC16>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using T = Tile<TS, NC, WM, WN>;
  if (a.FP % NC != 0) return cudaErrorInvalidValue;
  auto kernel = fused_frontend_kernel<TS, NC, WM, WN, VEC16>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (err != cudaSuccess) return err;
  // as much shared memory as the multiprocessor has, so that two blocks fit
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.S + TS - 1) / TS), (unsigned)(a.FP / NC));
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(
      a.mem, a.frame, a.mean, a.unit, a.dft, a.fb, a.new_mem, a.re_out, a.im_out,
      a.fe_out, a.fc_re, a.fc_im, a.mean_out, a.unit_out, a.band_part, a.done, a.S, a.D, a.H,
      a.F, a.FP, a.E, a.FD, a.alpha, a.one_minus_alpha);
  return cudaGetLastError();
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). The caller owns every buffer; all are float32 (`done`: uint32),
// contiguous and row-major. tile_rows picks the build: 64 (64 streams x NC = 64
// bins a block) or 16 (16 streams x NC = 32 bins). dft is the windowed DFT
// packed for that build: [FP / NC, Dp + Hp, 2 * NC + 8], chunk c's K rows of
// [cos[:, c*NC:(c+1)*NC] | sin[...] | 8 floats of padding], zero in the
// columns at and beyond F; its rows are the D rows of mem, zero rows up to
// Dp = ceil(D / 32) * 32, the H rows of frame and zero rows up to
// Hp = ceil(H / 32) * 32. band_part is [FP / NC, S, E]; done holds
// ceil(S / tile_rows) zeros.
int dfn_fused_frontend(const float* mem, const float* frame, const float* mean,
                       const float* unit, const float* dft,
                       const float* fb, float* new_mem, float* re_out, float* im_out,
                       float* fe_out, float* fc_re, float* fc_im, float* mean_out,
                       float* unit_out, float* band_part, unsigned int* done, int S, int D,
                       int H, int F, int FP, int E, int FD, float alpha,
                       float one_minus_alpha, int tile_rows, void* stream) {
  if (S <= 0) return 0;
  if (D < 0 || H <= 0 || FP < F || FD > F)
    return (int)cudaErrorInvalidValue;
  const Args a{mem, frame, mean, unit, dft, fb, new_mem, re_out, im_out, fe_out,
               fc_re, fc_im, mean_out, unit_out, band_part, done, S, D, H, F, FP, E, FD,
               alpha, one_minus_alpha};
  cudaStream_t st = (cudaStream_t)stream;
  // 16-byte copies need every row of both sources 16-byte aligned
  const bool vec16 = D % 4 == 0 && H % 4 == 0 && reinterpret_cast<uintptr_t>(frame) % 16 == 0 &&
                     (D == 0 || reinterpret_cast<uintptr_t>(mem) % 16 == 0);
  if (tile_rows == 64)
    return (int)(vec16 ? launch<64, 64, 2, 4, true>(a, st) : launch<64, 64, 2, 4, false>(a, st));
  if (tile_rows == 16)
    return (int)(vec16 ? launch<16, 32, 1, 4, true>(a, st) : launch<16, 32, 1, 4, false>(a, st));
  return (int)cudaErrorInvalidValue;
}

// An empty kernel on `stream`: what a launch alone costs on this card.
int dfn_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
