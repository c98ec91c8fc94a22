// Whole-cell streaming DFN3 for S streams, all frames of a call in one launch
// (Hopper, sm_90a).
//
// Replaces the TPU kernel deepfilternet_tpu/ops/pallas_cell.py (the kernel
// closure of make_cell_kernel with its body _frame_step / _frame_tail,
// launched by cell_process). For every stream row and frame it computes the
// analysis DFT, the ERB / unit-norm features and their exponential norms, the
// dense-folded encoder convs, the three GRU stacks, the LSNR head, the ERB
// decoder and mask, the DF coefficient head and the order-5 complex MAC over
// a 4-frame ring, the ERB mask through erb_inv, post-filter, LSNR gating,
// attenuation limit, the RMS silence counter and mute, and the iDFT synthesis
// with overlap-add. The carry (11 arrays, CKEYS order) is read once at the
// start of a tile of streams and written once at its end. Every matrix product
// of the frame is computed here: in float32 FMAs on the CUDA cores (float32
// build), or on the tensor cores (bfloat16 build, mma.sync m16n8k16).
//
// This is the row-tile design: one persistent block per tile of 4 or 8 stream
// rows computes every product of the frame by itself. The wrapper launches it
// for many streams only (ops/whole_cell.py::_kernel_choice); for few streams
// the design of whole_cell.cu, which spreads every product over the whole
// card, is several times faster.
//
// What bounds it: a frame is about 7.2 M multiply-adds a stream (8.1 M at the
// padded widths the weights are stored at) against 28 MB of float32 weights
// that every thread block must read once a frame, from L2, at the 27 bytes a
// clock one multiprocessor gets from it. With 8 rows a block and all
// multiprocessors busy the weight stream and the FMAs cost about the same in
// the float32 build. In the bfloat16 build the tensor cores leave the weight
// stream alone as the bound: 14.3 MB a tile and frame, which 16 rows a block
// share among twice the streams.
//
// What the design does about it:
//   * one persistent block of 512 threads per tile of R = 4 or 8 streams
//     (template; 16 in the bfloat16 build), looping over the call's frames;
//     blocks beyond the number
//     of multiprocessors are folded into a loop over tiles, so the scratch
//     is bounded by the card and not by S. The ragged last tile reads the
//     last valid stream again for its missing rows and stores nothing for them;
//   * one device routine gemm<R>: y[R, N] = act(x[R, K] @ W[K, N] + b) + addend.
//     x is staged in shared memory transposed ([K][R], so one 16-byte
//     broadcast load gives a thread 4 rows of one k), every thread owns 4
//     neighbouring columns (one 16-byte coalesced weight load for 4R FMAs,
//     4 such loads in flight while the last 4 are multiplied) and, where
//     N / 4 is below the thread count, a slice of K; slices are then added
//     in shared memory in slice order, so results do not depend on timing
//     or on R;
//   * the synthesis product against dft^T (gemm_t) gives each warp an output
//     sample: lanes stride K with 16-byte loads and reduce by shuffles;
//   * activations and the per-frame state live in a per-block scratch in
//     global memory (L1/L2 resident; allocated by the wrapper): about 70 KB a
//     stream row. Rolling windows (conv contexts, DF ring, analysis memory)
//     are shifted in place by the thread that owns the element;
//   * static scalars and the stage switches are kernel arguments; the 65 weight
//     pointers travel in the argument struct, copied by value;
//   * when the launch passes a record buffer, thread 0 of every block adds
//     up its SM cycles in each stage of the frame (and in the carry's load
//     and store) and writes them out in ns, scaled by the block's own span
//     of the global timer, with that span, so a run can say where a frame's
//     time goes and how long each multiprocessor held work. The timers are a
//     kernel of their own, whole_cell_recording, which the launch picks when
//     it passes a buffer; the kernel that ships, whole_cell_kernel, has no
//     timer code and reads no clock, and a trace tells the two apart by name.
//
// Two builds, by the weights' type (the TPU kernel's mdtype): float32 (R = 4,
// 8), and bfloat16 (R = 4, 8, 16), the JAX package's default. The bfloat16
// build runs every product on the tensor cores, as the TPU kernel runs it on
// its MXU (gemm_mma): y^T = W^T x^T with mma.sync m16n8k16, bfloat16 x
// bfloat16 -> float32, A the weight from a copy the wrapper packs once per
// weight set in A-fragment order (one 16-byte load a lane and step, in place
// of widening loads), B the block's R streams staged as bfloat16 pairs by
// cvt.rn.bf16x2.f32, which is the rounding of the input to bfloat16; the
// synthesis product is one of them, against a packed dft^T. Biases and small
// vectors are read as bfloat16 (imult and convp_b stay float32). How sums
// join: the tensor core's accumulating adds truncate, so a chain of steps
// never spans more than one 64-row chunk of K; chunks are added rounded to
// nearest in K order, K slices in slice order. The error stays a float32
// one, within what the bfloat16 gate allows (ops/whole_cell_check.py,
// TensorCoreSums, which sums in this order). Each result is rounded where the
// plain version's `mm` rounds (Rnd; df_conv0's three window products each
// rounded before they are added). Gates, norms, the DF MAC, the runtime
// stages and the carry stay float32.
//
// Measured times and the card they were taken on: PERF.md, kernel table.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

namespace {

constexpr int THREADS = 512;
constexpr int UNROLL = 4;  // weight rows a thread keeps in flight per batch
constexpr int NWARPS = THREADS / 32;
constexpr int HOP = 480;
constexpr int FFT = 960;
constexpr int FPAD = 512;
constexpr int BLK = 128;
constexpr int NB_ERB = 32;
constexpr int NB_DF = 96;
constexpr int HID = 256;
constexpr int CH = 16;
constexpr int ORDER = 5;
constexpr int KMAX = 2048;  // widest product input (c1)
constexpr float PI_F = 3.14159265358979323846f;

// weight pointers, WKEYS order
enum WKey {
  W_DFT, W_IMULT, W_ERB_FWD, W_ERB_INV,
  W_E0_W, W_E0_B, W_E1_W, W_E1_B, W_E2_W, W_E2_B, W_E3_W, W_E3_B,
  W_C0W_T0, W_C0W_T1, W_C0W_T2, W_C0_B, W_C1_W, W_C1_B, W_GL_W,
  W_P3_W, W_P3_B, W_T3_W, W_T3_B, W_P2_W, W_P2_B, W_T2_W, W_T2_B,
  W_P1_W, W_P1_B, W_T1_W, W_T1_B, W_P0_W, W_P0_B, W_OUT_W, W_OUT_B,
  W_ENC_LIN_IN, W_ENC_WIH, W_ENC_WHH, W_ENC_BIH, W_ENC_BHH, W_ENC_LIN_OUT,
  W_LSNR_W, W_LSNR_B,
  W_DEC_LIN_IN, W_DEC_WIH, W_DEC_WHH, W_DEC_BIH, W_DEC_BHH, W_DEC_LIN_OUT,
  W_DF_LIN_IN,
  W_DF_WIH0, W_DF_WHH0, W_DF_BIH0, W_DF_BHH0,
  W_DF_WIH1, W_DF_WHH1, W_DF_BIH1, W_DF_BHH1,
  W_DF_WIH2, W_DF_WHH2, W_DF_BIH2, W_DF_BHH2,
  W_DF_OUT_W, W_CONVP_CO, W_CONVP_B,
  N_WKEYS
};

constexpr int P_DFT_T = N_WKEYS;  // Params::pk's entry of the synthesis product

// carry arrays, CKEYS order
enum CKey { C_AMEM, C_SMEM, C_NORMS, C_SIL, C_ERB_CTX, C_SPEC_CTX, C_ENC_H, C_DEC_H,
            C_DF_H, C_RING_RE, C_RING_IM, N_CKEYS };

// per-row scratch layout, in floats; every offset is a multiple of 4
constexpr int O_BUF = 0;                     // [prev_hop | frame]         960
constexpr int O_SPEC = O_BUF + FFT;          // [re | im]                 1024
constexpr int O_POW = O_SPEC + 2 * FPAD;     // power                      512
constexpr int O_ERBWIN = O_POW + FPAD;       // [erb t-2 | t-1 | t]         96
constexpr int O_FSWIN = O_ERBWIN + 96;       // [fs t-2 | t-1 | t], 192 each: [re | im]
constexpr int O_E0 = O_FSWIN + 576;          // 512
constexpr int O_E1 = O_E0 + 512;             // 256
constexpr int O_E2 = O_E1 + 256;             // 128
constexpr int O_E3 = O_E2 + 128;             // 128
constexpr int O_C0 = O_E3 + 128;             // 2048
constexpr int O_C1 = O_C0 + CH * BLK;        // 768
constexpr int O_EMB = O_C1 + 768;            // 128  e3 + cemb
constexpr int O_XIN = O_EMB + 128;           // 256  GRU stack input
constexpr int O_GI = O_XIN + HID;            // 768
constexpr int O_GH = O_GI + 3 * HID;         // 768
constexpr int O_EMB2 = O_GH + 3 * HID;       // 128  encoder output embedding
constexpr int O_DEMB = O_EMB2 + 128;         // 128
constexpr int O_PA = O_DEMB + 128;           // 512  decoder pathway ping
constexpr int O_PB = O_PA + 512;             // 512  decoder pathway pong
constexpr int O_MASK = O_PB + 512;           // 32
constexpr int O_COEF = O_MASK + NB_ERB;      // 1280
constexpr int O_Y = O_COEF + ORDER * 2 * BLK;  // [y_re | y_im] 256
constexpr int O_GAIN = O_Y + 2 * BLK;        // 512  (also the raw ERB band sums)
constexpr int O_SE = O_GAIN + FPAD;          // [se_re*imult | se_im*imult] 1024
constexpr int O_X = O_SE + 2 * FPAD;         // synthesis frame 960
constexpr int O_SMEM = O_X + FFT;            // 480
constexpr int O_MEAN = O_SMEM + HOP;         // 32
constexpr int O_UNIT = O_MEAN + NB_ERB;      // 96
constexpr int O_ENC_H = O_UNIT + NB_DF;      // 256
constexpr int O_DEC_H = O_ENC_H + HID;       // 256
constexpr int O_DF_H = O_DEC_H + HID;        // 768
constexpr int O_RING_RE = O_DF_H + 3 * HID;  // 512
constexpr int O_RING_IM = O_RING_RE + 4 * BLK;  // 512
constexpr int SCR = O_RING_IM + 4 * BLK;
static_assert(SCR % 4 == 0 && O_FSWIN % 4 == 0 && O_MASK % 4 == 0 && O_MEAN % 4 == 0,
              "scratch offsets must keep 16-byte alignment");

enum Act { ACT_NONE, ACT_RELU, ACT_SIGMOID, ACT_TANH };
// where the bfloat16 build rounds a product's result: never (float32); the sum
// only (the bias then added in float32: h @ w_hh, whose bias joins the GRU
// gates); the sum, the bias add and the addend add (the model trunk)
enum Rnd { R_F32, R_SUM, R_TRUNK };

// stages whose time every block adds up when the launch records (see
// Params::records); ST_CARRY is the carry's load and store around a tile
enum Stage { ST_FRAME_IN, ST_ANALYSIS, ST_FEATURES, ST_ERB_CONVS, ST_DF_CONV0, ST_DF_CONV1,
             ST_ENC_GRU, ST_DEC_GRU, ST_ERB_DECODER, ST_DF_GRU, ST_DF_COEF_MAC, ST_MASK_TAIL,
             ST_SYNTHESIS, ST_CARRY, N_STAGES };

struct Params {
  const float* audio;  // [S, T]
  float* out;          // [S, T]
  const float* cin[N_CKEYS];
  float* cout[N_CKEYS];
  const void* w[N_WKEYS];  // the weights' type but imult and convp_b, float32
  // bfloat16 build: every product's weight in A-fragment order
  // (whole_cell_plan.pack_rows_weights), and where each product starts in it
  // by its first weight key (P_DFT_T: the synthesis product against dft^T)
  const __nv_bfloat16* wpack;
  int pk[N_WKEYS + 1];
  float* scratch;      // [gridDim.x, R, SCR]
  // null, or [gridDim.x][N_STAGES + 3]: each block's ns in each stage over
  // the call, then its first and last reading of the global timer and its
  // SM cycles between them
  long long* records;
  int S, n_frames;
  float alpha, one_minus_alpha, lsnr_min, lsnr_max, pf_beta, silence_thresh, atten_lim,
      gate_min, gate_max_erb, gate_max_df;
  int mask_pf, lsnr_gating, silence_frames;
};

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

// the device's global timer, in ns
__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <typename WT>
constexpr bool kBf16 = std::is_same<WT, __nv_bfloat16>::value;

// x rounded to bfloat16 (to nearest, ties to even), as a float
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// element i of a weight vector, widened to float
__device__ __forceinline__ float wget(const float* p, int i) { return __ldg(p + i); }
__device__ __forceinline__ float wget(const __nv_bfloat16* p, int i) {
  return __uint_as_float((unsigned)__ldg(reinterpret_cast<const unsigned short*>(p) + i) << 16);
}
// 4 neighbouring weights, widened (16 bytes of float32 or 8 of bfloat16)
__device__ __forceinline__ float4 wget4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 wget4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
// two floats rounded to bfloat16 (to nearest, ties to even) in one register,
// `lo` in its lower half: a k-neighbour pair of an mma fragment
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
// c += A B on the tensor cores, m16n8k16, bfloat16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint4& a, unsigned b0,
                                         unsigned b1) {
  asm(  // not volatile: a pure function of its operands
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float act_apply(float v, int act) {
  switch (act) {
    case ACT_RELU: return fmaxf(v, 0.0f);
    case ACT_SIGMOID: return sigmoidf_(v);
    case ACT_TANH: return tanhf(v);
    default: return v;
  }
}

// acc[r][0..3] += x[r] * w4 over this thread's rows k0..k1 of one weight
// segment (float32 build). xs: staged x, [K][R]; w: this thread's 4 columns
// of row 0. The weight rows come in batches of U 16-byte loads, the next
// batch in flight while the current one is multiplied.
template <int R>
__device__ __forceinline__ void fma_rows(float (&acc)[R][4], const float* __restrict__ xs,
                                         const float* __restrict__ w, int ldw, int k0, int k1) {
  constexpr int U = UNROLL;
  auto load = [&](float4 (&wv)[U], int k) {
#pragma unroll
    for (int u = 0; u < U; ++u) wv[u] = wget4(w + (size_t)(k + u) * ldw);
  };
  auto mac = [&](const float4 (&wv)[U], int k) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float xr[R];
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + (k + u) * R + 4 * q);
        xr[4 * q] = xv.x; xr[4 * q + 1] = xv.y; xr[4 * q + 2] = xv.z; xr[4 * q + 3] = xv.w;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r][0] = fmaf(xr[r], wv[u].x, acc[r][0]);
        acc[r][1] = fmaf(xr[r], wv[u].y, acc[r][1]);
        acc[r][2] = fmaf(xr[r], wv[u].z, acc[r][2]);
        acc[r][3] = fmaf(xr[r], wv[u].w, acc[r][3]);
      }
    }
  };
  const int nb = (k1 - k0) / U;
  float4 wa[U], wb[U];
  if (nb > 0) load(wa, k0);
  int b = 0;
  for (; b + 2 <= nb; b += 2) {
    load(wb, k0 + (b + 1) * U);
    mac(wa, k0 + b * U);
    if (b + 2 < nb) load(wa, k0 + (b + 2) * U);
    mac(wb, k0 + (b + 1) * U);
  }
  if (b < nb) mac(wa, k0 + b * U);
  for (int k = k0 + nb * U; k < k1; ++k) {
    const float4 wv = wget4(w + (size_t)k * ldw);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float xr = xs[k * R + r];
      acc[r][0] = fmaf(xr, wv.x, acc[r][0]);
      acc[r][1] = fmaf(xr, wv.y, acc[r][1]);
      acc[r][2] = fmaf(xr, wv.z, acc[r][2]);
      acc[r][3] = fmaf(xr, wv.w, acc[r][3]);
    }
  }
}

// One row's 4 finished columns: bias, activation, addend, store; the
// bfloat16 build rounds where `rnd` says.
template <typename WT>
__device__ __forceinline__ void finish4(float4 v, int col, const WT* __restrict__ bias, int act,
                                        int rnd, const float* addend_row, float* y_row) {
  auto r = [&](float4 a, bool on) {
    return on ? make_float4(bf16r(a.x), bf16r(a.y), bf16r(a.z), bf16r(a.w)) : a;
  };
  const bool bf = kBf16<WT>;
  v = r(v, bf && rnd != R_F32);
  if (bias != nullptr) {
    const float4 b = wget4(bias + col);
    v.x += b.x; v.y += b.y; v.z += b.z; v.w += b.w;
    v = r(v, bf && rnd == R_TRUNK);
  }
  v.x = act_apply(v.x, act); v.y = act_apply(v.y, act);
  v.z = act_apply(v.z, act); v.w = act_apply(v.w, act);
  if (addend_row != nullptr) {
    const float4 a = *reinterpret_cast<const float4*>(addend_row + col);
    v.x += a.x; v.y += a.y; v.z += a.z; v.w += a.w;
    v = r(v, bf && rnd == R_TRUNK);
  }
  *reinterpret_cast<float4*>(y_row + col) = v;
}

// One finished value of row r, column col: as finish4 (bfloat16 build).
__device__ __forceinline__ void finish1(float v, int col, const __nv_bfloat16* __restrict__ bias,
                                        int act, int rnd, const float* addend_row, float* y_row) {
  if (rnd != R_F32) v = bf16r(v);
  if (bias != nullptr) {
    v += wget(bias, col);
    if (rnd == R_TRUNK) v = bf16r(v);
  }
  v = act_apply(v, act);
  if (addend_row != nullptr) {
    v += addend_row[col];
    if (rnd == R_TRUNK) v = bf16r(v);
  }
  y_row[col] = v;
}

// The bfloat16 build's product, on the tensor cores (mma.sync m16n8k16,
// bfloat16 x bfloat16 -> float32): y^T = W^T x^T. A is the weight, 16 output
// columns x k16 a fragment, from the copy packed in fragment order
// ([N / 16][K / 16][32 lanes][8], pack_rows_weights): one 16-byte load a lane
// and step, a warp's 512 bytes contiguous. B is x^T, the block's R stream
// rows as n8 tiles (R = 4 fills half of one, 16 two), staged in shared memory
// as bfloat16 pairs [R8][K / 2][8 rows] by cvt.rn.bf16x2.f32, which is the
// rounding of the input to bfloat16, so that a lane's fragment is two
// conflict-free 4-byte loads. Steps accumulate on the tensor core (whose adds
// truncate) in chains of at most 4, one 64-row chunk of K; the chains are
// added rounded to nearest, in K order. A warp owns whole column tiles where
// there are at least as many as warps, else a column tile and a K slice of
// whole chunks, the slices then added in shared memory in slice order.
// k_seg: with seg_round, K rows of each segment whose product is rounded
// before it is added (whole column tiles only). Ends with a barrier.
template <int R>
__device__ __forceinline__ void gemm_mma(unsigned* sm_xb, float* sm_red, const float* x,
                                         const __nv_bfloat16* __restrict__ wp, int K, int k_seg,
                                         int N, const __nv_bfloat16* __restrict__ bias, int act,
                                         int rnd, const float* addend, float* y, bool seg_round) {
  constexpr int R8 = (R + 7) / 8;  // n8 tiles
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int KH = K / 2, KS = K / 16, MT = N / 16;
  for (int i = tid; i < R8 * KH * 8; i += THREADS) {
    const int n = (i / (KH * 8)) * 8 + (i & 7), kp = (i >> 3) % KH;
    const float2 v = n < R ? *reinterpret_cast<const float2*>(x + (size_t)n * SCR + 2 * kp)
                           : make_float2(0.f, 0.f);
    sm_xb[i] = pack_bf16(v.x, v.y);
  }
  __syncthreads();

  // tot[j] += the product of column tile mt over k16 steps s0..s1 for n8 tile
  // j: a lane holds columns 16 mt + g (q = 0, 1) and + 8 (q = 2, 3) of
  // streams 8j + 2t (q = 0, 2) and + 1 (q = 1, 3). The next chunk's A
  // fragments are in flight while one is multiplied.
  auto run = [&](int mt, int s0, int s1, float (&tot)[R8][4]) {
    const uint4* ap = reinterpret_cast<const uint4*>(wp) + ((size_t)mt * KS + s0) * 32 + lane;
    uint4 a[4];
    auto load = [&](int c0) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c0 + u < s1) a[u] = __ldg(ap + (size_t)(c0 + u - s0) * 32);
    };
    load(s0);
    for (int c0 = s0; c0 < s1; c0 += 4) {
      uint4 cur[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) cur[u] = a[u];
      if (c0 + 4 < s1) load(c0 + 4);
      float ch[R8][4] = {};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (c0 + u < s1) {
#pragma unroll
          for (int j = 0; j < R8; ++j) {
            const unsigned* b = sm_xb + ((size_t)j * KH + (c0 + u) * 8 + t) * 8 + g;
            mma_bf16(ch[j], cur[u], b[0], b[4 * 8]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < R8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) tot[j][q] += ch[j][q];
    }
  };

  if (MT >= NWARPS || seg_round) {
    for (int mt = warp; mt < MT; mt += NWARPS) {
      float tot[R8][4] = {};
      if (seg_round) {  // each segment's sum rounded, then added with rounding
        const int ss = k_seg / 16;
        for (int s0 = 0; s0 < KS; s0 += ss) {
          float part[R8][4] = {};
          run(mt, s0, s0 + ss, part);
#pragma unroll
          for (int j = 0; j < R8; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              tot[j][q] = s0 == 0 ? bf16r(part[j][q]) : bf16r(tot[j][q] + bf16r(part[j][q]));
        }
      } else {
        run(mt, 0, KS, tot);
      }
#pragma unroll
      for (int j = 0; j < R8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = 8 * j + 2 * t + (q & 1), col = 16 * mt + g + 8 * (q >> 1);
          if (r < R)
            finish1(tot[j][q], col, bias, act, rnd, addend ? addend + (size_t)r * SCR : nullptr,
                    y + (size_t)r * SCR);
        }
    }
  } else {
    const int ksl = NWARPS / MT;                      // K slices
    const int kper = ((KS + ksl - 1) / ksl + 3) & ~3;  // whole chunks a slice
    if (warp < MT * ksl) {
      const int mt = warp % MT, sl = warp / MT;
      const int s0 = min(sl * kper, KS), s1 = min(s0 + kper, KS);
      float tot[R8][4] = {};
      run(mt, s0, s1, tot);
#pragma unroll
      for (int j = 0; j < R8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = 8 * j + 2 * t + (q & 1), col = 16 * mt + g + 8 * (q >> 1);
          if (r < R) sm_red[(size_t)(sl * R + r) * N + col] = tot[j][q];
        }
    }
    __syncthreads();
    const int CG = N / 4;
    for (int e = tid; e < R * CG; e += THREADS) {
      const int r = e / CG, c = e % CG;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int sl = 0; sl < ksl; ++sl) {
        const float4 p =
            *reinterpret_cast<const float4*>(sm_red + ((size_t)(sl * R + r) * CG + c) * 4);
        v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
      }
      finish4<__nv_bfloat16>(v, 4 * c, bias, act, rnd,
                             addend ? addend + (size_t)r * SCR : nullptr, y + (size_t)r * SCR);
    }
  }
  __syncthreads();
}

// y[r, :N] = act(x[r, :K] @ [W0; W1; W2] + bias) + addend[r, :N] for the
// block's R scratch rows (row stride SCR). x, y and addend are scratch
// columns; the weight is up to three row segments of k_seg rows each, all
// [k_seg, N] row-major (float32 build, in FMAs); N % 4 == 0 and nseg * k_seg
// <= KMAX. The bfloat16 build multiplies on the tensor cores (gemm_mma): w0 is
// then the product's packed copy, its segments one after the other; it
// rounds x as it stages it, the result where `rnd` says, and with `seg_round`
// each segment's product before adding it. The caller has a barrier between
// the writes of x (and addend) and this call. Ends with a barrier, so the
// caller may read y and reuse the shared buffers at once.
template <int R, typename WT>
__device__ __noinline__ void gemm(float* sm_x, float* sm_red, const float* x,
                                  const WT* __restrict__ w0, const WT* __restrict__ w1,
                                  const WT* __restrict__ w2, int k_seg, int nseg, int N,
                                  const WT* __restrict__ bias, int act, int rnd,
                                  const float* addend, float* y, bool seg_round = false) {
  if constexpr (kBf16<WT>) {
    // w0: the product's packed copy, its segments one after the other
    gemm_mma<R>(reinterpret_cast<unsigned*>(sm_x), sm_red, x, w0, k_seg * nseg, k_seg, N, bias,
                act, rnd, addend, y, seg_round);
  } else {
    const int tid = threadIdx.x;
    const int K = k_seg * nseg;
    for (int i = tid; i < K * R; i += THREADS) {
      const int r = i % R, k = i / R;
      sm_x[i] = x[(size_t)r * SCR + k];
    }
    __syncthreads();

    const int CG = N / 4;  // column groups of 4
    if (CG >= THREADS) {
      for (int cg = tid; cg < CG; cg += THREADS) {
        float acc[R][4] = {};
        for (int s = 0; s < nseg; ++s) {
          const WT* w = s == 0 ? w0 : (s == 1 ? w1 : w2);
          fma_rows<R>(acc, sm_x + s * k_seg * R, w + 4 * cg, N, 0, k_seg);
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
          finish4<WT>(make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]), 4 * cg, bias, act,
                      rnd, addend ? addend + (size_t)r * SCR : nullptr, y + (size_t)r * SCR);
      }
    } else {
      const int ksl = THREADS / CG;  // K slices
      const int cg = tid % CG, ks = tid / CG;
      if (ks < ksl) {
        float acc[R][4] = {};
        const int kper = (k_seg + ksl - 1) / ksl;
        const int k0 = min(ks * kper, k_seg), k1 = min(k0 + kper, k_seg);
        for (int s = 0; s < nseg; ++s) {
          const WT* w = s == 0 ? w0 : (s == 1 ? w1 : w2);
          fma_rows<R>(acc, sm_x + s * k_seg * R, w + 4 * cg, N, k0, k1);
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
          *reinterpret_cast<float4*>(sm_red + ((size_t)(ks * R + r) * CG + cg) * 4) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
      __syncthreads();
      for (int e = tid; e < R * CG; e += THREADS) {
        const int r = e / CG, c = e % CG;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int s = 0; s < ksl; ++s) {
          const float4 p =
              *reinterpret_cast<const float4*>(sm_red + ((size_t)(s * R + r) * CG + c) * 4);
          v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
        }
        finish4<WT>(v, 4 * c, bias, act, rnd, addend ? addend + (size_t)r * SCR : nullptr,
                    y + (size_t)r * SCR);
      }
    }
    __syncthreads();
  }
}

// y[r, j] = sum_k x[r, k] * w[j, k] for j < N, K = 1024: the product against
// the transposed DFT matrix (float32 build; the bfloat16 build runs it through
// gemm on its packed copy of dft^T). One warp per output j; lanes stride k.
template <int R>
__device__ __noinline__ void gemm_t(float* sm_x, const float* x, const float* __restrict__ w,
                                    int N, float* y) {
  constexpr int K = 2 * FPAD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < R * K / 4; i += THREADS) {
    const int r = i / (K / 4), k4 = i % (K / 4);
    const float4 v = *reinterpret_cast<const float4*>(x + (size_t)r * SCR + 4 * k4);
    reinterpret_cast<float4*>(sm_x)[i] = v;
  }
  __syncthreads();
  for (int j = warp; j < N; j += NWARPS) {
    float4 wv[K / 128];
#pragma unroll
    for (int i = 0; i < K / 128; ++i) wv[i] = wget4(w + (size_t)j * K + i * 128 + lane * 4);
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < K / 128; ++i) {
        const float4 xv =
            *reinterpret_cast<const float4*>(sm_x + r * K + i * 128 + lane * 4);
        a = fmaf(xv.x, wv[i].x, a); a = fmaf(xv.y, wv[i].y, a);
        a = fmaf(xv.z, wv[i].z, a); a = fmaf(xv.w, wv[i].w, a);
      }
      acc[r] = a;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) y[(size_t)r * SCR + j] = acc[r];
    }
  }
  __syncthreads();
}

// GRU gates on GI (x @ w_ih + b_ih) and GH (h @ w_hh + b_hh): b_hn sits in GH
// and so stays inside r * (...). Updates h in place.
template <int R>
__device__ void gru_gate(float* sc, int o_h) {
  for (int i = threadIdx.x; i < R * HID; i += THREADS) {
    const int r = i / HID, j = i % HID;
    float* row = sc + (size_t)r * SCR;
    const float* gi = row + O_GI;
    const float* gh = row + O_GH;
    const float rg = sigmoidf_(gi[j] + gh[j]);
    const float zg = sigmoidf_(gi[HID + j] + gh[HID + j]);
    const float ng = tanhf(gi[2 * HID + j] + rg * gh[2 * HID + j]);
    const float h = row[o_h + j];
    row[o_h + j] = (1.0f - zg) * ng + zg * h;
  }
  __syncthreads();
}

// shared memory of a build: a product's staged input (float32 [K][R], or
// bfloat16 pairs [R8][K / 2][8]), then its K slices' partial sums
template <int R, typename WT>
__host__ __device__ constexpr int staged_floats() {
  return kBf16<WT> ? (R + 7) / 8 * KMAX * 4 : KMAX * R;
}
template <int R, typename WT>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) *
         (staged_floats<R, WT>() + (kBf16<WT> ? NWARPS * 16 * R : THREADS * R * 4));
}

#ifdef DFN_K2_PLANT
// A test build only: thread 0 spends k2_plant_ns of the global timer at the
// end of stage k2_plant_stage (dfn_k2_plant sets both), so that a test can
// see the planted time land in that stage's record.
__device__ int k2_plant_stage = -1;
__device__ long long k2_plant_ns = 0;
#endif

// The kernel's body. TIMED: the recording build (Params::records is set); the
// other reads no clock at all. Each build is a kernel of its own name
// (whole_cell_kernel, whole_cell_recording), so a trace tells them apart.
template <int R, typename WT, bool TIMED>
__device__ __forceinline__ void whole_cell_body(const Params& p) {
  extern __shared__ __align__(16) float smem[];
  float* sm_x = smem;                                      // staged x
  float* sm_red = smem + staged_floats<R, WT>();            // K slices' partial sums
  __shared__ float sm_co[CH * ORDER * 2];
  __shared__ float sm_cb[ORDER * 2];
  __shared__ float sm_lsnr[R];
  __shared__ int sm_mute[R];
  __shared__ long long sm_clk[N_STAGES];
  __shared__ long long sm_t0, sm_gt0, sm_clk0;  // thread 0's last mark, first readings

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = p.n_frames * HOP;
  float* sc = p.scratch + (size_t)blockIdx.x * R * SCR;
  // weight k in the build's type (imult and convp_b are float32 in both)
  auto W = [&](int k) { return static_cast<const WT*>(p.w[k]); };
  // a product's weight: as it is (float32), or its packed copy (bfloat16)
  auto P = [&](int k) -> const WT* {
    if constexpr (kBf16<WT>) return p.wpack + p.pk[k];
    else return W(k);
  };

  for (int i = tid; i < CH * ORDER * 2; i += THREADS) sm_co[i] = wget(W(W_CONVP_CO), i);
  if (tid < ORDER * 2) sm_cb[tid] = static_cast<const float*>(p.w[W_CONVP_B])[tid];
  if (TIMED && tid < N_STAGES) sm_clk[tid] = 0;
  // thread 0 closes a stage: the cycles since the last mark go to it
  auto mark = [&](int stage) {
    if (TIMED && tid == 0) {
#ifdef DFN_K2_PLANT
      if (stage == k2_plant_stage)
        for (const long long t = globaltimer(); globaltimer() - t < k2_plant_ns;) {
        }
#endif
      const long long t = clock64();
      sm_clk[stage] += t - sm_t0;
      sm_t0 = t;
    }
  };
  if (TIMED && tid == 0) {
    sm_gt0 = globaltimer();
    sm_clk0 = sm_t0 = clock64();
  }

  const int n_tiles = (p.S + R - 1) / R;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * R;
    // rows beyond S repeat the last stream: computed, never stored
    auto grow = [&](int r) { return min(row0 + r, p.S - 1); };
    auto valid = [&](int r) { return row0 + r < p.S; };

    // ---- carry -> scratch state
    __syncthreads();
    for (int i = tid; i < R * HOP; i += THREADS) {
      const int r = i / HOP, c = i % HOP;
      float* row = sc + (size_t)r * SCR;
      const size_t g = (size_t)grow(r);
      row[O_BUF + c] = p.cin[C_AMEM][g * 480 + c];
      row[O_SMEM + c] = p.cin[C_SMEM][g * 480 + c];
    }
    for (int i = tid; i < R * 512; i += THREADS) {
      const int r = i / 512, c = i % 512;
      float* row = sc + (size_t)r * SCR;
      const size_t g = (size_t)grow(r);
      row[O_RING_RE + c] = p.cin[C_RING_RE][g * 512 + c];
      row[O_RING_IM + c] = p.cin[C_RING_IM][g * 512 + c];
      if (c < 128) {
        const float v = p.cin[C_NORMS][g * 128 + c];
        if (c < NB_ERB) row[O_MEAN + c] = v; else row[O_UNIT + c - NB_ERB] = v;
      }
      if (c < 64) row[O_ERBWIN + c] = p.cin[C_ERB_CTX][g * 64 + c];
      if (c < 384) {
        // spec_ctx is (c, t, f) flat: [re t-2 | re t-1 | im t-2 | im t-1];
        // the window holds frames as [re | im] pairs
        const int blk = c / NB_DF, f = c % NB_DF;
        const int t = blk & 1, ri = blk >> 1;
        row[O_FSWIN + t * 192 + ri * NB_DF + f] = p.cin[C_SPEC_CTX][g * 384 + c];
      }
      if (c < HID) {
        row[O_ENC_H + c] = p.cin[C_ENC_H][g * HID + c];
        row[O_DEC_H + c] = p.cin[C_DEC_H][g * HID + c];
      }
    }
    for (int i = tid; i < R * 3 * HID; i += THREADS) {
      const int r = i / (3 * HID), c = i % (3 * HID);
      sc[(size_t)r * SCR + O_DF_H + c] = p.cin[C_DF_H][(size_t)grow(r) * 3 * HID + c];
    }
    // the silence counter travels as a float in sil[:, 0]
    float sil_ctr = 0.f;  // lane 0 of warp r keeps row r's counter
    if (warp < R && lane == 0) sil_ctr = p.cin[C_SIL][(size_t)grow(warp) * 8];
    __syncthreads();
    mark(ST_CARRY);  // the last tile's carry store and this one's load

    for (int f = 0; f < p.n_frames; ++f) {
      // ---- frame in; RMS silence counter (one warp per row)
      for (int i = tid; i < R * HOP; i += THREADS) {
        const int r = i / HOP, c = i % HOP;
        sc[(size_t)r * SCR + O_BUF + HOP + c] = p.audio[(size_t)grow(r) * T + (size_t)f * HOP + c];
      }
      if (warp < R) {
        const float* a = p.audio + (size_t)grow(warp) * T + (size_t)f * HOP;
        float ss = 0.f;
        for (int c = lane; c < HOP; c += 32) ss = fmaf(a[c], a[c], ss);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
        if (lane == 0) {
          const float rms = sqrtf(ss / (float)HOP);
          sil_ctr = rms < p.silence_thresh ? sil_ctr + 1.0f : 0.0f;
          sm_mute[warp] = sil_ctr >= (float)p.silence_frames;
        }
      }
      __syncthreads();
      mark(ST_FRAME_IN);
      // ---- analysis: [prev_hop | frame] @ dft -> [re | im]
      gemm<R, WT>(sm_x, sm_red, sc + O_BUF, P(W_DFT), nullptr, nullptr, FFT, 1, 2 * FPAD, nullptr,
              ACT_NONE, R_F32, nullptr, sc + O_SPEC);
      mark(ST_ANALYSIS);
      // ---- power, unit norm, complex features of this frame
      for (int i = tid; i < R * FPAD; i += THREADS) {
        const int r = i / FPAD, k = i % FPAD;
        float* row = sc + (size_t)r * SCR;
        const float re = row[O_SPEC + k], im = row[O_SPEC + FPAD + k];
        const float pw = re * re + im * im;
        row[O_POW + k] = pw;
        if (k < NB_DF) {
          const float un = sqrtf(pw) * p.one_minus_alpha + row[O_UNIT + k] * p.alpha;
          row[O_UNIT + k] = un;
          const float scale = rsqrtf(un);
          row[O_FSWIN + 384 + k] = re * scale;
          row[O_FSWIN + 384 + NB_DF + k] = im * scale;
        }
      }
      __syncthreads();
      gemm<R, WT>(sm_x, sm_red, sc + O_POW, P(W_ERB_FWD), nullptr, nullptr, FPAD, 1, NB_ERB, nullptr,
              ACT_NONE, R_F32, nullptr, sc + O_GAIN);
      for (int i = tid; i < R * NB_ERB; i += THREADS) {
        const int r = i / NB_ERB, e = i % NB_ERB;
        float* row = sc + (size_t)r * SCR;
        const float db = 10.0f * log10f(row[O_GAIN + e] + 1e-10f);
        const float mean = db * p.one_minus_alpha + row[O_MEAN + e] * p.alpha;
        row[O_MEAN + e] = mean;
        row[O_ERBWIN + 64 + e] = (db - mean) / 40.0f;
      }
      __syncthreads();
      mark(ST_FEATURES);
      // ---- conv frontend (dense folds)
      gemm<R, WT>(sm_x, sm_red, sc + O_ERBWIN, P(W_E0_W), nullptr, nullptr, 96, 1, 512, W(W_E0_B),
              ACT_RELU, R_TRUNK, nullptr, sc + O_E0);
      gemm<R, WT>(sm_x, sm_red, sc + O_E0, P(W_E1_W), nullptr, nullptr, 512, 1, 256, W(W_E1_B),
              ACT_RELU, R_TRUNK, nullptr, sc + O_E1);
      gemm<R, WT>(sm_x, sm_red, sc + O_E1, P(W_E2_W), nullptr, nullptr, 256, 1, 128, W(W_E2_B),
              ACT_RELU, R_TRUNK, nullptr, sc + O_E2);
      gemm<R, WT>(sm_x, sm_red, sc + O_E2, P(W_E3_W), nullptr, nullptr, 128, 1, 128, W(W_E3_B),
              ACT_RELU, R_TRUNK, nullptr, sc + O_E3);
      mark(ST_ERB_CONVS);
      gemm<R, WT>(sm_x, sm_red, sc + O_FSWIN, P(W_C0W_T0), W(W_C0W_T1), W(W_C0W_T2), 192, 3,
              CH * BLK, W(W_C0_B), ACT_RELU, R_TRUNK, nullptr, sc + O_C0, true);
      mark(ST_DF_CONV0);
      gemm<R, WT>(sm_x, sm_red, sc + O_C0, P(W_C1_W), nullptr, nullptr, CH * BLK, 1, 768, W(W_C1_B),
              ACT_RELU, R_TRUNK, nullptr, sc + O_C1);
      // emb = e3 + relu(c1 @ gl)
      gemm<R, WT>(sm_x, sm_red, sc + O_C1, P(W_GL_W), nullptr, nullptr, 768, 1, 128, nullptr,
              ACT_RELU, R_TRUNK, sc + O_E3, sc + O_EMB);
      mark(ST_DF_CONV1);
      // ---- encoder GRU + LSNR head
      gemm<R, WT>(sm_x, sm_red, sc + O_EMB, P(W_ENC_LIN_IN), nullptr, nullptr, 128, 1, HID, nullptr,
              ACT_RELU, R_TRUNK, nullptr, sc + O_XIN);
      gemm<R, WT>(sm_x, sm_red, sc + O_XIN, P(W_ENC_WIH), nullptr, nullptr, HID, 1, 3 * HID,
              W(W_ENC_BIH), ACT_NONE, R_TRUNK, nullptr, sc + O_GI);
      gemm<R, WT>(sm_x, sm_red, sc + O_ENC_H, P(W_ENC_WHH), nullptr, nullptr, HID, 1, 3 * HID,
              W(W_ENC_BHH), ACT_NONE, R_SUM, nullptr, sc + O_GH);
      gru_gate<R>(sc, O_ENC_H);
      gemm<R, WT>(sm_x, sm_red, sc + O_ENC_H, P(W_ENC_LIN_OUT), nullptr, nullptr, HID, 1, 128,
              nullptr, ACT_RELU, R_TRUNK, nullptr, sc + O_EMB2);
      if (warp < R) {
        const float* e = sc + (size_t)warp * SCR + O_EMB2;
        float a = 0.f;
        for (int k = lane; k < 128; k += 32) a = fmaf(e[k], wget(W(W_LSNR_W), k), a);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
        if (lane == 0)
          sm_lsnr[warp] =
              sigmoidf_(a + wget(W(W_LSNR_B), 0)) * (p.lsnr_max - p.lsnr_min) + p.lsnr_min;
      }
      mark(ST_ENC_GRU);
      // ---- ERB decoder
      gemm<R, WT>(sm_x, sm_red, sc + O_EMB2, P(W_DEC_LIN_IN), nullptr, nullptr, 128, 1, HID, nullptr,
              ACT_RELU, R_TRUNK, nullptr, sc + O_XIN);
      gemm<R, WT>(sm_x, sm_red, sc + O_XIN, P(W_DEC_WIH), nullptr, nullptr, HID, 1, 3 * HID,
              W(W_DEC_BIH), ACT_NONE, R_TRUNK, nullptr, sc + O_GI);
      gemm<R, WT>(sm_x, sm_red, sc + O_DEC_H, P(W_DEC_WHH), nullptr, nullptr, HID, 1, 3 * HID,
              W(W_DEC_BHH), ACT_NONE, R_SUM, nullptr, sc + O_GH);
      gru_gate<R>(sc, O_DEC_H);
      gemm<R, WT>(sm_x, sm_red, sc + O_DEC_H, P(W_DEC_LIN_OUT), nullptr, nullptr, HID, 1, 128,
              nullptr, ACT_RELU, R_TRUNK, nullptr, sc + O_DEMB);
      mark(ST_DEC_GRU);
      gemm<R, WT>(sm_x, sm_red, sc + O_E3, P(W_P3_W), nullptr, nullptr, 128, 1, 128, W(W_P3_B),
              ACT_RELU, R_TRUNK, sc + O_DEMB, sc + O_PA);
      gemm<R, WT>(sm_x, sm_red, sc + O_PA, P(W_T3_W), nullptr, nullptr, 128, 1, 128, W(W_T3_B),
              ACT_RELU, R_TRUNK, nullptr, sc + O_PB);
      gemm<R, WT>(sm_x, sm_red, sc + O_E2, P(W_P2_W), nullptr, nullptr, 128, 1, 128, W(W_P2_B),
              ACT_RELU, R_TRUNK, sc + O_PB, sc + O_PA);
      gemm<R, WT>(sm_x, sm_red, sc + O_PA, P(W_T2_W), nullptr, nullptr, 128, 1, 256, W(W_T2_B),
              ACT_RELU, R_TRUNK, nullptr, sc + O_PB);
      gemm<R, WT>(sm_x, sm_red, sc + O_E1, P(W_P1_W), nullptr, nullptr, 256, 1, 256, W(W_P1_B),
              ACT_RELU, R_TRUNK, sc + O_PB, sc + O_PA);
      gemm<R, WT>(sm_x, sm_red, sc + O_PA, P(W_T1_W), nullptr, nullptr, 256, 1, 512, W(W_T1_B),
              ACT_RELU, R_TRUNK, nullptr, sc + O_PB);
      gemm<R, WT>(sm_x, sm_red, sc + O_E0, P(W_P0_W), nullptr, nullptr, 512, 1, 512, W(W_P0_B),
              ACT_RELU, R_TRUNK, sc + O_PB, sc + O_PA);
      gemm<R, WT>(sm_x, sm_red, sc + O_PA, P(W_OUT_W), nullptr, nullptr, 512, 1, NB_ERB, W(W_OUT_B),
              ACT_SIGMOID, R_F32, nullptr, sc + O_MASK);
      mark(ST_ERB_DECODER);
      // ---- DF decoder: 3-layer GRU, coefficient head
      gemm<R, WT>(sm_x, sm_red, sc + O_EMB2, P(W_DF_LIN_IN), nullptr, nullptr, 128, 1, HID, nullptr,
              ACT_RELU, R_TRUNK, nullptr, sc + O_XIN);
      for (int li = 0; li < 3; ++li) {
        const int o_in = li == 0 ? O_XIN : O_DF_H + (li - 1) * HID;
        const int o_h = O_DF_H + li * HID;
        gemm<R, WT>(sm_x, sm_red, sc + o_in, P(W_DF_WIH0 + 4 * li), nullptr, nullptr, HID, 1, 3 * HID,
                W(W_DF_BIH0 + 4 * li), ACT_NONE, R_TRUNK, nullptr, sc + O_GI);
        gemm<R, WT>(sm_x, sm_red, sc + o_h, P(W_DF_WHH0 + 4 * li), nullptr, nullptr, HID, 1, 3 * HID,
                W(W_DF_BHH0 + 4 * li), ACT_NONE, R_SUM, nullptr, sc + O_GH);
        gru_gate<R>(sc, o_h);
      }
      mark(ST_DF_GRU);
      gemm<R, WT>(sm_x, sm_red, sc + O_DF_H + 2 * HID, P(W_DF_OUT_W), nullptr, nullptr, HID, 1,
              ORDER * 2 * BLK, nullptr, ACT_TANH, R_F32, nullptr, sc + O_COEF);
      // ---- deep filter MAC: ring frames 0..3, the current frame as tap 4;
      // then the ring shifts. Pad lanes (f >= 96) of the current frame are 0.
      for (int i = tid; i < R * BLK; i += THREADS) {
        const int r = i / BLK, f = i % BLK;
        float* row = sc + (size_t)r * SCR;
        const float cur_re = f < NB_DF ? row[O_SPEC + f] : 0.f;
        const float cur_im = f < NB_DF ? row[O_SPEC + FPAD + f] : 0.f;
        float c0v[CH];
#pragma unroll
        for (int c = 0; c < CH; ++c) c0v[c] = row[O_C0 + c * BLK + f];
        float y_re = 0.f, y_im = 0.f;
#pragma unroll
        for (int n = 0; n < ORDER; ++n) {
          const float t_re = n < ORDER - 1 ? row[O_RING_RE + n * BLK + f] : cur_re;
          const float t_im = n < ORDER - 1 ? row[O_RING_IM + n * BLK + f] : cur_im;
          float cp_re = 0.f, cp_im = 0.f;
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            cp_re = fmaf(sm_co[c * ORDER * 2 + 2 * n], c0v[c], cp_re);
            cp_im = fmaf(sm_co[c * ORDER * 2 + 2 * n + 1], c0v[c], cp_im);
          }
          const float c_re = row[O_COEF + (2 * n) * BLK + f] + fmaxf(cp_re + sm_cb[2 * n], 0.f);
          const float c_im =
              row[O_COEF + (2 * n + 1) * BLK + f] + fmaxf(cp_im + sm_cb[2 * n + 1], 0.f);
          y_re = y_re + t_re * c_re - t_im * c_im;
          y_im = y_im + t_re * c_im + t_im * c_re;
        }
        row[O_Y + f] = y_re;
        row[O_Y + BLK + f] = y_im;
#pragma unroll
        for (int n = 0; n < ORDER - 2; ++n) {
          row[O_RING_RE + n * BLK + f] = row[O_RING_RE + (n + 1) * BLK + f];
          row[O_RING_IM + n * BLK + f] = row[O_RING_IM + (n + 1) * BLK + f];
        }
        row[O_RING_RE + (ORDER - 2) * BLK + f] = cur_re;
        row[O_RING_IM + (ORDER - 2) * BLK + f] = cur_im;
      }
      __syncthreads();
      mark(ST_DF_COEF_MAC);
      // ---- ERB mask -> bin gains
      gemm<R, WT>(sm_x, sm_red, sc + O_MASK, P(W_ERB_INV), nullptr, nullptr, NB_ERB, 1, FPAD, nullptr,
              ACT_NONE, R_F32, nullptr, sc + O_GAIN);
      // ---- tail: post-filter, LSNR gating, atten-lim, mute, iDFT scaling
      for (int i = tid; i < R * FPAD; i += THREADS) {
        const int r = i / FPAD, k = i % FPAD;
        float* row = sc + (size_t)r * SCR;
        const float re = row[O_SPEC + k], im = row[O_SPEC + FPAD + k];
        const float g = row[O_GAIN + k];
        const float m_re = re * g, m_im = im * g;
        float se_re = k < NB_DF ? row[O_Y + k] : m_re;
        float se_im = k < NB_DF ? row[O_Y + BLK + k] : m_im;
        if (p.mask_pf) {
          const float eps = 1e-12f;
          const float mag_e = sqrtf(se_re * se_re + se_im * se_im);
          const float mag_x = sqrtf(re * re + im * im);
          const float gg = fminf(fmaxf(mag_e / (mag_x + eps), eps), 1.0f);
          const float g_sin = fmaxf(gg * sinf(PI_F * gg / 2.0f), eps);
          const float q = gg / g_sin;
          const float pf = (1.0f + p.pf_beta) / (1.0f + p.pf_beta * (q * q));
          se_re *= pf;
          se_im *= pf;
        }
        if (p.lsnr_gating) {
          const float ls = sm_lsnr[r];
          if (ls < p.gate_min) {
            se_re = 0.f; se_im = 0.f;
          } else if (ls > p.gate_max_df && ls <= p.gate_max_erb) {
            se_re = m_re; se_im = m_im;
          } else if (ls > p.gate_max_erb) {
            se_re = re; se_im = im;
          }
        }
        if (p.atten_lim > 0.f) {
          se_re = re * p.atten_lim + se_re * (1.0f - p.atten_lim);
          se_im = im * p.atten_lim + se_im * (1.0f - p.atten_lim);
        }
        if (sm_mute[r]) {  // the mute comes last, after atten-lim
          se_re = 0.f; se_im = 0.f;
        }
        const float sc_k = __ldg(static_cast<const float*>(p.w[W_IMULT]) + k);
        row[O_SE + k] = se_re * sc_k;
        row[O_SE + FPAD + k] = se_im * sc_k;
      }
      __syncthreads();
      mark(ST_MASK_TAIL);
      // ---- synthesis: [se_re | se_im] @ dft^T, overlap-add
      if constexpr (kBf16<WT>)
        gemm<R, WT>(sm_x, sm_red, sc + O_SE, p.wpack + p.pk[P_DFT_T], nullptr, nullptr, 2 * FPAD,
                    1, FFT, nullptr, ACT_NONE, R_F32, nullptr, sc + O_X);
      else
        gemm_t<R>(sm_x, sc + O_SE, W(W_DFT), FFT, sc + O_X);
      for (int i = tid; i < R * HOP; i += THREADS) {
        const int r = i / HOP, c = i % HOP;
        float* row = sc + (size_t)r * SCR;
        const float o = row[O_X + c] + row[O_SMEM + c];
        if (valid(r)) p.out[(size_t)(row0 + r) * T + (size_t)f * HOP + c] = o;
        row[O_SMEM + c] = row[O_X + HOP + c];
        row[O_BUF + c] = row[O_BUF + HOP + c];  // prev_hop = frame
        if (c < 192) {  // conv contexts advance one frame
          row[O_FSWIN + c] = row[O_FSWIN + 192 + c];
          row[O_FSWIN + 192 + c] = row[O_FSWIN + 384 + c];
        }
        if (c < NB_ERB) {
          row[O_ERBWIN + c] = row[O_ERBWIN + NB_ERB + c];
          row[O_ERBWIN + NB_ERB + c] = row[O_ERBWIN + 2 * NB_ERB + c];
        }
      }
      __syncthreads();
      mark(ST_SYNTHESIS);
    }

    // ---- scratch state -> carry, valid rows only
    for (int i = tid; i < R * 3 * HID; i += THREADS) {
      const int r = i / (3 * HID), c = i % (3 * HID);
      if (!valid(r)) continue;
      const float* row = sc + (size_t)r * SCR;
      const size_t g = (size_t)(row0 + r);
      p.cout[C_DF_H][g * 3 * HID + c] = row[O_DF_H + c];
      if (c < HOP) {
        p.cout[C_AMEM][g * 480 + c] = row[O_BUF + c];
        p.cout[C_SMEM][g * 480 + c] = row[O_SMEM + c];
      }
      if (c < 512) {
        p.cout[C_RING_RE][g * 512 + c] = row[O_RING_RE + c];
        p.cout[C_RING_IM][g * 512 + c] = row[O_RING_IM + c];
      }
      if (c < 128)
        p.cout[C_NORMS][g * 128 + c] = c < NB_ERB ? row[O_MEAN + c] : row[O_UNIT + c - NB_ERB];
      if (c < 64) p.cout[C_ERB_CTX][g * 64 + c] = row[O_ERBWIN + c];
      if (c < 384) {
        const int blk = c / NB_DF, fq = c % NB_DF;
        const int t = blk & 1, ri = blk >> 1;
        p.cout[C_SPEC_CTX][g * 384 + c] = row[O_FSWIN + t * 192 + ri * NB_DF + fq];
      }
      if (c < HID) {
        p.cout[C_ENC_H][g * HID + c] = row[O_ENC_H + c];
        p.cout[C_DEC_H][g * HID + c] = row[O_DEC_H + c];
      }
      if (c >= 1 && c < 8) p.cout[C_SIL][g * 8 + c] = p.cin[C_SIL][g * 8 + c];
    }
    if (warp < R && lane == 0 && valid(warp)) p.cout[C_SIL][(size_t)(row0 + warp) * 8] = sil_ctr;
  }
  if constexpr (TIMED) {
    __syncthreads();  // every thread has made its carry stores
    mark(ST_CARRY);
    if (tid == 0) {
      const long long gt1 = globaltimer();
      const long long gt0 = sm_gt0, clk0 = sm_clk0;
      const double ns_a_clk = sm_t0 > clk0 ? (double)(gt1 - gt0) / (double)(sm_t0 - clk0) : 0.0;
      long long* rec = p.records + (size_t)blockIdx.x * (N_STAGES + 3);
      for (int i = 0; i < N_STAGES; ++i) rec[i] = __double2ll_rn((double)sm_clk[i] * ns_a_clk);
      rec[N_STAGES] = gt0;
      rec[N_STAGES + 1] = gt1;
      rec[N_STAGES + 2] = sm_t0 - clk0;
    }
  }
}

// the build that ships: no record buffer, no clock read
template <int R, typename WT>
__global__ void __launch_bounds__(THREADS, 1) whole_cell_kernel(const __grid_constant__ Params p) {
  whole_cell_body<R, WT, false>(p);
}

// the build a launch with a record buffer runs
template <int R, typename WT>
__global__ void __launch_bounds__(THREADS, 1)
    whole_cell_recording(const __grid_constant__ Params p) {
  whole_cell_body<R, WT, true>(p);
}

template <typename Kernel>
cudaError_t launch_build(Kernel kernel, size_t shmem, const Params& p, int n_blocks,
                         cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, THREADS, shmem, stream>>>(p);
  return cudaGetLastError();
}

// the recording build when the launch passes a record buffer, else the one
// that reads no clock
template <int R, typename WT>
cudaError_t launch(const Params& p, int n_blocks, cudaStream_t stream) {
  const size_t shmem = smem_bytes<R, WT>();
  return p.records ? launch_build(whole_cell_recording<R, WT>, shmem, p, n_blocks, stream)
                   : launch_build(whole_cell_kernel<R, WT>, shmem, p, n_blocks, stream);
}

}  // namespace

#ifdef DFN_K2_PLANT
// A test build only: the recording build's thread 0 spends `ns` of the global
// timer at the end of `stage` (-1: none) in every block, tile and frame.
extern "C" int dfn_k2_plant(int stage, long long ns) {
  cudaError_t err = cudaMemcpyToSymbol(k2_plant_stage, &stage, sizeof(stage));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(k2_plant_ns, &ns, sizeof(ns));
  return (int)err;
}
#endif

// Floats of scratch the kernel needs for each stream row of each block.
extern "C" int dfn_whole_cell_rows_scratch_floats() { return SCR; }

// Stages a block records (int64 each, in the order of the Stage enum), before
// its first and last global timer reading and its cycles between them.
extern "C" int dfn_whole_cell_rows_stages() { return N_STAGES; }

// Launches the kernel on `stream` for audio [S, n_frames * 480]. carry_in,
// carry_out (11 device pointers, CKEYS order), weights (n_weights device
// pointers, WKEYS order) and scalars (alpha, 1 - alpha, lsnr_min, lsnr_max,
// pf_beta, silence_thresh, atten_lim, gate_min, gate_max_erb, gate_max_df) are
// host arrays; the weights are bfloat16 but imult and convp_b when `bf16`,
// else all float32. With `bf16`, wpack is the products' weights packed by
// whole_cell_plan.pack_rows_weights (bfloat16, on the device) and pk the host
// array of its n_weights + 1 offsets; else both are ignored. rows: 4 or 8, or
// 16 with `bf16`. scratch: n_blocks * rows *
// dfn_whole_cell_rows_scratch_floats() floats. records: null (no block reads
// a clock), or n_blocks x (dfn_whole_cell_rows_stages() + 3) int64 on the
// device, every entry written: a block's ns in each stage, then its first and
// last global timer reading (ns) and its SM cycles between them.
// Returns the CUDA error of the launch (0 on success).
extern "C" int dfn_whole_cell_rows(const void* audio, void* out, const void* const* carry_in,
                                   void* const* carry_out, const void* const* weights,
                                   int n_weights, const void* wpack, const int* pk, void* scratch,
                                   void* records, int S, int n_frames, int rows,
                                   int n_blocks, const float* scalars, int mask_pf,
                                   int lsnr_gating, int silence_frames, int bf16, void* stream) {
  if (n_weights != N_WKEYS || S < 1 || n_frames < 0 || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.audio = static_cast<const float*>(audio);
  p.out = static_cast<float*>(out);
  for (int i = 0; i < N_CKEYS; ++i) {
    p.cin[i] = static_cast<const float*>(carry_in[i]);
    p.cout[i] = static_cast<float*>(carry_out[i]);
  }
  for (int i = 0; i < N_WKEYS; ++i) p.w[i] = weights[i];
  p.wpack = static_cast<const __nv_bfloat16*>(wpack);
  for (int i = 0; i <= N_WKEYS; ++i) p.pk[i] = bf16 ? pk[i] : -1;
  p.scratch = static_cast<float*>(scratch);
  p.records = static_cast<long long*>(records);
  p.S = S;
  p.n_frames = n_frames;
  p.alpha = scalars[0]; p.one_minus_alpha = scalars[1];
  p.lsnr_min = scalars[2]; p.lsnr_max = scalars[3];
  p.pf_beta = scalars[4]; p.silence_thresh = scalars[5]; p.atten_lim = scalars[6];
  p.gate_min = scalars[7]; p.gate_max_erb = scalars[8]; p.gate_max_df = scalars[9];
  p.mask_pf = mask_pf; p.lsnr_gating = lsnr_gating; p.silence_frames = silence_frames;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  using bf = __nv_bfloat16;
  if (rows == 4) err = bf16 ? launch<4, bf>(p, n_blocks, st) : launch<4, float>(p, n_blocks, st);
  else if (rows == 8) err = bf16 ? launch<8, bf>(p, n_blocks, st) : launch<8, float>(p, n_blocks, st);
  else if (rows == 16 && bf16) err = launch<16, bf>(p, n_blocks, st);
  else err = cudaErrorInvalidValue;
  return (int)err;
}
