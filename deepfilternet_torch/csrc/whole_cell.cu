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
// start of the call and written once at its end. Every matrix product of the
// frame is computed here: in float32 FMAs on the CUDA cores (float32 build),
// or on the tensor cores (bfloat16 build, mma.sync m16n8k16).
//
// What bounds it: a frame is about 7.2 M multiply-adds a stream (8.1 M at the
// padded widths the weights are stored at) against 28 MB of float32 weights
// (14 MB bfloat16), which sit in the 50 MB L2 after the first frame. With few
// streams the limit is the chain of dependent products (DFT -> ERB bands ->
// e0 ... e3 -> encoder GRU -> ... -> conv_out -> the erb_inv tail ->
// synthesis): each must be spread over the whole card to be short, so what
// paces a frame is the fixed cost of each link, not the arithmetic. With many
// streams it is the float32 FMA rate in the float32 build; the bfloat16
// build's products take the tensor cores a small share of that time.
//
// What the design does about it:
//   * one persistent block of 256 threads per multiprocessor, launched
//     cooperatively so that all are resident, loops over the call's frames;
//   * a frame is a fixed list of phases; products that do not depend on one
//     another share a phase (every h @ w_hh beside the analysis DFT, the ERB
//     conv chain beside the DF conv chain, the ERB decoder beside the DF GRU
//     stack; the decoder's pathway convs run early and join as addends): 18
//     phases where the frame has ~45 products;
//   * a product is cut into units of one tile of 64 stream rows by one slice
//     of its output columns, so a block reads only its slice of the weights.
//     A phase's units are dealt over the blocks, the first to those that
//     have read least from L2 so far in the frame. The phases, their
//     products, each slice width, the dealing and the edges below are decided
//     on the host (ops/whole_cell_plan.py) for the stream count and the card,
//     and arrive as one int32 table;
//   * no barrier inside the frame loop. The units of a launch have one
//     global order (frame, phase, unit), every block walks its own in it, and
//     the plan's edges between jobs (read after write, write after read,
//     write after write, from the scratch columns each job touches; the
//     reduction no other path implies) all point backward in it. A counter
//     in global memory for each (job, tile) counts the job's units done there
//     over the launch: a unit that is done makes its stores visible to the
//     copy engine (fence.proxy.async) and adds one with release semantics;
//     a unit waits, with ld.acquire, until each producer's counter reaches
//     its units a tile times the frames the edge needs. A block with nothing
//     in a phase goes on to its next unit; with all blocks resident the
//     global order cannot deadlock. Carry in, the first frame in and carry
//     out keep a grid barrier each;
//   * activations and state live in a global scratch [tiles, SCR, 64],
//     feature major, so a K-chunk of any product's input is one contiguous
//     copy. A multiprocessor gets about 27 bytes a clock from L2 however the
//     copies are issued, and cp.async from every thread stalls the threads at
//     that rate; so a unit streams its input chunk and weight slice through a
//     ring of shared-memory stages filled by bulk copies (the TMA engine, one
//     warp issuing, an mbarrier a stage), which run while all warps multiply.
//     The copy warp runs ahead into the block's next unit: its weight copies
//     go out as soon as a stage is free, before the wait on producers, and
//     only its input copies wait, so a unit whose producers are done finds
//     its first stage in. float32: a thread owns 8 rows x 8 columns (8 x 2 in
//     narrow slices) and a share of each chunk's K rows; bfloat16: a warp
//     owns one k16 step of each chunk for half the tile's rows (MmaTile). The
//     shares are added in shared memory in a fixed order, so results do not
//     depend on timing or on the order the units run in;
//   * a unit owns whole groups of columns that belong together (re and im of
//     a bin; the three gates of a GRU column), so the elementwise stages run
//     in the product's epilogue: power / unit norm / complex features after
//     the DFT, dB and mean norm after the ERB bands, the GRU gates after
//     x @ w_ih, the DF MAC and the whole tail after erb_inv, overlap-add
//     after the synthesis product. Synthesis is the same routine against a
//     transposed copy of dft that the wrapper keeps;
//   * rows beyond S in the last tile repeat the last stream: computed, never
//     stored;
//   * when the launch passes a record buffer, thread 0 of every block adds
//     up its cycles in the units of each phase and, apart, its cycles
//     waiting on producers, and writes them out in ns, scaled by the block's
//     own span of the global timer over the frames, with that span, so a run
//     can say where a frame's time goes on every multiprocessor. The timers
//     are a kernel of their own, whole_cell_recording, which the launch picks
//     when it passes a buffer; the kernel that ships, whole_cell_kernel, has
//     no timer code and reads no clock, and a trace tells the two apart by
//     name.
//
// Two builds of the kernel, by the weights' type (the TPU kernel's mdtype):
// float32, and bfloat16, the JAX package's default. The bfloat16 build runs
// every product on the tensor cores, as the TPU kernel runs it on its MXU:
// mma.sync m16n8k16, bfloat16 x bfloat16 -> float32. It reads the packed
// weights (in B-fragment order, one 8-byte load a lane), biases and small
// vectors as bfloat16 (imult and convp_b stay float32), so a unit's K-chunk
// moves half the weight bytes through the ring. The A fragments are packed
// from the float32 input stage by cvt.rn.bf16x2.f32, which is the rounding
// of the input to bfloat16. The plan for this build (whole_cell_plan.plan,
// bf16) packs each unit's weight slice in whole n8 tiles. How sums join: the
// tensor core's accumulating adds truncate, so each warp takes one k16 step
// at a time from zero and adds it to its float32 sums rounded to nearest;
// the four K groups then add in group order in shared memory. The error
// stays a float32 one, within what the bfloat16 gate allows
// (ops/whole_cell_check.py, TensorCoreSums). Each result is rounded where the
// plain version's `mm` rounds (the plan's Rnd field; df_conv0's three window
// products each rounded before they are added). Gates, norms, the DF MAC,
// the runtime stages and the carry stay float32.
//
// Measured times and the card they were taken on: PERF.md, kernel table.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;                 // compute threads: 8 warps
constexpr int BLOCK_THREADS = THREADS + 32;  // and one warp that only copies
constexpr int RT = 64;        // stream rows a tile
constexpr int KC = 64;        // K rows a stage
constexpr int MAX_CNT = 64;   // widest column slice of a unit
constexpr int NSTG = 4;       // depth of the ring of shared-memory stages
constexpr int EPB = 4;        // elements a thread handles per batch of an epilogue
constexpr int STAGE_FLOATS = KC * RT + KC * MAX_CNT;
constexpr int RED_FLOATS = THREADS * RT;  // the K groups' partial sums of a unit
constexpr size_t SMEM_BYTES = sizeof(float) * (size_t)(NSTG * STAGE_FLOATS + RED_FLOATS);
constexpr int HOP = 480;
constexpr int FPAD = 512;
constexpr int BLK = 128;
constexpr int NB_ERB = 32;
constexpr int NB_DF = 96;
constexpr int HID = 256;
constexpr int CH = 16;
constexpr int ORDER = 5;
constexpr float PI_F = 3.14159265358979323846f;
constexpr int N_WKEYS = 65;
constexpr int W_IMULT = 1, W_LSNR_W = 41, W_LSNR_B = 42, W_CONVP_CO = 63, W_CONVP_B = 64;
constexpr int N_CKEYS = 11;
constexpr int C_SIL = 3;
__constant__ int CWIDTH[N_CKEYS] = {480, 480, 128, 8, 64, 384, 256, 256, 768, 512, 512};
constexpr int TAB_MAX = 3072;
constexpr int MAX_FRAME_PHASES = 23;  // stage clocks kept in shared memory
// a block's stage clocks in shared memory when the launch records: one a frame
// phase, then its wait on producers, the clock its running unit's inputs were
// in at, the clock the unit before it ended at, and its first global timer
// and cycle readings
constexpr int CLK_WAIT = MAX_FRAME_PHASES, CLK_READY = CLK_WAIT + 1, CLK_PREV = CLK_WAIT + 2,
              CLK_GT0 = CLK_WAIT + 3, CLK_START = CLK_WAIT + 4;

// scratch columns, in the order of the plan's LAYOUT
enum Lay { L_BUF, L_SPEC, L_POW, L_ERBWIN, L_FSWIN, L_E0, L_E1, L_E2, L_E3, L_C0, L_C1, L_CEMB,
           L_EMB, L_XENC, L_EMB2, L_XDEC, L_XDF, L_GH_ENC, L_GH_DEC, L_GH_DF, L_P0, L_P1, L_P2,
           L_P3, L_PA3, L_PA2, L_PA1, L_PA0, L_MASK, L_COEF, L_SE, L_SMEM, L_MEAN, L_UNIT,
           L_ENC_H, L_DEC_H, L_DF_H, L_RING_RE, L_RING_IM, L_LSNR, L_MUTE, L_SILCTR, N_LAY };

// the plan table: header, scratch offsets, carry segments, phases, jobs,
// edges, and the frame phases' block ranks (uint16, two an int: block b runs
// the units u of frame phase ph with u mod the grid = rank[ph][b])
enum Hdr { H_PHASES, H_JOBS, H_TILES, H_FRAME_PHASES, H_PRE, H_SEGS, H_LAY, H_SCR, H_DEPS,
           HEADER_INTS };
enum JobField { J_TYPE, J_BEGIN, J_UNITS, J_XOFF, J_K, J_W, J_NCAT, J_CSTRIDE, J_CW, J_SLICES,
                J_BIAS, J_ACT, J_ADD, J_Y, J_YRAW, J_EP, J_H, J_GH, J_KG, J_AUX, J_RND, J_KSEG,
                J_DEP0, J_NDEP, JOB_INTS };
// an edge of a frame job: the producer's job row, its units in a tile in one
// frame, and the frame it is waited for in (0: the consumer's, -1: the one
// before)
enum DepField { D_JOB, D_PER_TILE, D_FRAME, DEP_INTS };
// J_W: the weight's offset in wpack, in elements; J_CSTRIDE: columns between
// the groups in the unpacked weight (the host's bookkeeping); J_AUX: chunks
// (elementwise), columns of a thread's register tile (product, float32 build;
// 0 in the bfloat16 build's plan); J_RND, J_KSEG: where the bfloat16 build
// rounds the result (Rnd), and the K rows of each input segment whose product
// it rounds before adding (0: one sum); J_DEP0, J_NDEP: the job's edges
constexpr int PHASE_INTS = 3;  // first job, jobs, units
enum JobType { T_GEMM, T_CARRY_IN, T_FRAME0, T_ADVANCE, T_LSNR, T_CARRY_OUT };
enum Epilogue { EP_STD, EP_SPEC, EP_ERBNORM, EP_GRU, EP_TAIL, EP_OLA };
enum Act { ACT_NONE, ACT_RELU, ACT_SIGMOID, ACT_TANH };
// never (float32 result); the sum only (the bias then added in float32); the
// sum, the bias add and the addend add (the model trunk)
enum Rnd { R_F32, R_SUM, R_TRUNK };

struct Params {
  const float* audio;  // [S, T]
  float* out;          // [S, T]
  const float* cin[N_CKEYS];
  float* cout[N_CKEYS];
  const void* w[N_WKEYS];       // WKEYS order (biases and the small vectors are read here);
                                // the weights' type but imult and convp_b, float32
  const void* wpack;            // every product's weight, packed by unit slice
  float* scratch;               // [tiles, SCR, RT]
  const int* table;
  int table_ints;
  unsigned int* counters;       // the grid barrier's, then one per job and tile; zero at launch
  // null, or [gridDim.x][frame phases + 4]: each block's ns in each frame
  // phase's units, its ns waiting on producers, then its first and last
  // reading of the global timer over the frames and its SM cycles between them
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
// two floats rounded to bfloat16 (to nearest, ties to even) in one register,
// `lo` in its lower half: a k-neighbour pair of an mma fragment
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
// c += A B on the tensor cores, m16n8k16, bfloat16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm(  // not volatile: a pure function of its operands
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float act_apply(float v, int act) {
  switch (act) {
    case ACT_RELU: return fmaxf(v, 0.0f);
    case ACT_SIGMOID: return sigmoidf_(v);
    case ACT_TANH: return tanhf(v);
    default: return v;
  }
}

// ---- bulk copies (TMA, no tensor map) into a ring of shared-memory stages,
// each stage with an mbarrier that counts the bytes still to land
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(arrivals));
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
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// barrier of the compute threads only
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- counters in global memory: the grid barrier's, and one per (job, tile)
// that counts the units of the job done in the tile over the whole launch
__device__ __forceinline__ unsigned ld_acquire(const unsigned int* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void red_release(unsigned int* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// All blocks of the (cooperative) grid meet here. `target` counts arrivals
// over the whole launch, so the counter is never reset.
__device__ __forceinline__ void grid_barrier(unsigned int* ctr, unsigned int& target) {
  // what this thread stored to the scratch is read next by other blocks' bulk
  // copies (the async proxy)
  asm volatile("fence.proxy.async;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    target += gridDim.x;
    __threadfence();
    atomicAdd(ctr, 1u);
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(ctr) : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

template <typename WT>
struct Ctx {
  const Params& p;
  const int* tab;      // the plan, in shared memory
  const int* lay;      // scratch offsets
  const int* jobs;     // the job rows
  const int* deps;     // the frame jobs' edges
  long long* clk;      // the block's stage clocks (CLK_*), when the launch records
  float* smem;         // the ring's stages; the reduction tile takes their place
  unsigned long long* full;   // per stage: the bytes have landed
  unsigned long long* empty;  // per stage: every compute warp is done reading
  const float* sm_co;  // convp_co
  const float* sm_cb;  // convp_b
};

// Lanes of one warp wait, an edge a lane, until every producer of job J has
// done its units in this tile up to the frame the edge names (the counter
// reads with acquire semantics at GPU scope); then the warp meets.
template <typename WT>
__device__ void wait_producers(const Ctx<WT>& c, const int* J, int tile, int f, int lane) {
  const int tiles = c.tab[H_TILES];
  for (int i = lane; i < J[J_NDEP]; i += 32) {
    const int* d = c.deps + (J[J_DEP0] + i) * DEP_INTS;
    const int target = d[D_PER_TILE] * (f + 1 + d[D_FRAME]);
    const unsigned int* ctr = c.p.counters + 1 + d[D_JOB] * tiles + tile;
    if (target > 0)
      while (ld_acquire(ctr) < (unsigned)target) {
      }
  }
  __syncwarp();
}

// A unit of job J is done (compute threads): every thread's stores are made
// visible to the copy engine, which reads them next in other blocks' bulk
// copies; then one thread counts the unit with release semantics.
template <typename WT>
__device__ __forceinline__ void unit_done(const Ctx<WT>& c, const int* J, int tile) {
  asm volatile("fence.proxy.async;\n" ::: "memory");
  compute_sync();
  if (threadIdx.x == 0) {
    const int ji = (int)(J - c.jobs) / JOB_INTS;
    red_release(c.p.counters + 1 + ji * c.tab[H_TILES] + tile, 1u);
  }
}

// The float32 build's share of a unit's product: a thread owns 8 rows x MC
// columns of the tile (MC = 8 where the slice is wide enough: one byte of
// shared memory read per multiply-add, which is what the multiprocessor can
// feed; MC = 2 for narrow slices) and K group kgi's share of each chunk's K
// rows, in float32 FMAs.
template <int MC>
struct FmaTile {
  float acc[MC][8];
  int kgi, rg, cg;
  bool active;

  __device__ FmaTile(int tid, int cnt, int kg_n) {
    const int tpk = 8 * cnt / MC;  // threads of a K group: 8 row groups x cnt / MC column groups
    kgi = tid / tpk;
    const int idx = tid % tpk;
    rg = idx & 7;
    cg = idx >> 3;
    active = kgi < kg_n;
    clear();
  }
  __device__ void clear() {
#pragma unroll
    for (int j = 0; j < MC; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[j][i] = 0.f;
  }
  // the products of one stage: x [KC][RT], the weight slice [KC][cnt]
  __device__ void mac(const float* xs, const float* ws, int len, int cnt, int kg_n) {
    if (!active) return;
    const int kper = len / kg_n;
    const float* xp = xs + kgi * kper * RT + rg * 4;
    const float* wq = ws + kgi * kper * cnt + cg * MC;
#pragma unroll 2
    for (int kk = 0; kk < kper; ++kk) {
      const float4 xa = *reinterpret_cast<const float4*>(xp + kk * RT);
      const float4 xb = *reinterpret_cast<const float4*>(xp + kk * RT + 32);
      const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      float wv[MC];
      if constexpr (MC == 8) {
        const float4 wa = *reinterpret_cast<const float4*>(wq + kk * cnt);
        const float4 wb = *reinterpret_cast<const float4*>(wq + kk * cnt + 4);
        wv[0] = wa.x; wv[1] = wa.y; wv[2] = wa.z; wv[3] = wa.w;
        wv[4] = wb.x; wv[5] = wb.y; wv[6] = wb.z; wv[7] = wb.w;
      } else {
        const float2 w2 = *reinterpret_cast<const float2*>(wq + kk * cnt);
        wv[0] = w2.x; wv[1] = w2.y;
      }
#pragma unroll
      for (int j = 0; j < MC; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(xv[i], wv[j], acc[j][i]);
    }
  }
  // this K group's partial sums -> red[kgi][col][row]
  __device__ void to_red(float* red, int cnt) const {
    if (!active) return;
#pragma unroll
    for (int j = 0; j < MC; ++j) {
      float* r = red + (size_t)((kgi * cnt + cg * MC + j) * RT) + rg * 4;
      *reinterpret_cast<float4*>(r) = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      *reinterpret_cast<float4*>(r + 32) = make_float4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]);
    }
  }
};

// The bfloat16 build's share of a unit's product, on the tensor cores
// (mma.sync m16n8k16, bfloat16 x bfloat16 -> float32). Warp w multiplies the
// k16 step ks = w / 2 of every chunk (its K group) for the 32 stream rows of
// half pr = w % 2 of the tile, by all n8 tiles of the slice (a slice of 4 or 12
// columns is packed with zero columns up to whole tiles). The A
// fragments come from the float32 stage [KC][RT], two k rows packed by
// cvt.rn.bf16x2.f32, which is the rounding of the input to bfloat16 (exact for
// what trunk products wrote). A fragment row g of the half's first m16 tile is
// stream row 4g, row g + 8 is 4g + 1, of its second tile 4g + 2 and 4g + 3:
// one 16-byte load at (k, 4g) then serves both tiles, and the 8 lanes of a k
// row read 128 bytes, so the loads meet no bank conflict. The B fragments come
// from the slice packed in fragment order (whole_cell_plan.pack_weights), one
// 8-byte load a lane. Each step's product is added to the warp's float32 sums
// rounded to nearest; the tensor core's own accumulation, which truncates,
// never spans more than one step.
struct MmaTile {
  static constexpr int NT = MAX_CNT / 8;
  float acc[2][NT][4];
  int pr, ks, lane;

  __device__ MmaTile(int tid, int, int) {
    const int warp = tid >> 5;
    pr = warp & 1;
    ks = warp >> 1;
    lane = tid & 31;
    clear();
  }
  __device__ void clear() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  }
  __device__ void mac(const float* xs, const __nv_bfloat16* ws, int len, int cnt, int) {
    if (ks * 16 >= len) return;  // a chunk of 32 rows has two k16 steps
    const int g = lane >> 2, t = lane & 3, nt = (cnt + 7) / 8;
    const float* xk = xs + (ks * 16 + 2 * t) * RT + 32 * pr + 4 * g;
    const float4 v0 = *reinterpret_cast<const float4*>(xk);
    const float4 v1 = *reinterpret_cast<const float4*>(xk + RT);
    const float4 v8 = *reinterpret_cast<const float4*>(xk + 8 * RT);
    const float4 v9 = *reinterpret_cast<const float4*>(xk + 9 * RT);
    const unsigned a[2][4] = {
        {pack_bf16(v0.x, v1.x), pack_bf16(v0.y, v1.y), pack_bf16(v8.x, v9.x), pack_bf16(v8.y, v9.y)},
        {pack_bf16(v0.z, v1.z), pack_bf16(v0.w, v1.w), pack_bf16(v8.z, v9.z), pack_bf16(v8.w, v9.w)}};
    const uint2* wb = reinterpret_cast<const uint2*>(ws) + ks * nt * 32 + lane;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        const uint2 b = wb[j * 32];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};  // one step, then added rounded to nearest
          mma_bf16(d, a[i], b.x, b.y);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] += d[q];
        }
      }
    }
  }
  // this K group's partial sums -> red[ks][col][row]: a lane holds columns
  // 8j + 2t and 8j + 2t + 1 of stream rows 32pr + 4g .. 4g + 3 (none of them
  // where they are the zero padding of a slice of 4 or 12 columns)
  __device__ void to_red(float* red, int cnt) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (8 * j + 2 * t < cnt) {
        float* r = red + (size_t)((ks * cnt + 8 * j + 2 * t) * RT) + 32 * pr + 4 * g;
        *reinterpret_cast<float4*>(r) =
            make_float4(acc[0][j][0], acc[0][j][2], acc[1][j][0], acc[1][j][2]);
        *reinterpret_cast<float4*>(r + RT) =
            make_float4(acc[0][j][1], acc[0][j][3], acc[1][j][1], acc[1][j][3]);
      }
    }
  }
};

// One unit of a product: tile `tile` of stream rows, column slice `slice`.
// MC: the float32 build's register tile (FmaTile); the bfloat16 build
// multiplies on the tensor cores (MmaTile). WT: the weights' type.
template <int MC, typename WT, bool TIMED>
__device__ void gemm_unit(const Ctx<WT>& c, unsigned& fills, const int* J, int tile, int slice,
                          int f) {
  constexpr bool BF = kBf16<WT>;
  const Params& p = c.p;
  const int tid = threadIdx.x;
  const int SCR = c.tab[H_SCR];
  float* sct = p.scratch + (size_t)tile * SCR * RT;
  const int K = J[J_K], ncat = J[J_NCAT];
  const int cw = J[J_CW], kg_n = J[J_KG], x_off = J[J_XOFF];
  const int cnt = ncat * cw;
  const int col0 = slice * cw;
  float* red = c.smem + NSTG * STAGE_FLOATS;

  const int n_chunks = (K + KC - 1) / KC;
  // bfloat16: chunks of each input segment whose product is rounded on its own
  const int seg_chunks = BF && J[J_KSEG] > 0 ? J[J_KSEG] / KC : 0;

  // Fill number q of the ring (counted over the whole launch, the same in
  // every thread) goes to stage q % NSTG; it is that stage's (q / NSTG)-th use.
  if (tid >= THREADS) {
    // ---- the copy warp: two bulk copies (TMA) a chunk, issued by its first
    // lane, the unit's weight slice, which the wrapper has packed
    // contiguously ([slice][K][columns], in fragment order for the bfloat16
    // build), and the input tile's K rows. The weights are constant, so the
    // first stages' weight copies go out as soon as the stages are free;
    // the input copies wait until the warp has seen every producer of the
    // job done in this tile. A stage's mbarrier takes two arrivals: the
    // expected bytes before its first copy, and one after the producers
    // were seen, so that the compute warps' wait on the stage orders that
    // acquire before their own loads (the epilogue's). The warp runs ahead
    // of the compute warps by the depth of the ring, into the block's next
    // unit too.
    const int lane = tid - THREADS;
    // the slice's packed columns: whole n8 tiles in the bfloat16 build
    const int wcols = BF ? (cnt + 7) & ~7 : cnt;
    const WT* wsl =
        static_cast<const WT*>(p.wpack) + (size_t)J[J_W] + (size_t)slice * K * wcols;
    const int ahead = min(n_chunks, NSTG);  // chunks whose weights go before the wait
    auto fill = [&](int o) {  // a free stage, its bytes expected, the weights copied
      const unsigned q = fills + o;
      const int st = q % NSTG;
      const unsigned use = q / NSTG;
      if (use > 0) mbar_wait(c.empty + st, (use - 1) & 1u);
      const int k0 = o * KC;
      const int len = min(KC, K - k0);
      // the stage was last read by ordinary loads: order them before the
      // copy engine's writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect(c.full + st, (unsigned)(len * (RT * sizeof(float) + wcols * sizeof(WT))));
      // len is a multiple of 32 and wcols of 4: at least 256 bytes, 16-byte aligned
      bulk_copy(c.smem + st * STAGE_FLOATS + KC * RT, wsl + (size_t)k0 * wcols,
                (unsigned)(len * wcols * sizeof(WT)), c.full + st);
    };
    if (lane == 0)
      for (int o = 0; o < ahead; ++o) fill(o);
    wait_producers(c, J, tile, f, lane);
    if (lane == 0) {
      // the producers' stores, made visible to the copy engine before they
      // were counted, are read next by it
      asm volatile("fence.proxy.async;\n" ::: "memory");
      for (int o = 0; o < n_chunks; ++o) {
        if (o >= ahead) fill(o);
        const int st = (fills + o) % NSTG;
        const int k0 = o * KC;
        const int len = min(KC, K - k0);
        mbar_arrive(c.full + st);
        bulk_copy(c.smem + st * STAGE_FLOATS, sct + (size_t)(x_off + k0) * RT,
                  (unsigned)(len * RT * sizeof(float)), c.full + st);
      }
    }
    fills += n_chunks;
    return;
  }

  std::conditional_t<BF, MmaTile, FmaTile<MC>> prod(tid, cnt, kg_n);
  auto partials_to_red = [&]() {
    prod.to_red(red, cnt);
    compute_sync();
  };
  // bfloat16, segmented K: each thread keeps a running rounded total of its
  // share of the tile's outputs (i = tid + m * THREADS)
  constexpr int TOT = BF ? MAX_CNT * RT / THREADS : 1;
  float tot[TOT];
  for (int o = 0; o < n_chunks; ++o) {
    const unsigned q = fills + o;
    const int st = q % NSTG;
    mbar_wait(c.full + st, (q / NSTG) & 1u);
    if (TIMED && o == 0 && tid == 0) c.clk[CLK_READY] = clock64();  // the unit's inputs are in
    const float* xs = c.smem + st * STAGE_FLOATS;
    prod.mac(xs, reinterpret_cast<const WT*>(xs + KC * RT), min(KC, K - o * KC), cnt, kg_n);
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(c.empty + st);  // this warp is done with the stage
    if (seg_chunks > 0 && (o + 1) % seg_chunks == 0) {
      // a segment ends: its sum rounded, added to the rounded total and
      // rounded again; after the last, the total is the unit's tile
      partials_to_red();
      const bool first = o + 1 == seg_chunks, last = o + 1 == n_chunks;
#pragma unroll
      for (int m = 0; m < TOT; ++m) {
        const int i = tid + m * THREADS;
        if (i < cnt * RT) {
          float v = red[i];
          for (int g = 1; g < kg_n; ++g) v += red[g * cnt * RT + i];
          v = bf16r(v);
          tot[m] = first ? v : bf16r(tot[m] + v);
          if (last) red[i] = tot[m];
        }
      }
      compute_sync();
      prod.clear();
    }
  }
  fills += n_chunks;
  if (seg_chunks == 0) {  // the K groups' partial sums added in group order
    partials_to_red();
    if (kg_n > 1) {
      for (int i = tid; i < cnt * RT; i += THREADS) {
        float v = red[i];
        for (int g = 1; g < kg_n; ++g) v += red[g * cnt * RT + i];
        red[i] = v;
      }
      compute_sync();
    }
  }

  // ---- epilogue on the unit's finished tile red[col][row]; the bfloat16
  // build rounds where the job says (Rnd), the float32 build never
  const int rnd = BF ? J[J_RND] : R_F32;
  auto r_sum = [&](float v) { return rnd != R_F32 ? bf16r(v) : v; };
  auto r_trunk = [&](float v) { return rnd == R_TRUNK ? bf16r(v) : v; };
  const int row0 = tile * RT;
  const WT* bias = J[J_BIAS] >= 0 ? static_cast<const WT*>(p.w[J[J_BIAS]]) : nullptr;
  const int* L = c.lay;
  switch (J[J_EP]) {
    case EP_STD: {
      // in batches of EPB elements a thread: the loads of a batch are all
      // issued before its first store (the compiler must keep a load behind
      // an earlier store to the scratch)
      const int act = J[J_ACT], y = J[J_Y], yraw = J[J_YRAW], add = J[J_ADD];
      for (int i0 = tid; i0 < cnt * RT; i0 += EPB * THREADS) {
        float v[EPB], ad[EPB];
#pragma unroll
        for (int u = 0; u < EPB; ++u) {
          const int i = i0 + u * THREADS;
          if (i >= cnt * RT) break;
          const int col = col0 + i / RT, r = i % RT;
          v[u] = r_sum(red[i]);
          if (bias) v[u] = r_trunk(v[u] + wget(bias, col));
          ad[u] = add >= 0 ? __ldcg(sct + (size_t)(add + col) * RT + r) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < EPB; ++u) {
          const int i = i0 + u * THREADS;
          if (i >= cnt * RT) break;
          const int col = col0 + i / RT, r = i % RT;
          const float a = act_apply(v[u], act);
          if (yraw >= 0) sct[(size_t)(yraw + col) * RT + r] = a;
          sct[(size_t)(y + col) * RT + r] = add >= 0 ? r_trunk(a + ad[u]) : a;
        }
      }
      break;
    }
    case EP_SPEC: {  // power, unit norm, complex features of this frame
      for (int i = tid; i < cw * RT; i += THREADS) {
        const int j = i / RT, r = i % RT;
        const int k = col0 + j;
        const float re = red[j * RT + r], im = red[(cw + j) * RT + r];
        const float pw = re * re + im * im;
        sct[(size_t)(L[L_SPEC] + k) * RT + r] = re;
        sct[(size_t)(L[L_SPEC] + FPAD + k) * RT + r] = im;
        sct[(size_t)(L[L_POW] + k) * RT + r] = pw;
        if (k < NB_DF) {
          float* un = sct + (size_t)(L[L_UNIT] + k) * RT + r;
          const float u = sqrtf(pw) * p.one_minus_alpha + __ldcg(un) * p.alpha;
          *un = u;
          const float scale = rsqrtf(u);
          sct[(size_t)(L[L_FSWIN] + 384 + k) * RT + r] = re * scale;
          sct[(size_t)(L[L_FSWIN] + 384 + NB_DF + k) * RT + r] = im * scale;
        }
      }
      break;
    }
    case EP_ERBNORM: {
      for (int i = tid; i < cnt * RT; i += THREADS) {
        const int e = col0 + i / RT, r = i % RT;
        const float db = 10.0f * log10f(red[i] + 1e-10f);
        float* mp = sct + (size_t)(L[L_MEAN] + e) * RT + r;
        const float mean = db * p.one_minus_alpha + __ldcg(mp) * p.alpha;
        *mp = mean;
        sct[(size_t)(L[L_ERBWIN] + 64 + e) * RT + r] = (db - mean) / 40.0f;
      }
      break;
    }
    case EP_GRU: {  // gates on gi (here) and gh = h @ w_hh + b_hh (scratch); h in place
      const int ho = J[J_H], gho = J[J_GH];
      for (int i0 = tid; i0 < cw * RT; i0 += EPB * THREADS) {
        float gh_r[EPB], gh_z[EPB], gh_n[EPB], h[EPB];
#pragma unroll
        for (int u = 0; u < EPB; ++u) {
          const int i = i0 + u * THREADS;
          if (i >= cw * RT) break;
          const int col = col0 + i / RT, r = i % RT;
          gh_r[u] = __ldcg(sct + (size_t)(gho + col) * RT + r);
          gh_z[u] = __ldcg(sct + (size_t)(gho + HID + col) * RT + r);
          gh_n[u] = __ldcg(sct + (size_t)(gho + 2 * HID + col) * RT + r);
          h[u] = __ldcg(sct + (size_t)(ho + col) * RT + r);
        }
#pragma unroll
        for (int u = 0; u < EPB; ++u) {
          const int i = i0 + u * THREADS;
          if (i >= cw * RT) break;
          const int j = i / RT, r = i % RT;
          const int col = col0 + j;
          const float gi_r = r_trunk(r_sum(red[j * RT + r]) + wget(bias, col));
          const float gi_z = r_trunk(r_sum(red[(cw + j) * RT + r]) + wget(bias, HID + col));
          const float gi_n =
              r_trunk(r_sum(red[(2 * cw + j) * RT + r]) + wget(bias, 2 * HID + col));
          const float rgate = sigmoidf_(gi_r + gh_r[u]);
          const float zg = sigmoidf_(gi_z + gh_z[u]);
          const float ng = tanhf(gi_n + rgate * gh_n[u]);
          sct[(size_t)(ho + col) * RT + r] = (1.0f - zg) * ng + zg * h[u];
        }
      }
      break;
    }
    case EP_TAIL: {  // DF MAC (low bins), mask gains, post-filter, gating, atten-lim, mute
      for (int i = tid; i < cnt * RT; i += THREADS) {
        const int k = col0 + i / RT, r = i % RT;
        auto S_ = [&](int col) { return sct + (size_t)col * RT + r; };
        const float g = red[i];
        const float re = __ldcg(S_(L[L_SPEC] + k)), im = __ldcg(S_(L[L_SPEC] + FPAD + k));
        const float m_re = re * g, m_im = im * g;
        float se_re = m_re, se_im = m_im;
        if (k < BLK) {
          // ring frames 0..3, the current frame as tap 4; then the ring
          // shifts. Pad lanes (k >= 96) of the current frame are 0.
          const float cur_re = k < NB_DF ? re : 0.f, cur_im = k < NB_DF ? im : 0.f;
          float c0v[CH];
#pragma unroll
          for (int q = 0; q < CH; ++q) c0v[q] = __ldcg(S_(L[L_C0] + q * BLK + k));
          float ring_re[ORDER - 1], ring_im[ORDER - 1];
#pragma unroll
          for (int n = 0; n < ORDER - 1; ++n) {
            ring_re[n] = __ldcg(S_(L[L_RING_RE] + n * BLK + k));
            ring_im[n] = __ldcg(S_(L[L_RING_IM] + n * BLK + k));
          }
          float y_re = 0.f, y_im = 0.f;
#pragma unroll
          for (int n = 0; n < ORDER; ++n) {
            const float t_re = n < ORDER - 1 ? ring_re[n] : cur_re;
            const float t_im = n < ORDER - 1 ? ring_im[n] : cur_im;
            float cp_re = 0.f, cp_im = 0.f;
#pragma unroll
            for (int q = 0; q < CH; ++q) {
              cp_re = fmaf(c.sm_co[q * ORDER * 2 + 2 * n], c0v[q], cp_re);
              cp_im = fmaf(c.sm_co[q * ORDER * 2 + 2 * n + 1], c0v[q], cp_im);
            }
            const float c_re = __ldcg(S_(L[L_COEF] + (2 * n) * BLK + k)) +
                               fmaxf(cp_re + c.sm_cb[2 * n], 0.f);
            const float c_im = __ldcg(S_(L[L_COEF] + (2 * n + 1) * BLK + k)) +
                               fmaxf(cp_im + c.sm_cb[2 * n + 1], 0.f);
            y_re = y_re + t_re * c_re - t_im * c_im;
            y_im = y_im + t_re * c_im + t_im * c_re;
          }
#pragma unroll
          for (int n = 0; n < ORDER - 2; ++n) {
            *S_(L[L_RING_RE] + n * BLK + k) = ring_re[n + 1];
            *S_(L[L_RING_IM] + n * BLK + k) = ring_im[n + 1];
          }
          *S_(L[L_RING_RE] + (ORDER - 2) * BLK + k) = cur_re;
          *S_(L[L_RING_IM] + (ORDER - 2) * BLK + k) = cur_im;
          if (k < NB_DF) { se_re = y_re; se_im = y_im; }
        }
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
          const float ls = __ldcg(S_(L[L_LSNR]));
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
        if (__ldcg(S_(L[L_MUTE])) != 0.f) {  // the mute comes last, after atten-lim
          se_re = 0.f; se_im = 0.f;
        }
        const float sc_k = __ldg(static_cast<const float*>(p.w[W_IMULT]) + k);
        *S_(L[L_SE] + k) = se_re * sc_k;
        *S_(L[L_SE] + FPAD + k) = se_im * sc_k;
      }
      break;
    }
    case EP_OLA: {  // the unit owns x[c] and x[HOP + c]: output, then the new tail
      const int T = p.n_frames * HOP;
      for (int i = tid; i < cw * RT; i += THREADS) {
        const int j = i / RT, r = i % RT;
        const int cc = col0 + j;
        float* tail = sct + (size_t)(L[L_SMEM] + cc) * RT + r;
        const float o = red[j * RT + r] + __ldcg(tail);
        if (row0 + r < p.S) p.out[(size_t)(row0 + r) * T + (size_t)f * HOP + cc] = o;
        *tail = red[(cw + j) * RT + r];
      }
      break;
    }
  }
  unit_done(c, J, tile);  // and red and the ring are free for the next unit
}

// Audio frame f into buf's second half (after moving the last frame to the
// first half and advancing the conv windows, when `shift`), and, in chunk 0,
// that frame's RMS silence counter and mute flag.
template <typename WT>
__device__ void frame_in_unit(const Ctx<WT>& c, int tile, int chunk, int chunks, int f,
                              bool shift) {
  const Params& p = c.p;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid >= THREADS) return;
  const int* L = c.lay;
  float* sct = p.scratch + (size_t)tile * c.tab[H_SCR] * RT;
  const int row0 = tile * RT;
  const int T = p.n_frames * HOP;
  const bool load = f < p.n_frames;
  for (int i = chunk * THREADS + tid; i < HOP * RT; i += chunks * THREADS) {
    const int r = i / HOP, cc = i % HOP;
    float* lo = sct + (size_t)(L[L_BUF] + cc) * RT + r;
    float* hi = sct + (size_t)(L[L_BUF] + HOP + cc) * RT + r;
    if (shift) *lo = __ldcg(hi);  // prev_hop = frame
    if (load) *hi = p.audio[(size_t)min(row0 + r, p.S - 1) * T + (size_t)f * HOP + cc];
  }
  if (shift) {  // conv contexts advance one frame
    for (int i = chunk * THREADS + tid; i < 192 * RT; i += chunks * THREADS) {
      float* w0 = sct + (size_t)L[L_FSWIN] * RT + i;
      w0[0] = __ldcg(w0 + 192 * RT);
      w0[192 * RT] = __ldcg(w0 + 384 * RT);
    }
    for (int i = chunk * THREADS + tid; i < NB_ERB * RT; i += chunks * THREADS) {
      float* w0 = sct + (size_t)L[L_ERBWIN] * RT + i;
      w0[0] = __ldcg(w0 + NB_ERB * RT);
      w0[NB_ERB * RT] = __ldcg(w0 + 2 * NB_ERB * RT);
    }
  }
  if (chunk == 0 && load) {  // one warp per row
    for (int r = warp; r < RT; r += THREADS / 32) {
      const float* a = p.audio + (size_t)min(row0 + r, p.S - 1) * T + (size_t)f * HOP;
      float ss = 0.f;
      for (int cc = lane; cc < HOP; cc += 32) ss = fmaf(a[cc], a[cc], ss);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
      if (lane == 0) {
        float* ctr = sct + (size_t)L[L_SILCTR] * RT + r;
        const float rms = sqrtf(ss / (float)HOP);
        const float n = rms < p.silence_thresh ? __ldcg(ctr) + 1.0f : 0.0f;
        *ctr = n;
        sct[(size_t)L[L_MUTE] * RT + r] = n >= (float)p.silence_frames ? 1.0f : 0.0f;
      }
    }
  }
}

template <typename WT>
__device__ void lsnr_unit(const Ctx<WT>& c, int tile) {
  const Params& p = c.p;
  const int r = threadIdx.x;
  if (r >= RT) return;
  const int* L = c.lay;
  float* sct = p.scratch + (size_t)tile * c.tab[H_SCR] * RT;
  const WT* w = static_cast<const WT*>(p.w[W_LSNR_W]);
  float a = 0.f;  // emb2 is a trunk activation: already in the operand type
#pragma unroll 8
  for (int k = 0; k < 128; ++k)
    a = fmaf(__ldcg(sct + (size_t)(L[L_EMB2] + k) * RT + r), wget(w, k), a);
  sct[(size_t)L[L_LSNR] * RT + r] =
      sigmoidf_(a + wget(static_cast<const WT*>(p.w[W_LSNR_B]), 0)) * (p.lsnr_max - p.lsnr_min) +
      p.lsnr_min;
}

// carry <-> scratch state, by the plan's segments; `store`: scratch -> carry,
// valid rows only
template <typename WT>
__device__ void carry_unit(const Ctx<WT>& c, int tile, int chunk, int chunks, bool store) {
  const Params& p = c.p;
  const int tid = threadIdx.x;
  if (tid >= THREADS) return;
  float* sct = p.scratch + (size_t)tile * c.tab[H_SCR] * RT;
  const int row0 = tile * RT;
  const int* seg = c.tab + HEADER_INTS + c.tab[H_LAY];
  for (int s = 0; s < c.tab[H_SEGS]; ++s, seg += 4) {
    const int key = seg[0], cstart = seg[1], len = seg[2], soff = seg[3];
    const int d = CWIDTH[key];
    for (int i = chunk * THREADS + tid; i < len * RT; i += chunks * THREADS) {
      const int r = i / len, cc = i % len;
      float* sp = sct + (size_t)(soff + cc) * RT + r;
      if (!store) {
        *sp = p.cin[key][(size_t)min(row0 + r, p.S - 1) * d + cstart + cc];
      } else if (row0 + r < p.S) {
        p.cout[key][(size_t)(row0 + r) * d + cstart + cc] = __ldcg(sp);
      }
    }
  }
  if (store && chunk == 0) {  // the unused columns of `sil` pass through
    for (int i = tid; i < RT * 7; i += THREADS) {
      const int row = row0 + i / 7, cc = 1 + i % 7;
      if (row < p.S) p.cout[C_SIL][(size_t)row * 8 + cc] = p.cin[C_SIL][(size_t)row * 8 + cc];
    }
  }
}

#ifdef DFN_K2_PLANT
// A test build only: thread 0 spends k2_plant_ns of the global timer at the
// end of each unit of frame phase k2_plant_stage (dfn_k2_plant sets both), so
// that a test can see the planted time land in that phase's record.
__device__ int k2_plant_stage = -1;
__device__ long long k2_plant_ns = 0;
#endif

// The kernel's body. TIMED: the recording build (Params::records is set); the
// other reads no clock at all. Each build is a kernel of its own name
// (whole_cell_kernel, whole_cell_recording), so a trace tells them apart.
template <typename WT, bool TIMED>
__device__ __forceinline__ void whole_cell_body(const Params& p) {
  extern __shared__ __align__(128) float smem[];
  __shared__ int tab[TAB_MAX];
  __shared__ float sm_co[CH * ORDER * 2];
  __shared__ float sm_cb[ORDER * 2];
  __shared__ __align__(8) unsigned long long full[NSTG];
  __shared__ __align__(8) unsigned long long empty[NSTG];
  __shared__ long long clk[CLK_START + 1];
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < NSTG; ++i) {
      mbar_init(full + i, 2);              // the copy lane's expect, then its arrival once
                                           // the producers are seen; then bytes count
      mbar_init(empty + i, THREADS / 32);  // one arrival a compute warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::);
  }
  if (TIMED && tid <= CLK_START) clk[tid] = 0;
  for (int i = tid; i < p.table_ints; i += THREADS) tab[i] = p.table[i];
  for (int i = tid; i < CH * ORDER * 2; i += THREADS)
    sm_co[i] = wget(static_cast<const WT*>(p.w[W_CONVP_CO]), i);
  if (tid < ORDER * 2) sm_cb[tid] = static_cast<const float*>(p.w[W_CONVP_B])[tid];
  __syncthreads();
  const int tiles = tab[H_TILES], n_pre = tab[H_PRE], n_fp = tab[H_FRAME_PHASES];
  const int* phases = tab + HEADER_INTS + tab[H_LAY] + 4 * tab[H_SEGS];
  const int* jobs = phases + PHASE_INTS * tab[H_PHASES];
  const int* deps = jobs + JOB_INTS * tab[H_JOBS];
  const unsigned short* ranks =
      reinterpret_cast<const unsigned short*>(deps + DEP_INTS * tab[H_DEPS]);
  const Ctx<WT> c{p, tab, tab + HEADER_INTS, jobs, deps, clk, smem, full, empty, sm_co, sm_cb};
  unsigned fills = 0;  // ring fills so far, the same in every thread

  // The units of phase ph this block owns, those u with u mod the grid =
  // `first`, in order: the global order is frame by frame, phase by phase,
  // and a phase's units by number, and every block walks its own in it.
  auto for_units = [&](int ph, int first, auto&& run) {
    const int* P = phases + ph * PHASE_INTS;
    for (int u = first; u < P[2]; u += gridDim.x) {
      const int* J = jobs + P[0] * JOB_INTS;
      while (u >= J[J_BEGIN] + J[J_UNITS]) J += JOB_INTS;
      const int local = u - J[J_BEGIN];
      run(J, local % tiles, local / tiles);
    }
  };

  // carry in, the first frame in: a grid barrier after each
  unsigned int target = 0;
  for (int ph = 0; ph < n_pre; ++ph) {
    for_units(ph, blockIdx.x, [&](const int* J, int tile, int part) {
      if (J[J_TYPE] == T_CARRY_IN) carry_unit(c, tile, part, J[J_AUX], false);
      else frame_in_unit(c, tile, part, J[J_AUX], 0, false);
    });
    grid_barrier(p.counters, target);
  }

  // the frames: no barrier; a unit waits only on its producers' counters.
  // When the launch records, thread 0 of each block keeps its cycles in each
  // phase's units, less those spent waiting on producers (from a unit's start
  // until its first input stage is in, or until an elementwise unit's
  // producers are done).
  const bool timer = TIMED && tid == 0;
  if (timer) {
    clk[CLK_GT0] = globaltimer();
    clk[CLK_START] = clk[CLK_PREV] = clock64();
  }
  for (int f = 0; f < p.n_frames; ++f) {
    for (int ph = 0; ph < n_fp; ++ph) {
      const int first = ranks[ph * gridDim.x + blockIdx.x];
      for_units(n_pre + ph, first, [&](const int* J, int tile, int part) {
        if (J[J_TYPE] == T_GEMM) {
          if constexpr (kBf16<WT>)
            gemm_unit<8, WT, TIMED>(c, fills, J, tile, part, f);  // MC unused
          else if (J[J_AUX] == 8) gemm_unit<8, WT, TIMED>(c, fills, J, tile, part, f);
          else gemm_unit<2, WT, TIMED>(c, fills, J, tile, part, f);
        } else if (tid < THREADS) {  // elementwise: the compute threads alone
          if (tid < 32) wait_producers(c, J, tile, f, tid);
          compute_sync();
          if (TIMED && tid == 0) clk[CLK_READY] = clock64();
          if (J[J_TYPE] == T_ADVANCE) frame_in_unit(c, tile, part, J[J_AUX], f + 1, true);
          else lsnr_unit(c, tile);
          unit_done(c, J, tile);
        }
        if (timer && ph < MAX_FRAME_PHASES) {
#ifdef DFN_K2_PLANT
          if (ph == k2_plant_stage)
            for (const long long t = globaltimer(); globaltimer() - t < k2_plant_ns;) {
            }
#endif
          const long long t1 = clock64(), prev = clk[CLK_PREV], ready = clk[CLK_READY];
          const long long wait = ready > prev ? ready - prev : 0;
          clk[ph] += t1 - prev - wait;
          clk[CLK_WAIT] += wait;
          clk[CLK_PREV] = t1;
        }
      });
    }
  }
  if (timer) {
    const long long gt1 = globaltimer(), c1 = clock64();
    const double ns_a_clk =
        c1 > clk[CLK_START] ? (double)(gt1 - clk[CLK_GT0]) / (double)(c1 - clk[CLK_START]) : 0.0;
    long long* rec = p.records + (size_t)blockIdx.x * (n_fp + 4);
    for (int ph = 0; ph < n_fp; ++ph)
      rec[ph] = ph < MAX_FRAME_PHASES ? __double2ll_rn((double)clk[ph] * ns_a_clk) : 0;
    rec[n_fp] = __double2ll_rn((double)clk[CLK_WAIT] * ns_a_clk);
    rec[n_fp + 1] = clk[CLK_GT0];
    rec[n_fp + 2] = gt1;
    rec[n_fp + 3] = c1 - clk[CLK_START];
  }
  // carry out, once every unit of every frame is done
  grid_barrier(p.counters, target);
  for_units(n_pre + n_fp, blockIdx.x, [&](const int* J, int tile, int part) {
    carry_unit(c, tile, part, J[J_AUX], true);
  });
}

// the build that ships: no record buffer, no clock read
template <typename WT>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
    whole_cell_kernel(const __grid_constant__ Params p) {
  whole_cell_body<WT, false>(p);
}

// the build a launch with a record buffer runs
template <typename WT>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
    whole_cell_recording(const __grid_constant__ Params p) {
  whole_cell_body<WT, true>(p);
}

}  // namespace

#ifdef DFN_K2_PLANT
// A test build only: the recording build's thread 0 spends `ns` of the global
// timer at the end of each unit of frame phase `stage` (-1: none).
extern "C" int dfn_k2_plant(int stage, long long ns) {
  cudaError_t err = cudaMemcpyToSymbol(k2_plant_stage, &stage, sizeof(stage));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(k2_plant_ns, &ns, sizeof(ns));
  return (int)err;
}
#endif

// Threads a block, which the plan's K groups are sized for.
extern "C" int dfn_whole_cell_threads() { return THREADS; }

template <typename Kernel>
cudaError_t launch_build(Kernel kernel, Params& p, int n_blocks, cudaStream_t stream) {
  int dev = 0, coop = 0, per_sm = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return cudaErrorNotSupported;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK_THREADS,
                                                      SMEM_BYTES);
  if (err != cudaSuccess) return err;
  if (n_blocks > per_sm * n_sm) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3((unsigned)n_blocks),
                                    dim3(BLOCK_THREADS), args, SMEM_BYTES, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the recording build when the launch passes a record buffer, else the one
// that reads no clock
template <typename WT>
cudaError_t launch(Params& p, int n_blocks, cudaStream_t stream) {
  return p.records ? launch_build(whole_cell_recording<WT>, p, n_blocks, stream)
                   : launch_build(whole_cell_kernel<WT>, p, n_blocks, stream);
}

// Launches the kernel cooperatively on `stream` with n_blocks blocks (at most
// one per multiprocessor) for audio [S, n_frames * 480]. carry_in, carry_out
// (11 device pointers, CKEYS order), weights (n_weights device pointers, WKEYS
// order: bfloat16 but imult and convp_b when `bf16`, else all float32), wpack
// (the packed product weights, of the same type) and scalars (alpha, 1 - alpha,
// lsnr_min, lsnr_max, pf_beta, silence_thresh, atten_lim, gate_min,
// gate_max_erb, gate_max_df) are host arrays. table: the plan
// (ops/whole_cell_plan.py), table_ints int32 on the device. scratch:
// [tiles, SCR, 64] floats, zero where never written; counters: 1 + jobs x
// tiles uint32 (the plan's n_counters), zero; records: null (no block reads a
// clock), or n_blocks x (frame phases + 4) int64, every entry written (see
// Params::records). Returns the CUDA error
// (0 on success); cudaErrorCooperativeLaunchTooLarge or cudaErrorNotSupported
// if the card cannot hold the grid.
extern "C" int dfn_whole_cell(const void* audio, void* out, const void* const* carry_in,
                              void* const* carry_out, const void* const* weights, int n_weights,
                              const void* wpack, void* scratch, const void* table, int table_ints,
                              void* counters, void* records, int S, int n_frames, int n_blocks,
                              const float* scalars, int mask_pf, int lsnr_gating,
                              int silence_frames, int bf16, void* stream) {
  if (n_weights != N_WKEYS || S < 1 || n_frames < 0 || n_blocks < 1 || table_ints > TAB_MAX)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.audio = static_cast<const float*>(audio);
  p.out = static_cast<float*>(out);
  for (int i = 0; i < N_CKEYS; ++i) {
    p.cin[i] = static_cast<const float*>(carry_in[i]);
    p.cout[i] = static_cast<float*>(carry_out[i]);
  }
  for (int i = 0; i < N_WKEYS; ++i) p.w[i] = weights[i];
  p.wpack = wpack;
  p.scratch = static_cast<float*>(scratch);
  p.table = static_cast<const int*>(table);
  p.table_ints = table_ints;
  p.counters = static_cast<unsigned int*>(counters);
  p.records = static_cast<long long*>(records);
  p.S = S;
  p.n_frames = n_frames;
  p.alpha = scalars[0]; p.one_minus_alpha = scalars[1];
  p.lsnr_min = scalars[2]; p.lsnr_max = scalars[3];
  p.pf_beta = scalars[4]; p.silence_thresh = scalars[5]; p.atten_lim = scalars[6];
  p.gate_min = scalars[7]; p.gate_max_erb = scalars[8]; p.gate_max_df = scalars[9];
  p.mask_pf = mask_pf; p.lsnr_gating = lsnr_gating; p.silence_frames = silence_frames;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch<__nv_bfloat16>(p, n_blocks, st) : launch<float>(p, n_blocks, st));
}
