// How fast does one thread block per multiprocessor pull 16 KB chunks from L2
// into shared memory? Both kernels of this package stream their operands that
// way, and their designs rest on the answer (about 27 bytes a clock and
// multiprocessor on an H100 80GB HBM3 at 700 W, whether 1 or 132 blocks run,
// whether they read the same chunks or different ones, and whether the data
// was just written by other blocks).
//
// Not part of the package's build. On a machine with the card and the toolkit:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -o l2_copy_bench \
//       deepfilternet_torch/csrc/tools/l2_copy_bench.cu && ./l2_copy_bench
//
// Modes: 0, a 4-stage ring filled by cp.async from every thread; 1, the same
// ring filled by one bulk copy (TMA) a stage; 2, 16-byte loads to registers,
// then stores to shared memory. "same 1": every block reads the same chunks;
// "fresh 1": another kernel rewrites the buffer before each pass.
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
constexpr int THREADS = 256;
constexpr int CHUNK = 16384;  // bytes
constexpr int NSTG = 4;
__device__ __forceinline__ void cp16(void* s, const void* g) {
  unsigned a = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(g));
}
// mode 0: cp.async ring; 1: bulk copy ring (TMA 1D); 2: LDG.128 -> STS
__global__ void __launch_bounds__(THREADS, 1) bench(const float* src, size_t span_bytes, int n_chunks, int mode,
                                                     int same, long long* out, float* sink) {
  extern __shared__ __align__(128) unsigned char sm[];
  __shared__ __align__(8) unsigned long long mbar[NSTG];
  const int tid = threadIdx.x;
  const size_t n_slots = span_bytes / CHUNK;
  auto src_of = [&](int c) {
    size_t slot = same ? (size_t)c % n_slots : ((size_t)c * gridDim.x + blockIdx.x) % n_slots;
    return (const unsigned char*)src + slot * CHUNK;
  };
  if (mode == 1 && tid == 0) {
    for (int i = 0; i < NSTG; ++i) {
      unsigned a = (unsigned)__cvta_generic_to_shared(&mbar[i]);
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(a));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::);
  }
  __syncthreads();
  float acc = 0.f;
  long long t0 = clock64();
  if (mode == 0) {
    auto issue = [&](int st, int c) {
      const unsigned char* g = src_of(c);
      for (int i = tid; i < CHUNK / 16; i += THREADS) cp16(sm + st * CHUNK + i * 16, g + i * 16);
    };
    for (int s = 0; s < NSTG - 1; ++s) { if (s < n_chunks) issue(s, s); asm volatile("cp.async.commit_group;\n"); }
    for (int c = 0; c < n_chunks; ++c) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(NSTG - 2));
      __syncthreads();
      if (c + NSTG - 1 < n_chunks) issue((c + NSTG - 1) % NSTG, c + NSTG - 1);
      asm volatile("cp.async.commit_group;\n");
      acc += ((float*)(sm + (c % NSTG) * CHUNK))[tid];
    }
  } else if (mode == 1) {
    auto issue = [&](int st, int c) {
      if (tid == 0) {
        unsigned b = (unsigned)__cvta_generic_to_shared(&mbar[st]);
        unsigned d = (unsigned)__cvta_generic_to_shared(sm + st * CHUNK);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(CHUNK) : "memory");
        asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                     ::"r"(d), "l"(src_of(c)), "r"(CHUNK), "r"(b) : "memory");
      }
    };
    for (int s = 0; s < NSTG - 1; ++s) if (s < n_chunks) issue(s, s);
    for (int c = 0; c < n_chunks; ++c) {
      unsigned b = (unsigned)__cvta_generic_to_shared(&mbar[c % NSTG]);
      unsigned parity = (c / NSTG) & 1, ok = 0;
      while (!ok) {
        asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(ok) : "r"(b), "r"(parity) : "memory");
      }
      __syncthreads();
      if (c + NSTG - 1 < n_chunks) issue((c + NSTG - 1) % NSTG, c + NSTG - 1);
      acc += ((float*)(sm + (c % NSTG) * CHUNK))[tid];
    }
  } else {
    for (int c = 0; c < n_chunks; ++c) {
      const float4* g = (const float4*)src_of(c);
      float4 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = __ldcg(g + tid + i * THREADS);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) ((float4*)sm)[tid + i * THREADS] = v[i];
      __syncthreads();
      acc += ((float*)sm)[tid];
    }
  }
  long long t1 = clock64();
  if (tid == 0) out[blockIdx.x] = t1 - t0;
  if (acc == 123.456f) sink[0] = acc;
}
__global__ void touch(float* p, size_t n, float v) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n; i += (size_t)gridDim.x * blockDim.x) p[i] = v;
}
int main() {
  int n_sm; cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, 0);
  size_t span = 8u << 20;
  float* src; cudaMalloc(&src, span); cudaMemset(src, 0, span);
  long long* out; cudaMalloc(&out, n_sm * 8); float* sink; cudaMalloc(&sink, 4);
  cudaFuncSetAttribute(bench, cudaFuncAttributeMaxDynamicSharedMemorySize, NSTG * CHUNK);
  long long h[256];
  for (int blocks : {n_sm})
    for (int same : {0, 1})
      for (int mode : {0, 1, 2}) {
        int n_chunks = same ? 15 : 256;
      for (int fresh : {0, 1}) {
        for (int rep = 0; rep < 2; ++rep) {
          if (fresh) touch<<<n_sm, 256>>>(src, span / 4, (float)rep);
          bench<<<blocks, THREADS, NSTG * CHUNK>>>(src, span, n_chunks, mode, same, out, sink);
          cudaError_t e = cudaDeviceSynchronize();
          if (e != cudaSuccess) { printf("error %s\n", cudaGetErrorString(e)); return 1; }
        }
        cudaMemcpy(h, out, blocks * 8, cudaMemcpyDeviceToHost);
        long long mx = 0; for (int i = 0; i < blocks; ++i) mx = h[i] > mx ? h[i] : mx;
        printf("fresh %d blocks %3d same %d mode %d: %.0f cycles a 16KB chunk, %.1f B/clk/SM\n", fresh, blocks, same, mode,
               (double)mx / n_chunks, (double)CHUNK * n_chunks / mx);
      }
      }
  return 0;
}
