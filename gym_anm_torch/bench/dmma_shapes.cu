// Throughput of the float64 tensor-core products (mma.sync) on one card, by
// shape: the 8-row m8n8k4 (sm_80) against the 16-row m16n8k4/k8/k16 (sm_90).
// Each warp issues 256 rounds of CH independent accumulator chains; one block
// per multiprocessor of 1..16 warps.  Prints cycles per product per warp and
// the card's float64 rate.  The chord-Newton kernel (csrc/chord_newton.cu)
// takes its 16-row shape from these numbers.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/dmma_shapes gym_anm_torch/bench/dmma_shapes.cu
//   build/dmma_shapes
#include <cuda_runtime.h>
#include <stdio.h>

template <int M, int K>
struct Mma;

template <>
struct Mma<8, 4> {
  static constexpr int kA = 1, kB = 1, kC = 2;
  __device__ static void run(double* d, const double* a, const double* b) {
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
                 : "+d"(d[0]), "+d"(d[1])
                 : "d"(a[0]), "d"(b[0]));
  }
};
template <>
struct Mma<16, 4> {
  static constexpr int kA = 2, kB = 1, kC = 4;
  __device__ static void run(double* d, const double* a, const double* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  }
};
template <>
struct Mma<16, 8> {
  static constexpr int kA = 4, kB = 2, kC = 4;
  __device__ static void run(double* d, const double* a, const double* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  }
};
template <>
struct Mma<16, 16> {
  static constexpr int kA = 8, kB = 4, kC = 4;
  __device__ static void run(double* d, const double* a, const double* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]),
          "d"(b[1]), "d"(b[2]), "d"(b[3]));
  }
};

template <int M, int K, int CH>
__global__ void chains(double* out, long long* cycles, int rounds) {
  using T = Mma<M, K>;
  double a[T::kA], b[T::kB], d[CH][T::kC] = {};
  for (int i = 0; i < T::kA; ++i) a[i] = 1e-3 * threadIdx.x + i;
  for (int i = 0; i < T::kB; ++i) b[i] = 1.0 + i;
  const long long t0 = clock64();
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int c = 0; c < CH; ++c) T::run(d[c], a, b);
  }
  const long long t1 = clock64();
  double s = 0.0;
  for (int c = 0; c < CH; ++c)
    for (int i = 0; i < T::kC; ++i) s += d[c][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (blockIdx.x == 0 && threadIdx.x == 0) *cycles = t1 - t0;
}

template <int M, int K, int CH>
void measure(int warps, int n_sm, double* out, long long* cycles) {
  const int rounds = 256;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  chains<M, K, CH><<<n_sm, 32 * warps>>>(out, cycles, rounds);  // warm-up
  cudaEventRecord(e0);
  chains<M, K, CH><<<n_sm, 32 * warps>>>(out, cycles, rounds);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    printf("m%dn8k%d chains %d warps %2d: %s\n", M, K, CH, warps, cudaGetErrorString(err));
    return;
  }
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, e0, e1);
  long long c = 0;
  cudaMemcpy(&c, cycles, sizeof(c), cudaMemcpyDeviceToHost);
  const double n_mma = static_cast<double>(rounds) * CH;
  const double flop = 2.0 * M * 8 * K * n_mma * warps * n_sm;
  printf("m%dn8k%d chains %d warps/SM %2d: %6.1f cycles per product per warp, %6.2f TFLOP/s\n", M, K, CH, warps,
         c / n_mma, flop / (ms * 1e-3) / 1e12);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
}

int main() {
  int n_sm = 0;
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, 0);
  double* out = nullptr;
  long long* cycles = nullptr;
  cudaMalloc(&out, static_cast<size_t>(n_sm) * 1024 * sizeof(double));
  cudaMalloc(&cycles, sizeof(long long));
  for (int warps : {1, 4, 8, 16}) {
    measure<8, 4, 1>(warps, n_sm, out, cycles);
    measure<8, 4, 4>(warps, n_sm, out, cycles);
    measure<16, 4, 1>(warps, n_sm, out, cycles);
    measure<16, 4, 4>(warps, n_sm, out, cycles);
    if (warps < 16) {  // 16 warps of 4 such chains exceed the register file
      measure<16, 8, 4>(warps, n_sm, out, cycles);
      measure<16, 16, 4>(warps, n_sm, out, cycles);
    }
  }
  cudaFree(out);
  cudaFree(cycles);
  return 0;
}
