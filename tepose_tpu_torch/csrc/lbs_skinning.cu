// Linear-blend skinning for the SMPL forward, fp32, for Hopper (sm_90a).
//
// Replaces tepose_tpu/ops/lbs_pallas.py::lbs_skinning_pallas and its body
// _skin_kernel (the Pallas TPU kernel, pl.pallas_call at lbs_pallas.py:76).
// It computes, for every sample b and vertex v,
//
//   T         = sum_j W[v, j] * A[b, j]        (top 3 rows of a 4x4)
//   out[b, v] = T[:, :3] @ v_posed[b, v] + T[:, 3]
//
// and, like the TPU kernel, never writes the (B, V, 4, 4) per-vertex
// transform to device memory.
//
// What bounds it at the eval batch of B = 256, V = 6890, J = 24:
//   * device memory: v_posed in, 21 MB, and verts out, 21 MB;
//   * W^T is 661 KB and stays in L2, but the grid reads it once per sample;
//   * about 600 flops per vertex (288 FMAs to blend, 12 to apply), about
//     1 GFLOP in all.
// 42 MB at 3.35 TB/s is about 13 us and 1 GFLOP at 67 TFLOP/s fp32 about
// 16 us, so the kernel sits near the balance point. Tiling W across several
// samples per block (W reuse from registers) and fusing the pose-corrective
// add are later work; this first version is the simple, exact one.
//
// Design (the TPU layout is not carried over: the Pallas kernel padded V to
// 7168 and went component-major only to fill (8, 128) lanes):
//   * grid (ceil(V / 256), B), one thread per output vertex; the ragged last
//     block is masked;
//   * each block stages the top three rows of its sample's J transforms
//     (J x 12 floats) in shared memory; every thread of a warp reads the same
//     word, which shared memory broadcasts;
//   * W is passed transposed, (J, V), so neighbouring threads read
//     neighbouring addresses for each joint;
//   * v_posed is read as (B, V, 3) directly and verts written as (B, V, 3).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxJoints = 32;

__global__ void __launch_bounds__(kThreads)
lbs_skin_kernel(const float* __restrict__ wT, const float* __restrict__ A,
                const float* __restrict__ v, float* __restrict__ out,
                int V, int J) {
  __shared__ float s_tf[kMaxJoints * 12];

  const int b = blockIdx.y;
  const float* A_b = A + static_cast<size_t>(b) * J * 16;
  for (int i = threadIdx.x; i < J * 12; i += blockDim.x) {
    // rows 0..2 of joint j's row-major 4x4 are its first 12 floats
    s_tf[i] = A_b[(i / 12) * 16 + (i % 12)];
  }
  __syncthreads();

  const int vtx = blockIdx.x * blockDim.x + threadIdx.x;
  if (vtx >= V) return;

  float t[12];
#pragma unroll
  for (int r = 0; r < 12; ++r) t[r] = 0.0f;
  for (int j = 0; j < J; ++j) {
    const float w = wT[static_cast<size_t>(j) * V + vtx];
#pragma unroll
    for (int r = 0; r < 12; ++r) t[r] = fmaf(w, s_tf[j * 12 + r], t[r]);
  }

  const size_t base = (static_cast<size_t>(b) * V + vtx) * 3;
  const float x = v[base + 0], y = v[base + 1], z = v[base + 2];
  out[base + 0] = t[0] * x + t[1] * y + t[2] * z + t[3];
  out[base + 1] = t[4] * x + t[5] * y + t[6] * z + t[7];
  out[base + 2] = t[8] * x + t[9] * y + t[10] * z + t[11];
}

}  // namespace

extern "C" {

// wT (J, V), A (B, J, 4, 4), v (B, V, 3), out (B, V, 3): contiguous fp32 on
// one device; the caller checks shapes, 1 <= J <= 32 and B <= 65535.
// Launches on `stream` and returns cudaGetLastError() after the launch
// (0 on success). It does not synchronise.
int tepose_lbs_skin_f32(const float* wT, const float* A, const float* v,
                        float* out, int B, int V, int J, void* stream) {
  // This library carries its own CUDA runtime, whose current device is not
  // the caller's: make it the device that holds the output.
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(attr.device);
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid((V + kThreads - 1) / kThreads, B);
  lbs_skin_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      wT, A, v, out, V, J);
  return static_cast<int>(cudaGetLastError());
}

const char* tepose_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
