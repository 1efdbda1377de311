// Fused z-buffer + perspective-correct attribute interpolation for Hopper.
//
// Replaces both Pallas TPU kernels of happypose_tpu/ops/rasterizer_pallas.py:
//   - _make_kernel_tilemajor (:308-370, with _eval_chunk :197-230,
//     _resolve_chunk :233-243, _pixel_basis :246-254), launched by
//     run_tilemajor (:473-515);
//   - _make_kernel_dense (:257-305), launched by run_dense (:432-471), which
//     exists only for face databases too large for the TPU's 16 MB VMEM.
// One kernel covers both: it streams 64-face chunks through 12 KB of shared
// memory, so any face count fits.
//
// Input (built by happypose_tpu_torch/ops/rasterizer_fused.py::pack_faces):
//   A          [B, n_chunks*64, 3, 16] f32: per face, the (a, b, c)
//              coefficients of 16 rows that are affine in the pixel
//              coordinate: 3 normalized edge functions, 1/z, six attr/z
//              rows, and six constant rows (a = b = 0): the face's 1/z clamp
//              range and its screen bbox (umin, vmin, umax, vmax).
//   chunk_bbox [B, n_chunks, 4] f32: the union of the chunk's face bboxes.
// Output [B, 7, H, W] f32: iz = 1/z of the nearest covering face (0 on
// background) and its six attr*iz values.
//
// Design: one block of 256 threads per (image, 8x32 pixel tile), one thread
// per pixel, so a warp covers one pixel row and the output stores coalesce.
// The block walks the chunks in order. A block-uniform test of the chunk's
// bbox against the tile skips the chunk. Otherwise the block stages the
// chunk's rows in shared memory, shifting the c coefficient to the tile's
// origin (the f32-friendly tile-local coordinates of _eval_chunk's c_adj),
// and each thread walks the 64 faces in index order, keeping its running
// best iz and six attributes in registers. The update is a strict `>` from
// a running best of 0, which gives exactly the Pallas tie rules: the lowest
// face index within a chunk, the earlier chunk across chunks, and iz > 0.
// Attribute rows are evaluated only when a face wins the pixel.
//
// What bounds it on the H100: the per-(pixel, surviving face) edge and depth
// tests — about 4 affine rows, a clamp and 7 compares each — which are FP32
// CUDA-core work. The Pallas kernel fed the same tests to the TPU's matrix
// unit as a 3-deep matmul; that is not tensor-core work here, so the rows
// are evaluated with scalar multiplies and adds. The design cuts the number
// of tests with the chunk-bbox cull over spatially sorted faces, keeps each
// staged chunk in shared memory for all 256 pixels of the tile, and reads
// no global memory in the face loop.
//
// Arithmetic: every row evaluation is written with __fmul_rn/__fadd_rn
// (never contracted into an FMA), and the file is also built with
// --fmad=false, so it rounds exactly like the plain PyTorch version
// (rasterizer_fused.py::raster_fused_reference), which evaluates
// R = (a*pu + b*pv) + ((c + a*tu0) + b*tv0) with the same tile origins.
// Pixels that lie exactly on an edge therefore resolve the same way in both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 64;
constexpr int N_ROWS = 16;         // rows per face
constexpr int N_EVAL = 10;         // affine rows: w0 w1 w2 iz attr*iz x6
constexpr int FACE_STRIDE = 3 * N_ROWS;
constexpr int TILE_W = 32;
constexpr int TILE_H = 8;
constexpr int THREADS = TILE_W * TILE_H;
constexpr int N_OUT = 7;

// row indices of the constant rows
constexpr int R_IZMIN = 10, R_IZMAX = 11, R_UMIN = 12, R_VMIN = 13,
              R_UMAX = 14, R_VMAX = 15;

__device__ __forceinline__ float eval_row(float a, float b, float c_adj,
                                          float pu, float pv) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, pu), __fmul_rn(b, pv)), c_adj);
}

__global__ void __launch_bounds__(THREADS)
raster_fused_kernel(const float* __restrict__ A,
                    const float* __restrict__ chunk_bbox,
                    float* __restrict__ out, int n_chunks, int H, int W,
                    int n_tw) {
  // affine rows of the staged chunk: [row][face]; s_c holds c shifted to
  // the tile origin. Constant rows keep their c as is.
  __shared__ float s_a[N_EVAL][CHUNK];
  __shared__ float s_b[N_EVAL][CHUNK];
  __shared__ float s_c[N_ROWS][CHUNK];

  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int ti = tile / n_tw;
  const int tj = tile - ti * n_tw;
  const int lx = threadIdx.x % TILE_W;
  const int ly = threadIdx.x / TILE_W;
  const float tu0 = (float)(tj * TILE_W);
  const float tv0 = (float)(ti * TILE_H);
  const float pu = (float)lx;
  const float pv = (float)ly;
  const int x = tj * TILE_W + lx;
  const int y = ti * TILE_H + ly;
  const float gu = (float)x;
  const float gv = (float)y;

  const float* Ab = A + (size_t)b * n_chunks * CHUNK * FACE_STRIDE;
  const float* bb = chunk_bbox + (size_t)b * n_chunks * 4;

  float best = 0.0f;
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};

  for (int c = 0; c < n_chunks; ++c) {
    const float umin = bb[c * 4 + 0];
    const float vmin = bb[c * 4 + 1];
    const float umax = bb[c * 4 + 2];
    const float vmax = bb[c * 4 + 3];
    const bool overlap = (umax >= tu0) && (umin <= tu0 + (float)(TILE_W - 1)) &&
                         (vmax >= tv0) && (vmin <= tv0 + (float)(TILE_H - 1));
    if (!overlap) continue;  // block-uniform

    __syncthreads();  // the previous chunk's rows are no longer read
    const float* Ac = Ab + (size_t)c * CHUNK * FACE_STRIDE;
    for (int i = threadIdx.x; i < CHUNK * N_ROWS; i += THREADS) {
      const int k = i / N_ROWS;
      const int r = i - k * N_ROWS;
      const float* f = Ac + k * FACE_STRIDE;
      const float ca = f[r];
      const float cb = f[N_ROWS + r];
      const float cc = f[2 * N_ROWS + r];
      if (r < N_EVAL) {
        s_a[r][k] = ca;
        s_b[r][k] = cb;
        s_c[r][k] = __fadd_rn(__fadd_rn(cc, __fmul_rn(ca, tu0)),
                              __fmul_rn(cb, tv0));
      } else {
        s_c[r][k] = cc;
      }
    }
    __syncthreads();

    for (int k = 0; k < CHUNK; ++k) {
      const float w0 = eval_row(s_a[0][k], s_b[0][k], s_c[0][k], pu, pv);
      const float w1 = eval_row(s_a[1][k], s_b[1][k], s_c[1][k], pu, pv);
      const float w2 = eval_row(s_a[2][k], s_b[2][k], s_c[2][k], pu, pv);
      float iz = eval_row(s_a[3][k], s_b[3][k], s_c[3][k], pu, pv);
      iz = fminf(fmaxf(iz, s_c[R_IZMIN][k]), s_c[R_IZMAX][k]);
      const bool cov = (w0 >= 0.0f) && (w1 >= 0.0f) && (w2 >= 0.0f);
      // per-face bbox mask: sliver faces can pass the edge test far from
      // the triangle through f32 coefficient noise
      const bool inside = (gu >= s_c[R_UMIN][k] - 1.0f) &&
                          (gu <= s_c[R_UMAX][k] + 1.0f) &&
                          (gv >= s_c[R_VMIN][k] - 1.0f) &&
                          (gv <= s_c[R_VMAX][k] + 1.0f);
      const float cand = (cov && inside) ? iz : -1.0f;
      if (cand > best) {
        best = cand;
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          acc[j] = eval_row(s_a[4 + j][k], s_b[4 + j][k], s_c[4 + j][k], pu, pv);
        }
      }
    }
  }

  if (x < W && y < H) {
    const size_t plane = (size_t)H * W;
    float* o = out + (size_t)b * N_OUT * plane + (size_t)y * W + x;
    o[0] = best;
#pragma unroll
    for (int j = 0; j < 6; ++j) o[(j + 1) * plane] = acc[j];
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` of `device`; returns the CUDA error code
// (0 = ok): cudaSetDevice's, else cudaGetLastError() after the launch.
int raster_fused_launch(const void* A, const void* chunk_bbox, void* out,
                        int B, int n_chunks, int H, int W, int device,
                        void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n_th = (H + TILE_H - 1) / TILE_H;
  const int n_tw = (W + TILE_W - 1) / TILE_W;
  const dim3 grid(n_th * n_tw, B);
  raster_fused_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)A, (const float*)chunk_bbox, (float*)out, n_chunks, H, W,
      n_tw);
  return (int)cudaGetLastError();
}

const char* raster_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
