// Mask R-CNN's two irregular operations on Hopper: greedy non-maximum
// suppression with a fixed output budget, and RoIAlign at each RoI's own
// pyramid level. Both replace no TPU kernel: the JAX package has no Mask
// R-CNN (its FCOS detector scans its NMS on the host). Wrappers and plain
// PyTorch versions: `ops/nms.py`, `ops/multiscale_roi_align.py`.
//
// NMS. Bound by latency: the greedy scan is sequential in the candidates.
// `nms_mask_kernel` builds the IoU bitmask of the candidates, sorted by score,
// in 64 x 64 tiles (bit j of row i: j comes after i, both valid, one group,
// IoU > threshold); `nms_scan_kernel` runs the scan in one block an image,
// 64 candidates at a time: the block's 64 diagonal words are loaded at once,
// one thread resolves the 64 in shared memory, and the rows of those kept
// are OR-ed into the later words by all threads (shared 64-bit atomics), so
// a kept candidate costs no serial global load. The scan stops at the
// budget. The least time counts the boxes read once and the bitmask written
// once; the scan's syncs set the time.
//
// RoIAlign. Bound by bytes: one thread an output value, its 2 x 2 samples'
// 16 taps read from the RoI's level (torchvision's `roi_align` with
// aligned=False), with neighbouring threads on neighbouring output columns.
// The features of all levels (26 MB at 480x640) stay in L2; the outputs are
// written once. On the pyramid's channel-first layout a warp's taps fall in
// many 32-byte sectors, so L2's traffic, not HBM's, sets the time (PERF.md).
//
// Compiled with --fmad=false (csrc/__init__.py): the arithmetic is the plain
// versions' operation for operation, so the two agree bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NMS_TILE = 64;
constexpr int SCAN_THREADS = 256;

__device__ __forceinline__ bool over_threshold(const float* a, const float* b, float thr) {
  const float left = fmaxf(a[0], b[0]);
  const float top = fmaxf(a[1], b[1]);
  const float right = fminf(a[2], b[2]);
  const float bottom = fminf(a[3], b[3]);
  const float w = fmaxf(right - left, 0.f);
  const float h = fmaxf(bottom - top, 0.f);
  const float inter = w * h;
  const float area_a = (a[2] - a[0]) * (a[3] - a[1]);
  const float area_b = (b[2] - b[0]) * (b[3] - b[1]);
  return inter / (area_a + area_b - inter) > thr;
}

// grid (words, row tiles, images), 64 threads: row i = tile * 64 + thread
__global__ void __launch_bounds__(NMS_TILE)
nms_mask_kernel(const float* __restrict__ boxes, const int* __restrict__ groups,
                const uint8_t* __restrict__ valid, unsigned long long* __restrict__ mask,
                int N, int n_words, float thr) {
  const int col_tile = blockIdx.x, row_tile = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x;
  const int i = row_tile * NMS_TILE + t;
  __shared__ float cb[NMS_TILE * 4];
  __shared__ int cg[NMS_TILE];
  __shared__ uint8_t cv[NMS_TILE];
  const size_t base = (size_t)b * N;
  const int j0 = col_tile * NMS_TILE;
  if (j0 + t < N) {
#pragma unroll
    for (int k = 0; k < 4; ++k) cb[t * 4 + k] = boxes[(base + j0 + t) * 4 + k];
    cg[t] = groups[base + j0 + t];
    cv[t] = valid[base + j0 + t];
  }
  __syncthreads();
  if (i >= N) return;
  unsigned long long bits = 0ull;
  if (col_tile >= row_tile && valid[base + i]) {
    float a[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) a[k] = boxes[(base + i) * 4 + k];
    const int g = groups[base + i];
    const int n = min(NMS_TILE, N - j0);
    for (int jj = 0; jj < n; ++jj) {
      const int j = j0 + jj;
      if (j > i && cv[jj] && cg[jj] == g && over_threshold(a, cb + jj * 4, thr))
        bits |= 1ull << jj;
    }
  }
  mask[(base + i) * n_words + col_tile] = bits;
}

// one block an image; dynamic shared: removed[n_words] (64-bit words)
__global__ void __launch_bounds__(SCAN_THREADS)
nms_scan_kernel(const unsigned long long* __restrict__ mask, const uint8_t* __restrict__ valid,
                int64_t* __restrict__ keep, uint8_t* __restrict__ keep_valid, int N,
                int n_words, int max_out) {
  extern __shared__ unsigned long long removed[];
  __shared__ unsigned long long diag[NMS_TILE];
  __shared__ int kept_rows[NMS_TILE];
  __shared__ int n_kept_block, n_kept;
  const int b = blockIdx.x, t = threadIdx.x;
  const size_t base = (size_t)b * N;
  const unsigned long long* m = mask + base * n_words;
  for (int k = t; k < max_out; k += SCAN_THREADS) {
    keep[(size_t)b * max_out + k] = 0;
    keep_valid[(size_t)b * max_out + k] = 0;
  }
  // an invalid candidate starts removed
  for (int w = t; w < n_words; w += SCAN_THREADS) {
    unsigned long long r = 0ull;
    for (int jj = 0; jj < NMS_TILE; ++jj) {
      const int j = w * NMS_TILE + jj;
      if (j >= N || !valid[base + j]) r |= 1ull << jj;
    }
    removed[w] = r;
  }
  if (t == 0) n_kept = 0;
  __syncthreads();
  for (int w = 0; w < n_words; ++w) {
    if (n_kept >= max_out) break;  // uniform: read after the last sync
    if (t < NMS_TILE) {
      const int i = w * NMS_TILE + t;
      diag[t] = i < N ? m[(size_t)i * n_words + w] : 0ull;
    }
    __syncthreads();
    if (t == 0) {
      unsigned long long word = removed[w];
      int nb = 0, nk = n_kept;
      for (int jj = 0; jj < NMS_TILE && nk < max_out; ++jj) {
        if (!((word >> jj) & 1ull)) {
          const int i = w * NMS_TILE + jj;
          keep[(size_t)b * max_out + nk] = i;
          keep_valid[(size_t)b * max_out + nk] = 1;
          ++nk;
          kept_rows[nb++] = i;
          word |= diag[jj];
        }
      }
      removed[w] = word;
      n_kept_block = nb;
      n_kept = nk;
    }
    __syncthreads();
    const int rest = n_words - w - 1;
    const int pairs = n_kept_block * rest;
    for (int p = t; p < pairs; p += SCAN_THREADS) {
      const int row = kept_rows[p / rest];
      const int ww = w + 1 + p % rest;
      const unsigned long long bits = m[(size_t)row * n_words + ww];
      if (bits) atomicOr(&removed[ww], bits);
    }
    __syncthreads();
  }
}

struct Levels {
  const float* feat[4];
  int H[4], W[4];
  float scale[4];
};

__device__ __forceinline__ float bilinear(const float* f, int H, int W, float y, float x) {
  if (y < -1.0f || y > (float)H || x < -1.0f || x > (float)W) return 0.f;
  if (y <= 0.f) y = 0.f;
  if (x <= 0.f) x = 0.f;
  int y_low = (int)y, x_low = (int)x, y_high, x_high;
  if (y_low >= H - 1) {
    y_high = y_low = H - 1;
    y = (float)y_low;
  } else {
    y_high = y_low + 1;
  }
  if (x_low >= W - 1) {
    x_high = x_low = W - 1;
    x = (float)x_low;
  } else {
    x_high = x_low + 1;
  }
  const float ly = y - (float)y_low, lx = x - (float)x_low;
  const float hy = 1.f - ly, hx = 1.f - lx;
  const float v1 = f[y_low * W + x_low], v2 = f[y_low * W + x_high];
  const float v3 = f[y_high * W + x_low], v4 = f[y_high * W + x_high];
  const float w1 = hy * hx, w2 = hy * lx, w3 = ly * hx, w4 = ly * lx;
  return w1 * v1 + w2 * v2 + w3 * v3 + w4 * v4;
}

// one thread an output value [R, C, P, P]; RoI r reads image r / per_image.
// 32-bit index arithmetic: the wrapper keeps R * C * P * P under 2^31.
__global__ void __launch_bounds__(256)
roi_align_kernel(Levels lv, const float* __restrict__ rois, const int* __restrict__ levels,
                 float* __restrict__ out, int total, int per_image, int C, int P, int S) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int pw = idx % P;
  int rest = idx / P;
  const int ph = rest % P;
  rest /= P;
  const int c = rest % C;
  const int r = rest / C;
  const int l = levels[r];
  const int H = lv.H[l], W = lv.W[l];
  const float scale = lv.scale[l];
  const float* f = lv.feat[l] + ((size_t)(r / per_image) * C + c) * (size_t)H * W;
  const float* roi = rois + (size_t)r * 4;
  const float x1 = roi[0] * scale, y1 = roi[1] * scale;
  const float x2 = roi[2] * scale, y2 = roi[3] * scale;
  const float roi_w = fmaxf(x2 - x1, 1.f), roi_h = fmaxf(y2 - y1, 1.f);
  const float bin_w = roi_w / (float)P, bin_h = roi_h / (float)P;
  float acc = 0.f;
  for (int iy = 0; iy < S; ++iy) {
    const float y = (y1 + (float)ph * bin_h) + (((float)iy + 0.5f) * bin_h) / (float)S;
    for (int ix = 0; ix < S; ++ix) {
      const float x = (x1 + (float)pw * bin_w) + (((float)ix + 0.5f) * bin_w) / (float)S;
      acc = acc + bilinear(f, H, W, y, x);
    }
  }
  out[idx] = acc / (float)(S * S);
}

}  // namespace

extern "C" {

// Enqueues the mask and the scan on `stream` of `device`. boxes [B, N, 4]
// float32 in scan order, groups [B, N] int32, valid [B, N] uint8; `mask` the
// caller's scratch of B * N * ceil(N / 64) 64-bit words; writes keep
// [B, max_out] int64 (positions in scan order, 0 where unused) and
// keep_valid [B, max_out] uint8. Returns the first CUDA error code (0 = ok).
int nms_launch(const void* boxes, const void* groups, const void* valid, void* mask,
               void* keep, void* keep_valid, int B, int N, int max_out, float iou_threshold,
               int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int n_words = (N + NMS_TILE - 1) / NMS_TILE;
  if (B == 0 || max_out == 0) return 0;
  if (N > 0) {
    dim3 grid(n_words, n_words, B);
    nms_mask_kernel<<<grid, NMS_TILE, 0, stream>>>(
        (const float*)boxes, (const int*)groups, (const uint8_t*)valid,
        (unsigned long long*)mask, N, n_words, iou_threshold);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t shared = (size_t)n_words * sizeof(unsigned long long);
  if (shared > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  nms_scan_kernel<<<B, SCAN_THREADS, shared, stream>>>(
      (const unsigned long long*)mask, (const uint8_t*)valid, (int64_t*)keep,
      (uint8_t*)keep_valid, N, n_words, max_out);
  return (int)cudaGetLastError();
}

// Enqueues RoIAlign of R RoIs [R, 4] (x1, y1, x2, y2 in image pixels), RoI r
// of image r / per_image, at level levels[r] (0..n_levels-1) of features
// [B, C, H_l, W_l] float32 scaled by scale_l; out [R, C, P, P], sampling
// S x S a bin. Returns the first CUDA error code (0 = ok).
int roi_align_launch(const void* f0, const void* f1, const void* f2, const void* f3,
                     const int* hw, const float* scales, const void* rois, const void* levels,
                     void* out, int R, int per_image, int C, int P, int S, int device,
                     void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Levels lv;
  const void* feats[4] = {f0, f1, f2, f3};
  for (int l = 0; l < 4; ++l) {
    lv.feat[l] = (const float*)feats[l];
    lv.H[l] = hw[2 * l];
    lv.W[l] = hw[2 * l + 1];
    lv.scale[l] = scales[l];
  }
  const long long total = (long long)R * C * P * P;
  if (total == 0) return 0;
  if (total >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  roi_align_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream_ptr>>>(
      lv, (const float*)rois, (const int*)levels, (float*)out, (int)total, per_image, C, P, S);
  return (int)cudaGetLastError();
}

const char* mask_rcnn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
