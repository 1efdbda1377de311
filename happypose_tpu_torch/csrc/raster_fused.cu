// Fused z-buffer + perspective-correct attribute interpolation for Hopper.
//
// Replaces both Pallas TPU kernels of happypose_tpu/ops/rasterizer_pallas.py:
//   - _make_kernel_tilemajor (:308-370, with _eval_chunk :197-230,
//     _resolve_chunk :233-243, _pixel_basis :246-254), launched by
//     run_tilemajor (:473-515);
//   - _make_kernel_dense (:257-305), launched by run_dense (:432-471), which
//     exists only for face databases too large for the TPU's 16 MB VMEM.
// One set of kernels covers both: faces stream through 10 KB of shared
// memory in groups of 64, so any face count fits. There is no backward
// kernel there, so none here.
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
// The bound. Each input byte read once and each output byte written once
// over the card's 3.35 TB/s, against the tests the inputs need (about 30
// float32 operations for each face and each pixel inside its bbox +-1 px,
// the pixels at which `inside` below can accept it) over 67 TFLOP/s. The
// bytes bound it at ~1.5k and at ~16k faces an image: small faces need few
// tests. What a kernel actually pays is the (pixel, face) tests it cannot
// avoid at the grain of a tile and a strip, CUDA-core work that runs at a
// fraction of that peak, so the design is about testing fewer pairs,
// keeping the SMs equally busy and feeding each test from few
// shared-memory loads.
//
// Design, three kernels on one stream (raster_fused_launch):
//
// 1. bin_kernel: one warp per (image, tile). The lanes test the chunk
//    bboxes against the tile, 32 at a time; for each chunk that reaches it
//    (lowest first) they test its 64 face bboxes, read from the faces'
//    constant rows (the loads of four chunks are started before the first is
//    tested: they are scattered, 16 bytes of each face's 192, and a warp
//    that waited for each chunk in turn was bound by their latency), and
//    compact the survivors with ballots, so a tile's list is in ascending
//    packed order by construction. The warp counts and keeps
//    up to 512 indices in shared memory, takes room for exactly the count
//    from a pool with one atomicAdd and copies them out; only a longer list
//    is found again in a second walk over the same chunks. A tile whose
//    list does not fit the pool is marked "unlisted" and the raster kernel
//    walks all faces for it: slower, never lossy. `inside` below accepts a
//    face up to 1 px outside its bbox, so both bbox tests take that margin:
//    a face is never missing from the list of a tile in which it can win a
//    pixel. Tiles with an empty list are background: the warp writes their
//    zeros and they never reach the raster kernel. Every other tile gets a
//    place in a bucket by list length (steps of 16 faces).
// 2. order_kernel: turns (bucket, place) into a position in one queue,
//    longest lists first.
// 3. raster_kernel: block i takes queue[i]. The hardware hands blocks to the
//    SMs in index order as room frees up, so it is the queue's consumer:
//    long tiles start first and short ones fill in behind them. Splitting a
//    long list across blocks (and merging by iz and order) is left out: see
//    PERF.md for what the tail costs.
//    A block is the 8x32 tile in strips of PIX rows, one warp per strip, one
//    thread per pixel column: a thread keeps PIX pixels (one column of its
//    strip) in registers, so a warp's stores are 128-byte rows. PIX = 4
//    (2 warps a tile) does the fewest shared-memory loads for each test and
//    is fastest when the tiles fill the card; a launch of few tiles ends
//    when its longest lists do, and takes PIX = 1 (8 warps a tile) below
//    FEW_ITEMS (image, tile) items.
//    Faces arrive in groups of 64 through a two-stage ring: each thread
//    copies the 80 bytes the tests need of one face (rows w0 w1 w2 iz and
//    the constants) with five 16-byte cp.async, while the block tests the
//    previous group. When its own copies have landed the thread rewrites
//    its face in place into five 16-byte records, {a, b, c_adj, -} for each
//    tested row (c_adj = c shifted to the tile origin; the spare lanes carry
//    the 1/z clamp range) and the bbox with its 1 px margin, and one
//    __syncthreads() publishes the group. In the face loop the 32 lanes
//    first cull 32 faces at once, each lane one face's bbox against the
//    warp's strip, and a ballot leaves the survivors, walked lowest first
//    (warp-uniform). A survivor's records are read with 128-bit broadcast
//    loads; rows of the strip outside its v-range are skipped
//    (warp-uniform too), and a*pu is
//    shared by the thread's pixels. The loop keeps only the best iz and its
//    list position (a strict `>` from 0: lowest packed index wins ties,
//    iz > 0, exactly the Pallas tie rules). The six attribute rows are read
//    from global memory once, for the face that finally owns the pixel.
//
// Arithmetic: every row is evaluated per pixel as (a*pu + b*pv) + c_adj,
// c_adj = (c + a*tu0) + b*tv0, with __fmul_rn/__fadd_rn (never contracted
// into an FMA; the file is also built with --fmad=false), so it rounds
// exactly like the plain PyTorch version (raster_fused_reference) and
// edge-exact pixels resolve the same way in both. That rules out stepping a
// row incrementally along x, and the tensor cores: a depth-3 product in
// TF32 loses the low bits that decide those pixels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 64;
constexpr int N_ROWS = 16;  // rows per face
constexpr int FACE_STRIDE = 3 * N_ROWS;
constexpr int TILE_W = 32;
constexpr int TILE_H = 8;
constexpr int N_OUT = 7;

constexpr int GROUP = 64;  // faces per stage of the ring (128 was slower)

// The raster block for PIX pixels (rows of the tile) per thread.
template <int PIX>
struct Block {
  static_assert(PIX > 0 && TILE_H % PIX == 0, "PIX must divide the tile height");
  static constexpr int WARPS = TILE_H / PIX;  // strips per tile
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int SLOTS = (GROUP + THREADS - 1) / THREADS;  // faces a thread stages
};
// A launch of few (image, tile) items cannot fill the SMs with 4-row strips
// (2 warps a tile) and ends when its longest tiles do: below FEW_ITEMS a
// tile gets 8 warps of 1-row strips. Measured at 240x320 (300 tiles an
// image) on an NVIDIA H100 80GB HBM3 at 700 W: 1 row won at B = 16 and 32,
// 4 rows at 128 and 288; at B = 64 1 row won by 4% at ~16k faces and 4 rows
// by 13% at ~1.5k faces.
constexpr int FEW_ITEMS = 16384;

constexpr int BIN_WARPS = 8;  // warps per block of bin_kernel
// chunks whose face bboxes a warp of bin_kernel loads before it tests the
// first of them
constexpr int BIN_AHEAD = 4;
// indices a warp of bin_kernel keeps in shared memory from counting to
// filling; a longer list is found again in a second walk
constexpr int BIN_STAGE = 512;

// zeroed scratch, int32 words (rasterizer_fused.py::_N_COUNTERS = 68)
constexpr int N_BUCKETS = 64;
constexpr int BUCKET_STEP = 16;
constexpr int C_POOL_HEAD = N_BUCKETS;  // 64-bit, words 64 and 65
constexpr int C_N_ITEMS = N_BUCKETS + 2;
constexpr int N_COUNTERS = 68;

constexpr unsigned FULL = 0xffffffffu;

// Does a bbox (umin, vmin, umax, vmax) reach the tile at (tu0, tv0), with
// the 1 px margin of `inside`? Any pixel that passes `inside` lies in a tile
// that passes this.
__device__ __forceinline__ bool reaches(float4 bb, float tu0, float tv0) {
  return (tu0 + (float)(TILE_W - 1) >= bb.x - 1.0f) && (tu0 <= bb.z + 1.0f) &&
         (tv0 + (float)(TILE_H - 1) >= bb.y - 1.0f) && (tv0 <= bb.w + 1.0f);
}

__device__ __forceinline__ float4 face_bbox(const float* Ab, int face) {
  return *reinterpret_cast<const float4*>(Ab + (size_t)face * FACE_STRIDE +
                                          2 * N_ROWS + 12);
}

// Walks the chunks whose bbox reaches the tile, lowest first, and calls
// visit(chunk, lo, hi) with the ballots of the two halves of the chunk's
// faces that reach it too. Warp-uniform.
template <typename Visit>
__device__ __forceinline__ void walk_chunks(const float4* cb, const float* Ab,
                                            int n_chunks, int lane, float tu0,
                                            float tv0, Visit visit) {
  for (int c0 = 0; c0 < n_chunks; c0 += 32) {
    const int c = c0 + lane;
    const bool hit = (c < n_chunks) && reaches(cb[c], tu0, tv0);
    unsigned m = __ballot_sync(FULL, hit);
    while (m) {
      int cc[BIN_AHEAD];
      float4 lo[BIN_AHEAD], hi[BIN_AHEAD];
#pragma unroll
      for (int i = 0; i < BIN_AHEAD; ++i) {
        cc[i] = -1;
        if (m) {
          cc[i] = c0 + __ffs(m) - 1;
          m &= m - 1;
          lo[i] = face_bbox(Ab, cc[i] * CHUNK + lane);
          hi[i] = face_bbox(Ab, cc[i] * CHUNK + 32 + lane);
        }
      }
#pragma unroll
      for (int i = 0; i < BIN_AHEAD; ++i) {
        if (cc[i] < 0) break;
        visit(cc[i], __ballot_sync(FULL, reaches(lo[i], tu0, tv0)),
              __ballot_sync(FULL, reaches(hi[i], tu0, tv0)));
      }
    }
  }
}

// tile_meta[item] = (list length, offset into the pool or -1 if unlisted,
// bucket, place in the bucket); length 0 = background, already written.
__global__ void __launch_bounds__(32 * BIN_WARPS)
bin_kernel(const float* __restrict__ A, const float* __restrict__ chunk_bbox,
           float* __restrict__ out, int4* __restrict__ tile_meta,
           int* __restrict__ pool, int* __restrict__ counters, int n_items,
           int n_chunks, int H, int W, int n_tw, int n_tiles, int pool_cap) {
  const int lane = threadIdx.x & 31;
  const long long item_ll =
      (long long)blockIdx.x * BIN_WARPS + (threadIdx.x >> 5);
  if (item_ll >= n_items) return;  // warp-uniform
  const int item = (int)item_ll;
  const int b = item / n_tiles;
  const int tile = item - b * n_tiles;
  const int ti = tile / n_tw;
  const int tj = tile - ti * n_tw;
  const float tu0 = (float)(tj * TILE_W);
  const float tv0 = (float)(ti * TILE_H);
  const float4* cb =
      reinterpret_cast<const float4*>(chunk_bbox) + (size_t)b * n_chunks;
  const float* Ab = A + (size_t)b * n_chunks * CHUNK * FACE_STRIDE;

  __shared__ int s_stage[BIN_WARPS][BIN_STAGE];
  int* stage = s_stage[threadIdx.x >> 5];
  const unsigned below = (1u << lane) - 1u;

  int count = 0;
  walk_chunks(cb, Ab, n_chunks, lane, tu0, tv0, [&](int cc, unsigned lo, unsigned hi) {
    const int n_lo = __popc(lo), n_hi = __popc(hi);
    if (count + n_lo + n_hi <= BIN_STAGE) {
      if (lo & (1u << lane)) stage[count + __popc(lo & below)] = cc * CHUNK + lane;
      if (hi & (1u << lane))
        stage[count + n_lo + __popc(hi & below)] = cc * CHUNK + 32 + lane;
    }
    count += n_lo + n_hi;
  });

  if (count == 0) {
    if (lane == 0) tile_meta[item] = make_int4(0, 0, 0, 0);
    if (out != nullptr) {
      const int x = tj * TILE_W + lane;
      const size_t plane = (size_t)H * W;
      float* o = out + (size_t)b * N_OUT * plane;
      for (int r = 0; r < TILE_H; ++r) {
        const int y = ti * TILE_H + r;
        if (x < W && y < H) {
#pragma unroll
          for (int j = 0; j < N_OUT; ++j) o[j * plane + (size_t)y * W + x] = 0.0f;
        }
      }
    }
    return;
  }

  int offset = -1;
  if (lane == 0) {
    const unsigned long long at = atomicAdd(
        reinterpret_cast<unsigned long long*>(counters + C_POOL_HEAD),
        (unsigned long long)count);
    if (at + (unsigned long long)count <= (unsigned long long)pool_cap)
      offset = (int)at;
    int bucket = min(N_BUCKETS - 1, (count + BUCKET_STEP - 1) / BUCKET_STEP);
    if (offset < 0) bucket = N_BUCKETS - 1;  // walks every face: the longest
    const int place = atomicAdd(counters + bucket, 1);
    tile_meta[item] = make_int4(count, offset, bucket, place);
  }
  offset = __shfl_sync(FULL, offset, 0);
  if (offset < 0) return;

  int* list = pool + offset;
  if (count <= BIN_STAGE) {  // the whole list was staged
    __syncwarp();
    for (int i = lane; i < count; i += 32) list[i] = stage[i];
    return;
  }
  int w = 0;
  walk_chunks(cb, Ab, n_chunks, lane, tu0, tv0, [&](int cc, unsigned lo, unsigned hi) {
    if (lo & (1u << lane)) list[w + __popc(lo & below)] = cc * CHUNK + lane;
    w += __popc(lo);
    if (hi & (1u << lane)) list[w + __popc(hi & below)] = cc * CHUNK + 32 + lane;
    w += __popc(hi);
  });
}

__global__ void __launch_bounds__(256)
order_kernel(const int4* __restrict__ tile_meta, int* __restrict__ queue,
             int* __restrict__ counters, int n_items) {
  __shared__ int s_start[N_BUCKETS];
  if (threadIdx.x == 0) {
    int s = 0;
    for (int k = N_BUCKETS - 1; k >= 0; --k) {
      s_start[k] = s;
      s += counters[k];
    }
    if (blockIdx.x == 0) counters[C_N_ITEMS] = s;
  }
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_items) {
    const int4 m = tile_meta[i];
    if (m.x > 0) queue[s_start[m.z] + m.w] = (int)i;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const size_t src = __cvta_generic_to_global(gmem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float eval_row(float a, float b, float c_adj,
                                          float pu, float pv) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, pu), __fmul_rn(b, pv)), c_adj);
}

__device__ __forceinline__ float shift_c(float a, float b, float c, float tu0,
                                         float tv0) {
  return __fadd_rn(__fadd_rn(c, __fmul_rn(a, tu0)), __fmul_rn(b, tv0));
}

// One stage of the ring: five records per face, [record][face].
struct Stage {
  float4 rec[5][GROUP];
};

// Packed index of the face at position p of the tile's list.
__device__ __forceinline__ int list_face(const int* list, int p) {
  return list != nullptr ? list[p] : p;
}

// The faces this thread stages for group g (-1: none).
template <int SLOTS, int THREADS>
__device__ __forceinline__ void load_indices(const int* list, int count, int g,
                                             int (&face)[SLOTS]) {
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int i = threadIdx.x + s * THREADS;
    const int p = g * GROUP + i;
    face[s] = (i < GROUP && p < count) ? list_face(list, p) : -1;
  }
}

// Start the copies of this thread's faces: a[0:4], b[0:4], c[0:4] (the rows
// w0 w1 w2 iz), c[8:12] (izmin, izmax in its upper half), c[12:16] (bbox).
template <int SLOTS, int THREADS>
__device__ __forceinline__ void start_copies(Stage& st, const float* Ab,
                                             const int (&face)[SLOTS]) {
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    if (face[s] < 0) continue;
    const int i = threadIdx.x + s * THREADS;
    const float* src = Ab + (size_t)face[s] * FACE_STRIDE;
    cp_async16(&st.rec[0][i], src);
    cp_async16(&st.rec[1][i], src + N_ROWS);
    cp_async16(&st.rec[2][i], src + 2 * N_ROWS);
    cp_async16(&st.rec[3][i], src + 2 * N_ROWS + 8);
    cp_async16(&st.rec[4][i], src + 2 * N_ROWS + 12);
  }
}

// Rewrite this thread's landed faces into the records the face loop reads.
template <int SLOTS, int THREADS>
__device__ __forceinline__ void pack_records(Stage& st, const int (&face)[SLOTS],
                                             float tu0, float tv0) {
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    if (face[s] < 0) continue;
    const int i = threadIdx.x + s * THREADS;
    const float4 a = st.rec[0][i];
    const float4 b = st.rec[1][i];
    const float4 c = st.rec[2][i];
    const float4 k = st.rec[3][i];  // (attr c8, attr c9, izmin, izmax)
    const float4 bb = st.rec[4][i];
    st.rec[0][i] = make_float4(a.x, b.x, shift_c(a.x, b.x, c.x, tu0, tv0), k.z);
    st.rec[1][i] = make_float4(a.y, b.y, shift_c(a.y, b.y, c.y, tu0, tv0), k.w);
    st.rec[2][i] = make_float4(a.z, b.z, shift_c(a.z, b.z, c.z, tu0, tv0), 0.0f);
    st.rec[3][i] = make_float4(a.w, b.w, shift_c(a.w, b.w, c.w, tu0, tv0), 0.0f);
    st.rec[4][i] = make_float4(bb.x - 1.0f, bb.y - 1.0f, bb.z + 1.0f, bb.w + 1.0f);
  }
}

// Does a face's bbox (with its margin) miss the strip's pixel box
// (first u, first v, last u, last v)? Written so that a NaN bbox misses
// nothing here and is left to the per-pixel test.
__device__ __forceinline__ bool misses_strip(float4 bb, float4 box) {
  return bb.w < box.y || bb.y > box.w || bb.z < box.x || bb.x > box.z;
}

// One face of the stage against this thread's pixels: pixel j is at
// tile-local (pu, pv0 + j), image (gu, gv0 + j). `p` is the face's list
// position, kept where it wins.
template <int PIX>
__device__ __forceinline__ void test_face(const Stage& st, int k, int p, float pu,
                                          float pv0, float gu, float gv0,
                                          float (&best)[PIX], int (&won)[PIX]) {
  const float4 bb = st.rec[4][k];  // bbox with its margin
  const float4 r0 = st.rec[0][k];  // (a, b, c_adj, izmin) of w0
  const float4 r1 = st.rec[1][k];  // (a, b, c_adj, izmax) of w1
  const float4 r2 = st.rec[2][k];  // w2
  const float4 r3 = st.rec[3][k];  // iz
  const bool in_u = (gu >= bb.x) && (gu <= bb.z);
  const float au0 = __fmul_rn(r0.x, pu);
  const float au1 = __fmul_rn(r1.x, pu);
  const float au2 = __fmul_rn(r2.x, pu);
  const float au3 = __fmul_rn(r3.x, pu);
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    const float gv = gv0 + (float)j;
    const bool in_v = (gv >= bb.y) && (gv <= bb.w);  // warp-uniform
    // rows outside the face's v-range are skipped; a 1-row strip has none
    // (the cull against the strip was the same test)
    if (PIX == 1 || in_v) {
      const float pv = pv0 + (float)j;
      const float w0 = __fadd_rn(__fadd_rn(au0, __fmul_rn(r0.y, pv)), r0.z);
      const float w1 = __fadd_rn(__fadd_rn(au1, __fmul_rn(r1.y, pv)), r1.z);
      const float w2 = __fadd_rn(__fadd_rn(au2, __fmul_rn(r2.y, pv)), r2.z);
      float iz = __fadd_rn(__fadd_rn(au3, __fmul_rn(r3.y, pv)), r3.z);
      iz = fminf(fmaxf(iz, r0.w), r1.w);
      const bool cov = (w0 >= 0.0f) && (w1 >= 0.0f) && (w2 >= 0.0f);
      // per-face bbox mask: sliver faces can pass the edge test far from
      // the triangle through f32 coefficient noise
      const float cand = (cov && in_u && in_v) ? iz : -1.0f;
      if (cand > best[j]) {
        best[j] = cand;
        won[j] = p;
      }
    }
  }
}

template <int PIX>
__global__ void __launch_bounds__(Block<PIX>::THREADS)
raster_kernel(const float* __restrict__ A, const int4* __restrict__ tile_meta,
              const int* __restrict__ pool, const int* __restrict__ queue,
              const int* __restrict__ counters, float* __restrict__ out,
              int n_chunks, int H, int W, int n_tw, int n_tiles) {
  constexpr int THREADS = Block<PIX>::THREADS;
  constexpr int SLOTS = Block<PIX>::SLOTS;
  __shared__ Stage s_ring[2];

  if ((int)blockIdx.x >= counters[C_N_ITEMS]) return;
  const int item = queue[blockIdx.x];
  const int4 meta = tile_meta[item];
  const int b = item / n_tiles;
  const int tile = item - b * n_tiles;
  const int ti = tile / n_tw;
  const int tj = tile - ti * n_tw;
  // an unlisted tile walks every face; the bbox test in the loop culls
  const int* list = meta.y >= 0 ? pool + meta.y : nullptr;
  const int count = meta.y >= 0 ? meta.x : n_chunks * CHUNK;
  const int n_groups = (count + GROUP - 1) / GROUP;
  const float* Ab = A + (size_t)b * n_chunks * CHUNK * FACE_STRIDE;

  const int lane = threadIdx.x & 31;
  const int strip = threadIdx.x >> 5;
  const float tu0 = (float)(tj * TILE_W);
  const float tv0 = (float)(ti * TILE_H);
  const float pu = (float)lane;
  const float pv0 = (float)(strip * PIX);  // tile-local row of pixel 0
  const int x = tj * TILE_W + lane;
  const int y0 = ti * TILE_H + strip * PIX;
  const float gu = (float)x;
  const float gv0 = (float)y0;
  const float4 strip_box = make_float4(tu0, gv0, tu0 + (float)(TILE_W - 1),
                                       (float)(y0 + PIX - 1));

  float best[PIX];
  int won[PIX];  // list position of the face that holds the pixel
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    best[j] = 0.0f;
    won[j] = -1;
  }

  int face[SLOTS];       // of the group whose copies are in flight or landed
  int face_next[SLOTS];  // of the group after it
  load_indices<SLOTS, THREADS>(list, count, 0, face);
  start_copies<SLOTS, THREADS>(s_ring[0], Ab, face);
  load_indices<SLOTS, THREADS>(list, count, 1, face_next);

  for (int g = 0; g < n_groups; ++g) {
    Stage& st = s_ring[g & 1];
    cp_async_wait_all();
    pack_records<SLOTS, THREADS>(st, face, tu0, tv0);
    // publishes group g; every thread has also left the loop over group
    // g - 1, so its stage can take the copies of group g + 1
    __syncthreads();
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) face[s] = face_next[s];
    if (g + 1 < n_groups) {
      start_copies<SLOTS, THREADS>(s_ring[(g + 1) & 1], Ab, face);
      load_indices<SLOTS, THREADS>(list, count, g + 2, face_next);
    }

    const int n = min(GROUP, count - g * GROUP);
    // the lanes cull 32 faces at once against the strip; the survivors are
    // tested one by one, lowest first
    for (int k0 = 0; k0 < n; k0 += 32) {
      const int kk = k0 + lane;
      const bool hit = (kk < n) && !misses_strip(st.rec[4][kk], strip_box);
      unsigned m = __ballot_sync(FULL, hit);
      while (m) {
        const int k = k0 + __ffs(m) - 1;
        m &= m - 1;
        test_face<PIX>(st, k, g * GROUP + k, pu, pv0, gu, gv0, best, won);
      }
    }
  }

  // the winner's six attribute rows, from global memory
  const size_t plane = (size_t)H * W;
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    const int y = y0 + j;
    if (x >= W || y >= H) continue;
    float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (won[j] >= 0) {
      const float* f = Ab + (size_t)list_face(list, won[j]) * FACE_STRIDE;
      const float pv = pv0 + (float)j;
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        const float ca = f[4 + r];
        const float cb = f[N_ROWS + 4 + r];
        const float cc = f[2 * N_ROWS + 4 + r];
        acc[r] = eval_row(ca, cb, shift_c(ca, cb, cc, tu0, tv0), pu, pv);
      }
    }
    float* o = out + (size_t)b * N_OUT * plane + (size_t)y * W + x;
    o[0] = best[j];
#pragma unroll
    for (int r = 0; r < 6; ++r) o[(r + 1) * plane] = acc[r];
  }
}

}  // namespace

extern "C" {

// Enqueues the kernels on `stream` of `device`: the binning alone when `out`
// is null, else binning, ordering and rasterization. `scratch` is the
// caller's: int32 words, 16-byte aligned, 68 + 5 * n_items + pool_cap of them
// (n_items = B * tiles an image): the counters (zeroed here), tile_meta
// [n_items][4], the queue [n_items] and the pool. Returns the first CUDA
// error code (0 = ok).
int raster_fused_launch(const void* A, const void* chunk_bbox, void* out,
                        void* scratch, int B, int n_chunks, int H, int W,
                        int pool_cap, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int n_th = (H + TILE_H - 1) / TILE_H;
  const int n_tw = (W + TILE_W - 1) / TILE_W;
  const int n_tiles = n_th * n_tw;
  const int n_items = B * n_tiles;
  int* counters = (int*)scratch;
  int4* tile_meta = (int4*)(counters + N_COUNTERS);
  int* queue = (int*)(tile_meta + n_items);
  int* pool = queue + n_items;

  err = cudaMemsetAsync(counters, 0, N_COUNTERS * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  bin_kernel<<<(n_items + BIN_WARPS - 1) / BIN_WARPS, 32 * BIN_WARPS, 0, stream>>>(
      (const float*)A, (const float*)chunk_bbox, (float*)out, tile_meta, pool,
      counters, n_items, n_chunks, H, W, n_tw, n_tiles, pool_cap);
  err = cudaGetLastError();
  if (err != cudaSuccess || out == nullptr) return (int)err;
  order_kernel<<<(n_items + 255) / 256, 256, 0, stream>>>(tile_meta, queue,
                                                          counters, n_items);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define RF_RASTER(PIX)                                                     \
  raster_kernel<PIX><<<n_items, Block<PIX>::THREADS, 0, stream>>>(         \
      (const float*)A, tile_meta, pool, queue, counters, (float*)out,      \
      n_chunks, H, W, n_tw, n_tiles)
  if (n_items < FEW_ITEMS)
    RF_RASTER(1);
  else
    RF_RASTER(4);
#undef RF_RASTER
  return (int)cudaGetLastError();
}

const char* raster_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
