// Pair binning: the (tile, face) pairs of a frame, listed by tile
// (tpurast_torch/kernels/geometry.py bin_pairs, bin_triangles). Replaces the
// reference's bin_pairs and bin_triangles (tpurast/kernels/geometry.py),
// which are XLA ops: no pallas_call stands behind them. The port's plain
// version expands every slot (tiles_per_face per face, every tile for
// huge_budget faces), keys each with 64 bits and sorts them all.
//
// The contract: every valid face whose tile range meets the grid names the
// tiles of its range, row by row (a face cut by the eye plane: the range of
// its near-plane box, near_box, where the caller gives the clip-space
// corners; geometry.py near_boxes); a face of more than tiles_per_face tiles
// (a huge face) names them only if it is among the first huge_budget huge
// faces in draw order, and the tiles of the others are counted as dropped.
// The pairs are listed by (tile, 8-row y-bucket of the face's top, face)
// (bin_pairs) or by (tile, face) (bin_triangles), offsets holding each
// tile's first pair.
//
// What bounds it: it reads each face's box and valid flag (17 B a face,
// 2.0 MB at 116,224 faces) and writes the live pairs (8 B each) and the
// offsets: about 1-3 us at 3.35 TB/s. So the launches, the gaps between
// them and the latency of each pass's dependent steps are the practical
// floor. The design keeps the work and the bytes to the faces and the live
// pairs (no key for a slot that holds no pair, no general sort) and
// reaches the order by two stable counting passes over small digit ranges:
//
//   1. faces by y-bucket. A face's pairs share its y-bucket, so the faces in
//      (y-bucket, face) order, each expanded into its pairs, give the pairs
//      in (y-bucket, face) order. bin_triangles has no y-bucket: one digit.
//   2. those pairs by tile, stably: (tile, y-bucket, face).
//
// Four launches, each grid sized from the static shapes (the faces, the
// pair buffer's slots), the live counts read on the device:
//
//   face_kernel     a thread a face: its tile range and y-bucket, once, into
//                   a 16-byte record (a cut face's corners read here, and
//                   only a cut face's); each 32 faces' count of huge faces
//                   (a huge face's draw-order rank is the count before it)
//                   and of cut faces that name a tile; zeroes the words the
//                   later passes count into;
//   hist_kernel     each block's pairs per y-bucket; the frame's huge and
//                   cut faces;
//   expand_kernel   each face's pairs, written at their place in (y-bucket,
//                   face) order and counted per (block of pairs, tile);
//   scatter_kernel  each pair to its place in its tile; its first block
//                   writes offsets, counts, overflow and the face counts.
//
// Past kTileDigits tiles the tile pass runs as two stable passes, on the
// low kTileBits bits of the tile and then on the rest (five launches).
//
// A block of hist_kernel and expand_kernel owns a run of consecutive faces,
// a block of scatter_kernel a run of consecutive pairs, with up to 32 warps
// (fewer where the per-warp counters would pass kSums): runs of 1,024 items,
// doubled until at most kMaxBlocks blocks take them all (the faces' count
// on the host, the live pairs' on the device), so that the SMs share the
// work and the (block, digit) counts stay at most kMaxBlocks rows. An
// item's place among those of its digit is what the earlier blocks hold,
// then the block's earlier warps, the warp's earlier rounds (counters in
// shared memory) and the lanes below it with the same digit (one ballot a
// digit bit). Each block reads those of the earlier blocks from the
// (block, digit) counts itself, its threads splitting the blocks between
// them, so no launch waits on a scan in one block. Atomics only count; no
// place depends on the order in which threads run, so the lists are the
// same bits on every run, and a CUDA graph's replay equals the eager call.
//
// The face arithmetic is the plain version's (geometry.py near_boxes,
// _tile_ranges and bin_pairs), one rounding per operation: true divisions by
// the tile size, floor, the clamps in float before the conversion to int,
// which a face reaches only once it is valid and its range meets the grid (a
// NaN or an infinite box converts to nothing).

#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kFaceThreads = 256;               // face_kernel's block
constexpr int kBig = 1024;                      // the most threads of the other kernels' blocks
constexpr int kGroup = 32;                      // faces of one huge count: a warp's round
constexpr int kMinBlockBits = 10;               // a block owns at least 2^10 faces or pairs (block_bits)
constexpr int kMinBlockItems = 1 << kMinBlockBits;
constexpr int kMaxBlocks = 128;                 // the most blocks of hist_kernel, expand_kernel, scatter_kernel
constexpr int kYDigits = 1024;                  // geometry.py YB
constexpr int kTileBits = 11;
constexpr int kTileDigits = 1 << kTileBits;     // digits of one tile pass
constexpr int kSums = 8192;                     // ints of a block's per-warp counters (32 KB)
constexpr int kLaneMax = 16;                    // a face of more pairs is written by its whole warp
constexpr int kBatch = 8;                       // loads a thread has in flight

// Words of the scratch's head: the dropped pairs, the live pairs, the cut
// faces that name a tile and the huge faces.
enum { kDropped, kPairs, kCut, kHuge, kHead = 4 };

// Near-plane boxes: geometry.py EYE_EPS, NEAR_K, NEAR_RATIO, NEAR_MAX,
// NEAR_CLAMP, NEAR_SLOPE, NEAR_PAD.
constexpr float kEyeEps = 1e-20f;
constexpr float kNearK = 0.875f;
constexpr float kNearRatio = 65536.0f;
constexpr float kNearMax = 18446744073709551616.0f;  // 2^64
constexpr float kNearClamp = 1073741824.0f;          // 2^30
constexpr float kNearSlope = 0.00390625f;            // 2^-8
constexpr float kNearPad = 2.0f;

struct Grid {
  int n_faces, tiles_x, tiles_y, tile_w, tile_h, tiles_per_face, huge_budget, ty_base, ydigits, face_block;
  const float* clip;    // (F, 3, 4) clip-space corners, or null: no near-plane boxes
  float width, height;  // the frame's, as the setup's whole-screen box holds them
};

// The items a block owns, of n, as a power of two: kMinBlockItems, doubled
// until at most kMaxBlocks blocks take them all.
__host__ __device__ int block_bits(long long n) {
  int bits = kMinBlockBits;
  while (((n - 1) >> bits) + 1 > kMaxBlocks) ++bits;
  return bits;
}

// The box of a cut face's part on the near side of w = kNearK * z (c: its
// three corners x, y, z, w), into box[4] (geometry.py near_boxes): the
// corners kept and the crossings of the edges, each projected as the setup
// projects a corner, the bounds clamped and widened. Returns false where
// that part is empty (the face names no tile); leaves box as it is (the
// whole screen) where the corners are not tame or a point is not in front.
__device__ bool near_box(const float* c, float half_w, float half_h, float* box) {
  float zmin = c[2], wmax = 0.0f;
  bool tame = true;
  for (int i = 0; i < 12; ++i) tame = tame && fabsf(c[i]) <= kNearMax;
  for (int i = 0; i < 3; ++i) {
    zmin = fminf(zmin, c[4 * i + 2]);
    wmax = fmaxf(wmax, fabsf(c[4 * i + 3]));
  }
  if (!tame || !(zmin > 0.0f) || !(wmax <= zmin * kNearRatio)) return true;
  float d[3];
  for (int i = 0; i < 3; ++i) d[i] = c[4 * i + 3] - c[4 * i + 2] * kNearK;
  float lo_x = INFINITY, lo_y = INFINITY, hi_x = -INFINITY, hi_y = -INFINITY;
  bool any = false;
  for (int k = 0; k < 6; ++k) {  // corner i, then the crossing of edge i (corner i to i + 1)
    const int i = k % 3, j = (i + 1) % 3;
    const bool crossing = k >= 3;
    if (crossing ? (d[i] >= 0.0f) == (d[j] >= 0.0f) : !(d[i] >= 0.0f)) continue;
    float x = c[4 * i], y = c[4 * i + 1], w = c[4 * i + 3];
    if (crossing) {
      const float t = d[i] / (d[i] - d[j]);
      x = x + t * (c[4 * j] - x);
      y = y + t * (c[4 * j + 1] - y);
      w = w + t * (c[4 * j + 3] - w);
    }
    if (!(w > 0.0f)) return true;
    const float sx = fminf(fmaxf((x + w) * half_w / w, -kNearClamp), kNearClamp);
    const float sy = fminf(fmaxf((w - y) * half_h / w, -kNearClamp), kNearClamp);
    lo_x = sx < lo_x ? sx : lo_x;
    lo_y = sy < lo_y ? sy : lo_y;
    hi_x = sx > hi_x ? sx : hi_x;
    hi_y = sy > hi_y ? sy : hi_y;
    any = true;
  }
  if (!any) return false;
  box[0] = lo_x - fabsf(lo_x) * kNearSlope - kNearPad;
  box[1] = lo_y - fabsf(lo_y) * kNearSlope - kNearPad;
  box[2] = hi_x + fabsf(hi_x) * kNearSlope + kNearPad;
  box[3] = hi_y + fabsf(hi_y) * kNearSlope + kNearPad;
  return true;
}

// A face's record (face_kernel): x its first tile, y its range's width in
// tiles, z its tile count (0: no tile), w its y-bucket. *cut: the face is
// valid, its setup box the whole screen and a corner at w <= kEyeEps (read
// only where the box is the whole screen).
__device__ int4 record_of(const float* aabb, const unsigned char* valid, int f, const Grid& g, bool* cut) {
  const int4 none{0, 1, 0, 0};
  *cut = false;
  if (f >= g.n_faces || !valid[f]) return none;
  const float* a = aabb + 4LL * f;
  float b[4] = {a[0], a[1], a[2], a[3]};
  if (g.clip != nullptr && b[0] == 0.0f && b[1] == 0.0f && b[2] == g.width && b[3] == g.height) {
    const float* c = g.clip + 12LL * f;
    *cut = !(c[3] > kEyeEps && c[7] > kEyeEps && c[11] > kEyeEps);
    if (*cut && !near_box(c, g.width * 0.5f, g.height * 0.5f, b)) return none;
  }
  const float tw = (float)g.tile_w, th = (float)g.tile_h, base = (float)g.ty_base;
  const float bx0 = floorf(b[0] / tw), by0 = floorf(b[1] / th) - base;
  const float bx1 = floorf(b[2] / tw), by1 = floorf(b[3] / th) - base;
  if (!(bx1 >= 0.0f && by1 >= 0.0f && bx0 < (float)g.tiles_x && by0 < (float)g.tiles_y)) return none;
  const float mx = (float)(g.tiles_x - 1), my = (float)(g.tiles_y - 1);
  const int tx0 = (int)fminf(fmaxf(bx0, 0.0f), mx), ty0 = (int)fminf(fmaxf(by0, 0.0f), my);
  const int tx1 = (int)fminf(fmaxf(bx1, 0.0f), mx), ty1 = (int)fminf(fmaxf(by1, 0.0f), my);
  if (tx1 < tx0 || ty1 < ty0) return none;  // an inverted box names no tile
  int y = 0;
  if (g.ydigits > 1) {
    // clamp(floor(y / 8), 0, YB - 1); a face that meets the grid lies above
    // its last row, so its bucket is under ydigits (layout).
    y = min((int)fminf(fmaxf(floorf(b[1] * 0.125f), 0.0f), (float)(kYDigits - 1)), g.ydigits - 1);
  }
  return int4{ty0 * g.tiles_x + tx0, tx1 - tx0 + 1, (tx1 - tx0 + 1) * (ty1 - ty0 + 1), y};
}

// Tile j of a face's range, row by row (geometry.py _expand_pairs).
__device__ int tile_of(const int4& rec, int j, int tiles_x) { return rec.x + j / rec.y * tiles_x + j % rec.y; }

// Bits of the digits below n.
__device__ int bits_for(int n) {
  int b = 0;
  while ((1 << b) < n) ++b;
  return b;
}

// The lanes of the calling warp whose digit d equals the caller's, as bits
// (d under 2^bits, or -1 for none: those match each other); one ballot a
// bit. All 32 lanes must call.
__device__ unsigned peers_of(int d, int bits) {
  const bool live = d >= 0;
  const unsigned lv = warp_ballot(live);
  unsigned m = live ? lv : ~lv;
  for (int b = 0; b < bits; ++b) {
    const bool on = live && ((d >> b) & 1);
    const unsigned v = warp_ballot(on);
    m &= on ? v : ~v;
  }
  return m;
}

// The inclusive prefix of v over the lanes of the calling warp. All 32
// lanes must call.
__device__ int warp_inclusive(int v) {
  const int lane = threadIdx.x & 31;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = warp_shfl_i(v, lane >= d ? lane - d : lane);
    if (lane >= d) v += u;
  }
  return v;
}

// The exclusive prefix of v over the block's threads; *total gets the sum.
__device__ int block_exclusive(int v, int* total) {
  __shared__ int warp_first[33];  // each warp's first, then the sum
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int x = warp_inclusive(v);
  if (lane == 31) warp_first[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int s = lane < warps ? warp_first[lane] : 0;
    const int y = warp_inclusive(s);
    if (lane < warps) warp_first[lane] = y - s;
    if (lane == 31) warp_first[32] = y;
  }
  __syncthreads();
  const int before = warp_first[warp] + x - v;
  *total = warp_first[32];
  __syncthreads();
  return before;
}

// a[0, n) replaced by its exclusive prefix sums, each thread taking a run of
// consecutive entries; returns the sum.
__device__ int block_scan(int* a, long long n) {
  const long long per = (n + blockDim.x - 1) / blockDim.x;
  const long long lo = min(n, (long long)threadIdx.x * per), hi = min(n, lo + per);
  int s = 0;
  for (long long i = lo; i < hi; ++i) s += a[i];
  int total;
  int run = block_exclusive(s, &total);
  for (long long i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
  return total;
}

// For block `self` of a launch that counted m[b * digits + d] (digit d of
// block b < blocks): first[d] (shared) = the items before block self's of
// digit d in (digit, block) order, and, where totals is given (shared),
// totals[d] = the items of the digits before d. Returns the sum of m. The
// block's threads split the blocks between them, digit by digit, so that
// each has few loads, all in flight at once; part (shared) holds
// 2 * max(blockDim.x, digits) ints.
__device__ int digit_bases(const int* m, int digits, int blocks, int self, int* first, int* totals, int* part) {
  const int split = max(1, (int)blockDim.x / digits), items = split * digits, t = threadIdx.x;
  for (int w = t; w < items; w += blockDim.x) {
    const int d = w % digits, g = w / digits;
    int all = 0, before = 0;
    for (int b0 = g; b0 < blocks; b0 += kBatch * split) {
      int v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int b = b0 + u * split;
        v[u] = b < blocks ? m[(long long)b * digits + d] : 0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        all += v[u];
        before += b0 + u * split < self ? v[u] : 0;
      }
    }
    part[w] = all;
    part[items + w] = before;
  }
  __syncthreads();
  for (int d = t; d < digits; d += blockDim.x) {  // column d of part is this thread's alone
    int all = 0, before = 0;
    for (int g = 0; g < split; ++g) {
      all += part[g * digits + d];
      before += part[items + g * digits + d];
    }
    first[d] = all;
    part[items + d] = before;
  }
  __syncthreads();
  const int sum = block_scan(first, digits);  // each digit's sum into its first item
  for (int d = t; d < digits; d += blockDim.x) {
    if (totals != nullptr) totals[d] = first[d];
    first[d] += part[items + d];
  }
  __syncthreads();
  return sum;
}

// The huge faces before each warp of the block, into base[warp]: the blocks
// own `groups` groups of kGroup faces each, their warps `rounds` each, in
// order.
__device__ void huge_before(const int* group_huge, int groups, int rounds, int* base, int* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int first = blockIdx.x * groups;
  int s = 0;
  for (int i0 = 0; i0 < first; i0 += kBatch * blockDim.x) {
    int v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * blockDim.x + threadIdx.x;
      v[u] = i < first ? group_huge[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) s += v[u];
  }
  s = warp_add_i(s);
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    int before = 0;
    for (int w = 0; w < warps; ++w) before += part[w];
    int own = 0;
    if (lane < warps) {
      for (int r = 0; r < rounds; ++r) own += group_huge[first + lane * rounds + r];
    }
    int x = own;  // inclusive scan over the lanes
    for (int d = 1; d < 32; d <<= 1) {
      const int u = warp_shfl_i(x, lane >= d ? lane - d : lane);
      if (lane >= d) x += u;
    }
    if (lane < warps) base[lane] = before + x - own;
  }
  __syncthreads();
}

// The contract's offsets (first[t]: the first pair of tile t, clamped to
// the pair buffer's capacity), counts and overflow (dropped pairs plus those
// past the capacity), and where asked the face counts (cut, huge).
struct Out {
  int *offsets, *counts, *overflow, *faces;
  int capacity;
};

__device__ void write_offsets(const int* first, int tiles, int pairs, const int* head, const Out& out) {
  for (int t = threadIdx.x; t <= tiles; t += blockDim.x) {
    const int a = min(t < tiles ? first[t] : pairs, out.capacity);
    out.offsets[t] = a;
    if (t < tiles) out.counts[t] = min(t + 1 < tiles ? first[t + 1] : pairs, out.capacity) - a;
  }
  if (threadIdx.x == 0) {
    *out.overflow = (int)((unsigned)head[kDropped] + (unsigned)max(pairs - out.capacity, 0));
    if (out.faces != nullptr) {
      out.faces[0] = head[kCut];
      out.faces[1] = head[kHuge];
    }
  }
}

__global__ void __launch_bounds__(kFaceThreads) face_kernel(const float* aabb, const unsigned char* valid, Grid g,
                                                            int4* rec, int* group_huge, int* group_cut, int* zero,
                                                            long long n_zero, int* zero_out, long long n_zero_out) {
  const int f = blockIdx.x * kFaceThreads + threadIdx.x;
  bool cut;
  const int4 r = record_of(aabb, valid, f, g, &cut);
  rec[f] = r;
  const unsigned huge = warp_ballot(r.z > g.tiles_per_face);
  const unsigned named_cut = warp_ballot(cut && r.z > 0);
  if ((threadIdx.x & 31) == 0) {
    group_huge[f / kGroup] = __popc(huge);
    group_cut[f / kGroup] = __popc(named_cut);
  }
  const long long stride = (long long)gridDim.x * kFaceThreads;
  for (long long i = f; i < n_zero; i += stride) zero[i] = 0;
  for (long long i = f; i < n_zero_out; i += stride) zero_out[i] = 0;
}

// The pairs a face names: all of its tiles, unless it is huge and past the
// budget in draw order (rank: the huge faces before it).
__device__ int pairs_of(const int4& r, bool huge, int rank, const Grid& g) {
  return !huge || rank < g.huge_budget ? r.z : 0;
}

__global__ void __launch_bounds__(kBig) hist_kernel(const int4* rec, Grid g, const int* group_huge,
                                                    const int* group_cut, int* ysum, int* head) {
  __shared__ int hist[kYDigits];
  __shared__ int base[32], part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, groups = g.face_block / kGroup;
  const int rounds = groups / (blockDim.x >> 5);
  const unsigned below = (1u << lane) - 1u;
  for (int d = threadIdx.x; d < g.ydigits; d += blockDim.x) hist[d] = 0;
  huge_before(group_huge, groups, rounds, base, part);
  const int f0 = blockIdx.x * g.face_block + warp * rounds * kGroup;
  int rank = base[warp];
  unsigned dropped = 0;
  int4 next = rec[f0 + lane];
  for (int r = 0; r < rounds; ++r) {
    const int4 rc = next;
    if (r + 1 < rounds) next = rec[f0 + (r + 1) * kGroup + lane];
    const bool huge = rc.z > g.tiles_per_face;
    const unsigned hm = warp_ballot(huge);
    const int c = pairs_of(rc, huge, rank + __popc(hm & below), g);
    rank += __popc(hm);
    if (huge && c == 0) dropped += (unsigned)rc.z;
    if (c > 0) atomicAdd(&hist[rc.w], c);
  }
  dropped = (unsigned)warp_add_i((int)dropped);
  if (lane == 0 && dropped != 0) atomicAdd(&head[kDropped], (int)dropped);
  int cuts = 0;  // of the warp's groups
  for (int r = lane; r < rounds; r += 32) cuts += group_cut[f0 / kGroup + r];
  cuts = warp_add_i(cuts);
  if (lane == 0 && cuts != 0) atomicAdd(&head[kCut], cuts);
  if (lane == 0 && rank != base[warp]) atomicAdd(&head[kHuge], rank - base[warp]);
  __syncthreads();
  for (int d = threadIdx.x; d < g.ydigits; d += blockDim.x) ysum[blockIdx.x * g.ydigits + d] = hist[d];
}

// Where a pass puts its pairs: tiles and faces, and the counts per (block
// of 2^block_bits pairs, digit) of the next pass (digit = (tile >> shift) &
// mask, digits of them).
struct Pairs {
  int *tiles, *faces, *hist;
  int shift, mask, digits, block_bits;
};

__device__ void put_pair(const Pairs& p, int at, int tile, int face, int* tile_total) {
  p.tiles[at] = tile;
  p.faces[at] = face;
  atomicAdd(&p.hist[(long long)(at >> p.block_bits) * p.digits + ((tile >> p.shift) & p.mask)], 1);
  if (tile_total != nullptr) atomicAdd(&tile_total[tile], 1);
}

__global__ void __launch_bounds__(kBig) expand_kernel(const int4* rec, Grid g, const int* group_huge,
                                                      const int* ysum, Pairs p, int* tile_total, int* head) {
  __shared__ int sums[kSums];  // a warp's pairs, then its first pair, per y-bucket
  __shared__ int first[kYDigits];
  __shared__ int base[32], part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int groups = g.face_block / kGroup, rounds = groups / warps;
  const unsigned below = (1u << lane) - 1u;
  const int ny = g.ydigits, ybits = bits_for(ny);
  int* mine = sums + warp * ny;
  const int pairs = digit_bases(ysum, ny, gridDim.x, blockIdx.x, first, nullptr, sums);
  if (blockIdx.x == 0 && threadIdx.x == 0) head[kPairs] = pairs;
  p.block_bits = block_bits(pairs);
  for (int i = threadIdx.x; i < warps * ny; i += blockDim.x) sums[i] = 0;
  huge_before(group_huge, groups, rounds, base, part);
  const int f0 = blockIdx.x * g.face_block + warp * rounds * kGroup;
  int rank = base[warp];
  int4 next = rec[f0 + lane];
  for (int r = 0; r < rounds; ++r) {
    const int4 rc = next;
    if (r + 1 < rounds) next = rec[f0 + (r + 1) * kGroup + lane];
    const bool huge = rc.z > g.tiles_per_face;
    const unsigned hm = warp_ballot(huge);
    const int c = pairs_of(rc, huge, rank + __popc(hm & below), g);
    rank += __popc(hm);
    if (c > 0) atomicAdd(&mine[rc.w], c);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < ny; d += blockDim.x) {
    int run = first[d];
    for (int w = 0; w < warps; ++w) {
      const int v = sums[w * ny + d];
      sums[w * ny + d] = run;
      run += v;
    }
  }
  __syncthreads();
  rank = base[warp];
  next = rec[f0 + lane];
  for (int r = 0; r < rounds; ++r) {
    const int f = f0 + r * kGroup + lane;
    const int4 rc = next;
    if (r + 1 < rounds) next = rec[f + kGroup];
    const bool huge = rc.z > g.tiles_per_face;
    const unsigned hm = warp_ballot(huge);
    const int c = pairs_of(rc, huge, rank + __popc(hm & below), g);
    rank += __popc(hm);
    // The lanes of this face's y-bucket; the pairs of those below it and of
    // them all, added up bit plane by bit plane of the counts.
    const unsigned peers = peers_of(c > 0 ? rc.w : -1, ybits);
    const int cmax = warp_max_i(c);
    int under = 0, group = 0;
    for (int bit = 0; (cmax >> bit) != 0; ++bit) {
      const unsigned set = warp_ballot((c >> bit) & 1);
      under += __popc(set & peers & below) << bit;
      group += __popc(set & peers) << bit;
    }
    const int leader = __ffs(peers) - 1;
    int at = 0;
    if (c > 0 && lane == leader) {
      at = mine[rc.w];
      mine[rc.w] = at + group;
    }
    at = warp_shfl_i(at, leader) + under;
    warp_sync();
    if (c > 0 && c <= kLaneMax) {  // the range's tiles row by row, without a division
      int tile = rc.x, col = 0;
      for (int j = 0; j < c; ++j) {
        put_pair(p, at + j, tile, f, tile_total);
        if (++col == rc.y) {
          col = 0;
          tile += g.tiles_x - rc.y + 1;
        } else {
          ++tile;
        }
      }
    }
    // A face of many pairs (a huge face) is written by the whole warp.
    for (unsigned big = warp_ballot(c > kLaneMax); big != 0; big &= big - 1u) {
      const int src = __ffs(big) - 1;
      const int at0 = warp_shfl_i(at, src), n = warp_shfl_i(c, src), face = warp_shfl_i(f, src);
      const int4 sr{warp_shfl_i(rc.x, src), warp_shfl_i(rc.y, src), 0, 0};
      for (int j = lane; j < n; j += 32) put_pair(p, at0 + j, tile_of(sr, j, g.tiles_x), face, tile_total);
    }
  }
}

// scatter_kernel's pass over pair block b, whose digits' first places are first[].
__device__ void scatter_block(const int* in_tiles, const int* in_faces, int b, int shift, int mask, int digits,
                              int bits, const Pairs& p, int p_capacity, int pairs, unsigned short* cnt,
                              const int* first) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int rounds = (1 << p.block_bits) / 32 / warps;
  const unsigned below = (1u << lane) - 1u;
  unsigned short* mine = cnt + warp * digits;
  for (int i = threadIdx.x; i < warps * digits; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  const int i0 = (b << p.block_bits) + warp * rounds * 32;
  for (int r = 0; r < rounds; ++r) {
    const int i = i0 + r * 32 + lane;
    const int d = i < pairs ? (in_tiles[i] >> shift) & mask : -1;
    const unsigned peers = peers_of(d, bits);
    if (d >= 0 && lane == __ffs(peers) - 1) mine[d] += (unsigned short)__popc(peers);
    warp_sync();
  }
  __syncthreads();
  for (int d = threadIdx.x; d < digits; d += blockDim.x) {
    unsigned run = 0;
    for (int w = 0; w < warps; ++w) {
      const unsigned v = cnt[w * digits + d];
      cnt[w * digits + d] = (unsigned short)run;
      run += v;
    }
  }
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
    const int i = i0 + r * 32 + lane;
    const int t = i < pairs ? in_tiles[i] : -1;
    const int d = t >= 0 ? (t >> shift) & mask : -1;
    const unsigned peers = peers_of(d, bits);
    const int leader = __ffs(peers) - 1;
    int at = 0;
    if (d >= 0 && lane == leader) {
      at = mine[d];
      mine[d] = (unsigned short)(at + __popc(peers));
    }
    at = warp_shfl_i(at, leader);
    warp_sync();
    if (d >= 0) {
      at += first[d] + __popc(peers & below);
      const int face = in_faces[i];
      if (p.hist != nullptr) {
        put_pair(p, at, t, face, nullptr);
      } else {
        if (at < p_capacity) p.faces[at] = face;
        if (p.tiles != nullptr) p.tiles[at] = t;
      }
    }
  }
  __syncthreads();  // the counters are the next pair block's
}

// One stable pass of the tile sort: block b's pairs [b << block_bits, ...)
// of (in_tiles, in_faces), counted per (block, digit) in hist, by digit
// (tile >> shift) & mask to their places in p, whose pair faces past
// p_capacity are not written (bin_triangles' buffer) and whose tiles may be
// null. The first of two passes counts the next pass's digits into p.hist.
// Block 0 of a one-pass sort writes the offsets from the digits' firsts; of
// the last of two passes, from the per-tile totals.
__global__ void __launch_bounds__(kBig) scatter_kernel(const int* in_tiles, const int* in_faces, const int* hist,
                                                       int shift, int mask, int digits, Pairs p, int p_capacity,
                                                       int* tile_total, int tiles, const int* head, Out out) {
  __shared__ unsigned short cnt[2 * kSums];  // a warp's pairs, then its next place, per digit
  __shared__ int first[kTileDigits];
  int* spare = reinterpret_cast<int*>(cnt);  // digit_bases' part, then block 0's digit firsts
  const int pairs = head[kPairs], bits = bits_for(digits);
  p.block_bits = block_bits(pairs);
  const int blocks = pairs > 0 ? ((pairs - 1) >> p.block_bits) + 1 : 0;
  if (blockIdx.x == 0 && out.offsets != nullptr) {
    int* totals = tile_total == nullptr ? spare + 2 * kTileDigits : tile_total;
    if (tile_total == nullptr) {
      digit_bases(hist, digits, blocks, 0, first, totals, spare);
    } else {
      block_scan(tile_total, tiles);
    }
    write_offsets(totals, tiles, pairs, head, out);
    __syncthreads();
  }
  // The blocks walk the pair blocks (the same in every thread of a block);
  // block 0's firsts are there already where it wrote the offsets from them.
  for (int b = blockIdx.x; b < blocks; b += gridDim.x) {
    if (b != 0 || out.offsets == nullptr || tile_total != nullptr) {
      digit_bases(hist, digits, blocks, b, first, nullptr, spare);
    }
    scatter_block(in_tiles, in_faces, b, shift, mask, digits, bits, p, p_capacity, pairs, cnt, first);
  }
}

// The warps of a block whose per-warp counters of `digits` digits take at
// most `room` entries: 32, 16 or 8 (each divides a block's rounds).
int warps_for(int digits, int room) { return digits <= room / 32 ? 32 : digits <= room / 16 ? 16 : 8; }

// The scratch's parts, in ints: the faces' records (first, on the 16-byte
// grid), the groups' huge and cut counts, the y-bucket sums, the head, the tile
// counts of the first and second tile pass and the per-tile totals (zeroed
// each call, one run from the head on), and two pair buffers of the pair
// slots each.
struct Layout {
  Grid g;
  long long slots, records, group_huge, group_cut, ysum, head, hist, hist2, tile_total, a_tiles, a_faces, b_tiles,
      b_faces, total;
  int face_blocks, digits, digits2;
  bool two_pass;
};

Layout layout(int n_faces, int tiles_x, int tiles_y, int tile_w, int tile_h, int tiles_per_face, int huge_budget,
              int ty_base, int by_y) {
  Layout l{};
  const long long tiles = (long long)tiles_x * tiles_y;
  const int budget = std::max(0, std::min(huge_budget, n_faces));
  // A face that meets the grid has floor(y / tile_h) below the slab's last
  // tile row, so its y / 8 lies under that row's end / 8.
  const long long rows_end = ((long long)tiles_y + ty_base) * tile_h;
  const int ydigits = by_y ? (int)std::max(1LL, std::min((long long)kYDigits, (rows_end + 7) / 8)) : 1;
  const int face_block = 1 << block_bits(n_faces);
  l.g = Grid{n_faces, tiles_x, tiles_y, tile_w, tile_h, tiles_per_face, budget, ty_base, ydigits, face_block,
             nullptr, 0.0f, 0.0f};
  l.slots = (long long)tiles_per_face * n_faces + budget * tiles;
  l.face_blocks = (int)std::max(1LL, ((long long)n_faces + face_block - 1) / face_block);
  l.two_pass = tiles > kTileDigits;
  l.digits = l.two_pass ? kTileDigits : (int)tiles;
  l.digits2 = l.two_pass ? (int)((tiles + kTileDigits - 1) >> kTileBits) : 0;
  long long at = 0;
  l.records = at, at += 4LL * l.face_blocks * face_block;
  l.group_huge = at, at += (long long)l.face_blocks * (face_block / kGroup);
  l.group_cut = at, at += (long long)l.face_blocks * (face_block / kGroup);
  l.ysum = at, at += (long long)ydigits * l.face_blocks;
  l.head = at, at += kHead;
  l.hist = at, at += (long long)l.digits * kMaxBlocks;
  l.hist2 = at, at += (long long)l.digits2 * kMaxBlocks;
  l.tile_total = at, at += l.two_pass ? tiles : 0;
  l.a_tiles = at, at += l.slots;
  l.a_faces = at, at += l.slots;
  l.b_tiles = at, at += l.two_pass ? l.slots : 0;
  l.b_faces = at, at += l.two_pass ? l.slots : 0;
  l.total = at;
  return l;
}

bool shapes_ok(const Layout& l) {
  const Grid& g = l.g;
  return g.n_faces >= 0 && g.tiles_x >= 1 && g.tiles_y >= 1 && g.tile_w >= 1 && g.tile_h >= 1 &&
         g.tiles_per_face >= 0 && (long long)g.tiles_x * g.tiles_y < (1LL << 22) && l.slots < INT_MAX &&
         4LL * l.face_blocks * l.g.face_block < INT_MAX;
}

}  // namespace

// Ints of scratch tr_bin needs for these arguments (its own), or -1 where
// it refuses them.
extern "C" long long tr_bin_scratch(int n_faces, int tiles_x, int tiles_y, int tile_w, int tile_h,
                                    int tiles_per_face, int huge_budget, int ty_base, int by_y) {
  const Layout l = layout(n_faces, tiles_x, tiles_y, tile_w, tile_h, tiles_per_face, huge_budget, ty_base, by_y);
  return shapes_ok(l) ? l.total : -1;
}

// Bins n_faces faces (aabb (F, 4) f32, valid (F,) bool) into the tiles_x x
// tiles_y grid of a slab whose first tile row is ty_base. clip: the faces'
// clip-space corners (F, 3, 4) f32 and the frame's width and height, so
// that a face cut by the eye plane is ranged by its near-plane box, or null
// for none. by_y: order each tile's faces by y-bucket, then face
// (bin_pairs), else by face (bin_triangles). pair_faces holds `capacity`
// entries; pair_tiles (the pair slots, as pair_faces) or null: then
// pair_faces past the binned pairs hold 0 and offsets are clamped to the
// capacity (bin_triangles' contract). offsets (T+1,), counts (T,), overflow
// (one int), faces (two ints: the cut faces that name a tile, the huge
// faces) or null. scratch: tr_bin_scratch ints, on the 16-byte grid.
extern "C" int tr_bin(const float* aabb, const unsigned char* valid, const float* clip, int width, int height,
                      int n_faces, int tiles_x, int tiles_y, int tile_w, int tile_h, int tiles_per_face,
                      int huge_budget, int ty_base, int by_y, int capacity, int* pair_faces, int* pair_tiles,
                      int* offsets, int* counts, int* overflow, int* faces, int* scratch, long long scratch_ints,
                      void* stream) {
  Layout l = layout(n_faces, tiles_x, tiles_y, tile_w, tile_h, tiles_per_face, huge_budget, ty_base, by_y);
  if (!shapes_ok(l) || scratch_ints < l.total || capacity < 0 || (uintptr_t)scratch % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  l.g.clip = clip;
  l.g.width = (float)width;
  l.g.height = (float)height;
  const int tiles = tiles_x * tiles_y;
  int* s = scratch;
  int* head = s + l.head;
  int4* rec = reinterpret_cast<int4*>(s + l.records);
  const Out out{offsets, counts, overflow, faces, capacity};
  const Out none{nullptr, nullptr, nullptr, nullptr, capacity};
  const int all = INT_MAX;
  // The live pairs' blocks: at most kMaxBlocks, and at most one a
  // kMinBlockItems of the pair slots.
  const int scatter_blocks =
      (int)std::max(1LL, std::min((long long)kMaxBlocks, (l.slots + kMinBlockItems - 1) / kMinBlockItems));
  TR_LAUNCH(face_kernel, l.face_blocks * (l.g.face_block / kFaceThreads), kFaceThreads, stream, aabb, valid, l.g, rec,
            s + l.group_huge, s + l.group_cut, head, l.a_tiles - l.head, pair_tiles == nullptr ? pair_faces : nullptr,
            pair_tiles == nullptr ? (long long)capacity : 0LL);
  TR_LAUNCH(hist_kernel, l.face_blocks, kBig, stream, rec, l.g, s + l.group_huge, s + l.group_cut, s + l.ysum, head);
  const Pairs a{s + l.a_tiles, s + l.a_faces, s + l.hist, 0, l.two_pass ? kTileDigits - 1 : all, l.digits, 0};
  TR_LAUNCH(expand_kernel, l.face_blocks, 32 * warps_for(l.g.ydigits, kSums), stream, rec, l.g, s + l.group_huge,
            s + l.ysum, a, l.two_pass ? s + l.tile_total : nullptr, head);
  const Pairs final_pairs{pair_tiles, pair_faces, nullptr, 0, 0, 0, 0};
  if (!l.two_pass) {
    TR_LAUNCH(scatter_kernel, scatter_blocks, 32 * warps_for(l.digits, 2 * kSums), stream, s + l.a_tiles,
              s + l.a_faces, s + l.hist, 0, all, l.digits, final_pairs, capacity, nullptr, tiles, head, out);
  } else {
    const Pairs b{s + l.b_tiles, s + l.b_faces, s + l.hist2, kTileBits, all, l.digits2, 0};
    TR_LAUNCH(scatter_kernel, scatter_blocks, 32 * warps_for(l.digits, 2 * kSums), stream, s + l.a_tiles,
              s + l.a_faces, s + l.hist, 0, kTileDigits - 1, l.digits, b, all, nullptr, tiles, head, none);
    TR_LAUNCH(scatter_kernel, scatter_blocks, 32 * warps_for(l.digits2, 2 * kSums), stream, s + l.b_tiles,
              s + l.b_faces, s + l.hist2, kTileBits, all, l.digits2, final_pairs, capacity, s + l.tile_total,
              tiles, head, out);
  }
  return (int)cudaGetLastError();
}
