// Per-tile texel-window plan.
//
// Replaces tpurast/kernels/sampler.py::_plan_kernel (launched by
// plan_tiles). Plain torch version:
// tpurast_torch/kernels/sampler.py::plan_tiles_plain.
//
// One block per framebuffer tile, 1024 threads x 4 pixels. Each pixel's
// page-coordinate anchor range (bilinear texel plus the probe train's
// extremes, own and parent mip) is computed once, in the reference's f32
// arithmetic, and held in registers as integers. A tile of more than 4096
// px (plan_kernel<true>) goes over its pixels in groups of 4096 at every
// step instead, each pixel's anchors, slots and flags written once to a
// global scratch buffer and read back by the thread that owns the pixel:
// the same covering and the same block-wide minima, so the same table and
// assignment, at the cost of two passes over the tile's scratch a round
// (the shipped 4096-px instantiation keeps everything in registers). A greedy
// banded covering then places up to K2 = 32 windows of WH x WW texels: each
// round seeds at the smallest uncovered anchor row, opens an ALIGN_Y-aligned
// band there, takes the smallest anchor column inside the band, and assigns
// every pixel role whose whole range fits the ALIGN_X-aligned window
// (sampler.py:286-341). Tiles whose pixels do not all fit K2 windows are
// RESIDUAL. Per (chunk of rc rows, slot) the kernel then packs the y and x
// bands of the window that the chunk's pixels touch and their worst probe
// count into one plan word (sampler.py:362-445). The output is the
// reference's table (T, 8, 128) and assign (2, Hp, Wp), value for value,
// and the matched pixels of the RESIDUAL tiles, summed over the frame. On
// this card the sample kernel reads the tile's class from the table and
// nothing else (csrc/sampler.cu); the renderer reports the pixel count.
//
// What bounds it on this card: latency, not bytes. A tile's covering is a
// chain of block-wide minima, two per window, and the horizon tiles need
// the most windows. So a minimum is one redux.sync per warp, one shared
// slot per warp, one barrier, and one more redux.sync over the 32 slots
// (the slots alternate between two buffers, so no second barrier); the plan
// words are not reduced per (chunk, slot) but gathered in one pass: each
// warp folds the roles that share a (chunk, slot) with redux.sync and one
// lane merges them into shared memory with atomicMin / atomicMax, which are
// order-free, so the table is deterministic. Plane 16 is read first and a
// tile without a matched pixel leaves after one barrier. 64 registers a
// thread keep the 1024-thread block resident on an SM. The large path is
// latency-bound too, and more so: each round reads its groups' flags and
// anchors from L2 twice (the groups where the thread has nothing left to
// assign are skipped), so a large tile costs more per pixel.
//
// Integers are exact here: a role that can be assigned (it fits a window)
// has anchors that are either small integral floats (a wrapped texel below
// the mip's size plus its page origin, and an extent below WW) or not
// finite, and integer min, max, floor-mod and comparisons on the former
// give what the plain version's f32 gives. A NaN or infinite anchor on such
// a role (a non-finite u, v, derivative or page origin under a matched
// pixel; inf - inf is NaN, so the fit test lets it through) can place no
// window; where the reference would go on to convert non-finite floats to
// integers, both versions here make the whole tile RESIDUAL with no window
// and no assignment, and a NaN probe count counts as 1 in the chunk's lane.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kPPT = 4;  // pixels per thread
constexpr int kGroupPx = kThreads * kPPT;  // pixels a block holds in registers at once
constexpr int kWarps = kThreads / 32;
constexpr int kWH = 96, kWW = 384, kAlignY = 8, kAlignX = 128;
constexpr int kK2 = 32, kYB = 48, kXB = 128, kNXB = kWW / kXB;
constexpr int kClsWindowed = 0, kClsEmpty = 2, kClsResidual = 3;
constexpr int kChunkNpLane = 120;
constexpr int kRows = 8, kLanes = 128;  // a tile's table
constexpr int kMaxChunks = kRows - 1;
constexpr int kNone = 0x7fffffff;
static_assert(kWarps == 32 && kRows * kLanes == kThreads, "one table word and one warp slot per thread");

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ int floor_mod_i(int a, int b) { return a - floor_div(a, b) * b; }

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

// Block-wide minimum; every thread gets it. Consecutive calls alternate
// between the two rows of part, so a thread that runs ahead into the next
// call cannot overwrite a slot that a slower one has yet to read.
__device__ __forceinline__ int block_min(int v, int (*part)[kWarps], int& turn) {
  int* slots = part[turn];
  turn ^= 1;
  v = warp_min_i(v);
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_min_i(slots[threadIdx.x & 31]);
}

// Calls body(key, mine) once for every distinct key >= 0 among the warp's
// lanes, smallest first; mine says whether the calling lane holds that key.
// All 32 lanes call; body may use warp-wide reductions.
template <class Body>
__device__ __forceinline__ void warp_by_key(int key, Body body) {
  for (;;) {
    const int j = warp_min_i(key >= 0 ? key : kNone);
    if (j == kNone) break;
    const bool mine = key == j;
    body(j, mine);
    if (mine) key = -1;
  }
}

// One axis of sampler.py _probe_extent_anchors.
__device__ __forceinline__ void anchor(float uu, float ww, float dd, float lim, float* lo, float* hi) {
  const float lo_u = floorf((uu - dd) * ww - 0.5f);
  const float hi_u = floorf((uu + dd) * ww - 0.5f);
  const float ww_c = max_nan(ww, 1.0f);
  const float lo_m = floor_mod(lo_u, ww_c);
  const float hi_m = floor_mod(hi_u, ww_c);
  const bool big = ww > lim;
  *lo = big ? lo_m : min_nan(lo_m, hi_m);
  *hi = big ? lo_m + (hi_u - lo_u) : max_nan(lo_m, hi_m);
}

// Whether a[0..3] are all finite (x - x is NaN for a NaN or infinite x).
__device__ __forceinline__ bool finite4(const float* a) {
  return a[0] - a[0] == 0.0f && a[1] - a[1] == 0.0f && a[2] - a[2] == 0.0f && a[3] - a[3] == 0.0f;
}

// A pixel's own slot + 1, parent slot + 1 and probe count, in one register.
__device__ __forceinline__ int own_slot(int packed) { return (packed & 0xFF) - 1; }
__device__ __forceinline__ int par_slot(int packed) { return ((packed >> 8) & 0xFF) - 1; }
__device__ __forceinline__ int probes(int packed) { return packed >> 16; }

// A thread's pixels of one group of kGroupPx: pixel q = group * kGroupPx +
// tid + k * kThreads of the tile (row-major), k < kPPT.
struct Group {
  int pix[kPPT];      // offset in a plane (tr_plan refuses planes of 2^31 pixels or more)
  int anch[kPPT][8];  // own y lo, y hi, x lo, x hi; parent the same
  int slots[kPPT];    // own slot + 1 | (parent slot + 1) << 8 | probe count << 16
  unsigned matched, todo_o, todo_p, share;  // bit k: pixel k
};

// Large tiles: a group's state in the scratch planes (anchors 0-7, slots 8,
// flags 9: matched, todo_o, todo_p, share), written for every pixel of the
// tile by the anchor pass and then by the rounds that assign its roles.
// Each pixel is read and written by the one thread that owns it, so no
// barrier guards them. A pass loads only the planes it reads (kPlanes, bit
// i: plane i), all at once, whatever the flags say.
constexpr int kFlagMatched = 1, kFlagTodoO = 2, kFlagTodoP = 4, kFlagShare = 8;
constexpr unsigned kSlotsPlane = 1u << 8, kAllPlanes = 0x1FFu;

template <unsigned kPlanes>
__device__ __forceinline__ void load_group(Group& s, const int* __restrict__ scratch, long long plane, int base,
                                           int tpx) {
  int f[kPPT];
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    const bool in = base + k * kThreads < tpx;
    f[k] = in ? scratch[9 * plane + s.pix[k]] : 0;
    s.slots[k] = (kPlanes & kSlotsPlane) && in ? scratch[8 * plane + s.pix[k]] : 1 << 16;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (kPlanes >> i & 1) s.anch[k][i] = in ? scratch[i * plane + s.pix[k]] : 0;
    }
  }
  s.matched = s.todo_o = s.todo_p = s.share = 0;
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    if (f[k] & kFlagMatched) s.matched |= 1u << k;
    if (f[k] & kFlagTodoO) s.todo_o |= 1u << k;
    if (f[k] & kFlagTodoP) s.todo_p |= 1u << k;
    if (f[k] & kFlagShare) s.share |= 1u << k;
  }
}

// The group's planes of kPlanes and its flags, for its pixels in the tile.
template <unsigned kPlanes>
__device__ __forceinline__ void store_group(const Group& s, int* __restrict__ scratch, long long plane, int base,
                                            int tpx) {
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    if (base + k * kThreads >= tpx) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (kPlanes >> i & 1) scratch[i * plane + s.pix[k]] = s.anch[k][i];
    }
    if (kPlanes & kSlotsPlane) scratch[8 * plane + s.pix[k]] = s.slots[k];
    scratch[9 * plane + s.pix[k]] = (s.matched >> k & 1 ? kFlagMatched : 0) | (s.todo_o >> k & 1 ? kFlagTodoO : 0) |
                                    (s.todo_p >> k & 1 ? kFlagTodoP : 0) | (s.share >> k & 1 ? kFlagShare : 0);
  }
}

// One block per tile. kLarge = false: tiles of at most kGroupPx pixels, the
// state in registers (one group). kLarge = true: any tile, the pixels in
// groups of kGroupPx whose state lives in scratch between passes; every
// block-wide minimum runs over all groups, so the covering, the plan words
// and the assignment are the small path's.
template <bool kLarge>
__global__ void __launch_bounds__(kThreads, 1)
    plan_kernel(const float* __restrict__ gbuf, int tiles_x, int tiles_y, int tile_h, int tile_w, int rc,
                int max_anisotropy, int* __restrict__ table, float* __restrict__ assign,
                int* __restrict__ residual_px, int* __restrict__ scratch) {
  __shared__ int part[2][kWarps];
  __shared__ __align__(16) int rows[kRows * kLanes];
  __shared__ int words[kMaxChunks * kK2][5];  // per (chunk, slot): y lo, y hi, x lo, x hi, probes
  __shared__ int chunk_np[kMaxChunks];
  __shared__ int sl_oy[kK2], sl_ox[kK2];
  __shared__ int n_matched;
  const int tid = threadIdx.x;
  const int t = blockIdx.x;
  const int hp = tiles_y * tile_h, wp = tiles_x * tile_w;
  const long long plane = (long long)hp * wp;
  const int tpx = tile_h * tile_w;
  const int y0 = (t / tiles_x) * tile_h, x0 = (t % tiles_x) * tile_w;
  const int nc = tile_h / rc;
  const int cpx = rc * tile_w;
  const int n_groups = kLarge ? (tpx + kGroupPx - 1) / kGroupPx : 1;

  rows[tid] = 0;
  if (tid < kMaxChunks * kK2) {
    words[tid][0] = kNone;
    words[tid][1] = -kNone;
    words[tid][2] = kNone;
    words[tid][3] = -kNone;
    words[tid][4] = 0;
  }
  if (tid < kMaxChunks) chunk_np[tid] = 1;
  if (tid == 0) n_matched = 0;

  Group s;
  // Pixel offsets of group grp; the small path computes them once.
  auto locate = [&](int grp) {
#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
      const int q = grp * kGroupPx + tid + k * kThreads;
      s.pix[k] = (y0 + q / tile_w) * wp + x0 + q % tile_w;
    }
  };
  auto match = [&](int grp) {
    s.matched = 0;
#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
      if (grp * kGroupPx + tid + k * kThreads < tpx && gbuf[16 * plane + s.pix[k]] > 0.0f) s.matched |= 1u << k;
    }
  };
  // A group's planes kPlanes from scratch (the large path; the small one
  // holds its only group in registers).
  auto load = [&](int grp, auto planes) {
    if (kLarge) {
      locate(grp);
      load_group<decltype(planes)::value>(s, scratch, plane, grp * kGroupPx + tid, tpx);
    }
  };
  using RoundB = std::integral_constant<unsigned, 0x66u>;   // y hi, x lo (own and parent)
  using RoundC = std::integral_constant<unsigned, 0x1BBu>;  // y lo, y hi, x hi, slots
  using Words = std::integral_constant<unsigned, kAllPlanes>;

  unsigned any_matched = 0;
  for (int grp = 0; grp < n_groups; ++grp) {
    locate(grp);
    match(grp);
    any_matched |= s.matched;
  }
#pragma unroll
  for (int k = 0; k < kPPT; ++k) s.slots[k] = 1 << 16;
  int n_used = 0;
  int cls = kClsEmpty;

  if (__syncthreads_or(any_matched)) {  // else an empty tile: the table and assignment below are all it needs
    bool leftover = false, poison = false, pending = false;
    int matched_px = 0;
    // Large path: the groups below 64 where this thread still has roles to
    // assign (the rounds pass over no other); later groups always.
    unsigned long long live = 0;
    auto skip = [&](int grp) { return kLarge && grp < 64 && !(live >> grp & 1); };
    // Large path: the smallest row anchor still to assign, found by the
    // pass before each round (the anchor pass, then each round's
    // assignment pass), so a round makes two passes over the groups.
    int m_next = kNone;
    auto fold_next = [&]() {
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        if (s.todo_o >> k & 1) m_next = min(m_next, s.anch[k][0]);
        if (s.todo_p >> k & 1) m_next = min(m_next, s.anch[k][4]);
      }
    };
    for (int grp = 0; grp < n_groups; ++grp) {
      if (kLarge) {
        locate(grp);
        match(grp);
      }
      s.todo_o = s.todo_p = s.share = 0;
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
#pragma unroll
        for (int i = 0; i < 8; ++i) s.anch[k][i] = 0;
        s.slots[k] = 1 << 16;
        if (!(s.matched >> k & 1)) continue;
        const float* g = gbuf + s.pix[k];
        const float u = g[6 * plane], v = g[7 * plane];
        const float tw0 = g[9 * plane], th0 = g[10 * plane], tw1 = g[11 * plane], th1 = g[12 * plane];
        const float maj_du = g[14 * plane], maj_dv = g[15 * plane], span = g[17 * plane];
        float n_px = 1.0f;
        if (max_anisotropy > 1) {
          // shade.probe_count
          const float ext = max_nan(fabsf(maj_du) * tw0, fabsf(maj_dv) * th0) * span;
          n_px = min_nan(max_nan(ceilf(ext - 1e-4f), 1.0f), (float)max_anisotropy);
        }
        s.slots[k] = (n_px == n_px ? (int)n_px : 1) << 16;
        const float fo_ext = (0.5f - 0.5f / n_px) * span;
        const float du_ext = fabsf(maj_du) * fo_ext;
        const float dv_ext = fabsf(maj_dv) * fo_ext;
        float a[8];
        anchor(v, th0, dv_ext, 87.0f, &a[0], &a[1]);   // Y_WRAP_LIM
        anchor(u, tw0, du_ext, 255.0f, &a[2], &a[3]);  // X_WRAP_LIM
        anchor(v, th1, dv_ext, 87.0f, &a[4], &a[5]);
        anchor(u, tw1, du_ext, 255.0f, &a[6], &a[7]);
        const float by0 = g[20 * plane], bx0 = g[21 * plane], by1 = g[22 * plane], bx1 = g[23 * plane];
        a[0] = a[0] + by0;
        a[1] = a[1] + by0;
        a[2] = a[2] + bx0;
        a[3] = a[3] + bx0;
        a[4] = a[4] + by1;
        a[5] = a[5] + by1;
        a[6] = a[6] + bx1;
        a[7] = a[7] + bx1;
        const bool unfit_o = (a[1] - a[0] > (float)(kWH - kAlignY - 2)) || (a[3] - a[2] > (float)(kWW - kAlignX - 2));
        const bool unfit_p = (a[5] - a[4] > (float)(kWH - kAlignY - 2)) || (a[7] - a[6] > (float)(kWW - kAlignX - 2));
        const bool nan_o = !finite4(a), nan_p = !finite4(a + 4);
        leftover = leftover || unfit_o || unfit_p;
        poison = poison || (!unfit_o && nan_o) || (!unfit_p && nan_p);
        if (!unfit_o && !nan_o) {
          s.todo_o |= 1u << k;
#pragma unroll
          for (int i = 0; i < 4; ++i) s.anch[k][i] = (int)a[i];
        }
        if (!unfit_p && !nan_p) {
          s.todo_p |= 1u << k;
#pragma unroll
          for (int i = 4; i < 8; ++i) s.anch[k][i] = (int)a[i];
        }
        if (tw1 == tw0 && th1 == th0) s.share |= 1u << k;
      }
      matched_px += __popc(s.matched);
      if (kLarge) {
        store_group<kAllPlanes>(s, scratch, plane, grp * kGroupPx + tid, tpx);
        if ((s.todo_o | s.todo_p) && grp < 64) live |= 1ull << grp;
        fold_next();
      }
    }
    // A poisoned tile plans no window: with nothing to do, the first
    // round's minimum is kNone.
    poison = __syncthreads_or(poison);
    if (poison) {
      s.todo_o = s.todo_p = 0;
      leftover = true;
    }

    // Greedy banded covering (sampler.py:286-341).
    int turn = 0;
    for (int sl = 0; sl < kK2 && !(kLarge && poison); ++sl) {
      int m = kNone;
      if (kLarge) {
        m = m_next;
      } else {
#pragma unroll
        for (int k = 0; k < kPPT; ++k) {
          if (s.todo_o >> k & 1) m = min(m, s.anch[k][0]);
          if (s.todo_p >> k & 1) m = min(m, s.anch[k][4]);
        }
      }
      const int ymin = block_min(m, part, turn);
      if (ymin == kNone) break;  // covered
      const int oy = ymin - floor_mod_i(ymin, kAlignY);
      const int lim_y = oy + (kWH - 2);
      unsigned band_o = 0, band_p = 0;
      auto band = [&]() {
        band_o = band_p = 0;
#pragma unroll
        for (int k = 0; k < kPPT; ++k) {
          if ((s.todo_o >> k & 1) && s.anch[k][1] < lim_y) band_o |= 1u << k;
          if ((s.todo_p >> k & 1) && s.anch[k][5] < lim_y) band_p |= 1u << k;
        }
      };
      m = kNone;
      for (int grp = 0; grp < n_groups; ++grp) {
        if (skip(grp)) continue;
        load(grp, RoundB{});
        band();
#pragma unroll
        for (int k = 0; k < kPPT; ++k) {
          if (band_o >> k & 1) m = min(m, s.anch[k][2]);
          if (band_p >> k & 1) m = min(m, s.anch[k][6]);
        }
      }
      const int xmin = block_min(m, part, turn);
      const int ox = xmin - floor_mod_i(xmin, kAlignX);
      const int lim_x = ox + (kWW - 2);
      pending = false;
      m_next = kNone;
      for (int grp = 0; grp < n_groups; ++grp) {
        if (skip(grp)) continue;
        if (kLarge) {
          load(grp, RoundC{});
          band();
        }
#pragma unroll
        for (int k = 0; k < kPPT; ++k) {
          const bool win_o = (band_o >> k & 1) && s.anch[k][3] < lim_x;
          const bool win_p = (band_p >> k & 1) && s.anch[k][7] < lim_x && (!win_o || (s.share >> k & 1));
          if (win_o) {
            s.slots[k] |= sl + 1;
            s.todo_o &= ~(1u << k);
          }
          if (win_p) {
            s.slots[k] |= (sl + 1) << 8;
            s.todo_p &= ~(1u << k);
          }
        }
        pending = pending || s.todo_o || s.todo_p;
        if (kLarge) fold_next();
        if (kLarge && (band_o || band_p)) {
          store_group<kSlotsPlane>(s, scratch, plane, grp * kGroupPx + tid, tpx);
          if (!(s.todo_o | s.todo_p) && grp < 64) live &= ~(1ull << grp);
        }
      }
      if (tid == 0) {
        sl_oy[sl] = oy;
        sl_ox[sl] = ox;
      }
      ++n_used;
    }
    if (!kLarge) pending = s.todo_o || s.todo_p;
    // Also publishes sl_oy / sl_ox and the initial words.
    cls = __syncthreads_or(leftover || pending) ? kClsResidual : kClsWindowed;
    if (cls == kClsResidual) {
      // Integer sums: the frame's count does not depend on the order.
      const int n = warp_add_i(matched_px);
      if ((tid & 31) == 0) atomicAdd(&n_matched, n);
    }

    // Per (chunk, slot): the anchors' extremes and the worst probe count
    // over the roles assigned to the slot (sampler.py:362-445), and per
    // chunk the worst probe count of its matched pixels.
    for (int grp = 0; grp < n_groups; ++grp) {
      load(grp, Words{});
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        const int q = grp * kGroupPx + tid + k * kThreads;
        const int ci = q / cpx;
        const int np = probes(s.slots[k]);
        warp_by_key((s.matched >> k & 1) ? ci : -1, [&](int chunk, bool mine) {
          const int worst = warp_max_i(mine ? np : 1);
          if ((tid & 31) == 0) atomicMax(&chunk_np[chunk], worst);
        });
#pragma unroll
        for (int role = 0; role < 2; ++role) {
          const int slot = role == 0 ? own_slot(s.slots[k]) : par_slot(s.slots[k]);
          const int a0 = s.anch[k][4 * role], a1 = s.anch[k][4 * role + 1];
          const int a2 = s.anch[k][4 * role + 2], a3 = s.anch[k][4 * role + 3];
          warp_by_key(slot >= 0 ? ci * kK2 + slot : -1, [&](int word, bool mine) {
            const int ylo = warp_min_i(mine ? a0 : kNone), yhi = warp_max_i(mine ? a1 : -kNone);
            const int xlo = warp_min_i(mine ? a2 : kNone), xhi = warp_max_i(mine ? a3 : -kNone);
            const int worst = warp_max_i(mine ? np : 0);
            if ((tid & 31) == 0) {
              atomicMin(&words[word][0], ylo);
              atomicMax(&words[word][1], yhi);
              atomicMin(&words[word][2], xlo);
              atomicMax(&words[word][3], xhi);
              atomicMax(&words[word][4], worst);
            }
          });
        }
      }
    }
    __syncthreads();
    if (tid < nc * kK2 && tid % kK2 < n_used && words[tid][4] > 0) {
      const int ci = tid / kK2, j = tid % kK2;
      const int rylo = clampi(words[tid][0] - sl_oy[j], 0, kWH - 1);
      const int ryhi = clampi(words[tid][1] - sl_oy[j] + 1, 0, kWH - 1);
      const int rxlo = clampi(words[tid][2] - sl_ox[j], 0, kWW - 1);
      const int rxhi = clampi(words[tid][3] - sl_ox[j] + 1, 0, kWW - 1);
      int b0 = rylo - floor_mod_i(rylo, kAlignY);
      const int nyb = clampi(floor_div(ryhi + 1 - b0 + kYB - 1, kYB), 1, kWH / kYB);
      b0 = min(b0, kWH - nyb * kYB);
      const int xb0 = floor_div(rxlo, kXB);
      const int nxb = clampi(floor_div(rxhi, kXB), 0, kNXB - 1) - xb0 + 1;
      const int np_s = clampi(words[tid][4], 1, 16);
      rows[(1 + ci) * kLanes + j] = 1 | (b0 << 1) | (nyb << 9) | (xb0 << 12) | (nxb << 14) | ((np_s - 1) << 16);
    }
    if (tid < n_used) {
      rows[32 + tid] = sl_oy[tid];
      rows[64 + tid] = sl_ox[tid];
    }
  }

  if (tid == 0) {
    rows[0] = cls;
    rows[1] = n_used;
    if (cls == kClsResidual) atomicAdd(residual_px, n_matched);  // summed before the words' barrier
  }
  if (tid < nc) rows[(1 + tid) * kLanes + kChunkNpLane] = chunk_np[tid];
  __syncthreads();
  if (tid < kRows * kLanes / 4)
    reinterpret_cast<int4*>(table + (long long)t * kRows * kLanes)[tid] = reinterpret_cast<const int4*>(rows)[tid];
  for (int grp = 0; grp < n_groups; ++grp) {
    if (kLarge) {
      locate(grp);
      if (cls != kClsEmpty) load_group<kSlotsPlane>(s, scratch, plane, grp * kGroupPx + tid, tpx);
    }
#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
      if (grp * kGroupPx + tid + k * kThreads >= tpx) continue;
      assign[s.pix[k]] = (float)own_slot(s.slots[k]);
      assign[plane + s.pix[k]] = (float)par_slot(s.slots[k]);
    }
  }
}

}  // namespace

// scratch: 10 (Hp, Wp) int planes for tiles of more than kGroupPx pixels
// (kernels/sampler.py plan_scratch), else unused (may be null).
extern "C" int tr_plan(const float* gbuf, int tiles_x, int tiles_y, int tile_h, int tile_w, int rc,
                       int max_anisotropy, int* table, float* assign, int* residual_px, int* scratch, void* stream) {
  const bool large = tile_h * tile_w > kGroupPx;
  if (tile_h < 1 || tile_w < 1 || rc < 1 || tile_h % rc != 0 || tile_h / rc > kMaxChunks ||
      (long long)tiles_x * tile_w * tiles_y * tile_h > kNone || (large && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (large) {
    TR_LAUNCH(plan_kernel<true>, tiles_x * tiles_y, kThreads, stream, gbuf, tiles_x, tiles_y, tile_h, tile_w, rc,
              max_anisotropy, table, assign, residual_px, scratch);
  } else {
    TR_LAUNCH(plan_kernel<false>, tiles_x * tiles_y, kThreads, stream, gbuf, tiles_x, tiles_y, tile_h, tile_w, rc,
              max_anisotropy, table, assign, residual_px, scratch);
  }
  return (int)cudaGetLastError();
}

#ifndef TR_HOST_EMU
// The plan kernel's registers per thread and resident blocks per SM (the
// path of tiles of at most kGroupPx pixels; tr_plan_large_info: the other).
template <bool kLarge>
int plan_info(int* registers, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, plan_kernel<kLarge>);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, plan_kernel<kLarge>, kThreads, 0);
}

extern "C" int tr_plan_info(int* registers, int* blocks_per_sm) { return plan_info<false>(registers, blocks_per_sm); }

extern "C" int tr_plan_large_info(int* registers, int* blocks_per_sm) {
  return plan_info<true>(registers, blocks_per_sm);
}
#endif
