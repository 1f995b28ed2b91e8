// Per-tile texel-window plan for the sample kernel.
//
// Replaces tpurast/kernels/sampler.py::_plan_kernel (launched by
// plan_tiles). Plain torch version:
// tpurast_torch/kernels/sampler.py::plan_tiles_plain.
//
// One block per framebuffer tile, 512 threads x 8 pixels (tiles of at most
// 4096 px). Each pixel's page-coordinate anchor range (bilinear texel plus
// the probe train's extremes, own and parent mip) is computed once and
// held in registers. A greedy banded covering then places up to K2 = 32
// windows of WH x WW texels: each round seeds at the smallest uncovered
// anchor row, opens an ALIGN_Y-aligned band there, takes the smallest
// anchor column inside the band, and assigns every pixel role whose whole
// range fits the ALIGN_X-aligned window (sampler.py:286-341). Tiles whose
// pixels do not all fit K2 windows are RESIDUAL; the sample kernel reads
// their texels straight from the page. Per (chunk of rc rows, slot) the
// kernel then packs the y and x bands of the window that the chunk's
// pixels touch and their worst probe count into one plan word
// (sampler.py:362-445). The output is the reference's table (T, 8, 128)
// and assign (2, Hp, Wp), value for value.
//
// What bounds it on this card: block-wide reductions. A round is two
// min-reductions over the tile and a chunk slot one 6-value reduction; each
// is a shared-memory tree with a barrier per level (no warp shuffles, so
// the host emulation in host_emu.h runs the same code). Most tiles need
// 1-4 rounds, so the kernel is a small share of a frame; a later PR can
// move to warp-shuffle reductions.

#include "common.cuh"

namespace {

constexpr int kAOut = 24;
constexpr int kThreads = 512;
constexpr int kPPT = 8;  // pixels per thread
constexpr int kWH = 96, kWW = 384, kAlignY = 8, kAlignX = 128;
constexpr int kK2 = 32, kYB = 48, kXB = 128, kNXB = kWW / kXB;
constexpr int kClsWindowed = 0, kClsEmpty = 2, kClsResidual = 3;
constexpr int kChunkNpLane = 120;
constexpr float kBig = 3.4e38f;
constexpr int kRed = 6;  // values per reduction, at most

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ int floor_mod_i(int a, int b) { return a - floor_div(a, b) * b; }

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

// Block-wide NaN-propagating max of N values per thread; every thread
// gets the results.
template <int N>
__device__ void block_max(float v[N], float (*red)[kThreads]) {
  const int tid = threadIdx.x;
  __syncthreads();
  for (int i = 0; i < N; ++i) red[i][tid] = v[i];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s)
      for (int i = 0; i < N; ++i) red[i][tid] = max_nan(red[i][tid], red[i][tid + s]);
    __syncthreads();
  }
  for (int i = 0; i < N; ++i) v[i] = red[i][0];
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

__global__ void plan_kernel(const float* __restrict__ gbuf, int tiles_x, int tiles_y, int tile_h,
                            int tile_w, int rc, int max_anisotropy, int* __restrict__ table,
                            float* __restrict__ assign) {
  __shared__ float red[kRed][kThreads];
  __shared__ int rows[8][128];
  __shared__ int sl_oy[kK2], sl_ox[kK2];
  const int tid = threadIdx.x;
  const int t = blockIdx.x;
  const int hp = tiles_y * tile_h, wp = tiles_x * tile_w;
  const long long plane = (long long)hp * wp;
  const int tpx = tile_h * tile_w;
  const int y0 = (t / tiles_x) * tile_h, x0 = (t % tiles_x) * tile_w;

  float anch[kPPT][8];
  float npx[kPPT], ao[kPPT], ap[kPPT];
  unsigned matched = 0, todo_o = 0, todo_p = 0, share = 0;
  bool unfit_any = false;
  for (int k = 0; k < kPPT; ++k) {
    const int q = tid + k * kThreads;
    ao[k] = -1.0f;
    ap[k] = -1.0f;
    npx[k] = 1.0f;
    for (int i = 0; i < 8; ++i) anch[k][i] = 0.0f;
    if (q >= tpx) continue;
    const long long p = (long long)(y0 + q / tile_w) * wp + x0 + q % tile_w;
    float g[kAOut];
    for (int i = 0; i < kAOut; ++i) g[i] = gbuf[i * plane + p];
    const float u = g[6], v = g[7], tw0 = g[9], th0 = g[10], tw1 = g[11], th1 = g[12];
    const float span = g[17];
    float n_px = 1.0f;
    if (max_anisotropy > 1) {
      // shade.probe_count
      const float ext = max_nan(fabsf(g[14]) * tw0, fabsf(g[15]) * th0) * span;
      n_px = min_nan(max_nan(ceilf(ext - 1e-4f), 1.0f), (float)max_anisotropy);
    }
    npx[k] = n_px;
    const float fo_ext = (0.5f - 0.5f / n_px) * span;
    const float du_ext = fabsf(g[14]) * fo_ext;
    const float dv_ext = fabsf(g[15]) * fo_ext;
    float a[8];
    anchor(v, th0, dv_ext, 87.0f, &a[0], &a[1]);   // Y_WRAP_LIM
    anchor(u, tw0, du_ext, 255.0f, &a[2], &a[3]);  // X_WRAP_LIM
    anchor(v, th1, dv_ext, 87.0f, &a[4], &a[5]);
    anchor(u, tw1, du_ext, 255.0f, &a[6], &a[7]);
    a[0] = a[0] + g[20];
    a[1] = a[1] + g[20];
    a[2] = a[2] + g[21];
    a[3] = a[3] + g[21];
    a[4] = a[4] + g[22];
    a[5] = a[5] + g[22];
    a[6] = a[6] + g[23];
    a[7] = a[7] + g[23];
    for (int i = 0; i < 8; ++i) anch[k][i] = a[i];
    const bool m = g[16] > 0.0f;
    const bool unfit_o = (a[1] - a[0] > (float)(kWH - kAlignY - 2)) || (a[3] - a[2] > (float)(kWW - kAlignX - 2));
    const bool unfit_p = (a[5] - a[4] > (float)(kWH - kAlignY - 2)) || (a[7] - a[6] > (float)(kWW - kAlignX - 2));
    unfit_any = unfit_any || (m && (unfit_o || unfit_p));
    if (m) matched |= 1u << k;
    if (m && !unfit_o) todo_o |= 1u << k;
    if (m && !unfit_p) todo_p |= 1u << k;
    if (tw1 == tw0 && th1 == th0) share |= 1u << k;
  }

  // Greedy banded covering (sampler.py:286-341).
  int n_used = 0;
  for (int s = 0; s < kK2; ++s) {
    float r[1] = {-kBig};
    for (int k = 0; k < kPPT; ++k) {
      const float yo = (todo_o >> k & 1) ? anch[k][0] : kBig;
      const float yp = (todo_p >> k & 1) ? anch[k][4] : kBig;
      r[0] = max_nan(r[0], -min_nan(yo, yp));
    }
    block_max<1>(r, red);
    const float ymin = -r[0];
    if (!(ymin < kBig * 0.5f)) break;  // covered (or NaN: nothing can seed)
    const float oy = ymin - floorf(ymin / (float)kAlignY) * (float)kAlignY;
    const float lim_y = ymin - oy + (float)(kWH - 2);
    unsigned band_o = 0, band_p = 0;
    r[0] = -kBig;
    for (int k = 0; k < kPPT; ++k) {
      if ((todo_o >> k & 1) && anch[k][1] < lim_y) band_o |= 1u << k;
      if ((todo_p >> k & 1) && anch[k][5] < lim_y) band_p |= 1u << k;
      const float xo = (band_o >> k & 1) ? anch[k][2] : kBig;
      const float xp = (band_p >> k & 1) ? anch[k][6] : kBig;
      r[0] = max_nan(r[0], -min_nan(xo, xp));
    }
    block_max<1>(r, red);
    const float xmin = -r[0];
    const float oxs = xmin - floorf(xmin / (float)kAlignX) * (float)kAlignX;
    const float lim_x = xmin - oxs + (float)(kWW - 2);
    for (int k = 0; k < kPPT; ++k) {
      const bool win_o = (band_o >> k & 1) && anch[k][3] < lim_x;
      const bool win_p = (band_p >> k & 1) && anch[k][7] < lim_x && (!win_o || (share >> k & 1));
      if (win_o) {
        ao[k] = (float)s;
        todo_o &= ~(1u << k);
      }
      if (win_p) {
        ap[k] = (float)s;
        todo_p &= ~(1u << k);
      }
    }
    if (tid == 0) {
      const int ymin_i = (int)ymin, xmin_i = (int)xmin;
      sl_oy[s] = ymin_i - floor_mod_i(ymin_i, kAlignY);
      sl_ox[s] = xmin_i - floor_mod_i(xmin_i, kAlignX);
    }
    ++n_used;
  }

  float f[3] = {matched ? 1.0f : 0.0f, (todo_o | todo_p) ? 1.0f : 0.0f, unfit_any ? 1.0f : 0.0f};
  block_max<3>(f, red);  // also publishes sl_oy / sl_ox
  const bool covered = f[0] > 0.0f, leftover = f[1] > 0.0f || f[2] > 0.0f;
  const int cls = covered ? (leftover ? kClsResidual : kClsWindowed) : kClsEmpty;
  for (int i = tid; i < 8 * 128; i += kThreads) {
    const int row = i / 128, lane = i % 128;
    int val = 0;
    if (row == 0) {
      if (lane == 0) val = cls;
      if (lane == 1) val = n_used;
      if (lane >= 32 && lane < 32 + n_used) val = sl_oy[lane - 32];
      if (lane >= 64 && lane < 64 + n_used) val = sl_ox[lane - 64];
    }
    rows[row][lane] = val;
  }

  // Per-(chunk, slot) plan words (sampler.py:362-445).
  const int nc = tile_h / rc;
  const int cpx = rc * tile_w;
  for (int ci = 0; ci < nc; ++ci) {
    float c[1] = {1.0f};
    for (int k = 0; k < kPPT; ++k) {
      const int q = tid + k * kThreads;
      if (q < tpx && q / cpx == ci && (matched >> k & 1)) c[0] = max_nan(c[0], npx[k]);
    }
    block_max<1>(c, red);
    if (tid == 0) rows[1 + ci][kChunkNpLane] = (int)c[0];
    for (int j = 0; j < n_used; ++j) {
      const float jf = (float)j;
      float v[kRed] = {0.0f, -kBig, -kBig, -kBig, -kBig, 1.0f};
      for (int k = 0; k < kPPT; ++k) {
        const int q = tid + k * kThreads;
        if (q >= tpx || q / cpx != ci) continue;
        const bool m_o = ao[k] == jf, m_p = ap[k] == jf;
        if (m_o || m_p) v[0] = 1.0f;
        v[1] = max_nan(v[1], -min_nan(m_o ? anch[k][0] : kBig, m_p ? anch[k][4] : kBig));
        v[2] = max_nan(v[2], max_nan(m_o ? anch[k][1] : -kBig, m_p ? anch[k][5] : -kBig));
        v[3] = max_nan(v[3], -min_nan(m_o ? anch[k][2] : kBig, m_p ? anch[k][6] : kBig));
        v[4] = max_nan(v[4], max_nan(m_o ? anch[k][3] : -kBig, m_p ? anch[k][7] : -kBig));
        v[5] = max_nan(v[5], (m_o || m_p) ? npx[k] : 1.0f);
      }
      block_max<kRed>(v, red);
      if (tid == 0 && v[0] > 0.0f) {
        const int rylo = clampi((int)(-v[1]) - sl_oy[j], 0, kWH - 1);
        const int ryhi = clampi((int)v[2] - sl_oy[j] + 1, 0, kWH - 1);
        const int rxlo = clampi((int)(-v[3]) - sl_ox[j], 0, kWW - 1);
        const int rxhi = clampi((int)v[4] - sl_ox[j] + 1, 0, kWW - 1);
        int b0 = rylo - floor_mod_i(rylo, kAlignY);
        const int nyb = clampi(floor_div(ryhi + 1 - b0 + kYB - 1, kYB), 1, kWH / kYB);
        b0 = min(b0, kWH - nyb * kYB);
        const int xb0 = floor_div(rxlo, kXB);
        const int nxb = clampi(floor_div(rxhi, kXB), 0, kNXB - 1) - xb0 + 1;
        const int np_s = clampi((int)v[5], 1, 16);
        rows[1 + ci][j] = 1 | (b0 << 1) | (nyb << 9) | (xb0 << 12) | (nxb << 14) | ((np_s - 1) << 16);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < 8 * 128; i += kThreads) table[(long long)t * 8 * 128 + i] = rows[i / 128][i % 128];
  for (int k = 0; k < kPPT; ++k) {
    const int q = tid + k * kThreads;
    if (q >= tpx) continue;
    const long long p = (long long)(y0 + q / tile_w) * wp + x0 + q % tile_w;
    assign[p] = ao[k];
    assign[plane + p] = ap[k];
  }
}

}  // namespace

extern "C" int tr_plan(const float* gbuf, int tiles_x, int tiles_y, int tile_h, int tile_w, int rc,
                       int max_anisotropy, int* table, float* assign, void* stream) {
  if (tile_h * tile_w > kThreads * kPPT || tile_h % rc != 0 || tile_h / rc + 1 > 8) return (int)cudaErrorInvalidValue;
  TR_LAUNCH(plan_kernel, tiles_x * tiles_y, kThreads, stream, gbuf, tiles_x, tiles_y, tile_h, tile_w, rc,
            max_anisotropy, table, assign);
  return (int)cudaGetLastError();
}
