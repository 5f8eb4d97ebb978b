// The batched inverse and solve behind engine.inv_or_nan and
// engine.solve_or_nan for float32 lanes of m <= 256: one launch a call.
//
// Replaces no TPU kernel: the JAX package leaves jnp.linalg.inv and solve
// to XLA. On the card these calls went to torch.linalg.inv_ex / solve_ex,
// which at these sizes is MAGMA's batched getrf / getrs: a host loop of
// ~270 launches for one inverse at [1024, 256, 256], with allocations,
// frees and device synchronisations among them, the card idle between.
//
// Arithmetic. LU factorization with partial pivoting (getrf's), then the
// two triangular solves. At step k the pivot is the row of largest |a| in
// column k among the rows not yet pivoted, the lowest logical row on a tie:
// the row LAPACK's getrf takes. Rows are never moved; every row keeps its
// logical position (`pos`, LAPACK's order after its interchanges) and the
// answer is read through it at the end. As getf2 does, a multiplier is the
// entry times the pivot's reciprocal; as getrf does, a panel's update is
// U12 = L11^-1 A12, then A22 -= L21 U12. The forward transform T (T A = U,
// unit lower) is kept in place of L, so column k of the lane's storage
// holds U on and above its pivot row and T's column p_k below it. Phase 1
// eliminates; phase 2 runs the back substitution X = U^-1 T by row blocks,
// bottom up, in place (the inverse, read out as inv[k][p_j] = S[p_k][j]; a
// division by a pivot is the product with the reciprocal phase 1 took);
// the solve carries its right-hand side through both phases instead and
// forms no inverse. A pivot that is 0 or not finite fails the lane, which
// comes back all NaN (what a nonzero LAPACK info gave); a NaN entry is a
// candidate of infinite size, so it fails its column or spreads through
// phase 2. Every sum runs in one fixed order, with no atomics: a lane's
// bits depend on m alone, not on B, its place in the batch or the run.
//
// Bound. Operations: the inverse is 2 m^3 flops a lane (34.4 GFLOP at
// [1024, 256, 256], 0.51 ms at 67 TFLOP/s); the solve 2/3 m^3 (0.17 ms).
// Bytes: M read once, the answer written once (0.16 ms for the inverse at
// that shape). The lane's 256 column steps are a serial chain.
//
// Design. A lane's matrix (256 KB at m = 256) stays on chip for the whole
// call, split by columns over a cluster of 1, 2 or 4 CTAs of 256 threads (at
// most 64 columns a CTA: whole panels of kNB columns, dealt out in turn), so
// that two lanes share an SM and one lane's serial steps overlap the
// other's block products. Phase 1, panel p: its owner CTA runs getf2 on the
// panel's columns with one row a thread in registers and ONE block barrier
// a column (each warp publishes its candidate's key and whole row, so every
// thread reads the pivot row alone); it writes the panel's multipliers
// (rows in logical order), the pivots' reciprocals and every row's new
// position into every CTA of the cluster; then one cluster barrier, and
// every CTA applies the panel to its own columns: U12 on the pivot rows (a
// column a thread), then the rows below as a block product held in
// registers (4 rows x 8 columns a thread a pass). Phase 2, row block K from
// the bottom: every CTA pushes its part of U's rows K to the CTAs that need
// it (all of them for the inverse, the one holding the right-hand side for
// the solve); one cluster barrier; then a block product over the rows below
// and a 16-step triangular solve inside a warp, in registers. The panel
// buffers alternate, so one panel's buffer is written while the last one's
// is still read. At the end each CTA writes the output's columns of its
// own columns (the inverse column-major, as torch.linalg returns it).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_segment.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kNB = 16;  // columns a panel
constexpr int kLuThreads = 256;
constexpr int kLuWarps = kLuThreads / 32;
constexpr int kMaxM = 256;  // one row a thread in the panel factorization
// a warp's winner of a column step: its key (2 words, 2 spare) and its row
constexpr int kWinFloats = kNB + 4;
constexpr int kSlotFloats = 2 * kLuWarps * kWinFloats;  // two rounds

struct Plan {
  int mp;   // m padded with identity rows and columns
  int cl;   // CTAs a lane: 1, 2 or 4, so that a CTA holds <= 64 columns
  int lc;   // columns a CTA holds
  int lda;  // row stride of the held columns (4 more: fewer bank conflicts)
  int bs;   // floats of one panel buffer: L[mp][kNB], K[kNB], pos[mp], fail
};

__host__ __device__ __forceinline__ Plan make_plan(int m) {
  Plan p;
  p.cl = m <= 64 ? 1 : (m <= 128 ? 2 : 4);
  const int q = kNB * p.cl;
  p.mp = (m + q - 1) / q * q;
  p.lc = p.mp / p.cl;
  p.lda = p.lc + 4;
  p.bs = kNB * p.mp + kNB + p.mp + 4;
  return p;
}

__host__ __device__ __forceinline__ size_t smem_bytes(const Plan& p) {
  return sizeof(float) * ((size_t)p.mp * p.lda + 2 * (size_t)p.bs +
                          kNB * p.lc + kNB + 3 * p.mp + kSlotFloats);
}

__device__ __forceinline__ int* buf_K(float* buf, int mp) {
  return (int*)(buf + kNB * mp);
}
// Offset of float4 chunk q (entries 4 q .. 4 q + 3) of row r of a panel's
// multipliers: rows of kNB floats, the chunks of a row rotated by bits 1-2
// of r, so that eight neighbouring rows' chunk q fill the 32 banks.
__device__ __forceinline__ int lsw(int r, int q) {
  return r * kNB + 4 * (q ^ ((r >> 1) & 3));
}
__device__ __forceinline__ int* buf_pos(float* buf, int mp) {
  return buf_K(buf, mp) + kNB;
}
__device__ __forceinline__ int* buf_fail(float* buf, int mp) {
  return buf_pos(buf, mp) + mp;
}

__device__ __forceinline__ float* in_rank(cg::cluster_group& cluster,
                                          float* p, int rank) {
  return (int)cluster.block_rank() == rank ? p
                                            : cluster.map_shared_rank(p, rank);
}

// Phase 1, panel p, on every thread of its owner: getf2's steps k0 .. k0 +
// kNB - 1 on the panel's columns, row i = threadIdx.x in registers (the
// multiplier l = a * (1 / pivot), a -= l * u with u the unscaled pivot row),
// and the transform's columns kept in place (-l, then updated by the later
// steps as any column). A step's one block barrier publishes each warp's
// candidate: its key and its whole row, so every thread reads the pivot
// row from the winning warp's slot. Writes the multipliers L (the row of
// logical position k0 + r at chunks lsw(r, .); for the panel's own pivot
// rows, r < kNB, their multipliers of the steps before theirs: L11), K, pos,
// 1 / pivot (dinv, at its position) and the failure flag into every CTA,
// and the panel's rows from position k0 down back into the held columns.
__device__ __forceinline__ void factor_panel(cg::cluster_group& cluster,
                                             const Plan& pl, float* As, int lq,
                                             int k0, const float* prev,
                                             float* buf, float* dinv,
                                             float* slot) {
  const int i = threadIdx.x, warp = i >> 5, ln = i & 31;
  const int mp = pl.mp, lda = pl.lda;
  const bool active = i < mp;
  float a[kNB], l[kNB];
  int mypos = i;
  if (active) {
    const float4* src = (const float4*)(As + (size_t)i * lda + lq * kNB);
#pragma unroll
    for (int q = 0; q < kNB / 4; ++q) {
      const float4 v = src[q];
      a[4 * q] = v.x;
      a[4 * q + 1] = v.y;
      a[4 * q + 2] = v.z;
      a[4 * q + 3] = v.w;
    }
    if (prev != nullptr) mypos = buf_pos((float*)prev, mp)[i];
  } else {
#pragma unroll
    for (int c = 0; c < kNB; ++c) a[c] = 0.0f;
  }
#pragma unroll
  for (int c = 0; c < kNB; ++c) l[c] = 0.0f;
  const bool cand0 = active && mypos >= k0;
  int failed = prev != nullptr ? buf_fail((float*)prev, mp)[0] : 0;
  int* K = buf_K(buf, mp);
  float rcps = 0.0f;  // thread t < kNB: 1 / pivot of step t

#pragma unroll
  for (int t = 0; t < kNB; ++t) {
    const int k = k0 + t;
    const bool cand = active && mypos >= k;
    // the candidate of largest |a| (NaN as +inf), then of lowest position:
    // the value's bits, then pos << 16 | row
    unsigned vb = 0u, key = 0xFFFFFFFFu;
    if (cand) {
      float v = fabsf(a[t]);
      if (v != v) v = INFINITY;
      vb = __float_as_uint(v);
      key = ((unsigned)mypos << 16) | (unsigned)i;
    }
    const unsigned wb = __reduce_max_sync(lp::kFullMask, vb);
    const unsigned wk =
        __reduce_min_sync(lp::kFullMask, vb == wb ? key : 0xFFFFFFFFu);
    float* round = slot + (t & 1) * kLuWarps * kWinFloats;
    float* w = round + warp * kWinFloats;
    if (ln == 0) *(uint2*)(w + kNB) = make_uint2(wb, wk);
    if (key == wk && key != 0xFFFFFFFFu) {  // the warp's winner: its row
#pragma unroll
      for (int q = 0; q < kNB / 4; ++q)
        *(float4*)(w + 4 * q) =
            make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
    }
    __syncthreads();
    // the warps' winners, compared as a tree in every thread
    uint2 sk[kLuWarps];
#pragma unroll
    for (int w2 = 0; w2 < kLuWarps; ++w2)
      sk[w2] = *(const uint2*)(round + w2 * kWinFloats + kNB);
#pragma unroll
    for (int h = 1; h < kLuWarps; h *= 2)
#pragma unroll
      for (int w2 = 0; w2 < kLuWarps; w2 += 2 * h) {
        const uint2 o = sk[w2 + h];
        if (o.x > sk[w2].x || (o.x == sk[w2].x && o.y < sk[w2].y)) sk[w2] = o;
      }
    vb = sk[0].x;
    key = sk[0].y;
    const int pr = (int)(key & 0xFFFFu);
    const int ppos = (int)(key >> 16);
    const float best = __uint_as_float(vb);
    const bool bad = !(best > 0.0f) || best == INFINITY;
    failed |= bad ? 1 : 0;
    // the pivot row u, from the winning warp's slot (pr's warp is pr >> 5)
    float u[kNB];
    const float* win = round + (pr >> 5) * kWinFloats;
#pragma unroll
    for (int q = 0; q < kNB / 4; ++q) {
      const float4 v = *(const float4*)(win + 4 * q);
      u[4 * q] = v.x;
      u[4 * q + 1] = v.y;
      u[4 * q + 2] = v.z;
      u[4 * q + 3] = v.w;
    }
    const float rcp = __frcp_rn(bad ? 1.0f : u[t]);
    if (i == t) rcps = rcp;
    if (i == 0) K[t] = pr;
    if (cand) {
      if (i == pr) {
        mypos = k;
      } else {
        const float lt = a[t] * rcp;
#pragma unroll
        for (int c = 0; c < kNB; ++c)
          if (c != t) a[c] = fmaf(-lt, u[c], a[c]);
        a[t] = -lt;
        l[t] = lt;
        if (mypos == k) mypos = ppos;
      }
    }
  }

  // L by logical position (the panel's pivot rows: L11, strictly lower)
  const int r = mypos - k0;
  for (int dst = 0; dst < pl.cl; ++dst) {
    float* b = in_rank(cluster, buf, dst);
    if (cand0) {
#pragma unroll
      for (int q = 0; q < kNB / 4; ++q)
        *(float4*)(b + lsw(r, q)) =
            make_float4(l[4 * q], l[4 * q + 1], l[4 * q + 2], l[4 * q + 3]);
    }
    if (active) buf_pos(b, mp)[i] = mypos;
    if (b != buf && i < kNB) buf_K(b, mp)[i] = K[i];
    if (i < kNB) in_rank(cluster, dinv, dst)[k0 + i] = rcps;
    if (i == 0) buf_fail(b, mp)[0] = failed;
  }
  if (cand0) {
    float4* dst = (float4*)(As + (size_t)i * lda + lq * kNB);
#pragma unroll
    for (int q = 0; q < kNB / 4; ++q)
      dst[q] = make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
  }
}

// Phase 1's update of one warp's 8 held columns lc0 .. lc0 + 7 by a panel,
// rows k0 .. k0 + nrows - 1 by position, in passes over 4 blocks of 32 rows
// (a lane: one row of each block): the panel's pivot rows take U12 (R,
// after the solve with L11), the rows below subtract L21 U12.
__device__ __forceinline__ void apply_panel(float* As, int lda, const float* R,
                                            int LC, const float* L, int mp,
                                            const int* rowAt, int k0,
                                            int nrows, int lc0) {
  const int ln = threadIdx.x & 31;
  for (int b0 = 0; b0 < nrows; b0 += 128) {
    float acc[4][8];
    int row[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int idx = b0 + ln + 32 * r;
      row[r] = idx < nrows ? rowAt[k0 + idx] : 0;
      const float* src = idx < kNB ? R + idx * LC + lc0
                                   : As + (size_t)row[r] * lda + lc0;
      float4 v0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), v1 = v0;
      if (idx < nrows) {
        v0 = *(const float4*)src;
        v1 = *(const float4*)(src + 4);
      }
      acc[r][0] = v0.x;
      acc[r][1] = v0.y;
      acc[r][2] = v0.z;
      acc[r][3] = v0.w;
      acc[r][4] = v1.x;
      acc[r][5] = v1.y;
      acc[r][6] = v1.z;
      acc[r][7] = v1.w;
    }
    for (int t0 = 0; t0 < kNB; t0 += 4) {
      float w[4][4];  // -L of the four rows, steps t0 .. t0 + 3
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int idx = b0 + ln + 32 * r;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (idx >= kNB && idx < nrows)
          v = *(const float4*)(L + lsw(idx, t0 >> 2));
        w[r][0] = -v.x;
        w[r][1] = -v.y;
        w[r][2] = -v.z;
        w[r][3] = -v.w;
      }
#pragma unroll
      for (int dt = 0; dt < 4; ++dt) {
        const float4 r0 = *(const float4*)(R + (t0 + dt) * LC + lc0);
        const float4 r1 = *(const float4*)(R + (t0 + dt) * LC + lc0 + 4);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float wr = w[r][dt];
          acc[r][0] = fmaf(wr, r0.x, acc[r][0]);
          acc[r][1] = fmaf(wr, r0.y, acc[r][1]);
          acc[r][2] = fmaf(wr, r0.z, acc[r][2]);
          acc[r][3] = fmaf(wr, r0.w, acc[r][3]);
          acc[r][4] = fmaf(wr, r1.x, acc[r][4]);
          acc[r][5] = fmaf(wr, r1.y, acc[r][5]);
          acc[r][6] = fmaf(wr, r1.z, acc[r][6]);
          acc[r][7] = fmaf(wr, r1.w, acc[r][7]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (b0 + ln + 32 * r < nrows) {
        float* dst = As + (size_t)row[r] * lda + lc0;
        *(float4*)dst =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        *(float4*)(dst + 4) =
            make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
      }
    }
  }
}

template <bool SOLVE>
__global__ void __launch_bounds__(kLuThreads, 2)
    batched_lu_kernel(const float* __restrict__ M, long long smb,
                      long long smi, long long smj,
                      const float* __restrict__ rhs, long long srb,
                      long long sri, float* __restrict__ out, int m) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Plan pl = make_plan(m);
  const int C = pl.cl, mp = pl.mp, LC = pl.lc, lda = pl.lda;
  const int rank = (int)cluster.block_rank();
  const long long lane = blockIdx.x / C;
  const int tid = threadIdx.x, warp = tid >> 5, ln = tid & 31;

  float* As = smem;                     // [mp][lda]: the held columns
  float* buf0 = As + (size_t)mp * lda;  // two panel buffers
  float* R = buf0 + 2 * pl.bs;          // [kNB][LC]: the pivot rows
  float* Rrhs = R + kNB * LC;           // [kNB]
  float* xs = Rrhs + kNB;               // [mp]: the right-hand side
  int* rowAt = (int*)(xs + mp);         // [mp]: physical row at a position
  float* dinv = (float*)(rowAt + mp);   // [mp]: 1 / pivot at its position
  float* slot = dinv + mp;              // [2][kLuWarps][kWinFloats]

  auto sync_all = [&]() {
    if (C > 1)
      cluster.sync();
    else
      __syncthreads();
  };
  // global column of held column lc
  auto col_of = [&](int lc) {
    return ((lc >> 4) * C + rank) * kNB + (lc & (kNB - 1));
  };

  // ---- load: M's held columns, identity outside m x m ----------------------
  const float* Mb = M + lane * smb;
  if (smj == 1) {  // a warp along a row
#pragma unroll 4
    for (int i = warp; i < mp; i += kLuWarps)
      for (int lc = ln; lc < LC; lc += 32) {
        const int j = col_of(lc);
        As[(size_t)i * lda + lc] =
            i < m && j < m ? Mb[i * smi + j] : (i == j ? 1.0f : 0.0f);
      }
  } else {  // a warp down a column
#pragma unroll 4
    for (int lc = warp; lc < LC; lc += kLuWarps) {
      const int j = col_of(lc);
      for (int i = ln; i < mp; i += 32)
        As[(size_t)i * lda + lc] =
            i < m && j < m ? Mb[i * smi + j * smj] : (i == j ? 1.0f : 0.0f);
    }
  }
  if (SOLVE && rank == 0)
    for (int i = tid; i < mp; i += kLuThreads)
      xs[i] = i < m ? rhs[lane * srb + i * sri] : 0.0f;
  sync_all();  // every CTA of the cluster runs before its memory is written

  // ---- phase 1: forward elimination, panel by panel ------------------------
  const int P = mp / kNB;
  for (int p = 0; p < P; ++p) {
    float* buf = buf0 + (p & 1) * pl.bs;
    const int k0 = p * kNB;
    if (rank == p % C) {
      const float* prev = p > 0 ? buf0 + ((p - 1) & 1) * pl.bs : nullptr;
      factor_panel(cluster, pl, As, p / C, k0, prev, buf, dinv, slot);
    }
    sync_all();  // the panel is in every CTA

    const float* L = buf;
    const int* K = buf_K(buf, mp);
    const int* pos = buf_pos(buf, mp);
    for (int i = tid; i < mp; i += kLuThreads) rowAt[pos[i]] = i;
    for (int t = warp; t < kNB; t += kLuWarps) {
      const float* src = As + (size_t)K[t] * lda;
      for (int lc = ln; lc < LC; lc += 32) R[t * LC + lc] = src[lc];
    }
    if (SOLVE && rank == 0 && tid < kNB) Rrhs[tid] = xs[K[tid]];
    __syncthreads();
    // the pivot rows' new values U12 = L11^-1 R, a column a thread
    if (tid <= LC && (tid < LC || (SOLVE && rank == 0))) {
      float* col = tid < LC ? R + tid : Rrhs;
      const int ld = tid < LC ? LC : 1;
      float v[kNB];
#pragma unroll
      for (int t = 0; t < kNB; ++t) v[t] = col[t * ld];
#pragma unroll
      for (int t = 1; t < kNB; ++t)
#pragma unroll
        for (int s2 = 0; s2 < t; ++s2)
          v[t] = fmaf(-L[lsw(t, s2 >> 2) + (s2 & 3)], v[s2], v[t]);
#pragma unroll
      for (int t = 1; t < kNB; ++t) col[t * ld] = v[t];
    }
    __syncthreads();

    // the panel applied to the held columns, rows k0 .. mp - 1 by position
    // (apply_panel), and to the right-hand side
    const int nrows = mp - k0;
    if (warp < LC / 8) {
      const int lc0 = warp * 8;
      const int gp = (lc0 / kNB) * C + rank;  // this warp's panel
      if (gp != p && !(SOLVE && gp < p)) {
        apply_panel(As, lda, R, LC, L, mp, rowAt, k0, nrows, lc0);
      }
    }
    if (SOLVE && rank == 0) {
      for (int idx = tid; idx < nrows; idx += kLuThreads) {
        const int i = rowAt[k0 + idx];
        float acc = Rrhs[idx < kNB ? idx : 0];
        if (idx >= kNB) {
          acc = xs[i];
#pragma unroll
          for (int t = 0; t < kNB; ++t)
            acc = fmaf(-L[lsw(idx, t >> 2) + (t & 3)], Rrhs[t], acc);
        }
        xs[i] = acc;
      }
    }
    __syncthreads();
  }
  sync_all();  // phase 1 done in every CTA: its buffers are free

  // ---- phase 2: X = U^-1 T by row blocks, bottom up (T unit lower: its
  // diagonal, where U's pivots are kept, is implicit) ------------------------
  // G[l * kNB + t] = U[k0 + t][l] for the columns l >= k0 of row block K
  for (int kb = P - 1; kb >= 0; --kb) {
    const int k0 = kb * kNB;
    float* G = buf0 + (kb & 1) * pl.bs;
    // a thread: four rows of the block in one held column, as one float4
    for (int e = tid; e < 4 * LC; e += kLuThreads) {
      const int tq = e / LC, lc = e - tq * LC;
      const int l = col_of(lc);
      if (l < k0) continue;
      float4 v;
      v.x = As[(size_t)rowAt[k0 + 4 * tq] * lda + lc];
      v.y = As[(size_t)rowAt[k0 + 4 * tq + 1] * lda + lc];
      v.z = As[(size_t)rowAt[k0 + 4 * tq + 2] * lda + lc];
      v.w = As[(size_t)rowAt[k0 + 4 * tq + 3] * lda + lc];
      for (int dst = SOLVE ? 0 : C - 1; dst >= 0; --dst)
        *(float4*)(in_rank(cluster, G, dst) + l * kNB + 4 * tq) = v;
    }
    sync_all();  // row block K's part of U is in every CTA that needs it

    if (!SOLVE && 2 * warp < LC / 4) {
      // lane: rows 4 tg .. 4 tg + 3 of the block x columns 4 cg .. 4 cg + 3,
      // over the rows l below the block with l = k0 + kNB + part (mod 4)
      const int part = ln >> 3, tg = (ln >> 1) & 3, cg = 2 * warp + (ln & 1);
      const int j0 = col_of(4 * cg);  // the columns' first global index
      float acc[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = 4 * tg + q;
        const float4 v =
            *(const float4*)(As + (size_t)rowAt[k0 + t] * lda + 4 * cg);
        const float vc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + c;
          acc[q][c] = part != 0 ? 0.0f
                                : (j < k0 + t ? vc[c]
                                              : (j == k0 + t ? 1.0f : 0.0f));
        }
      }
#pragma unroll 4
      for (int l = k0 + kNB + part; l < mp; l += 4) {
        const float4 x =
            *(const float4*)(As + (size_t)rowAt[l] * lda + 4 * cg);
        const float4 g = *(const float4*)(G + l * kNB + 4 * tg);
        const float xc[4] = {x.x, x.y, x.z, x.w};
        const float gq[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[q][c] = fmaf(-gq[q], xc[c], acc[q][c]);
      }
      // the four parts' sums, the same in every part's lanes
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[q][c] += __shfl_xor_sync(lp::kFullMask, acc[q][c], 8);
          acc[q][c] += __shfl_xor_sync(lp::kFullMask, acc[q][c], 16);
        }
      // the block's own triangle, bottom up: x_t = acc_t / U_tt, then the
      // rows above it take -U[t'][t] x_t
#pragma unroll
      for (int t = kNB - 1; t >= 0; --t) {
        const float d = dinv[k0 + t];
        if (tg == t >> 2)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[t & 3][c] *= d;
        const int src = (ln & 0x19) | ((t >> 2) << 1);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float x = __shfl_sync(lp::kFullMask, acc[t & 3][c], src);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (4 * tg + q < t)
              acc[q][c] = fmaf(-G[(k0 + t) * kNB + 4 * tg + q], x, acc[q][c]);
        }
      }
      if (part == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          *(float4*)(As + (size_t)rowAt[k0 + 4 * tg + q] * lda + 4 * cg) =
              make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
      }
    }
    if (SOLVE && rank == 0 && warp == 0) {
      // lane: row t = ln & 15 of the block, every other row below
      const int t = ln & 15, half = ln >> 4;
      float acc = half == 0 ? xs[rowAt[k0 + t]] : 0.0f;
      for (int l = k0 + kNB + half; l < mp; l += 2)
        acc = fmaf(-G[l * kNB + t], xs[rowAt[l]], acc);
      acc += __shfl_xor_sync(lp::kFullMask, acc, 16);
#pragma unroll
      for (int s = kNB - 1; s >= 0; --s) {
        if (t == s) acc *= dinv[k0 + s];
        const float x = __shfl_sync(lp::kFullMask, acc, s);
        if (t < s) acc = fmaf(-G[(k0 + s) * kNB + t], x, acc);
      }
      if (ln < kNB) xs[rowAt[k0 + ln]] = acc;
    }
  }
  // no CTA touches another's memory past the last block's barrier
  __syncthreads();

  // ---- out: row k is physical row p_k; the column of held column lc (step
  // j) is p_j. The inverse goes out as torch.linalg's does, each matrix
  // column-major, so a CTA writes whole output columns from its own memory.
  float* last = buf0 + ((P - 1) & 1) * pl.bs;
  const bool fail = buf_fail(last, mp)[0] != 0;
  const float nan = __int_as_float(0x7fc00000);
  if (SOLVE) {
    if (rank == 0)
      for (int k = tid; k < m; k += kLuThreads)
        out[lane * m + k] = fail ? nan : xs[rowAt[k]];
  } else {
    float* ob = out + lane * m * (long long)m;
#pragma unroll 2
    for (int lc = warp; lc < LC; lc += kLuWarps) {
      const int j = col_of(lc);
      if (j >= m) continue;
      float* dst = ob + (long long)rowAt[j] * m;
      for (int k = ln; k < m; k += 32)
        dst[k] = fail ? nan : As[(size_t)rowAt[k] * lda + lc];
    }
  }
}

}  // namespace

// CTAs a lane and shared-memory bytes a CTA at this m (0), or a CUDA error.
extern "C" int lp_batched_lu_plan(int m, int* cluster, long long* smem) {
  if (m < 1 || m > kMaxM) return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(m);
  *cluster = pl.cl;
  *smem = (long long)smem_bytes(pl);
  return 0;
}

// rhs null: out[B, m, m] = M^-1 a lane, each matrix column-major (strides
// m * m, 1, m); else out[B, m] (contiguous) = M^-1 rhs. M [B, m, m] and
// rhs [B, m] at any strides.
extern "C" int lp_batched_lu(const float* M, long long smb, long long smi,
                             long long smj, const float* rhs, long long srb,
                             long long sri, float* out, int B, int m,
                             void* stream) {
  if (B < 1 || m < 1 || m > kMaxM || M == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(m);
  const size_t smem = smem_bytes(pl);
  const cudaStream_t s = (cudaStream_t)stream;
  if (rhs != nullptr)
    return lpc::launch<kLuThreads>(batched_lu_kernel<true>, pl.cl, B, smem, s,
                                   M, smb, smi, smj, rhs, srb, sri, out, m);
  return lpc::launch<kLuThreads>(batched_lu_kernel<false>, pl.cl, B, smem, s,
                                 M, smb, smi, smj, (const float*)nullptr, 0LL,
                                 0LL, out, m);
}
