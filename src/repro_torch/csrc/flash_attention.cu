// Flash-attention forward: the Hopper port of the Pallas kernel
// `flash_attention_pallas` (src/repro/kernels/flash_attention/
// flash_attention.py:79, pallas_call :90).
//
// What it computes. Causal (or full) grouped-query attention:
// q (B, S, KV, G, hd), k / v (B, S, KV, hd) -> o (B, S, KV, G, hd), f32 or
// bf16, with the reference kernel's numerics: scores (q . k) * scale in f32
// on the f32 values of the inputs, an online softmax in f32 (running max
// from NEG_INF = finfo(f32).min, masked scores NEG_INF), P and V rounded to
// bf16 (round to nearest even) for P . V with f32 accumulation, l summed
// from the unrounded p, and o = acc / max(l, 1e-30) rounded to the input
// type. S need not be a multiple of any block (the reference asserts it).
//
// Bound. Operations: 4 hd flops a (query head, visible key) pair, half the
// S^2 pairs when causal. At the prefill shape (B 8, S 2048, KV 8, G 4,
// hd 128, bf16, causal) that is 274.9 GFLOP, 0.278 ms at the card's
// 989 TFLOP/s bf16 peak, against 335.5 MB of q, k, v and o (0.100 ms at
// 3.35 TB/s): bound by operations, and only wgmma reaches the tensor
// cores' full rate.
//
// Design. The Pallas grid walks the kv blocks of a q block in sequence
// with its accumulators in VMEM. Here one block owns a tile of 128 rows, a
// row being a (query position, query head) pair of one (b, kv):
// 128 / G positions times all G heads of that KV head (the rows in use are
// (128 / G) * G when G does not divide 128), so every K and V tile it loads
// serves the G heads at once; past 64 heads the G heads split into
// balanced chunks of at most 64 (Falcon-7B's 71: 36 + 35, 3 positions x 36
// = 108 rows), one block a chunk, each loading the same K / V tiles (the
// rereads come from L2). Each body is built at the widths 16, 32, 64, 128,
// 192 and 256 and runs a head dim (a multiple of 8; the wrappers pass any
// other as a zero-padded copy) at the first that holds it: the columns
// past hd are zeros, the scale is the true hd's. It walks the key tiles up to the diagonal
// (skipping those above it), masks only where a tile crosses the diagonal
// or the end of S, and runs the heaviest (last) causal q tiles first. Two
// bodies share that schedule:
//  * bf16: flash_fwd_wgmma_kernel, a
//    warp-specialised block of three warpgroups. One producer thread
//    issues TMA loads (cp.async.bulk.tensor) of Q once and of the K and V
//    tiles into a ring in shared memory (3 stages of 64-key tiles; 32-key
//    tiles past width 128, whose consumers hold HD / 2 accumulators), with
//    full and empty mbarriers, 128-byte swizzled (2 stages at width 256,
//    whose 3 would take 256 KB); q is a 5-D tensor map {hd, G, KV, S, B}
//    and k / v 4-D maps {hd, KV, S, B}, so a ragged tile past S, and the
//    columns past hd, are zero-filled by the hardware and never read the
//    next sequence or row (widths 64 to 256 take one to four 64-column
//    boxes a row; a row of width 32 or 16 is one 64- or 32-byte box, 64- or
//    32-byte swizzled, read through descriptors of layout B64 or B32:
//    HD / 16 k-steps in Q . K^T, wgmma N = HD in P . V up to 128, pieces of
//    N = 128 and 64 past it). Two consumer warpgroups own 64 rows each (setmaxnreg
//    gives them the producer's registers): S = Q . K^T is wgmma m64nKNk16
//    with both operands in shared memory (products of bf16 values are exact
//    in f32, so the scores are the reference's f32 scores); the online
//    softmax runs in registers in the log2 domain, scale * log2(e) folded
//    into one multiply, exponentials on ex2.approx; P is rounded to bf16 in
//    registers and O += P . V is wgmma with P from registers and V read in
//    its natural [keys][hd] layout through the descriptor's transpose. A
//    consumer issues S_t and P_{t-1} . V_{t-1} together and takes the
//    softmax of S_t while the second product runs; a K stage is released
//    when its S is done, a V stage when its product is. The two consumers
//    take turns to issue (two named barriers: FA3's ping-pong), so one's
//    softmax runs under the other's products.
//  * f32 (the same widths): flash_fwd_kernel, scalar f32 FMAs on
//    the same rounded values over 64-row tiles and 64-key tiles: Q (and K)
//    transposed, V and P in shared memory as f32, each thread a 4 x 8
//    block of scores and a 4 x (hd / 8) block of the output, read in
//    16-byte vectors (8-byte ones at hd 16) laid out so that a quarter
//    warp hits distinct banks. Q . K^T of f32 inputs cannot take bf16
//    operands. The REDUCED configs and the examples' generators are f32:
//    their chunked prefills run this kernel.
// A row past 256 columns runs as column pieces (`attn::piece_cols`: at
// most 128 columns in bf16, 256 in f32), one block a piece beside the head
// chunks: every piece scores with the whole row, taken 64 columns at a
// time, and writes only its own columns of the output, so no consumer
// holds more than a piece's accumulators (bf16: flash_fwd_deep_kernel at
// width 128; f32: the scalar body's DEEP instantiation at 192 or 256).

#include <cmath>

#include "attention.cuh"

namespace {

using attn::kNegInf;

constexpr int kThreads = 128;
constexpr int kRows = 64;  // rows (query position, head) a block
constexpr int kKeys = 64;  // keys a tile

constexpr int kChunk = 64;  // columns of Q and K a chunk past width 256

// Shared memory of the f32 body: Q and K transposed (the whole width HD,
// or past 256 one chunk of kChunk columns at a time), V [keys][HD] and
// Pt [keys][rows]. 112 KB at width 256 either way.
template <int HD, bool DEEP>
constexpr size_t smem_bytes() {
  constexpr size_t QK = DEEP ? kChunk : HD;
  return sizeof(float) * (QK * kRows +                       // Qt [QK][rows]
                          QK * kKeys +                       // Kt [QK][keys]
                          static_cast<size_t>(kKeys) * HD +  // V  [keys][HD]
                          static_cast<size_t>(kKeys) * kRows);  // Pt [keys][rows]
}

// Blocks run at a built width HD >= hd (`launch_width`): a row's hd
// columns come from device memory, the rest of its HD columns are zeros in
// shared memory (they add exact zeros to Q . K^T) and the epilogue writes
// only the hd columns. A block takes the heads [g0, g0 + GC) of one KV head
// (head chunk `blockIdx.x % n_gc`, `head_chunks`): kRows / GC positions of
// GC heads each, heads past G being zero rows it never writes. EXACT
// (hd == HD, one chunk of all G heads: every served shape but the wide
// ones) fixes hd, GC and n_gc when compiling, so that code carries no
// column or chunk arithmetic. DEEP (a row past 256: `attn::piece_cols`,
// pieces of 136 to 256 columns in f32)
// runs one column piece of pw columns a block, piece blockIdx.x % n_pc
// beside the head chunks: the scores take the whole row of hd columns in
// chunks of kChunk (Q and K read again every key tile, from L2), P . V and
// the epilogue the piece's columns [p0, p0 + pw) only, at width HD >= pw.
template <typename T, int HD, bool EXACT, bool DEEP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int KV,
                 int G, int hd_arg, int gc_arg, int n_gc_arg, int pw_arg,
                 int n_pc_arg, int causal, float scale) {
  static_assert(!(EXACT && DEEP), "a piece is never the whole row");
  const int hd = EXACT ? HD : hd_arg;
  const int GC = EXACT ? G : gc_arg, n_gc = EXACT ? 1 : n_gc_arg;
  const int n_pc = DEEP ? n_pc_arg : 1;
  constexpr int QK = DEEP ? kChunk : HD;  // columns of Qt and Kt
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int CH = HD / VEC;   // 16-byte chunks a row
  // the 8 threads of a row group split a row's HD output columns into
  // DJ runs of CW: float4s 32 columns apart, or at hd 16 one float2 each
  constexpr int CW = HD >= 32 ? 4 : HD / 8;
  constexpr int DJ = HD / (8 * CW);
  static_assert(CW * 8 * DJ == HD && (CW == 4 || CW == 2), "column split");
  const int ch_live = hd / VEC;  // chunks of a row in device memory
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Kt = Qt + QK * kRows;
  float* Vs = Kt + QK * kKeys;
  float* Pt = Vs + kKeys * HD;

  const int BQ = kRows / GC;     // query positions a tile
  const int R = BQ * GC;         // rows in use
  // heaviest causal tiles first, the head chunks (and pieces) of a tile
  // side by side
  const int rev = gridDim.x - 1 - blockIdx.x;
  const int pc = DEEP ? rev % n_pc : 0, rq = DEEP ? rev / n_pc : rev;
  const int qt = rq / n_gc, g0 = rq % n_gc * GC;
  // this block's output columns: [p0, p0 + pw_live) of the row
  const int p0 = DEEP ? pc * pw_arg : 0;
  const int pw_live = DEEP ? min(pw_arg, hd - p0) : hd;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, tr = tid / 8, tc = tid % 8;

  const size_t q_row = static_cast<size_t>(KV) * G * hd;  // one position
  const size_t k_row = static_cast<size_t>(KV) * hd;
  const T* qb = q + static_cast<size_t>(b) * S * q_row +
                (static_cast<size_t>(kv) * G + g0) * hd;
  const T* kb = k + static_cast<size_t>(b) * S * k_row +
                static_cast<size_t>(kv) * hd;
  const T* vb = v + static_cast<size_t>(b) * S * k_row +
                static_cast<size_t>(kv) * hd;

  // the Q tile, transposed: Qt[d][r], row r = (position r / GC, head
  // g0 + r % GC); past width 256 the kChunk columns from c0
  auto load_q = [&](int c0, int nch) {
    for (int idx = tid; idx < kRows * nch; idx += kThreads) {
      const int r = idx % kRows, ch = idx / kRows;
      const int p = r / GC, g = r % GC;
      float x[VEC];
      if (r < R && q0 + p < S && g0 + g < G && c0 / VEC + ch < ch_live) {
        attn::load_vec(qb + static_cast<size_t>(q0 + p) * q_row + g * hd +
                       c0 + ch * VEC, x);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) Qt[(ch * VEC + e) * kRows + r] = x[e];
    }
  };
  // keys k0.. of K transposed, columns c0.. (consecutive threads on
  // consecutive keys: no bank conflict on the transposed stores)
  auto load_k = [&](int k0, int c0, int nch) {
    for (int idx = tid; idx < kKeys * nch; idx += kThreads) {
      const int c = idx % kKeys, ch = idx / kKeys;
      float x[VEC];
      if (k0 + c < S && c0 / VEC + ch < ch_live) {
        attn::load_vec(kb + static_cast<size_t>(k0 + c) * k_row + c0 +
                       ch * VEC, x);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) Kt[(ch * VEC + e) * kKeys + c] = x[e];
    }
  };
  // Q . K^T of the columns in Qt / Kt into s: rows tr*4 + i, keys tc*4 + e
  // and 32 + tc*4 + e
  auto qk = [&](float (&s)[4][8]) {
#pragma unroll 4
    for (int d = 0; d < QK; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * kRows + tr * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Kt + d * kKeys + tc * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Kt + d * kKeys + 32 + tc * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
  };
  if constexpr (!DEEP) load_q(0, CH);

  int pos[4];  // query position of each of this thread's rows
#pragma unroll
  for (int i = 0; i < 4; ++i) pos[i] = q0 + (tr * 4 + i) / GC;
  float m_r[4], l_r[4], acc[4][DJ][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
#pragma unroll
      for (int e = 0; e < CW; ++e) acc[i][j][e] = 0.f;
  }

  const int p_last = min(S, q0 + BQ) - 1;  // last live position of the tile
  const int n_tiles = causal ? p_last / kKeys + 1 : (S + kKeys - 1) / kKeys;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kKeys;
    __syncthreads();  // the previous tile's Kt, V and Pt are consumed
    // K transposed, V as is (coalesced; past width 256 the piece's HD
    // columns from p0), V and later P rounded to bf16 as the reference's
    // P . V takes them
    if constexpr (!DEEP) load_k(k0, 0, CH);
    for (int idx = tid; idx < kKeys * CH; idx += kThreads) {
      const int ch = idx % CH, c = idx / CH;
      float x[VEC];
      if (k0 + c < S && p0 / VEC + ch < ch_live) {
        attn::load_vec(vb + static_cast<size_t>(k0 + c) * k_row + p0 +
                       ch * VEC, x);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        Vs[c * HD + ch * VEC + e] = attn::round_bf16(x[e]);
    }
    __syncthreads();

    // scores: rows tr*4 + i, keys tc*4 + e and 32 + tc*4 + e; past width
    // 256 over the row's chunks of kChunk columns
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    if constexpr (DEEP) {
      for (int c0 = 0; c0 < hd; c0 += kChunk) {
        __syncthreads();  // the previous chunk's Qt and Kt are consumed
        load_q(c0, kChunk / VEC);
        load_k(k0, c0, kChunk / VEC);
        __syncthreads();
        qk(s);
      }
    } else {
      qk(s);
    }

    // online softmax; the 8 threads of a row group are 8 consecutive lanes
    const bool edge = k0 + kKeys > S || (causal && k0 + kKeys - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = k0 + (j < 4 ? tc * 4 + j : 32 + tc * 4 + j - 4);
        float x = s[i][j] * scale;
        if (edge && (c >= S || (causal && c > pos[i]))) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_r[i], mx);
      const float alpha = expf(m_r[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        s[i][j] = attn::round_bf16(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l_r[i] = l_r[i] * alpha + sum;
      m_r[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j)
#pragma unroll
        for (int e = 0; e < CW; ++e) acc[i][j][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j < 4 ? tc * 4 + j : 32 + tc * 4 + j - 4;
      *reinterpret_cast<float4*>(Pt + c * kRows + tr * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // P . V: rows tr*4 + i, dims j*8*CW + tc*CW + e
    // keys past S, or past the tile's last position when causal, have p = 0
    const int c_end = min(kKeys, (causal ? p_last + 1 : S) - k0);
    for (int c = 0; c < c_end; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(Pt + c * kRows + tr * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float* vp = Vs + c * HD + j * 8 * CW + tc * CW;
        float wv[CW];
        if constexpr (CW == 4) {
          const float4 w = *reinterpret_cast<const float4*>(vp);
          wv[0] = w.x;
          wv[1] = w.y;
          wv[2] = w.z;
          wv[3] = w.w;
        } else {
          const float2 w = *reinterpret_cast<const float2*>(vp);
          wv[0] = w.x;
          wv[1] = w.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < CW; ++e) acc[i][j][e] = fmaf(av[i], wv[e], acc[i][j][e]);
      }
    }
  }

  // o = acc / max(l, 1e-30), rows in use, heads below G, positions inside
  // S and the hd columns only (hd is a multiple of 8, so a run of CW
  // columns lies wholly inside or outside)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    const int p = r / GC, g = r % GC;
    if (r >= R || q0 + p >= S || (!EXACT && g0 + g >= G)) continue;
    const float den = fmaxf(l_r[i], 1e-30f);
    T* orow = o + (static_cast<size_t>(b) * S + q0 + p) * q_row +
              (static_cast<size_t>(kv) * G + g0 + g) * hd + p0;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = j * 8 * CW + tc * CW;
      if (c >= pw_live) continue;
#pragma unroll
      for (int e = 0; e < CW; ++e)
        attn::from_float(acc[i][j][e] / den, orow + c + e);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs: a TMA ring feeding wgmma, warp-specialised
// ---------------------------------------------------------------------------

namespace tma {

using attn::mbar_arrive;
using attn::mbar_expect_tx;
using attn::mbar_init;
using attn::mbar_wait;
using attn::smem_u32;
using attn::tma_load_4d;
using attn::tma_load_5d;

constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kWgRows = 64;                        // rows a consumer: wgmma M
constexpr int kTileRows = kConsumers * kWgRows;    // rows a block
constexpr int kThreads = (kConsumers + 1) * 128;   // + the producer warpgroup
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// Shared memory, each region 1024-byte aligned (the 128-byte swizzle's
// period, a multiple of the 64- and 32-byte swizzles'): Q [kBoxes][128
// rows][kBox], the K ring and the V ring [kStages][kBoxes][KN rows][kBox],
// then the mbarriers full_q, full_k[kStages], full_v[kStages],
// empty_k[kStages], empty_v[kStages]. A row lies in swizzled lines of
// kLine bytes: widths 64 to 256 in one to four 128-byte lines (TMA's and
// wgmma's 128-byte swizzle), 32 and 16 in one 64- or 32-byte line (the
// 64- and 32-byte swizzles), so a line never holds parts of two rows. At
// width 256 Q takes 64 KB and a stage of K and V 64 KB: two stages fit the
// 227 KB a block may use, three (256 KB) do not.
template <int HD, int KN>
struct Layout {
  static constexpr int kLine = HD * 2 < 128 ? HD * 2 : 128;  // swizzle span
  static constexpr int kBox = kLine / 2;                 // bf16 columns a box
  static constexpr int kBoxes = HD / kBox;               // boxes a row
  static constexpr int kStages = HD > 192 ? 2 : 3;       // ring depth
  static constexpr int kTileBytes = kBoxes * KN * kLine;  // a K or V tile
  static constexpr int kK = kBoxes * kTileRows * kLine;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;
  static constexpr int kSmem = kBars + 8 * (1 + 4 * kStages) + 1024;
  static_assert((kLine == 128 && HD % 64 == 0) || kLine == 64 ||
                    kLine == 32,
                "widths 16, 32 and multiples of 64");
  static_assert(kSmem <= 232448, "a block's shared memory");
  static_assert(kTileBytes % 1024 == 0, "regions stay 1024-byte aligned");
};

// wgmma and its descriptors: attention.cuh (shared with the decode kernel)
using attn::desc_sw;
using attn::fast_exp2;
using attn::fence_regs;
using attn::issue_pv;
using attn::pack_p;
using attn::pack_bf16;
using attn::wgmma_commit;
using attn::wgmma_fence;
using attn::wgmma_rs;
using attn::wgmma_ss_n32;
using attn::wgmma_ss_n64;
using attn::wgmma_wait;

// The consumers' ping-pong: named barrier 1 + w is consumer warpgroup w's
// turn to issue its products; the other warpgroup arrives on it once it
// has issued its own. So the two issue in alternation and one's softmax
// runs while the other's products occupy the tensor cores.
__device__ __forceinline__ void wait_turn(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void pass_turn(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

}  // namespace tma

// The online softmax of one key tile k0.. in the log2 domain: the raw
// scores masked only on an edge tile, the rows' max over the quad of lanes
// that holds a row, scaled by c = scale * log2(e) into the running max m;
// sc replaced by p = exp2(s c - m) (one FFMA and ex2.approx), l = l * alpha
// + (this thread's sum of the unrounded p; the quad's sum is taken at the
// end); returns the alphas. A row's first tile always holds a live key
// (key 0), so a masked score's p is exp2(-huge) = 0.
template <int KN>
__device__ __forceinline__ void online_softmax(
    float (&sc)[KN / 2], int k0, bool edge, int S, int causal, int pos0,
    int pos1, int tig, float scale_log2, float& m0, float& m1, float& l0,
    float& l1, float& al0, float& al1) {
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < KN / 2; ++j) {
    if (edge) {
      const int c = k0 + (j / 4) * 8 + tig * 2 + (j & 1);
      if (c >= S || (causal && c > ((j & 2) ? pos1 : pos0))) sc[j] = kNegInf;
    }
    if (j & 2) mx1 = fmaxf(mx1, sc[j]); else mx0 = fmaxf(mx0, sc[j]);
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0 * scale_log2);
  const float mn1 = fmaxf(m1, mx1 * scale_log2);
  al0 = tma::fast_exp2(m0 - mn0);
  al1 = tma::fast_exp2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < KN / 2; ++j) {
    const float p =
        tma::fast_exp2(fmaf(sc[j], scale_log2, (j & 2) ? -mn1 : -mn0));
    if (j & 2) sum1 += p; else sum0 += p;
    sc[j] = p;
  }
  l0 = l0 * al0 + sum0;
  l1 = l1 * al1 + sum1;
}

// One block: 128 rows (position, head) of one (b, kv) -- kTileRows / GC
// positions of the GC heads [g0, g0 + GC) of head chunk blockIdx.x % n_gc
// -- three warpgroups, built at a width HD >= hd (`launch_width`): the
// tensor maps' inner dimension is hd, so TMA fills the columns past it
// with zeros and the epilogue writes hd columns.
// Warpgroup 2 is the producer (one thread issues every TMA load);
// warpgroups 0 and 1 are the consumers, 64 rows each. A consumer thread
// holds rows r0 = 64 wg + 16 warp + lane / 4 and r1 = r0 + 8: the wgmma
// accumulator layout, element j of a row's accumulators being column
// 8 (j / 4) + 2 (lane % 4) + (j % 2) of row (j & 2 ? r1 : r0). A consumer
// pipelines its tiles: it issues S_t = Q . K_t^T and O += P_{t-1} . V_{t-1}
// together, takes the softmax of S_t while the second product runs, then
// rescales O and packs P_t; K_t's stage is released as soon as S_t is
// done, V_{t-1}'s when its product is. EXACT as in flash_fwd_kernel.
template <int HD, int KN, bool EXACT>
__global__ void __launch_bounds__(tma::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       __nv_bfloat16* __restrict__ o, int S, int KV, int G,
                       int hd_arg, int gc_arg, int n_gc_arg, int causal,
                       float scale_log2) {
  using namespace tma;
  const int hd = EXACT ? HD : hd_arg;
  const int GC = EXACT ? G : gc_arg, n_gc = EXACT ? 1 : n_gc_arg;
  using Lt = Layout<HD, KN>;
  constexpr int NS = Lt::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + Lt::kK, sv = sq + Lt::kV;
  const uint32_t full_q = sq + Lt::kBars;
  const uint32_t full_k = full_q + 8, full_v = full_k + 8 * NS;
  const uint32_t empty_k = full_v + 8 * NS, empty_v = empty_k + 8 * NS;

  const int BQ = kTileRows / GC, R = BQ * GC;
  // heaviest causal tiles first, the head chunks of a tile side by side
  const int rev = gridDim.x - 1 - blockIdx.x;
  const int qt = rev / n_gc, g0 = rev % n_gc * GC;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int p_last = min(S, q0 + BQ) - 1;  // last live position of the tile
  const int n_tiles = causal ? p_last / KN + 1 : (S + KN - 1) / KN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, kConsumers * 4);  // one arrival a warp
      mbar_init(empty_v + 8 * s, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: Q once, then K and V tiles through the ring ----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(full_q, Lt::kBoxes * R * Lt::kLine);
#pragma unroll
      for (int h = 0; h < Lt::kBoxes; ++h)
        tma_load_5d(sq + h * kTileRows * Lt::kLine, &qmap, full_q,
                    h * Lt::kBox, g0, kv, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % NS;
        // the consumers released this stage's previous K (then V) tile
        const uint32_t parity = (t / NS - 1) & 1;
        const uint32_t kt = sk + s * Lt::kTileBytes;
        const uint32_t vt = sv + s * Lt::kTileBytes;
        if (t >= NS) mbar_wait(empty_k + 8 * s, parity);
        mbar_expect_tx(full_k + 8 * s, Lt::kTileBytes);
#pragma unroll
        for (int h = 0; h < Lt::kBoxes; ++h)
          tma_load_4d(kt + h * KN * Lt::kLine, &kmap, full_k + 8 * s,
                      h * Lt::kBox, kv, t * KN, b);
        if (t >= NS) mbar_wait(empty_v + 8 * s, parity);
        mbar_expect_tx(full_v + 8 * s, Lt::kTileBytes);
#pragma unroll
        for (int h = 0; h < Lt::kBoxes; ++h)
          tma_load_4d(vt + h * KN * Lt::kLine, &vmap, full_v + 8 * s,
                      h * Lt::kBox, kv, t * KN, b);
      }
    }
  } else {
    // ---- consumers: 64 rows each ----------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int tig = lane % 4;
    const int r0 = wg * kWgRows + warp * 16 + lane / 4, r1 = r0 + 8;
    const int pos0 = q0 + r0 / GC, pos1 = q0 + r1 / GC;
    const uint32_t q_rows = sq + wg * kWgRows * Lt::kLine;  // this group's Q
    float acc[HD / 2], sc[KN / 2];
    uint32_t pa[KN / 16][4];
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) acc[j] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, al0, al1;

    // tile 0: its scores and softmax (O is zero: nothing to rescale);
    // warpgroup 0 takes the first turn
    if (wg == 1) pass_turn(wg);
    mbar_wait(full_q, 0);
    mbar_wait(full_k, 0);
    wait_turn(wg);
    wgmma_fence();
    attn::issue_scores<HD, KN, tma::kTileRows>(sc, q_rows, sk);
    pass_turn(wg);
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(empty_k);
    online_softmax<KN>(sc, 0, KN > S || (causal && KN - 1 > q0), S, causal,
                       pos0, pos1, tig, scale_log2, m0, m1, l0, l1, al0, al1);
    pack_p<KN>(sc, pa);
    for (int t = 1; t < n_tiles; ++t) {
      const int s = t % NS, sp = (t - 1) % NS;
      const int k0 = t * KN;
      mbar_wait(full_k + 8 * s, (t / NS) & 1);
      mbar_wait(full_v + 8 * sp, ((t - 1) / NS) & 1);
      wait_turn(wg);
      wgmma_fence();
      attn::issue_scores<HD, KN, tma::kTileRows>(sc, q_rows,
                                                 sk + s * Lt::kTileBytes);
      issue_pv<HD, KN>(acc, pa, sv + sp * Lt::kTileBytes);
      pass_turn(wg);
      wgmma_wait<1>();  // S_t is done, P_{t-1} . V_{t-1} may still run
      fence_regs(sc);
      if (lane == 0) mbar_arrive(empty_k + 8 * s);
      online_softmax<KN>(sc, k0, k0 + KN > S || (causal && k0 + KN - 1 > q0),
                         S, causal, pos0, pos1, tig, scale_log2, m0, m1, l0,
                         l1, al0, al1);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(empty_v + 8 * sp);
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) acc[j] *= (j & 2) ? al1 : al0;
      pack_p<KN>(sc, pa);
    }
    const int sl = (n_tiles - 1) % NS;
    mbar_wait(full_v + 8 * sl, ((n_tiles - 1) / NS) & 1);
    fence_regs(acc);
    wait_turn(wg);
    wgmma_fence();
    issue_pv<HD, KN>(acc, pa, sv + sl * Lt::kTileBytes);
    if (wg == 0) pass_turn(wg);  // the turns balance: n_tiles + 1 each
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);

    // o = acc / max(l, 1e-30), rows in use, heads below G, positions
    // inside S and the hd columns only
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? r1 : r0;
      const int p = r / GC, g = g0 + r % GC;
      if (r >= R || q0 + p >= S || (!EXACT && g >= G)) continue;
      const float den = fmaxf(h ? l1 : l0, 1e-30f);
      __nv_bfloat16* orow =
          o + ((static_cast<size_t>(b) * S + q0 + p) * KV + kv) * G * hd +
          static_cast<size_t>(g) * hd;
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb) {
        if (nb * 8 < hd) {
          const __nv_bfloat162 y = __floats2bfloat162_rn(
              acc[4 * nb + 2 * h] / den, acc[4 * nb + 2 * h + 1] / den);
          *reinterpret_cast<__nv_bfloat162*>(orow + nb * 8 + tig * 2) = y;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 rows past 256: column pieces, Q and K streamed in 64-column chunks
// ---------------------------------------------------------------------------

// Shared memory of a bf16 row past 256, for a row of NC 64-column chunks
// and pieces of width HD = 128 (64-key tiles: a consumer holds 64
// accumulators, 32 scores and 16 P registers, and spills nothing; pieces
// of 256 spilled 320 bytes and ran 2.9x slower at hd 512, PERF.md). Q . K^T
// takes a chunk at a time: four k-steps over one 128-byte line of 128 Q
// rows (16 KB) and of KN key rows. Two layouts:
//  * QRES (Q resident): Q's NC chunks once [NC][128 rows][128 bytes], a
//    ring of kSStages = 8 K chunks of KN * 128 bytes, a ring of 2 V tiles
//    of the piece's HD columns ([HD / 64 boxes][KN rows][128 bytes], the
//    layout `issue_pv` reads), then the mbarriers: 16 NC KB + 64 KB + 32 KB
//    + 1.2 KB, 225 KB at hd 512, the widest row it fits (227 KB a block).
//  * streamed (wider rows): a score stage is one chunk of the tile's Q
//    rows and of the key tile's K rows (24 KB), a ring of 4 of them, the
//    same V ring: 129 KB for any hd, Q read again from L2 every key tile
//    and piece (at hd 1024, 8 pieces: 256 KB of Q against 128 KB of K and
//    16 KB of V a key tile and piece).
// `deep_resident` picks QRES wherever it fits.
template <int HD, int KN, bool QRES>
struct DeepLayout {
  static constexpr int kQBytes = tma::kTileRows * 128;     // a Q chunk
  static constexpr int kKBytes = KN * 128;                 // a K chunk
  static constexpr int kSBytes = QRES ? kKBytes : kQBytes + kKBytes;
  static constexpr int kSStages = QRES ? 8 : 4;
  static constexpr int kVBytes = (HD / 64) * KN * 128;     // a V tile
  static constexpr int kVStages = 2;
  // offsets from the Q region's end (0 when streamed)
  static constexpr int kV = kSStages * kSBytes;
  static constexpr int kBars = kV + kVStages * kVBytes;
  static constexpr int kRest = kBars + 8 * (1 + 2 * (kSStages + kVStages)) +
                               1024;
  static constexpr int kMaxSmem = 232448;  // a block's opt-in maximum
  __host__ __device__ static int q_bytes(int NC) {
    return QRES ? NC * kQBytes : 0;
  }
  __host__ __device__ static int smem(int NC) { return q_bytes(NC) + kRest; }
  static_assert(HD % 64 == 0 && tma::Layout<HD, KN>::kLine == 128,
                "pieces of whole 64-column boxes in 128-byte lines");
  static_assert(kSBytes % 1024 == 0 && kVBytes % 1024 == 0,
                "regions stay 1024-byte aligned");
  static_assert(kRest <= kMaxSmem, "a block's shared memory");
};

// S (+)= Q . K^T over one 64-column chunk: four k-steps of 16 columns in
// one 128-byte swizzled line; ``first`` starts S at zero
template <int KN>
__device__ __forceinline__ void issue_score_chunk(float (&sc)[KN / 2],
                                                  uint32_t q_rows,
                                                  uint32_t kt, bool first) {
  using namespace tma;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t da = desc_sw<128>(q_rows + ks * 32, 16, 8 * 128);
    const uint64_t db = desc_sw<128>(kt + ks * 32, 16, 8 * 128);
    const int accumulate = !first || ks > 0;
    if constexpr (KN == 64)
      wgmma_ss_n64(sc, da, db, accumulate);
    else
      wgmma_ss_n32(sc, da, db, accumulate);
  }
  tma::wgmma_commit();
}

// One block: the 128 rows of flash_fwd_wgmma_kernel's tile and one column
// piece (blockIdx.x % n_pc of n_pc, pw columns from p0 = piece * pw) of a
// row of hd > 256 columns, at width HD >= pw. The producer loads Q's
// ceil(hd / 64) chunks once (QRES) and then, per key tile, K's chunks
// through the score ring -- or streams both, a (Q, K) pair of chunks a
// stage -- (the tensor maps zero-fill columns past hd and rows past S),
// then the piece's V tile; a consumer accumulates S over the chunks
// (releasing each stage once the next chunk's product is issued and the
// previous one is done), takes the same online softmax and issues O += P
// . V of the piece's HD columns, overlapped with the next tile's first
// score chunk. The consumers do not take turns. Every piece recomputes the
// whole row's scores: (n_pc hd + n_pc HD) / (2 hd) of the products a
// single block would do (1.5 at hd 512).
template <int HD, int KN, bool QRES>
__global__ void __launch_bounds__(tma::kThreads, 1)
flash_fwd_deep_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      __nv_bfloat16* __restrict__ o, int S, int KV, int G,
                      int hd, int GC, int n_gc, int pw, int n_pc, int causal,
                      float scale_log2) {
  using namespace tma;
  using Dl = DeepLayout<HD, KN, QRES>;
  constexpr int NSS = Dl::kSStages, NSV = Dl::kVStages;
  const int NC = (hd + 63) / 64;           // 64-column chunks of the row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ss = sq + Dl::q_bytes(NC);
  const uint32_t sv = ss + Dl::kV;
  const uint32_t full_s = ss + Dl::kBars, empty_s = full_s + 8 * NSS;
  const uint32_t full_v = empty_s + 8 * NSS, empty_v = full_v + 8 * NSV;
  const uint32_t full_q = empty_v + 8 * NSV;

  const int BQ = kTileRows / GC, R = BQ * GC;
  // heaviest causal tiles first, the head chunks and pieces of a tile
  // side by side
  const int rev = gridDim.x - 1 - blockIdx.x;
  const int pc = rev % n_pc, rq = rev / n_pc;
  const int qt = rq / n_gc, g0 = rq % n_gc * GC;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int p0 = pc * pw, pw_live = min(pw, hd - p0);
  const int p_last = min(S, q0 + BQ) - 1;  // last live position of the tile
  const int n_tiles = causal ? p_last / KN + 1 : (S + KN - 1) / KN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < NSS; ++s) {
      mbar_init(full_s + 8 * s, 1);
      mbar_init(empty_s + 8 * s, kConsumers * 4);  // one arrival a warp
    }
    for (int s = 0; s < NSV; ++s) {
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_v + 8 * s, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: Q once (QRES), per key tile the row's K chunks (and
    // Q's, streamed), then V -----------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      if constexpr (QRES) {
        mbar_expect_tx(full_q, NC * R * 128);
        for (int c = 0; c < NC; ++c)
          tma_load_5d(sq + c * Dl::kQBytes, &qmap, full_q, c * 64, g0, kv,
                      q0, b);
      }
      int i = 0;  // score stages issued
      for (int t = 0; t < n_tiles; ++t) {
        for (int c = 0; c < NC; ++c, ++i) {
          const int s = i % NSS;
          const uint32_t st = ss + s * Dl::kSBytes;
          if (i >= NSS) mbar_wait(empty_s + 8 * s, (i / NSS - 1) & 1);
          if constexpr (QRES) {
            mbar_expect_tx(full_s + 8 * s, Dl::kKBytes);
            tma_load_4d(st, &kmap, full_s + 8 * s, c * 64, kv, t * KN, b);
          } else {
            mbar_expect_tx(full_s + 8 * s, R * 128 + Dl::kKBytes);
            tma_load_5d(st, &qmap, full_s + 8 * s, c * 64, g0, kv, q0, b);
            tma_load_4d(st + Dl::kQBytes, &kmap, full_s + 8 * s, c * 64, kv,
                        t * KN, b);
          }
        }
        const int s = t % NSV;
        const uint32_t vt = sv + s * Dl::kVBytes;
        if (t >= NSV) mbar_wait(empty_v + 8 * s, (t / NSV - 1) & 1);
        mbar_expect_tx(full_v + 8 * s, Dl::kVBytes);
#pragma unroll
        for (int h = 0; h < HD / 64; ++h)
          tma_load_4d(vt + h * KN * 128, &vmap, full_v + 8 * s, p0 + h * 64,
                      kv, t * KN, b);
      }
    }
  } else {
    // ---- consumers: 64 rows each ----------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int tig = lane % 4;
    const int r0 = wg * kWgRows + warp * 16 + lane / 4, r1 = r0 + 8;
    const int pos0 = q0 + r0 / GC, pos1 = q0 + r1 / GC;
    const uint32_t q_off = wg * kWgRows * 128;  // this group's Q rows
    float acc[HD / 2], sc[KN / 2];
    uint32_t pa[KN / 16][4];
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) acc[j] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, al0, al1;

    if constexpr (QRES) mbar_wait(full_q, 0);
    int i = 0;  // score stages consumed
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * KN;
      if (t > 0) {
        const int sp = (t - 1) % NSV;
        mbar_wait(full_v + 8 * sp, ((t - 1) / NSV) & 1);
        wgmma_fence();
        issue_pv<HD, KN>(acc, pa, sv + sp * Dl::kVBytes);
      }
      for (int c = 0; c < NC; ++c, ++i) {
        const int s = i % NSS;
        const uint32_t st = ss + s * Dl::kSBytes;
        mbar_wait(full_s + 8 * s, (i / NSS) & 1);
        wgmma_fence();
        if constexpr (QRES)
          issue_score_chunk<KN>(sc, sq + c * Dl::kQBytes + q_off, st, c == 0);
        else
          issue_score_chunk<KN>(sc, st + q_off, st + Dl::kQBytes, c == 0);
        if (c > 0 || t > 0) {
          // the group before this chunk's is done: the previous chunk's
          // stage, or (first chunk) the previous tile's P . V
          wgmma_wait<1>();
          if (c > 0) {
            if (lane == 0) mbar_arrive(empty_s + 8 * ((i - 1) % NSS));
          } else {
            fence_regs(acc);
            fence_regs(pa);
            if (lane == 0) mbar_arrive(empty_v + 8 * ((t - 1) % NSV));
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(empty_s + 8 * ((i - 1) % NSS));
      online_softmax<KN>(sc, k0, k0 + KN > S || (causal && k0 + KN - 1 > q0),
                         S, causal, pos0, pos1, tig, scale_log2, m0, m1, l0,
                         l1, al0, al1);
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) acc[j] *= (j & 2) ? al1 : al0;
      pack_p<KN>(sc, pa);
    }
    const int sl = (n_tiles - 1) % NSV;
    mbar_wait(full_v + 8 * sl, ((n_tiles - 1) / NSV) & 1);
    fence_regs(acc);
    wgmma_fence();
    issue_pv<HD, KN>(acc, pa, sv + sl * Dl::kVBytes);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);

    // o = acc / max(l, 1e-30), rows in use, heads below G, positions
    // inside S and the piece's columns only
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? r1 : r0;
      const int p = r / GC, g = g0 + r % GC;
      if (r >= R || q0 + p >= S || g >= G) continue;
      const float den = fmaxf(h ? l1 : l0, 1e-30f);
      __nv_bfloat16* orow =
          o + ((static_cast<size_t>(b) * S + q0 + p) * KV + kv) * G * hd +
          static_cast<size_t>(g) * hd + p0;
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb) {
        if (nb * 8 < pw_live) {
          const __nv_bfloat162 y = __floats2bfloat162_rn(
              acc[4 * nb + 2 * h] / den, acc[4 * nb + 2 * h + 1] / den);
          *reinterpret_cast<__nv_bfloat162*>(orow + nb * 8 + tig * 2) = y;
        }
      }
    }
  }
}

// Query heads a block of G: balanced chunks of at most kMaxChunk heads
// (`head_chunks` in kernels/flash_attention/flash_attention.py), so a
// tile keeps >= 2 positions in the bf16 kernel's 128 rows and >= 1 in the
// f32 kernel's 64; chunk c holds heads [c GC, min(G, (c + 1) GC)).
constexpr int kMaxChunk = 64;
inline int chunk_heads(int G) {
  const int n_gc = (G + kMaxChunk - 1) / kMaxChunk;
  return (G + n_gc - 1) / n_gc;
}

// A launch takes the kernels' EXACT instantiation when its rows fill the
// width and one chunk holds all G heads
inline bool exact_launch(int HD, int hd, int n_gc) {
  return hd == HD && n_gc == 1;
}

template <int HD, int KN>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int KV, int G, int hd, int hd_scale, int causal,
                 cudaStream_t stream) {
  using Lt = tma::Layout<HD, KN>;
  const int GC = chunk_heads(G), n_gc = (G + GC - 1) / GC;
  const int BQ = tma::kTileRows / GC;
  const int n_qt = (S + BQ - 1) / BQ;
  const cuuint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t w = static_cast<cuuint64_t>(hd);
  const cuuint64_t qdims[5] = {w, static_cast<cuuint64_t>(G),
                               static_cast<cuuint64_t>(KV),
                               static_cast<cuuint64_t>(S),
                               static_cast<cuuint64_t>(B)};
  const cuuint64_t qstrides[4] = {w * e, qdims[1] * w * e,
                                  qdims[2] * qdims[1] * w * e,
                                  qdims[3] * qdims[2] * qdims[1] * w * e};
  const cuuint32_t qbox[5] = {Lt::kBox, static_cast<cuuint32_t>(GC), 1,
                              static_cast<cuuint32_t>(BQ), 1};
  const cuuint64_t kdims[4] = {w, static_cast<cuuint64_t>(KV),
                               static_cast<cuuint64_t>(S),
                               static_cast<cuuint64_t>(B)};
  const cuuint64_t kvstrides[3] = {w * e, kdims[1] * w * e,
                                   kdims[2] * kdims[1] * w * e};
  const cuuint32_t kbox[4] = {Lt::kBox, 1, KN, 1};
  CUtensorMap qm, km, vm;
  constexpr CUtensorMapDataType kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapSwizzle kSw =
      Lt::kLine == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : Lt::kLine == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  int err = attn::make_map(&qm, kBf16, q, 5, qdims, qstrides, qbox, kSw);
  if (err == 0)
    err = attn::make_map(&km, kBf16, k, 4, kdims, kvstrides, kbox, kSw);
  if (err == 0)
    err = attn::make_map(&vm, kBf16, v, 4, kdims, kvstrides, kbox, kSw);
  if (err != 0) return err;
  auto kern = exact_launch(HD, hd, n_gc)
                  ? flash_fwd_wgmma_kernel<HD, KN, true>
                  : flash_fwd_wgmma_kernel<HD, KN, false>;
  cudaError_t cerr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Lt::kSmem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const float scale_log2 = static_cast<float>(
      1.4426950408889634 / sqrt(static_cast<double>(hd_scale)));
  kern<<<dim3(n_qt * n_gc, KV, B), tma::kThreads, Lt::kSmem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), S, KV, G, hd, GC, n_gc,
      causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// Whether the bf16 body of a row of hd > 256 columns keeps Q resident
// (`DeepLayout`): wherever Q's chunks fit beside the rings.
template <int HD, int KN>
bool deep_resident(int hd) {
  return DeepLayout<HD, KN, true>::smem((hd + 63) / 64) <=
         DeepLayout<HD, KN, true>::kMaxSmem;
}

// The bf16 launch of a row past 256 (`attn::piece_cols`): n_pc pieces of
// pw columns at width HD, each a block beside the head chunks.
template <int HD, int KN, bool QRES>
int launch_wgmma_deep(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int KV, int G, int hd, int hd_scale,
                      int causal, cudaStream_t stream) {
  using Dl = DeepLayout<HD, KN, QRES>;
  const int smem = Dl::smem((hd + 63) / 64);
  const int GC = chunk_heads(G), n_gc = (G + GC - 1) / GC;
  const int pw = attn::piece_cols(attn::kBF16, hd);
  const int n_pc = (hd + pw - 1) / pw;
  const int BQ = tma::kTileRows / GC;
  const int n_qt = (S + BQ - 1) / BQ;
  const cuuint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t w = static_cast<cuuint64_t>(hd);
  const cuuint64_t qdims[5] = {w, static_cast<cuuint64_t>(G),
                               static_cast<cuuint64_t>(KV),
                               static_cast<cuuint64_t>(S),
                               static_cast<cuuint64_t>(B)};
  const cuuint64_t qstrides[4] = {w * e, qdims[1] * w * e,
                                  qdims[2] * qdims[1] * w * e,
                                  qdims[3] * qdims[2] * qdims[1] * w * e};
  const cuuint32_t qbox[5] = {64, static_cast<cuuint32_t>(GC), 1,
                              static_cast<cuuint32_t>(BQ), 1};
  const cuuint64_t kdims[4] = {w, static_cast<cuuint64_t>(KV),
                               static_cast<cuuint64_t>(S),
                               static_cast<cuuint64_t>(B)};
  const cuuint64_t kvstrides[3] = {w * e, kdims[1] * w * e,
                                   kdims[2] * kdims[1] * w * e};
  const cuuint32_t kbox[4] = {64, 1, KN, 1};
  CUtensorMap qm, km, vm;
  constexpr CUtensorMapDataType kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapSwizzle kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  int err = attn::make_map(&qm, kBf16, q, 5, qdims, qstrides, qbox, kSw);
  if (err == 0)
    err = attn::make_map(&km, kBf16, k, 4, kdims, kvstrides, kbox, kSw);
  if (err == 0)
    err = attn::make_map(&vm, kBf16, v, 4, kdims, kvstrides, kbox, kSw);
  if (err != 0) return err;
  auto kern = flash_fwd_deep_kernel<HD, KN, QRES>;
  cudaError_t cerr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const float scale_log2 = static_cast<float>(
      1.4426950408889634 / sqrt(static_cast<double>(hd_scale)));
  kern<<<dim3(n_qt * n_gc * n_pc, KV, B), tma::kThreads, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), S, KV, G, hd, GC, n_gc, pw,
      n_pc, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// The f32 launch; DEEP (a row past 256) puts its column pieces on the grid
// beside the head chunks.
template <typename T, int HD, bool DEEP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int KV, int G, int hd, int hd_scale, int causal,
           cudaStream_t stream) {
  const int GC = chunk_heads(G), n_gc = (G + GC - 1) / GC;
  const int pw = DEEP ? attn::piece_cols(attn::kF32, hd) : hd;
  const int n_pc = (hd + pw - 1) / pw;
  const int BQ = kRows / GC;
  const int n_qt = (S + BQ - 1) / BQ;
  constexpr size_t smem = smem_bytes<HD, DEEP>();
  auto kern = flash_fwd_kernel<T, HD, false, DEEP>;
  if constexpr (!DEEP) {
    if (exact_launch(HD, hd, n_gc)) kern = flash_fwd_kernel<T, HD, true, false>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(n_qt * n_gc * n_pc, KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, KV, G, hd, GC, n_gc,
      pw, n_pc, causal, attn::head_scale(hd_scale));
  return static_cast<int>(cudaGetLastError());
}

// Keys a tile of the bf16 kernel at width HD (`key_tile` in
// kernels/flash_attention/flash_attention.py): 64 measured faster than 128
// at the prefill shape (at 128 the consumers' accumulators outgrow their
// registers and ptxas serializes the wgmmas); past width 128 the HD / 2
// accumulators leave room for 32 keys' scores and P (64 spill: at width
// 192 100 bytes and 16% slower, tools/flash_width_probe.py).
constexpr int key_tile(int HD) { return HD > 128 ? 32 : 64; }

template <int HD>
int launch_at(bool bf, const void* q, const void* k, const void* v, void* o,
              int B, int S, int KV, int G, int hd, int hd_scale, int causal,
              cudaStream_t st) {
  return bf ? launch_wgmma<HD, key_tile(HD)>(q, k, v, o, B, S, KV, G, hd,
                                             hd_scale, causal, st)
            : launch<float, HD, false>(q, k, v, o, B, S, KV, G, hd,
                                       hd_scale, causal, st);
}

// A bf16 row past 256: its pieces (`attn::piece_cols`, 88 to 128 columns)
// run at width 128 with 64-key tiles
int launch_deep_bf16(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int KV, int G, int hd, int hd_scale,
                     int causal, cudaStream_t st) {
  constexpr int HD = 128, KN = key_tile(HD);
  return deep_resident<HD, KN>(hd)
             ? launch_wgmma_deep<HD, KN, true>(q, k, v, o, B, S, KV, G, hd,
                                               hd_scale, causal, st)
             : launch_wgmma_deep<HD, KN, false>(q, k, v, o, B, S, KV, G, hd,
                                                hd_scale, causal, st);
}

}  // namespace

extern "C" {

// q (B, S, KV, G, hd), k / v (B, S, KV, hd) -> o (B, S, KV, G, hd), all of
// `dtype` (0 f32: the scalar kernel, 1 bf16: the TMA + wgmma kernel), hd any
// multiple of 8 run at `attn::launch_width(dtype, hd)` (the rule of
// `launch_width`
// in kernels/_attention.py; past 256 as column pieces of
// `attn::piece_cols(hd)` columns on the grid), the scale 1 / sqrt(hd_scale)
// (the true head dim: hd_scale < hd when the wrapper passed a zero-padded
// copy), any G >= 1 (head chunks of at most 64 on the grid). One launch on
// `stream`, no synchronisation. Returns the first CUDA error (0 on
// success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int S, int KV, int G,
                           int hd, int hd_scale, int causal,
                           void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const bool bf = dtype == attn::kBF16;
  if ((!bf && dtype != attn::kF32) || G < 1 || hd_scale < 1 ||
      hd_scale > hd)
    return static_cast<int>(cudaErrorInvalidValue);
  const int width = attn::launch_width(dtype, hd);
  if (width > 0 && attn::piece_cols(dtype, hd) < hd) {
    if (bf)
      return launch_deep_bf16(q, k, v, o, B, S, KV, G, hd, hd_scale, causal,
                              st);
    return width == 192 ? launch<float, 192, true>(q, k, v, o, B, S, KV, G,
                                                   hd, hd_scale, causal, st)
                        : launch<float, 256, true>(q, k, v, o, B, S, KV, G,
                                                   hd, hd_scale, causal, st);
  }
#define FLASH_AT(W) \
  launch_at<W>(bf, q, k, v, o, B, S, KV, G, hd, hd_scale, causal, st)
  switch (width) {
    case 16: return FLASH_AT(16);
    case 32: return FLASH_AT(32);
    case 64: return FLASH_AT(64);
    case 128: return FLASH_AT(128);
    case 192: return FLASH_AT(192);
    case 256: return FLASH_AT(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_AT
}

// The width a row of hd elements runs at (`attn::launch_width`), or -1
// when the launchers refuse hd: the C side of `launch_width` in
// kernels/_attention.py, which the card checks against it.
int attention_launch_width(int dtype, int hd) {
  return attn::launch_width(dtype, hd);
}

// The columns of a piece of a row of hd elements in `dtype`
// (`attn::piece_cols`: hd itself up to 256): the C side of `row_pieces` in
// kernels/_attention.py.
int attention_piece_cols(int dtype, int hd) {
  return attn::piece_cols(dtype, hd);
}

}  // extern "C"
