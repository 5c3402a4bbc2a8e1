// K4: the exact limb-plane contraction behind keyswitch and pfKS on Hopper.
//
// Replaces the Pallas kernel tfhe_aes2_tpu/ops/pallas/matmul.py::
// fused_limb_matmul, for every shape (the TPU kernel took only MXU-tileable
// ones):
//
//   out[b, n] = Σ_{i, j>=js} 2^(8(i+j)) Σ_k d_i[b, k] · m_j[k, n]   mod 2^64
//
// d: int8 [ND][B][K] limb planes of gadget digits; m: int8 [8-js][K][N] limb
// planes of the keyswitch key. At PARAMS_SQRD_LVL_64 the keyswitch is
// B x 8192 x 678 with ND=1 and 3 key planes, the pfKS B x 4098 x 12800 with
// ND=3 and 7 key planes.
//
// What bounds it on the H100: int8 operations for the pfKS (B = 256:
// 256·4098·12800·18 ≈ 2.4e11 multiply-adds against ~370 MB of key planes);
// the key-plane bytes for the keyswitch at small B. Design: a plain tiled
// GEMM. A block owns a BM x BN output tile and walks K in KT slices staged
// in shared memory: the digit tile as 32-bit words of 4 consecutive k, the
// key tile transposed into words of 4 consecutive k per column, so every
// inner step is one __dp4a. Each output keeps one int32 bucket per weight
// 2^(8s); a bucket sums at most ND products of K terms of at most 2^7·2^7,
// the int32 bound that tfhe_aes2_tpu/ops/torus.py guards
// (ND·K·2^14 < 2^31; 2.0e8 for the pfKS) and that the Python wrapper
// checks. Ragged edges in B, K and N are masked with zeros.
#include "nc_common.cuh"   // NC_DISPATCH

namespace {

constexpr int BM = 32;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int KT = 32;   // contraction slice per stage
constexpr int TM = 2;    // rows per thread
constexpr int TN = 4;    // columns per thread (strided by 16)
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256

template <int ND, int JS>
__global__ void __launch_bounds__(THREADS)
fused_limb_matmul_kernel(const int8_t* __restrict__ d,
                         const int8_t* __restrict__ m,
                         uint64_t* __restrict__ out, int B, int K, int N) {
  constexpr int NJ = 8 - JS;
  __shared__ uint32_t dw[ND][BM][KT / 4];
  __shared__ uint32_t mw[NJ][KT / 4][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int b0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  int32_t part[TM][TN][NJ];
#pragma unroll
  for (int rr = 0; rr < TM; ++rr)
#pragma unroll
    for (int cc = 0; cc < TN; ++cc)
#pragma unroll
      for (int s = 0; s < NJ; ++s) part[rr][cc][s] = 0;

  for (int k0 = 0; k0 < K; k0 += KT) {
    __syncthreads();
    for (int idx = tid; idx < ND * BM * (KT / 4); idx += THREADS) {
      const int w = idx % (KT / 4);
      const int row = (idx / (KT / 4)) % BM;
      const int i = idx / ((KT / 4) * BM);
      const int b = b0 + row;
      uint32_t word = 0;
      if (b < B) {
        const int8_t* src = d + ((size_t)i * B + b) * K;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = k0 + 4 * w + q;
          if (k < K) word |= (uint32_t)(uint8_t)src[k] << (8 * q);
        }
      }
      dw[i][row][w] = word;
    }
    for (int idx = tid; idx < NJ * (KT / 4) * BN; idx += THREADS) {
      const int col = idx % BN;
      const int w = (idx / BN) % (KT / 4);
      const int j = idx / (BN * (KT / 4));
      const int n = n0 + col;
      uint32_t word = 0;
      if (n < N) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = k0 + 4 * w + q;
          if (k < K)
            word |= (uint32_t)(uint8_t)m[((size_t)j * K + k) * N + n]
                    << (8 * q);
        }
      }
      mw[j][w][col] = word;
    }
    __syncthreads();
#pragma unroll 2
    for (int w = 0; w < KT / 4; ++w) {
      int a[ND][TM];
#pragma unroll
      for (int i = 0; i < ND; ++i)
#pragma unroll
        for (int rr = 0; rr < TM; ++rr) a[i][rr] = (int)dw[i][ty * TM + rr][w];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        int bw[TN];
#pragma unroll
        for (int cc = 0; cc < TN; ++cc)
          bw[cc] = (int)mw[j][w][tx + cc * (BN / TN)];
#pragma unroll
        for (int i = 0; i < ND; ++i) {
          if (i + j + JS < 8) {
#pragma unroll
            for (int rr = 0; rr < TM; ++rr)
#pragma unroll
              for (int cc = 0; cc < TN; ++cc)
                part[rr][cc][i + j] =
                    __dp4a(a[i][rr], bw[cc], part[rr][cc][i + j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < TM; ++rr) {
    const int b = b0 + ty * TM + rr;
    if (b >= B) continue;
#pragma unroll
    for (int cc = 0; cc < TN; ++cc) {
      const int n = n0 + tx + cc * (BN / TN);
      if (n >= N) continue;
      uint64_t sum = 0;
#pragma unroll
      for (int s = 0; s < NJ; ++s)
        sum += (uint64_t)(int64_t)part[rr][cc][s] << (8 * (s + JS));
      out[(size_t)b * N + n] = sum;
    }
  }
}

template <int ND, int JS>
int launch(const int8_t* d, const int8_t* m, int64_t* out, int B, int K,
           int N, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (B + BM - 1) / BM);
  fused_limb_matmul_kernel<ND, JS><<<grid, THREADS, 0, stream>>>(
      d, m, reinterpret_cast<uint64_t*>(out), B, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tfhe_fused_limb_matmul(const int8_t* d, const int8_t* m,
                                      int64_t* out, int B, int K, int N,
                                      int nd, int js, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define MM_CALL(ND, JS) launch<ND, JS>(d, m, out, B, K, N, s)
  NC_DISPATCH(nd, js, MM_CALL)
#undef MM_CALL
}
