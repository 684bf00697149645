// Threefry-2x32 random bits for a batch of keys: (K, 2) key words ->
// (K, n) int64, element (k, i) the uint32 y0 ^ y1 of
// threefry2x32(key_k, (0, i)), the bits of jax.random.bits(key_k, (n,))
// in its partitionable mode.
//
// Replaces no TPU kernel: the JAX package draws DnC's coordinate sketch
// (attacking_federate_learning_tpu/defenses/dnc.py:88,
// jax.random.choice) and its power-iteration start (:46,
// jax.random.normal) with XLA's threefry inside its jitted round.  The
// port draws the same bits on the card, where a host draw (numpy, about
// 30 ms at d = 79,510) would swamp a 3 ms round; the sort of the shuffle
// and the uniform-to-normal steps stay in PyTorch
// (ops/threefry_bits.py).
//
// Bound on an H100 by bytes: 8 bytes written per element against about
// 80 integer operations (20 rounds of add, rotate, xor and 5 key
// injections), which the SMs retire faster than the 3.35 TB/s write
// stream.  One thread an element, consecutive threads on consecutive
// outputs; the key words stay in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
    x0 += x1;
    x1 = rotl32(x1, r) ^ x0;
}

__global__ void threefry_bits_kernel(const long long* keys, int num_keys,
                                     long long n, long long* out) {
    const long long total = (long long)num_keys * n;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         idx < total; idx += stride) {
        const long long k = idx / n;
        const uint32_t i = (uint32_t)(idx - k * n);
        const uint32_t k0 = (uint32_t)keys[2 * k];
        const uint32_t k1 = (uint32_t)keys[2 * k + 1];
        const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
        uint32_t x0 = ks[0];        // counter word 0 is 0
        uint32_t x1 = i + ks[1];
#pragma unroll
        for (int s = 0; s < 5; ++s) {
            if (s % 2 == 0) {
                mix(x0, x1, 13); mix(x0, x1, 15);
                mix(x0, x1, 26); mix(x0, x1, 6);
            } else {
                mix(x0, x1, 17); mix(x0, x1, 29);
                mix(x0, x1, 16); mix(x0, x1, 24);
            }
            x0 += ks[(s + 1) % 3];
            x1 += ks[(s + 2) % 3] + (uint32_t)(s + 1);
        }
        out[idx] = (long long)(x0 ^ x1);
    }
}

}  // namespace

// keys: (num_keys, 2) int64 on the device, each word < 2^32; out:
// (num_keys, n) int64.  n < 2^32 (the counter is one 32-bit word).
// Launches on `stream`; returns the CUDA error code (0 on success).
extern "C" int fl_threefry_bits(const long long* keys, int num_keys,
                                long long n, long long* out, void* stream) {
    const long long total = (long long)num_keys * n;
    if (total <= 0) return 0;
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    threefry_bits_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(keys, num_keys, n, out);
    return (int)cudaGetLastError();
}
