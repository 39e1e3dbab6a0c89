// gnnio — native host runtime for legion.
//
// Counterpart of the reference's host-side hot paths: the
// pinned-host feature reads of zero_copy_with_aggregated_cache
// (reference src/Kernels.cu:662-702) become a threaded row gather that
// feeds device staging, and the host CSR sampling that backs the
// topology-cache miss path (reference samples the zero-copy CSR from
// GPU threads, src/Kernels.cu:468-564) becomes a threaded CPU sampler.
// mmap dataset loading mirrors GPUGraphStore's readers
// (src/GPUGraphStore.cu:254-340).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the
// image). All functions are thread-parallel with a caller-chosen thread
// count and release-the-GIL friendly (pure C, no Python API).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Parallel row gather: out[i, :] = table[ids[i], :], zeros for ids < 0.
void gather_rows_f32(float* out, const float* table, const int32_t* ids,
                     int64_t n, int64_t dim, int64_t num_rows, int nthreads) {
    if (nthreads < 1) nthreads = 1;
    std::vector<std::thread> ts;
    std::atomic<int64_t> next(0);
    const int64_t chunk = 256;
    auto work = [&]() {
        for (;;) {
            int64_t s = next.fetch_add(chunk);
            if (s >= n) break;
            int64_t e = s + chunk < n ? s + chunk : n;
            for (int64_t i = s; i < e; i++) {
                int32_t id = ids[i];
                float* dst = out + i * dim;
                if (id < 0 || id >= num_rows) {
                    memset(dst, 0, dim * sizeof(float));
                } else {
                    memcpy(dst, table + (int64_t)id * dim, dim * sizeof(float));
                }
            }
        }
    };
    for (int t = 0; t < nthreads; t++) ts.emplace_back(work);
    for (auto& t : ts) t.join();
}

// splitmix64 — cheap counter-based PRNG for reproducible host sampling.
static inline uint64_t splitmix64(uint64_t x) {
    x += 0x9E3779B97F4A7C15ull;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
    return x ^ (x >> 31);
}

// Uniform-with-replacement neighbor sampling over a host CSR.
// Semantics identical to the device sampler (and the reference kernel,
// src/Kernels.cu:399-410): slot s of node v is valid iff s < deg(v);
// valid slots draw uniformly from v's full neighbor list. ids < 0 give
// all -1 rows.
void sample_neighbors_u32(int32_t* out, const int64_t* indptr,
                          const int32_t* indices, const int32_t* ids,
                          int64_t n, int32_t fanout, uint64_t seed,
                          int nthreads) {
    if (nthreads < 1) nthreads = 1;
    std::vector<std::thread> ts;
    std::atomic<int64_t> next(0);
    const int64_t chunk = 128;
    auto work = [&]() {
        for (;;) {
            int64_t s = next.fetch_add(chunk);
            if (s >= n) break;
            int64_t e = s + chunk < n ? s + chunk : n;
            for (int64_t i = s; i < e; i++) {
                int32_t v = ids[i];
                int32_t* dst = out + i * fanout;
                if (v < 0) {
                    for (int32_t f = 0; f < fanout; f++) dst[f] = -1;
                    continue;
                }
                int64_t start = indptr[v];
                int64_t deg = indptr[v + 1] - start;
                for (int32_t f = 0; f < fanout; f++) {
                    if (f >= deg || deg <= 0) {
                        dst[f] = -1;
                    } else {
                        uint64_t r = splitmix64(seed ^ ((uint64_t)i << 20) ^ f);
                        dst[f] = indices[start + (int64_t)(r % (uint64_t)deg)];
                    }
                }
            }
        }
    };
    for (int t = 0; t < nthreads; t++) ts.emplace_back(work);
    for (auto& t : ts) t.join();
}

// Histogram accumulate: hist[ids[i]] += 1 for ids >= 0 (hotness
// counting on host for host-resident-topology presampling).
void accumulate_hist_i64(int64_t* hist, const int32_t* ids, int64_t n,
                         int64_t num_rows, int nthreads) {
    if (nthreads < 1) nthreads = 1;
    std::vector<std::thread> ts;
    int64_t per = (n + nthreads - 1) / nthreads;
    std::vector<std::vector<int64_t>> parts(nthreads);
    auto work = [&](int t) {
        parts[t].assign(num_rows, 0);
        int64_t s = t * per, e = s + per < n ? s + per : n;
        for (int64_t i = s; i < e; i++) {
            int32_t v = ids[i];
            if (v >= 0 && v < num_rows) parts[t][v]++;
        }
    };
    for (int t = 0; t < nthreads; t++) ts.emplace_back(work, t);
    for (auto& t : ts) t.join();
    for (int t = 0; t < nthreads; t++)
        for (int64_t v = 0; v < num_rows; v++) hist[v] += parts[t][v];
}

// COO -> CSR conversion (counting sort by dst), for the dataset packer.
// src/dst are int32 edge endpoints; indptr must hold num_nodes+1 int64
// zeros on entry; indices holds num_edges int32 on exit.
void coo_to_csr(const int32_t* src, const int32_t* dst, int64_t num_edges,
                int64_t num_nodes, int64_t* indptr, int32_t* indices) {
    for (int64_t i = 0; i < num_edges; i++) indptr[dst[i] + 1]++;
    for (int64_t v = 0; v < num_nodes; v++) indptr[v + 1] += indptr[v];
    std::vector<int64_t> cur(indptr, indptr + num_nodes);
    for (int64_t i = 0; i < num_edges; i++) {
        indices[cur[dst[i]]++] = src[i];
    }
}

}  // extern "C"
