// Host-side native runtime ops of the port's data layer (C ABI, loaded via
// ctypes by flowcompare_tpu_torch/native/__init__.py).
//
// The port's own copy of flowcompare_tpu/native/native_ops.cpp, kept
// function for function the same so both packages give equal indices:
//   * voxelize_grid / count_voxels — grid binning: floor((p - start)/size),
//     ravel-multi-index, per-voxel occupancy.
//   * fps — deterministic farthest-point sampling for the host data path
//     (the loaders' random_start=False contract; the on-device FPS of the
//     PAConv encoder is csrc/fps.cu).
//   * gather_records — the packed-dataset batch assembler: multithreaded
//     gather from an mmap'd record file into one contiguous batch buffer.
//
// Built with g++ at first use (native/__init__.py); a failed build raises.
// The numpy bodies (*_plain in native/__init__.py) are the tests' reference.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

extern "C" {

// points: (n, d_pts) row-major; start/size/steps: (d_grid,) with
// d_grid <= d_pts (xyz-first convention). out_ids: (n,) voxel ids.
void voxelize_grid(const float* points, int64_t n, int32_t d_pts,
                   const float* start, const float* size,
                   const int64_t* steps, int32_t d_grid, int64_t* out_ids) {
    std::vector<int64_t> strides(d_grid);
    int64_t acc = 1;
    for (int32_t k = 0; k < d_grid; ++k) {
        strides[k] = acc;
        acc *= steps[k];
    }
    for (int64_t i = 0; i < n; ++i) {
        const float* p = points + i * d_pts;
        int64_t id = 0;
        for (int32_t k = 0; k < d_grid; ++k) {
            int64_t cell = (int64_t)std::floor((p[k] - start[k]) / size[k]);
            cell = std::max<int64_t>(0, std::min<int64_t>(cell, steps[k] - 1));
            id += cell * strides[k];
        }
        out_ids[i] = id;
    }
}

void count_voxels(const int64_t* ids, int64_t n, int64_t n_voxels,
                  int64_t* counts) {
    std::memset(counts, 0, sizeof(int64_t) * (size_t)n_voxels);
    for (int64_t i = 0; i < n; ++i) {
        if (ids[i] >= 0 && ids[i] < n_voxels) counts[ids[i]] += 1;
    }
}

// Deterministic farthest-point sampling, start index 0 (the loaders'
// random_start=False contract). points: (n, stride) with xyz first.
void fps(const float* points, int64_t n, int32_t stride, int64_t m,
         int64_t* out_idx) {
    std::vector<float> best(n, std::numeric_limits<float>::infinity());
    int64_t far = 0;
    for (int64_t i = 0; i < m; ++i) {
        out_idx[i] = far;
        const float* c = points + far * stride;
        float maxd = -1.0f;
        int64_t argmax = 0;
        for (int64_t j = 0; j < n; ++j) {
            const float* p = points + j * stride;
            float dx = p[0] - c[0], dy = p[1] - c[1], dz = p[2] - c[2];
            float d = dx * dx + dy * dy + dz * dz;
            if (d < best[j]) best[j] = d;
            if (best[j] > maxd) { maxd = best[j]; argmax = j; }
        }
        far = argmax;
    }
}

// Gather `batch` records of `record_floats` f32 each from `base` (mmap'd
// packed file) at `indices` into `out`, striped across threads.
void gather_records(const float* base, const int64_t* indices, int64_t batch,
                    int64_t record_floats, float* out, int32_t n_threads) {
    if (n_threads < 1) n_threads = 1;
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= batch) return;
            std::memcpy(out + i * record_floats,
                        base + indices[i] * record_floats,
                        sizeof(float) * (size_t)record_floats);
        }
    };
    std::vector<std::thread> pool;
    for (int32_t t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
}

}  // extern "C"
