// Native IO kernels for the host side of the data pipeline.
//
// The port's own copy of the JAX package's native/io_kernels.cpp: the
// same C ABI, the same semantics. It parses numeric CSV and IDX files
// and assembles minibatches (a row gather, optionally fused with
// per-column standardization, and one-hot labels) across a thread pool,
// so that the feed pipeline's host stages keep up with the card.
//
// A plain C ABI read through ctypes. Numbers are parsed with
// std::from_chars: locale-independent (strtof misreads '1.5' under
// comma-decimal locales) and allocation free. Line semantics match the
// Python fallback exactly: skip_rows counts PHYSICAL lines, and
// whitespace-only lines are not rows.
//
// Built at first use by deeplearning4j_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -pthread -std=c++17 -o _build/libdl4jtorch_io.so io_kernels.cpp

#include <atomic>
#include <charconv>
#include <cstdio>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

bool is_blank(const char* p, const char* end) {
    for (; p < end; p++)
        if (*p != ' ' && *p != '\t' && *p != '\r') return false;
    return true;
}

// Parse one cell: skip quotes/spaces, from_chars, return success.
bool parse_cell(const char* q, const char* cell_end, float* out) {
    while (q < cell_end && (*q == '"' || *q == ' ' || *q == '\t')) q++;
    const char* e = cell_end;
    while (e > q && (*(e - 1) == '"' || *(e - 1) == ' ' || *(e - 1) == '\t'
                     || *(e - 1) == '\r')) e--;
    if (q >= e) { *out = 0.0f; return false; }
    auto res = std::from_chars(q, e, *out);
    if (res.ec != std::errc()) { *out = 0.0f; return false; }
    return true;
}

struct FileBuf {
    std::vector<char> data;
    bool ok = false;
};

FileBuf read_file(const char* path) {
    FileBuf fb;
    FILE* f = fopen(path, "rb");
    if (!f) return fb;
    fseek(f, 0, SEEK_END);
#if defined(_WIN32)
    int64_t n = _ftelli64(f);  // long ftell is 32-bit on LLP64
#else
    int64_t n = ftello(f);
#endif
    fseek(f, 0, SEEK_SET);
    if (n < 0) { fclose(f); return fb; }  // ftell failure: empty buf
    fb.data.resize(n + 1);
    if (n > 0 && fread(fb.data.data(), 1, n, f) != (size_t)n) { fclose(f); return fb; }
    fclose(f);
    fb.data[n] = '\0';
    fb.data.resize(n);
    fb.ok = true;
    return fb;
}

// Collect [start, end) of every data line (after skipping skip_rows
// PHYSICAL lines and dropping blank lines) — shared by shape + parse.
void data_lines(const std::vector<char>& buf, int64_t skip_rows,
                std::vector<const char*>& starts,
                std::vector<const char*>& ends) {
    const char* p = buf.data();
    const char* end = p + buf.size();
    int64_t physical = 0;
    while (p < end) {
        const char* line_end = (const char*)memchr(p, '\n', end - p);
        if (!line_end) line_end = end;
        if (physical >= skip_rows && !is_blank(p, line_end)) {
            starts.push_back(p);
            ends.push_back(line_end);
        }
        physical++;
        p = line_end + 1;
    }
}

}  // namespace

extern "C" {

// ----------------------------------------------------------------- csv

int dl4j_csv_shape(const char* path, int64_t skip_rows, int64_t* rows, int64_t* cols) {
    FileBuf fb = read_file(path);
    if (!fb.ok) return -1;
    std::vector<const char*> starts, ends;
    data_lines(fb.data, skip_rows, starts, ends);
    *rows = (int64_t)starts.size();
    *cols = 0;
    if (!starts.empty()) {
        int64_t c = 1;
        for (const char* q = starts[0]; q < ends[0]; q++)
            if (*q == ',') c++;
        *cols = c;
    }
    return 0;
}

// Parse into a pre-allocated [rows, cols] float32 buffer. Returns the
// number of non-numeric cells (>= 0, parsed as 0.0), or negative on IO
// error — the caller decides whether bad cells are fatal.
int64_t dl4j_csv_parse(const char* path, int64_t skip_rows, float* out,
                    int64_t rows, int64_t cols, int threads) {
    FileBuf fb = read_file(path);
    if (!fb.ok) return -1;
    std::vector<const char*> starts, ends;
    data_lines(fb.data, skip_rows, starts, ends);
    if ((int64_t)starts.size() < rows) return -3;

    std::atomic<int64_t> bad{0};
    auto parse_range = [&](int64_t lo, int64_t hi) {
        int64_t local_bad = 0;
        for (int64_t i = lo; i < hi; i++) {
            const char* q = starts[i];
            const char* line_end = ends[i];
            float* row_out = out + i * cols;
            int64_t col = 0;
            while (col < cols) {
                const char* cell_end = (const char*)memchr(q, ',', line_end - q);
                if (!cell_end) cell_end = line_end;
                if (q >= line_end && col > 0) {
                    row_out[col++] = 0.0f;  // short row: zero-fill
                    local_bad++;
                    continue;
                }
                if (!parse_cell(q, cell_end, &row_out[col])) local_bad++;
                col++;
                q = cell_end < line_end ? cell_end + 1 : line_end;
            }
        }
        bad.fetch_add(local_bad, std::memory_order_relaxed);
    };

    int nt = threads > 0 ? threads : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt > 16) nt = 16;
    // small files are not worth thread spawns
    int64_t min_rows_per_thread = 4096;
    int64_t useful = rows / min_rows_per_thread + 1;
    if ((int64_t)nt > useful) nt = (int)useful;
    if (nt <= 1) {
        parse_range(0, rows);
    } else {
        int64_t per = (rows + nt - 1) / nt;
        std::vector<std::thread> pool;
        for (int t = 0; t < nt; t++) {
            int64_t lo = t * per;
            int64_t hi = lo + per < rows ? lo + per : rows;
            if (lo >= hi) break;
            pool.emplace_back(parse_range, lo, hi);
        }
        for (auto& th : pool) th.join();
    }
    return bad.load();
}

// ----------------------------------------------------------------- idx

int dl4j_idx_header(const char* path, int* dtype, int* ndim, int64_t* dims) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    unsigned char h[4];
    if (fread(h, 1, 4, f) != 4 || h[0] != 0 || h[1] != 0) { fclose(f); return -2; }
    *dtype = h[2];
    *ndim = h[3];
    if (*ndim > 8) { fclose(f); return -3; }
    for (int i = 0; i < *ndim; i++) {
        unsigned char d[4];
        if (fread(d, 1, 4, f) != 4) { fclose(f); return -4; }
        dims[i] = ((int64_t)d[0] << 24) | ((int64_t)d[1] << 16) | ((int64_t)d[2] << 8) | d[3];
    }
    fclose(f);
    return 0;
}

int dl4j_idx_read(const char* path, unsigned char* out, int64_t nbytes) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    unsigned char h[4];
    if (fread(h, 1, 4, f) != 4) { fclose(f); return -2; }
    int64_t skip = 4 + 4 * h[3];
    fseek(f, skip, SEEK_SET);
    int64_t got = (int64_t)fread(out, 1, nbytes, f);
    fclose(f);
    return got == nbytes ? 0 : -5;
}


// ------------------------------------------------------- batch assembly
//
// The host side's minibatch assembly: gather rows by index (a shuffled
// minibatch), optionally fused with per-column standardization, and
// expand integer labels to one-hot, across a thread pool. Row indices
// are bounds-checked (returns -2 on the first out of range).

}  // extern "C" (templates below need C++ linkage)

// Minimum per-thread work (floats): below this, thread create/join
// overhead dwarfs the copy — typical 32-row minibatches run inline.
static const int64_t kMinWorkPerThread = 1L << 16;

static int clamp_threads(int threads, int64_t rows, int64_t work_per_row) {
    int nt = threads > 0 ? threads
                         : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if ((int64_t)nt > rows) nt = (int)(rows > 0 ? rows : 1);
    int64_t total = rows * (work_per_row > 0 ? work_per_row : 1);
    int64_t by_work = total / kMinWorkPerThread;
    if (by_work < 1) by_work = 1;
    if ((int64_t)nt > by_work && threads <= 0) nt = (int)by_work;
    return nt;
}

template <typename Fn>
static void parallel_rows(int64_t rows, int64_t work_per_row, int threads, Fn fn) {
    int nt = clamp_threads(threads, rows, work_per_row);
    if (nt <= 1) { fn(0L, rows); return; }
    int64_t per = (rows + nt - 1) / nt;
    std::vector<std::thread> pool;
    for (int t = 0; t < nt; t++) {
        int64_t lo = t * per;
        int64_t hi = lo + per < rows ? lo + per : rows;
        if (lo >= hi) break;
        pool.emplace_back(fn, lo, hi);
    }
    for (auto& th : pool) th.join();
}

extern "C" {

int64_t dl4j_gather_rows(const float* src, int64_t n_rows, int64_t row_elems,
                      const int64_t* idx, int64_t n_idx, float* out, int threads) {
    for (int64_t i = 0; i < n_idx; i++)
        if (idx[i] < 0 || idx[i] >= n_rows) return -2;
    parallel_rows(n_idx, row_elems, threads, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i++)
            std::memcpy(out + i * row_elems, src + idx[i] * row_elems,
                        sizeof(float) * (size_t)row_elems);
    });
    return 0;
}

int64_t dl4j_gather_normalize(const float* src, int64_t n_rows, int64_t row_elems,
                           const int64_t* idx, int64_t n_idx, const float* mean,
                           const float* stdv, float* out, int threads) {
    for (int64_t i = 0; i < n_idx; i++)
        if (idx[i] < 0 || idx[i] >= n_rows) return -2;
    parallel_rows(n_idx, row_elems, threads, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i++) {
            const float* row = src + idx[i] * row_elems;
            float* dst = out + i * row_elems;
            for (int64_t j = 0; j < row_elems; j++) {
                float sd = stdv[j];
                dst[j] = (row[j] - mean[j]) / (sd != 0.0f ? sd : 1.0f);
            }
        }
    });
    return 0;
}

int64_t dl4j_onehot(const int64_t* labels, int64_t n, int64_t classes, float* out,
                 int threads) {
    for (int64_t i = 0; i < n; i++)
        if (labels[i] < 0 || labels[i] >= classes) return -2;
    parallel_rows(n, classes, threads, [&](int64_t lo, int64_t hi) {
        std::memset(out + lo * classes, 0,
                    sizeof(float) * (size_t)((hi - lo) * classes));
        for (int64_t i = lo; i < hi; i++)
            out[i * classes + labels[i]] = 1.0f;
    });
    return 0;
}

}  // extern "C"
