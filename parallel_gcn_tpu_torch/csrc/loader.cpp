// Native dataset loader for the .graph/.svmlight/.split format, and the
// label-propagation sweep of the community reorder.
//
// The port's own copy of the JAX package's csrc/loader.cpp (same C
// interface, same semantics), the counterpart of the reference's C++ Parser
// (reference: src/parser.cpp — parseGraph/parseNode/parseSplit +
// calculateGraphValues): builds the self-loop-inclusive CSR, the sparse
// feature CSR (with optional NO_FEATURE-style binarization), the split vector,
// and precomputes the symmetric-normalized adjacency values
// 1/sqrt(deg(src)*deg(dst)). Built with g++ and OpenMP into
// parallel_gcn_tpu_torch/_build/ and consumed via ctypes
// (parallel_gcn_tpu_torch/data/native.py); the numpy readers in
// parallel_gcn_tpu_torch/data/parser.py and the numpy sweep in
// data/reorder.py are the semantic spec and the fallback.
//
// Parsing is a single pass over an fread-slurped buffer with hand-rolled
// integer/float scanning — ~20x faster than the Python reader on reddit-scale
// files.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <limits>
#include <algorithm>
#include <string>
#include <vector>

namespace {

struct Buffer {
    char *data = nullptr;
    size_t size = 0;
    bool ok = false;
};

Buffer slurp(const std::string &path) {
    Buffer b;
    FILE *f = std::fopen(path.c_str(), "rb");
    if (!f) return b;
    std::fseek(f, 0, SEEK_END);
    long n = std::ftell(f);
    if (n < 0) {  // unseekable (FIFO/special file): refuse rather than
        std::fclose(f);  // fread(SIZE_MAX) into a 0-byte buffer
        return b;
    }
    std::fseek(f, 0, SEEK_SET);
    b.data = static_cast<char *>(std::malloc(static_cast<size_t>(n) + 1));
    if (b.data && std::fread(b.data, 1, n, f) == static_cast<size_t>(n)) {
        b.size = n;
        b.data[n] = '\0';
        b.ok = true;
    } else if (b.data) {
        std::free(b.data);  // short read: don't leak the buffer
        b.data = nullptr;
    }
    std::fclose(f);
    return b;
}

inline void skip_spaces(const char *&p, const char *end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
}

inline bool parse_int(const char *&p, const char *end, long &out) {
    skip_spaces(p, end);
    if (p >= end || (*p != '-' && (*p < '0' || *p > '9'))) return false;
    bool neg = *p == '-';
    if (neg) ++p;
    long v = 0;
    while (p < end && *p >= '0' && *p <= '9') {
        int d = *p - '0';
        // overflow guard: a corrupt id > LONG_MAX must fail the parse, not
        // wrap silently before the caller's range check
        if (v > (std::numeric_limits<long>::max() - d) / 10) return false;
        v = v * 10 + d;
        ++p;
    }
    out = neg ? -v : v;
    return true;
}

inline bool parse_float(const char *&p, const char *end, float &out) {
    skip_spaces(p, end);
    char *q;
    float v = std::strtof(p, &q);
    // strtof ignores our line boundary (it skips newlines as whitespace):
    // a malformed "id:" entry would swallow the next line's label. Reject
    // any parse that starts or ends past the line end.
    if (q == p || p >= end || q > end) return false;
    p = q;
    out = v;
    return true;
}

}  // namespace

extern "C" {

struct PgcnDataset {
    // graph CSR (self-loop first per row, reference src/parser.cpp:29-31)
    std::vector<int64_t> g_indptr;
    std::vector<int32_t> g_indices;
    std::vector<float> g_values;  // Â values (src/parser.cpp:164-181)
    // feature CSR
    std::vector<int64_t> f_indptr;
    std::vector<int32_t> f_indices;
    std::vector<float> f_values;
    std::vector<int32_t> labels;
    std::vector<int32_t> split;
    int64_t n_nodes = 0;
    int64_t input_dim = 0;
    int64_t output_dim = 0;
    int status = 0;  // 0 ok, <0 error
};

PgcnDataset *pgcn_load(const char *dir, const char *name, int binarize) {
    auto *ds = new PgcnDataset();
    std::string base = std::string(dir) + "/" + name;

    {  // ---- .graph: one line per node, neighbors; implicit self-loop first
        Buffer b = slurp(base + ".graph");
        if (!b.ok) { ds->status = -1; return ds; }
        const char *p = b.data, *end = b.data + b.size;
        ds->g_indptr.push_back(0);
        int32_t node = 0;
        while (p < end) {
            const char *nl = static_cast<const char *>(memchr(p, '\n', end - p));
            const char *line_end = nl ? nl : end;
            ds->g_indices.push_back(node);  // self-loop
            long nnz = 1;
            long v;
            while (parse_int(p, line_end, v)) {
                ds->g_indices.push_back(static_cast<int32_t>(v));
                ++nnz;
            }
            skip_spaces(p, line_end);
            if (p < line_end) {
                // unparsed garbage on a neighbor line (including an id that
                // overflowed parse_int) — fail loudly instead of silently
                // truncating the node's neighbor list
                ds->status = -7;
                break;
            }
            ds->g_indptr.push_back(ds->g_indptr.back() + nnz);
            ++node;
            p = nl ? nl + 1 : end;
        }
        ds->n_nodes = node;
        std::free(b.data);
        if (ds->status != 0) return ds;
    }

    // ---- validate neighbor ids (the Python spec path raises IndexError on
    // out-of-range ids; without this the Â loop reads out of bounds)
    for (const int32_t dst : ds->g_indices) {
        if (dst < 0 || dst >= ds->n_nodes) { ds->status = -4; return ds; }
    }

    {  // ---- Â values: 1/sqrt(deg_src * deg_dst), degrees self-loop-inclusive
        ds->g_values.resize(ds->g_indices.size());
        for (int64_t src = 0; src < ds->n_nodes; ++src) {
            const float dsrc =
                static_cast<float>(ds->g_indptr[src + 1] - ds->g_indptr[src]);
            for (int64_t i = ds->g_indptr[src]; i < ds->g_indptr[src + 1]; ++i) {
                const int32_t dst = ds->g_indices[i];
                const float ddst =
                    static_cast<float>(ds->g_indptr[dst + 1] - ds->g_indptr[dst]);
                ds->g_values[i] = 1.0f / std::sqrt(dsrc * ddst);
            }
        }
    }

    {  // ---- .svmlight: "<label> <id>:<val> ..." per node
        Buffer b = slurp(base + ".svmlight");
        if (!b.ok) { ds->status = -2; return ds; }
        const char *p = b.data, *end = b.data + b.size;
        ds->f_indptr.push_back(0);
        long max_idx = 0, max_label = 0;
        while (p < end) {
            const char *nl = static_cast<const char *>(memchr(p, '\n', end - p));
            const char *line_end = nl ? nl : end;
            long label;
            if (!parse_int(p, line_end, label)) label = -1;
            ds->labels.push_back(static_cast<int32_t>(label));
            if (label > max_label) max_label = label;
            long nnz = 0;
            long k;
            while (parse_int(p, line_end, k)) {
                skip_spaces(p, line_end);
                if (p < line_end && *p == ':') ++p;
                float v;
                if (!parse_float(p, line_end, v)) break;
                ds->f_indices.push_back(static_cast<int32_t>(k));
                ds->f_values.push_back(binarize ? 1.0f : v);
                if (k > max_idx) max_idx = k;
                ++nnz;
            }
            ds->f_indptr.push_back(ds->f_indptr.back() + nnz);
            p = nl ? nl + 1 : end;
        }
        ds->input_dim = max_idx + 1;
        ds->output_dim = max_label + 1;
        std::free(b.data);
        // the ctypes side copies n_nodes(+1) entries from labels/f_indptr —
        // a truncated .svmlight must fail loudly, not read past the vectors
        if (static_cast<int64_t>(ds->labels.size()) != ds->n_nodes) {
            ds->status = -5;
            return ds;
        }
    }

    {  // ---- .split: one int per node (1=train 2=val 3=test)
        Buffer b = slurp(base + ".split");
        if (!b.ok) { ds->status = -3; return ds; }
        const char *p = b.data, *end = b.data + b.size;
        long v;
        while (parse_int(p, end, v)) {
            ds->split.push_back(static_cast<int32_t>(v));
            skip_spaces(p, end);
            while (p < end && (*p == '\n' || *p == '\r')) ++p;
        }
        std::free(b.data);
        if (static_cast<int64_t>(ds->split.size()) != ds->n_nodes) {
            // BOM/blank-line/truncation silently stopping parse_int would
            // otherwise yield empty or wrong train/val/test masks
            ds->status = -6;
            return ds;
        }
    }

    return ds;
}

int pgcn_status(const PgcnDataset *ds) { return ds->status; }
int64_t pgcn_n_nodes(const PgcnDataset *ds) { return ds->n_nodes; }
int64_t pgcn_input_dim(const PgcnDataset *ds) { return ds->input_dim; }
int64_t pgcn_output_dim(const PgcnDataset *ds) { return ds->output_dim; }
int64_t pgcn_graph_nnz(const PgcnDataset *ds) { return ds->g_indices.size(); }
int64_t pgcn_feat_nnz(const PgcnDataset *ds) { return ds->f_indices.size(); }
int64_t pgcn_split_len(const PgcnDataset *ds) { return ds->split.size(); }

const int64_t *pgcn_graph_indptr(const PgcnDataset *ds) { return ds->g_indptr.data(); }
const int32_t *pgcn_graph_indices(const PgcnDataset *ds) { return ds->g_indices.data(); }
const float *pgcn_graph_values(const PgcnDataset *ds) { return ds->g_values.data(); }
const int64_t *pgcn_feat_indptr(const PgcnDataset *ds) { return ds->f_indptr.data(); }
const int32_t *pgcn_feat_indices(const PgcnDataset *ds) { return ds->f_indices.data(); }
const float *pgcn_feat_values(const PgcnDataset *ds) { return ds->f_values.data(); }
const int32_t *pgcn_labels(const PgcnDataset *ds) { return ds->labels.data(); }
const int32_t *pgcn_split(const PgcnDataset *ds) { return ds->split.data(); }

void pgcn_free(PgcnDataset *ds) { delete ds; }

// ---- label propagation (community reorder, data/reorder.py community_order)
//
// Synchronous sweeps: every node adopts the most frequent label among its
// neighbors (ties toward the LARGER label id — matching the NumPy
// lexsort-by-(count,label) reference implementation); rows with no edges keep
// their label. ``rows`` must be sorted ascending (a CSR row expansion).
// The NumPy version pays an O(E log E) full-array sort per sweep (~2 s/sweep
// at reddit scale); here each row's small neighbor-label span sorts
// independently, parallelized over row spans.
void pgcn_community_labels(const int64_t *rows, const int64_t *cols,
                           int64_t nnz, int64_t n, int n_iters,
                           int64_t *labels) {
    if (nnz <= 0 || n <= 0) return;
    std::vector<int64_t> cur(labels, labels + n), nxt(n);
    // row-span starts (rows sorted): spans[k] .. spans[k+1] share one row
    std::vector<int64_t> starts;
    starts.reserve(1 << 20);
    starts.push_back(0);
    for (int64_t i = 1; i < nnz; ++i)
        if (rows[i] != rows[i - 1]) starts.push_back(i);
    starts.push_back(nnz);
    const int64_t n_spans = static_cast<int64_t>(starts.size()) - 1;

    for (int it = 0; it < n_iters; ++it) {
        nxt = cur;
#pragma omp parallel
        {
            std::vector<int64_t> tmp;
#pragma omp for schedule(dynamic, 1024)
            for (int64_t sidx = 0; sidx < n_spans; ++sidx) {
                const int64_t i = starts[sidx], j = starts[sidx + 1];
                tmp.clear();
                for (int64_t k = i; k < j; ++k) tmp.push_back(cur[cols[k]]);
                std::sort(tmp.begin(), tmp.end());
                int64_t best_lab = tmp[0], best_cnt = 0;
                for (size_t k = 0; k < tmp.size();) {
                    const int64_t lab = tmp[k];
                    int64_t c = 0;
                    while (k < tmp.size() && tmp[k] == lab) { ++k; ++c; }
                    if (c > best_cnt || (c == best_cnt && lab > best_lab)) {
                        best_cnt = c;
                        best_lab = lab;
                    }
                }
                nxt[rows[i]] = best_lab;
            }
        }
        cur.swap(nxt);
    }
    std::copy(cur.begin(), cur.end(), labels);
}

}  // extern "C"
