// Host-side data layer of the port: Matrix Market parsing, COO->CSR
// conversion and a Matrix Market writer.  Host C++ built by g++ (not a
// device kernel) at first use, by utils/host_build.py, into build/.
//
// C++ equivalents of the reference ingest hot loops:
//   * CooMatrix::InitMarket (sparse_matrix.h:217-380): banner detection
//     (symmetric / skew / array / pattern), strtol/strtod per-entry fast
//     path (:328-356), 1-based->0-based conversion (:357), symmetric
//     expansion (:362-368), defaulted values for pattern files.
//   * CsrMatrix::Init (sparse_matrix.h:666-728): stable sort by (row, col)
//     (:676) and row-offset construction with empty-row backfill
//     (:707-727); duplicate coordinates are retained as distinct nonzeros.
//
// The parser and COO->CSR are the same C ABI (msp_*) as the TPU package's
// native/market_io.cpp, with the same results element for element.  The
// writer (msp_write_market) is this port's: the text of
// formats/market.py::write_market's Python loop, byte for byte, with each
// value in Python's repr() form (shortest round-trip digits, fixed
// notation for decimal exponents -4 < decpt <= 16, else scientific with a
// signed exponent of at least two digits), formatted in parallel blocks.
// It needs floating-point std::to_chars (GCC 11 or later); without it the
// symbol is left out and the Python writer runs.
//
// Consumed by formats/native_io.py via ctypes.

#include <algorithm>
#include <charconv>
#include <cmath>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <string>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#include <parallel/algorithm>
#define MSP_STABLE_SORT __gnu_parallel::stable_sort
#else
#define MSP_STABLE_SORT std::stable_sort
#endif

extern "C" {

struct MspCoo {
  int64_t num_rows = 0;
  int64_t num_cols = 0;
  std::vector<int32_t> rows;
  std::vector<int32_t> cols;
  std::vector<double> vals;
  std::string error;
};

// ---------------------------------------------------------------------- //
// Matrix Market parser
// ---------------------------------------------------------------------- //

static const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
    ++p;
  return p;
}

static const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

MspCoo* msp_read_market(const char* path, double default_value) {
  auto* m = new MspCoo();
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    m->error = std::string("cannot open ") + path;
    return m;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  if (std::fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    m->error = "short read";
    return m;
  }
  std::fclose(f);
  buf[size] = '\0';
  const char* p = buf.data();
  const char* end = p + size;

  bool symmetric = false, skew = false, array = false;
  // banner + comments (sparse_matrix.h:259-272)
  while (p < end) {
    p = skip_ws(p, end);
    if (p >= end) break;
    if (*p == '%') {
      if (p + 1 < end && p[1] == '%') {
        const char* e = p;
        while (e < end && *e != '\n') ++e;
        std::string banner(p, e);
        for (auto& c : banner) c = static_cast<char>(tolower(c));
        symmetric = banner.find("symmetric") != std::string::npos;
        skew = banner.find("skew") != std::string::npos;
        array = banner.find("array") != std::string::npos;
      }
      p = next_line(p, end);
      continue;
    }
    break;
  }
  // size line — tokens must not spill into the next line
  const char* line_end = p;
  while (line_end < end && *line_end != '\n') ++line_end;
  char* q = nullptr;
  long long nr = strtoll(p, &q, 10);
  long long nc = strtoll(q, &q, 10);
  long long ne = array ? nr * nc : strtoll(q, &q, 10);
  if (q > line_end || q == p) {
    m->error = "invalid size line";
    return m;
  }
  p = q;
  m->num_rows = nr;
  m->num_cols = nc;
  if (nr <= 0 || nc <= 0 || ne < 0) {
    m->error = "invalid size line";
    return m;
  }

  if (array) {
    // dense column-major value list (sparse_matrix.h:320-325)
    m->rows.resize(ne);
    m->cols.resize(ne);
    m->vals.resize(ne);
    for (long long i = 0; i < ne; ++i) {
      double v = strtod(p, &q);
      if (q == p) {
        m->error = "array value parse error at entry " + std::to_string(i);
        return m;
      }
      p = q;
      m->rows[i] = static_cast<int32_t>(i % nr);
      m->cols[i] = static_cast<int32_t>(i / nr);
      m->vals[i] = v;
    }
    return m;
  }

  size_t cap = static_cast<size_t>(symmetric ? 2 * ne : ne);
  m->rows.reserve(cap);
  m->cols.reserve(cap);
  m->vals.reserve(cap);
  for (long long i = 0; i < ne; ++i) {
    long r = strtol(p, &q, 10);
    if (q == p) {
      m->error = "entry parse error at " + std::to_string(i);
      return m;
    }
    p = q;
    long c = strtol(p, &q, 10);
    if (q == p) {
      m->error = "entry parse error at " + std::to_string(i);
      return m;
    }
    p = q;
    // optional value token on the same line (pattern files omit it,
    // sparse_matrix.h:341-353); scan without crossing the newline
    double v = default_value;
    const char* s = p;
    while (s < end && (*s == ' ' || *s == '\t' || *s == '\r')) ++s;
    if (s < end && *s != '\n') {
      v = strtod(s, &q);
      if (q != s) p = q;
    }
    int32_t r0 = static_cast<int32_t>(r - 1);   // 1-based → 0-based
    int32_t c0 = static_cast<int32_t>(c - 1);
    m->rows.push_back(r0);
    m->cols.push_back(c0);
    m->vals.push_back(v);
    if (symmetric && r0 != c0) {                // mirrored expansion
      m->rows.push_back(c0);
      m->cols.push_back(r0);
      m->vals.push_back(skew ? -v : v);
    }
  }
  return m;
}

int64_t msp_coo_num_rows(const MspCoo* m) { return m->num_rows; }
int64_t msp_coo_num_cols(const MspCoo* m) { return m->num_cols; }
int64_t msp_coo_nnz(const MspCoo* m) {
  return static_cast<int64_t>(m->vals.size());
}
const char* msp_coo_error(const MspCoo* m) {
  return m->error.empty() ? nullptr : m->error.c_str();
}

void msp_coo_copy(const MspCoo* m, int32_t* rows, int32_t* cols,
                  double* vals) {
  std::memcpy(rows, m->rows.data(), m->rows.size() * sizeof(int32_t));
  std::memcpy(cols, m->cols.data(), m->cols.size() * sizeof(int32_t));
  std::memcpy(vals, m->vals.data(), m->vals.size() * sizeof(double));
}

void msp_coo_free(MspCoo* m) { delete m; }

// ---------------------------------------------------------------------- //
// COO → CSR (stable (row, col) order, duplicates kept, empty-row backfill)
// ---------------------------------------------------------------------- //

void msp_coo_to_csr(int64_t nnz, int64_t num_rows, const int32_t* rows,
                    const int32_t* cols, const double* vals,
                    int32_t* row_offsets,  /* out: num_rows + 1 */
                    int32_t* out_cols,     /* out: nnz */
                    double* out_vals) {    /* out: nnz */
  std::vector<int64_t> perm(nnz);
  std::iota(perm.begin(), perm.end(), int64_t{0});
  MSP_STABLE_SORT(perm.begin(), perm.end(), [&](int64_t a, int64_t b) {
    if (rows[a] != rows[b]) return rows[a] < rows[b];
    return cols[a] < cols[b];
  });

#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < nnz; ++i) {
    out_cols[i] = cols[perm[i]];
    out_vals[i] = vals[perm[i]];
  }

  // row_offsets with empty-row backfill (sparse_matrix.h:707-727)
  int64_t prev = -1;
  for (int64_t i = 0; i < nnz; ++i) {
    int64_t r = rows[perm[i]];
    for (int64_t k = prev + 1; k <= r; ++k)
      row_offsets[k] = static_cast<int32_t>(i);
    prev = std::max(prev, r);
  }
  for (int64_t k = prev + 1; k <= num_rows; ++k)
    row_offsets[k] = static_cast<int32_t>(nnz);
}

// ---------------------------------------------------------------------- //
// Matrix Market writer: header (given) + "r c repr(v)\n" per entry
// ---------------------------------------------------------------------- //

#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L

// repr() of a double as CPython prints it (Python/pystrtod.c, 'r' mode
// with Py_DTSF_ADD_DOT_0): the shortest digits that round-trip, placed in
// fixed notation when -4 < decpt <= 16, else as d.ddde[+-]XX.
static char* py_repr(double v, char* out) {
  if (std::isnan(v)) {
    std::memcpy(out, "nan", 3);
    return out + 3;
  }
  if (std::isinf(v)) {
    if (v < 0) *out++ = '-';
    std::memcpy(out, "inf", 3);
    return out + 3;
  }
  char buf[48];
  auto res = std::to_chars(buf, buf + sizeof(buf), v,
                           std::chars_format::scientific);
  const char* p = buf;
  if (*p == '-') {
    *out++ = '-';
    ++p;
  }
  char digits[32];
  int nd = 0;
  while (p < res.ptr && *p != 'e') {
    if (*p != '.') digits[nd++] = *p;
    ++p;
  }
  // the signed exponent after 'e' (to_chars writes no terminating NUL)
  int exp10 = 0;
  for (const char* d = p + 2; d < res.ptr; ++d)
    exp10 = 10 * exp10 + (*d - '0');
  if (p[1] == '-') exp10 = -exp10;
  const int decpt = exp10 + 1;   // v = 0.digits * 10^decpt
  if (decpt <= -4 || decpt > 16) {
    *out++ = digits[0];
    if (nd > 1) {
      *out++ = '.';
      std::memcpy(out, digits + 1, nd - 1);
      out += nd - 1;
    }
    int e = decpt - 1;
    *out++ = 'e';
    *out++ = e < 0 ? '-' : '+';
    if (e < 0) e = -e;
    if (e < 10) *out++ = '0';
    out = std::to_chars(out, out + 8, e).ptr;
  } else if (decpt <= 0) {
    *out++ = '0';
    *out++ = '.';
    for (int i = 0; i < -decpt; ++i) *out++ = '0';
    std::memcpy(out, digits, nd);
    out += nd;
  } else if (decpt >= nd) {
    std::memcpy(out, digits, nd);
    out += nd;
    for (int i = nd; i < decpt; ++i) *out++ = '0';
    *out++ = '.';
    *out++ = '0';
  } else {
    std::memcpy(out, digits, decpt);
    out += decpt;
    *out++ = '.';
    std::memcpy(out, digits + decpt, nd - decpt);
    out += nd - decpt;
  }
  return out;
}

// Writes `header` and then one "row+1 col+1 repr(value)\n" line per entry.
// Blocks of entries are formatted in parallel and written in order.
// Returns 0, or the errno of the failed open / write / close.
int msp_write_market(const char* path, const char* header, int64_t nnz,
                     const int64_t* rows, const int64_t* cols,
                     const double* vals) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return errno ? errno : -1;
  const size_t hlen = std::strlen(header);
  if (std::fwrite(header, 1, hlen, f) != hlen) {
    int e = errno ? errno : -1;
    std::fclose(f);
    return e;
  }
  // one line: two int64 (<= 20 chars each), repr (<= 24), 3 separators
  constexpr int64_t kLine = 72;
  constexpr int64_t kBlock = 1 << 16;
  int workers = 1;
#if defined(_OPENMP)
  workers = omp_get_max_threads();
#endif
  std::vector<std::vector<char>> bufs(workers,
                                      std::vector<char>(kBlock * kLine));
  std::vector<int64_t> used(workers, 0);
  const int64_t nblocks = (nnz + kBlock - 1) / kBlock;
  int err = 0;
  for (int64_t b0 = 0; b0 < nblocks && !err; b0 += workers) {
    const int64_t nb = std::min<int64_t>(workers, nblocks - b0);
#if defined(_OPENMP)
#pragma omp parallel for schedule(static, 1)
#endif
    for (int64_t k = 0; k < nb; ++k) {
      char* out = bufs[k].data();
      const int64_t lo = (b0 + k) * kBlock;
      const int64_t hi = std::min(nnz, lo + kBlock);
      for (int64_t i = lo; i < hi; ++i) {
        out = std::to_chars(out, out + 24, rows[i] + 1).ptr;
        *out++ = ' ';
        out = std::to_chars(out, out + 24, cols[i] + 1).ptr;
        *out++ = ' ';
        out = py_repr(vals[i], out);
        *out++ = '\n';
      }
      used[k] = out - bufs[k].data();
    }
    for (int64_t k = 0; k < nb && !err; ++k)
      if (std::fwrite(bufs[k].data(), 1, used[k], f)
          != static_cast<size_t>(used[k]))
        err = errno ? errno : -1;
  }
  if (std::fclose(f) != 0 && !err) err = errno ? errno : -1;
  return err;
}

#endif  // floating-point std::to_chars

}  // extern "C"
