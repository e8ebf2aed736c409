// fftw3_tpu native runtime tier (C++17, C ABI for ctypes).
//
// Re-implementation of the reference's native kernel-tier
// services (the C "kernel" of fftw/fftw_api.c, SURVEY.md §2.1), covering
// the pieces that run on the HOST at plan time and must be fast,
// deterministic, and shareable across processes:
//
//   * MD5 problem hashing          (fftw_md5*, fftw/fftw_api.c:14194-14394)
//   * prime/factor arithmetic      (fftw_is_prime/power_mod/find_generator,
//                                   fftw/fftw_api.c:15750-15915)
//   * wisdom store                 (the planner hashtables + text
//                                   export/import, fftw/fftw_api.c:14927,
//                                   :15466-15700) — thread-safe, with the
//                                   patience-subsumption rule
//   * ESTIMATE-mode c2c search     (the planner's memoized DP over the
//                                   solver space, fftw/fftw_api.c:15195-15700)
//     emitting descriptor trees as JSON, bit-identical in policy to the
//     Python planner so all hosts pick the same plans (the MPI wisdom-vote
//     property, fftw/mpi/api.c:60-130, achieved by determinism instead)
//
// The device compute path stays in XLA; this library is the
// host-side runtime around it.  Python binds via ctypes
// (fftw3_tpu/native.py) and falls back to pure Python when the shared
// library is unavailable.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cmath>
#include <map>
#include <mutex>
#include <string>
#include <vector>
#include <algorithm>

#define API extern "C" __attribute__((visibility("default")))

// ---------------------------------------------------------------------------
// MD5 (self-contained, RFC 1321 layout) — problem-hash backend.
// ---------------------------------------------------------------------------

namespace md5impl {

struct Ctx {
  uint32_t a = 0x67452301u, b = 0xefcdab89u, c = 0x98badcfeu, d = 0x10325476u;
  uint64_t len = 0;
  unsigned char buf[64];
};

static inline uint32_t rol(uint32_t x, int s) {
  return (x << s) | (x >> (32 - s));
}

static const uint32_t K[64] = {
    0xd76aa478, 0xe8c7b756, 0x242070db, 0xc1bdceee, 0xf57c0faf, 0x4787c62a,
    0xa8304613, 0xfd469501, 0x698098d8, 0x8b44f7af, 0xffff5bb1, 0x895cd7be,
    0x6b901122, 0xfd987193, 0xa679438e, 0x49b40821, 0xf61e2562, 0xc040b340,
    0x265e5a51, 0xe9b6c7aa, 0xd62f105d, 0x02441453, 0xd8a1e681, 0xe7d3fbc8,
    0x21e1cde6, 0xc33707d6, 0xf4d50d87, 0x455a14ed, 0xa9e3e905, 0xfcefa3f8,
    0x676f02d9, 0x8d2a4c8a, 0xfffa3942, 0x8771f681, 0x6d9d6122, 0xfde5380c,
    0xa4beea44, 0x4bdecfa9, 0xf6bb4b60, 0xbebfbc70, 0x289b7ec6, 0xeaa127fa,
    0xd4ef3085, 0x04881d05, 0xd9d4d039, 0xe6db99e5, 0x1fa27cf8, 0xc4ac5665,
    0xf4292244, 0x432aff97, 0xab9423a7, 0xfc93a039, 0x655b59c3, 0x8f0ccc92,
    0xffeff47d, 0x85845dd1, 0x6fa87e4f, 0xfe2ce6e0, 0xa3014314, 0x4e0811a1,
    0xf7537e82, 0xbd3af235, 0x2ad7d2bb, 0xeb86d391};

static const int S[64] = {7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22,
                          7, 12, 17, 22, 5, 9,  14, 20, 5, 9,  14, 20,
                          5, 9,  14, 20, 5, 9,  14, 20, 4, 11, 16, 23,
                          4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
                          6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21,
                          6, 10, 15, 21};

static void block(Ctx& c, const unsigned char* p) {
  uint32_t m[16];
  for (int i = 0; i < 16; ++i)
    m[i] = (uint32_t)p[4 * i] | ((uint32_t)p[4 * i + 1] << 8) |
           ((uint32_t)p[4 * i + 2] << 16) | ((uint32_t)p[4 * i + 3] << 24);
  uint32_t a = c.a, b = c.b, cc = c.c, d = c.d;
  for (int i = 0; i < 64; ++i) {
    uint32_t f;
    int g;
    if (i < 16) {
      f = (b & cc) | (~b & d);
      g = i;
    } else if (i < 32) {
      f = (d & b) | (~d & cc);
      g = (5 * i + 1) & 15;
    } else if (i < 48) {
      f = b ^ cc ^ d;
      g = (3 * i + 5) & 15;
    } else {
      f = cc ^ (b | ~d);
      g = (7 * i) & 15;
    }
    uint32_t tmp = d;
    d = cc;
    cc = b;
    b = b + rol(a + f + K[i] + m[g], S[i]);
    a = tmp;
  }
  c.a += a;
  c.b += b;
  c.c += cc;
  c.d += d;
}

static void update(Ctx& c, const unsigned char* p, size_t n) {
  size_t have = (size_t)(c.len & 63);
  c.len += n;
  if (have) {
    size_t need = 64 - have;
    size_t take = n < need ? n : need;
    std::memcpy(c.buf + have, p, take);
    p += take;
    n -= take;
    if (have + take == 64) block(c, c.buf);
    else return;
  }
  while (n >= 64) {
    block(c, p);
    p += 64;
    n -= 64;
  }
  if (n) std::memcpy(c.buf, p, n);
}

static void final(Ctx& c, unsigned char out[16]) {
  uint64_t bits = c.len * 8;
  unsigned char pad[72] = {0x80};
  size_t have = (size_t)(c.len & 63);
  size_t padn = (have < 56) ? (56 - have) : (120 - have);
  update(c, pad, padn);
  unsigned char lb[8];
  for (int i = 0; i < 8; ++i) lb[i] = (unsigned char)(bits >> (8 * i));
  update(c, lb, 8);
  uint32_t regs[4] = {c.a, c.b, c.c, c.d};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) out[4 * i + j] = (unsigned char)(regs[i] >> (8 * j));
}

}  // namespace md5impl

API void ftpu_md5_hex(const unsigned char* data, uint64_t n, char out[33]) {
  md5impl::Ctx c;
  md5impl::update(c, data, (size_t)n);
  unsigned char dig[16];
  md5impl::final(c, dig);
  static const char* hx = "0123456789abcdef";
  for (int i = 0; i < 16; ++i) {
    out[2 * i] = hx[dig[i] >> 4];
    out[2 * i + 1] = hx[dig[i] & 15];
  }
  out[32] = 0;
}

// ---------------------------------------------------------------------------
// prime / factor arithmetic (fftw_is_prime / power_mod / find_generator)
// ---------------------------------------------------------------------------

API int ftpu_is_prime(uint64_t n) {
  if (n < 2) return 0;
  if (n < 4) return 1;
  if (n % 2 == 0) return 0;
  for (uint64_t d = 3; d * d <= n; d += 2)
    if (n % d == 0) return 0;
  return 1;
}

API uint64_t ftpu_largest_prime_factor(uint64_t n) {
  uint64_t last = 1;
  for (uint64_t d = 2; d * d <= n; d += (d == 2 ? 1 : 2))
    while (n % d == 0) {
      last = d;
      n /= d;
    }
  return n > 1 ? n : last;
}

API uint64_t ftpu_power_mod(uint64_t base, uint64_t exp, uint64_t p) {
  // p < 2^32 in practice (transform sizes); use 128-bit products for safety
  unsigned __int128 acc = 1, b = base % p;
  while (exp) {
    if (exp & 1) acc = (acc * b) % p;
    b = (b * b) % p;
    exp >>= 1;
  }
  return (uint64_t)acc;
}

API uint64_t ftpu_find_generator(uint64_t p) {
  if (p == 2) return 1;
  uint64_t phi = p - 1, m = phi;
  uint64_t pf[64];
  int npf = 0;
  for (uint64_t d = 2; d * d <= m; d += (d == 2 ? 1 : 2))
    if (m % d == 0) {
      pf[npf++] = d;
      while (m % d == 0) m /= d;
    }
  if (m > 1) pf[npf++] = m;
  for (uint64_t g = 2; g < p; ++g) {
    bool ok = true;
    for (int i = 0; i < npf && ok; ++i)
      if (ftpu_power_mod(g, phi / pf[i], p) == 1) ok = false;
    if (ok) return g;
  }
  return 0;
}

API uint64_t ftpu_next_fast_size(uint64_t n, uint64_t smooth) {
  for (uint64_t m = n;; ++m)
    if (ftpu_largest_prime_factor(m) <= smooth) return m;
}

// fills out[] with divisors ascending; returns count (or required count if
// capacity too small)
API int32_t ftpu_divisors(uint64_t n, uint64_t* out, int32_t cap) {
  std::vector<uint64_t> small, large;
  for (uint64_t d = 1; d * d <= n; ++d)
    if (n % d == 0) {
      small.push_back(d);
      if (d != n / d) large.push_back(n / d);
    }
  int32_t total = (int32_t)(small.size() + large.size());
  if (total > cap) return total;
  int32_t i = 0;
  for (uint64_t v : small) out[i++] = v;
  for (auto it = large.rbegin(); it != large.rend(); ++it) out[i++] = *it;
  return total;
}

// ---------------------------------------------------------------------------
// wisdom store (blessed-hashtable analog with patience subsumption)
// ---------------------------------------------------------------------------

namespace {

struct Entry {
  std::string desc_json;
  int32_t patience = 0;
  double cost = 0.0;
};

struct Store {
  std::map<std::string, Entry> tab;
  std::mutex mu;
};

std::string escape(const std::string& s) {
  std::string o;
  for (char ch : s) {
    if (ch == '"' || ch == '\\') {
      o += '\\';
      o += ch;
    } else if (ch == '\n') {
      o += "\\n";
    } else {
      o += ch;
    }
  }
  return o;
}

}  // namespace

API void* ftpu_wisdom_new() { return new Store; }
API void ftpu_wisdom_free(void* s) { delete (Store*)s; }

API void ftpu_wisdom_put(void* sv, const char* key, const char* desc_json,
                         int32_t patience, double cost) {
  Store* s = (Store*)sv;
  std::lock_guard<std::mutex> lk(s->mu);
  Entry& e = s->tab[key];
  // subsumption: a more-patient entry is never overwritten by a less-patient
  // one (the l/u lattice `subsumes` rule, fftw/fftw_api.c:14748)
  if (e.desc_json.empty() || patience >= e.patience) {
    e.desc_json = desc_json;
    e.patience = patience;
    e.cost = cost;
  }
}

// returns 1 on hit with patience >= wanted; fills caller buffers
API int32_t ftpu_wisdom_get(void* sv, const char* key, int32_t min_patience,
                            char* desc_out, int32_t cap, int32_t* patience_out,
                            double* cost_out) {
  Store* s = (Store*)sv;
  std::lock_guard<std::mutex> lk(s->mu);
  auto it = s->tab.find(key);
  if (it == s->tab.end() || it->second.patience < min_patience) return 0;
  const Entry& e = it->second;
  if ((int32_t)e.desc_json.size() + 1 > cap) return -(int32_t)e.desc_json.size() - 1;
  std::memcpy(desc_out, e.desc_json.c_str(), e.desc_json.size() + 1);
  *patience_out = e.patience;
  *cost_out = e.cost;
  return 1;
}

API void ftpu_wisdom_forget(void* sv) {
  Store* s = (Store*)sv;
  std::lock_guard<std::mutex> lk(s->mu);
  s->tab.clear();
}

API int64_t ftpu_wisdom_size(void* sv) {
  Store* s = (Store*)sv;
  std::lock_guard<std::mutex> lk(s->mu);
  return (int64_t)s->tab.size();
}

// export as JSON object {key: {"desc": <tree>, "patience": p, "cost": c}};
// returns length (caller then calls with big-enough buffer)
API int64_t ftpu_wisdom_export(void* sv, char* out, int64_t cap) {
  Store* s = (Store*)sv;
  std::lock_guard<std::mutex> lk(s->mu);
  std::string j = "{";
  bool first = true;
  for (auto& kv : s->tab) {
    if (!first) j += ",";
    first = false;
    char num[64];
    snprintf(num, sizeof num, "%d", kv.second.patience);
    std::string pat = num;
    snprintf(num, sizeof num, "%.17g", kv.second.cost);
    j += "\"" + escape(kv.first) + "\":{\"desc\":" + kv.second.desc_json +
         ",\"patience\":" + pat + ",\"cost\":" + std::string(num) + "}";
  }
  j += "}";
  if ((int64_t)j.size() + 1 <= cap && out) std::memcpy(out, j.c_str(), j.size() + 1);
  return (int64_t)j.size() + 1;
}

// ---------------------------------------------------------------------------
// ESTIMATE-mode c2c planner search (DP over the solver space)
//
// Mirrors fftw3_tpu/planner.py exactly: same candidate set, same cost
// formulas, same tie-breaking (first minimum in candidate order), so Python
// and native planners always produce identical descriptor trees.
// ---------------------------------------------------------------------------

namespace search {

// planner.HardwareModel's f32 rates; Python passes them from the device
// table (fftw3_tpu/devices.py)
struct HW {
  double hbm_bw = 0.0;
  double matmul_flops = 0.0;
  double elem_flops = 0.0;
  double matmul_k = 1.0;
  double gather_penalty = 0.0;
  double matmul_eff(double k) const {
    return std::min(k, matmul_k) / matmul_k;
  }
};

struct Params {
  HW hw;
  int direct_max = 128;
  int generic_max = 2048;
  int r2r_generic_max = 4096;
  int patience = 0;          // ESTIMATE ladder position (candidate width)
};

struct Node {
  std::string alg;
  std::string kind;          // r2r_matmul only
  long n = 0, p = 0, m = 0;
  int child = -1;            // index into pool
  int child2 = -1;           // second child of the split r2r algs
};

struct Ctx {
  Params prm;
  std::vector<Node> pool;
  std::map<long, int> memo;  // n -> pool index of best plan
  std::map<long, double> memo_cost;
  // (kind, n) -> pool index for the non-c2c kinds
  std::map<std::pair<std::string, long>, int> kmemo;
};

double cost_of(const Ctx& c, int idx);

double node_cost(const Ctx& c, const Node& nd) {
  const HW& hw = c.prm.hw;
  double el = 8.0, n = (double)nd.n;
  if (nd.alg == "nop" || nd.n == 1) return 0.0;
  if (nd.alg == "direct")
    return 2 * el * n / hw.hbm_bw +
           8.0 * n * n / (hw.matmul_flops * hw.matmul_eff(n));
  if (nd.alg == "mixed") {
    double p = (double)nd.p;
    // ~2 HBM round trips per XLA stage (einsum + final axis swap);
    // keep in sync with the Python planner
    double stage = 4 * el * n / hw.hbm_bw +
                   8.0 * p * n / (hw.matmul_flops * hw.matmul_eff(p)) +
                   6.0 * n / hw.elem_flops;
    return stage + p * cost_of(c, nd.child);
  }
  if (nd.alg == "bluestein") {
    double m = (double)nd.m;
    double extra = 6.0 * el * m / hw.hbm_bw + 12.0 * m / hw.elem_flops;
    return 2 * cost_of(c, nd.child) + extra;
  }
  if (nd.alg == "rader") {
    double extra = hw.gather_penalty * 4 * el * n / hw.hbm_bw;
    return 2 * cost_of(c, nd.child) + 6.0 * n / hw.elem_flops + extra;
  }
  return 1e30;
}

double cost_of(const Ctx& c, int idx) {
  return node_cost(c, c.pool[idx]);
}

long largest_pf(long n) { return (long)ftpu_largest_prime_factor((uint64_t)n); }

long next_pow2(long n) {
  long m = 1;
  while (m < n) m *= 2;
  return m;
}

std::vector<long> divisors_of(long n) {
  std::vector<long> small, large;
  for (long d = 1; d * d <= n; ++d)
    if (n % d == 0) {
      small.push_back(d);
      if (d != n / d) large.push_back(n / d);
    }
  small.insert(small.end(), large.rbegin(), large.rend());
  return small;
}

// mirror of planner._mixed_factor_candidates
std::vector<long> mixed_factors(long n, int direct_max, int patience) {
  std::vector<long> divs;
  for (long d : divisors_of(n))
    if (d >= 2 && d <= direct_max && d != n) divs.push_back(d);
  std::stable_sort(divs.begin(), divs.end(), [n](long a, long b) {
    double ba = std::fabs(std::log2((double)a * a / n));
    double bb = std::fabs(std::log2((double)b * b / n));
    if (ba != bb) return ba < bb;
    return a > b;
  });
  int width[4] = {3, 4, 8, 64};
  int w = width[std::min(std::max(patience, 0), 3)];
  if ((int)divs.size() > w) divs.resize(w);
  return divs;
}

int plan_c2c(Ctx& c, long n);

int add_node(Ctx& c, Node nd) {
  c.pool.push_back(std::move(nd));
  return (int)c.pool.size() - 1;
}

int plan_c2c(Ctx& c, long n) {
  auto hit = c.memo.find(n);
  if (hit != c.memo.end()) return hit->second;
  const Params& P = c.prm;
  std::vector<int> cands;
  if (n == 1) {
    Node nd;
    nd.alg = "nop";
    nd.n = 1;
    int i = add_node(c, nd);
    c.memo[n] = i;
    return i;
  }
  if (n <= P.direct_max ||
      (n <= P.generic_max && largest_pf(n) > 64)) {
    Node nd;
    nd.alg = "direct";
    nd.n = n;
    cands.push_back(add_node(c, nd));
  }
  for (long p : mixed_factors(n, P.direct_max, P.patience)) {
    Node nd;
    nd.alg = "mixed";
    nd.n = n;
    nd.p = p;
    nd.child = plan_c2c(c, n / p);
    cands.push_back(add_node(c, nd));
  }
  long lpf = largest_pf(n);
  if (lpf > P.direct_max || (P.patience >= 2 && n > 16)) {
    Node nd;
    nd.alg = "bluestein";
    nd.n = n;
    nd.m = next_pow2(2 * n - 1);
    nd.child = plan_c2c(c, nd.m);
    cands.push_back(add_node(c, nd));
    if (P.patience >= 2) {
      long m5 = 2 * n - 1;
      while (largest_pf(m5) > 5) ++m5;
      if (m5 != nd.m) {
        Node nd5;
        nd5.alg = "bluestein";
        nd5.n = n;
        nd5.m = m5;
        nd5.child = plan_c2c(c, m5);
        cands.push_back(add_node(c, nd5));
      }
    }
  }
  if (ftpu_is_prime((uint64_t)n) && n > P.direct_max) {
    Node nd;
    nd.alg = "rader";
    nd.n = n;
    nd.child = plan_c2c(c, n - 1);
    cands.push_back(add_node(c, nd));
  }
  // first minimum wins (same tie-break as Python's min())
  int best = -1;
  double bestc = 0;
  for (int i : cands) {
    double ci = cost_of(c, i);
    if (best < 0 || ci < bestc) {
      best = i;
      bestc = ci;
    }
  }
  c.memo[n] = best;
  c.memo_cost[n] = bestc;
  return best;
}

// ---------------------------------------------------------------------------
// r2c / c2r / r2r ESTIMATE searches — mirrors of planner._candidates and
// planner._cost for the real-transform kinds (same candidate order, same
// cost formulas, first-minimum tie-break)
// ---------------------------------------------------------------------------

int plan_kind(Ctx& c, const std::string& kind, long n);

double kind_cost(Ctx& c, const std::string& kind, int idx);

// r2c/c2r candidate costs (planner._cost, the r2c/c2r branch)
double real_cost(Ctx& c, const Node& nd) {
  const HW& hw = c.prm.hw;
  double n = (double)nd.n;
  if (nd.alg == "r2c_dense" || nd.alg == "c2r_dense")
    return 12.0 * n / hw.hbm_bw +
           2.0 * n * (double)(nd.n / 2 + 1) /
               (hw.matmul_flops * hw.matmul_eff(n));
  if (nd.alg == "r2c_pack" || nd.alg == "c2r_pack")
    return 0.55 * cost_of(c, nd.child) + 16.0 * n / hw.hbm_bw;
  return cost_of(c, nd.child) + 16.0 * n / hw.hbm_bw;  // via_c2c
}

int plan_real(Ctx& c, const std::string& kind, long n) {
  auto key = std::make_pair(kind, n);
  auto hit = c.kmemo.find(key);
  if (hit != c.kmemo.end()) return hit->second;
  const Params& P = c.prm;
  bool is_r2c = kind == "r2c";
  std::vector<int> cands;
  if (n <= P.r2r_generic_max) {
    Node nd;
    nd.alg = is_r2c ? "r2c_dense" : "c2r_dense";
    nd.n = n;
    cands.push_back(add_node(c, nd));
  }
  if (n % 2 == 0 && n > 2) {
    Node nd;
    nd.alg = is_r2c ? "r2c_pack" : "c2r_pack";
    nd.n = n;
    nd.child = plan_c2c(c, n / 2);
    cands.push_back(add_node(c, nd));
  }
  {
    Node nd;
    nd.alg = is_r2c ? "r2c_via_c2c" : "c2r_via_c2c";
    nd.n = n;
    nd.child = plan_c2c(c, n);
    cands.push_back(add_node(c, nd));
  }
  int best = -1;
  double bestc = 0;
  for (int i : cands) {
    double ci = real_cost(c, c.pool[i]);
    if (best < 0 || ci < bestc) { best = i; bestc = ci; }
  }
  c.kmemo[key] = best;
  return best;
}

double r2r_cost(Ctx& c, const Node& nd);

// cost of an already-planned node of the given kind
double kind_cost(Ctx& c, const std::string& kind, int idx) {
  if (kind == "c2c") return cost_of(c, idx);
  if (kind == "r2c" || kind == "c2r") return real_cost(c, c.pool[idx]);
  return r2r_cost(c, c.pool[idx]);
}

double r2r_cost(Ctx& c, const Node& nd) {
  const HW& hw = c.prm.hw;
  double n = (double)nd.n;
  if (nd.alg == "r2r_matmul")
    return 8.0 * n / hw.hbm_bw +
           2.0 * n * n / (hw.matmul_flops * hw.matmul_eff(n));
  if (nd.alg == "redft00_split" || nd.alg == "rodft00_split")
    return r2r_cost(c, c.pool[nd.child]) + r2r_cost(c, c.pool[nd.child2]) +
           8.0 * n / hw.hbm_bw;
  // reduction table: child kind decides the recursion + the pass cost
  std::string ck;
  if (nd.alg == "hc2r_via_c2r" || nd.alg == "redft01_half") ck = "c2r";
  else if (nd.alg == "redft11_2n") ck = "c2c";
  else if (nd.alg == "rodft10_flip" || nd.alg == "rodft01_flip" ||
           nd.alg == "rodft11_flip" || nd.alg == "redft11_odd") ck = "r2r";
  else ck = "r2c";
  if (ck == "r2r")
    return kind_cost(c, ck, nd.child) + 8.0 * n / hw.hbm_bw;
  return kind_cost(c, ck, nd.child) + 16.0 * n / hw.hbm_bw;
}

int plan_r2r(Ctx& c, const std::string& kind, long n) {
  auto key = std::make_pair(kind, n);
  auto hit = c.kmemo.find(key);
  if (hit != c.kmemo.end()) return hit->second;
  const Params& P = c.prm;
  std::vector<int> cands;
  auto red = [&](const char* alg, const std::string& ck, long cn) {
    Node nd;
    nd.alg = alg;
    nd.n = n;
    nd.child = plan_kind(c, ck, cn);
    cands.push_back(add_node(c, nd));
  };
  if (kind == "dht") red("dht_via_r2c", "r2c", n);
  else if (kind == "r2hc") red("r2hc_via_r2c", "r2c", n);
  else if (kind == "hc2r") red("hc2r_via_c2r", "c2r", n);
  else if (kind == "redft10") red("redft10_half", "r2c", n);
  else if (kind == "redft01") red("redft01_half", "c2r", n);
  else if (kind == "redft00" && n > 1) {
    red("redft00_ext", "r2c", 2 * (n - 1));
    if (n % 2 == 1 && n >= 5) {
      Node nd;
      nd.alg = "redft00_split";
      nd.n = n;
      nd.child = plan_r2r(c, "redft00", (n + 1) / 2);
      nd.child2 = plan_r2r(c, "redft10", (n - 1) / 2);
      cands.push_back(add_node(c, nd));
    }
  } else if (kind == "rodft00") {
    red("rodft00_ext", "r2c", 2 * (n + 1));
    if (n % 2 == 1 && n >= 5) {
      Node nd;
      nd.alg = "rodft00_split";
      nd.n = n;
      nd.child = plan_r2r(c, "rodft00", (n - 1) / 2);
      nd.child2 = plan_r2r(c, "rodft10", (n + 1) / 2);
      cands.push_back(add_node(c, nd));
    }
  } else if (kind == "redft11") {
    red("redft11_2n", "c2c", 2 * n);
    if (n % 2 == 1) red("redft11_odd", "r2r_r2hc", n);
  } else if (kind == "rodft10") red("rodft10_flip", "r2r_redft10", n);
  else if (kind == "rodft01") red("rodft01_flip", "r2r_redft01", n);
  else if (kind == "rodft11") red("rodft11_flip", "r2r_redft11", n);
  if (n <= P.r2r_generic_max) {
    Node nd;
    nd.alg = "r2r_matmul";
    nd.kind = kind;
    nd.n = n;
    cands.push_back(add_node(c, nd));
  }
  int best = -1;
  double bestc = 0;
  for (int i : cands) {
    double ci = r2r_cost(c, c.pool[i]);
    if (best < 0 || ci < bestc) { best = i; bestc = ci; }
  }
  c.kmemo[key] = best;
  return best;
}

// dispatch on kind; "r2r_<kind>" routes to the r2r table (flip children)
int plan_kind(Ctx& c, const std::string& kind, long n) {
  if (kind == "c2c") return plan_c2c(c, n);
  if (kind == "r2c" || kind == "c2r") return plan_real(c, kind, n);
  if (kind.rfind("r2r_", 0) == 0) return plan_r2r(c, kind.substr(4), n);
  return plan_r2r(c, kind, n);
}

void to_json(const Ctx& c, int idx, std::string& out) {
  const Node& nd = c.pool[idx];
  char buf[64];
  out += "{\"alg\": \"" + nd.alg + "\", \"n\": ";
  snprintf(buf, sizeof buf, "%ld", nd.n);
  out += buf;
  if (!nd.kind.empty()) out += ", \"kind\": \"" + nd.kind + "\"";
  if (nd.child2 >= 0) {       // split r2r algs carry a children pair
    out += ", \"children\": [";
    to_json(c, nd.child, out);
    out += ", ";
    to_json(c, nd.child2, out);
    out += "]}";
    return;
  }
  if (nd.alg == "mixed") {
    snprintf(buf, sizeof buf, ", \"p\": %ld", nd.p);
    out += buf;
  }
  if (nd.alg == "bluestein") {
    snprintf(buf, sizeof buf, ", \"m\": %ld", nd.m);
    out += buf;
  }
  if (nd.child >= 0) {
    out += ", \"child\": ";
    to_json(c, nd.child, out);
  }
  out += "}";
}

}  // namespace search

// Plan a c2c transform of size n at ESTIMATE patience; writes the JSON
// descriptor tree.  Returns required buffer length (call again if > cap).
static search::HW make_hw(double hbm_bw, double matmul_flops,
                          double elem_flops, double matmul_k,
                          double gather_penalty) {
  search::HW hw;
  hw.hbm_bw = hbm_bw;
  hw.matmul_flops = matmul_flops;
  hw.elem_flops = elem_flops;
  hw.matmul_k = matmul_k;
  hw.gather_penalty = gather_penalty;
  return hw;
}

API int64_t ftpu_plan_c2c(int64_t n, int32_t patience, double hbm_bw,
                          double matmul_flops, double elem_flops,
                          double matmul_k, double gather_penalty,
                          int32_t direct_max, int32_t generic_max,
                          char* out, int64_t cap) {
  search::Ctx c;
  c.prm.hw = make_hw(hbm_bw, matmul_flops, elem_flops, matmul_k,
                     gather_penalty);
  c.prm.direct_max = direct_max;
  c.prm.generic_max = generic_max;
  c.prm.patience = patience;
  int root = search::plan_c2c(c, (long)n);
  if (root < 0) return -1;
  std::string j;
  search::to_json(c, root, j);
  if ((int64_t)j.size() + 1 <= cap && out) std::memcpy(out, j.c_str(), j.size() + 1);
  return (int64_t)j.size() + 1;
}

// Plan ANY kind ("c2c", "r2c", "c2r", or an r2r kind name like "redft10")
// at ESTIMATE patience; same contract as ftpu_plan_c2c.
API int64_t ftpu_plan_kind(const char* kind, int64_t n, int32_t patience,
                           double hbm_bw, double matmul_flops,
                           double elem_flops, double matmul_k,
                           double gather_penalty, int32_t direct_max,
                           int32_t generic_max, int32_t r2r_generic_max,
                           char* out, int64_t cap) {
  search::Ctx c;
  c.prm.hw = make_hw(hbm_bw, matmul_flops, elem_flops, matmul_k,
                     gather_penalty);
  c.prm.direct_max = direct_max;
  c.prm.generic_max = generic_max;
  c.prm.r2r_generic_max = r2r_generic_max;
  c.prm.patience = patience;
  int root = search::plan_kind(c, std::string(kind), (long)n);
  if (root < 0) return -1;
  std::string j;
  search::to_json(c, root, j);
  if ((int64_t)j.size() + 1 <= cap && out) std::memcpy(out, j.c_str(), j.size() + 1);
  return (int64_t)j.size() + 1;
}

API const char* ftpu_version() { return "fftw3-tpu-native-1"; }
