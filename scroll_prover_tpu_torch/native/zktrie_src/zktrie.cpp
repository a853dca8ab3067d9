// Poseidon sparse Merkle trie (zktrie) — C++ native component.
//
// Role parity with the reference's Go zktrie linked via gobuild/cgo
// (SURVEY.md section 2.2 native component #1): Poseidon-hashed sparse
// binary Merkle trie holding account/storage state, with root computation
// and Merkle path extraction for witness generation.
//
// Field arithmetic: BN254 Fr as 4x64-bit Montgomery (CIOS with __int128).
// Poseidon parameters (round constants, MDS, Montgomery constants) are
// injected at init by the Python side (hashes/poseidon.py generates them
// with the standard Grain procedure), keeping one source of truth.
//
// Trie spec (matches trie/zktrie.py's Python reference implementation):
//   empty subtree hash = 0
//   leaf hash          = poseidon_hash2(key, value, domain=1)
//   internal hash      = poseidon_hash2(left, right, domain=0)
//   path bits          = little-endian bits of the key, max DEPTH levels,
//                        path-compressed: a subtree holding exactly one
//                        leaf hashes to that leaf directly (Scroll-style
//                        early termination)
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <vector>

using u64 = uint64_t;
using u128 = unsigned __int128;

struct Fr {
  u64 v[4];
  bool operator<(const Fr& o) const {
    for (int i = 3; i >= 0; --i) {
      if (v[i] != o.v[i]) return v[i] < o.v[i];
    }
    return false;
  }
  bool operator==(const Fr& o) const {
    return !memcmp(v, o.v, sizeof(v));
  }
};

static Fr P;        // modulus
static u64 N0INV;   // -p^-1 mod 2^64
static Fr R2;       // R^2 mod p (to-Montgomery multiplier)
static Fr RC[65][3];
static Fr MDS[3][3];
static int R_F = 8, R_P = 57;
static bool INITED = false;

static inline bool geq(const Fr& a, const Fr& b) {
  for (int i = 3; i >= 0; --i) {
    if (a.v[i] != b.v[i]) return a.v[i] > b.v[i];
  }
  return true;
}

static inline Fr sub_p(const Fr& a) {
  Fr r;
  u64 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.v[i] - P.v[i] - borrow;
    r.v[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  return r;
}

static Fr add(const Fr& a, const Fr& b) {
  Fr r;
  u64 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a.v[i] + b.v[i] + carry;
    r.v[i] = (u64)s;
    carry = (u64)(s >> 64);
  }
  if (carry || geq(r, P)) r = sub_p(r);
  return r;
}

// CIOS Montgomery multiplication (4 limbs of 64 bits).
static Fr mont_mul(const Fr& a, const Fr& b) {
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u64 c = 0;
    for (int j = 0; j < 4; ++j) {
      u128 s = (u128)t[j] + (u128)a.v[i] * b.v[j] + c;
      t[j] = (u64)s;
      c = (u64)(s >> 64);
    }
    u128 s = (u128)t[4] + c;
    t[4] = (u64)s;
    t[5] = (u64)(s >> 64);
    u64 m = t[0] * N0INV;
    u128 s2 = (u128)t[0] + (u128)m * P.v[0];
    c = (u64)(s2 >> 64);
    for (int j = 1; j < 4; ++j) {
      u128 s3 = (u128)t[j] + (u128)m * P.v[j] + c;
      t[j - 1] = (u64)s3;
      c = (u64)(s3 >> 64);
    }
    u128 s4 = (u128)t[4] + c;
    t[3] = (u64)s4;
    t[4] = t[5] + (u64)(s4 >> 64);
    t[5] = 0;
  }
  Fr r = {{t[0], t[1], t[2], t[3]}};
  if (t[4] || geq(r, P)) r = sub_p(r);
  return r;
}

static Fr to_mont(const Fr& a) { return mont_mul(a, R2); }

static Fr from_mont(const Fr& a) {
  Fr one = {{1, 0, 0, 0}};
  return mont_mul(a, one);
}

static Fr sbox(const Fr& x) {
  Fr x2 = mont_mul(x, x);
  Fr x4 = mont_mul(x2, x2);
  return mont_mul(x4, x);
}

// Poseidon permutation on 3 Montgomery-form elements.
static void permute(Fr s[3]) {
  int half = R_F / 2;
  int rnd = 0;
  for (int phase = 0; phase < 3; ++phase) {
    int count = (phase == 1) ? R_P : half;
    bool full = (phase != 1);
    for (int k = 0; k < count; ++k, ++rnd) {
      for (int j = 0; j < 3; ++j) s[j] = add(s[j], RC[rnd][j]);
      if (full) {
        for (int j = 0; j < 3; ++j) s[j] = sbox(s[j]);
      } else {
        s[0] = sbox(s[0]);
      }
      Fr out[3];
      for (int i = 0; i < 3; ++i) {
        Fr acc = mont_mul(MDS[i][0], s[0]);
        acc = add(acc, mont_mul(MDS[i][1], s[1]));
        acc = add(acc, mont_mul(MDS[i][2], s[2]));
        out[i] = acc;
      }
      for (int i = 0; i < 3; ++i) s[i] = out[i];
    }
  }
}

// hash2(a, b, domain): permute([a, b, domain])[0] — all standard form.
static Fr hash2(const Fr& a, const Fr& b, const Fr& domain) {
  Fr s[3] = {to_mont(a), to_mont(b), to_mont(domain)};
  permute(s);
  return from_mont(s[0]);
}

// ---------------- trie ----------------

static const int DEPTH = 64;

struct Trie {
  std::map<Fr, Fr> leaves;  // key -> value
};

static std::vector<Trie*> g_tries;

static void fr_from_bytes(const uint8_t* b, Fr& out) {
  for (int i = 0; i < 4; ++i) {
    u64 w = 0;
    for (int j = 0; j < 8; ++j) w |= (u64)b[i * 8 + j] << (8 * j);
    out.v[i] = w;
  }
}

static void fr_to_bytes(const Fr& f, uint8_t* b) {
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 8; ++j) b[i * 8 + j] = (uint8_t)(f.v[i] >> (8 * j));
  }
}

static int key_bit(const Fr& k, int level) {
  return (k.v[level / 64] >> (level % 64)) & 1;
}

// Recursive subtree hash over the sorted leaf range [lo, hi) at `level`.
static Fr subtree_hash(
    std::vector<std::pair<Fr, Fr>>& kv, int lo, int hi, int level) {
  Fr zero = {{0, 0, 0, 0}};
  if (lo >= hi) return zero;
  if (hi - lo == 1 || level == DEPTH) {
    // path-compressed: a single-leaf subtree hashes to the leaf itself
    Fr one = {{1, 0, 0, 0}};
    return hash2(kv[lo].first, kv[lo].second, one);
  }
  // partition by bit `level`
  int mid = lo;
  while (mid < hi && key_bit(kv[mid].first, level) == 0) ++mid;
  Fr l = subtree_hash(kv, lo, mid, level + 1);
  Fr r = subtree_hash(kv, mid, hi, level + 1);
  return hash2(l, r, zero);
}

extern "C" {

int spt_zktrie_init(const uint8_t* p_bytes, const uint8_t* n0inv_bytes,
                    const uint8_t* r2_bytes, const uint8_t* rc_bytes,
                    const uint8_t* mds_bytes, int r_f, int r_p) {
  fr_from_bytes(p_bytes, P);
  u64 n0 = 0;
  for (int j = 0; j < 8; ++j) n0 |= (u64)n0inv_bytes[j] << (8 * j);
  N0INV = n0;
  fr_from_bytes(r2_bytes, R2);
  R_F = r_f;
  R_P = r_p;
  int rounds = r_f + r_p;
  for (int r = 0; r < rounds && r < 65; ++r)
    for (int j = 0; j < 3; ++j) {
      fr_from_bytes(rc_bytes + 32 * (r * 3 + j), RC[r][j]);
      RC[r][j] = to_mont(RC[r][j]);
    }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      fr_from_bytes(mds_bytes + 32 * (i * 3 + j), MDS[i][j]);
      MDS[i][j] = to_mont(MDS[i][j]);
    }
  INITED = true;
  return 0;
}

int spt_zktrie_hash2(const uint8_t* a, const uint8_t* b, uint8_t domain,
                     uint8_t* out) {
  if (!INITED) return -1;
  Fr fa, fb, fd = {{domain, 0, 0, 0}};
  fr_from_bytes(a, fa);
  fr_from_bytes(b, fb);
  Fr h = hash2(fa, fb, fd);
  fr_to_bytes(h, out);
  return 0;
}

int spt_zktrie_new() {
  g_tries.push_back(new Trie());
  return (int)g_tries.size() - 1;
}

int spt_zktrie_update(int h, const uint8_t* key, const uint8_t* value) {
  if (h < 0 || h >= (int)g_tries.size()) return -1;
  Fr k, val;
  fr_from_bytes(key, k);
  fr_from_bytes(value, val);
  Fr zero = {{0, 0, 0, 0}};
  if (val == zero)
    g_tries[h]->leaves.erase(k);
  else
    g_tries[h]->leaves[k] = val;
  return 0;
}

int spt_zktrie_get(int h, const uint8_t* key, uint8_t* out) {
  if (h < 0 || h >= (int)g_tries.size()) return -1;
  Fr k;
  fr_from_bytes(key, k);
  auto it = g_tries[h]->leaves.find(k);
  if (it == g_tries[h]->leaves.end()) return 1;  // not found
  fr_to_bytes(it->second, out);
  return 0;
}

// Bit-reversed ordering note: leaves must be sorted by the path bits
// (LSB-first), which the std::map order over v[] does NOT give; sort here.
int spt_zktrie_root(int h, uint8_t* out) {
  if (h < 0 || h >= (int)g_tries.size() || !INITED) return -1;
  std::vector<std::pair<Fr, Fr>> kv(
      g_tries[h]->leaves.begin(), g_tries[h]->leaves.end());
  // sort by path-bit order (bit 0 first)
  std::sort(kv.begin(), kv.end(), [](const auto& a, const auto& b) {
    for (int lvl = 0; lvl < DEPTH; ++lvl) {
      int ba = key_bit(a.first, lvl), bb = key_bit(b.first, lvl);
      if (ba != bb) return ba < bb;
    }
    return false;
  });
  Fr root = subtree_hash(kv, 0, (int)kv.size(), 0);
  fr_to_bytes(root, out);
  return 0;
}

// Merkle proof: sibling hashes along the key's path, root-side first.
int spt_zktrie_prove(int h, const uint8_t* key, uint8_t* out_siblings,
                     int max_levels) {
  if (h < 0 || h >= (int)g_tries.size() || !INITED) return -1;
  Fr k;
  fr_from_bytes(key, k);
  std::vector<std::pair<Fr, Fr>> kv(
      g_tries[h]->leaves.begin(), g_tries[h]->leaves.end());
  std::sort(kv.begin(), kv.end(), [](const auto& a, const auto& b) {
    for (int lvl = 0; lvl < DEPTH; ++lvl) {
      int ba = key_bit(a.first, lvl), bb = key_bit(b.first, lvl);
      if (ba != bb) return ba < bb;
    }
    return false;
  });
  int lo = 0, hi = (int)kv.size();
  int n = 0;
  // descend only while the key's subtree still holds >= 2 leaves
  // (path-compressed placement: the leaf sits at that depth)
  for (int level = 0; level < DEPTH && n < max_levels && hi - lo >= 2;
       ++level) {
    int mid = lo;
    while (mid < hi && key_bit(kv[mid].first, level) == 0) ++mid;
    int bit = key_bit(k, level);
    Fr sib = bit ? subtree_hash(kv, lo, mid, level + 1)
                 : subtree_hash(kv, mid, hi, level + 1);
    fr_to_bytes(sib, out_siblings + 32 * n);
    ++n;
    if (bit) lo = mid; else hi = mid;
  }
  return n;
}

int spt_zktrie_free(int h) {
  if (h < 0 || h >= (int)g_tries.size() || !g_tries[h]) return -1;
  delete g_tries[h];
  g_tries[h] = nullptr;
  return 0;
}

}  // extern "C"
