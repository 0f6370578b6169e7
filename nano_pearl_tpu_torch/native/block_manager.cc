// Native host-side core of the port's paged KV block allocator: chained-
// hash prefix caching with ref counts, growth by any number of tokens,
// PEARL rollback, and pages striped over sequence-parallel shards.
//
// C++ counterpart of nano_pearl_tpu_torch/engine/block_manager.py, with
// the same decisions step for step (tests/test_torch_native.py holds the
// two against each other), behind a plain C interface that
// engine/native.py loads with ctypes. It follows native/block_manager.cc
// of the JAX package with two changes:
//
// - the chain digest is BLAKE2b cut to 8 bytes (RFC 7693, written out
//   below), the Python manager's hashlib.blake2b(digest_size=8), where the
//   JAX package's is xxh64, so prefix keys agree between the port's two
//   managers;
// - `shards` > 1 takes a view's page i from shard i % shards while that
//   shard has a free block (the Python manager's `_next_free`).
//
// Build: g++ -O2 -shared -fPIC -std=c++17 (engine/native.py does it at
// first use).

#include <cstdint>
#include <cstring>
#include <deque>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// BLAKE2b (RFC 7693), unkeyed, digest of `outlen` bytes.
// ---------------------------------------------------------------------------
constexpr uint64_t kIV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
    0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL, 0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
};

constexpr uint8_t kSigma[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
};

inline uint64_t rotr(uint64_t x, int r) { return (x >> r) | (x << (64 - r)); }

inline uint64_t load_le64(const uint8_t* p) {
  uint64_t w = 0;
  for (int i = 7; i >= 0; --i) w = (w << 8) | p[i];
  return w;
}

inline void mix(uint64_t* v, int a, int b, int c, int d, uint64_t x, uint64_t y) {
  v[a] = v[a] + v[b] + x;
  v[d] = rotr(v[d] ^ v[a], 32);
  v[c] = v[c] + v[d];
  v[b] = rotr(v[b] ^ v[c], 24);
  v[a] = v[a] + v[b] + y;
  v[d] = rotr(v[d] ^ v[a], 16);
  v[c] = v[c] + v[d];
  v[b] = rotr(v[b] ^ v[c], 63);
}

// One compression of a 128-byte block; `bytes` counts the message bytes
// up to and including this block, `last` marks the final block.
void compress(uint64_t h[8], const uint8_t block[128], uint64_t bytes, bool last) {
  uint64_t m[16], v[16];
  for (int i = 0; i < 16; ++i) m[i] = load_le64(block + 8 * i);
  for (int i = 0; i < 8; ++i) {
    v[i] = h[i];
    v[i + 8] = kIV[i];
  }
  v[12] ^= bytes;  // the counter's high word stays 0: messages are < 2^64 bytes
  if (last) v[14] = ~v[14];
  for (int r = 0; r < 12; ++r) {
    const uint8_t* s = kSigma[r];
    mix(v, 0, 4, 8, 12, m[s[0]], m[s[1]]);
    mix(v, 1, 5, 9, 13, m[s[2]], m[s[3]]);
    mix(v, 2, 6, 10, 14, m[s[4]], m[s[5]]);
    mix(v, 3, 7, 11, 15, m[s[6]], m[s[7]]);
    mix(v, 0, 5, 10, 15, m[s[8]], m[s[9]]);
    mix(v, 1, 6, 11, 12, m[s[10]], m[s[11]]);
    mix(v, 2, 7, 8, 13, m[s[12]], m[s[13]]);
    mix(v, 3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
  for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

// The first 8 bytes of BLAKE2b-64 (digest length 8) of `data`, read
// little-endian: Python's int.from_bytes(blake2b(data, digest_size=8)
// .digest(), "little").
uint64_t blake2b_64(const uint8_t* data, size_t len) {
  uint64_t h[8];
  for (int i = 0; i < 8; ++i) h[i] = kIV[i];
  h[0] ^= 0x01010000ULL ^ 8ULL;  // depth 1, fanout 1, no key, 8-byte digest
  uint8_t block[128];
  size_t done = 0;
  while (len - done > 128) {  // every block but the last
    compress(h, data + done, done + 128, false);
    done += 128;
  }
  std::memset(block, 0, sizeof block);
  std::memcpy(block, data + done, len - done);  // the last (possibly empty) block, zero-padded
  compress(h, block, len, true);
  return h[0];
}

// The chain hash of engine/block_manager.py's chain_hash: the previous
// block's digest as 8 little-endian bytes (when there is one), then the
// tokens as little-endian int64.
uint64_t chain_hash(const int64_t* tokens, int n, uint64_t prefix, bool has_prefix) {
  std::vector<uint8_t> buf;
  buf.reserve((has_prefix ? 8 : 0) + 8 * (size_t)n);
  if (has_prefix) {
    for (int i = 0; i < 8; ++i) buf.push_back((prefix >> (8 * i)) & 0xff);
  }
  for (int i = 0; i < n; ++i) {
    const uint64_t t = (uint64_t)tokens[i];
    for (int b = 0; b < 8; ++b) buf.push_back((t >> (8 * b)) & 0xff);
  }
  return blake2b_64(buf.data(), buf.size());
}

struct Block {
  int ref_count = 0;
  bool has_hash = false;
  uint64_t hash = 0;
  std::vector<int64_t> tokens;
};

struct BlockManager {
  int num_blocks;
  int block_size;
  int shards;
  int blocks_per_shard;  // the garbage block is the last shard's
  std::vector<Block> blocks;
  std::unordered_map<uint64_t, int> hash_to_block;
  std::deque<int> free_ids;

  BlockManager(int nb, int bs, int sh)
      : num_blocks(nb), block_size(bs), shards(sh), blocks_per_shard((nb + 1) / sh), blocks(nb) {
    for (int i = 0; i < nb; ++i) free_ids.push_back(i);
  }

  // The block for a view's page `page`: the first free one, from shard
  // page % shards where it has one.
  int next_free(int page) const {
    if (shards > 1) {
      const int want = page % shards;
      for (int id : free_ids) {
        if (id / blocks_per_shard == want) return id;
      }
    }
    return free_ids.front();
  }

  int take(int id) {
    Block& b = blocks[id];
    b.ref_count = 1;
    b.has_hash = false;
    b.tokens.clear();
    for (auto it = free_ids.begin(); it != free_ids.end(); ++it) {
      if (*it == id) {
        free_ids.erase(it);
        break;
      }
    }
    return id;
  }

  void release(int id) {
    if (--blocks[id].ref_count == 0) free_ids.push_back(id);
  }

  void publish(int id, uint64_t h, const int64_t* toks, int n) {
    Block& b = blocks[id];
    b.has_hash = true;
    b.hash = h;
    b.tokens.assign(toks, toks + n);
    hash_to_block[h] = id;
  }
};

}  // namespace

extern "C" {

void* bm_create(int num_blocks, int block_size, int shards) {
  if (num_blocks <= 0 || shards < 1 || (num_blocks + 1) % shards) return nullptr;
  return new BlockManager(num_blocks, block_size, shards);
}

void bm_destroy(void* h) { delete static_cast<BlockManager*>(h); }

int bm_num_free(void* h) { return (int)static_cast<BlockManager*>(h)->free_ids.size(); }

uint64_t bm_chain_hash(const int64_t* tokens, int n, uint64_t prefix, int has_prefix) {
  return chain_hash(tokens, n, prefix, has_prefix != 0);
}

// Allocate a fresh table for `n_tokens` tokens, reusing prefix-cached full
// blocks. Writes the block ids into out_table (capacity ceil(n / bs)) and
// returns the view's cached-token count (starting from `cached`), or -1
// when the pool cannot hold the sequence.
int bm_allocate(void* h, const int64_t* tokens, int n_tokens, int cached, int* out_table) {
  auto* bm = static_cast<BlockManager*>(h);
  const int bs = bm->block_size;
  const int nb = (n_tokens + bs - 1) / bs;
  if ((int)bm->free_ids.size() < nb) return -1;
  bool miss = false;
  uint64_t prev = 0;
  bool has_prev = false;
  for (int i = 0; i < nb; ++i) {
    const int64_t* toks = tokens + (size_t)i * bs;
    const int n = (i == nb - 1) ? n_tokens - i * bs : bs;
    const bool full = n == bs;
    const uint64_t hcur = full ? chain_hash(toks, n, prev, has_prev) : 0;
    int hit = -1;
    if (full) {
      auto it = bm->hash_to_block.find(hcur);
      if (it != bm->hash_to_block.end()) hit = it->second;
    }
    if (hit < 0 || (int)bm->blocks[hit].tokens.size() != n ||
        std::memcmp(bm->blocks[hit].tokens.data(), toks, (size_t)n * 8) != 0) {
      miss = true;
    }
    int id;
    if (miss) {
      id = bm->take(bm->next_free(i));
    } else {
      cached += bs;
      id = hit;
      if (bm->blocks[id].ref_count > 0) {
        bm->blocks[id].ref_count++;
      } else {
        bm->take(id);
      }
    }
    if (full) bm->publish(id, hcur, toks, n);
    out_table[i] = id;
    prev = hcur;
    has_prev = full;
  }
  if (cached == n_tokens) cached -= bs;  // keep one query row for prefill
  return cached;
}

void bm_deallocate(void* h, const int* table, int n) {
  auto* bm = static_cast<BlockManager*>(h);
  for (int i = n - 1; i >= 0; --i) bm->release(table[i]);
}

// Release every table entry past the blocks of `new_len` tokens (lookahead
// reservations included); returns the new table length.
int bm_rollback(void* h, const int* table, int table_len, int new_len) {
  auto* bm = static_cast<BlockManager*>(h);
  const int keep = (new_len + bm->block_size - 1) / bm->block_size;
  for (int i = keep; i < table_len; ++i) bm->release(table[i]);
  return keep < table_len ? keep : table_len;
}

// Grow `table` to hold cur_len + extra tokens, first publishing the hashes
// of full blocks that have none; `tokens` is the view's whole stream
// (cur_len entries). Returns the new table length, or -1 if the pool or
// the table's capacity is short.
int bm_ensure(void* h, const int64_t* tokens, int cur_len, int extra, int* table, int table_len,
              int table_capacity) {
  auto* bm = static_cast<BlockManager*>(h);
  const int bs = bm->block_size;
  const int target = (cur_len + extra + bs - 1) / bs;
  if (target > table_capacity) return -1;
  if (target - table_len > (int)bm->free_ids.size()) return -1;
  const int num_full = cur_len / bs;
  for (int i = 0; i < table_len && i < num_full; ++i) {
    if (!bm->blocks[table[i]].has_hash) {
      const bool has_prev = i > 0;
      const uint64_t prev = has_prev ? bm->blocks[table[i - 1]].hash : 0;
      const int64_t* toks = tokens + (size_t)i * bs;
      bm->publish(table[i], chain_hash(toks, bs, prev, has_prev), toks, bs);
    }
  }
  int len = table_len;
  while (len < target) {
    table[len] = bm->take(bm->next_free(len));
    ++len;
  }
  return len;
}

void bm_clear_prefix_cache(void* h) {
  auto* bm = static_cast<BlockManager*>(h);
  bm->hash_to_block.clear();
  for (auto& b : bm->blocks) {
    b.has_hash = false;
    b.tokens.clear();
  }
}

}  // extern "C"
