// dig_lmdb: minimal read-only LMDB data-file reader.
//
// The reference framework stores every dataset in LMDB databases with
// keys `image-%09d` / `label-%09d` / `num-samples` (reference:
// tools/create_mae_lmdb.py:70-83, dataset/dataset_lmdb.py:23-28).  The
// Python `lmdb` binding is not available in this environment, so this
// is a from-scratch implementation of the LMDB on-disk B+tree format
// (as documented in the OpenLDAP LMDB design papers): meta pages,
// branch/leaf node layout and overflow pages — enough for point lookups
// on the read path that feeds the input pipeline.
//
// Exposed as a tiny C ABI for ctypes.  Thread-safe for concurrent reads
// (the map is immutable after open).
//
// Build (done by lmdb_store.py at first use): g++ -O2 -shared -fPIC -o libdig_lmdb.so dig_lmdb.cpp

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <string>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t MDB_MAGIC = 0xBEEFC0DE;
constexpr uint16_t P_BRANCH = 0x01;
constexpr uint16_t P_LEAF = 0x02;
constexpr uint16_t P_OVERFLOW = 0x04;
constexpr uint16_t P_META = 0x08;
constexpr uint16_t P_LEAF2 = 0x20;
constexpr uint16_t F_BIGDATA = 0x01;
constexpr size_t PAGEHDRSZ = 16;
constexpr uint64_t P_INVALID = ~uint64_t{0};

#pragma pack(push, 1)
struct PageHeader {
  uint64_t pgno;
  uint16_t pad;
  uint16_t flags;
  union {
    struct {
      uint16_t lower;
      uint16_t upper;
    } pb;
    uint32_t pages;  // overflow page count
  };
};

struct Node {
  uint16_t lo;
  uint16_t hi;
  uint16_t flags;
  uint16_t ksize;
  // key bytes, then data bytes / overflow pgno
};

struct MdbDb {
  uint32_t pad;
  uint16_t flags;
  uint16_t depth;
  uint64_t branch_pages;
  uint64_t leaf_pages;
  uint64_t overflow_pages;
  uint64_t entries;
  uint64_t root;
};

struct MdbMeta {
  uint32_t magic;
  uint32_t version;
  uint64_t address;
  uint64_t mapsize;
  MdbDb dbs[2];  // [0]=free db, [1]=main db
  uint64_t last_pg;
  uint64_t txnid;
};
#pragma pack(pop)

static_assert(sizeof(PageHeader) == 16, "page header must be 16 bytes");
static_assert(sizeof(MdbDb) == 48, "MDB_db must be 48 bytes");

struct Env {
  const uint8_t* map = nullptr;
  size_t size = 0;
  size_t psize = 4096;
  uint64_t root = P_INVALID;
  uint16_t depth = 0;
  uint64_t entries = 0;
};

inline const PageHeader* page(const Env* env, uint64_t pgno) {
  size_t off = pgno * env->psize;
  if (off + PAGEHDRSZ > env->size) return nullptr;
  return reinterpret_cast<const PageHeader*>(env->map + off);
}

inline int numkeys(const PageHeader* p) {
  return static_cast<int>((p->pb.lower - PAGEHDRSZ) >> 1);
}

inline const Node* node_at(const PageHeader* p, int i) {
  const uint16_t* ptrs =
      reinterpret_cast<const uint16_t*>(reinterpret_cast<const uint8_t*>(p) + PAGEHDRSZ);
  return reinterpret_cast<const Node*>(reinterpret_cast<const uint8_t*>(p) + ptrs[i]);
}

inline const uint8_t* node_key(const Node* n) {
  return reinterpret_cast<const uint8_t*>(n) + sizeof(Node);
}

inline uint64_t branch_pgno(const Node* n) {
  return uint64_t(n->lo) | (uint64_t(n->hi) << 16) | (uint64_t(n->flags) << 32);
}

inline size_t leaf_dsize(const Node* n) {
  return size_t(n->lo) | (size_t(n->hi) << 16);
}

// liblmdb default comparator: memcmp over min length, shorter first.
inline int key_cmp(const uint8_t* a, size_t alen, const uint8_t* b, size_t blen) {
  size_t n = alen < blen ? alen : blen;
  int c = memcmp(a, b, n);
  if (c) return c;
  return alen < blen ? -1 : (alen > blen ? 1 : 0);
}

}  // namespace

extern "C" {

void* dig_lmdb_open(const char* path) {
  std::string file(path);
  struct stat st;
  if (stat(file.c_str(), &st) == 0 && S_ISDIR(st.st_mode)) {
    file += "/data.mdb";
  }
  int fd = open(file.c_str(), O_RDONLY);
  if (fd < 0) return nullptr;
  if (fstat(fd, &st) != 0 || st.st_size < (off_t)(2 * PAGEHDRSZ)) {
    close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  close(fd);
  if (map == MAP_FAILED) return nullptr;

  auto* env = new Env;
  env->map = static_cast<const uint8_t*>(map);
  env->size = st.st_size;

  // Meta page 0 is always at byte 0; the authoritative page size is the
  // meta's own mm_psize (liblmdb stores it in the free DB's pad slot:
  // #define mm_psize mm_dbs[FREE_DBI].md_pad).  Meta 1 then lives at that
  // offset; pick the valid meta with the larger txnid.
  auto meta_at = [&](size_t off) -> const MdbMeta* {
    if (off + PAGEHDRSZ + sizeof(MdbMeta) > env->size) return nullptr;
    auto* m = reinterpret_cast<const MdbMeta*>(env->map + off + PAGEHDRSZ);
    return m->magic == MDB_MAGIC ? m : nullptr;
  };
  const MdbMeta* m0 = meta_at(0);
  if (!m0) {
    munmap(map, env->size);
    delete env;
    return nullptr;
  }
  size_t psize = m0->dbs[0].pad;
  if (psize < 512 || psize > 65536 || (psize & (psize - 1)) != 0) {
    // legacy files (this module's writer once left mm_psize = 0):
    // recover the page size by probing for the second meta page
    psize = 4096;
    for (size_t cand : {size_t(4096), size_t(8192), size_t(16384),
                        size_t(32768), size_t(65536)}) {
      if (meta_at(cand)) { psize = cand; break; }
    }
  }
  const MdbMeta* m1 = meta_at(psize);
  const MdbMeta* best = (m1 && m1->txnid > m0->txnid) ? m1 : m0;
  env->psize = psize;
  env->root = best->dbs[1].root;
  env->depth = best->dbs[1].depth;
  env->entries = best->dbs[1].entries;
  return env;
}

uint64_t dig_lmdb_entries(void* handle) {
  return handle ? static_cast<Env*>(handle)->entries : 0;
}

// Returns 0 on success; *val points into the mapped file (zero-copy).
int dig_lmdb_get(void* handle, const uint8_t* key, size_t klen,
                 const uint8_t** val, size_t* vlen) {
  auto* env = static_cast<Env*>(handle);
  if (!env || env->root == P_INVALID) return -1;
  const PageHeader* p = page(env, env->root);
  if (!p) return -1;

  while (p->flags & P_BRANCH) {
    int n = numkeys(p);
    // binary search: find last child whose key <= target (node 0 = -inf)
    int lo = 1, hi = n - 1, best = 0;
    while (lo <= hi) {
      int mid = (lo + hi) / 2;
      const Node* nd = node_at(p, mid);
      int c = key_cmp(key, klen, node_key(nd), nd->ksize);
      if (c >= 0) {
        best = mid;
        lo = mid + 1;
      } else {
        hi = mid - 1;
      }
    }
    p = page(env, branch_pgno(node_at(p, best)));
    if (!p) return -1;
  }
  if (!(p->flags & P_LEAF) || (p->flags & P_LEAF2)) return -1;

  int n = numkeys(p);
  int lo = 0, hi = n - 1;
  while (lo <= hi) {
    int mid = (lo + hi) / 2;
    const Node* nd = node_at(p, mid);
    int c = key_cmp(key, klen, node_key(nd), nd->ksize);
    if (c == 0) {
      size_t dsize = leaf_dsize(nd);
      if (nd->flags & F_BIGDATA) {
        uint64_t ovpg;
        memcpy(&ovpg, node_key(nd) + nd->ksize, sizeof(ovpg));
        const PageHeader* ov = page(env, ovpg);
        if (!ov || !(ov->flags & P_OVERFLOW)) return -1;
        *val = reinterpret_cast<const uint8_t*>(ov) + PAGEHDRSZ;
      } else {
        *val = node_key(nd) + nd->ksize;
      }
      *vlen = dsize;
      return 0;
    }
    if (c < 0)
      hi = mid - 1;
    else
      lo = mid + 1;
  }
  return 1;  // not found
}

void dig_lmdb_close(void* handle) {
  auto* env = static_cast<Env*>(handle);
  if (!env) return;
  munmap(const_cast<uint8_t*>(env->map), env->size);
  delete env;
}

}  // extern "C"
