"""LMDB-format key/value store: native C++ reader + pure-Python writer/reader.

The port's own copy of `dig_tpu/data/lmdb_store.py` (the port imports
nothing of the JAX package).  The reference keeps every dataset in LMDB
files with the schema ``image-%09d`` / ``label-%09d`` / ``num-samples``.
The Python `lmdb` binding is often not installed, so this module
implements the LMDB on-disk format directly:

* `LmdbReader`: point lookups.  Prefers the native zero-copy C++ reader
  (`native/dig_lmdb.cpp`, built with g++ at first use), then the `lmdb`
  package when importable, and finally a pure-Python mmap parser.
  `LmdbReader.backend` names the one taken.  This is host IO: whichever
  backend reads the file, the bytes are the same.
* `LmdbWriter`: offline bulk writer; builds the B+tree bottom-up in one
  pass over sorted keys and emits standard meta / branch / leaf / overflow
  pages (liblmdb-compatible layout).

Format constants follow the LMDB design documents: 4096-byte pages,
16-byte page headers, 8-byte node headers, dual meta pages with magic
0xBEEFC0DE, default lexicographic key order.

The native library is built into `native/_build/` (listed in `.gitignore`)
under a name that carries a hash of its source, so an edited source is
rebuilt and a stale binary is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
import struct
import subprocess
import threading

PAGE_SIZE = 4096
PAGEHDRSZ = 16
NODESZ = 8
MAGIC = 0xBEEFC0DE
VERSION = 1
P_BRANCH, P_LEAF, P_OVERFLOW, P_META, P_LEAF2 = 0x01, 0x02, 0x04, 0x08, 0x20
F_BIGDATA = 0x01
P_INVALID = 2**64 - 1
# liblmdb: me_nodemax = ((psize - PAGEHDRSZ) / MDB_MINKEYS) & -2
NODE_MAX = ((PAGE_SIZE - PAGEHDRSZ) // 2) & ~1

_NATIVE_SRC = os.path.join(os.path.dirname(__file__), "native", "dig_lmdb.cpp")
_NATIVE_BUILD_DIR = os.path.join(os.path.dirname(__file__), "native", "_build")
_build_lock = threading.Lock()


def _even(n: int) -> int:
    return (n + 1) & ~1


def _load_native():
    """The native reader's library, built if this source has no library
    yet; None where it cannot be built or loaded (no g++, no source)."""
    with _build_lock:
        try:
            with open(_NATIVE_SRC, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()[:12]
        except OSError:
            return None
        so = os.path.join(_NATIVE_BUILD_DIR, f"libdig_lmdb-{digest}.so")
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            try:
                os.makedirs(_NATIVE_BUILD_DIR, exist_ok=True)
                subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _NATIVE_SRC],
                               check=True, capture_output=True)
                os.replace(tmp, so)  # atomic: another process never loads half a file
            except (OSError, subprocess.CalledProcessError):
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
    lib.dig_lmdb_open.restype = ctypes.c_void_p
    lib.dig_lmdb_open.argtypes = [ctypes.c_char_p]
    lib.dig_lmdb_get.restype = ctypes.c_int
    lib.dig_lmdb_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.dig_lmdb_entries.restype = ctypes.c_uint64
    lib.dig_lmdb_entries.argtypes = [ctypes.c_void_p]
    lib.dig_lmdb_close.argtypes = [ctypes.c_void_p]
    return lib


_native_lib = None
_native_tried = False


def native_lib():
    global _native_lib, _native_tried
    if not _native_tried:
        _native_lib = _load_native()
        _native_tried = True
    return _native_lib


class _NativeReader:
    def __init__(self, path: str):
        lib = native_lib()
        if lib is None:
            raise OSError("native reader unavailable")
        self._lib = lib
        self._h = lib.dig_lmdb_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open LMDB at {path}")

    def get(self, key: bytes):
        val = ctypes.c_void_p()
        vlen = ctypes.c_size_t()
        rc = self._lib.dig_lmdb_get(
            self._h, key, len(key), ctypes.byref(val), ctypes.byref(vlen)
        )
        if rc != 0:
            return None
        return ctypes.string_at(val.value, vlen.value)

    @property
    def entries(self) -> int:
        return int(self._lib.dig_lmdb_entries(self._h))

    def close(self):
        if self._h:
            self._lib.dig_lmdb_close(self._h)
            self._h = None


class _PyReader:
    """Pure-Python mmap parser of the same format (slow path / fallback)."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self._f = open(path, "rb")
        self._m = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        # meta page 0 is always at byte 0; the authoritative page size is
        # the meta's own mm_psize field (liblmdb stores it in the free DB's
        # pad slot: #define mm_psize mm_dbs[FREE_DBI].md_pad) — probing page
        # offsets alone would lock onto 4096 regardless of the real size
        m0 = self._parse_meta(0)
        if m0 is None:
            raise OSError(f"not an LMDB file: {path}")
        psize = m0[1]
        if not (512 <= psize <= 65536 and psize & (psize - 1) == 0):
            # legacy files (this module's writer once left mm_psize = 0):
            # recover the page size by probing for the second meta page
            psize = 4096
            for cand in (4096, 8192, 16384, 32768, 65536):
                if self._parse_meta(cand) is not None:
                    psize = cand
                    break
        m1 = self._parse_meta(psize)
        best = m1 if (m1 is not None and m1[0] > m0[0]) else m0
        main = best[2]
        self.psize = psize
        self.depth = main[2]
        self.entries = main[6]
        self.root = main[7]

    def _parse_meta(self, off: int):
        """(txnid, mm_psize, main_db_fields) of the meta at byte `off`,
        or None if no valid meta lives there.  Meta layout after the page
        header: magic(4) version(4) address(8) mapsize(8) dbs[2] (2x48)
        last_pg(8) txnid(8)."""
        if off + PAGEHDRSZ + 136 > len(self._m):
            return None
        magic = struct.unpack_from("<I", self._m, off + PAGEHDRSZ)[0]
        if magic != MAGIC:
            return None
        psize = struct.unpack_from("<I", self._m, off + PAGEHDRSZ + 24)[0]
        main = struct.unpack_from("<IHH5Q", self._m, off + PAGEHDRSZ + 72)
        txnid = struct.unpack_from("<Q", self._m, off + PAGEHDRSZ + 128)[0]
        return (txnid, psize, main)

    def _page(self, pgno: int) -> int:
        return pgno * self.psize

    def _numkeys(self, base: int) -> int:
        lower = struct.unpack_from("<H", self._m, base + 12)[0]
        return (lower - PAGEHDRSZ) >> 1

    def _node(self, base: int, i: int) -> int:
        off = struct.unpack_from("<H", self._m, base + PAGEHDRSZ + 2 * i)[0]
        return base + off

    def _node_key(self, naddr: int) -> bytes:
        ksize = struct.unpack_from("<H", self._m, naddr + 6)[0]
        return self._m[naddr + NODESZ : naddr + NODESZ + ksize]

    def get(self, key: bytes):
        if self.root == P_INVALID:
            return None
        base = self._page(self.root)
        while True:
            flags = struct.unpack_from("<H", self._m, base + 10)[0]
            if flags & P_BRANCH:
                n = self._numkeys(base)
                lo, hi, best = 1, n - 1, 0
                while lo <= hi:
                    mid = (lo + hi) // 2
                    if key >= self._node_key(self._node(base, mid)):
                        best, lo = mid, mid + 1
                    else:
                        hi = mid - 1
                naddr = self._node(base, best)
                nlo, nhi, nflags = struct.unpack_from("<HHH", self._m, naddr)
                base = self._page(nlo | (nhi << 16) | (nflags << 32))
            elif flags & P_LEAF:
                n = self._numkeys(base)
                lo, hi = 0, n - 1
                while lo <= hi:
                    mid = (lo + hi) // 2
                    naddr = self._node(base, mid)
                    k = self._node_key(naddr)
                    if k == key:
                        nlo, nhi, nflags, ksize = struct.unpack_from("<HHHH", self._m, naddr)
                        dsize = nlo | (nhi << 16)
                        daddr = naddr + NODESZ + ksize
                        if nflags & F_BIGDATA:
                            ovpg = struct.unpack_from("<Q", self._m, daddr)[0]
                            daddr = self._page(ovpg) + PAGEHDRSZ
                        return self._m[daddr : daddr + dsize]
                    if key < k:
                        hi = mid - 1
                    else:
                        lo = mid + 1
                return None
            else:
                return None

    def close(self):
        self._m.close()
        self._f.close()


class LmdbReader:
    """Reader facade with backend preference: native C++ > lmdb pkg > Python."""

    def __init__(self, path: str, backend: str = "auto"):
        self.path = path
        self._impl = None
        if backend in ("auto", "native"):
            try:
                self._impl = _NativeReader(path)
                self.backend = "native"
            except OSError:
                if backend == "native":
                    raise
        if self._impl is None and backend in ("auto", "lmdb"):
            try:
                import lmdb  # noqa

                env = lmdb.open(path, subdir=os.path.isdir(path),
                                max_readers=32, readonly=True, lock=False)

                class _L:
                    entries = env.stat()["entries"]

                    def get(self, key):
                        # one read txn per call: py-lmdb transactions are
                        # not usable concurrently, and the loader fans
                        # samples out across worker threads
                        with env.begin() as txn:
                            return txn.get(key)

                    def close(self):
                        env.close()

                self._impl = _L()
                self.backend = "lmdb"
            except Exception:
                # any open failure (not just a missing package) falls
                # through to the pure-Python parser in auto mode
                if backend == "lmdb":
                    raise
        if self._impl is None:
            self._impl = _PyReader(path)
            self.backend = "python"

    def get(self, key: bytes):
        return self._impl.get(key)

    @property
    def entries(self) -> int:
        return self._impl.entries

    def close(self):
        self._impl.close()


class LmdbWriter:
    """Bulk writer: collect puts, then `commit()` builds the B+tree.

    Produces standard LMDB page layout (dual metas, branch/leaf nodes,
    overflow pages for large values) so files round-trip through both the
    native reader and liblmdb.
    """

    def __init__(self, path: str):
        if not os.path.splitext(path)[1]:
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, "data.mdb")
        else:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._items = {}

    def put(self, key: bytes, value: bytes):
        self._items[bytes(key)] = bytes(value)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if not exc[0]:
            self.commit()

    def commit(self):
        items = sorted(self._items.items())
        pages = {}  # pgno -> bytes
        next_pg = 2  # 0/1 are metas

        def alloc(n=1):
            nonlocal next_pg
            pg = next_pg
            next_pg += n
            return pg

        # ---- leaves (+ overflow) -------------------------------------------
        overflow_pages = 0
        leaf_entries = []  # (first_key, pgno)
        cur_nodes = []  # (key, flags, data_bytes, dsize)
        cur_space = 0

        def node_size(klen, dlen):
            return _even(NODESZ + klen + dlen)

        def flush_leaf():
            nonlocal cur_nodes, cur_space
            if not cur_nodes:
                return
            pg = alloc()
            buf = bytearray(PAGE_SIZE)
            upper = PAGE_SIZE
            ptrs = []
            for key, flags, data, dsize in cur_nodes:
                sz = node_size(len(key), len(data))
                upper -= sz
                ptrs.append(upper)
                struct.pack_into(
                    "<HHHH", buf, upper,
                    dsize & 0xFFFF, (dsize >> 16) & 0xFFFF, flags, len(key),
                )
                buf[upper + NODESZ : upper + NODESZ + len(key)] = key
                buf[upper + NODESZ + len(key) : upper + NODESZ + len(key) + len(data)] = data
            lower = PAGEHDRSZ + 2 * len(ptrs)
            struct.pack_into("<QHHHH", buf, 0, pg, 0, P_LEAF, lower, upper)
            for i, p in enumerate(ptrs):
                struct.pack_into("<H", buf, PAGEHDRSZ + 2 * i, p)
            pages[pg] = bytes(buf)
            leaf_entries.append((cur_nodes[0][0], pg))
            cur_nodes, cur_space = [], 0

        for key, value in items:
            if NODESZ + len(key) + len(value) > NODE_MAX:
                ovp = (PAGEHDRSZ + len(value) + PAGE_SIZE - 1) // PAGE_SIZE
                pg = alloc(ovp)
                buf = bytearray(ovp * PAGE_SIZE)
                struct.pack_into("<QHHI", buf, 0, pg, 0, P_OVERFLOW, ovp)
                buf[PAGEHDRSZ : PAGEHDRSZ + len(value)] = value
                for i in range(ovp):
                    pages[pg + i] = bytes(buf[i * PAGE_SIZE : (i + 1) * PAGE_SIZE])
                overflow_pages += ovp
                data, flags, dsize = struct.pack("<Q", pg), F_BIGDATA, len(value)
            else:
                data, flags, dsize = value, 0, len(value)
            sz = node_size(len(key), len(data))
            if cur_space + 2 + sz > PAGE_SIZE - PAGEHDRSZ:
                flush_leaf()
            cur_nodes.append((key, flags, data, dsize))
            cur_space += 2 + sz
        flush_leaf()

        # ---- branch levels --------------------------------------------------
        depth = 1
        level = leaf_entries
        branch_pages = 0
        while len(level) > 1:
            depth += 1
            next_level = []
            cur, space = [], 0
            for idx, (first_key, child) in enumerate(level):
                key = b"" if not cur else first_key
                sz = _even(NODESZ + len(key))
                if space + 2 + sz > PAGE_SIZE - PAGEHDRSZ:
                    next_level.append(_emit_branch(pages, alloc, cur))
                    branch_pages += 1
                    cur, space = [], 0
                    key = b""
                    sz = _even(NODESZ)
                cur.append((key, first_key, child))
                space += 2 + sz
            if cur:
                next_level.append(_emit_branch(pages, alloc, cur))
                branch_pages += 1
            level = next_level
        root = level[0][1] if level else P_INVALID

        # ---- metas -----------------------------------------------------------
        last_pg = next_pg - 1
        mapsize = max(next_pg * PAGE_SIZE, 1 << 20)
        # liblmdb keeps the page size in the free DB's pad slot
        # (#define mm_psize mm_dbs[FREE_DBI].md_pad); flags 0x08 =
        # MDB_INTEGERKEY, matching mdb_env_init_meta
        free_db = struct.pack("<IHH5Q", PAGE_SIZE, 0x08, 0, 0, 0, 0, 0,
                              P_INVALID)
        main_db = struct.pack(
            "<IHH5Q", 0, 0, depth if items else 0, branch_pages,
            len(leaf_entries), overflow_pages, len(items),
            root if items else P_INVALID,
        )
        with open(self.path, "wb") as f:
            for i in (0, 1):
                buf = bytearray(PAGE_SIZE)
                struct.pack_into("<QHHHH", buf, 0, i, 0, P_META, PAGEHDRSZ, PAGE_SIZE)
                meta = struct.pack("<IIQQ", MAGIC, VERSION, 0, mapsize) + free_db + main_db
                meta += struct.pack("<QQ", last_pg, 1 + i)  # txnid: page1 newer
                buf[PAGEHDRSZ : PAGEHDRSZ + len(meta)] = meta
                f.write(buf)
            for pg in range(2, next_pg):
                f.write(pages[pg])


def _emit_branch(pages, alloc, entries):
    """entries: list of (stored_key, first_key, child_pgno); returns
    (first_key_of_page, pgno)."""
    pg = alloc()
    buf = bytearray(PAGE_SIZE)
    upper = PAGE_SIZE
    ptrs = []
    for stored_key, _, child in entries:
        sz = _even(NODESZ + len(stored_key))
        upper -= sz
        ptrs.append(upper)
        struct.pack_into(
            "<HHHH", buf, upper,
            child & 0xFFFF, (child >> 16) & 0xFFFF, (child >> 32) & 0xFFFF,
            len(stored_key),
        )
        buf[upper + NODESZ : upper + NODESZ + len(stored_key)] = stored_key
    lower = PAGEHDRSZ + 2 * len(ptrs)
    struct.pack_into("<QHHHH", buf, 0, pg, 0, P_BRANCH, lower, upper)
    for i, p in enumerate(ptrs):
        struct.pack_into("<H", buf, PAGEHDRSZ + 2 * i, p)
    pages[pg] = bytes(buf)
    return (entries[0][1], pg)
