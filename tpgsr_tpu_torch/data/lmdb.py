"""Self-contained LMDB reader and writer (counterpart of
tpgsr_tpu/data/lmdb.py: ``LMDBReader`` :67 and ``write_lmdb`` :536).

TextZoom ships as LMDB databases (reference dataset/dataset.py:104-149); the
``lmdb`` package is not a dependency, so the on-disk format is read and
written directly:

* ``LMDBReader``: an mmap reader that picks the freshest meta page (or a
  given one), walks the main B+tree for point lookups (``get``) and in-order
  scans (``items``), and follows overflow pages for large values.  It reads
  multi-commit files, and pickles as its path so that a loader worker reopens
  the mmap.  Lookups are pure Python.
* ``write_lmdb``: a valid single-commit ``data.mdb`` from key/value pairs:
  bottom-up B+tree packing, overflow pages for large values, two meta pages.
  Its output is byte-identical to the JAX package's ``write_lmdb``.

Format: LMDB's public ``mdb.c``/``lmdb.h`` layout (BSD-licensed): meta magic
0xBEEFC0DE, version 1, 16-byte page headers, uint16 node offsets growing up
from the header while nodes grow down from the end of the page.  The page
size is recorded in the FREE_DBI's ``md_pad`` field.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

MDB_MAGIC = 0xBEEFC0DE
MDB_DATA_VERSION = 1

# page flags
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08

# node flags
F_BIGDATA = 0x01

PAGEHDRSZ = 16
P_INVALID = 0xFFFFFFFFFFFFFFFF

# MDB_db: md_pad(u32) md_flags(u16) md_depth(u16) md_branch_pages(u64)
# md_leaf_pages(u64) md_overflow_pages(u64) md_entries(u64) md_root(u64)
_DB_FMT = "<IHHQQQQQ"
_DB_SIZE = struct.calcsize(_DB_FMT)  # 48

# MDB_meta prefix: mm_magic(u32) mm_version(u32) mm_address(u64) mm_mapsize(u64)
_META_PREFIX_FMT = "<IIQQ"
_META_PREFIX_SIZE = struct.calcsize(_META_PREFIX_FMT)  # 24


class LMDBError(Exception):
    pass


def _data_file(path: str) -> str:
    if os.path.isdir(path):
        return os.path.join(path, "data.mdb")
    return path


class LMDBReader:
    """Read-only LMDB environment over mmap::

        env = LMDBReader("/path/to/textzoom/train1")
        n = int(env.get(b"num-samples"))
        img = env.get(b"image_hr-%09d" % 1)

    ``meta_slot`` (0 or 1) reads that meta page's snapshot of a multi-commit
    database; by default the freshest (highest txnid), as liblmdb does.
    """

    def __init__(self, path: str, meta_slot: Optional[int] = None):
        self.path = _data_file(path)
        self._meta_slot = meta_slot
        self._open()

    def _open(self):
        self._f = open(self.path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self._parse_meta()

    # a loader worker receives the path and reopens the mmap
    def __getstate__(self):
        return {"path": self.path, "meta_slot": self._meta_slot}

    def __setstate__(self, state):
        self.path = state["path"]
        self._meta_slot = state.get("meta_slot")
        self._open()

    # -- meta --------------------------------------------------------------

    def _read_meta(self, off: int) -> Optional[dict]:
        m = self._mm
        try:
            magic, version, _addr, _mapsize = struct.unpack_from(_META_PREFIX_FMT, m, off)
        except struct.error:
            return None
        if magic != MDB_MAGIC or version != MDB_DATA_VERSION:
            return None
        free_db = struct.unpack_from(_DB_FMT, m, off + _META_PREFIX_SIZE)
        main_db = struct.unpack_from(_DB_FMT, m, off + _META_PREFIX_SIZE + _DB_SIZE)
        _last_pg, txnid = struct.unpack_from("<QQ", m, off + _META_PREFIX_SIZE + 2 * _DB_SIZE)
        return {"psize": free_db[0], "main": main_db, "txnid": txnid}

    def _parse_meta(self):
        # meta 0 at page 0, meta 1 at page 1: the page size comes from meta 0
        meta0 = self._read_meta(PAGEHDRSZ)
        psize = meta0["psize"] if meta0 else 4096
        metas = [meta0, self._read_meta(psize + PAGEHDRSZ)]
        if self._meta_slot is not None:
            meta = metas[self._meta_slot]
            if meta is None:
                raise LMDBError(f"{self.path}: meta slot {self._meta_slot} invalid")
        else:
            valid = [mt for mt in metas if mt]
            if not valid:
                raise LMDBError(f"{self.path}: no valid LMDB meta page")
            meta = max(valid, key=lambda mt: mt["txnid"])
        self.psize = meta["psize"]
        self.txnid = meta["txnid"]
        (_pad, _flags, self.depth, _bp, _lp, _op, self.entries, self.root) = meta["main"]

    # -- page / node parsing -----------------------------------------------

    def _page(self, pgno: int) -> Tuple[int, int]:
        """(offset, flags) of a page."""
        off = pgno * self.psize
        return off, struct.unpack_from("<H", self._mm, off + 10)[0]

    def _num_keys(self, off: int) -> int:
        lower = struct.unpack_from("<H", self._mm, off + 12)[0]
        return (lower - PAGEHDRSZ) // 2

    def _node_off(self, page_off: int, i: int) -> int:
        return page_off + struct.unpack_from("<H", self._mm, page_off + PAGEHDRSZ + 2 * i)[0]

    def _branch_key_child(self, page_off: int, i: int) -> Tuple[bytes, int]:
        off = self._node_off(page_off, i)
        lo, hi, fl, ksize = struct.unpack_from("<HHHH", self._mm, off)
        return bytes(self._mm[off + 8 : off + 8 + ksize]), lo | (hi << 16) | (fl << 32)

    def _leaf_kv(self, page_off: int, i: int) -> Tuple[bytes, bytes]:
        off = self._node_off(page_off, i)
        lo, hi, fl, ksize = struct.unpack_from("<HHHH", self._mm, off)
        dsize = lo | (hi << 16)
        key = bytes(self._mm[off + 8 : off + 8 + ksize])
        dstart = off + 8 + ksize
        if fl & F_BIGDATA:
            ov_off, ov_flags = self._page(struct.unpack_from("<Q", self._mm, dstart)[0])
            if not ov_flags & P_OVERFLOW:
                raise LMDBError("expected overflow page")
            return key, bytes(self._mm[ov_off + PAGEHDRSZ : ov_off + PAGEHDRSZ + dsize])
        return key, bytes(self._mm[dstart : dstart + dsize])

    # -- public API ----------------------------------------------------------

    def __len__(self) -> int:
        return self.entries

    def get(self, key: bytes) -> Optional[bytes]:
        if self.root == P_INVALID:
            return None
        pgno = self.root
        while True:
            off, flags = self._page(pgno)
            n = self._num_keys(off)
            if flags & P_BRANCH:
                # the rightmost child whose key <= target; node 0's key is -inf
                lo_i, hi_i, pick = 1, n - 1, 0
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    k, _ = self._branch_key_child(off, mid)
                    if k <= key:
                        pick = mid
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                _, pgno = self._branch_key_child(off, pick)
            elif flags & P_LEAF:
                lo_i, hi_i = 0, n - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    k, v = self._leaf_kv(off, mid)
                    if k == key:
                        return v
                    if k < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return None
            else:
                raise LMDBError(f"unexpected page flags {flags:#x}")

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """In-order scan of every key/value pair."""
        if self.root == P_INVALID:
            return
        stack: List[Tuple[int, int]] = [(self.root, 0)]
        while stack:
            pgno, idx = stack.pop()
            off, flags = self._page(pgno)
            n = self._num_keys(off)
            if flags & P_LEAF:
                for i in range(n):
                    yield self._leaf_kv(off, i)
            elif idx < n:
                stack.append((pgno, idx + 1))
                stack.append((self._branch_key_child(off, idx)[1], 0))

    def close(self):
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _even(n: int) -> int:
    return n + (n & 1)


class _PageBuilder:
    """Pages of one commit, numbered from 2 (pages 0 and 1 are the metas)."""

    def __init__(self, psize: int):
        self.psize = psize
        self.pages: Dict[int, bytes] = {}
        self.next_pgno = 2
        self.n_branch = 0
        self.n_leaf = 0
        self.n_overflow = 0

    def alloc(self, count: int = 1) -> int:
        pgno = self.next_pgno
        self.next_pgno += count
        return pgno

    def emit(self, pgno: int, flags: int, nodes: List[bytes]) -> None:
        """A branch or leaf page from encoded nodes (grow-down layout)."""
        psize = self.psize
        buf = bytearray(psize)
        upper = psize
        ptrs = []
        for node in nodes:
            upper -= _even(len(node))
            buf[upper : upper + len(node)] = node
            ptrs.append(upper)
        lower = PAGEHDRSZ + 2 * len(nodes)
        if lower > upper:
            raise LMDBError("page overflow")
        struct.pack_into("<QHHHH", buf, 0, pgno, 0, flags, lower, upper)
        for i, p in enumerate(ptrs):
            struct.pack_into("<H", buf, PAGEHDRSZ + 2 * i, p)
        self.pages[pgno] = bytes(buf)
        if flags & P_BRANCH:
            self.n_branch += 1
        elif flags & P_LEAF:
            self.n_leaf += 1

    def emit_overflow(self, data: bytes) -> int:
        psize = self.psize
        npages = (PAGEHDRSZ + len(data) + psize - 1) // psize
        pgno = self.alloc(npages)
        blob = bytearray(npages * psize)
        struct.pack_into("<QHHI", blob, 0, pgno, 0, P_OVERFLOW, npages)
        blob[PAGEHDRSZ : PAGEHDRSZ + len(data)] = data
        for i in range(npages):
            self.pages[pgno + i] = bytes(blob[i * psize : (i + 1) * psize])
        self.n_overflow += npages
        return pgno


def _leaf_node(key: bytes, value: bytes, bigdata_pgno: Optional[int]) -> bytes:
    size = struct.pack("<HH", len(value) & 0xFFFF, (len(value) >> 16) & 0xFFFF)
    if bigdata_pgno is not None:
        return size + struct.pack("<HH", F_BIGDATA, len(key)) + key + struct.pack("<Q", bigdata_pgno)
    return size + struct.pack("<HH", 0, len(key)) + key + value


def _branch_node(key: bytes, child_pgno: int) -> bytes:
    head = struct.pack("<HHHH", child_pgno & 0xFFFF, (child_pgno >> 16) & 0xFFFF,
                       (child_pgno >> 32) & 0xFFFF, len(key))
    return head + key


def _build_tree(builder: _PageBuilder, pairs: List[Tuple[bytes, bytes]]) -> Tuple[int, int]:
    """Pack sorted pairs into a B+tree, leaves first, then each branch level;
    returns (root, depth)."""
    nodemax = ((builder.psize - PAGEHDRSZ) // 2) & ~1  # mdb_env_init me_nodemax
    psize = builder.psize

    def pack(entries, flags, encode) -> List[Tuple[bytes, int]]:
        """Fill pages with ``encode(key, payload, first_on_page)`` in order;
        returns (first key, pgno) of each page."""
        out: List[Tuple[bytes, int]] = []
        nodes: List[bytes] = []
        first: Optional[bytes] = None
        size = PAGEHDRSZ
        for key, payload in entries:
            node = encode(key, payload, not nodes)
            if size + _even(len(node)) + 2 > psize:
                pgno = builder.alloc()
                builder.emit(pgno, flags, nodes)
                out.append((first, pgno))
                nodes, first, size = [], None, PAGEHDRSZ
                if flags & P_BRANCH:
                    node = encode(key, payload, True)
            if first is None:
                first = key
            nodes.append(node)
            size += _even(len(node)) + 2
        if nodes:
            pgno = builder.alloc()
            builder.emit(pgno, flags, nodes)
            out.append((first, pgno))
        return out

    def leaf(key, value, _first):
        # a large value's overflow pages are allocated as its node is made
        if 8 + len(key) + len(value) > nodemax:
            return _leaf_node(key, value, builder.emit_overflow(value))
        return _leaf_node(key, value, None)

    def branch(key, child, first):
        # LMDB stores an empty key for each branch page's first node
        return _branch_node(b"" if first else key, child)

    if not pairs:
        return P_INVALID, 0
    level, depth = pack(pairs, P_LEAF, leaf), 1
    while len(level) > 1:
        level, depth = pack(level, P_BRANCH, branch), depth + 1
    return level[0][1], depth


def _meta_page_bytes(psize: int, pgno: int, txnid: int, mapsize: int, last_pg: int,
                     main: Tuple[int, int, Tuple[int, int, int], int]) -> bytes:
    """A meta page; ``main`` is (root, depth, (branch, leaf, overflow pages),
    entries), and the freelist is empty."""
    buf = bytearray(psize)
    struct.pack_into("<QHHHH", buf, 0, pgno, 0, P_META, 0, 0)
    off = PAGEHDRSZ
    struct.pack_into(_META_PREFIX_FMT, buf, off, MDB_MAGIC, MDB_DATA_VERSION, 0, mapsize)
    off += _META_PREFIX_SIZE
    # FREE_DBI: md_pad carries the page size
    struct.pack_into(_DB_FMT, buf, off, psize, 0, 0, 0, 0, 0, 0, P_INVALID)
    off += _DB_SIZE
    m_root, m_depth, (m_b, m_l, m_o), m_entries = main
    struct.pack_into(_DB_FMT, buf, off, 0, 0, m_depth, m_b, m_l, m_o, m_entries, m_root)
    off += _DB_SIZE
    struct.pack_into("<QQ", buf, off, last_pg, txnid)
    return bytes(buf)


def write_lmdb(path: str, items: Iterable[Tuple[bytes, bytes]], psize: int = 4096, map_extra: int = 0) -> str:
    """Write ``items`` into ``<path>/data.mdb`` as a valid LMDB database and
    return the data file's path.

    Keys are sorted bytewise (LMDB's default memcmp order).  One commit: both
    metas describe the same tree (txnid 0 and 1) and the freelist is empty,
    the layout liblmdb gives a freshly created environment.
    """
    pairs = sorted(items, key=lambda kv: kv[0])
    for k, _ in pairs:
        if not 0 < len(k) <= 511:
            raise LMDBError(f"invalid key length {len(k)}")

    builder = _PageBuilder(psize)
    root, depth = _build_tree(builder, pairs)
    last_pg = builder.next_pgno - 1
    mapsize = max(builder.next_pgno * psize + map_extra, 1 << 20)
    main = (root, depth, (builder.n_branch, builder.n_leaf, builder.n_overflow), len(pairs))

    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "data.mdb")
    with open(out, "wb") as f:
        f.write(_meta_page_bytes(psize, 0, 0, mapsize, last_pg, main))
        f.write(_meta_page_bytes(psize, 1, 1, mapsize, last_pg, main))
        for pgno in range(2, builder.next_pgno):
            f.write(builder.pages[pgno])
    return out
