"""Self-contained LMDB (Lightning Memory-Mapped DB) file-format support.

The reference stores all region features and many annotations in LMDB
environments accessed through the ``lmdb`` C extension
(reference: volta/datasets/_image_features_reader.py:46-57,
data/flickr30k/convert_flickr30k_lmdb.py:17-28). This image has no ``lmdb``
package, so the framework carries its own implementation of the on-disk
format: a read-only mmap B+tree walker plus a bulk writer (used by the data
prep converters and test fixtures). Both speak the standard LMDB v1 data
format (magic 0xBEEFC0DE), so real datasets produced by the reference
tooling load unchanged.

Only the features used by the datasets are implemented: the MAIN dbi,
get/iteration, inline and overflow (BIGDATA) values. No write transactions,
no dupsort, no nested dbs.

The port's copy of ``volta_tpu/data/lmdbx.py``, which uses numpy and the
standard library only; the port keeps its own so that it imports nothing
of the JAX package.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, List, Optional, Tuple

MAGIC = 0xBEEFC0DE
VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08

F_BIGDATA = 0x01

_PGHDR = struct.Struct("<Q2sHHH")        # pgno, pad, flags, lower, upper
_META = struct.Struct("<II Q Q")          # magic, version, address, mapsize
_DB = struct.Struct("<IHHQQQQQ")          # pad, flags, depth, branch, leaf,
                                          # overflow, entries, root
_NODEHDR = struct.Struct("<HHHH")         # lo, hi, flags, ksize
_INVALID = 0xFFFFFFFFFFFFFFFF


class Env:
    """Read-only LMDB environment over mmap."""

    def __init__(self, path: str, subdir: Optional[bool] = None):
        if subdir is None:
            subdir = os.path.isdir(path)
        self.path = os.path.join(path, "data.mdb") if subdir else path
        self._f = open(self.path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self._load_meta()

    # -------------------------------------------------------------- meta
    def _read_meta(self, off: int):
        mm = self._mm
        magic, version, _addr, _mapsize = _META.unpack_from(mm, off + 16)
        if magic != MAGIC:
            raise ValueError(f"{self.path}: not an LMDB data file")
        if version != VERSION:
            raise ValueError(f"unsupported LMDB data version {version}")
        dbs_off = off + 16 + _META.size
        free_db = _DB.unpack_from(mm, dbs_off)
        main_db = _DB.unpack_from(mm, dbs_off + _DB.size)
        last_pg, txnid = struct.unpack_from("<QQ", mm, dbs_off + 2 * _DB.size)
        psize = free_db[0]  # mm_psize aliases mm_dbs[0].md_pad
        return txnid, psize, main_db

    def _load_meta(self):
        # meta pages are pages 0 and 1; page size must be discovered from
        # meta 0 (mm_psize) before locating meta 1
        txn0, psize, main0 = self._read_meta(0)
        self.psize = psize or 4096
        txn1, _, main1 = self._read_meta(self.psize)
        self._main = main1 if txn1 > txn0 else main0
        self.entries = self._main[6]
        self._root = self._main[7]

    # -------------------------------------------------------------- pages
    def _page(self, pgno: int):
        off = pgno * self.psize
        _pg, _pad, flags, lower, upper = _PGHDR.unpack_from(self._mm, off)
        return off, flags, lower, upper

    def _node(self, page_off: int, idx: int):
        ptr = struct.unpack_from(
            "<H", self._mm, page_off + 16 + 2 * idx)[0]
        noff = page_off + ptr
        lo, hi, flags, ksize = _NODEHDR.unpack_from(self._mm, noff)
        key = self._mm[noff + 8: noff + 8 + ksize]
        return noff, lo, hi, flags, ksize, key

    def _nkeys(self, lower: int) -> int:
        return (lower - 16) // 2

    # ------------------------------------------------------------- lookup
    def get(self, key: bytes) -> Optional[bytes]:
        if self._root == _INVALID:
            return None
        pgno = self._root
        while True:
            off, flags, lower, upper = self._page(pgno)
            n = self._nkeys(lower)
            if flags & P_BRANCH:
                # binary search: rightmost child whose key <= target
                lo_i, hi_i = 1, n - 1
                child = 0
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    _, nlo, nhi, _nf, ks, k = self._node(off, mid)
                    if k <= key:
                        child = mid
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                noff, nlo, nhi, nf, ks, k = self._node(off, child)
                pgno = nlo | (nhi << 16) | (nf << 32)
            elif flags & P_LEAF:
                lo_i, hi_i = 0, n - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    noff, nlo, nhi, nf, ks, k = self._node(off, mid)
                    if k == key:
                        return self._leaf_data(noff, nlo, nhi, nf, ks)
                    if k < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return None
            else:
                raise ValueError(f"unexpected page flags {flags:#x}")

    def _leaf_data(self, noff, lo, hi, flags, ksize) -> bytes:
        dsize = lo | (hi << 16)
        if flags & F_BIGDATA:
            ovf_pgno = struct.unpack_from(
                "<Q", self._mm, noff + 8 + ksize)[0]
            ooff = ovf_pgno * self.psize
            return bytes(self._mm[ooff + 16: ooff + 16 + dsize])
        doff = noff + 8 + ksize
        return bytes(self._mm[doff: doff + dsize])

    # ----------------------------------------------------------- iterate
    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        if self._root == _INVALID:
            return
        stack = [(self._root, 0)]
        while stack:
            pgno, idx = stack.pop()
            off, flags, lower, upper = self._page(pgno)
            n = self._nkeys(lower)
            if flags & P_BRANCH:
                if idx < n:
                    stack.append((pgno, idx + 1))
                    noff, nlo, nhi, nf, ks, k = self._node(off, idx)
                    stack.append((nlo | (nhi << 16) | (nf << 32), 0))
            else:
                for i in range(n):
                    noff, nlo, nhi, nf, ks, k = self._node(off, i)
                    yield bytes(k), self._leaf_data(noff, nlo, nhi, nf, ks)

    def keys(self) -> List[bytes]:
        return [k for k, _ in self.items()]

    def close(self):
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# ===================================================================== write
def _node_payload(key: bytes, lo: int, hi: int, flags: int,
                  data: bytes) -> bytes:
    return _NODEHDR.pack(lo, hi, flags, len(key)) + key + data


def write(path: str, items, psize: int = 4096, subdir: bool = False) -> None:
    """Create an LMDB data file from (key, value) pairs (sorted internally).

    Bulk bottom-up build: leaves first, then branch levels, finally the two
    meta pages. Values too large for half a page go to overflow pages.
    """
    # coerce keys to bytes BEFORE sorting: the reader binary-searches in
    # byte order, and native-type order disagrees with it (e.g. ints
    # 2 < 10 but b"10" < b"2")
    items = [(k if isinstance(k, bytes) else str(k).encode(), v)
             for k, v in items]
    items = sorted(items, key=lambda kv: kv[0])
    pages: List[bytes] = [b"", b""]  # meta placeholders (pgno 0 and 1)
    next_pgno = 2

    max_inline = (psize - 16) // 2 - 16

    # ---- leaves
    leaves: List[Tuple[bytes, int]] = []  # (first_key, pgno)
    cur_nodes: List[bytes] = []
    cur_sizes: List[int] = []
    cur_first: Optional[bytes] = None
    cur_used = 0

    def flush_leaf():
        nonlocal cur_nodes, cur_sizes, cur_first, cur_used, next_pgno
        if not cur_nodes:
            return
        pgno = next_pgno
        next_pgno += 1
        out = bytearray(psize)
        total = sum(cur_sizes)
        lower = 16 + 2 * len(cur_nodes)
        upper = psize - total
        _PGHDR.pack_into(out, 0, pgno, b"\x00\x00", P_LEAF, lower, upper)
        pos = upper
        for i, (payload, s) in enumerate(zip(cur_nodes, cur_sizes)):
            struct.pack_into("<H", out, 16 + 2 * i, pos)
            out[pos: pos + len(payload)] = payload
            pos += s
        pages.append(bytes(out))
        leaves.append((cur_first, pgno))
        cur_nodes, cur_sizes, cur_first, cur_used = [], [], None, 0

    overflow_chunks: List[Tuple[int, bytes]] = []

    for key, val in items:
        if not isinstance(val, bytes):
            val = bytes(val)
        if len(val) > max_inline:
            npages = (len(val) + 16 + psize - 1) // psize
            ovf_pgno = next_pgno
            next_pgno += npages
            hdr = bytearray(psize * npages)
            # overflow header: pgno + P_OVERFLOW flag + page count in pb
            _PGHDR.pack_into(hdr, 0, ovf_pgno, b"\x00\x00", P_OVERFLOW, 0, 0)
            struct.pack_into("<I", hdr, 12, npages)
            hdr[16:16 + len(val)] = val
            overflow_chunks.append((ovf_pgno, bytes(hdr)))
            payload = _node_payload(key, len(val) & 0xFFFF, len(val) >> 16,
                                    F_BIGDATA, struct.pack("<Q", ovf_pgno))
        else:
            payload = _node_payload(key, len(val) & 0xFFFF, len(val) >> 16,
                                    0, val)
        size = len(payload) + (len(payload) % 2)
        if cur_used + size + 2 > psize - 16:
            flush_leaf()
        if cur_first is None:
            cur_first = key
        cur_nodes.append(payload)
        cur_sizes.append(size)
        cur_used += size + 2
    flush_leaf()

    # overflow pages were assigned pgnos inline; but we appended leaf pages
    # to `pages` in order of creation while pgnos interleave with overflow.
    # Rebuild the page table by explicit pgno.
    page_table = {}
    # leaves got their pgnos in flush_leaf; reconstruct from `leaves` and
    # `pages` ordering: pages[2:] are leaves in creation order.
    for (first, pgno), buf in zip(leaves, pages[2:]):
        page_table[pgno] = buf
    for pgno, buf in overflow_chunks:
        page_table[pgno] = buf

    # ---- branch levels
    level = leaves
    depth = 1
    branch_pages = 0
    while len(level) > 1:
        next_level = []
        i = 0
        while i < len(level):
            pgno = next_pgno
            next_pgno += 1
            out = bytearray(psize)
            nodes = []
            sizes = []
            used = 0
            first_key = level[i][0]
            j = i
            while j < len(level):
                k = b"" if j == i else level[j][0]
                child = level[j][1]
                payload = _NODEHDR.pack(child & 0xFFFF,
                                        (child >> 16) & 0xFFFF,
                                        (child >> 32) & 0xFFFF,
                                        len(k)) + k
                s = len(payload) + (len(payload) % 2)
                if used + s + 2 > psize - 16:
                    break
                nodes.append(payload)
                sizes.append(s)
                used += s + 2
                j += 1
            lower = 16 + 2 * len(nodes)
            upper = psize - sum(sizes)
            _PGHDR.pack_into(out, 0, pgno, b"\x00\x00", P_BRANCH, lower,
                             upper)
            pos = upper
            for idx2, (payload, s) in enumerate(zip(nodes, sizes)):
                struct.pack_into("<H", out, 16 + 2 * idx2, pos)
                out[pos: pos + len(payload)] = payload
                pos += s
            page_table[pgno] = bytes(out)
            branch_pages += 1
            next_level.append((first_key, pgno))
            i = j
        level = next_level
        depth += 1

    root = level[0][1] if level else _INVALID
    if not items:
        root = _INVALID
        depth = 0

    # ---- metas
    n_leaf = len(leaves)
    n_ovf = sum((len(buf) // psize) for _, buf in overflow_chunks)
    last_pg = next_pgno - 1

    def meta(txnid: int, pgno: int) -> bytes:
        out = bytearray(psize)
        _PGHDR.pack_into(out, 0, pgno, b"\x00\x00", P_META, 0, 0)
        _META.pack_into(out, 16, MAGIC, VERSION, 0, psize * (last_pg + 1))
        dbs_off = 16 + _META.size
        # FREE_DBI: md_pad carries the page size
        _DB.pack_into(out, dbs_off, psize, 0, 0, 0, 0, 0, 0, _INVALID)
        _DB.pack_into(out, dbs_off + _DB.size, 0, 0, depth, branch_pages,
                      n_leaf, n_ovf, len(items), root)
        struct.pack_into("<QQ", out, dbs_off + 2 * _DB.size, last_pg, txnid)
        return bytes(out)

    if subdir:
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, "data.mdb")
    with open(path, "wb") as f:
        f.write(meta(0, 0))
        f.write(meta(1, 1))
        for pgno in range(2, next_pgno):
            buf = page_table.get(pgno)
            if buf is None:
                continue  # tail of a multi-page overflow chunk
            f.write(buf)


def open_env(path: str) -> Env:
    return Env(path)
