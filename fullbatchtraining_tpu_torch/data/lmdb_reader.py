"""A read-only parser of LMDB database files, with no dependency beyond the
standard library (the port's own copy of
``fullbatchtraining_tpu/data/lmdb_reader.py``).

The upstream project keeps datasets and loss surfaces in LMDB files
(datasets: ascii index keys to raw uint8 image rows plus pickled
``__keys__``/``__labels__``/``__len__``/``__shape__``; surfaces: pickled
position keys to pickled metric dicts). This module reads the on-disk
B+tree straight from the memory-mapped file, enough for
``tools/lmdb_import.py`` to carry both into this package's stores.

Format (single-file databases, ``subdir=False``, as the upstream project writes):

* two meta pages at page 0/1; the live one has the larger ``mm_txnid``.
  Meta body (after the 16-byte page header): magic ``0xBEEFC0DE`` (u32),
  version (u32), address (u64), mapsize (u64), two ``MDB_db`` records of
  48 bytes (FREE_DBI then MAIN_DBI), last_pg (u64), txnid (u64). The main
  tree root page number sits at offset 40 inside the MAIN record.
* every page: pgno (u64), pad (u16), flags (u16), then for branch/leaf
  pages ``lower``/``upper`` (u16 each) bounding the node-pointer array /
  node heap; ``mp_ptrs`` (u16 page offsets) start at byte 16.
* node header (8 bytes): ``lo``/``hi``/``flags``/``ksize`` (u16 each).
  Leaf: value size = ``lo | hi<<16``; key bytes follow the header, value
  bytes follow the key - unless ``F_BIGDATA`` (0x01), where the value is
  an 8-byte overflow page number and the payload lives after the 16-byte
  header of that overflow page (spanning ``pb_pages`` contiguous pages).
  Branch: child page number = ``lo | hi<<16 | flags<<32``; node 0 covers
  keys below every separator.

The page size is not recorded in the file; it is detected by locating the
second meta magic (page 1 starts at exactly one page). Write support is
absent: the import is one way.
"""

from __future__ import annotations

import mmap
import struct
from pathlib import Path

_MAGIC = 0xBEEFC0DE
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
F_BIGDATA = 0x01
_INVALID_PGNO = 0xFFFFFFFFFFFFFFFF
_META_HDR = struct.Struct("<II")          # magic, version
_DB_ROOT_OFF = 24 + 48 + 40               # meta body -> MAIN_DBI md_root
_META_TXNID_OFF = 24 + 2 * 48 + 8         # meta body -> mm_txnid
_MAIN_ENTRIES_OFF = 24 + 48 + 32          # meta body -> MAIN_DBI md_entries
_NODE = struct.Struct("<HHHH")            # lo, hi, flags, ksize


class CorruptDatabaseError(ValueError):
    pass


class MdbFile:
    """Read-only view of a single-file LMDB environment.

    ``get(key) -> bytes | None`` and ``items() -> iterator`` over the main
    database, both returning real ``bytes`` copies (safe after close).
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._fh = open(self.path, "rb")
        self._mm = None
        try:
            try:
                self._mm = mmap.mmap(self._fh.fileno(), 0,
                                     access=mmap.ACCESS_READ)
            except ValueError as err:
                raise CorruptDatabaseError(f"{path}: empty file") from err
            self.psize = self._detect_psize()
            self.root, self.entries = self._live_meta()
        except BaseException:
            self.close()  # don't leak the fd/mapping on invalid files
            raise

    # -- file structure -------------------------------------------------
    def _detect_psize(self) -> int:
        mm = self._mm
        if len(mm) < 32 or _META_HDR.unpack_from(mm, 16)[0] != _MAGIC:
            raise CorruptDatabaseError(f"{self.path}: no LMDB meta magic")
        for psize in (4096, 8192, 16384, 32768, 65536, 512, 1024, 2048):
            off = psize + 16
            if len(mm) >= off + 8 and _META_HDR.unpack_from(mm, off)[0] == _MAGIC:
                return psize
        raise CorruptDatabaseError(f"{self.path}: second meta page not found")

    def _live_meta(self) -> tuple[int, int]:
        best = None
        for pg in (0, 1):
            body = pg * self.psize + 16
            magic, version = _META_HDR.unpack_from(self._mm, body)
            if magic != _MAGIC:
                continue
            txnid = struct.unpack_from("<Q", self._mm, body + _META_TXNID_OFF)[0]
            root = struct.unpack_from("<Q", self._mm, body + _DB_ROOT_OFF)[0]
            entries = struct.unpack_from("<Q", self._mm, body + _MAIN_ENTRIES_OFF)[0]
            if best is None or txnid > best[0]:
                best = (txnid, root, entries)
        if best is None:
            raise CorruptDatabaseError(f"{self.path}: no valid meta page")
        return best[1], best[2]

    def _page(self, pgno: int) -> int:
        off = pgno * self.psize
        if off + 16 > len(self._mm):
            raise CorruptDatabaseError(f"{self.path}: page {pgno} out of range")
        return off

    def _page_flags(self, off: int) -> int:
        return struct.unpack_from("<H", self._mm, off + 10)[0]

    def _node_offsets(self, off: int) -> list[int]:
        lower = struct.unpack_from("<H", self._mm, off + 12)[0]
        nkeys = (lower - 16) // 2
        return [struct.unpack_from("<H", self._mm, off + 16 + 2 * i)[0]
                for i in range(nkeys)]

    def _node(self, page_off: int, node_off: int):
        lo, hi, flags, ksize = _NODE.unpack_from(self._mm, page_off + node_off)
        kstart = page_off + node_off + 8
        key = bytes(self._mm[kstart:kstart + ksize])
        return lo, hi, flags, key, kstart + ksize

    def _leaf_value(self, lo: int, hi: int, flags: int, dstart: int) -> bytes:
        size = lo | (hi << 16)
        if flags & F_BIGDATA:
            ovf = struct.unpack_from("<Q", self._mm, dstart)[0]
            ooff = self._page(ovf)
            if not self._page_flags(ooff) & P_OVERFLOW:
                raise CorruptDatabaseError(
                    f"{self.path}: page {ovf} is not an overflow page")
            dstart = ooff + 16
        if dstart + size > len(self._mm):  # mmap slicing would clamp at EOF
            raise CorruptDatabaseError(
                f"{self.path}: value extent {dstart}+{size} beyond file end "
                "(truncated database)")
        return bytes(self._mm[dstart:dstart + size])

    # -- queries --------------------------------------------------------
    def get(self, key: bytes):
        """Value stored under ``key`` in the main database, else None."""
        if self.root == _INVALID_PGNO:
            return None
        pgno = self.root
        for _ in range(64):  # depth bound against pointer cycles
            off = self._page(pgno)
            flags = self._page_flags(off)
            ptrs = self._node_offsets(off)
            if flags & P_BRANCH:
                child = None
                for i, noff in enumerate(ptrs):
                    lo, hi, nflags, nkey, _ = self._node(off, noff)
                    if i > 0 and nkey > key:
                        break
                    child = lo | (hi << 16) | (nflags << 32)
                if child is None:  # zero-node branch page
                    raise CorruptDatabaseError(
                        f"{self.path}: empty branch page {pgno}")
                pgno = child
            elif flags & P_LEAF:
                for noff in ptrs:
                    lo, hi, nflags, nkey, dstart = self._node(off, noff)
                    if nkey == key:
                        return self._leaf_value(lo, hi, nflags, dstart)
                return None
            else:
                raise CorruptDatabaseError(
                    f"{self.path}: unexpected page flags {flags:#x}")
        raise CorruptDatabaseError(f"{self.path}: tree deeper than 64 levels")

    def items(self):
        """Yield (key, value) in key order via a depth-first tree walk
        (LMDB leaf pages carry no sibling links)."""
        if self.root == _INVALID_PGNO:
            return
        # a branch page is popped once per child, a leaf once: in a real tree
        # total pops = #leaves + #edges < 2 * page count; more means a cycle
        budget = 2 * (len(self._mm) // self.psize) + 2
        stack = [(self.root, 0)]
        while stack:
            budget -= 1
            if budget < 0:  # pointer cycle in a corrupt tree
                raise CorruptDatabaseError(
                    f"{self.path}: tree walk exceeded the page count")
            pgno, idx = stack.pop()
            off = self._page(pgno)
            flags = self._page_flags(off)
            ptrs = self._node_offsets(off)
            if flags & P_BRANCH:
                if idx >= len(ptrs):  # zero-node branch page
                    raise CorruptDatabaseError(
                        f"{self.path}: empty branch page {pgno}")
                if idx + 1 < len(ptrs):
                    stack.append((pgno, idx + 1))
                lo, hi, nflags, _, _ = self._node(off, ptrs[idx])
                stack.append((lo | (hi << 16) | (nflags << 32), 0))
            elif flags & P_LEAF:
                for noff in ptrs:
                    lo, hi, nflags, nkey, dstart = self._node(off, noff)
                    yield nkey, self._leaf_value(lo, hi, nflags, dstart)
            else:
                raise CorruptDatabaseError(
                    f"{self.path}: unexpected page flags {flags:#x}")

    def keys(self):
        return (k for k, _ in self.items())

    def close(self):
        if self._mm is not None:
            self._mm.close()
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __len__(self):
        return self.entries
