"""The HDF5 structures of the newer file formats, which h5py writes with
`libver="latest"` (or "v108" and later) and, in part, for `track_order=True`:
the Jenkins lookup3 checksum that guards each of them, the fractal heap, the
version-2 B-tree, and the fixed and extensible arrays that index a dataset's
chunks. `data/h5file.py` reads objects, groups and datasets over them.
The last section writes what its writer needs to edit such a file in
place: a version-2 object header of one chunk, link, Link Info, Group Info
and Attribute Info messages, and superblock 2/3, each checksum computed as
HDF5 computes it.

Each reader takes the file (`H5File`: its `_read(addr, n)` and `path`) and
the structure's address. Every block that carries a checksum is verified as
it is read: a mismatch raises `ValueError` naming the structure and its
address, and no data of that block is returned. What a reader does not
decode raises `NotImplementedError` naming it. Offsets and lengths are 8
bytes wide (the superblock is held to that).
"""

from __future__ import annotations

import bisect
import struct
from typing import Dict, Iterator, List, Optional, Tuple

UNDEF = 0xFFFFFFFFFFFFFFFF
_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# the checksum
# ---------------------------------------------------------------------------


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M32


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 `hashlittle` of `data`, as HDF5's
    `H5_checksum_lookup3` computes it."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M32
    full = (n - 1) // 12 if n else 0  # the last 1..12 bytes go through the final mix
    words = struct.unpack_from(f"<{3 * full}I", data)
    for i in range(0, 3 * full, 3):
        a = (a + words[i]) & _M32
        b = (b + words[i + 1]) & _M32
        c = (c + words[i + 2]) & _M32
        a = (a - c) & _M32 ^ _rot(c, 4)
        c = (c + b) & _M32
        b = (b - a) & _M32 ^ _rot(a, 6)
        a = (a + c) & _M32
        c = (c - b) & _M32 ^ _rot(b, 8)
        b = (b + a) & _M32
        a = (a - c) & _M32 ^ _rot(c, 16)
        c = (c + b) & _M32
        b = (b - a) & _M32 ^ _rot(a, 19)
        a = (a + c) & _M32
        c = (c - b) & _M32 ^ _rot(b, 4)
        b = (b + a) & _M32
    if n == 12 * full:
        return c
    x, y, z = struct.unpack("<III", data[12 * full:].ljust(12, b"\0"))
    a, b, c = (a + x) & _M32, (b + y) & _M32, (c + z) & _M32
    c = (c ^ b) - _rot(b, 14) & _M32
    a = (a ^ c) - _rot(c, 11) & _M32
    b = (b ^ a) - _rot(a, 25) & _M32
    c = (c ^ b) - _rot(b, 16) & _M32
    a = (a ^ c) - _rot(c, 4) & _M32
    b = (b ^ a) - _rot(a, 14) & _M32
    c = (c ^ b) - _rot(b, 24) & _M32
    return c


def verify(file, buf: bytes, what: str, addr: int, signature: Optional[bytes] = None) -> bytes:
    """`buf` (read at `addr`) if it starts with `signature` and its last four
    bytes are the lookup3 checksum of the rest; else ValueError."""
    if signature is not None and buf[:4] != signature:
        raise ValueError(f"{file.path}: no {what} at {addr} (signature {buf[:4]!r})")
    if struct.unpack_from("<I", buf, len(buf) - 4)[0] != lookup3(buf[:-4]):
        raise ValueError(f"{file.path}: the {what} at {addr} fails its checksum")
    return buf


def read_verified(file, addr: int, n: int, what: str, signature: Optional[bytes]) -> bytes:
    return verify(file, file._read(addr, n), what, addr, signature)


def _uint(b: bytes) -> int:
    return int.from_bytes(b, "little")


def _log2(n: int) -> int:
    return n.bit_length() - 1


def _enc_size(n: int) -> int:
    """Bytes HDF5 takes to store counts up to `n` (`H5VM_limit_enc_size`)."""
    return max(_log2(n), 0) // 8 + 1


# ---------------------------------------------------------------------------
# version-2 B-trees
# ---------------------------------------------------------------------------


class BTree2:
    """A version-2 B-tree: `records()` gives every record's bytes, in the
    tree's order (HDF5's record types say what they hold)."""

    def __init__(self, file, addr: int):
        self.file, self.addr = file, addr
        head = read_verified(file, addr, 38, "v2 B-tree header", b"BTHD")
        if head[4] != 0:
            raise NotImplementedError(f"HDF5 v2 B-tree header version {head[4]}")
        (self.type, node_size, self.rec_size, self.depth, _, _, self.root,
         self.root_nrec) = struct.unpack_from("<BIHHBBQH", head, 5)
        # records a node of each depth holds at most, and the widths of the
        # child counts an internal node stores (H5B2__hdr_init)
        leaf_max = (node_size - 10) // self.rec_size
        self._nrec_size = _enc_size(leaf_max)
        cum, self._cum_size = [leaf_max], [0]
        for d in range(1, self.depth + 1):
            ptr = 8 + self._nrec_size + (self._cum_size[d - 1] if d > 1 else 0)
            most = (node_size - 10 - ptr) // (self.rec_size + ptr)
            cum.append((most + 1) * cum[d - 1] + most)
            self._cum_size.append(_enc_size(cum[d]))

    def records(self) -> Iterator[bytes]:
        if self.root == UNDEF or self.root_nrec == 0:
            return
        yield from self._node(self.root, self.root_nrec, self.depth)

    def _node(self, addr: int, nrec: int, depth: int) -> Iterator[bytes]:
        rs = self.rec_size
        if depth == 0:
            buf = read_verified(self.file, addr, 6 + nrec * rs + 4, "v2 B-tree leaf node",
                                b"BTLF")
            for i in range(nrec):
                yield buf[6 + i * rs:6 + (i + 1) * rs]
            return
        nsize, tsize = self._nrec_size, (self._cum_size[depth - 1] if depth > 1 else 0)
        ptr = 8 + nsize + tsize
        buf = read_verified(self.file, addr, 6 + nrec * rs + (nrec + 1) * ptr + 4,
                            "v2 B-tree internal node", b"BTIN")
        at = 6 + nrec * rs
        children = [(struct.unpack_from("<Q", buf, at + i * ptr)[0],
                     _uint(buf[at + i * ptr + 8:at + i * ptr + 8 + nsize]))
                    for i in range(nrec + 1)]
        for i, (child, n) in enumerate(children):
            yield from self._node(child, n, depth - 1)
            if i < nrec:
                yield buf[6 + i * rs:6 + (i + 1) * rs]


# ---------------------------------------------------------------------------
# fractal heaps
# ---------------------------------------------------------------------------


class FractalHeap:
    """A fractal heap: `get(heap_id)` returns an object's bytes. Managed
    objects (in direct blocks under a root direct or indirect block of any
    depth), tiny objects (in the ID itself) and huge objects that are not
    filtered (their own addresses, directly in the ID or through the heap's
    v2 B-tree)."""

    def __init__(self, file, addr: int):
        self.file, self.addr = file, addr
        buf = file._read(addr, 146)  # a filtered heap's header is longer
        if buf[:4] != b"FRHP":
            raise ValueError(f"{file.path}: no fractal heap header at {addr}")
        if buf[4] != 0:
            raise NotImplementedError(f"HDF5 fractal heap version {buf[4]}")
        self.id_len, filter_len, flags, self.max_managed = struct.unpack_from("<HHBI", buf, 5)
        if filter_len:
            raise NotImplementedError(f"HDF5 filtered fractal heaps (at {addr})")
        verify(file, buf, "fractal heap header", addr)
        self._checksummed = bool(flags & 2)
        self._huge_btree = struct.unpack_from("<Q", buf, 22)[0]
        (self.width, self.start_size, self.max_direct, max_heap_bits, _, self.root,
         self.root_rows) = struct.unpack_from("<HQQHHQH", buf, 110)
        self._off_size = (max_heap_bits + 7) // 8
        self._len_size = min((_log2(self.max_direct) + 7) // 8, _enc_size(self.max_managed))
        self._max_direct_rows = _log2(self.max_direct) - _log2(self.start_size) + 2
        self._first_row_bits = _log2(self.start_size) + _log2(self.width)
        self._blocks: Optional[List[Tuple[int, int, int]]] = None  # (offset, size, address)
        self._data: Dict[int, bytes] = {}
        self._huge: Optional[Dict[int, Tuple[int, int]]] = None

    def _row_size(self, r: int) -> int:
        return self.start_size if r == 0 else self.start_size << (r - 1)

    def _row_offset(self, r: int) -> int:
        return 0 if r == 0 else self.width * self.start_size << (r - 1)

    def _direct_blocks(self) -> List[Tuple[int, int, int]]:
        if self._blocks is None:
            blocks: List[Tuple[int, int, int]] = []
            if self.root != UNDEF:
                if self.root_rows == 0:
                    blocks.append((0, self.start_size, self.root))
                else:
                    self._walk(self.root, self.root_rows, blocks, 0)
            self._blocks = sorted(blocks)
        return self._blocks

    def _walk(self, addr: int, nrows: int, out: List[Tuple[int, int, int]], depth: int):
        if depth > 64:
            raise ValueError(f"{self.file.path}: fractal heap at {self.addr} does not end")
        prefix = 13 + self._off_size
        buf = read_verified(self.file, addr, prefix + nrows * self.width * 8 + 4,
                            "fractal heap indirect block", b"FHIB")
        base = _uint(buf[13:prefix])
        for r in range(nrows):
            for c in range(self.width):
                (child,) = struct.unpack_from("<Q", buf, prefix + (r * self.width + c) * 8)
                if child == UNDEF:
                    continue
                offset = base + self._row_offset(r) + c * self._row_size(r)
                if r < self._max_direct_rows:
                    out.append((offset, self._row_size(r), child))
                else:
                    rows = _log2(self._row_size(r)) - self._first_row_bits + 1
                    self._walk(child, rows, out, depth + 1)

    def _block(self, offset: int, size: int, addr: int) -> bytes:
        data = self._data.get(addr)
        if data is None:
            data = self.file._read(addr, size)
            if data[:4] != b"FHDB":
                raise ValueError(f"{self.file.path}: no fractal heap direct block at {addr}")
            prefix = 13 + self._off_size
            if _uint(data[13:prefix]) != offset:
                raise ValueError(f"{self.file.path}: fractal heap direct block at {addr} "
                                 f"holds offset {_uint(data[13:prefix])}, want {offset}")
            if self._checksummed:  # over the whole block, its checksum field zeroed
                (stored,) = struct.unpack_from("<I", data, prefix)
                if stored != lookup3(data[:prefix] + b"\0" * 4 + data[prefix + 4:]):
                    raise ValueError(f"{self.file.path}: the fractal heap direct block at "
                                     f"{addr} fails its checksum")
            self._data[addr] = data
        return data

    def get(self, heap_id: bytes) -> bytes:
        if heap_id[0] >> 6 != 0:
            raise NotImplementedError(f"HDF5 fractal heap ID version {heap_id[0] >> 6}")
        kind = heap_id[0] >> 4 & 3
        if kind == 0:  # managed: an offset into the heap's space and a length
            offset = _uint(heap_id[1:1 + self._off_size])
            length = _uint(heap_id[1 + self._off_size:1 + self._off_size + self._len_size])
            blocks = self._direct_blocks()
            i = bisect.bisect_right(blocks, (offset, UNDEF, UNDEF)) - 1
            if i < 0 or offset + length > blocks[i][0] + blocks[i][1]:
                raise ValueError(f"{self.file.path}: fractal heap at {self.addr} has no "
                                 f"object at offset {offset}")
            start = offset - blocks[i][0]  # objects count from the block's own start
            return self._block(*blocks[i])[start:start + length]
        if kind == 2:  # tiny: the object is in the ID
            if self.id_len <= 18:
                return heap_id[1:2 + (heap_id[0] & 0x0F)]
            n = ((heap_id[0] & 0x0F) << 8 | heap_id[1]) + 1
            return heap_id[2:2 + n]
        if kind == 1:  # huge: its own place in the file
            if self.id_len >= 17:
                addr, length = struct.unpack_from("<QQ", heap_id, 1)
            else:
                key = _uint(heap_id[1:1 + min(self.id_len - 1, 8)])
                entry = self._huge_objects().get(key)
                if entry is None:
                    raise ValueError(f"{self.file.path}: fractal heap at {self.addr} has no "
                                     f"huge object {key}")
                addr, length = entry
            return self.file._read(addr, length)
        raise NotImplementedError(f"HDF5 fractal heap ID of type {kind}")

    def _huge_objects(self) -> Dict[int, Tuple[int, int]]:
        if self._huge is None:
            self._huge = {}
            if self._huge_btree != UNDEF:
                tree = BTree2(self.file, self._huge_btree)
                if tree.type != 1:
                    raise NotImplementedError(f"HDF5 huge objects in a v2 B-tree of record "
                                              f"type {tree.type} (filtered or direct)")
                for rec in tree.records():
                    addr, length, key = struct.unpack_from("<QQQ", rec)
                    self._huge[key] = (addr, length)
        return self._huge


# ---------------------------------------------------------------------------
# fixed and extensible arrays (chunk indexes)
# ---------------------------------------------------------------------------


def _bit(bitmap: bytes, i: int) -> bool:
    return bool(bitmap[i // 8] & (0x80 >> (i % 8)))


def fixed_array(file, addr: int) -> Iterator[Tuple[int, bytes]]:
    """(index, element bytes) of every element of the fixed array whose
    header is at `addr`, pages that were never written left out."""
    head = read_verified(file, addr, 28, "fixed array header", b"FAHD")
    if head[4] != 0:
        raise NotImplementedError(f"HDF5 fixed array version {head[4]}")
    esize, page_bits = head[6], head[7]
    n, dblk = struct.unpack_from("<QQ", head, 8)
    if dblk == UNDEF or n == 0:
        return
    page_n = 1 << page_bits
    if n <= page_n:
        buf = read_verified(file, dblk, 18 + n * esize, "fixed array data block", b"FADB")
        for i in range(n):
            yield i, buf[14 + i * esize:14 + (i + 1) * esize]
        return
    npages = -(-n // page_n)
    prefix = 14 + -(-npages // 8) + 4
    head = read_verified(file, dblk, prefix, "fixed array data block", b"FADB")
    bitmap = head[14:prefix - 4]
    at = dblk + prefix
    for p in range(npages):
        count = min(page_n, n - p * page_n)
        if _bit(bitmap, p):
            page = read_verified(file, at, count * esize + 4, "fixed array data block page",
                                 None)
            for i in range(count):
                yield p * page_n + i, page[i * esize:(i + 1) * esize]
        at += page_n * esize + 4


def extensible_array(file, addr: int) -> Iterator[Tuple[int, bytes]]:
    """(index, element bytes) of every element the extensible array whose
    header is at `addr` holds: its index block's own elements, the data
    blocks it points to, and those of its secondary blocks (paged or not);
    blocks never written left out."""
    head = read_verified(file, addr, 72, "extensible array header", b"EAHD")
    if head[4] != 0:
        raise NotImplementedError(f"HDF5 extensible array version {head[4]}")
    esize, max_bits, iblk_n, dblk_min, sblk_min_ptrs, page_bits = head[6:12]
    max_set = struct.unpack_from("<Q", head, 44)[0]  # one past the largest index set
    (iblock,) = struct.unpack_from("<Q", head, 60)
    if iblock == UNDEF:
        return
    off_size = (max_bits + 7) // 8
    page_n = 1 << page_bits
    # super block s: 2^(s // 2) data blocks of 2^((s + 1) // 2) * dblk_min elements
    nsblks = 1 + max_bits - _log2(dblk_min)
    sblks, start = [], iblk_n
    for s in range(nsblks):
        sblks.append((1 << s // 2, (1 << (s + 1) // 2) * dblk_min, start))
        start += sblks[-1][0] * sblks[-1][1]
    in_iblock = 2 * _log2(sblk_min_ptrs)  # super blocks whose data blocks the index block holds
    n_dblk = 2 * (sblk_min_ptrs - 1)
    n_sblk = nsblks - in_iblock
    buf = read_verified(file, iblock, 14 + iblk_n * esize + (n_dblk + n_sblk) * 8 + 4,
                        "extensible array index block", b"EAIB")
    for i in range(min(iblk_n, max_set)):
        yield i, buf[14 + i * esize:14 + (i + 1) * esize]
    at = 14 + iblk_n * esize
    dblks = struct.unpack_from(f"<{n_dblk}Q", buf, at)
    sblk_addrs = struct.unpack_from(f"<{n_sblk}Q", buf, at + n_dblk * 8)

    def data_block(daddr: int, count: int, first: int, bitmap: Optional[bytes], bit0: int):
        """The elements of the data block at `daddr` (`count` of them from
        index `first`); a paged block's pages are set in `bitmap` from bit
        `bit0` on."""
        if daddr == UNDEF or first >= max_set:
            return
        prefix = 14 + off_size
        if count <= page_n:
            blk = read_verified(file, daddr, prefix + count * esize + 4,
                                "extensible array data block", b"EADB")
            for i in range(count):
                yield first + i, blk[prefix + i * esize:prefix + (i + 1) * esize]
            return
        if bitmap is None:
            raise NotImplementedError("HDF5 paged data blocks in an extensible array's index "
                                      "block")
        read_verified(file, daddr, prefix + 4, "extensible array data block", b"EADB")
        at = daddr + prefix + 4
        for p in range(count // page_n):
            if _bit(bitmap, bit0 + p):
                page = read_verified(file, at, page_n * esize + 4,
                                     "extensible array data block page", None)
                for i in range(page_n):
                    yield first + p * page_n + i, page[i * esize:(i + 1) * esize]
            at += page_n * esize + 4

    d = 0
    for s in range(min(in_iblock, nsblks)):
        count, size, first = sblks[s]
        for j in range(count):
            yield from data_block(dblks[d], size, first + j * size, None, 0)
            d += 1
    for k, saddr in enumerate(sblk_addrs):
        count, size, first = sblks[in_iblock + k]
        if saddr == UNDEF or first >= max_set:
            continue
        # a paged data block's pages are set in a bitmap of its own bytes,
        # but indexed across the blocks (H5EA__lookup_elmt)
        npages = size // page_n if size > page_n else 0
        bitmap_size = count * (-(-npages // 8))
        prefix = 14 + off_size
        sbuf = read_verified(file, saddr, prefix + bitmap_size + count * 8 + 4,
                             "extensible array secondary block", b"EASB")
        bitmap = sbuf[prefix:prefix + bitmap_size]
        addrs = struct.unpack_from(f"<{count}Q", sbuf, prefix + bitmap_size)
        for j, daddr in enumerate(addrs):
            yield from data_block(daddr, size, first + j * size, bitmap, j * npages)


# ---------------------------------------------------------------------------
# the write side
# ---------------------------------------------------------------------------


def ohdr(flags: int, prefix: bytes, msgs) -> bytes:
    """A version-2 object header of one chunk, under its checksum. `flags`
    bits 2-5 say whether attribute creation order is tracked (then every
    message header carries one) and indexed, and whether the attribute
    phase change and the times are stored (`prefix` holds them: times, then
    phase change); the width of the chunk's size is chosen here. `msgs` are
    (type, flags, creation order, data)."""
    order = bool(flags & 0x04)
    parts = []
    for mtype, mflags, corder, data in msgs:
        if len(data) > 0xFFFF:
            raise NotImplementedError(f"an HDF5 header message of {len(data)} bytes "
                                      f"(type {mtype}): more than a header holds")
        parts.append(struct.pack("<BHB", mtype, len(data), mflags)
                     + (struct.pack("<H", corder) if order else b"") + data)
    body = b"".join(parts)
    width = 0 if len(body) < 1 << 8 else 1 if len(body) < 1 << 16 else 2
    head = (b"OHDR" + bytes([2, flags & 0x3C | width]) + prefix
            + len(body).to_bytes(1 << width, "little") + body)
    return head + struct.pack("<I", lookup3(head))


def link_message(name: str, addr: int, corder: Optional[int] = None) -> bytes:
    """A hard link message to the object header at `addr`, with its creation
    order where the group tracks it; a name that is not ASCII is marked
    UTF-8."""
    nb = name.encode("utf-8")
    width = 0 if len(nb) < 1 << 8 else 1 if len(nb) < 1 << 16 else 2
    flags = width | (0x04 if corder is not None else 0) | (0 if nb.isascii() else 0x10)
    return (bytes([1, flags]) + (struct.pack("<q", corder) if corder is not None else b"")
            + (b"\x01" if flags & 0x10 else b"") + len(nb).to_bytes(1 << width, "little")
            + nb + struct.pack("<Q", addr))


def link_info(flags: int, next_order: int) -> bytes:
    """The Link Info message of a group whose links are all in its header
    (no fractal heap, no index): creation order tracked (flag 1, with the
    next order to give) and indexed (flag 2) as `flags` say."""
    return (bytes([0, flags & 3]) + (struct.pack("<q", next_order) if flags & 1 else b"")
            + struct.pack("<QQ", UNDEF, UNDEF) + (struct.pack("<Q", UNDEF) if flags & 2 else b""))


def group_info(old: Optional[bytes], n_links: int) -> bytes:
    """A Group Info message: `old`'s (HDF5's defaults if None) with the
    largest compact count raised to at least `n_links`, so that the links
    may stay in the header; at most 65,535."""
    flags, most, least, estimates = 0, 8, 6, b""
    if old is not None:
        if old[0] != 0:
            raise NotImplementedError(f"HDF5 group info message version {old[0]}")
        flags, pos = old[1] & 3, 2
        if flags & 1:
            most, least = struct.unpack_from("<HH", old, pos)
            pos += 4
        estimates = old[pos:pos + 4] if flags & 2 else b""
    if n_links > 0xFFFF:
        raise ValueError(f"{n_links} links do not fit a Group Info message")
    if n_links > most:
        flags, most = flags | 1, n_links
    return bytes([0, flags]) + (struct.pack("<HH", most, least) if flags & 1 else b"") + estimates


def attribute_info(flags: int, next_order: int) -> bytes:
    """The Attribute Info message of an object whose attributes are all in
    its header: creation order tracked (flag 1, with the next order to give)
    and indexed (flag 2) as `flags` say."""
    return (bytes([0, flags & 3]) + (struct.pack("<H", next_order & 0xFFFF) if flags & 1 else b"")
            + struct.pack("<QQ", UNDEF, UNDEF) + (struct.pack("<Q", UNDEF) if flags & 2 else b""))


def superblock(old: bytes, eof: int, root: int) -> bytes:
    """Superblock 2 or 3 `old` with a new end-of-file address and root
    object header, under a new checksum."""
    sb = old[:28] + struct.pack("<QQ", eof, root)
    return sb + struct.pack("<I", lookup3(sb))
