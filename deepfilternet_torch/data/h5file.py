"""HDF5 files in numpy, `struct` and `zlib`: the port reads and writes the
corpora of the data engine without h5py.

The reader (`H5File`) covers what h5py writes with its default `libver`
("earliest"), which is what the JAX package's `scripts/prepare_data.py`
and the reference's corpora use:

  * superblock version 0 or 1, 8-byte offsets and lengths, any user block;
  * version-1 object headers with their continuation blocks;
  * symbol-table groups (a v1 group B-tree of any depth, symbol-table nodes,
    a local heap);
  * contiguous, compact and chunked data layouts (layout message version 3),
    the chunks indexed by a v1 B-tree of any depth;

and what it writes with `libver="latest"` (or "v108" and later), and for
`track_order=True`, over the structures of `data/h5v2.py`:

  * superblock version 2 or 3, under its lookup3 checksum;
  * version-2 object headers ("OHDR", "OCHK" continuation blocks; times,
    phase-change values, creation-ordered messages, gaps), each block under
    its checksum;
  * groups of link messages: compact (in the header) or dense (a fractal
    heap indexed by a v2 B-tree of names or of creation order);
  * attributes in dense storage (a fractal heap, huge objects included, and
    a v2 B-tree of names or of creation order);
  * data layout message version 4: compact, contiguous, and chunked with any
    chunk index h5py writes (a single chunk, filtered or not; implicit; a
    fixed array, paged or not; an extensible array with its secondary and
    paged data blocks; a v2 B-tree of filtered or unfiltered records);
    fill values (messages of version 1 to 3) where a chunk was never written;

and in every format:

  * the deflate and shuffle filters;
  * little- and big-endian integers and IEEE floats, fixed-length strings,
    variable-length strings (the global heap);
  * attributes of any of these types, scalar or array.

A block whose checksum does not match raises `ValueError` naming it.
Everything else raises `NotImplementedError` that names the HDF5 feature
(a superblock extension; filtered fractal heaps; shared messages; other
filters; soft, external and user-defined links; compound, array, enum,
reference and opaque types; ...): the reader never returns data it did not
decode.

Its interface is the part of h5py's the data engine uses: `H5File(path)`,
`f.attrs` (a dict; variable-length strings come back as `str`, fixed-length
ones as `np.bytes_`, numbers as numpy scalars or arrays, as h5py gives
them), `f[path]`, `name in group`, `group.keys()` (in h5py's order: by
creation order where a group tracks it, else by name), `ds.shape`,
`ds.dtype`, `ds.chunks`, `ds.attrs` and `ds[...]` / `ds[..., a:b]` (basic
slicing; a chunked read decodes only the chunks the selection touches).
Reads use `os.pread`, so one file serves several threads.

`H5Writer` writes the layout of `prepare_data`: superblock 0, symbol-table
groups (any number of keys), chunked datasets compressed by deflate,
attributes of numbers and strings. In mode "a" it edits a file of
superblock 0, 2 or 3 in place, in that file's own form, as h5py's modes "a"
and "r+" do (copy-on-write toward the root; see `H5Writer`), and
`copy_group` copies chunks byte for byte, as h5py's `copy` does. h5py reads
and edits again what it writes.
"""

from __future__ import annotations

import itertools
import os
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from deepfilternet_torch.data import h5v2

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF

# object header message types
_DATASPACE, _LINKINFO, _DATATYPE, _OLD_FILL, _FILL = 0x01, 0x02, 0x03, 0x04, 0x05
_LINK, _EXTERNAL, _LAYOUT, _GROUPINFO, _PIPELINE = 0x06, 0x07, 0x08, 0x0A, 0x0B
_ATTRIBUTE, _CONTINUATION, _STAB, _ATTRINFO = 0x0C, 0x10, 0x11, 0x15

_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
                 6: "scaleoffset", 32001: "blosc", 32004: "lz4", 32015: "zstd"}
_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
                8: "enum", 10: "array"}

# the B-tree and symbol-table node widths the writer uses (HDF5's defaults,
# which superblock 0 implies for chunk B-trees)
_GROUP_LEAF_K, _GROUP_INTERNAL_K, _CHUNK_K = 4, 16, 32
# the writer's chunks: whole leading dimensions, one second at 48 kHz of the
# last; gzip level 2 (what the JAX package's prepare_data asks h5py for)
CHUNK, LEVEL = 48000, 2
_ENTRY_SIZE = 40  # a symbol table entry with 8-byte offsets
# the most links a group of link messages may hold: Group Info counts them in
# 16 bits (the writer makes a symbol table of a larger one)
_MAX_LINK_MESSAGES = 0xFFFF


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# ---------------------------------------------------------------------------
# datatypes
# ---------------------------------------------------------------------------


class _Type:
    """A decoded datatype: `kind` "num" (numpy dtype), "str" (fixed length)
    or "vstr" (variable-length string); `size` bytes an element."""

    def __init__(self, kind: str, size: int, dtype: Optional[np.dtype] = None,
                 utf8: bool = False):
        self.kind, self.size, self.dtype, self.utf8 = kind, size, dtype, utf8


_IEEE = {  # size: (sign location, exponent location, size, mantissa size, bias)
    2: (15, 10, 5, 10, 15),
    4: (31, 23, 8, 23, 127),
    8: (63, 52, 11, 52, 1023),
}


def _parse_type(d: bytes) -> _Type:
    cls, version = d[0] & 0x0F, d[0] >> 4
    bits = d[1] | d[2] << 8 | d[3] << 16
    (size,) = struct.unpack_from("<I", d, 4)
    if version not in (1, 2, 3):
        raise NotImplementedError(f"HDF5 datatype message version {version}")
    if cls == 0:  # fixed point
        offset, precision = struct.unpack_from("<HH", d, 8)
        if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size:
            raise NotImplementedError(f"HDF5 bit-packed integers ({precision} bits at "
                                      f"{offset} in {size} bytes)")
        order = ">" if bits & 1 else "<"
        return _Type("num", size, np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}"))
    if cls == 1:  # floating point
        if bits & 0x40:
            raise NotImplementedError("HDF5 VAX-order floats")
        offset, precision, e_loc, e_size, m_loc, m_size, bias = struct.unpack_from(
            "<HHBBBBI", d, 8)
        if (size not in _IEEE or (bits >> 8 & 0xFF, e_loc, e_size, m_size, bias) != _IEEE[size]
                or offset != 0 or precision != 8 * size or m_loc != 0):
            raise NotImplementedError(f"HDF5 non-IEEE {size}-byte floats")
        order = ">" if bits & 1 else "<"
        return _Type("num", size, np.dtype(f"{order}f{size}"))
    if cls == 3:  # fixed-length string
        return _Type("str", size, np.dtype(f"S{size}"))
    if cls == 9:  # variable length
        if bits & 0xF != 1:
            raise NotImplementedError("HDF5 variable-length sequences")
        return _Type("vstr", size, utf8=bool(bits >> 8 & 0xF))
    raise NotImplementedError(f"HDF5 {_CLASS_NAMES.get(cls, f'class-{cls}')} datatypes")


def _parse_space(d: bytes) -> Optional[Tuple[int, ...]]:
    """The dataspace's dimensions; () for a scalar, None for a null space."""
    return _parse_space_max(d)[0]


def _parse_space_max(d: bytes) -> Tuple[Optional[Tuple[int, ...]], Optional[Tuple[int, ...]]]:
    """(dimensions, maximum dimensions) of a dataspace message; UNDEF is an
    unlimited maximum."""
    version, rank, flags = d[0], d[1], d[2]
    if version == 1:
        pos = 8
    elif version == 2:
        if d[3] == 2:
            return None, None
        pos = 4
    else:
        raise NotImplementedError(f"HDF5 dataspace message version {version}")
    dims = struct.unpack_from(f"<{rank}Q", d, pos)
    if not flags & 1:
        return dims, dims
    return dims, struct.unpack_from(f"<{rank}Q", d, pos + 8 * rank)


def _attr_parts(d: bytes) -> Tuple[str, bytes, bytes, bytes]:
    """(name, datatype message, dataspace message, value bytes) of an
    attribute message."""
    version = d[0]
    if version == 1:
        nlen, tlen, slen = struct.unpack_from("<HHH", d, 2)
        pos = 8
        name = d[pos:pos + nlen].split(b"\0")[0]
        pos += _pad8(nlen)
        tdata = d[pos:pos + tlen]
        pos += _pad8(tlen)
        sdata = d[pos:pos + slen]
        pos += _pad8(slen)
    elif version in (2, 3):
        if d[1] & 3:
            raise NotImplementedError("HDF5 shared datatypes or dataspaces in an attribute")
        nlen, tlen, slen = struct.unpack_from("<HHH", d, 2)
        pos = 8 + (1 if version == 3 else 0)
        name = d[pos:pos + nlen].split(b"\0")[0]
        tdata = d[pos + nlen:pos + nlen + tlen]
        sdata = d[pos + nlen + tlen:pos + nlen + tlen + slen]
        pos += nlen + tlen + slen
    else:
        raise NotImplementedError(f"HDF5 attribute message version {version}")
    return name.decode("utf-8"), tdata, sdata, d[pos:]


class _Header:
    """An object header as the file holds it: `version` (1 or 2), a
    version-2 header's `flags` and the fields after them (`prefix`: times,
    attribute phase change), a version-1 header's reference count, and every
    message but continuations and null messages as (type, flags, creation
    order, data)."""

    def __init__(self, version: int, flags: int, prefix: bytes, refcount: int, msgs):
        self.version, self.flags, self.prefix = version, flags, prefix
        self.refcount, self.msgs = refcount, msgs


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------


class H5File:
    """A read-only HDF5 file (see the module docstring for what it reads).
    Use as a context manager or call `close()`."""

    def __init__(self, path: str):
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        try:
            self._size = os.fstat(self._fd).st_size
            # the superblock's own place (after any user block) and version,
            # and the root group's object header
            self._sb_at = self._base = self._find_superblock()
            self.superblock_version = os.pread(self._fd, 9, self._base)[8]
            self._root_addr = UNDEF
            self._objects: Dict[int, object] = {}
            self._gheaps: Dict[int, Dict[int, bytes]] = {}
            self._root = self._read_superblock()
        except BaseException:
            os.close(self._fd)
            raise

    # -- raw access ----------------------------------------------------------

    def _read(self, addr: int, n: int) -> bytes:
        if addr == UNDEF or addr + n > self._size - self._base:
            raise ValueError(f"{self.path}: read of {n} bytes at {addr} beyond the file")
        data = os.pread(self._fd, n, self._base + addr)
        if len(data) != n:
            raise ValueError(f"{self.path}: short read at {addr}")
        return data

    def _find_superblock(self) -> int:
        at = 0
        while at + 8 <= self._size:
            if os.pread(self._fd, 8, at) == SIGNATURE:
                return at
            at = 512 if at == 0 else 2 * at
        raise ValueError(f"{self.path}: not an HDF5 file")

    def _read_superblock(self) -> "Group":
        head = os.pread(self._fd, 16, self._base)
        version = head[8]
        if version in (2, 3):
            return self._read_superblock_v2()
        if version not in (0, 1):
            raise NotImplementedError(f"HDF5 superblock version {version}")
        if head[13] != 8 or head[14] != 8:
            raise NotImplementedError(f"HDF5 offsets of {head[13]} and lengths of "
                                      f"{head[14]} bytes (only 8 are read)")
        pos = 24 + (4 if version == 1 else 0)
        sb = os.pread(self._fd, pos + 32 + _ENTRY_SIZE, self._base)
        # every address is relative to the base address, an absolute one
        # (the superblock's own place after a user block)
        self._base, _, eof, _ = struct.unpack_from("<4Q", sb, pos)
        _, self._root_addr = struct.unpack_from("<QQ", sb, pos + 32)
        self._check_eof(eof)
        return self._object(self._root_addr, "/")

    def _read_superblock_v2(self) -> "Group":
        """Superblock version 2 or 3 (libver "v108" and later): base address,
        extension, end of file and root object header, under a checksum."""
        sb = h5v2.verify(self, os.pread(self._fd, 48, self._base), "superblock", self._base)
        if sb[9] != 8 or sb[10] != 8:
            raise NotImplementedError(f"HDF5 offsets of {sb[9]} and lengths of {sb[10]} bytes "
                                      "(only 8 are read)")
        self._base, ext, eof, self._root_addr = struct.unpack_from("<4Q", sb, 12)
        if ext != UNDEF:
            raise NotImplementedError(f"HDF5 superblock extension at {ext} (file space "
                                      "strategy or other settings stored with the file)")
        self._check_eof(eof)
        return self._object(self._root_addr, "/")

    def _check_eof(self, eof: int):
        if eof > self._size:  # an absolute address, as HDF5 checks it
            raise ValueError(f"{self.path}: truncated (end of file {eof}, size {self._size})")

    # -- objects ---------------------------------------------------------------

    def _messages(self, addr: int) -> List[Tuple[int, int, bytes]]:
        """(type, flags, data) of every message of the object header at
        `addr`, continuation blocks included (continuation and null messages
        left out)."""
        return [(t, f, d) for t, f, _, d in self._header(addr).msgs]

    def _header(self, addr: int) -> "_Header":
        prefix = self._read(addr, 16)
        if prefix[:4] == b"OHDR":
            return self._header_v2(addr)
        version, _, n_msgs, refcount, size = struct.unpack_from("<BBHII", prefix)
        if version != 1:
            raise NotImplementedError(f"HDF5 object header version {version}")
        blocks, msgs, seen = [(addr + 16, size)], [], 0
        while blocks and seen < n_msgs:
            start, length = blocks.pop(0)
            buf, pos = self._read(start, length), 0
            while pos + 8 <= length and seen < n_msgs:
                mtype, msize, mflags = struct.unpack_from("<HHB", buf, pos)
                data = buf[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                seen += 1
                if mtype == _CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", data))
                elif mtype:
                    msgs.append((mtype, mflags, 0, data))
        return _Header(1, 0, b"", refcount, msgs)

    def _header_v2(self, addr: int) -> "_Header":
        """A version-2 object header ("OHDR", then "OCHK" continuation
        blocks), each block under its checksum."""
        head = self._read(addr, 6)
        version, flags = head[4], head[5]
        if version != 2:
            raise NotImplementedError(f"HDF5 object header version {version} (OHDR)")
        # times (4 x 4 bytes) and phase-change values (2 x 2), then chunk 0's
        # size in 1, 2, 4 or 8 bytes
        pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        size = int.from_bytes(self._read(addr + pos, width), "little")
        chunk0 = h5v2.read_verified(self, addr, pos + width + size + 4, "object header", b"OHDR")
        prefix = chunk0[6:pos]
        mhead = 6 if flags & 0x04 else 4  # creation order in each message header
        blocks, msgs = [(chunk0, pos + width)], []
        while blocks:
            buf, at = blocks.pop(0)
            end = len(buf) - 4
            while at + mhead <= end:  # fewer bytes than a message header: a gap
                mtype, msize, mflags = struct.unpack_from("<BHB", buf, at)
                corder = struct.unpack_from("<H", buf, at + 4)[0] if mhead == 6 else 0
                data = buf[at + mhead:at + mhead + msize]
                at += mhead + msize
                if mtype == _CONTINUATION:
                    caddr, clen = struct.unpack_from("<QQ", data)
                    blocks.append((h5v2.read_verified(
                        self, caddr, clen, "object header continuation block", b"OCHK"), 4))
                elif mtype:
                    msgs.append((mtype, mflags, corder, data))
        return _Header(2, flags, prefix, 1, msgs)

    def _object(self, addr: int, name: str):
        obj = self._objects.get(addr)
        if obj is None:
            msgs = self._messages(addr)
            types = {t for t, _, _ in msgs}
            if types & {_STAB, _LINKINFO, _LINK}:
                obj = Group(self, name, msgs)
            elif _LAYOUT in types:
                obj = Dataset(self, name, msgs)
            else:
                raise NotImplementedError(f"HDF5 object of another kind at {name} "
                                          "(a committed datatype?)")
            self._objects[addr] = obj
        return obj

    def _attrs(self, msgs) -> Dict[str, object]:
        """The attributes of an object: its attribute messages (compact
        storage, in the header's order), then those in dense storage (a
        fractal heap indexed by v2 B-trees of names, type 8, and where it is
        kept of creation order, type 9: in that order, else by name)."""
        return {name: self._attribute(d)[1]
                for name, _, d in self._raw_attrs([(t, f, 0, d) for t, f, d in msgs])}

    def _raw_attrs(self, msgs) -> List[Tuple[str, int, bytes]]:
        """(name, creation order, attribute message) of every attribute of
        the header messages `msgs` (type, flags, creation order, data), in
        the order `_attrs` gives them."""
        out = []
        for mtype, _, corder, d in msgs:
            if mtype == _ATTRIBUTE:
                out.append((_attr_parts(d)[0], corder, d))
            elif mtype == _ATTRINFO:
                out.extend(self._dense_attrs(d))
        return out

    def _dense_attrs(self, d: bytes) -> List[Tuple[str, int, bytes]]:
        if d[0] != 0:
            raise NotImplementedError(f"HDF5 attribute info message version {d[0]}")
        pos = 2 + (2 if d[1] & 1 else 0)
        heap_addr, name_tree = struct.unpack_from("<QQ", d, pos)
        if heap_addr == UNDEF:
            return []
        order_tree = struct.unpack_from("<Q", d, pos + 16)[0] if d[1] & 2 else UNDEF
        tree = h5v2.BTree2(self, order_tree if order_tree != UNDEF else name_tree)
        if tree.type not in (8, 9):
            raise ValueError(f"{self.path}: attribute index of record type {tree.type}")
        heap, found = h5v2.FractalHeap(self, heap_addr), []
        for rec in tree.records():  # heap ID (8), message flags, creation order (4), ...
            if rec[8] & 2:
                raise NotImplementedError("HDF5 shared attribute messages (a shared object "
                                          "header message table)")
            data = heap.get(rec[:8])
            found.append((_attr_parts(data)[0], struct.unpack_from("<I", rec, 9)[0], data))
        if tree.type == 8:
            found.sort(key=lambda item: item[0].encode("utf-8"))
        return found

    def _attribute(self, d: bytes) -> Tuple[str, object]:
        """(name, value) of an attribute message."""
        name, tdata, sdata, raw = _attr_parts(d)
        return name, self._value(_parse_type(tdata), _parse_space(sdata), raw)

    def _value(self, typ: _Type, shape, raw: bytes):
        """An attribute's value as h5py returns it."""
        if shape is None:
            return None
        n = int(np.prod(shape, dtype=np.int64))
        if typ.kind == "vstr":
            vals = [self._vlen_string(raw[i * 16:(i + 1) * 16], typ.utf8) for i in range(n)]
            if shape == ():
                return vals[0]
            return np.array(vals, dtype=object).reshape(shape)
        arr = np.frombuffer(raw[:n * typ.size], dtype=typ.dtype).reshape(shape)
        return arr[()] if shape == () else arr.copy()

    def _vlen_string(self, ref: bytes, utf8: bool) -> str:
        length, heap, index = struct.unpack("<IQI", ref)
        if heap in (0, UNDEF) or length == 0:
            return ""
        data = self._global_heap(heap)[index][:length]
        return data.decode("utf-8" if utf8 else "ascii")

    def _global_heap(self, addr: int) -> Dict[int, bytes]:
        objs = self._gheaps.get(addr)
        if objs is None:
            head = self._read(addr, 16)
            if head[:4] != b"GCOL":
                raise ValueError(f"{self.path}: no global heap at {addr}")
            (size,) = struct.unpack_from("<Q", head, 8)
            buf, pos, objs = self._read(addr, size), 16, {}
            while pos + 16 <= size:
                index, _, osize = struct.unpack_from("<HH4xQ", buf, pos)
                if index == 0:  # free space ends the collection
                    break
                objs[index] = buf[pos + 16:pos + 16 + osize]
                pos += 16 + _pad8(osize)
            self._gheaps[addr] = objs
        return objs

    def _btree_leaves(self, addr: int, node_type: int, key_size: int
                      ) -> Iterator[Tuple[bytes, bytes, int]]:
        """(left key, right key, child) of every level-0 entry of the v1
        B-tree at `addr`, in order."""
        stack, seen = [addr], 0
        while stack:
            node = stack.pop()
            seen += 1
            if seen > self._size // 24:
                raise ValueError(f"{self.path}: B-tree at {addr} does not end")
            head = self._read(node, 24)
            if head[:4] != b"TREE" or head[4] != node_type:
                raise ValueError(f"{self.path}: no type-{node_type} B-tree node at {node}")
            level, n = head[5], struct.unpack_from("<H", head, 6)[0]
            body = self._read(node + 24, n * (key_size + 8) + key_size)
            step = key_size + 8
            entries = [(body[i * step:i * step + key_size],
                        body[(i + 1) * step:(i + 1) * step + key_size],
                        struct.unpack_from("<Q", body, i * step + key_size)[0])
                       for i in range(n)]
            if level > 0:
                stack.extend(child for _, _, child in reversed(entries))
            else:
                yield from entries

    def _local_heap(self, addr: int) -> bytes:
        head = self._read(addr, 32)
        if head[:4] != b"HEAP" or head[4] != 0:
            raise ValueError(f"{self.path}: no local heap at {addr}")
        size, _, data = struct.unpack_from("<QQQ", head, 8)
        return self._read(data, size)

    # -- the h5py-like surface ----------------------------------------------------

    @property
    def attrs(self) -> Dict[str, object]:
        return self._root.attrs

    def __getitem__(self, path: str):
        return self._root[path]

    def __contains__(self, path: str) -> bool:
        return path in self._root

    def close(self):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Group:
    def __init__(self, file: H5File, name: str, msgs):
        self.file, self.name = file, name
        self._msgs = msgs
        self.attrs = file._attrs(msgs)
        self._links: Optional[Dict[str, Tuple[int, Optional[str]]]] = None

    def _entries(self) -> Dict[str, Tuple[int, Optional[str]]]:
        """name -> (object header address, None) for a hard link, or (UNDEF,
        what the link is) for one the reader does not follow; in h5py's
        order."""
        if self._links is None:
            stab = [d for t, _, d in self._msgs if t == _STAB]
            self._links = self._stab_entries(*struct.unpack_from("<QQ", stab[0])) if stab \
                else self._link_entries()
        return self._links

    def _stab_entries(self, btree: int, heap_addr: int) -> Dict[str, Tuple[int, Optional[str]]]:
        """A symbol-table group's members, sorted by name (the B-tree's order)."""
        return {name: (UNDEF, "soft links") if cache == 2 else (header, None)
                for name, header, cache, _ in _stab_members(self.file, btree, heap_addr)}

    def _link_entries(self) -> Dict[str, Tuple[int, Optional[str]]]:
        """A group of link messages: compact (in its header) or dense (a
        fractal heap indexed by a v2 B-tree of names, type 5, or of creation
        order, type 6). h5py lists them in creation order where the group
        tracks it, else by name."""
        return {name: entry for name, _, _, entry in _link_members(self.file, self._msgs)[2]}

    def keys(self) -> List[str]:
        return list(self._entries())

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __getitem__(self, path: str):
        obj = self
        for part in (p for p in path.split("/") if p):
            if not isinstance(obj, Group):
                raise KeyError(path)
            entry = obj._entries().get(part)
            if entry is None:
                raise KeyError(path)
            if entry[1] is not None:
                raise NotImplementedError(f"HDF5 {entry[1]} ({path})")
            obj = self.file._object(entry[0], f"{obj.name.rstrip('/')}/{part}")
        return obj


def _stab_members(file: H5File, btree: int, heap_addr: int
                  ) -> List[Tuple[str, int, int, bytes]]:
    """(name, object header, cache type, scratch pad) of every entry of a
    symbol table, in name order."""
    heap, members = file._local_heap(heap_addr), []
    for _, _, snod in file._btree_leaves(btree, 0, 8):
        head = file._read(snod, 8)
        if head[:4] != b"SNOD":
            raise ValueError(f"{file.path}: no symbol table node at {snod}")
        n = struct.unpack_from("<H", head, 6)[0]
        body = file._read(snod + 8, n * _ENTRY_SIZE)
        for i in range(n):
            off, header, cache = struct.unpack_from("<QQI", body, i * _ENTRY_SIZE)
            name = heap[off:heap.index(b"\0", off)].decode("utf-8")
            members.append((name, header, cache, body[i * _ENTRY_SIZE + 24:(i + 1) * _ENTRY_SIZE]))
    return members


def _link_members(file: H5File, msgs) -> Tuple[int, int, List[Tuple[str, int, bytes, tuple]]]:
    """(Link Info flags: creation order tracked 1, indexed 2; the next
    creation order; [(name, creation order, link message, (address, None)
    or (UNDEF, what the link is))] in h5py's order) of a group of link
    messages, compact or dense."""
    info = next((d for t, _, d in msgs if t == _LINKINFO), None)
    links = [(d,) + _parse_link(d) for t, _, d in msgs if t == _LINK]
    flags = next_order = 0
    if info is not None:
        if info[0] != 0:
            raise NotImplementedError(f"HDF5 link info message version {info[0]}")
        flags = info[1] & 3
        if flags & 1:
            (next_order,) = struct.unpack_from("<q", info, 2)
        pos = 2 + (8 if flags & 1 else 0)
        heap_addr, name_tree = struct.unpack_from("<QQ", info, pos)
        order_tree = struct.unpack_from("<Q", info, pos + 16)[0] if flags & 2 else UNDEF
        if heap_addr != UNDEF:
            tree = h5v2.BTree2(file, order_tree if order_tree != UNDEF else name_tree)
            if tree.type not in (5, 6):
                raise ValueError(f"{file.path}: link index of record type {tree.type}")
            heap = h5v2.FractalHeap(file, heap_addr)
            # a name's hash (4) or a creation order (8), then the heap ID
            skip = 4 if tree.type == 5 else 8
            for rec in tree.records():
                d = heap.get(rec[skip:skip + heap.id_len])
                links.append((d,) + _parse_link(d))
    if flags & 1:
        links.sort(key=lambda link: link[2])
    else:
        links.sort(key=lambda link: link[1].encode("utf-8"))
    return flags, next_order, [(name, order, d, entry) for d, name, order, entry in links]


def _parse_link(d: bytes) -> Tuple[str, int, Tuple[int, Optional[str]]]:
    """(name, creation order, (address, None) or (UNDEF, what it is)) of a
    link message."""
    if d[0] != 1:
        raise NotImplementedError(f"HDF5 link message version {d[0]}")
    flags, pos, kind, order = d[1], 2, 0, 0
    if flags & 0x08:
        kind, pos = d[pos], pos + 1
    if flags & 0x04:
        (order,) = struct.unpack_from("<Q", d, pos)
        pos += 8
    if flags & 0x10:
        pos += 1  # the name's character set: ASCII or UTF-8, both read as UTF-8
    width = 1 << (flags & 3)
    nlen = int.from_bytes(d[pos:pos + width], "little")
    pos += width
    name = d[pos:pos + nlen].decode("utf-8")
    if kind == 0:
        return name, order, (struct.unpack_from("<Q", d, pos + nlen)[0], None)
    what = {1: "soft links", 64: "external links"}.get(kind, f"user-defined links (type {kind})")
    return name, order, (UNDEF, what)


# chunk index types of a version-4 data layout message
_INDEX_NAMES = {1: "single chunk", 2: "implicit", 3: "fixed array", 4: "extensible array",
                5: "v2 B-tree"}


class Dataset:
    def __init__(self, file: H5File, name: str, msgs):
        self.file, self.name = file, name
        self._msgs = msgs
        self.attrs = file._attrs(msgs)
        by_type = {t: d for t, _, d in msgs}
        if _EXTERNAL in by_type:
            raise NotImplementedError(f"HDF5 external data files ({name})")
        if any(t == _DATATYPE and f & 2 for t, f, _ in msgs):
            raise NotImplementedError(f"HDF5 shared (committed) datatypes ({name})")
        self._type = _parse_type(by_type[_DATATYPE])
        if self._type.kind == "vstr":
            raise NotImplementedError(f"HDF5 datasets of variable-length strings ({name})")
        shape, self._maxshape = _parse_space_max(by_type[_DATASPACE])
        self.shape = shape if shape is not None else (0,)
        self.dtype = self._type.dtype
        self._fill = _parse_fill(by_type.get(_FILL), by_type.get(_OLD_FILL), self.dtype)
        self._filters = _parse_pipeline(by_type[_PIPELINE]) if _PIPELINE in by_type else []
        self._layout(by_type[_LAYOUT])
        self._index: Optional[Dict[Tuple[int, ...], Tuple[int, int, int]]] = None

    def _layout(self, d: bytes):
        version, cls = d[0], d[1]
        if version not in (3, 4):
            raise NotImplementedError(f"HDF5 data layout message version {version} ({self.name})")
        self.chunks = None
        if cls == 0:
            (size,) = struct.unpack_from("<H", d, 2)
            self._compact = d[4:4 + size]
        elif cls == 1:
            self._addr, self._nbytes = struct.unpack_from("<QQ", d, 2)
        elif cls == 2 and version == 3:
            ndims = d[2]
            (self._index_addr,) = struct.unpack_from("<Q", d, 3)
            dims = struct.unpack_from(f"<{ndims}I", d, 11)
            self.chunks = tuple(dims[:-1])
            self._index_type = 0  # a v1 B-tree
        elif cls == 2:
            self._layout_v4(d)
        else:
            raise NotImplementedError(f"HDF5 virtual datasets ({self.name})")
        self._class = cls

    def _layout_v4(self, d: bytes):
        """A chunked layout of version 4: its chunk dimensions, the chunk
        index's type and parameters, and the index's address."""
        flags, ndims, width = d[2], d[3], d[4]
        if flags & 1:
            raise NotImplementedError(f"HDF5 partial edge chunks stored unfiltered ({self.name})")
        dims = [int.from_bytes(d[5 + i * width:5 + (i + 1) * width], "little")
                for i in range(ndims)]
        self.chunks = tuple(dims[:-1])
        pos = 5 + ndims * width
        self._index_type = d[pos]
        pos += 1
        self._single = None
        if self._index_type == 1:
            if flags & 2:  # a filtered single chunk: its stored size and filter mask
                self._single = struct.unpack_from("<QI", d, pos)
                pos += 12
        elif self._index_type == 3:
            pos += 1  # page bits, which the array's header holds too
        elif self._index_type == 4:
            pos += 5  # the extensible array's parameters, which its header holds too
        elif self._index_type == 5:
            pos += 6  # node size, split and merge percentages, in the B-tree's header too
        elif self._index_type != 2:
            raise NotImplementedError(f"HDF5 chunk index type {self._index_type} ({self.name})")
        (self._index_addr,) = struct.unpack_from("<Q", d, pos)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def __getitem__(self, key) -> np.ndarray:
        box, steps, squeeze = _selection(key, self.shape)
        out = np.zeros(tuple(b - a for a, b in box), self.dtype)
        if self._fill is not None:
            out[...] = self._fill
        if out.size:
            if self._class == 2:
                self._read_chunks(box, out)
            elif self._class == 1:
                if self._addr != UNDEF:
                    out[...] = np.memmap(self.file.path, self.dtype, "r",
                                         self.file._base + self._addr,
                                         self.shape)[tuple(slice(a, b) for a, b in box)]
            else:
                out[...] = np.frombuffer(self._compact[:self.size * self.dtype.itemsize],
                                         self.dtype).reshape(self.shape)[
                    tuple(slice(a, b) for a, b in box)]
        if any(s != 1 for s in steps):
            out = out[tuple(slice(None, None, s) for s in steps)]
        out = out.reshape([n for n, sq in zip(out.shape, squeeze) if not sq])
        # ds[()] of a scalar dataset is a numpy scalar, ds[...] an array, as in h5py
        return out[()] if isinstance(key, tuple) and not key and not self.shape else out

    # -- chunked storage --------------------------------------------------------

    def _chunk_index(self) -> Dict[Tuple[int, ...], Tuple[int, int, int]]:
        """Chunk offset -> (address, stored bytes, filter mask), for the
        chunks that were written."""
        if self._index is None:
            rank, addr = len(self.shape), self._index_addr
            nbytes = int(np.prod(self.chunks)) * self.dtype.itemsize
            index = {}
            if addr == UNDEF:
                pass
            elif self._index_type == 0:
                for key, _, child in self.file._btree_leaves(addr, 1, 8 + 8 * (rank + 1)):
                    size, mask = struct.unpack_from("<II", key)
                    index[struct.unpack_from(f"<{rank}Q", key, 8)] = (child, size, mask)
            elif self._index_type == 1:
                size, mask = self._single if self._single is not None else (nbytes, 0)
                index[(0,) * rank] = (addr, size, mask)
            elif self._index_type == 2:  # every chunk in place, in the grid's order
                grid = int(np.prod(self._grid()[0], dtype=np.int64))
                for i, origin in self._grid_order(range(grid)):
                    index[origin] = (addr + i * nbytes, nbytes, 0)
            elif self._index_type in (3, 4):
                read = h5v2.fixed_array if self._index_type == 3 else h5v2.extensible_array
                elements = dict(read(self.file, addr))
                for i, origin in self._grid_order(elements):
                    entry = _chunk_entry(elements[i], nbytes)
                    if entry is not None:
                        index[origin] = entry
            else:
                tree = h5v2.BTree2(self.file, addr)
                if tree.type not in (10, 11):
                    raise ValueError(f"{self.file.path}: chunk index of record type {tree.type} "
                                     f"({self.name})")
                for rec in tree.records():
                    scaled = struct.unpack_from(f"<{rank}Q", rec, len(rec) - 8 * rank)
                    entry = _chunk_entry(rec[:len(rec) - 8 * rank], nbytes)
                    if entry is not None:
                        index[tuple(s * c for s, c in zip(scaled, self.chunks))] = entry
            self._index = {o: e for o, e in index.items()
                           if all(a < n for a, n in zip(o, self.shape))}
        return self._index

    def _grid(self) -> Tuple[List[int], int]:
        """(chunks in each dimension of the array indexes' grid, the one
        unlimited dimension or 0): over the maximum dimensions, the unlimited
        one moved first (an extensible array's order)."""
        counts = [-(-(n if m == UNDEF else m) // c)
                  for n, m, c in zip(self.shape, self._maxshape, self.chunks)]
        unlimited = [i for i, m in enumerate(self._maxshape) if m == UNDEF]
        if len(unlimited) > 1:
            raise ValueError(f"{self.file.path}: an array chunk index over "
                             f"{len(unlimited)} unlimited dimensions ({self.name})")
        u = unlimited[0] if unlimited else 0
        return [counts[u]] + counts[:u] + counts[u + 1:], u

    def _grid_order(self, indexes) -> Iterator[Tuple[int, Tuple[int, ...]]]:
        """(i, the offset of the chunk of linear index i) for each i."""
        grid, u = self._grid()
        if not all(grid[1:]):
            return
        for i in indexes:
            rest, scaled = i, []
            for n in reversed(grid[1:]):
                scaled.append(rest % n)
                rest //= n
            scaled = [rest] + scaled[::-1]  # the first dimension is not bounded
            scaled = scaled[1:u + 1] + scaled[:1] + scaled[u + 1:]
            yield i, tuple(s * c for s, c in zip(scaled, self.chunks))

    def _decode_chunk(self, addr: int, nbytes: int, mask: int) -> np.ndarray:
        buf = self.file._read(addr, nbytes)
        for i in reversed(range(len(self._filters))):
            if mask >> i & 1:
                continue
            fid = self._filters[i]
            if fid == 1:
                buf = zlib.decompress(buf)
            else:  # shuffle: byte planes back to elements
                es = self.dtype.itemsize
                n = len(buf) // es
                planes = np.frombuffer(buf, np.uint8, n * es).reshape(es, n)
                buf = planes.T.tobytes() + buf[n * es:]
        want = int(np.prod(self.chunks)) * self.dtype.itemsize
        if len(buf) != want:
            raise ValueError(f"{self.file.path}: chunk of {len(buf)} bytes in {self.name}, "
                             f"want {want}")
        return np.frombuffer(buf, self.dtype).reshape(self.chunks)

    def _read_chunks(self, box, out: np.ndarray):
        index = self._chunk_index()
        ranges = [range(a // c * c, b, c) for (a, b), c in zip(box, self.chunks)]
        for origin in itertools.product(*ranges):
            entry = index.get(origin)
            if entry is None:
                continue  # never written: the fill value
            chunk = self._decode_chunk(*entry)
            src, dst = [], []
            for o, c, (a, b) in zip(origin, self.chunks, box):
                lo, hi = max(a, o), min(b, o + c)
                src.append(slice(lo - o, hi - o))
                dst.append(slice(lo - a, hi - a))
            out[tuple(dst)] = chunk[tuple(src)]


def _chunk_entry(element: bytes, nbytes: int) -> Optional[Tuple[int, int, int]]:
    """(address, stored bytes, filter mask) of a chunk index's element: an
    address, and for filtered chunks their stored size and filter mask; None
    where the chunk was never written."""
    (addr,) = struct.unpack_from("<Q", element)
    if addr == UNDEF:
        return None
    if len(element) == 8:
        return addr, nbytes, 0
    return addr, int.from_bytes(element[8:-4], "little"), struct.unpack_from("<I", element,
                                                                             len(element) - 4)[0]


def _parse_fill(new: Optional[bytes], old: Optional[bytes], dtype: np.dtype):
    """The fill value of unwritten data (fill value message version 1, 2 or
    3, else the old fill value message) as a numpy scalar, or None for
    zeros."""
    raw = b""
    if new is not None:
        version = new[0]
        if version == 1 or (version == 2 and new[3]):
            (size,) = struct.unpack_from("<I", new, 4)
            raw = new[8:8 + size]
        elif version == 3:
            if new[1] & 0x20:
                (size,) = struct.unpack_from("<I", new, 2)
                raw = new[6:6 + size]
        elif version != 2:
            raise NotImplementedError(f"HDF5 fill value message version {version}")
    elif old is not None:
        (size,) = struct.unpack_from("<I", old)
        raw = old[4:4 + size]
    if not raw.strip(b"\0"):
        return None
    if len(raw) != dtype.itemsize:
        raise NotImplementedError(f"HDF5 fill value of {len(raw)} bytes for {dtype}")
    return np.frombuffer(raw, dtype)[0]


def _parse_pipeline(d: bytes) -> List[int]:
    """The filter ids of a filter pipeline message, in the order they were
    applied; raises on a filter the reader cannot undo."""
    version, n = d[0], d[1]
    if version not in (1, 2):
        raise NotImplementedError(f"HDF5 filter pipeline message version {version}")
    pos, out = (8 if version == 1 else 2), []
    for _ in range(n):
        (fid,) = struct.unpack_from("<H", d, pos)
        pos += 2
        nlen = 0
        if version == 1 or fid >= 256:
            (nlen,) = struct.unpack_from("<H", d, pos)
            pos += 2
        _, nvals = struct.unpack_from("<HH", d, pos)
        pos += 4 + (_pad8(nlen) if version == 1 else nlen) + 4 * nvals
        if version == 1 and nvals % 2:
            pos += 4
        if fid not in (1, 2):
            raise NotImplementedError(f"HDF5 filter {_FILTER_NAMES.get(fid, fid)}")
        out.append(fid)
    return out


def _selection(key, shape) -> Tuple[List[Tuple[int, int]], List[int], List[bool]]:
    """Basic indexing of `shape` -> (the bounding box [start, stop) in each
    dimension, the step in each, which dimensions an integer removes)."""
    key = key if isinstance(key, tuple) else (key,)
    if sum(k is Ellipsis for k in key) > 1:
        raise IndexError("only one Ellipsis")
    if Ellipsis in key:
        i = key.index(Ellipsis)
        key = key[:i] + (slice(None),) * (len(shape) - len(key) + 1) + key[i + 1:]
    if len(key) > len(shape):
        raise IndexError(f"{len(key)} indices for {len(shape)} dimensions")
    key = key + (slice(None),) * (len(shape) - len(key))
    box, steps, squeeze = [], [], []
    for k, n in zip(key, shape):
        if isinstance(k, (int, np.integer)):
            i = int(k) + (n if k < 0 else 0)
            if not 0 <= i < n:
                raise IndexError(f"index {k} out of range for {n}")
            box.append((i, i + 1))
            steps.append(1)
            squeeze.append(True)
        elif isinstance(k, slice):
            start, stop, step = k.indices(n)
            if step < 1:
                raise ValueError("steps must be positive")
            box.append((start, max(start, stop)))
            steps.append(step)
            squeeze.append(False)
        else:
            raise TypeError(f"unsupported index {k!r}")
    return box, steps, squeeze


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------


def _type_message(dtype: np.dtype) -> bytes:
    dtype = np.dtype(dtype)
    order = 1 if dtype.str[0] == ">" else 0
    size = dtype.itemsize
    if dtype.kind in "iu":
        bits = order | (8 if dtype.kind == "i" else 0)
        return struct.pack("<BBBBIHH", 0x10, bits, 0, 0, size, 0, 8 * size)
    if dtype.kind == "f" and size in _IEEE:
        sign, e_loc, e_size, m_size, bias = _IEEE[size]
        return struct.pack("<BBBBIHHBBBBI", 0x11, order | 0x20, sign, 0, size, 0, 8 * size,
                           e_loc, e_size, 0, m_size, bias)
    if dtype.kind == "S":
        return struct.pack("<BBBBI", 0x13, 0x01, 0, 0, size)  # null padded, ASCII
    raise NotImplementedError(f"writing {dtype} data")


# a variable-length UTF-8 string, as h5py writes a `str`: class 9 (string,
# null terminated, UTF-8) over a base type of 1-byte unsigned integers
_VSTR_TYPE = struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0, 16) + _type_message(np.dtype("u1"))


def _space_message(shape: Tuple[int, ...]) -> bytes:
    return struct.pack("<BBBB4x", 1, len(shape), 0, 0) + struct.pack(f"<{len(shape)}Q", *shape)


def _attr_message(name: str, tdata: bytes, sdata: bytes, value: bytes) -> bytes:
    nb = name.encode("utf-8") + b"\0"
    return (struct.pack("<BBHHH", 1, 0, len(nb), len(tdata), len(sdata))
            + nb.ljust(_pad8(len(nb)), b"\0") + tdata.ljust(_pad8(len(tdata)), b"\0")
            + sdata.ljust(_pad8(len(sdata)), b"\0") + value)


class _Raw:
    """An attribute message as the file holds it, written back byte for byte
    (its variable-length strings stay in the file's global heap)."""

    def __init__(self, data: bytes):
        self.data = data


class _Old:
    """A member the writer has not opened: its object header's address and
    its symbol-table entry's cache type and scratch pad; for a soft or
    external link in a group of link messages (address UNDEF) that message,
    for a soft link in a symbol table (cache type 2) its value."""

    def __init__(self, addr: int, cache: int = 0, scratch: bytes = bytes(16),
                 link: Optional[bytes] = None):
        self.addr, self.cache, self.scratch, self.link = addr, cache, scratch, link


class _WObject:
    """An object whose header the writer writes: a new one (`addr` None), or
    one of the file's that a call opened, written anew only when `changed`
    (or, for a group, when a member's header moved). `version`, `flags`,
    `prefix` and `refcount` are its header's (`_Header`), `msgs` the
    header's messages but its attributes and their info, as (type, flags,
    creation order, data); `attrs` maps a name to a value or to a `_Raw`
    message, in the order they are written, `order` to its creation order;
    `ainfo` is the (message flags, info flags) of its Attribute Info message
    and `next_order` the next creation order to give; `entry` the (cache
    type, scratch pad) its parent's symbol table held."""

    def __init__(self, version: int, msgs, addr: Optional[int] = None, flags: int = 0,
                 prefix: bytes = b"", refcount: int = 1):
        self.version, self.msgs, self.addr = version, msgs, addr
        self.flags, self.prefix, self.refcount = flags, prefix, refcount
        self.changed = addr is None
        self.attrs: Dict[str, object] = {}
        self.order: Dict[str, int] = {}
        self.ainfo: Optional[Tuple[int, int]] = None
        self.next_order = 0
        self.entry = (0, bytes(16))


class _WGroup(_WObject):
    """A group: `children` maps a name to a member (`_Old`, `_WGroup` or
    `_WObject`). `links`: a group of link messages (else a symbol table);
    `link_flags` its Link Info flags (creation order tracked 1, indexed 2),
    `link_order` each link's creation order and `next_link` the next;
    `ginfo` the (message flags, data) of its Group Info message."""

    def __init__(self, version: int, msgs, links: bool, **kw):
        super().__init__(version, msgs, **kw)
        self.children: Dict[str, object] = {}
        self.links = links
        self.link_flags = self.next_link = 0
        self.link_order: Dict[str, int] = {}
        self.linfo_flags = 0
        self.ginfo: Optional[Tuple[int, bytes]] = None


class H5Writer:
    """Writes an HDF5 file: `require_group(path)`, `set_attr(path, name,
    value)`, `del_attr(path, name)`, `create_dataset(path, data, ...)` (its
    chunks are compressed and written at once), `copy_chunks(path, ds)`,
    `delete(path)`, `path in writer`, then `close()`, which writes the
    groups, attributes and superblock. Attribute values: Python or numpy
    numbers and numeric arrays, `str` (a variable-length UTF-8 string, as
    h5py stores a `str`) and `bytes` (fixed length).

    Mode "w" writes a new file: superblock 0, symbol-table groups, version-1
    object headers. Mode "a" edits an existing file in place, as h5py's
    modes "a" and "r+" do (it creates a missing file as "w" does), for
    superblock 0 and, over `data/h5v2.py`, superblocks 2 and 3; any other
    version raises `NotImplementedError`. Copy-on-write toward the root:
    new chunks and every new or changed object header, local heap, symbol
    table node, B-tree and global heap collection are appended at the old
    end of the file; an object whose header changes gets a new header there,
    and so does every group on its path to the root; untouched members keep
    their addresses, and no byte of an existing chunk is read or written.
    The superblock is written last (its root and end of file), so until then
    the file reads as before; on an exception the file is cut back to its
    old length (a file the writer created is removed). Space a replaced key
    frees is left, as h5py leaves it.

    A changed group is written in its own form: a symbol table again (links
    in name order), or a version-2 header of compact link messages with its
    Link Info (creation order kept where tracked, new links last) and Group
    Info (the largest compact count raised to the number of links); a group
    of link messages of more than 65,535 links, which Group Info cannot
    count, becomes a symbol table. A changed object's header keeps every
    message but its attributes, which are all written compact (continuation
    blocks flattened); its chunk index is not touched. New objects take the
    file's form: version-1 headers and symbol tables under superblock 0,
    version-2 headers and link messages under 2 and 3; new datasets are
    chunked under a v1 B-tree."""

    def __init__(self, path: str, mode: str = "w"):
        if mode not in ("w", "a"):
            raise ValueError(f"mode {mode!r}: 'w' or 'a'")
        self.path, self.mode = path, mode
        self._src: Optional[H5File] = None
        self._base = self._sb_at = 0
        self._group_k = (_GROUP_LEAF_K, _GROUP_INTERNAL_K)
        if mode == "a" and os.path.exists(path):
            self._open_existing()
        else:
            self._old_size = None  # a new file: removed on an exception in mode "a"
            self._sb_version = 0
            self._f = open(path, "wb")
            self._f.write(b"\0" * 96)  # the superblock, written last
            self._root = self._new_group()

    def _open_existing(self):
        src = H5File(self.path)
        try:
            version = src.superblock_version
            if version not in (0, 2, 3):
                raise NotImplementedError(
                    f"HDF5 superblock version {version} (the writer edits files of superblock "
                    "version 0, 2 or 3 in place)")
            self._sb_version, self._base, self._sb_at = version, src._base, src._sb_at
            self._sb = os.pread(src._fd, 96 if version == 0 else 48, src._sb_at)
            root = _Old(src._root_addr)
            if version == 0:
                self._group_k = struct.unpack_from("<HH", self._sb, 16)
                root = _Old(src._root_addr, struct.unpack_from("<I", self._sb, 72)[0],
                            self._sb[80:96])
            self._src = src
            self._root = self._load(root)
            self._f = open(self.path, "r+b")
        except BaseException:
            src.close()
            raise
        self._old_size = self._f.seek(0, os.SEEK_END)

    # -- the file's objects --------------------------------------------------------

    def _new_group(self) -> _WGroup:
        if self._sb_version >= 2:
            return _WGroup(2, [], links=True)
        return _WGroup(1, [], links=False)

    def _new_object(self, msgs, attrs) -> _WObject:
        obj = _WObject(2 if self._sb_version >= 2 else 1, msgs)
        for name, value in (attrs or {}).items():
            self._set(obj, name, value)
        return obj

    def _load(self, old: _Old) -> _WObject:
        """Open a member: its header, attributes and (a group) members."""
        if old.addr == UNDEF or old.cache == 2:
            raise NotImplementedError("HDF5 soft, external or user-defined links (the writer "
                                      "follows hard links only)")
        h = self._src._header(old.addr)
        types = {m[0] for m in h.msgs}
        kw = dict(addr=old.addr, flags=h.flags, prefix=h.prefix, refcount=h.refcount)
        keep = [m for m in h.msgs if m[0] not in (_ATTRIBUTE, _ATTRINFO)]
        if types & {_STAB, _LINKINFO, _LINK}:
            stab = next((d for t, _, _, d in h.msgs if t == _STAB), None)
            node = _WGroup(h.version, [m for m in keep if m[0] not in
                                       (_STAB, _LINKINFO, _GROUPINFO, _LINK)],
                           links=stab is None, **kw)
            if stab is not None:
                btree, heap_addr = struct.unpack_from("<QQ", stab)
                heap = self._src._local_heap(heap_addr)
                for name, addr, cache, scratch in _stab_members(self._src, btree, heap_addr):
                    value = None
                    if cache == 2:  # a soft link: its value's offset in the heap
                        at = struct.unpack_from("<I", scratch)[0]
                        value = heap[at:heap.index(b"\0", at)]
                    node.children[name] = _Old(addr, cache, scratch, value)
            else:
                msgs = [(t, f, d) for t, f, _, d in h.msgs]
                node.link_flags, node.next_link, members = _link_members(self._src, msgs)
                for name, order, data, (addr, what) in members:
                    node.children[name] = _Old(addr, link=data if what else None)
                    node.link_order[name] = order
                node.linfo_flags = next((f for t, f, _, _ in h.msgs if t == _LINKINFO), 0)
                node.ginfo = next(((f, d) for t, f, _, d in h.msgs if t == _GROUPINFO), None)
        elif _LAYOUT in types:
            node = _WObject(h.version, keep, **kw)
        else:
            raise NotImplementedError("HDF5 object of another kind (a committed datatype?) "
                                      f"at {old.addr}")
        for name, order, data in self._src._raw_attrs(h.msgs):
            node.attrs[name] = _Raw(data)
            node.order[name] = order
            node.next_order = max(node.next_order, order + 1)
        ainfo = next(((f, d) for t, f, _, d in h.msgs if t == _ATTRINFO), None)
        if ainfo is not None:
            node.ainfo = (ainfo[0], ainfo[1][1] & 3)
            if ainfo[1][1] & 1:
                node.next_order = max(node.next_order,
                                      struct.unpack_from("<H", ainfo[1], 2)[0])
        node.entry = (old.cache, old.scratch)
        return node

    def _node(self, path: str, create: bool = False) -> _WObject:
        node = self._root
        for part in (p for p in path.split("/") if p):
            if not isinstance(node, _WGroup):
                raise KeyError(path)
            child = node.children.get(part)
            if child is None:
                if not create:
                    raise KeyError(path)
                child = self._add(node, part, self._new_group())
            elif isinstance(child, _Old):
                child = node.children[part] = self._load(child)
            node = child
        return node

    def _add(self, group: _WGroup, name: str, child):
        if name in group.children:
            raise KeyError(f"{name} exists")
        group.children[name] = child
        group.changed = True
        if group.link_flags & 1:
            group.link_order[name] = group.next_link
            group.next_link += 1
        return child

    def _parent(self, path: str) -> Tuple[_WGroup, str]:
        parent, _, name = path.strip("/").rpartition("/")
        group = self._node(parent, create=True)
        if not isinstance(group, _WGroup) or not name:
            raise KeyError(path)
        return group, name

    @staticmethod
    def _set(obj: _WObject, name: str, value):
        obj.attrs.pop(name, None)
        obj.attrs[name] = value
        obj.order[name] = obj.next_order
        obj.next_order += 1
        obj.changed = True

    # -- the h5py-like surface --------------------------------------------------

    def __contains__(self, path: str) -> bool:
        try:
            self._node(path)
        except KeyError:
            return False
        return True

    def require_group(self, path: str):
        if not isinstance(self._node(path, create=True), _WGroup):
            raise TypeError(f"{path} is a dataset")

    def set_attr(self, path: str, name: str, value):
        self._set(self._node(path), name, value)

    def del_attr(self, path: str, name: str):
        obj = self._node(path)
        del obj.attrs[name]
        obj.changed = True

    def delete(self, path: str):
        """Unlink `path` from its group, as h5py's `del group[name]` does."""
        parent, _, name = path.strip("/").rpartition("/")
        group = self._node(parent)
        if not isinstance(group, _WGroup) or name not in group.children:
            raise KeyError(path)
        del group.children[name]
        group.link_order.pop(name, None)
        group.changed = True

    def create_dataset(self, path: str, data: np.ndarray,
                       attrs: Optional[Dict[str, object]] = None):
        """Write `data` at `path` (its parent groups are made) in chunks of
        every leading dimension whole and CHUNK elements of the last, each
        compressed by deflate at level 2, as `prepare_data` stores a clip; a
        scalar (which HDF5 does not chunk) contiguous."""
        data = np.asarray(data)
        group, name = self._parent(path)
        if name in group.children:
            raise KeyError(f"{path} exists")
        if data.ndim == 0:
            layout = struct.pack("<BBQQ", 3, 1, self._append(data.tobytes()), data.nbytes)
            msgs = [(_DATASPACE, 0, 0, _space_message(())),
                    (_DATATYPE, 0, 0, _type_message(data.dtype)),
                    (_FILL, 0, 0, struct.pack("<BBBB", 2, 2, 2, 0)), (_LAYOUT, 0, 0, layout)]
            self._add(group, name, self._new_object(msgs, attrs))
            return
        data = np.ascontiguousarray(data)
        shape = data.shape
        chunks = tuple(max(n, 1) for n in shape[:-1]) + (max(min(shape[-1], CHUNK), 1),)
        stored = []
        for start in range(0, shape[-1], chunks[-1]):
            origin = (0,) * (data.ndim - 1) + (start,)
            block = np.zeros(chunks, data.dtype)
            part = data[..., start:start + chunks[-1]]
            block[..., :part.shape[-1]] = part
            raw = zlib.compress(block.tobytes(), LEVEL)
            stored.append((origin, self._append(raw), len(raw), 0))
        msgs = [(_DATASPACE, 0, 0, _space_message(shape)),
                (_DATATYPE, 0, 0, _type_message(data.dtype)),
                # fill value: allocated incrementally, written if set, none set
                (_FILL, 0, 0, struct.pack("<BBBB", 2, 3, 2, 0)),
                (_LAYOUT, 0, 0, self._chunk_layout(stored, chunks, data.dtype.itemsize)),
                # one filter, deflate (id 1, optional), named as h5py names it
                # (HDF5's copy writes the name into the message's old size),
                # whose one value is the level
                (_PIPELINE, 0, 0, struct.pack("<BB6xHHHH", 1, 1, 1, 8, 1, 1) + b"deflate\0"
                 + struct.pack("<I4x", LEVEL))]
        self._add(group, name, self._new_object(msgs, attrs))

    def copy_chunks(self, path: str, ds: "Dataset"):
        """Copy the chunked dataset `ds` (of another file, under any chunk
        index) to `path`, as h5py's `copy` does: each stored chunk byte for
        byte with its size and filter mask, in the source's chunk shape,
        dataspace, datatype, fill value and filter pipeline, under a v1
        B-tree; its attributes."""
        if ds.chunks is None:
            raise ValueError(f"{ds.name} is not chunked")
        group, name = self._parent(path)
        if name in group.children:
            raise KeyError(f"{path} exists")
        index = ds._chunk_index()
        stored = [(origin, self._append(ds.file._read(addr, size)), size, mask)
                  for origin, (addr, size, mask) in sorted(index.items())]
        msgs = [(t, f, 0, d) for t, f, d in ds._msgs if t in (_DATASPACE, _DATATYPE, _OLD_FILL,
                                                              _FILL)]
        msgs.append((_LAYOUT, 0, 0, self._chunk_layout(stored, ds.chunks, ds.dtype.itemsize)))
        msgs += [(t, f, 0, d) for t, f, d in ds._msgs if t == _PIPELINE]
        self._add(group, name, self._new_object(msgs, ds.attrs))

    def _chunk_layout(self, stored, chunks, es: int) -> bytes:
        """Write the v1 B-tree over `stored` chunks (offset, address, bytes,
        filter mask; in offset order); returns the layout message (version 3,
        chunked) that points to it."""
        rank = len(chunks)
        btree = UNDEF
        if stored:
            keys = [struct.pack("<II", size, mask) + struct.pack(f"<{rank + 1}Q", *origin, 0)
                    for origin, _, size, mask in stored]
            # the right bound of the last chunk: one chunk on in every
            # dimension (the element-size dimension included), as HDF5 does
            last = [o + c for o, c in zip(stored[-1][0], chunks)]
            keys.append(struct.pack("<II", 0, 0) + struct.pack(f"<{rank + 1}Q", *last, es))
            btree = self._btree(1, keys, [addr for _, addr, _, _ in stored], 2 * _CHUNK_K)
        return (struct.pack("<BBBQ", 3, 2, rank + 1, btree)
                + struct.pack(f"<{rank + 1}I", *chunks, es))

    # -- writing -------------------------------------------------------------------

    def _append(self, data: bytes) -> int:
        pos = self._f.tell()
        pad = _pad8(pos) - pos
        if pad:
            self._f.write(b"\0" * pad)
        self._f.write(data)
        return pos + pad - self._base

    def _eof(self) -> int:
        return _pad8(self._f.tell()) - self._base

    def _btree(self, node_type: int, keys: List[bytes], children: List[int], fanout: int) -> int:
        """Write a v1 B-tree over `children` (the level-0 entries) whose
        boundary keys are `keys` (one more than the children); every node is
        written at the full width HDF5 reads. Returns the root's address."""
        key_size = len(keys[0])
        node_size = 24 + fanout * 8 + (fanout + 1) * key_size
        level = 0
        while True:
            spans = [range(i, min(i + fanout, len(children)))
                     for i in range(0, max(len(children), 1), fanout)]
            base = self._eof()
            addrs = [base + j * node_size for j in range(len(spans))]
            for j, span in enumerate(spans):
                left = addrs[j - 1] if j else UNDEF
                right = addrs[j + 1] if j + 1 < len(spans) else UNDEF
                body = b"".join(keys[i] + struct.pack("<Q", children[i]) for i in span)
                node = (b"TREE" + struct.pack("<BBHQQ", node_type, level, len(span), left, right)
                        + body + keys[span.stop])
                self._append(node.ljust(node_size, b"\0"))
            if len(spans) == 1:
                return addrs[0]
            keys = [keys[s.start] for s in spans] + [keys[-1]]
            children, level = addrs, level + 1

    def _symbol_table(self, members: List[Tuple[str, int, int, bytes]]) -> Tuple[int, int]:
        """Write a symbol table's local heap, nodes and B-tree over `members`
        (name, object header, cache type, scratch pad, or for a soft link,
        cache type 2, its value). Returns (B-tree, heap) addresses."""
        members = sorted(members, key=lambda m: m[0].encode("utf-8"))
        # local heap: "" at offset 0, then every name, each padded to 8, and
        # a soft link's value after its name (the entry's scratch pad holds
        # the value's offset)
        heap, offsets = bytearray(8), []
        for i, (name, header, cache, scratch) in enumerate(members):
            offsets.append(len(heap))
            nb = name.encode("utf-8") + b"\0"
            heap += nb.ljust(_pad8(len(nb)), b"\0")
            if cache == 2:
                members[i] = (name, header, cache, struct.pack("<I", len(heap)))
                heap += scratch.ljust(_pad8(len(scratch) + 1), b"\0")
        heap_addr = self._eof()
        self._append(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), 1, heap_addr + 32)
                     + bytes(heap))
        # symbol-table nodes of up to 2K entries, then the B-tree over them
        leaf_k, internal_k = self._group_k
        per_node, snods, keys = 2 * leaf_k, [], [struct.pack("<Q", 0)]
        for i in range(0, len(members), per_node):
            part = members[i:i + per_node]
            body = b"".join(struct.pack("<QQI4x", offsets[i + j], header, cache)
                            + scratch.ljust(16, b"\0")
                            for j, (_, header, cache, scratch) in enumerate(part))
            node = b"SNOD" + struct.pack("<BBH", 1, 0, len(part)) + body
            snods.append(self._append(node.ljust(8 + per_node * _ENTRY_SIZE, b"\0")))
            keys.append(struct.pack("<Q", offsets[i + len(part) - 1]))
        return self._btree(0, keys, snods, 2 * internal_k), heap_addr

    def _write(self, node) -> Tuple[int, int, bytes]:
        """Write a member (and what it holds) where it changed. Returns its
        object header's address and the cache type and scratch pad of a
        symbol-table entry for it."""
        if isinstance(node, _Old):
            return node.addr, node.cache, node.scratch
        if not isinstance(node, _WGroup):
            if not node.changed:
                return (node.addr,) + node.entry
            return self._write_header(node, []), 0, bytes(16)
        written = {name: self._write(child) for name, child in node.children.items()}
        if not node.changed and all(written[name][0] == child.addr
                                    for name, child in node.children.items()):
            return (node.addr,) + node.entry
        if node.links and len(written) <= _MAX_LINK_MESSAGES:
            return self._write_header(node, self._link_messages(node, written)), 0, bytes(16)
        if node.links and any(isinstance(c, _Old) and c.link is not None
                              for c in node.children.values()):
            raise NotImplementedError("HDF5 soft or external links in a group of more than "
                                      "65,535 links (written as a symbol table)")
        btree, heap = self._symbol_table([
            (name, addr, cache, scratch if cache != 2 else node.children[name].link)
            for name, (addr, cache, scratch) in written.items()])
        header = self._write_header(node, [(_STAB, 0, 0, struct.pack("<QQ", btree, heap))])
        return header, 1, struct.pack("<QQ", btree, heap)

    def _link_messages(self, group: _WGroup, written) -> list:
        """The Link Info, Group Info and link messages of a group of link
        messages, its links in creation order where it tracks it."""
        names = list(written)
        tracked = bool(group.link_flags & 1)
        if tracked:
            names.sort(key=lambda n: group.link_order[n])
        links = []
        for name in names:
            child = group.children[name]
            if isinstance(child, _Old) and child.link is not None:
                data = child.link  # a soft or external link, as the file holds it
            else:
                data = h5v2.link_message(name, written[name][0],
                                         group.link_order[name] if tracked else None)
            links.append((_LINK, 0, 0, data))
        ginfo_flags, ginfo = group.ginfo if group.ginfo is not None else (1, None)
        return ([(_LINKINFO, group.linfo_flags, 0, h5v2.link_info(group.link_flags,
                                                                   group.next_link)),
                 (_GROUPINFO, ginfo_flags, 0, h5v2.group_info(ginfo, len(names)))] + links)

    def _write_header(self, obj: _WObject, extra) -> int:
        """Write `obj`'s object header in its version: its messages, `extra`
        (type, flags, creation order, data) and its attributes, all compact.
        Returns its address."""
        attrs = [(_ATTRIBUTE, 0, obj.order.get(name, 0),
                  value.data if isinstance(value, _Raw) else self._attr_data(obj, name, value))
                 for name, value in obj.attrs.items()]
        msgs = obj.msgs + extra
        if obj.version == 1:
            body = []
            for mtype, mflags, _, data in msgs + attrs:
                if len(data) > 0xFFF8:
                    raise NotImplementedError(f"an HDF5 header message of {len(data)} bytes "
                                              f"(type {mtype}): more than a header holds")
                body.append(struct.pack("<HHB3x", mtype, _pad8(len(data)), mflags)
                            + data.ljust(_pad8(len(data)), b"\0"))
            body = b"".join(body)
            return self._append(struct.pack("<BBHII4x", 1, 0, len(msgs) + len(attrs),
                                             obj.refcount, len(body)) + body)
        flags, prefix = obj.flags, obj.prefix
        if obj.ainfo is not None or attrs:
            mflags, iflags = obj.ainfo if obj.ainfo is not None else (4, 0)
            msgs = msgs + [(_ATTRINFO, mflags, 0, h5v2.attribute_info(iflags, obj.next_order))]
            # every attribute in the header: its compact limit raised to their
            # count, so that HDF5 moves them to dense storage when it adds one
            most, least = struct.unpack_from("<HH", prefix, len(prefix) - 4) if flags & 0x10 \
                else (8, 6)
            if len(attrs) > most:
                if len(attrs) > 0xFFFF:
                    raise NotImplementedError(f"{len(attrs)} HDF5 attributes in one header")
                prefix = (prefix[:-4] if flags & 0x10 else prefix) + struct.pack(
                    "<HH", len(attrs), least)
                flags |= 0x10
        return self._append(h5v2.ohdr(flags, prefix, msgs + attrs))

    def _attr_data(self, obj: _WObject, name: str, value) -> bytes:
        """An attribute message for a value set by this writer."""
        if isinstance(value, str):
            ref = struct.pack("<IQI", len(value.encode("utf-8")), self._gheap,
                              self._gindex[id(obj), name])
            return _attr_message(name, _VSTR_TYPE, _space_message(()), ref)
        arr = np.asarray(value)
        if isinstance(value, bool) or arr.dtype.kind not in "iufS":
            raise NotImplementedError(f"writing attribute {name} of {type(value).__name__}")
        if isinstance(value, int):
            arr = arr.astype(np.int64)
        return _attr_message(name, _type_message(arr.dtype), _space_message(arr.shape),
                             arr.tobytes())

    def _string_heap(self):
        """Write one global heap collection of every string attribute this
        writer set (none: no collection)."""
        self._gindex: Dict[Tuple[int, str], int] = {}
        self._gheap = UNDEF
        strings: List[bytes] = []

        def collect(node):
            for name, v in node.attrs.items():
                if isinstance(v, str):
                    strings.append(v.encode("utf-8"))
                    self._gindex[id(node), name] = len(strings)
            for child in getattr(node, "children", {}).values():
                if isinstance(child, _WObject):
                    collect(child)

        collect(self._root)
        if strings:
            objs = b"".join(struct.pack("<HH4xQ", i + 1, 1, len(s)) + s.ljust(_pad8(len(s)), b"\0")
                            for i, s in enumerate(strings))
            size = max(4096, 16 + len(objs) + 16)
            free = size - 16 - len(objs)
            self._gheap = self._append(b"GCOL" + struct.pack("<B3xQ", 1, size) + objs
                                       + struct.pack("<HH4xQ", 0, 0, free).ljust(free, b"\0"))

    def close(self):
        """Write the global heap of the string attributes, every new or
        changed object, and last the superblock; close the file."""
        if self._f is None:
            return
        try:
            self._string_heap()
            root, cache, scratch = self._write(self._root)
            eof = self._f.tell()  # the superblock holds it as an absolute address
            if self._old_size is not None and (eof, root) == (self._old_size, self._root.addr):
                return  # nothing changed
            if self._old_size is None:
                sb = (SIGNATURE + struct.pack("<8BHHI", 0, 0, 0, 0, 0, 8, 8, 0, _GROUP_LEAF_K,
                                              _GROUP_INTERNAL_K, 0)
                      + struct.pack("<4Q", 0, UNDEF, eof, UNDEF))
            elif self._sb_version == 0:
                sb = self._sb[:40] + struct.pack("<Q", eof) + self._sb[48:56]
            else:
                sb = h5v2.superblock(self._sb, eof, root)
            if self._sb_version == 0:
                sb += struct.pack("<QQI4x", 0, root, cache) + scratch
            self._f.seek(self._sb_at)
            self._f.write(sb)
        except BaseException:
            if self.mode == "a":
                self._abort()
            raise
        finally:
            self._close_files()

    def _abort(self):
        """Leave the file as it was: cut back to its old length, or removed
        if this writer created it."""
        if self._f is None:
            return
        if self._old_size is None:
            self._close_files()
            os.remove(self.path)
        else:
            self._f.truncate(self._old_size)
            self._close_files()

    def _close_files(self):
        if self._f is not None:
            self._f.close()
            self._f = None
        if self._src is not None:
            self._src.close()
            self._src = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is not None and self.mode == "a":
            self._abort()
        else:
            self.close()


def copy_group(src: Group, dst: H5Writer, path: str = "", skip=frozenset()):
    """Copy a group's attributes and members (but the paths in `skip`,
    relative to the root and without a leading "/") into the writer at
    `path`: a chunked dataset's chunks byte for byte in its own chunk shape
    (`H5Writer.copy_chunks`, as h5py's `copy` does), a contiguous or compact
    one decoded and written in the writer's chunks; each with its
    attributes."""
    dst.require_group(path)
    for name, value in src.attrs.items():
        dst.set_attr(path, name, value)
    for key in src.keys():
        if f"{path}/{key}".strip("/") in skip:
            continue
        obj = src[key]
        if isinstance(obj, Dataset) and obj.chunks is not None:
            dst.copy_chunks(f"{path}/{key}", obj)
        elif isinstance(obj, Dataset):
            dst.create_dataset(f"{path}/{key}", obj[...], attrs=obj.attrs)
        else:
            copy_group(obj, dst, f"{path}/{key}", skip)
