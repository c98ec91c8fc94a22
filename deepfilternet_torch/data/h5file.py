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
attributes of numbers and strings. h5py reads what it writes.
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
            self._base = self._find_superblock()
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
        _, header = struct.unpack_from("<QQ", sb, pos + 32)
        self._check_eof(eof)
        return self._object(header, "/")

    def _read_superblock_v2(self) -> "Group":
        """Superblock version 2 or 3 (libver "v108" and later): base address,
        extension, end of file and root object header, under a checksum."""
        sb = h5v2.verify(self, os.pread(self._fd, 48, self._base), "superblock", self._base)
        if sb[9] != 8 or sb[10] != 8:
            raise NotImplementedError(f"HDF5 offsets of {sb[9]} and lengths of {sb[10]} bytes "
                                      "(only 8 are read)")
        self._base, ext, eof, root = struct.unpack_from("<4Q", sb, 12)
        if ext != UNDEF:
            raise NotImplementedError(f"HDF5 superblock extension at {ext} (file space "
                                      "strategy or other settings stored with the file)")
        self._check_eof(eof)
        return self._object(root, "/")

    def _check_eof(self, eof: int):
        if eof > self._size:  # an absolute address, as HDF5 checks it
            raise ValueError(f"{self.path}: truncated (end of file {eof}, size {self._size})")

    # -- objects ---------------------------------------------------------------

    def _messages(self, addr: int) -> List[Tuple[int, int, bytes]]:
        """(type, flags, data) of every message of the object header at
        `addr`, continuation blocks included."""
        prefix = self._read(addr, 16)
        if prefix[:4] == b"OHDR":
            return self._messages_v2(addr)
        version, _, n_msgs, _, size = struct.unpack_from("<BBHII", prefix)
        if version != 1:
            raise NotImplementedError(f"HDF5 object header version {version}")
        blocks, msgs = [(addr + 16, size)], []
        while blocks and len(msgs) < n_msgs:
            start, length = blocks.pop(0)
            buf, pos = self._read(start, length), 0
            while pos + 8 <= length and len(msgs) < n_msgs:
                mtype, msize, mflags = struct.unpack_from("<HHB", buf, pos)
                data = buf[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if mtype == _CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", data))
                msgs.append((mtype, mflags, data))
        return msgs

    def _messages_v2(self, addr: int) -> List[Tuple[int, int, bytes]]:
        """The messages of a version-2 object header ("OHDR", then "OCHK"
        continuation blocks), each block under its checksum."""
        head = self._read(addr, 6)
        version, flags = head[4], head[5]
        if version != 2:
            raise NotImplementedError(f"HDF5 object header version {version} (OHDR)")
        # times (4 x 4 bytes) and phase-change values (2 x 2), then chunk 0's
        # size in 1, 2, 4 or 8 bytes
        pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        size = int.from_bytes(self._read(addr + pos, width), "little")
        pos += width
        mhead = 6 if flags & 0x04 else 4  # creation order in each message header
        blocks = [(h5v2.read_verified(self, addr, pos + size + 4, "object header", b"OHDR"),
                   pos)]
        msgs = []
        while blocks:
            buf, at = blocks.pop(0)
            end = len(buf) - 4
            while at + mhead <= end:  # fewer bytes than a message header: a gap
                mtype, msize, mflags = struct.unpack_from("<BHB", buf, at)
                data = buf[at + mhead:at + mhead + msize]
                at += mhead + msize
                if mtype == _CONTINUATION:
                    caddr, clen = struct.unpack_from("<QQ", data)
                    blocks.append((h5v2.read_verified(
                        self, caddr, clen, "object header continuation block", b"OCHK"), 4))
                if mtype:
                    msgs.append((mtype, mflags, data))
        return msgs

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
        out = {}
        for mtype, _, d in msgs:
            if mtype == _ATTRIBUTE:
                name, value = self._attribute(d)
                out[name] = value
            elif mtype == _ATTRINFO:
                out.update(self._dense_attrs(d))
        return out

    def _dense_attrs(self, d: bytes) -> Dict[str, object]:
        if d[0] != 0:
            raise NotImplementedError(f"HDF5 attribute info message version {d[0]}")
        pos = 2 + (2 if d[1] & 1 else 0)
        heap_addr, name_tree = struct.unpack_from("<QQ", d, pos)
        if heap_addr == UNDEF:
            return {}
        order_tree = struct.unpack_from("<Q", d, pos + 16)[0] if d[1] & 2 else UNDEF
        tree = h5v2.BTree2(self, order_tree if order_tree != UNDEF else name_tree)
        if tree.type not in (8, 9):
            raise ValueError(f"{self.path}: attribute index of record type {tree.type}")
        heap, found = h5v2.FractalHeap(self, heap_addr), []
        for rec in tree.records():  # heap ID (8), message flags, creation order (4), ...
            if rec[8] & 2:
                raise NotImplementedError("HDF5 shared attribute messages (a shared object "
                                          "header message table)")
            found.append(self._attribute(heap.get(rec[:8])))
        if tree.type == 8:
            found.sort(key=lambda item: item[0].encode("utf-8"))
        return dict(found)

    def _attribute(self, d: bytes) -> Tuple[str, object]:
        """(name, value) of an attribute message."""
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
                raise NotImplementedError("HDF5 shared datatypes or dataspaces in an "
                                          "attribute")
            nlen, tlen, slen = struct.unpack_from("<HHH", d, 2)
            pos = 8 + (1 if version == 3 else 0)
            name = d[pos:pos + nlen].split(b"\0")[0]
            tdata = d[pos + nlen:pos + nlen + tlen]
            sdata = d[pos + nlen + tlen:pos + nlen + tlen + slen]
            pos += nlen + tlen + slen
        else:
            raise NotImplementedError(f"HDF5 attribute message version {version}")
        typ, shape = _parse_type(tdata), _parse_space(sdata)
        return name.decode("utf-8"), self._value(typ, shape, d[pos:])

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
        heap, links = self.file._local_heap(heap_addr), {}
        for _, _, snod in self.file._btree_leaves(btree, 0, 8):
            head = self.file._read(snod, 8)
            if head[:4] != b"SNOD":
                raise ValueError(f"{self.file.path}: no symbol table node at {snod}")
            n = struct.unpack_from("<H", head, 6)[0]
            body = self.file._read(snod + 8, n * _ENTRY_SIZE)
            for i in range(n):
                off, header, cache = struct.unpack_from("<QQI", body, i * _ENTRY_SIZE)
                name = heap[off:heap.index(b"\0", off)].decode("utf-8")
                links[name] = (UNDEF, "soft links") if cache == 2 else (header, None)
        return links

    def _link_entries(self) -> Dict[str, Tuple[int, Optional[str]]]:
        """A group of link messages: compact (in its header) or dense (a
        fractal heap indexed by a v2 B-tree of names, type 5, or of creation
        order, type 6). h5py lists them in creation order where the group
        tracks it, else by name."""
        info = next((d for t, _, d in self._msgs if t == _LINKINFO), None)
        links = [_parse_link(d) for t, _, d in self._msgs if t == _LINK]
        tracked = False
        if info is not None:
            if info[0] != 0:
                raise NotImplementedError(f"HDF5 link info message version {info[0]}")
            tracked = bool(info[1] & 1)
            pos = 2 + (8 if tracked else 0)
            heap_addr, name_tree = struct.unpack_from("<QQ", info, pos)
            order_tree = struct.unpack_from("<Q", info, pos + 16)[0] if info[1] & 2 else UNDEF
            if heap_addr != UNDEF:
                tree = h5v2.BTree2(self.file, order_tree if order_tree != UNDEF else name_tree)
                if tree.type not in (5, 6):
                    raise ValueError(f"{self.file.path}: link index of record type {tree.type}")
                heap = h5v2.FractalHeap(self.file, heap_addr)
                # a name's hash (4) or a creation order (8), then the heap ID
                skip = 4 if tree.type == 5 else 8
                links += [_parse_link(heap.get(rec[skip:skip + heap.id_len]))
                          for rec in tree.records()]
        if tracked:
            links.sort(key=lambda link: link[1])
        else:
            links.sort(key=lambda link: link[0].encode("utf-8"))
        return {name: entry for name, _, entry in links}

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


def _message(mtype: int, data: bytes) -> bytes:
    return struct.pack("<HHB3x", mtype, _pad8(len(data)), 0) + data.ljust(_pad8(len(data)), b"\0")


def _attr_message(name: str, tdata: bytes, sdata: bytes, value: bytes) -> bytes:
    nb = name.encode("utf-8") + b"\0"
    return (struct.pack("<BBHHH", 1, 0, len(nb), len(tdata), len(sdata))
            + nb.ljust(_pad8(len(nb)), b"\0") + tdata.ljust(_pad8(len(tdata)), b"\0")
            + sdata.ljust(_pad8(len(sdata)), b"\0") + value)


class _WGroup:
    def __init__(self):
        self.children: Dict[str, object] = {}
        self.attrs: Dict[str, object] = {}


class _WDataset:
    def __init__(self, shape, dtype, chunks, btree, attrs):
        self.shape, self.dtype, self.chunks, self.btree = shape, dtype, chunks, btree
        self.attrs = dict(attrs or {})


class H5Writer:
    """Writes a new HDF5 file: `require_group(path)`, `set_attr(path, name,
    value)`, `create_dataset(path, data, ...)` (its chunks are compressed and
    written at once), then `close()`, which writes the groups, attributes and
    superblock. Attribute values: Python or numpy numbers and numeric arrays,
    `str` (a variable-length UTF-8 string, as h5py stores a `str`) and
    `bytes` (fixed length)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self._f.write(b"\0" * 96)  # the superblock, written last
        self._root = _WGroup()

    def _append(self, data: bytes) -> int:
        addr = self._f.tell()
        pad = _pad8(addr) - addr
        if pad:
            self._f.write(b"\0" * pad)
        self._f.write(data)
        return addr + pad

    def _eof(self) -> int:
        return _pad8(self._f.tell())

    def _node(self, path: str, create: bool = False) -> object:
        node = self._root
        for part in (p for p in path.split("/") if p):
            if not isinstance(node, _WGroup):
                raise KeyError(path)
            if part not in node.children:
                if not create:
                    raise KeyError(path)
                node.children[part] = _WGroup()
            node = node.children[part]
        return node

    def require_group(self, path: str):
        if not isinstance(self._node(path, create=True), _WGroup):
            raise TypeError(f"{path} is a dataset")

    def set_attr(self, path: str, name: str, value):
        self._node(path).attrs[name] = value

    def create_dataset(self, path: str, data: np.ndarray,
                       attrs: Optional[Dict[str, object]] = None):
        """Write `data` at `path` (its parent groups are made) in chunks of
        every leading dimension whole and CHUNK elements of the last, each
        compressed by deflate at level 2, as `prepare_data` stores a clip."""
        data = np.ascontiguousarray(data)
        if data.ndim == 0:
            raise ValueError("a chunked dataset needs at least one dimension")
        parent, _, name = path.strip("/").rpartition("/")
        group = self._node(parent, create=True)
        if not isinstance(group, _WGroup) or name in group.children:
            raise KeyError(f"{path} exists")
        shape = data.shape
        chunks = tuple(max(n, 1) for n in shape[:-1]) + (max(min(shape[-1], CHUNK), 1),)
        es, rank = data.dtype.itemsize, data.ndim
        keys, addrs = [], []
        for start in range(0, shape[-1], chunks[-1]):
            origin = (0,) * (rank - 1) + (start,)
            block = np.zeros(chunks, data.dtype)
            part = data[..., start:start + chunks[-1]]
            block[..., :part.shape[-1]] = part
            raw = zlib.compress(block.tobytes(), LEVEL)
            addrs.append(self._append(raw))
            keys.append(struct.pack("<II", len(raw), 0) + struct.pack(f"<{rank}Q", *origin)
                        + struct.pack("<Q", 0))
        btree = UNDEF
        if addrs:
            # the right bound of the last chunk: one chunk on in every
            # dimension (the element-size dimension included), as HDF5 does
            last = [o + c for o, c in zip(origin, chunks)]
            keys.append(struct.pack("<II", 0, 0) + struct.pack(f"<{rank + 1}Q", *last, es))
            btree = self._btree(1, keys, addrs, 2 * _CHUNK_K)
        group.children[name] = _WDataset(shape, data.dtype, chunks, btree, attrs)

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

    def _write_group(self, group: _WGroup, attr_messages) -> Tuple[int, int, int]:
        """Write a group's members, local heap, symbol-table nodes, B-tree
        and object header. Returns (header, B-tree, heap) addresses."""
        entries = []
        for name in sorted(group.children, key=lambda s: s.encode("utf-8")):
            child = group.children[name]
            if isinstance(child, _WGroup):
                header, btree, heap = self._write_group(child, attr_messages)
                entries.append((name, header, 1, struct.pack("<QQ", btree, heap)))
            else:
                entries.append((name, self._write_dataset(child, attr_messages), 0, b""))
        # local heap: "" at offset 0, then every name, each padded to 8
        heap, offsets = bytearray(8), []
        for name, *_ in entries:
            offsets.append(len(heap))
            nb = name.encode("utf-8") + b"\0"
            heap += nb.ljust(_pad8(len(nb)), b"\0")
        heap_addr = self._eof()
        self._append(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), 1, heap_addr + 32)
                     + bytes(heap))
        # symbol-table nodes of up to 2K entries, then the B-tree over them
        per_node, snods, keys = 2 * _GROUP_LEAF_K, [], [struct.pack("<Q", 0)]
        for i in range(0, len(entries), per_node):
            part = entries[i:i + per_node]
            body = b"".join(struct.pack("<QQI4x", offsets[i + j], header, cache)
                            + scratch.ljust(16, b"\0")
                            for j, (_, header, cache, scratch) in enumerate(part))
            node = b"SNOD" + struct.pack("<BBH", 1, 0, len(part)) + body
            snods.append(self._append(node.ljust(8 + per_node * _ENTRY_SIZE, b"\0")))
            keys.append(struct.pack("<Q", offsets[i + len(part) - 1]))
        btree = self._btree(0, keys, snods, 2 * _GROUP_INTERNAL_K)
        header = self._header([_message(_STAB, struct.pack("<QQ", btree, heap_addr))]
                               + attr_messages(group.attrs))
        return header, btree, heap_addr

    def _write_dataset(self, ds: _WDataset, attr_messages) -> int:
        dims = struct.pack(f"<{len(ds.chunks)}I", *ds.chunks) + struct.pack("<I", ds.dtype.itemsize)
        layout = struct.pack("<BBBQ", 3, 2, len(ds.chunks) + 1, ds.btree) + dims
        msgs = [_message(_DATASPACE, _space_message(ds.shape)),
                _message(_DATATYPE, _type_message(ds.dtype)),
                # fill value: allocated incrementally, written if set, none set
                _message(_FILL, struct.pack("<BBBB", 2, 3, 2, 0)),
                _message(_LAYOUT, layout),
                # one filter, deflate (id 1), whose one value is the level
                _message(_PIPELINE, struct.pack("<BB6xHHHHI4x", 1, 1, 1, 0, 0, 1, LEVEL))]
        return self._header(msgs + attr_messages(ds.attrs))

    def _header(self, msgs: List[bytes]) -> int:
        body = b"".join(msgs)
        return self._append(struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body)) + body)

    def close(self):
        """Write the global heap of the string attributes, every group and
        dataset header, and the superblock; close the file."""
        if self._f is None:
            return
        try:
            # every string attribute's global heap index, by (attrs, name)
            index: Dict[Tuple[int, str], int] = {}
            strings: List[bytes] = []

            def collect(node):
                for name, v in node.attrs.items():
                    if isinstance(v, str):
                        strings.append(v.encode("utf-8"))
                        index[id(node.attrs), name] = len(strings)
                for child in getattr(node, "children", {}).values():
                    collect(child)

            collect(self._root)
            heap_addr = UNDEF
            if strings:
                objs = b"".join(struct.pack("<HH4xQ", i + 1, 1, len(s)) + s.ljust(_pad8(len(s)),
                                                                                  b"\0")
                                for i, s in enumerate(strings))
                size = max(4096, 16 + len(objs) + 16)
                free = size - 16 - len(objs)
                heap_addr = self._append(b"GCOL" + struct.pack("<B3xQ", 1, size) + objs
                                         + struct.pack("<HH4xQ", 0, 0, free).ljust(free, b"\0"))

            def attr_messages(attrs) -> List[bytes]:
                out = []
                for name, value in attrs.items():
                    if isinstance(value, str):
                        ref = struct.pack("<IQI", len(value.encode("utf-8")), heap_addr,
                                          index[id(attrs), name])
                        out.append(_message(_ATTRIBUTE, _attr_message(
                            name, _VSTR_TYPE, _space_message(()), ref)))
                        continue
                    arr = np.asarray(value)
                    if isinstance(value, bool) or arr.dtype.kind not in "iufS":
                        raise NotImplementedError(f"writing attribute {name} of "
                                                  f"{type(value).__name__}")
                    if isinstance(value, int):
                        arr = arr.astype(np.int64)
                    out.append(_message(_ATTRIBUTE, _attr_message(
                        name, _type_message(arr.dtype), _space_message(arr.shape),
                        arr.tobytes())))
                return out

            header, btree, heap = self._write_group(self._root, attr_messages)
            eof = self._eof()
            self._f.write(b"\0" * (eof - self._f.tell()))
            sb = (SIGNATURE + struct.pack("<8BHHI", 0, 0, 0, 0, 0, 8, 8, 0, _GROUP_LEAF_K,
                                          _GROUP_INTERNAL_K, 0)
                  + struct.pack("<4Q", 0, UNDEF, eof, UNDEF)
                  + struct.pack("<QQI4xQQ", 0, header, 1, btree, heap))
            self._f.seek(0)
            self._f.write(sb)
        finally:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def copy_group(src: Group, dst: H5Writer, path: str = "", skip=frozenset()):
    """Copy a group's attributes and members (but the paths in `skip`,
    relative to the root and without a leading "/") into the writer at
    `path`: every dataset with its values, type and attributes, rewritten in
    the writer's chunks."""
    dst.require_group(path)
    for name, value in src.attrs.items():
        dst.set_attr(path, name, value)
    for key in src.keys():
        if f"{path}/{key}".strip("/") in skip:
            continue
        obj = src[key]
        if isinstance(obj, Dataset):
            dst.create_dataset(f"{path}/{key}", obj[...], attrs=obj.attrs)
        else:
            copy_group(obj, dst, f"{path}/{key}", skip)
