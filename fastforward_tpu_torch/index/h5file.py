"""The on-disk index's HDF5 file, read and written without h5py.

``OnDiskIndex`` keeps its table in an HDF5 file whose layout is the JAX
package's and the reference's.  That file uses a small, fixed part of
HDF5, the part h5py 3 writes with its default settings, and this module
reads and writes that part with numpy and ``os.pread``/``os.pwrite``:

- superblock version 0 (or 1) with 8-byte offsets and lengths;
- version-1 object headers, followed through continuation messages;
- old-style groups: a symbol-table message, a version-1 B-tree of
  ``TREE`` nodes over ``SNOD`` symbol nodes, the names in a ``HEAP``;
- datasets of one or more axes with a contiguous layout, or a chunked
  one (a version-1 chunk B-tree) whose chunks hold whole rows, and no
  filters;
- little-endian IEEE f32/f64, signed and unsigned integers of 8 to 64
  bits, null-padded byte strings ``S{n}``, h5py's bool enum, and (in
  attributes only) variable-length UTF-8 strings in a ``GCOL`` global heap;
- attribute messages of versions 1 to 3 over scalar or simple dataspaces.

Any other structure raises :class:`UnsupportedHDF5` naming it, so no read
returns wrong data: filters (gzip and the like), superblocks of version 2
or 3 (h5py's ``libver="latest"``), version-2 object headers, new-style
groups (link messages, fractal heaps), compact and virtual layouts,
chunks that split rows, scalar datasets, and other datatypes.

Writes put data in place: a chunk is allocated at the end of the file,
whole and zero-filled, the first time a write touches it, and written
where it lies.  Metadata is copied on write, at ``close``: a structure
that changed (a chunk B-tree that grew; a group's B-tree, symbol nodes
and heap; an object header that outgrew its room) is written afresh at
the end of the file and the one pointer to it patched in place (a layout
or symbol-table message, the parent's symbol-table entry, the
superblock's root entry).  The copies left behind are legal HDF5 that
nothing points to.  A value that keeps its size (an attribute such as
``num_vectors``, a dataspace that grew, a layout's B-tree address) is
patched where it lies.  Files h5py wrote and files this module wrote are
handled alike; no B-tree node is split in place.

Each ``File`` reads through ``os.pread`` on a descriptor of its own, so
threads may read at once, each through a ``File`` of its own.
"""

import os
import struct
from collections.abc import MutableMapping
from itertools import product

import numpy as np

__all__ = ["Dataset", "File", "Group", "UnsupportedHDF5"]

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFF_FFFF_FFFF_FFFF  # the undefined address
_HEAP_FREE_NULL = 1  # a local heap's end of free list
_GCOL_MIN = 4096  # the least size of a global heap collection
_LEAF_K, _GROUP_K, _CHUNK_K = 4, 16, 32  # the B-tree widths of a new file
_HEADER_ROOM = 256  # the least message room of an object header written here

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL = 0x00, 0x01, 0x02, 0x03, 0x05
_LINK, _LAYOUT, _GROUP_INFO, _FILTERS, _ATTRIBUTE = 0x06, 0x08, 0x0A, 0x0B, 0x0C
_CONTINUATION, _STAB, _ATTR_INFO = 0x10, 0x11, 0x15

_REFUSED_MESSAGES = {
    _LINK_INFO: "a new-style group (link info message)",
    _LINK: "a new-style group (link message)",
    _GROUP_INFO: "a new-style group (group info message)",
    _FILTERS: "a filter pipeline (compression or another filter)",
    _ATTR_INFO: "dense attribute storage (attribute info message, fractal heap)",
}
_TYPE_CLASSES = ("integer", "float", "time", "string", "bitfield", "opaque", "compound",
                 "reference", "enum", "variable-length", "array")


class UnsupportedHDF5(ValueError):
    """The file holds a structure outside the part of HDF5 this module
    reads and writes; the message names it."""


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _padded(data: bytes) -> bytes:
    return bytes(data) + bytes(_pad8(len(data)) - len(data))


# -- the file ------------------------------------------------------------------


class _Store:
    """A descriptor with positioned reads and writes, and an allocator at
    the end of the file (the superblock's End of File Address)."""

    def __init__(self, path: str, writable: bool, create: bool) -> None:
        flags = os.O_RDWR if writable else os.O_RDONLY
        if create:
            flags |= os.O_CREAT | os.O_TRUNC
        self.fd = os.open(path, flags | getattr(os, "O_CLOEXEC", 0), 0o644)
        self.eoa = 0

    def size(self) -> int:
        return os.fstat(self.fd).st_size

    def read(self, addr: int, n: int) -> bytes:
        data = os.pread(self.fd, n, addr)
        while len(data) < n:
            more = os.pread(self.fd, n - len(data), addr + len(data))
            if not more:
                raise UnsupportedHDF5(f"truncated file: {n} bytes wanted at {addr}")
            data += more
        return data

    def readinto(self, addr: int, out: np.ndarray) -> None:
        view = memoryview(out).cast("B")
        done = 0
        while done < len(view):
            got = os.preadv(self.fd, [view[done:]], addr + done)
            if got <= 0:
                raise UnsupportedHDF5(f"truncated file: {len(view)} bytes wanted at {addr}")
            done += got

    def write(self, addr: int, data) -> None:
        view = memoryview(data).cast("B")
        done = 0
        while done < len(view):
            done += os.pwritev(self.fd, [view[done:]], addr + done)

    def alloc(self, n: int) -> int:
        addr = _pad8(self.eoa)
        self.eoa = addr + n
        return addr

    def extend(self) -> None:
        """Make the file reach its End of File Address (zeros)."""
        if self.size() < self.eoa:
            os.ftruncate(self.fd, self.eoa)

    def close(self) -> None:
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1


# -- datatypes -----------------------------------------------------------------

_VSTR_ELEMENT = np.dtype([("len", "<u4"), ("addr", "<u8"), ("idx", "<u4")])
_FLOAT_FIELDS = {4: (31, 23, 8, 0, 23, 127), 8: (63, 52, 11, 0, 52, 1023)}


class _Type:
    """A datatype of the subset: ``kind`` is ``"num"`` (integers, floats),
    ``"bytes"`` (``S{n}``), ``"bool"`` (h5py's enum) or ``"vstr"``
    (variable-length UTF-8); ``stored`` is the numpy dtype of an element
    as it lies in the file, ``dtype`` the one a read returns."""

    def __init__(self, kind: str, stored: np.dtype) -> None:
        self.kind = kind
        self.stored = np.dtype(stored)
        self.dtype = {"bool": np.dtype(bool), "vstr": np.dtype(object)}.get(kind, self.stored)

    @classmethod
    def of(cls, dtype) -> "_Type":
        """The type that stores numpy ``dtype``.

        :raises TypeError: For a dtype outside the subset.
        """
        dtype = np.dtype(dtype)
        if dtype == np.dtype(bool):
            return cls("bool", np.dtype(np.int8))
        if dtype.kind in "iu" and dtype.itemsize in (1, 2, 4, 8) or (
            dtype.kind == "f" and dtype.itemsize in (4, 8)
        ):
            return cls("num", dtype.newbyteorder("<"))
        if dtype.kind == "S":
            return cls("bytes", dtype)
        if dtype.kind in "OU":
            return cls("vstr", _VSTR_ELEMENT)
        raise TypeError(f"no HDF5 datatype of this module stores {dtype}")

    def encode(self) -> bytes:
        """The datatype message."""
        if self.kind == "bytes":
            return struct.pack("<BBBBI", 0x13, 0x01, 0, 0, self.stored.itemsize)  # null-padded ASCII
        if self.kind == "bool":
            base = _integer_type(1, signed=True)
            names = _padded(b"FALSE\0") + _padded(b"TRUE\0")
            return struct.pack("<BBBBI", 0x18, 2, 0, 0, 1) + base + names + b"\x00\x01"
        if self.kind == "vstr":  # a string of UTF-8 over unsigned bytes
            return struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0, 16) + _integer_type(1, signed=False)
        if self.stored.kind == "f":
            size = self.stored.itemsize
            sign, exp_loc, exp_size, man_loc, man_size, bias = _FLOAT_FIELDS[size]
            return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, sign, 0, size, 0, 8 * size,
                               exp_loc, exp_size, man_loc, man_size, bias)
        return _integer_type(self.stored.itemsize, self.stored.kind == "i")


def _integer_type(size: int, signed: bool) -> bytes:
    return struct.pack("<BBBBIHH", 0x10, 0x08 if signed else 0, 0, 0, size, 0, 8 * size)


def _decode_type(buf: bytes, pos: int = 0) -> tuple:
    """``(_Type, end)`` of the datatype message at ``buf[pos:]``."""
    cls, version = buf[pos] & 0x0F, buf[pos] >> 4
    bits = buf[pos + 1] | buf[pos + 2] << 8 | buf[pos + 3] << 16
    (size,) = struct.unpack_from("<I", buf, pos + 4)
    p = pos + 8
    if cls == 0:
        offset, precision = struct.unpack_from("<HH", buf, p)
        if bits & 0x01:
            raise UnsupportedHDF5("a big-endian integer datatype")
        if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
            raise UnsupportedHDF5(f"an integer datatype of {precision} bits in {size} bytes")
        return _Type("num", f"<{'i' if bits & 0x08 else 'u'}{size}"), p + 4
    if cls == 1:
        fields = struct.unpack_from("<HHBBBBI", buf, p)
        order = bits & 0x01 | (bits >> 5) & 0x02
        if order or size not in _FLOAT_FIELDS or fields[:2] != (0, 8 * size) or (
            (bits >> 8) & 0xFF,) + fields[2:] != _FLOAT_FIELDS[size]:
            raise UnsupportedHDF5(f"a floating-point datatype other than little-endian "
                                  f"IEEE f32/f64 ({size} bytes)")
        return _Type("num", f"<f{size}"), p + 12
    if cls == 3:
        if bits & 0x0F not in (0, 1):
            raise UnsupportedHDF5("a space-padded string datatype")
        return _Type("bytes", f"S{size}"), p
    if cls == 8:
        base, p = _decode_type(buf, p)
        names = []
        for _ in range(bits & 0xFFFF):
            end = buf.index(b"\0", p)
            names.append(bytes(buf[p:end]))
            p = p + _pad8(end + 1 - p) if version < 3 else end + 1
        count = len(names)
        values = np.frombuffer(buf, base.stored, count, p).tolist()
        p += count * base.stored.itemsize
        if base.stored != np.dtype(np.int8) or dict(zip(names, values)) != {b"FALSE": 0, b"TRUE": 1}:
            raise UnsupportedHDF5(f"an enum datatype other than h5py's bool ({names})")
        return _Type("bool", np.int8), p
    if cls == 9:
        if bits & 0x0F != 1:
            raise UnsupportedHDF5("a variable-length sequence datatype")
        _, p = _decode_type(buf, p)
        return _Type("vstr", _VSTR_ELEMENT), p
    name = _TYPE_CLASSES[cls] if cls < len(_TYPE_CLASSES) else f"class {cls}"
    raise UnsupportedHDF5(f"an {name} datatype")


# -- messages ------------------------------------------------------------------


def _encode_space(shape: tuple, maxshape: "tuple | None" = None) -> bytes:
    """A version-1 dataspace message (scalar for ``shape == ()``)."""
    maxshape = shape if maxshape is None else maxshape
    head = struct.pack("<BBBB4x", 1, len(shape), 1 if shape else 0, 0)
    dims = [int(d) for d in shape] + [_UNDEF if m is None else int(m) for m in maxshape] if shape else []
    return head + struct.pack(f"<{len(dims)}Q", *dims)


def _decode_space(buf: bytes, pos: int = 0) -> tuple:
    """``(shape, maxshape, end)`` of the dataspace message at ``buf[pos:]``."""
    version, rank, flags = buf[pos], buf[pos + 1], buf[pos + 2]
    if version == 1:
        p = pos + 8
    elif version == 2:
        if buf[pos + 3] == 2:
            raise UnsupportedHDF5("a null dataspace")
        p = pos + 4
    else:
        raise UnsupportedHDF5(f"a dataspace message of version {version}")
    shape = struct.unpack_from(f"<{rank}Q", buf, p)
    p += 8 * rank
    maxshape = shape
    if flags & 0x01:
        maxshape = tuple(None if m == _UNDEF else m for m in struct.unpack_from(f"<{rank}Q", buf, p))
        p += 8 * rank
    if flags & 0x02:
        raise UnsupportedHDF5("a dataspace with a permutation index")
    return tuple(shape), tuple(maxshape), p


def _decode_fill(buf: bytes, stored: np.dtype) -> bytes:
    """The fill value's bytes (zeros where none is defined)."""
    version = buf[0]
    value = b""
    if version in (1, 2):
        if version == 1 or buf[3]:
            (size,) = struct.unpack_from("<I", buf, 4)
            value = buf[8 : 8 + size]
    elif version == 3:
        if buf[1] & 0x20:
            (size,) = struct.unpack_from("<I", buf, 2)
            value = buf[6 : 6 + size]
    else:
        raise UnsupportedHDF5(f"a fill value message of version {version}")
    if value and len(value) != stored.itemsize:
        raise UnsupportedHDF5(f"a fill value of {len(value)} bytes for {stored.itemsize}-byte elements")
    return bytes(value) or bytes(stored.itemsize)


class _Message:
    __slots__ = ("mtype", "flags", "data", "pos")

    def __init__(self, mtype: int, data: bytes, flags: int = 0, pos: "int | None" = None) -> None:
        self.mtype, self.flags, self.data, self.pos = mtype, flags, _padded(data), pos


class _Header:
    """A version-1 object header: its messages, its address and the room
    of its first block; ``patched`` messages kept their size and are
    written where they lie, any other change rewrites the header."""

    def __init__(self, messages: list, addr: "int | None" = None, room: int = 0,
                 refcount: int = 1) -> None:
        self.messages, self.addr, self.room, self.refcount = messages, addr, room, refcount
        self.patched: list = []
        self.rebuilt = addr is None

    @classmethod
    def read(cls, store: _Store, addr: int) -> "_Header":
        prefix = store.read(addr, 16)
        if prefix[:4] == b"OHDR":
            raise UnsupportedHDF5(f"a version-2 object header (at {addr})")
        version, _, count, refcount, size = struct.unpack_from("<BBHII", prefix)
        if version != 1:
            raise UnsupportedHDF5(f"an object header of version {version} (at {addr})")
        blocks, messages = [(addr + 16, size)], []
        for start, length in blocks:  # continuation blocks join the list
            raw = store.read(start, length)
            pos = 0
            while pos + 8 <= length:
                mtype, msize, mflags = struct.unpack_from("<HHB", raw, pos)
                body = raw[pos + 8 : pos + 8 + msize]
                if mtype == _CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", body))
                elif mtype != _NIL:
                    if mtype in _REFUSED_MESSAGES:
                        raise UnsupportedHDF5(f"{_REFUSED_MESSAGES[mtype]} (object at {addr})")
                    if mflags & 0x02 and mtype in (_DATASPACE, _DATATYPE, _FILL, _ATTRIBUTE):
                        raise UnsupportedHDF5(f"a shared message of type {mtype} (object at {addr})")
                    messages.append(_Message(mtype, body, mflags, start + pos + 8))
                pos += 8 + msize
        return cls(messages, addr, size, refcount)

    def find(self, mtype: int) -> "_Message | None":
        return next((m for m in self.messages if m.mtype == mtype), None)

    def replace(self, message: _Message, data: bytes) -> None:
        data = _padded(data)
        if len(data) == len(message.data) and message.pos is not None and not self.rebuilt:
            self.patched.append(message)
        else:
            self.rebuilt = True
        message.data = data

    def add(self, message: _Message) -> None:
        self.messages.append(message)
        self.rebuilt = True

    def remove(self, message: _Message) -> None:
        self.messages.remove(message)
        self.rebuilt = True

    def flush(self, store: _Store) -> bool:
        """Write what changed; True when the header moved."""
        if not self.rebuilt:
            for message in self.patched:
                store.write(message.pos, message.data)
            self.patched = []
            return False
        need = sum(8 + len(m.data) for m in self.messages)
        addr, room = self.addr, self.room
        if addr is None or need > room:
            room = max(_HEADER_ROOM, _pad8(need + need // 2))
            addr = store.alloc(16 + room)
        out = bytearray(struct.pack("<BBHII4x", 1, 0, len(self.messages), self.refcount, room))
        for message in self.messages:
            out += struct.pack("<HHB3x", message.mtype, len(message.data), message.flags)
            message.pos = addr + len(out)
            out += message.data
        if need < room:  # a NIL message fills the rest
            out += struct.pack("<HHB3x", _NIL, room - need - 8, 0) + bytes(room - need - 8)
            struct.pack_into("<H", out, 2, len(self.messages) + 1)
        store.write(addr, out)
        moved = addr != self.addr
        self.addr, self.room, self.rebuilt, self.patched = addr, room, False, []
        return moved


# -- B-trees -------------------------------------------------------------------


def _btree_leaves(store: _Store, addr: int, node_type: int, key_size: int) -> list:
    """``[(key bytes, child address)]`` of every leaf entry under the
    version-1 B-tree node at ``addr``, in key order."""
    head = store.read(addr, 24)
    if head[:4] != b"TREE" or head[4] != node_type:
        raise UnsupportedHDF5(f"no version-1 B-tree node of type {node_type} at {addr}")
    level, used = head[5], struct.unpack_from("<H", head, 6)[0]
    raw = store.read(addr + 24, used * (key_size + 8) + key_size)
    out = []
    for i in range(used):
        p = i * (key_size + 8)
        key, (child,) = raw[p : p + key_size], struct.unpack_from("<Q", raw, p + key_size)
        if level:
            out += _btree_leaves(store, child, node_type, key_size)
        else:
            out.append((key, child))
    return out


def _write_btree(store: _Store, node_type: int, two_k: int, items: list, right_key: bytes) -> int:
    """Write a version-1 B-tree over ``items`` (``[(left key, child)]`` in
    order; ``right_key`` bounds the last child) bottom-up, nodes full;
    returns the root's address."""
    key_size = len(right_key)
    node_size = 24 + (two_k + 1) * key_size + two_k * 8
    level = 0
    while True:
        groups = [items[i : i + two_k] for i in range(0, len(items), two_k)] or [[]]
        addrs = [store.alloc(node_size) for _ in groups]
        for j, group in enumerate(groups):
            last = groups[j + 1][0][0] if j + 1 < len(groups) else right_key
            out = bytearray(b"TREE" + struct.pack(
                "<BBHQQ", node_type, level, len(group), addrs[j - 1] if j else _UNDEF,
                addrs[j + 1] if j + 1 < len(groups) else _UNDEF))
            for key, child in group:
                out += key + struct.pack("<Q", child)
            out += (last if group else bytes(key_size))
            store.write(addrs[j], out + bytes(node_size - len(out)))
        if len(groups) == 1:
            return addrs[0]
        items = [(group[0][0], addr) for group, addr in zip(groups, addrs)]
        level += 1


# -- objects -------------------------------------------------------------------


class _Entry:
    """A symbol-table entry: a link to an object header, with the group's
    B-tree and heap cached where ``cache`` is 1."""

    __slots__ = ("addr", "cache", "scratch")

    def __init__(self, addr: int, cache: int = 0, scratch: bytes = bytes(16)) -> None:
        self.addr, self.cache, self.scratch = addr, cache, scratch


class AttributeManager(MutableMapping):
    """An object's attributes, as h5py's ``.attrs``: a scalar reads as a
    numpy scalar (a ``str`` for a variable-length string), an array as an
    ndarray."""

    def __init__(self, obj: "_Object") -> None:
        self._obj = obj

    def _messages(self) -> dict:
        out = {}
        for message in self._obj._header.messages:
            if message.mtype == _ATTRIBUTE:
                out[_attribute_name(message.data)] = message
        return out

    def __getitem__(self, name: str):
        message = self._messages().get(name)
        if message is None:
            raise KeyError(f"no attribute {name!r}")
        return self._obj._file._decode_attribute(message.data)

    def __setitem__(self, name: str, value) -> None:
        data = self._obj._file._encode_attribute(name, value)
        message = self._messages().get(name)
        header = self._obj._header
        if message is None:
            header.add(_Message(_ATTRIBUTE, data))
        else:
            header.replace(message, data)

    def __delitem__(self, name: str) -> None:
        message = self._messages().get(name)
        if message is None:
            raise KeyError(f"no attribute {name!r}")
        self._obj._header.remove(message)

    def __iter__(self):
        return iter(sorted(self._messages()))

    def __len__(self) -> int:
        return len(self._messages())


def _attribute_name(data: bytes) -> str:
    version = data[0]
    (name_size,) = struct.unpack_from("<H", data, 2)
    start = 8 if version == 1 else (8 if version == 2 else 9)
    if version not in (1, 2, 3):
        raise UnsupportedHDF5(f"an attribute message of version {version}")
    return data[start : start + name_size - 1].decode()


class _Object:
    """An object of the file: a group or a dataset."""

    def __init__(self, file: "File", header: _Header) -> None:
        self._file = file
        self._header = header
        self.attrs = AttributeManager(self)


class Group(_Object):
    """An old-style group: its links in a symbol table."""

    def __init__(self, file: "File", header: _Header) -> None:
        super().__init__(file, header)
        self._links: "dict | None" = None  # name (bytes) -> _Entry or a loaded object
        self._links_dirty = False
        if header.find(_STAB) is None:
            raise UnsupportedHDF5(f"an object header without a symbol table (at {header.addr})")

    @classmethod
    def _new(cls, file: "File") -> "Group":
        group = cls(file, _Header([_Message(_STAB, struct.pack("<QQ", _UNDEF, _UNDEF))]))
        group._links, group._links_dirty = {}, True
        return group

    def _stab(self) -> tuple:
        return struct.unpack_from("<QQ", self._header.find(_STAB).data)

    def _table(self) -> dict:
        if self._links is None:
            self._links = self._file._read_links(*self._stab())
        return self._links

    def _child(self, name: bytes) -> "Group | Dataset":
        links = self._table()
        link = links[name]
        if isinstance(link, _Entry):
            if link.cache == 2:
                raise UnsupportedHDF5(f"a soft link ({name.decode()!r})")
            header = _Header.read(self._file._store, link.addr)
            link = Group(self._file, header) if header.find(_STAB) else Dataset(self._file, header)
            links[name] = link
        return link

    def _walk(self, path: str, create: bool = False) -> tuple:
        """``(group, last name)`` of ``path``, creating the groups on the
        way where ``create``."""
        parts = [p.encode() for p in str(path).strip("/").split("/") if p]
        if not parts:
            raise ValueError(f"empty path {path!r}")
        group = self
        for part in parts[:-1]:
            if part not in group._table():
                if not create:
                    raise KeyError(f"no object {path!r}")
                group._link(part, Group._new(self._file))
            child = group._child(part)
            if not isinstance(child, Group):
                raise KeyError(f"{part.decode()!r} in {path!r} is not a group")
            group = child
        return group, parts[-1]

    def _link(self, name: bytes, obj: _Object) -> None:
        self._file._check_writable()
        if name in self._table():
            raise ValueError(f"an object named {name.decode()!r} exists")
        self._links[name] = obj
        self._links_dirty = True

    def __contains__(self, path: str) -> bool:
        try:
            group, name = self._walk(path)
        except KeyError:
            return False
        return name in group._table()

    def __getitem__(self, path: str) -> "Group | Dataset":
        group, name = self._walk(path)
        if name not in group._table():
            raise KeyError(f"no object {path!r}")
        return group._child(name)

    def __delitem__(self, path: str) -> None:
        self._file._check_writable()
        group, name = self._walk(path)
        if name not in group._table():
            raise KeyError(f"no object {path!r}")
        del group._links[name]
        group._links_dirty = True

    def keys(self) -> list:
        return [name.decode() for name in sorted(self._table())]

    def items(self) -> list:
        return [(name.decode(), self._child(name)) for name in sorted(self._table())]

    def create_group(self, path: str) -> "Group":
        """Create a group, and the groups on its path that are missing.

        :raises ValueError: When an object of that name exists.
        """
        group, name = self._walk(path, create=True)
        child = Group._new(self._file)
        group._link(name, child)
        return child

    def create_dataset(self, path: str, shape=None, dtype=None, data=None, maxshape=None,
                       chunks=None) -> "Dataset":
        """Create a dataset as h5py does: ``data=`` alone makes it contiguous;
        ``chunks=True``, or a ``maxshape``, chunks it as h5py would.

        :raises ValueError: When an object of that name exists.
        :raises TypeError: For a dtype outside the subset.
        """
        if data is not None:
            data = np.asarray(data, dtype=dtype)
            shape, dtype = data.shape if shape is None else tuple(shape), data.dtype
        shape = tuple(int(d) for d in shape)
        dtype = np.dtype(np.float32 if dtype is None else dtype)
        group, name = self._walk(path, create=True)
        dataset = Dataset._new(self._file, shape, dtype, maxshape, chunks)
        group._link(name, dataset)
        if data is not None:
            dataset[...] = data
        return dataset

    def _flush(self) -> bool:
        """Write what changed below and in this group; True when its entry
        in the parent must change."""
        store = self._file._store
        children = [obj for obj in (self._links or {}).values() if isinstance(obj, _Object)]
        moved = [obj._flush() for obj in children]
        changed = False
        if self._links_dirty or any(moved) or self._header.addr is None:
            stab = self._file._write_links(self._links if self._links is not None else self._table())
            self._header.replace(self._header.find(_STAB), struct.pack("<QQ", *stab))
            self._links_dirty, changed = False, True
        return self._header.flush(store) or changed


class _Rows:
    """The S{n} rows of a dataset decoded to ``str`` (h5py's ``asstr()``)."""

    def __init__(self, dataset: "Dataset") -> None:
        self._dataset = dataset

    def __getitem__(self, key) -> np.ndarray:
        raw = np.asarray(self._dataset[key])
        return np.array([b.decode() for b in raw.ravel().tolist()], dtype=object).reshape(raw.shape)


class Dataset(_Object):
    """A chunked or contiguous dataset of fixed-size elements, read and
    written by rows; a chunk holds whole rows."""

    def __init__(self, file: "File", header: _Header) -> None:
        super().__init__(file, header)
        space, layout, dtype = (header.find(t) for t in (_DATASPACE, _LAYOUT, _DATATYPE))
        if space is None or layout is None or dtype is None:
            raise UnsupportedHDF5(f"an object that is neither a group nor a dataset (at {header.addr})")
        self.shape, self.maxshape, _ = _decode_space(space.data)
        if not self.shape:
            raise UnsupportedHDF5("a scalar dataset")
        self._type, _ = _decode_type(dtype.data)
        if self._type.kind == "vstr":
            raise UnsupportedHDF5("a dataset of variable-length strings")
        fill = header.find(_FILL)
        self._fill = _decode_fill(fill.data, self._type.stored) if fill else bytes(self._type.stored.itemsize)
        version, cls = layout.data[0], layout.data[1]
        if version != 3:
            raise UnsupportedHDF5(f"a data layout message of version {version}")
        if cls == 1:
            self.chunks = None
            self._addr, _ = struct.unpack_from("<QQ", layout.data, 2)
        elif cls == 2:
            ndims = layout.data[2]
            (self._btree,) = struct.unpack_from("<Q", layout.data, 3)
            dims = struct.unpack_from(f"<{ndims}I", layout.data, 11)
            if ndims != len(self.shape) + 1 or dims[-1] != self._type.stored.itemsize:
                raise UnsupportedHDF5(f"a chunk layout of {ndims} dimensions {dims} for shape {self.shape}")
            self.chunks = tuple(dims[:-1])
            if self.chunks[1:] != self.shape[1:]:
                raise UnsupportedHDF5(f"chunks {self.chunks} that split the rows of shape {self.shape}")
        else:
            raise UnsupportedHDF5(f"a {('compact', 'contiguous', 'chunked', 'virtual')[cls]} layout"
                                  if cls < 4 else f"a layout of class {cls}")
        self._index: "dict | None" = None  # chunk number -> address
        self._index_dirty = False

    @classmethod
    def _new(cls, file: "File", shape: tuple, dtype: np.dtype, maxshape, chunks) -> "Dataset":
        kind = _Type.of(dtype)
        if kind.kind == "vstr":
            raise TypeError(f"no dataset of this module stores {dtype}")
        maxshape = None if maxshape is None else tuple(maxshape)
        if chunks is True or (chunks is None and maxshape is not None):
            chunks = _guess_chunks(shape, kind.stored.itemsize)
        if chunks:
            layout = struct.pack(f"<BBBQ{len(shape) + 1}I", 3, 2, len(shape) + 1, _UNDEF,
                                 *(int(c) for c in chunks), kind.stored.itemsize)
            fill = struct.pack("<BBBBI", 2, 3, 2, 1, 0)  # incremental allocation, as h5py
        else:
            if maxshape is not None and maxshape != shape:
                raise ValueError("a resizable dataset needs chunks")
            size = int(np.prod(shape, dtype=np.int64)) * kind.stored.itemsize
            addr = file._store.alloc(size) if size else _UNDEF
            file._store.extend()
            layout = struct.pack("<BBQQ", 3, 1, addr, size)
            fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)  # late allocation, as h5py
        header = _Header([
            _Message(_DATASPACE, _encode_space(shape, maxshape)),
            _Message(_DATATYPE, kind.encode(), flags=0x01),
            _Message(_FILL, fill, flags=0x01),
            _Message(_LAYOUT, layout),
        ])
        dataset = cls(file, header)
        if dataset.chunks:
            dataset._index = {}
        return dataset

    @property
    def dtype(self) -> np.dtype:
        return self._type.dtype

    def _row_bytes(self) -> int:
        return int(np.prod(self.shape[1:], dtype=np.int64)) * self._type.stored.itemsize

    # -- chunks ----------------------------------------------------------------

    def _chunk_index(self) -> dict:
        if self._index is None:
            rank = len(self.shape)
            nbytes = self.chunks[0] * self._row_bytes()
            self._index = {}
            if self._btree != _UNDEF:
                for key, child in _btree_leaves(self._file._store, self._btree, 1, 8 + 8 * (rank + 1)):
                    size, mask, first = struct.unpack_from("<IIQ", key)
                    if mask:
                        raise UnsupportedHDF5("a chunk stored through a filter")
                    if size != nbytes:
                        raise UnsupportedHDF5(f"a chunk of {size} bytes where whole chunks hold {nbytes}")
                    self._index[first // self.chunks[0]] = child
        return self._index

    def chunk_offsets(self) -> list:
        """The file offsets of the allocated chunks in chunk order (h5py's
        ``id.get_chunk_info(i).byte_offset`` for each ``i``).

        :raises ValueError: For a contiguous dataset.
        """
        if self.chunks is None:
            raise ValueError("a contiguous dataset has no chunks")
        index = self._chunk_index()
        return [index[number] for number in sorted(index)]

    def resize(self, size: int, axis: int = 0) -> None:
        """Grow the dataset to ``size`` rows; the new rows read as the fill
        value.

        :raises ValueError: For another axis than 0, beyond ``maxshape``,
            when shrinking, or for a contiguous dataset.
        """
        if self.chunks is None or axis != 0:
            raise ValueError("only a chunked dataset grows, along axis 0")
        size = int(size)
        if self.maxshape[0] is not None and size > self.maxshape[0]:
            raise ValueError(f"{size} rows exceed the maximum {self.maxshape[0]}")
        if size < self.shape[0]:
            raise ValueError(f"shrinking a dataset ({self.shape[0]} to {size} rows) is not supported")
        self.shape = (size,) + self.shape[1:]
        space = self._header.find(_DATASPACE)
        self._header.replace(space, _encode_space(self.shape, self.maxshape))

    def _set_btree(self, addr: int) -> None:
        self._btree = addr
        layout = self._header.find(_LAYOUT)
        data = bytearray(layout.data)
        struct.pack_into("<Q", data, 3, addr)
        self._header.replace(layout, bytes(data))

    def _spans(self, start: int, stop: int):
        """``(chunk number, its first row read, slice of rows start:stop)``
        of each chunk that rows ``start:stop`` touch."""
        rows = self.chunks[0]
        for number in range(start // rows, (stop - 1) // rows + 1):
            lo, hi = max(start, number * rows), min(stop, (number + 1) * rows)
            yield number, lo - number * rows, slice(lo - start, hi - start)

    # -- reads and writes ------------------------------------------------------

    def asstr(self) -> _Rows:
        """Reads of the ``S{n}`` rows decoded from UTF-8 to ``str``."""
        return _Rows(self)

    def _rows(self, key) -> "tuple | np.ndarray":
        """``(start, stop)`` of a slice, or the sorted rows of a list."""
        if key is Ellipsis or (isinstance(key, tuple) and not key):
            return 0, self.shape[0]
        if isinstance(key, slice):
            start, stop, step = key.indices(self.shape[0])
            if step != 1:
                raise ValueError("a slice with a step is not supported")
            return start, max(start, stop)
        if isinstance(key, (int, np.integer)):
            row = int(key) + (self.shape[0] if key < 0 else 0)
            if not 0 <= row < self.shape[0]:
                raise IndexError(f"row {key} out of range for {self.shape[0]} rows")
            return row, row + 1
        rows = np.asarray(key, dtype=np.int64)
        if rows.ndim != 1 or (rows.size and (rows[0] < 0 or rows[-1] >= self.shape[0])):
            raise IndexError("rows must be a list of integers inside the dataset")
        if np.any(np.diff(rows) < 0):
            raise ValueError("rows must be in increasing order")
        return rows

    def __getitem__(self, key):
        rows = self._rows(key)
        if isinstance(rows, tuple):
            out = np.empty((rows[1] - rows[0],) + self.shape[1:], self._type.stored)
            self._read_span(rows[0], rows[1], out)
        else:
            out = np.empty((rows.shape[0],) + self.shape[1:], self._type.stored)
            # one read a run of consecutive rows in one chunk
            per_chunk = rows // self.chunks[0] if self.chunks else np.zeros_like(rows)
            cut = 1 + np.flatnonzero((np.diff(rows) != 1) | (np.diff(per_chunk) != 0))
            for lo, hi in zip(np.r_[0, cut], np.r_[cut, rows.shape[0]]):
                self._read_span(int(rows[lo]), int(rows[hi - 1]) + 1, out[lo:hi])
        if self._type.kind == "bool":
            out = out.astype(bool)
        return out[0] if isinstance(key, (int, np.integer)) else out

    def __setitem__(self, key, value) -> None:
        """Write rows ``key`` (a slice, ``...`` or one row)."""
        self._file._check_writable()
        rows = self._rows(key)
        if not isinstance(rows, tuple):
            raise ValueError("writes take a slice of rows")
        start, stop = rows
        value = np.asarray(value)
        if self._type.kind == "bool":
            value = value.astype(bool)
        data = np.ascontiguousarray(np.broadcast_to(value.astype(self._type.stored, copy=False),
                                                    (stop - start,) + self.shape[1:]))
        if stop <= start:
            return
        store = self._file._store
        if self.chunks is None:
            store.write(self._addr + start * self._row_bytes(), data)
            return
        index = self._chunk_index()
        row_bytes = self._row_bytes()
        for number, first, target in self._spans(start, stop):
            addr = index.get(number)
            if addr is None:  # a whole chunk, of the fill value
                addr = index[number] = store.alloc(self.chunks[0] * row_bytes)
                store.extend()
                if any(self._fill):
                    block = np.empty(self.chunks, self._type.stored)
                    self._fill_array(block)
                    store.write(addr, block)
                self._index_dirty = True
            store.write(addr + first * row_bytes, data[target])

    def _fill_array(self, out: np.ndarray) -> None:
        out[...] = np.frombuffer(self._fill, self._type.stored)[0]

    def _read_span(self, start: int, stop: int, out: np.ndarray) -> None:
        if stop <= start:
            return
        store = self._file._store
        if self.chunks is None:
            if self._addr == _UNDEF:
                self._fill_array(out)
            else:
                store.readinto(self._addr + start * self._row_bytes(), out)
            return
        index = self._chunk_index()
        row_bytes = self._row_bytes()
        for number, first, target in self._spans(start, stop):
            addr = index.get(number)
            if addr is None:
                self._fill_array(out[target])
            else:
                store.readinto(addr + first * row_bytes, out[target])

    def _flush(self) -> bool:
        if self._index_dirty:
            rank = len(self.shape)
            rows, nbytes = self.chunks[0], self.chunks[0] * self._row_bytes()
            numbers = sorted(self._index)
            trailing = (0,) * rank  # the other axes' offsets and the element's
            items = [(struct.pack(f"<II{rank + 1}Q", nbytes, 0, n * rows, *trailing), self._index[n])
                     for n in numbers]
            right = struct.pack(f"<II{rank + 1}Q", 0, 0, (numbers[-1] + 1) * rows, *self.shape[1:],
                                self._type.stored.itemsize)
            self._set_btree(_write_btree(self._file._store, 1, 2 * self._file._chunk_k, items, right))
            self._index_dirty = False
        return self._header.flush(self._file._store)


def _guess_chunks(shape: tuple, itemsize: int) -> tuple:
    """The chunk shape h5py picks for ``chunks=True``: halve the axes in
    turn until a chunk is near a target size that grows with the dataset
    (8 KiB to 1 MiB)."""
    chunks = np.array([d if d else 1024 for d in shape], dtype=np.float64)
    if not chunks.size:
        raise ValueError("a scalar dataset has no chunks")
    target = 16 * 1024 * 2 ** np.log10(np.prod(chunks) * itemsize / (1024.0 * 1024))
    target = min(max(target, 8 * 1024), 1024 * 1024)
    axis = 0
    while True:
        nbytes = np.prod(chunks) * itemsize
        if (nbytes < target or abs(nbytes - target) / target < 0.5) and nbytes < 1024 * 1024:
            break
        if np.prod(chunks) == 1:
            break
        chunks[axis % chunks.size] = np.ceil(chunks[axis % chunks.size] / 2.0)
        axis += 1
    return tuple(int(c) for c in chunks)


# -- the file ------------------------------------------------------------------


class File(Group):
    """An HDF5 file of the subset, opened as h5py's ``File``: ``"r"``,
    ``"w"`` (create or truncate) or ``"a"`` (read and write, create if
    missing).  Changes reach the file at ``close``.

    :raises UnsupportedHDF5: When the file lies outside the subset.
    """

    def __init__(self, path, mode: str = "r") -> None:
        if mode not in ("r", "w", "a"):
            raise ValueError(f"mode must be 'r', 'w' or 'a', got {mode!r}")
        path = os.fspath(path)
        create = mode == "w" or (mode == "a" and not os.path.exists(path))
        self._store = _Store(path, mode != "r", create)
        self._readonly = mode == "r"
        self._file = self
        self._strings: "tuple | None" = None  # the open global heap: (address, size, used, objects)
        self._gcols: dict = {}
        try:
            if create:
                self._superblock = bytearray(96)
                self._root_at = 56
                self._leaf_k, self._group_k, self._chunk_k = _LEAF_K, _GROUP_K, _CHUNK_K
                self._store.eoa = 96
                super().__init__(self, _Header([_Message(_STAB, struct.pack("<QQ", _UNDEF, _UNDEF))]))
                self._links, self._links_dirty = {}, True
            else:
                self._read_superblock()
                (addr,) = struct.unpack_from("<Q", self._superblock, self._root_at + 8)
                super().__init__(self, _Header.read(self._store, addr))
        except BaseException:
            self._store.close()
            raise
        self._new_file = create

    def _check_writable(self) -> None:
        if self._readonly:
            raise ValueError("the file is open for reading only")

    def _read_superblock(self) -> None:
        store = self._store
        head = store.read(0, min(100, store.size()))
        if head[:8] != _SIGNATURE:
            raise UnsupportedHDF5("no HDF5 superblock at the start of the file (a user block?)")
        version = head[8]
        if version not in (0, 1):
            raise UnsupportedHDF5(f"superblock version {version} (h5py's libver='latest' or "
                                  "a newer library bound)")
        if head[13] != 8 or head[14] != 8:
            raise UnsupportedHDF5(f"{head[13]}-byte offsets and {head[14]}-byte lengths")
        self._leaf_k, self._group_k = struct.unpack_from("<HH", head, 16)
        self._chunk_k = struct.unpack_from("<H", head, 24)[0] if version == 1 else _CHUNK_K
        at = 28 if version == 1 else 24
        base, _, eoa, layer_info = struct.unpack_from("<4Q", head, at)
        if base != 0:
            raise UnsupportedHDF5(f"a base address of {base}")
        if layer_info != _UNDEF:
            raise UnsupportedHDF5("a file-layer information block (a family or multi file)")
        if store.size() < eoa:
            raise UnsupportedHDF5(f"truncated file: {store.size()} bytes, the superblock says {eoa}")
        self._superblock = bytearray(head[: at + 72])
        self._root_at = at + 32
        store.eoa = eoa

    # -- links -----------------------------------------------------------------

    def _read_links(self, btree: int, heap: int) -> dict:
        store = self._store
        prefix = store.read(heap, 32)
        if prefix[:4] != b"HEAP" or prefix[4] != 0:
            raise UnsupportedHDF5(f"no local heap of version 0 at {heap}")
        size, _, data_addr = struct.unpack_from("<QQQ", prefix, 8)
        names = store.read(data_addr, size)
        links = {}
        for _, snod in _btree_leaves(store, btree, 0, 8):
            head = store.read(snod, 8)
            if head[:4] != b"SNOD" or head[4] != 1:
                raise UnsupportedHDF5(f"no symbol table node of version 1 at {snod}")
            (count,) = struct.unpack_from("<H", head, 6)
            raw = store.read(snod + 8, 40 * count)
            for i in range(count):
                offset, addr, cache = struct.unpack_from("<QQI", raw, 40 * i)
                name = names[offset : names.index(b"\0", offset)]
                links[name] = _Entry(addr, cache, raw[40 * i + 24 : 40 * i + 40])
        return links

    def _write_links(self, links: dict) -> tuple:
        """Write a group's heap, symbol nodes and B-tree; returns
        ``(B-tree address, heap address)``."""
        store = self._store
        names = sorted(links)
        data = bytearray(8)  # offset 0: the empty name
        offsets = []
        for name in names:
            offsets.append(len(data))
            data += _padded(name + b"\0")
        heap = store.alloc(32 + len(data))
        store.write(heap, b"HEAP" + struct.pack("<B3xQQQ", 0, len(data), _HEAP_FREE_NULL, heap + 32) + data)
        per_node = 2 * self._leaf_k
        items = []
        for i in range(0, len(names), per_node):
            out = bytearray(b"SNOD" + struct.pack("<BxH", 1, len(names[i : i + per_node])))
            for name, offset in zip(names[i : i + per_node], offsets[i : i + per_node]):
                entry = self._entry_of(links[name])
                out += struct.pack("<QQI4x", offset, entry.addr, entry.cache) + entry.scratch
            size = 8 + 40 * per_node
            addr = store.alloc(size)
            store.write(addr, out + bytes(size - len(out)))
            items.append((struct.pack("<Q", offsets[i - 1] if i else 0), addr))
        right = struct.pack("<Q", offsets[-1] if names else 0)
        return _write_btree(store, 0, 2 * self._group_k, items, right), heap

    @staticmethod
    def _entry_of(link) -> _Entry:
        if isinstance(link, _Entry):
            return link
        if isinstance(link, Group):
            return _Entry(link._header.addr, 1, struct.pack("<QQ", *link._stab()))
        return _Entry(link._header.addr)

    # -- attributes ------------------------------------------------------------

    def _put_string(self, data: bytes) -> tuple:
        """Store ``data`` in the global heap collection this ``File`` opened;
        returns ``(collection address, object index)``."""
        need = 16 + _pad8(len(data))
        if self._strings is None or self._strings[2] + need + 16 > self._strings[1]:
            size = max(_GCOL_MIN, 32 + need)
            self._strings = (self._store.alloc(size), size, 16, [])
        addr, size, used, objects = self._strings
        objects.append(data)
        used += need
        out = bytearray(b"GCOL" + struct.pack("<B3xQ", 1, size))
        for i, obj in enumerate(objects, 1):
            out += struct.pack("<HH4xQ", i, 0, len(obj)) + _padded(obj)
        out += struct.pack("<HH4xQ", 0, 0, size - len(out))
        self._store.write(addr, out + bytes(size - len(out)))
        self._strings = (addr, size, used, objects)
        self._gcols.pop(addr, None)
        return addr, len(objects)

    def _get_string(self, addr: int, index: int) -> bytes:
        if addr not in self._gcols:
            head = self._store.read(addr, 16)
            if head[:4] != b"GCOL":
                raise UnsupportedHDF5(f"no global heap collection at {addr}")
            (size,) = struct.unpack_from("<Q", head, 8)
            raw = self._store.read(addr, size)
            objects, pos = {}, 16
            while pos + 16 <= size:
                idx, _, length = struct.unpack_from("<HH4xQ", raw, pos)
                if idx == 0:
                    break
                objects[idx] = raw[pos + 16 : pos + 16 + length]
                pos += 16 + _pad8(length)
            self._gcols[addr] = objects
        return self._gcols[addr][index]

    def _encode_attribute(self, name: str, value) -> bytes:
        self._check_writable()
        array = np.array(value, dtype=object) if isinstance(value, str) else np.asarray(value)
        kind = _Type.of(array.dtype)
        if kind.kind == "vstr":
            data = np.empty(array.shape, _VSTR_ELEMENT)
            for pos, item in np.ndenumerate(array):
                if not isinstance(item, str):
                    raise TypeError(f"attribute {name!r}: {item!r} is not a str")
                raw = item.encode()
                data[pos] = (len(raw),) + self._put_string(raw)
        else:
            data = array.astype(kind.stored)
        raw_name = name.encode()
        dtype, space = kind.encode(), _encode_space(array.shape)
        if raw_name.isascii():
            head = struct.pack("<BxHHH", 1, len(raw_name) + 1, len(dtype), len(space))
            return (head + _padded(raw_name + b"\0") + _padded(dtype) + _padded(space)
                    + data.tobytes())
        head = struct.pack("<BxHHHB", 3, len(raw_name) + 1, len(dtype), len(space), 1)
        return head + raw_name + b"\0" + dtype + space + data.tobytes()

    def _decode_attribute(self, data: bytes):
        version = data[0]
        name_size, type_size, space_size = struct.unpack_from("<HHH", data, 2)
        if version == 1:
            pos = 8 + _pad8(name_size)
            kind, _ = _decode_type(data, pos)
            pos += _pad8(type_size)
            shape, _, _ = _decode_space(data, pos)
            pos += _pad8(space_size)
        elif version in (2, 3):
            if data[1] & 0x03:
                raise UnsupportedHDF5("an attribute with a shared datatype or dataspace")
            pos = (8 if version == 2 else 9) + name_size
            kind, _ = _decode_type(data, pos)
            shape, _, _ = _decode_space(data, pos + type_size)
            pos += type_size + space_size
        else:
            raise UnsupportedHDF5(f"an attribute message of version {version}")
        count = int(np.prod(shape, dtype=np.int64))
        stored = np.frombuffer(data, kind.stored, count, pos).reshape(shape)
        if kind.kind == "vstr":
            out = np.empty(shape, object)
            for idx in np.ndindex(shape):
                length, addr, index = stored[idx]
                out[idx] = self._get_string(int(addr), int(index))[:length].decode() if length else ""
        elif kind.kind == "bool":
            out = stored.astype(bool)
        else:
            out = stored.copy()
        return out[()] if not shape else out

    # -- closing ---------------------------------------------------------------

    def _write_out(self) -> None:
        """Write every change to the file."""
        if self._readonly:
            return
        store = self._store
        self._flush()
        block = self._superblock
        if self._new_file:  # a version-0 superblock
            block[:24] = _SIGNATURE + struct.pack("<8BHHI", 0, 0, 0, 0, 0, 8, 8, 0,
                                                  self._leaf_k, self._group_k, 0)
            struct.pack_into("<4Q", block, 24, 0, _UNDEF, 0, _UNDEF)
            self._new_file = False
        entry = self._entry_of(self)
        struct.pack_into("<QQI4x", block, self._root_at, 0, entry.addr, entry.cache)
        block[self._root_at + 24 : self._root_at + 40] = entry.scratch
        struct.pack_into("<Q", block, self._root_at - 16, store.eoa)
        store.extend()
        store.write(0, bytes(block))

    def close(self) -> None:
        """Write every change (where open for writing) and close the file."""
        if self._store.fd < 0:
            return
        try:
            self._write_out()
        finally:
            self._store.close()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
