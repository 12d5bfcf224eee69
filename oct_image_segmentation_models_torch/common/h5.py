"""HDF5 files without h5py, written with numpy, zlib and the standard
library.

The port reads and writes the HDF5 files the JAX package and its users
exchange (datasets, native and Keras checkpoints, the workflows'
artifacts) through this module, whether or not h5py is installed, so the
path the CPU tests run is the path that runs on a machine without h5py.
It offers the subset of h5py's API that the port calls: :class:`File`
(modes ``"r"``, ``"w"`` and ``"a"``), :class:`Group`, :class:`Dataset`
and ``attrs``. Values come back as h5py 3 returns them: a fixed-length
string as ``np.bytes_`` (an ``S`` array when not scalar), a
variable-length string attribute as ``str`` (a dataset's as ``bytes``),
a scalar attribute as a numpy scalar, h5py's boolean enum as
``np.bool_``; members and attributes iterate by name.

Read: superblocks v0 to v3 (at offset 0 or after a user block), object
headers v1 (with continuation blocks) and v2 (with their Jenkins lookup3
checksums verified), symbol-table groups (v1 B-trees, local heaps),
compact link and attribute messages, contiguous, compact and v1-B-tree
chunked layouts with the deflate and shuffle filters; integers and
floats of either byte order, fixed-length strings, variable-length
strings from the global heap and the boolean enum; scalar, simple and
null dataspaces. Everything else raises :class:`UnsupportedFeature`
naming it: dense link or attribute storage (fractal heaps, v2 B-trees),
chunk indexes other than the v1 B-tree, other filters, compound,
reference, array, opaque, time and bitfield types, other enums,
variable-length sequences, soft and external links, shared messages.

Write: what h5py writes by default (superblock v0, v1 object headers
with continuation blocks, symbol-table groups with names sorted,
contiguous datasets, attributes in the object header). ``"w"`` and
``"a"`` build the tree in memory and write it when the file closes, to a
temporary file beside the target that then replaces it, so a process
that dies leaves the previous file whole; ``"a"`` keeps every dataset
and attribute it does not change bit for bit.
"""

from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF


class UnsupportedFeature(OSError):
    """An HDF5 feature this module does not read or write."""

    def __init__(self, feature: str, where: str = ""):
        self.feature = feature
        at = f" ({where})" if where else ""
        super().__init__(f"unsupported HDF5 feature: {feature}{at}")


class FormatError(OSError):
    """A file that is not HDF5, or is damaged."""


# ---------------------------------------------------------------------------
# Jenkins lookup3 (hashlittle), the checksum of v2 metadata
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _rot(x, k):
    return ((x << k) | (x >> (32 - k))) & _M32


def _lookup3(data: bytes) -> int:
    n = len(data)
    a = b = c = (0xDEADBEEF + n) & _M32
    i = 0
    while n > 12:
        a = (a + int.from_bytes(data[i:i + 4], "little")) & _M32
        b = (b + int.from_bytes(data[i + 4:i + 8], "little")) & _M32
        c = (c + int.from_bytes(data[i + 8:i + 12], "little")) & _M32
        a = (a - c) & _M32; a ^= _rot(c, 4); c = (c + b) & _M32  # noqa: E702
        b = (b - a) & _M32; b ^= _rot(a, 6); a = (a + c) & _M32  # noqa: E702
        c = (c - b) & _M32; c ^= _rot(b, 8); b = (b + a) & _M32  # noqa: E702
        a = (a - c) & _M32; a ^= _rot(c, 16); c = (c + b) & _M32  # noqa: E702
        b = (b - a) & _M32; b ^= _rot(a, 19); a = (a + c) & _M32  # noqa: E702
        c = (c - b) & _M32; c ^= _rot(b, 4); b = (b + a) & _M32  # noqa: E702
        n -= 12
        i += 12
    if n == 0:
        return c
    tail = data[i:i + n] + bytes(12 - n)
    a = (a + int.from_bytes(tail[0:4], "little")) & _M32
    b = (b + int.from_bytes(tail[4:8], "little")) & _M32
    c = (c + int.from_bytes(tail[8:12], "little")) & _M32
    c ^= b; c = (c - _rot(b, 14)) & _M32  # noqa: E702
    a ^= c; a = (a - _rot(c, 11)) & _M32  # noqa: E702
    b ^= a; b = (b - _rot(a, 25)) & _M32  # noqa: E702
    c ^= b; c = (c - _rot(b, 16)) & _M32  # noqa: E702
    a ^= c; a = (a - _rot(c, 4)) & _M32  # noqa: E702
    b ^= a; b = (b - _rot(a, 14)) & _M32  # noqa: E702
    c ^= b; c = (c - _rot(b, 24)) & _M32  # noqa: E702
    return c


# ---------------------------------------------------------------------------
# Datatypes
# ---------------------------------------------------------------------------

# IEEE layouts by size: (exponent location, exponent size, mantissa size, bias)
_IEEE = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class _Type:
    """A datatype the module reads and writes: ``kind`` is "int",
    "float", "str" (fixed length), "vstr" (variable-length string) or
    "bool" (h5py's enum); ``dtype`` the numpy dtype of the values (object
    for "vstr"); ``pad`` and ``cset`` the string padding and character
    set as HDF5 encodes them."""

    __slots__ = ("kind", "dtype", "pad", "cset")

    def __init__(self, kind, dtype, pad=0, cset=0):
        self.kind, self.dtype, self.pad, self.cset = kind, np.dtype(dtype), pad, cset

    @property
    def size(self) -> int:
        return 16 if self.kind == "vstr" else self.dtype.itemsize

    @property
    def storage(self) -> np.dtype:
        """The numpy dtype of the bytes in the file."""
        if self.kind == "bool":
            return np.dtype("i1")
        if self.kind == "vstr":
            return np.dtype([("len", "<u4"), ("addr", "<u8"), ("index", "<u4")])
        return self.dtype

    def encode(self) -> bytes:
        big = self.dtype.byteorder == ">"
        if self.kind == "int":
            flags = int(big) | (8 if self.dtype.kind == "i" else 0)
            return _dt_header(0, 1, flags, self.size) + struct.pack("<HH", 0, 8 * self.size)
        if self.kind == "float":
            exp_loc, exp_size, mant_size, bias = _IEEE[self.size]
            flags = int(big) | 0x20 | ((8 * self.size - 1) << 8)
            return _dt_header(1, 1, flags, self.size) + struct.pack(
                "<HHBBBBI", 0, 8 * self.size, exp_loc, exp_size, 0, mant_size, bias
            )
        if self.kind == "str":
            return _dt_header(3, 1, self.pad | (self.cset << 4), self.size)
        if self.kind == "vstr":
            base = _dt_header(0, 1, 0, 1) + struct.pack("<HH", 0, 8)
            flags = 1 | (self.pad << 4) | (self.cset << 8)
            return _dt_header(9, 1, flags, 16) + base
        # h5py's bool: an enum of int8 with FALSE = 0 and TRUE = 1
        base = _dt_header(0, 1, 8, 1) + struct.pack("<HH", 0, 8)
        names = b"FALSE\0\0\0TRUE\0\0\0\0"
        return _dt_header(8, 1, 2, 1) + base + names + b"\x00\x01"


def _dt_header(cls, version, flags, size) -> bytes:
    return struct.pack("<BBBBI", cls | (version << 4), flags & 0xFF,
                       (flags >> 8) & 0xFF, (flags >> 16) & 0xFF, size)


def _parse_type(buf: bytes, pos: int = 0):
    """-> (_Type, position after the type)."""
    cls_ver, f0, f1, f2, size = struct.unpack_from("<BBBBI", buf, pos)
    cls, version = cls_ver & 0x0F, cls_ver >> 4
    flags = f0 | (f1 << 8) | (f2 << 16)
    pos += 8
    order = ">" if flags & 1 else "<"
    if cls == 0:
        offset, precision = struct.unpack_from("<HH", buf, pos)
        if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size:
            raise UnsupportedFeature(
                f"integer type of {size} bytes, {precision} bits at bit {offset}"
            )
        kind = "i" if flags & 8 else "u"
        return _Type("int", f"{order}{kind}{size}"), pos + 4
    if cls == 1:
        offset, precision, exp_loc, exp_size, mant_loc, mant_size, bias = struct.unpack_from(
            "<HHBBBBI", buf, pos
        )
        ieee = _IEEE.get(size)
        if (
            ieee is None or flags & 0x40 or offset != 0 or precision != 8 * size
            or mant_loc != 0 or (exp_loc, exp_size, mant_size, bias) != ieee
            or (flags >> 4) & 3 != 2 or (flags >> 8) & 0xFF != 8 * size - 1
        ):
            raise UnsupportedFeature(f"floating-point type of {size} bytes that is not IEEE")
        return _Type("float", f"{order}f{size}"), pos + 12
    if cls == 3:
        pad, cset = flags & 0x0F, (flags >> 4) & 0x0F
        if pad > 2 or cset > 1:
            raise UnsupportedFeature(f"string padding {pad} / character set {cset}")
        return _Type("str", f"S{size}", pad, cset), pos
    if cls == 8:
        count = flags & 0xFFFF
        base, pos = _parse_type(buf, pos)
        names = []
        for _ in range(count):
            end = buf.index(b"\0", pos)
            names.append(buf[pos:end])
            pos = end + 1 if version >= 3 else pos + _pad8(end - pos + 1)
        values = list(buf[pos:pos + count * base.size])
        pos += count * base.size
        if base.kind != "int" or base.size != 1 or dict(zip(names, values)) != {
            b"FALSE": 0, b"TRUE": 1
        } or count != 2:
            raise UnsupportedFeature("enumeration type other than h5py's bool")
        return _Type("bool", np.bool_), pos
    if cls == 9:
        vtype, pad, cset = flags & 0x0F, (flags >> 4) & 0x0F, (flags >> 8) & 0x0F
        if vtype != 1:
            raise UnsupportedFeature("variable-length sequence type")
        _, pos = _parse_type(buf, pos)
        return _Type("vstr", object, pad, cset), pos
    names = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference", 10: "array"}
    raise UnsupportedFeature(f"{names.get(cls, f'class {cls}')} datatype")


def _type_of(array: np.ndarray) -> _Type:
    """The type h5py gives a numpy array it stores."""
    dtype = array.dtype
    if dtype.kind == "b":
        return _Type("bool", np.bool_)
    if dtype.kind in "iu" and dtype.itemsize in (1, 2, 4, 8):
        return _Type("int", dtype)
    if dtype.kind == "f" and dtype.itemsize in _IEEE:
        return _Type("float", dtype)
    if dtype.kind == "S":
        return _Type("str", dtype, pad=1)
    if dtype.kind == "O" and all(isinstance(x, (str, bytes)) for x in array.flat):
        return _Type("vstr", object, pad=0, cset=1)
    raise TypeError(f"no HDF5 type for numpy dtype {dtype}")


def _as_array(value, dtype=None) -> np.ndarray:
    """A value as h5py turns it into an array to store: ``str`` as a
    variable-length UTF-8 string, ``bytes`` as a fixed-length one."""
    if dtype is not None:
        dtype = np.dtype(dtype)
        if dtype.kind == "O":
            return np.array(value, dtype=object)
        return np.asarray(value, dtype=dtype)
    if isinstance(value, str):
        return np.array(value, dtype=object)
    array = np.asarray(value)
    if array.dtype.kind == "U":
        return array.astype(object)
    return array


# ---------------------------------------------------------------------------
# Typed values: numpy arrays with their HDF5 type
# ---------------------------------------------------------------------------


class Empty:
    """A null dataspace's value, as h5py's ``h5py.Empty``."""

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)

    def __eq__(self, other):
        return isinstance(other, Empty) and other.dtype == self.dtype

    def __repr__(self):
        return f"Empty(dtype={self.dtype!r})"


class _Value:
    """Data and its type: ``array`` holds the values (bytes objects for a
    variable-length string), ``shape`` None is a null dataspace."""

    __slots__ = ("array", "type", "shape")

    def __init__(self, array, type_, shape):
        self.array, self.type, self.shape = array, type_, shape

    @classmethod
    def of(cls, value, dtype=None) -> "_Value":
        array = _as_array(value, dtype)
        type_ = _type_of(array)
        if type_.kind == "vstr":
            array = np.array(
                [x.encode("utf-8") if isinstance(x, str) else x for x in array.flat],
                dtype=object,
            ).reshape(array.shape)
        # a copy, as h5py writes at once: later changes to the caller's
        # array do not reach the file
        return cls(np.array(array, dtype=type_.dtype, order="C"), type_, tuple(array.shape))

    def h5py_view(self, strings_as_str: bool):
        """The value as h5py 3 returns it: scalars as numpy scalars,
        variable-length strings as ``str`` (attributes) or ``bytes``."""
        if self.shape is None:
            return Empty(self.type.dtype)
        array = self.array
        if self.type.kind == "vstr" and strings_as_str:
            array = np.array(
                [x.decode("utf-8") for x in array.flat], dtype=object
            ).reshape(array.shape)
        return array[()] if array.ndim == 0 else array.copy()


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

_SKIPPED = {0x00, 0x04, 0x0A, 0x0D, 0x0E, 0x12, 0x13, 0x14, 0x16, 0x17}
_NOT_READ = {
    0x07: "external data files",
    0x09: "bogus message",
    0x0F: "shared message table",
    0x18: "reference count of shared messages",
}


class _Reader:
    """Low-level access to an open file: the superblock's sizes and the
    parsing of objects at addresses."""

    def __init__(self, fh):
        self.fh = fh
        fh.seek(0, os.SEEK_END)
        self.file_size = fh.tell()
        self.base = self._find_superblock()
        self.heaps = {}
        self._parse_superblock()

    def _find_superblock(self) -> int:
        offset = 0
        while offset + 8 <= self.file_size:
            self.fh.seek(offset)
            if self.fh.read(8) == SIGNATURE:
                return offset
            offset = 512 if offset == 0 else offset * 2
        raise FormatError("file signature not found: not an HDF5 file")

    def read(self, addr: int, size: int) -> bytes:
        if addr == UNDEF or addr + size > self.file_size - self.base:
            raise FormatError(f"read of {size} bytes at {addr:#x} past the end of the file")
        self.fh.seek(self.base + addr)
        return self.fh.read(size)

    def read_into(self, addr: int, out: np.ndarray) -> None:
        view = memoryview(out.reshape(-1).view(np.uint8))
        if addr == UNDEF or addr + len(view) > self.file_size - self.base:
            raise FormatError(f"data of {len(view)} bytes at {addr:#x} past the end of the file")
        self.fh.seek(self.base + addr)
        got = self.fh.readinto(view)
        if got != len(view):
            raise FormatError(f"short read at {addr:#x}")

    def _parse_superblock(self):
        head = self.read(0, 48)
        version = head[8]
        if version in (0, 1):
            size_off, size_len = head[13], head[14]
            if (size_off, size_len) != (8, 8):
                raise UnsupportedFeature(f"offsets of {size_off} and lengths of {size_len} bytes")
            pos = 24 + (4 if version == 1 else 0)
            raw = self.read(0, pos + 32 + 40)
            base, _free, _eof, _driver = struct.unpack_from("<QQQQ", raw, pos)
            self._check_base(base)
            self.root_addr = struct.unpack_from("<Q", raw, pos + 32 + 8)[0]
        elif version in (2, 3):
            size_off, size_len = head[9], head[10]
            if (size_off, size_len) != (8, 8):
                raise UnsupportedFeature(f"offsets of {size_off} and lengths of {size_len} bytes")
            raw = self.read(0, 48)
            if _lookup3(raw[:44]) != struct.unpack_from("<I", raw, 44)[0]:
                raise FormatError("superblock checksum mismatch")
            base, ext, _eof, self.root_addr = struct.unpack_from("<QQQQ", raw, 12)
            self._check_base(base)
            if ext != UNDEF:
                raise UnsupportedFeature("superblock extension")
        else:
            raise UnsupportedFeature(f"superblock version {version}")

    def _check_base(self, base):
        # Addresses are relative to the superblock; a stored base address
        # is 0 or the superblock's own offset.
        if base not in (0, self.base):
            raise UnsupportedFeature(f"base address {base:#x}")

    # -- object headers ------------------------------------------------------

    def messages(self, addr: int) -> list:
        """The messages of the object header at ``addr`` as ``(type,
        bytes)``, continuation blocks followed."""
        first = self.read(addr, 16)
        if first[:4] == b"OHDR":
            return self._messages_v2(addr)
        if first[0] != 1:
            raise UnsupportedFeature(f"object header version {first[0]}")
        chunk_size = struct.unpack_from("<I", first, 8)[0]
        chunks = [(addr + 16, chunk_size)]
        out = []
        while chunks:
            start, size = chunks.pop(0)
            buf = self.read(start, size)
            pos = 0
            while pos + 8 <= size:
                mtype, msize, mflags = struct.unpack_from("<HHB", buf, pos)
                data = buf[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                self._message(mtype, mflags, data, out, chunks)
        return out

    def _messages_v2(self, addr: int) -> list:
        head = self.read(addr, min(34, self.file_size - self.base - addr))
        version, flags = head[4], head[5]
        if version != 2:
            raise UnsupportedFeature(f"object header version {version}")
        pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        chunk_size = int.from_bytes(head[pos:pos + width], "little")
        pos += width
        order = 2 if flags & 0x04 else 0
        out, chunks = [], []
        block = self.read(addr, pos + chunk_size + 4)
        self._checked(block)
        self._walk_v2(block, pos, pos + chunk_size, order, out, chunks)
        while chunks:
            start, size = chunks.pop(0)
            block = self.read(start, size)
            if block[:4] != b"OCHK":
                raise FormatError(f"bad continuation block at {start:#x}")
            self._checked(block)
            self._walk_v2(block, 4, size - 4, order, out, chunks)
        return out

    @staticmethod
    def _checked(block: bytes):
        if _lookup3(block[:-4]) != struct.unpack_from("<I", block, len(block) - 4)[0]:
            raise FormatError("object header checksum mismatch")

    def _walk_v2(self, buf, pos, end, order, out, chunks):
        while pos + 4 + order <= end:
            mtype, msize, mflags = struct.unpack_from("<BHB", buf, pos)
            pos += 4 + order
            self._message(mtype, mflags, buf[pos:pos + msize], out, chunks)
            pos += msize

    def _message(self, mtype, mflags, data, out, chunks):
        if mflags & 0x02:
            raise UnsupportedFeature("shared object header message")
        if mtype == 0x10:
            caddr, clen = struct.unpack_from("<QQ", data)
            chunks.append((caddr, clen))
        elif mtype in _NOT_READ:
            raise UnsupportedFeature(_NOT_READ[mtype])
        elif mtype in _SKIPPED:
            pass
        elif mtype in (0x01, 0x02, 0x03, 0x05, 0x06, 0x08, 0x0B, 0x0C, 0x11, 0x15):
            out.append((mtype, data))
        else:
            raise UnsupportedFeature(f"object header message type {mtype:#x}")

    # -- objects ---------------------------------------------------------------

    def load(self, addr: int, file, name: str, parent):
        """The group or dataset whose object header is at ``addr``."""
        msgs = self.messages(addr)
        kinds = {m for m, _ in msgs}
        attrs = {}
        for mtype, data in msgs:
            if mtype == 0x0C:
                key, value = self._attribute(data)
                attrs[key] = value
            elif mtype == 0x15:
                _check_attribute_info(data)
        if 0x08 in kinds:
            node = Dataset._stored(file, name, parent, self, msgs)
        else:
            node = Group(file, name, parent)
            for mtype, data in msgs:
                if mtype == 0x11:
                    btree, heap = struct.unpack_from("<QQ", data)
                    for child, caddr in self._symbol_table(btree, heap):
                        node._children[child] = (caddr,)
                elif mtype == 0x06:
                    child, caddr = _parse_link(data)
                    node._children[child] = (caddr,)
                elif mtype == 0x02:
                    _check_link_info(data)
        node._attrs = attrs
        return node

    def _attribute(self, data: bytes):
        version = data[0]
        if version == 1:
            name_size, type_size, space_size = struct.unpack_from("<HHH", data, 2)
            pos = 8
            name = data[pos:pos + name_size - 1]
            pos += _pad8(name_size)
            type_, _ = _parse_type(data, pos)
            pos += _pad8(type_size)
            shape = _parse_space(data, pos)
            pos += _pad8(space_size)
        elif version in (2, 3):
            if data[1] & 0x03:
                raise UnsupportedFeature("shared attribute datatype or dataspace")
            name_size, type_size, space_size = struct.unpack_from("<HHH", data, 2)
            pos = 8 + (1 if version == 3 else 0)
            name = data[pos:pos + name_size - 1]
            pos += name_size
            type_, _ = _parse_type(data, pos)
            pos += type_size
            shape = _parse_space(data, pos)
            pos += space_size
        else:
            raise UnsupportedFeature(f"attribute message version {version}")
        value = self.decode(data[pos:], type_, shape)
        return name.decode("utf-8"), value

    def decode(self, raw, type_: _Type, shape) -> _Value:
        """Values of ``type_`` and ``shape`` from their bytes in the file."""
        if shape is None:
            return _Value(None, type_, None)
        count = int(np.prod(shape, dtype=np.int64))
        stored = np.frombuffer(raw, dtype=type_.storage, count=count).copy()
        return _Value(self.values(stored, type_).reshape(shape), type_, tuple(shape))

    def values(self, stored: np.ndarray, type_: _Type) -> np.ndarray:
        """The values of freshly read ``stored`` bytes."""
        if type_.kind == "bool":
            return stored != 0
        if type_.kind == "vstr":
            return np.array(
                [self.heap_object(int(r["addr"]), int(r["index"]), int(r["len"])) for r in stored],
                dtype=object,
            )
        return stored

    def heap_object(self, addr: int, index: int, length: int) -> bytes:
        if length == 0:
            return b""
        if addr not in self.heaps:
            head = self.read(addr, 16)
            if head[:4] != b"GCOL" or head[4] != 1:
                raise FormatError(f"bad global heap collection at {addr:#x}")
            size = struct.unpack_from("<Q", head, 8)[0]
            buf = self.read(addr, size)
            objects, pos = {}, 16
            while pos + 16 <= size:
                idx, _refs, osize = struct.unpack_from("<HH4xQ", buf, pos)
                if idx == 0:
                    break
                objects[idx] = buf[pos + 16:pos + 16 + osize]
                pos += 16 + _pad8(osize)
            self.heaps[addr] = objects
        try:
            return self.heaps[addr][index][:length]
        except KeyError:
            raise FormatError(f"global heap object {index} missing at {addr:#x}") from None

    def _symbol_table(self, btree: int, heap: int):
        """``(name, object header address)`` of a symbol-table group."""
        head = self.read(heap, 32)
        if head[:4] != b"HEAP":
            raise FormatError(f"bad local heap at {heap:#x}")
        seg_size, _free, seg_addr = struct.unpack_from("<QQQ", head, 8)
        names = self.read(seg_addr, seg_size)
        out = []
        for snod in self._btree_children(btree, 0, key_size=8):
            buf = self.read(snod, 8)
            if buf[:4] != b"SNOD":
                raise FormatError(f"bad symbol table node at {snod:#x}")
            count = struct.unpack_from("<H", buf, 6)[0]
            entries = self.read(snod + 8, 40 * count)
            for i in range(count):
                name_off, obj, cache = struct.unpack_from("<QQI", entries, 40 * i)
                end = names.index(b"\0", name_off)
                name = names[name_off:end].decode("utf-8")
                if cache == 2:
                    raise UnsupportedFeature("soft link", name)
                out.append((name, obj))
        return out

    def _btree_children(self, addr: int, node_type: int, key_size: int):
        """The leaf children of a v1 B-tree, in key order; a chunk tree's
        leaves come with their keys."""
        head = self.read(addr, 24)
        if head[:4] != b"TREE" or head[4] != node_type:
            raise FormatError(f"bad v1 B-tree node at {addr:#x}")
        level, entries = head[5], struct.unpack_from("<H", head, 6)[0]
        body = self.read(addr + 24, entries * (key_size + 8) + key_size)
        out = []
        for i in range(entries):
            pos = i * (key_size + 8)
            child = struct.unpack_from("<Q", body, pos + key_size)[0]
            if level > 0:
                out += self._btree_children(child, node_type, key_size)
            elif node_type == 0:
                out.append(child)
            else:
                out.append((body[pos:pos + key_size], child))
        return out

    def chunk_index(self, btree: int, rank: int) -> list:
        """``(offsets, stored size, filter mask, address)`` of every chunk
        of a v1-B-tree chunked dataset."""
        out = []
        for key, child in self._btree_children(btree, 1, key_size=8 + 8 * (rank + 1)):
            size, mask = struct.unpack_from("<II", key)
            offsets = struct.unpack_from(f"<{rank}Q", key, 8)
            out.append((offsets, size, mask, child))
        return out


def _parse_space(buf: bytes, pos: int):
    """A dataspace message -> shape tuple, or None for a null space."""
    version, rank, flags = buf[pos], buf[pos + 1], buf[pos + 2]
    if version == 1:
        pos += 8
        kind = 1 if rank else 0
    elif version == 2:
        kind = buf[pos + 3]
        pos += 4
    else:
        raise UnsupportedFeature(f"dataspace message version {version}")
    if kind == 2:
        return None
    if flags & 0x02:
        raise UnsupportedFeature("dataspace permutation")
    return tuple(struct.unpack_from(f"<{rank}Q", buf, pos)) if kind == 1 else ()


def _parse_link(data: bytes):
    """A link message -> ``(name, object header address)`` of a hard link."""
    if data[0] != 1:
        raise UnsupportedFeature(f"link message version {data[0]}")
    flags, pos = data[1], 2
    link_type = 0
    if flags & 0x08:
        link_type = data[pos]
        pos += 1
    if flags & 0x04:
        pos += 8
    if flags & 0x10:
        pos += 1
    width = 1 << (flags & 3)
    length = int.from_bytes(data[pos:pos + width], "little")
    pos += width
    name = data[pos:pos + length].decode("utf-8")
    pos += length
    if link_type != 0:
        kind = {1: "soft link", 64: "external link"}.get(link_type, f"link type {link_type}")
        raise UnsupportedFeature(kind, name)
    return name, struct.unpack_from("<Q", data, pos)[0]


def _check_link_info(data: bytes):
    pos = 2 + (8 if data[1] & 1 else 0)
    if struct.unpack_from("<Q", data, pos)[0] != UNDEF:
        raise UnsupportedFeature("dense link storage (fractal heap and v2 B-tree)")


def _check_attribute_info(data: bytes):
    pos = 2 + (2 if data[1] & 1 else 0)
    if struct.unpack_from("<Q", data, pos)[0] != UNDEF:
        raise UnsupportedFeature("dense attribute storage (fractal heap and v2 B-tree)")


def _parse_fill(data: bytes):
    """Fill value message -> the fill value's bytes, or None."""
    version = data[0]
    if version in (1, 2):
        defined = data[3]
        if version == 1 or defined:
            size = struct.unpack_from("<I", data, 4)[0]
            return data[8:8 + size] if size else None
        return None
    if version == 3:
        if data[1] & 0x20:
            size = struct.unpack_from("<I", data, 2)[0]
            return data[6:6 + size]
        return None
    raise UnsupportedFeature(f"fill value message version {version}")


def _parse_filters(data: bytes) -> list:
    """Filter pipeline message -> filter ids in order of application."""
    version, count = data[0], data[1]
    pos = 8 if version == 1 else 2
    ids = []
    for _ in range(count):
        fid = struct.unpack_from("<H", data, pos)[0]
        if version == 1 or fid >= 256:
            name_len = struct.unpack_from("<H", data, pos + 2)[0]
            pos += 4
        else:
            name_len = 0
            pos += 2
        nvalues = struct.unpack_from("<H", data, pos + 2)[0]
        pos += 4 + name_len + 4 * nvalues
        if version == 1:
            pos += 4 * (nvalues % 2)
        if fid not in (1, 2):
            names = {3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset"}
            raise UnsupportedFeature(f"filter {names.get(fid, fid)}")
        ids.append(fid)
    if version not in (1, 2):
        raise UnsupportedFeature(f"filter pipeline message version {version}")
    return ids


def _unfilter(raw: bytes, filters: list, mask: int, itemsize: int) -> bytes:
    for i in reversed(range(len(filters))):
        if mask & (1 << i):
            continue
        if filters[i] == 1:
            raw = zlib.decompress(raw)
        else:  # shuffle: bytes grouped by position within an element
            n = len(raw) // itemsize
            body = np.frombuffer(raw, np.uint8, n * itemsize).reshape(itemsize, n)
            raw = body.T.tobytes() + raw[n * itemsize:]
    return raw


class _Layout:
    """Where a stored dataset's values are: compact bytes, a contiguous
    block, or chunks under a v1 B-tree."""

    def __init__(self, data: bytes, filters: list, fill):
        version, self.kind = data[0], data[1]
        self.filters, self.fill = filters, fill
        if version not in (3, 4):
            raise UnsupportedFeature(f"data layout message version {version}")
        if self.kind == 0:
            size = struct.unpack_from("<H", data, 2)[0]
            self.compact = data[4:4 + size]
        elif self.kind == 1:
            self.addr, self.size = struct.unpack_from("<QQ", data, 2)
        elif self.kind == 2:
            if version == 4:
                raise UnsupportedFeature(
                    "chunked layout version 4 (chunk index other than the v1 B-tree)"
                )
            rank = data[2] - 1
            self.addr = struct.unpack_from("<Q", data, 3)[0]
            self.chunk = struct.unpack_from(f"<{rank}I", data, 11)
        else:
            raise UnsupportedFeature("virtual dataset layout")
        if filters and self.kind != 2:
            raise FormatError("filters on a dataset that is not chunked")


class Dataset:
    """An HDF5 dataset, as much of ``h5py.Dataset`` as the port uses."""

    def __init__(self, file, name, parent, value: _Value = None):
        self.file, self._name, self._parent = file, name, parent
        self._attrs = {}
        self._value = value
        self._reader = self._layout = None
        if value is not None:
            self._type, self._shape = value.type, value.shape

    @classmethod
    def _stored(cls, file, name, parent, reader: _Reader, msgs) -> "Dataset":
        ds = cls(file, name, parent)
        by_type = {}
        for mtype, data in msgs:
            by_type.setdefault(mtype, data)
        if 0x03 not in by_type or 0x01 not in by_type:
            raise FormatError(f"dataset {name} without datatype or dataspace")
        ds._type, _ = _parse_type(by_type[0x03])
        ds._shape = _parse_space(by_type[0x01], 0)
        filters = _parse_filters(by_type[0x0B]) if 0x0B in by_type else []
        fill = _parse_fill(by_type[0x05]) if 0x05 in by_type else None
        ds._reader, ds._layout = reader, _Layout(by_type[0x08], filters, fill)
        return ds

    # -- h5py surface ------------------------------------------------------

    @property
    def name(self) -> str:
        return self._name

    @property
    def parent(self) -> "Group":
        return self._parent

    @property
    def attrs(self) -> "AttributeManager":
        return AttributeManager(self)

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self) -> np.dtype:
        return self._type.dtype

    def __len__(self) -> int:
        if not self._shape:
            raise TypeError("a scalar dataset has no length")
        return self._shape[0]

    def __array__(self, dtype=None, copy=None):
        array = np.asarray(self[()])
        return array if dtype is None else array.astype(dtype)

    def __repr__(self):
        return f'<Dataset "{self._name}": shape {self._shape}, type "{self.dtype.str}">'

    def __getitem__(self, key):
        whole = key is Ellipsis or (isinstance(key, tuple) and key == ())
        if self._shape is None:
            if whole:
                return Empty(self.dtype)
            raise ValueError("a null dataspace has no values")
        if not self._shape:
            if whole:
                return self._read_rows(None)[()]
            raise ValueError("a scalar dataset takes only [()]")
        key = key if isinstance(key, tuple) else (key,)
        if not key:
            key = (slice(None),)
        first, rest = key[0], key[1:]
        n = self._shape[0]
        if first is Ellipsis:
            first, rest = slice(None), key
        if isinstance(first, (int, np.integer)):
            index = int(first) + n if first < 0 else int(first)
            if not 0 <= index < n:
                raise IndexError(f"index {first} out of range for axis of {n}")
            block = self._read_rows(range(index, index + 1))[0]
            return block[rest] if rest else block
        if not isinstance(first, slice):
            raise TypeError(f"index {first!r}: only (), ..., an int or a slice")
        block = self._read_rows(range(*first.indices(n)))
        return block[(slice(None),) + rest] if rest else block

    # -- reading ------------------------------------------------------------

    def _read_rows(self, rows):
        """The values of ``rows`` of axis 0 (all of a scalar for None),
        read from the file only where they lie."""
        if self._value is not None:
            array = self._value.array
            return array if rows is None else array[np.asarray(rows, dtype=np.int64)]
        if self._reader is None or self.file._closed:
            raise ValueError(f"dataset {self._name}: the file is closed")
        row_shape = self._shape[1:] if rows is not None else ()
        nrows = 1 if rows is None else len(rows)
        stored = np.empty((nrows,) + tuple(row_shape), dtype=self._type.storage)
        layout = self._layout
        if stored.size:
            if layout.kind == 0:
                flat = np.frombuffer(layout.compact, self._type.storage)
                full = flat.reshape(self._shape)
                stored[...] = full if rows is None else full[np.asarray(rows, np.int64)]
            elif layout.kind == 1:
                self._read_contiguous(stored, rows)
            else:
                self._read_chunked(stored, rows)
        values = self._reader.values(stored.reshape(-1), self._type).reshape(stored.shape)
        return values.reshape(values.shape[1:]) if rows is None else values

    def _fill(self, out: np.ndarray):
        fill = self._layout.fill
        if fill is None or self._type.kind == "vstr":
            out[...] = np.zeros((), out.dtype)
        else:
            out[...] = np.frombuffer(fill, out.dtype, 1)[0]

    def _read_contiguous(self, out: np.ndarray, rows):
        layout = self._layout
        if layout.addr == UNDEF:
            self._fill(out)
            return
        if rows is None:
            self._reader.read_into(layout.addr, out)
            return
        row_bytes = out[0].nbytes
        rows = list(rows)
        start = 0
        while start < len(rows):  # runs of consecutive rows in one read each
            end = start + 1
            while end < len(rows) and rows[end] == rows[end - 1] + 1:
                end += 1
            self._reader.read_into(layout.addr + rows[start] * row_bytes, out[start:end])
            start = end

    def _read_chunked(self, out: np.ndarray, rows):
        layout, shape = self._layout, self._shape
        chunk = layout.chunk
        storage = self._type.storage
        wanted = np.arange(1) if rows is None else np.asarray(rows, dtype=np.int64)
        self._fill(out)
        if layout.addr == UNDEF:
            return
        need = set((wanted // chunk[0]).tolist()) if shape else {0}
        position = {int(r): i for i, r in enumerate(wanted)}
        for offsets, size, mask, addr in self._reader.chunk_index(layout.addr, len(shape)):
            if shape and offsets[0] // chunk[0] not in need:
                continue
            raw = _unfilter(self._reader.read(addr, size), layout.filters, mask, storage.itemsize)
            block = np.frombuffer(raw, storage, int(np.prod(chunk))).reshape(chunk)
            if not shape:
                out[...] = block.reshape(out.shape)
                continue
            inner = tuple(
                slice(0, min(c, s - o)) for c, s, o in zip(chunk[1:], shape[1:], offsets[1:])
            )
            dest = tuple(
                slice(o, min(o + c, s)) for c, s, o in zip(chunk[1:], shape[1:], offsets[1:])
            )
            for r in range(offsets[0], min(offsets[0] + chunk[0], shape[0])):
                i = position.get(r)
                if i is not None:
                    out[(i,) + dest] = block[(r - offsets[0],) + inner]

    def _stored_value(self) -> _Value:
        """All values, for a rewrite of the file."""
        if self._value is not None:
            return self._value
        if self._shape is None:
            return _Value(None, self._type, None)
        array = self._read_rows(None if not self._shape else range(self._shape[0]))
        return _Value(np.ascontiguousarray(array), self._type, self._shape)


class AttributeManager:
    """``obj.attrs``: the attributes of a group or dataset, by name."""

    def __init__(self, obj):
        self._obj = obj

    def _store(self) -> dict:
        return self._obj._attrs

    def __getitem__(self, name):
        return self._store()[name].h5py_view(strings_as_str=True)

    def __setitem__(self, name, value):
        self._obj.file._check_writable()
        self._store()[name] = _Value.of(value)

    def __contains__(self, name) -> bool:
        return name in self._store()

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._store())

    def keys(self) -> list:
        return sorted(self._store())

    def items(self) -> list:
        return [(k, self[k]) for k in self.keys()]

    def get(self, name, default=None):
        return self[name] if name in self._store() else default


class Group:
    """An HDF5 group, as much of ``h5py.Group`` as the port uses. Members
    iterate by name, as h5py lists a group's members."""

    def __init__(self, file, name, parent):
        self.file, self._name, self._parent = file, name, parent
        self._attrs = {}
        # name -> Group/Dataset, or (address,) until first looked at
        self._children = {}

    @property
    def name(self) -> str:
        return self._name

    @property
    def parent(self) -> "Group":
        return self._parent if self._parent is not None else self

    @property
    def attrs(self) -> AttributeManager:
        return AttributeManager(self)

    def _path(self, name: str) -> str:
        return f"{self._name.rstrip('/')}/{name}"

    def _child(self, name: str):
        node = self._children[name]
        if isinstance(node, tuple):
            node = self.file._reader.load(node[0], self.file, self._path(name), self)
            self._children[name] = node
        return node

    def _walk(self, path: str, create: bool = False):
        """The group holding the last part of ``path``, and that part."""
        group = self.file if path.startswith("/") else self
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise ValueError(f"empty name {path!r}")
        for part in parts[:-1]:
            if part not in group._children:
                if not create:
                    raise KeyError(f"no object {path!r} in {self._name}")
                group._children[part] = Group(group.file, group._path(part), group)
            group = group._child(part)
            if not isinstance(group, Group):
                raise KeyError(f"{part!r} in {path!r} is not a group")
        return group, parts[-1]

    def __getitem__(self, path: str):
        if path == "/":
            return self.file
        group, last = self._walk(path)
        if last not in group._children:
            raise KeyError(f"no object {path!r} in {self._name}")
        return group._child(last)

    def __contains__(self, path) -> bool:
        try:
            self[path]
        except (KeyError, ValueError):
            return False
        return True

    def get(self, path: str, default=None):
        return self[path] if path in self else default

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._children)

    def keys(self) -> list:
        return sorted(self._children)

    def items(self) -> list:
        return [(k, self._child(k)) for k in self.keys()]

    def visititems(self, func):
        """``func(relative name, object)`` for every object below this
        group, by name and parents first, as h5py visits them; stops at
        the first result that is not None and returns it."""
        for key in self.keys():
            obj = self._child(key)
            result = func(key, obj)
            if result is not None:
                return result
            if isinstance(obj, Group):
                result = obj.visititems(lambda n, o, _k=key: func(f"{_k}/{n}", o))
                if result is not None:
                    return result
        return None

    def create_group(self, path: str) -> "Group":
        self.file._check_writable()
        group, last = self._walk(path, create=True)
        if last in group._children:
            raise ValueError(f"name {path!r} already exists")
        node = Group(group.file, group._path(last), group)
        group._children[last] = node
        return node

    def create_dataset(self, path: str, data=None, dtype=None) -> Dataset:
        self.file._check_writable()
        if data is None:
            raise TypeError("create_dataset needs data")
        group, last = self._walk(path, create=True)
        if last in group._children:
            raise ValueError(f"name {path!r} already exists")
        node = Dataset(group.file, group._path(last), group, _Value.of(data, dtype))
        group._children[last] = node
        return node

    def __setitem__(self, path: str, value):
        self.create_dataset(path, data=value)

    def __repr__(self):
        return f'<Group "{self._name}" ({len(self)} members)>'


class File(Group):
    """An HDF5 file: ``"r"`` reads, ``"w"`` creates (truncating), ``"a"``
    reads and writes, creating the file if it is missing. Written files
    reach the disk when the file closes."""

    def __init__(self, path, mode: str = "r"):
        if mode not in ("r", "w", "a"):
            raise ValueError(f"mode must be 'r', 'w' or 'a', not {mode!r}")
        super().__init__(self, "/", None)
        self.filename = os.fspath(path)
        self.mode = mode
        self._closed = False
        self._reader = self._fh = self._tmp = None
        if mode == "w" or (mode == "a" and not os.path.exists(self.filename)):
            self._open_tmp()
            return
        self._fh = open(self.filename, "rb")
        try:
            self._reader = _Reader(self._fh)
            root = self._reader.load(self._reader.root_addr, self, "/", None)
            if not isinstance(root, Group):
                raise FormatError("the root object is not a group")
        except Exception:
            self._fh.close()
            raise
        self._children, self._attrs = root._children, root._attrs
        if mode == "a":
            self._open_tmp()

    def _open_tmp(self):
        path = Path(self.filename)
        self._tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        open(self._tmp, "wb").close()  # fails now if the folder is missing

    def _check_writable(self):
        if self._closed:
            raise ValueError("the file is closed")
        if self.mode == "r":
            raise ValueError(f"{self.filename} is open read-only")

    def close(self):
        if self._closed:
            return
        try:
            if self._tmp is not None:
                try:
                    _write(self, self._tmp)
                    os.replace(self._tmp, self.filename)
                except BaseException:
                    os.unlink(self._tmp)
                    raise
        finally:
            self._closed = True
            if self._fh is not None:
                self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __repr__(self):
        state = "closed" if self._closed else f"mode {self.mode}"
        return f'<HDF5 file "{os.path.basename(self.filename)}" ({state})>'


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

_HEADER_CHUNK = 4096  # message bytes in one object header chunk
_GROUP_LEAF_K, _GROUP_NODE_K = 4, 16
_SNOD_SIZE = 8 + 2 * _GROUP_LEAF_K * 40
_BTREE_SIZE = 24 + 2 * _GROUP_NODE_K * 8 + (2 * _GROUP_NODE_K + 1) * 8
_MIN_COLLECTION = 4096


class _Image:
    """A file image being laid out: pieces placed at increasing
    addresses, written in one pass."""

    def __init__(self):
        self.pieces = {}  # address -> bytes or ndarray, in order of address
        self.eof = 0

    def alloc(self, size: int, content=None) -> int:
        addr = _pad8(self.eof)
        self.eof = addr + size
        self.pieces[addr] = content
        return addr

    def set(self, addr: int, content):
        self.pieces[addr] = content

    def write(self, fh):
        pos = 0
        for addr, content in self.pieces.items():
            if addr > pos:
                fh.write(bytes(addr - pos))
            view = memoryview(content.reshape(-1).view(np.uint8)) if isinstance(
                content, np.ndarray
            ) else memoryview(content)
            fh.write(view)
            pos = addr + len(view)
        if self.eof > pos:
            fh.write(bytes(self.eof - pos))


def _write(root: File, path) -> None:
    image = _Image()
    superblock = image.alloc(96)
    addr, btree, heap = _write_group(image, root)
    entry = struct.pack("<QQII", 0, addr, 1, 0) + struct.pack("<QQ", btree, heap)
    head = SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0]) + struct.pack(
        "<HHI", _GROUP_LEAF_K, _GROUP_NODE_K, 0
    )
    image.set(superblock, head + struct.pack("<QQQQ", 0, UNDEF, image.eof, UNDEF) + entry)
    with open(path, "wb") as fh:
        image.write(fh)


def _space_message(shape) -> bytes:
    if shape is None:
        return struct.pack("<BBBB", 2, 0, 0, 2)
    rank = len(shape)
    dims = struct.pack(f"<{rank}Q", *shape)
    return struct.pack("<BBBB4x", 1, rank, 1 if rank else 0, 0) + dims + (dims if rank else b"")


def _encode_values(image: _Image, value: _Value):
    """The bytes of ``value`` in the file, a variable-length string's in
    a global heap collection written now."""
    if value.type.kind != "vstr":
        array = value.array
        if value.type.kind == "bool":
            array = array.astype(np.int8)
        return np.ascontiguousarray(array, dtype=value.type.storage)
    strings = list(value.array.flat)
    objects = b"".join(
        struct.pack("<HH4xQ", i + 1, 1, len(s)) + s + bytes(_pad8(len(s)) - len(s))
        for i, s in enumerate(strings)
    )
    size = max(_MIN_COLLECTION, 16 + len(objects) + 16)
    free = size - 16 - len(objects)
    collection = (
        b"GCOL" + bytes([1, 0, 0, 0]) + struct.pack("<Q", size) + objects
        + struct.pack("<HH4xQ", 0, 0, free) + bytes(free - 16)
    )
    addr = image.alloc(size, collection)
    refs = np.zeros(len(strings), value.type.storage)
    refs["len"] = [len(s) for s in strings]
    refs["addr"] = addr
    refs["index"] = np.arange(1, len(strings) + 1)
    return refs


def _attribute_message(image: _Image, name: str, value: _Value) -> bytes:
    raw_name = name.encode("utf-8") + b"\0"
    dtype = value.type.encode()
    space = _space_message(value.shape)
    data = b"" if value.shape is None else _encode_values(image, value).tobytes()

    def padded(b):
        return b + bytes(_pad8(len(b)) - len(b))

    return struct.pack("<BBHHH", 1, 0, len(raw_name), len(dtype), len(space)) + (
        padded(raw_name) + padded(dtype) + padded(space) + data
    )


def _write_header(image: _Image, messages: list, attrs: dict) -> int:
    """Lay out a v1 object header of ``messages`` (type, bytes) and the
    attribute messages of ``attrs``, split into continuation blocks."""
    msgs = list(messages)
    for name in sorted(attrs):
        data = _attribute_message(image, name, attrs[name])
        if len(data) > 0xFFFF:
            raise UnsupportedFeature(
                f"attribute {name!r} of {len(data)} bytes (more than 64 KiB needs "
                "dense attribute storage)"
            )
        msgs.append((0x0C, data))
    chunks, size = [[]], [0]
    for mtype, data in msgs:
        need = 8 + _pad8(len(data))
        if chunks[-1] and size[-1] + need + 24 > _HEADER_CHUNK:
            chunks.append([])
            size.append(0)
        chunks[-1].append((mtype, data))
        size[-1] += need
    for i in range(len(chunks) - 1):
        size[i] += 24
    addrs = [image.alloc(16 + size[0])] + [image.alloc(s) for s in size[1:]]
    count = len(msgs) + len(chunks) - 1
    for i, chunk in enumerate(chunks):
        if i + 1 < len(chunks):
            chunk = chunk + [(0x10, struct.pack("<QQ", addrs[i + 1], size[i + 1]))]
        body = b"".join(
            struct.pack("<HHB3x", mtype, _pad8(len(data)), 1 if mtype in (0x03, 0x05) else 0)
            + data + bytes(_pad8(len(data)) - len(data))
            for mtype, data in chunk
        )
        if i == 0:
            body = struct.pack("<BBHII4x", 1, 0, count, 1, size[0]) + body
        image.set(addrs[i], body)
    return addrs[0]


def _write_dataset(image: _Image, ds: Dataset) -> int:
    value = ds._stored_value()
    if value.shape is None:
        addr, nbytes = UNDEF, 0
    else:
        data = _encode_values(image, value)
        nbytes = data.nbytes
        addr = image.alloc(nbytes, data) if nbytes else UNDEF
    fill = struct.pack("<BBBB", 2, 2, 2, 1) + struct.pack("<I", 0)
    layout = struct.pack("<BBQQ", 3, 1, addr, nbytes)
    return _write_header(
        image,
        [(0x01, _space_message(value.shape)), (0x03, value.type.encode()),
         (0x05, fill), (0x08, layout)],
        ds._attrs,
    )


def _write_group(image: _Image, group: Group):
    """-> (object header, B-tree and local heap addresses)."""
    entries = []
    for name in group.keys():  # sorted: the B-tree's keys and lookups need it
        child = group._child(name)
        if isinstance(child, Group):
            addr, btree, heap = _write_group(image, child)
            scratch = struct.pack("<QQ", btree, heap)
            entries.append((name, struct.pack("<QII", addr, 1, 0) + scratch))
        else:
            addr = _write_dataset(image, child)
            entries.append((name, struct.pack("<QII", addr, 0, 0) + bytes(16)))
    # local heap: "" at offset 0, then each name null-terminated, 8-aligned
    segment, offsets = bytearray(8), []
    for name, _ in entries:
        offsets.append(len(segment))
        raw = name.encode("utf-8") + b"\0"
        segment += raw + bytes(_pad8(len(raw)) - len(raw))
    heap = image.alloc(32)
    seg_addr = image.alloc(len(segment), bytes(segment))
    image.set(heap, b"HEAP" + bytes(4) + struct.pack("<QQQ", len(segment), 1, seg_addr))
    # symbol table nodes of up to 2K entries, then B-tree levels of up to
    # 2K children; a node's key i is the largest name below child i - 1
    nodes = []  # (address, offset of the node's largest name)
    per = 2 * _GROUP_LEAF_K
    for start in range(0, len(entries), per):
        part = entries[start:start + per]
        body = b"".join(
            struct.pack("<Q", offsets[start + i]) + entry for i, (_, entry) in enumerate(part)
        )
        node = b"SNOD" + struct.pack("<BBH", 1, 0, len(part)) + body
        nodes.append((image.alloc(_SNOD_SIZE, node + bytes(_SNOD_SIZE - len(node))),
                      offsets[start + len(part) - 1]))
    level = 0
    while True:
        groups = [nodes[i:i + 2 * _GROUP_NODE_K] for i in range(0, len(nodes), 2 * _GROUP_NODE_K)]
        groups = groups or [[]]
        addrs = [image.alloc(_BTREE_SIZE) for _ in groups]
        parents, left_key = [], 0
        for j, children in enumerate(groups):
            left = addrs[j - 1] if j else UNDEF
            right = addrs[j + 1] if j + 1 < len(groups) else UNDEF
            body = struct.pack("<Q", left_key)
            for child, key in children:
                body += struct.pack("<QQ", child, key)
            node = b"TREE" + struct.pack("<BBHQQ", 0, level, len(children), left, right) + body
            image.set(addrs[j], node + bytes(_BTREE_SIZE - len(node)))
            if children:
                left_key = children[-1][1]
            parents.append((addrs[j], left_key))
        if len(parents) == 1:
            btree = parents[0][0]
            break
        nodes, level = parents, level + 1
    header = _write_header(image, [(0x11, struct.pack("<QQ", btree, heap))], group._attrs)
    return header, btree, heap
