"""A reader of the HDF5 subset that Athena++ and h5py's default layout
write, in numpy and ``struct`` alone.

The port reads ``.athdf`` snapshots on machines without h5py, as the
reference binary does with its own parser (hdf5_format_*.cpp). Covered,
from the HDF5 file-format specification:

- superblock version 0 or 1 (8-byte offsets and lengths);
- version 1 object headers, with continuation blocks;
- old-style groups: a symbol-table message, its version 1 B-tree of
  symbol-table nodes and the local heap that holds the link names;
- datasets with a contiguous (or compact) layout and no filters;
- fixed-point, floating-point and fixed-length string datatypes;
- scalar and simple dataspaces;
- attributes, message versions 1 to 3.

Anything else (version 2 object headers, chunked or filtered data,
variable-length strings, shared messages, links of the new-style group)
raises ``HDF5Error``. This is a loader only: it writes nothing.
"""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEFINED = 0xFFFFFFFFFFFFFFFF

# Object header message types (specification section IV.A.2)
_MSG_DATASPACE = 0x0001
_MSG_DATATYPE = 0x0003
_MSG_LAYOUT = 0x0008
_MSG_FILTERS = 0x000B
_MSG_ATTRIBUTE = 0x000C
_MSG_CONTINUATION = 0x0010
_MSG_SYMBOL_TABLE = 0x0011
_MSG_LINK = 0x0006
_MSG_LINK_INFO = 0x0002


class HDF5Error(ValueError):
    """The file is not HDF5, or uses a feature outside the subset."""


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class _Reader:
    """Byte access with the file's offset and length sizes."""

    def __init__(self, data: bytes):
        self.data = data
        if data[:8] != _SIGNATURE:
            raise HDF5Error("not an HDF5 file (bad signature)")
        version = data[8]
        if version not in (0, 1):
            raise HDF5Error(f"superblock version {version} is not supported")
        self.size_offsets = data[13]
        self.size_lengths = data[14]
        if self.size_offsets != 8 or self.size_lengths != 8:
            raise HDF5Error("only 8-byte offsets and lengths are supported")
        # version 0: 24 bytes of fixed fields; version 1 adds 4 more
        pos = 24 if version == 0 else 28
        if self.u64(pos) != 0:
            raise HDF5Error("a non-zero base address is not supported")
        pos += 32  # base, free-space and end-of-file addresses, and one unused
        # root group symbol table entry
        self.root_header = self.u64(pos + 8)

    def u8(self, pos):
        return self.data[pos]

    def u16(self, pos):
        return struct.unpack_from("<H", self.data, pos)[0]

    def u32(self, pos):
        return struct.unpack_from("<I", self.data, pos)[0]

    def u64(self, pos):
        return struct.unpack_from("<Q", self.data, pos)[0]

    def cstring(self, pos) -> str:
        end = self.data.index(b"\0", pos)
        return self.data[pos:end].decode()


def _object_messages(f: _Reader, address: int) -> list:
    """(type, body bytes) of every message of the version 1 object header
    at ``address``, continuation blocks included."""
    if f.u8(address) != 1:
        raise HDF5Error(f"object header version {f.u8(address)} at "
                        f"{address} is not supported")
    count = f.u16(address + 2)
    size = f.u32(address + 8)
    blocks = [(address + 16, size)]  # the 12-byte prefix is padded to 16
    messages = []
    while blocks and len(messages) < count:
        pos, size = blocks.pop(0)
        end = pos + size
        while pos + 8 <= end and len(messages) < count:
            mtype, msize, flags = f.u16(pos), f.u16(pos + 2), f.u8(pos + 4)
            body = f.data[pos + 8:pos + 8 + msize]
            if flags & 0x02:
                raise HDF5Error("shared object header messages are not "
                                "supported")
            if mtype == _MSG_CONTINUATION:
                blocks.append(struct.unpack_from("<QQ", body))
            messages.append((mtype, body))
            pos += 8 + msize
    return messages


def _datatype(body: bytes, pos: int = 0):
    """numpy dtype of a datatype message at ``body[pos:]``."""
    class_version = body[pos]
    cls = class_version & 0x0F
    bits = body[pos + 1]
    size = struct.unpack_from("<I", body, pos + 4)[0]
    if cls == 0:  # fixed-point
        order = ">" if bits & 0x01 else "<"
        kind = "i" if bits & 0x08 else "u"
        return np.dtype(f"{order}{kind}{size}")
    if cls == 1:  # floating-point (IEEE)
        order = ">" if bits & 0x01 else "<"
        if size not in (2, 4, 8):
            raise HDF5Error(f"{size}-byte floats are not supported")
        return np.dtype(f"{order}f{size}")
    if cls == 3:  # fixed-length string
        return np.dtype(f"S{size}")
    raise HDF5Error(f"datatype class {cls} is not supported")


def _dataspace(body: bytes, pos: int = 0) -> tuple:
    """Shape of a dataspace message at ``body[pos:]`` (() for a scalar)."""
    version, rank, flags = body[pos], body[pos + 1], body[pos + 2]
    if version == 1:
        dims_at = pos + 8
    elif version == 2:
        if body[pos + 3] == 2:
            raise HDF5Error("null dataspaces are not supported")
        dims_at = pos + 4
    else:
        raise HDF5Error(f"dataspace version {version} is not supported")
    del flags  # the maximum dimensions that may follow are not needed
    return tuple(struct.unpack_from(f"<{rank}Q", body, dims_at))


def _attribute(body: bytes):
    """(name, numpy value) of an attribute message."""
    version = body[0]
    name_size, type_size, space_size = struct.unpack_from("<HHH", body, 2)
    if version == 1:
        pos = 8
        name = body[pos:pos + name_size]
        pos += _pad8(name_size)
        dtype = _datatype(body, pos)
        pos += _pad8(type_size)
        shape = _dataspace(body, pos)
        pos += _pad8(space_size)
    elif version in (2, 3):
        pos = 8 if version == 2 else 9
        name = body[pos:pos + name_size]
        pos += name_size
        dtype = _datatype(body, pos)
        pos += type_size
        shape = _dataspace(body, pos)
        pos += space_size
    else:
        raise HDF5Error(f"attribute message version {version} is not "
                        "supported")
    count = int(np.prod(shape, dtype=np.int64))
    value = np.frombuffer(body, dtype=dtype, count=count, offset=pos)
    value = value.reshape(shape).astype(dtype.newbyteorder("="))
    return name.rstrip(b"\0").decode(), value[()] if shape == () else value


def _layout(body: bytes) -> tuple:
    """("contiguous", address, size) or ("compact", bytes)."""
    version = body[0]
    if version == 3:
        cls = body[1]
        if cls == 0:
            size = struct.unpack_from("<H", body, 2)[0]
            return "compact", body[4:4 + size]
        if cls == 1:
            address, size = struct.unpack_from("<QQ", body, 2)
            return "contiguous", address, size
    elif version in (1, 2):
        rank, cls = body[1], body[2]
        if cls == 1:
            address = struct.unpack_from("<Q", body, 8)[0]
            return "contiguous", address, None
        if cls == 0:
            size = struct.unpack_from("<I", body, 8 + 4 * rank)[0]
            at = 12 + 4 * rank
            return "compact", body[at:at + size]
    else:
        raise HDF5Error(f"layout message version {version} is not supported")
    raise HDF5Error("only contiguous and compact datasets are supported")


class Node:
    """A group or dataset of the file: ``attrs`` (name -> numpy value);
    a group also has ``children`` (name -> Node), a dataset ``dtype``,
    ``shape`` and ``read()``."""

    def __init__(self, f: _Reader, address: int):
        self._f = f
        self.attrs: Dict[str, np.ndarray] = {}
        self.children: Dict[str, Node] = {}
        self.dtype = None
        self.shape = None
        self._layout = None
        symbol_table = None
        for mtype, body in _object_messages(f, address):
            if mtype == _MSG_ATTRIBUTE:
                name, value = _attribute(body)
                self.attrs[name] = value
            elif mtype == _MSG_DATATYPE:
                self.dtype = _datatype(body)
            elif mtype == _MSG_DATASPACE:
                self.shape = _dataspace(body)
            elif mtype == _MSG_LAYOUT:
                self._layout = _layout(body)
            elif mtype == _MSG_FILTERS:
                raise HDF5Error("filtered (compressed) datasets are not "
                                "supported")
            elif mtype == _MSG_SYMBOL_TABLE:
                symbol_table = struct.unpack_from("<QQ", body)
            elif mtype in (_MSG_LINK, _MSG_LINK_INFO):
                raise HDF5Error("new-style groups are not supported")
        if symbol_table is not None:
            self._read_group(*symbol_table)

    @property
    def is_dataset(self) -> bool:
        return self._layout is not None

    def _read_group(self, btree: int, heap: int) -> None:
        f = self._f
        if f.data[heap:heap + 4] != b"HEAP":
            raise HDF5Error("bad local heap signature")
        heap_data = f.u64(heap + 24)
        for entry in self._symbol_entries(btree):
            name = f.cstring(heap_data + f.u64(entry))
            self.children[name] = Node(f, f.u64(entry + 8))

    def _symbol_entries(self, node: int) -> list:
        """Addresses of the symbol-table entries under B-tree ``node``."""
        f = self._f
        if f.data[node:node + 4] != b"TREE" or f.u8(node + 4) != 0:
            raise HDF5Error("bad group B-tree node")
        level, used = f.u8(node + 5), f.u16(node + 6)
        entries = []
        # keys and children alternate after the two sibling addresses,
        # starting with key 0 (8-byte heap offsets for group nodes)
        pos = node + 24 + 8
        for _ in range(used):
            child = f.u64(pos)
            if level > 0:
                entries += self._symbol_entries(child)
            else:
                if f.data[child:child + 4] != b"SNOD":
                    raise HDF5Error("bad symbol-table node")
                n_symbols = f.u16(child + 6)
                entries += [child + 8 + 40 * s for s in range(n_symbols)]
            pos += 16
        return entries

    def read(self) -> np.ndarray:
        """The dataset's values in native byte order."""
        if not self.is_dataset:
            raise HDF5Error("a group has no values")
        count = int(np.prod(self.shape, dtype=np.int64))
        if self._layout[0] == "compact":
            raw = self._layout[1]
            out = np.frombuffer(raw, dtype=self.dtype, count=count)
        else:
            address = self._layout[1]
            if address == _UNDEFINED:  # never written: the fill value 0
                out = np.zeros(count, dtype=self.dtype)
            else:
                out = np.frombuffer(self._f.data, dtype=self.dtype,
                                    count=count, offset=address)
        return out.reshape(self.shape).astype(self.dtype.newbyteorder("="))

    def __getitem__(self, name: str) -> "Node":
        return self.children[name]

    def __contains__(self, name: str) -> bool:
        return name in self.children


def read_file(path: str) -> Node:
    """The root group of the HDF5 file at ``path``."""
    with open(path, "rb") as fobj:
        data = fobj.read()
    f = _Reader(data)
    return Node(f, f.root_header)
