"""A reader and a writer of the HDF5 subset that Keras 2 weight files use,
in `struct` and numpy only (the port reads `model.h5` files without h5py).

Keras 2 writes its weights through h5py with the default
`libver="earliest"`, which gives the original file format:

  * superblock version 0 at offset 0, 8-byte offsets and lengths;
  * version-1 object headers: a 16-byte prefix, then messages whose sizes
    are multiples of 8, chained through continuation messages (0x10);
  * old-style groups: a symbol-table message (0x11) naming a version-1
    B-tree of type 0, whose leaves are symbol-table nodes (`SNOD`) of
    entries that name their children through a local heap (`HEAP`);
  * version-1 dataspaces (0x01, scalar or simple), datatypes (0x03:
    fixed-length strings, little-endian IEEE float32 and float64, and
    integers), data layout version 3 (0x08, contiguous or compact) and
    version-1 attributes (0x0C: name, datatype and dataspace each padded
    to 8 bytes).

`File(path)` reads such a file: `f["a/b:0"]` is a `Group` or a `Dataset`,
path components separated by `/`; `.attrs` maps attribute names to numpy
arrays (a scalar dataspace gives a numpy scalar), each decoded when read;
`np.asarray(dataset)` or `dataset[()]` reads the data.  Anything outside
the subset (a filter pipeline, chunked or external storage,
variable-length types, big-endian types, shared messages, new-style groups
or superblock versions 2 and 3, which `libver="latest"` writes) raises
ValueError naming the feature; it is never misread.  (h5py 3 writes a
bytes attribute as a variable-length string: the committed model files'
root `backend` and `keras_version` are such, and nothing reads them.)

`Writer(path)` writes the same subset: superblock 0, every group a symbol
table with a one-level B-tree over `SNOD`s of at most 8 entries (2 x group
leaf K), sorted by name bytes, so a group holds at most 32 x 8 = 256
entries (2 x group internal K nodes); fixed-length string and float
attributes; contiguous float datasets.  Names with `/` create the
intermediate groups, as h5py does."""

from __future__ import annotations

import struct
from collections.abc import Mapping
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFFFFFFFFFFFFFF

# Message types of a version-1 object header.
MSG_NIL = 0x00
MSG_DATASPACE = 0x01
MSG_LINK_INFO = 0x02
MSG_DATATYPE = 0x03
MSG_LINK = 0x06
MSG_EXTERNAL = 0x07
MSG_LAYOUT = 0x08
MSG_GROUP_INFO = 0x0A
MSG_FILTERS = 0x0B
MSG_ATTRIBUTE = 0x0C
MSG_CONTINUATION = 0x10
MSG_SYMBOL_TABLE = 0x11
MSG_ATTRIBUTE_INFO = 0x15

# What this module refuses, by message type.
_REFUSED = {
    MSG_LINK_INFO: "link-info messages (new-style groups, libver='latest')",
    MSG_LINK: "link messages (new-style groups, libver='latest')",
    MSG_GROUP_INFO: "group-info messages (new-style groups, "
                    "libver='latest')",
    MSG_ATTRIBUTE_INFO: "attribute-info messages (dense attribute storage)",
    MSG_EXTERNAL: "external data storage",
}

# IEEE layouts: size -> (precision, exponent location, exponent size,
# mantissa location, mantissa size, exponent bias, sign location).
_IEEE = {4: (32, 23, 8, 0, 23, 127, 31), 8: (64, 52, 11, 0, 52, 1023, 63)}

LEAF_K = 4          # a symbol-table node holds 2 x LEAF_K entries
INTERNAL_K = 16     # a B-tree node holds 2 x INTERNAL_K children
_SNOD_ENTRIES = 2 * LEAF_K
_MAX_ENTRIES = 2 * INTERNAL_K * _SNOD_ENTRIES


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# -- reading ------------------------------------------------------------------


def _parse_datatype(data: bytes) -> np.dtype:
    cls, version = data[0] & 0x0F, data[0] >> 4
    bits = data[1] | data[2] << 8 | data[3] << 16
    size = struct.unpack_from("<I", data, 4)[0]
    if version not in (1, 2, 3):
        raise ValueError(f"datatype message version {version}")
    if cls == 0:                                    # fixed point
        if bits & 1:
            raise ValueError("big-endian integer datatype")
        offset, precision = struct.unpack_from("<HH", data, 8)
        if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
            raise ValueError(f"integer datatype of {size} bytes with "
                             f"{precision} bits at offset {offset}")
        return np.dtype(f"<{'i' if bits & 8 else 'u'}{size}")
    if cls == 1:                                    # floating point
        if bits & 1 or bits & 0x40:
            raise ValueError("big-endian (or VAX) float datatype")
        offset, prec, eloc, esize, mloc, msize, bias = struct.unpack_from(
            "<HHBBBBI", data, 8)
        sign = (bits >> 8) & 0xFF
        if size not in _IEEE or offset or (
                prec, eloc, esize, mloc, msize, bias, sign) != _IEEE[size]:
            raise ValueError(f"non-IEEE float datatype of {size} bytes")
        return np.dtype(f"<f{size}")
    if cls == 3:                                    # fixed-length string
        return np.dtype(f"S{size}")
    if cls == 9:
        raise ValueError("variable-length datatype (variable-length "
                         "strings or sequences)")
    raise ValueError(f"datatype class {cls}")


def _parse_dataspace(data: bytes) -> Tuple[int, ...]:
    """A version-1 dataspace's dimensions (rank 0: scalar)."""
    if data[0] != 1:
        raise ValueError(f"dataspace message version {data[0]}")
    return struct.unpack_from(f"<{data[1]}Q", data, 8)


def _array(raw: bytes, dtype: np.dtype, shape: Tuple[int, ...]):
    n = int(np.prod(shape, dtype=np.int64))
    if len(raw) < n * dtype.itemsize:
        raise ValueError(f"{len(raw)} bytes of data for {n} elements of "
                         f"{dtype}")
    arr = np.frombuffer(raw, dtype, count=n).reshape(shape).copy()
    return arr[()] if shape == () else arr


def _attribute_name(data: bytes) -> str:
    if data[0] != 1:
        raise ValueError(f"attribute message version {data[0]}")
    name_size = struct.unpack_from("<H", data, 2)[0]
    return bytes(data[8:8 + name_size]).split(b"\0", 1)[0].decode()


def _parse_attribute(data: bytes) -> object:
    """A version-1 attribute's value: name, datatype and dataspace each
    padded to 8 bytes, then the data."""
    name_size, dt_size, ds_size = struct.unpack_from("<HHH", data, 2)
    p = 8 + _pad8(name_size)
    dtype = _parse_datatype(data[p:p + dt_size])
    p += _pad8(dt_size)
    shape = _parse_dataspace(data[p:p + ds_size])
    p += _pad8(ds_size)
    return _array(data[p:], dtype, shape)


class _Attributes(Mapping):
    """An object's attributes in name order (as h5py lists them); each
    value is decoded when it is read, so an attribute outside the subset
    raises only when asked for."""

    def __init__(self, messages: List[bytes]):
        raw = {_attribute_name(d): d for d in messages}
        self._raw = {k: raw[k] for k in sorted(raw, key=str.encode)}

    def __getitem__(self, name: str) -> object:
        return _parse_attribute(self._raw[name])

    def __iter__(self) -> Iterator[str]:
        return iter(self._raw)

    def __len__(self) -> int:
        return len(self._raw)


class _Object:
    """An object header's messages, read on first use."""

    def __init__(self, file: "File", address: int, name: str):
        self._file = file
        self._address = address
        self.name = name
        self._msgs: Optional[List[Tuple[int, bytes]]] = None

    def _messages(self) -> List[Tuple[int, bytes]]:
        if self._msgs is None:
            self._msgs = self._file._read_header(self._address)
        return self._msgs

    def _find(self, mtype: int) -> Optional[bytes]:
        for t, data in self._messages():
            if t == mtype:
                return data
        return None

    @property
    def attrs(self) -> "_Attributes":
        return _Attributes([d for t, d in self._messages()
                            if t == MSG_ATTRIBUTE])


class Dataset(_Object):
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(_parse_dataspace(self._find(MSG_DATASPACE)))

    @property
    def dtype(self) -> np.dtype:
        return _parse_datatype(self._find(MSG_DATATYPE))

    def read(self) -> np.ndarray:
        if self._find(MSG_FILTERS) is not None:
            raise ValueError(f"{self.name}: a filter pipeline (compression "
                             f"or other filters) is not supported")
        layout = self._find(MSG_LAYOUT)
        if layout[0] != 3:
            raise ValueError(f"{self.name}: data layout message version "
                             f"{layout[0]}")
        dtype, shape = self.dtype, self.shape
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if layout[1] == 0:                          # compact
            size = struct.unpack_from("<H", layout, 2)[0]
            raw = layout[4:4 + size]
        elif layout[1] == 1:                        # contiguous
            address, size = struct.unpack_from("<QQ", layout, 2)
            if address == UNDEFINED:                # never written: fill 0
                raw = bytes(n)
            else:
                raw = self._file._at(address, min(size, n))
        elif layout[1] == 2:
            raise ValueError(f"{self.name}: chunked layout is not supported")
        else:
            raise ValueError(f"{self.name}: layout class {layout[1]}")
        out = _array(raw, dtype, shape)
        return np.asarray(out) if shape == () else out

    def __array__(self, dtype=None, copy=None):
        out = self.read()
        return out if dtype is None else out.astype(dtype)

    def __getitem__(self, key):
        return self.read()[key]


class Group(_Object):
    def _entries(self) -> Dict[str, int]:
        if not hasattr(self, "_children"):
            table = self._find(MSG_SYMBOL_TABLE)
            if table is None:
                raise ValueError(f"{self.name}: a group without a symbol "
                                 f"table")
            btree, heap = struct.unpack_from("<QQ", table)
            self._children = self._file._read_group(btree, heap, self.name)
        return self._children

    def keys(self) -> List[str]:
        return list(self._entries())

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __getitem__(self, path: str) -> Union["Group", Dataset]:
        obj: Union[Group, Dataset] = self
        for part in (p for p in path.split("/") if p):
            if not isinstance(obj, Group) or part not in obj._entries():
                raise KeyError(f"{path!r} not in {self.name}")
            obj = obj._file._object(obj._entries()[part],
                                    obj.name.rstrip("/") + "/" + part)
        return obj


class File(Group):
    """A read-only HDF5 file of the supported subset (module docstring)."""

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            self._buf = memoryview(fh.read())
        self._cache: Dict[int, _Object] = {}
        b = self._buf
        if bytes(b[:8]) != SIGNATURE:
            raise ValueError("not an HDF5 file, or one with a user block "
                             "(no superblock at offset 0)")
        if b[8] != 0:
            raise ValueError(f"superblock version {b[8]} (libver='latest' "
                             f"or newer files) is not supported")
        if b[13] != 8 or b[14] != 8:
            raise ValueError(f"{b[13]}-byte offsets and {b[14]}-byte "
                             f"lengths (8 and 8 supported)")
        super().__init__(self, struct.unpack_from("<Q", b, 64)[0], "/")

    def close(self) -> None:
        self._buf.release()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _at(self, address: int, size: int) -> bytes:
        if address + size > len(self._buf):
            raise ValueError(f"address {address} + {size} bytes lies past "
                             f"the end of the file")
        return bytes(self._buf[address:address + size])

    def _read_header(self, address: int) -> List[Tuple[int, bytes]]:
        """The messages of the version-1 object header at `address`,
        continuation blocks followed wherever they appear."""
        prefix = self._at(address, 16)
        if prefix[:4] == b"OHDR":
            raise ValueError("version-2 object headers (libver='latest' "
                             "or track_order) are not supported")
        if prefix[0] != 1:
            raise ValueError(f"object header version {prefix[0]}")
        size = struct.unpack_from("<I", prefix, 8)[0]
        blocks = [(address + 16, size)]
        out = []
        while blocks:
            start, length = blocks.pop(0)
            block = self._at(start, length)
            p = 0
            while p + 8 <= length:
                mtype, msize, flags = struct.unpack_from("<HHB", block, p)
                data = block[p + 8:p + 8 + msize]
                p += 8 + msize
                if flags & 0x02:
                    raise ValueError(f"shared message of type {mtype:#x} "
                                     f"(committed datatypes) is not "
                                     f"supported")
                if mtype in _REFUSED:
                    raise ValueError(f"{_REFUSED[mtype]} are not supported")
                if mtype == MSG_CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", data))
                elif mtype != MSG_NIL:
                    out.append((mtype, data))
        return out

    def _object(self, address: int, name: str) -> Union[Group, Dataset]:
        if address not in self._cache:
            probe = _Object(self, address, name)
            kinds = {t for t, _ in probe._messages()}
            cls = (Group if MSG_SYMBOL_TABLE in kinds else
                   Dataset if MSG_LAYOUT in kinds else None)
            if cls is None:
                raise ValueError(f"{name}: neither a group nor a dataset "
                                 f"(message types {sorted(kinds)})")
            obj = cls(self, address, name)
            obj._msgs = probe._msgs
            self._cache[address] = obj
        return self._cache[address]

    def _read_group(self, btree: int, heap: int, name: str) -> Dict[str, int]:
        """Children {name: object header address} of an old-style group."""
        sig, version, _, _, data = struct.unpack_from(
            "<4sB3xQQQ", self._at(heap, 32))
        if sig != b"HEAP" or version != 0:
            raise ValueError(f"{name}: bad local heap")
        names: Dict[str, int] = {}

        def heap_name(offset: int) -> str:
            start = data + offset
            end = bytes(self._buf[start:start + 1024]).index(b"\0")
            return bytes(self._buf[start:start + end]).decode()

        def node(address: int) -> None:
            sig, ntype, level, used = struct.unpack_from(
                "<4sBBH", self._at(address, 8))
            if sig != b"TREE" or ntype != 0:
                raise ValueError(f"{name}: bad group B-tree node")
            body = self._at(address + 24, 16 * used + 8)
            for i in range(used):
                child = struct.unpack_from("<Q", body, 16 * i + 8)[0]
                if level > 0:
                    node(child)
                else:
                    snod(child)

        def snod(address: int) -> None:
            sig, version, count = struct.unpack_from(
                "<4sBxH", self._at(address, 8))
            if sig != b"SNOD" or version != 1:
                raise ValueError(f"{name}: bad symbol-table node")
            body = self._at(address + 8, 40 * count)
            for i in range(count):
                offset, header, cache = struct.unpack_from("<QQI", body,
                                                           40 * i)
                if cache == 2:
                    raise ValueError(f"{name}: soft links are not supported")
                names[heap_name(offset)] = header

        node(btree)
        return names


# -- writing ------------------------------------------------------------------


def _datatype_message(dtype: np.dtype) -> bytes:
    if dtype.kind == "S":
        # Class 3 (string), version 1, null-padded ASCII: h5py's mapping
        # of numpy's fixed-length bytes.
        return struct.pack("<BBBBI", 0x13, 0x01, 0, 0, dtype.itemsize)
    if dtype.byteorder == ">" or (dtype.byteorder == "=" and
                                  np.little_endian is False):
        raise ValueError(f"big-endian {dtype} is not written")
    if dtype.kind == "f" and dtype.itemsize in _IEEE:
        prec, eloc, esize, mloc, msize, bias, sign = _IEEE[dtype.itemsize]
        return (struct.pack("<BBBBI", 0x11, 0x20, sign, 0, dtype.itemsize)
                + struct.pack("<HHBBBBI", 0, prec, eloc, esize, mloc, msize,
                              bias))
    raise ValueError(f"datatype {dtype} is not written")


def _dataspace_message(shape: Tuple[int, ...]) -> bytes:
    return (struct.pack("<BBBB4x", 1, len(shape), 0, 0)
            + struct.pack(f"<{len(shape)}Q", *shape))


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = data + bytes(_pad8(len(data)) - len(data))
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _attribute_message(name: str, value: np.ndarray) -> bytes:
    name_b = name.encode() + b"\0"
    dt = _datatype_message(value.dtype)
    ds = _dataspace_message(value.shape)
    body = struct.pack("<BxHHH", 1, len(name_b), len(dt), len(ds))
    for part in (name_b, dt, ds):
        body += part + bytes(_pad8(len(part)) - len(part))
    return _message(MSG_ATTRIBUTE, body + value.tobytes())


def _as_attr(value) -> np.ndarray:
    if isinstance(value, str):
        value = value.encode()
    arr = np.asarray(value)
    if arr.dtype.kind == "U":
        arr = np.char.encode(arr)
    if arr.dtype.kind == "O":
        raise ValueError("variable-length attributes are not written")
    return np.array(arr, order="C")         # ascontiguousarray makes 0-d 1-d


class _WGroup:
    """A group being written: attributes, subgroups and datasets."""

    def __init__(self):
        self.attrs: Dict[str, np.ndarray] = _Attrs()
        self.children: Dict[str, Union["_WGroup", "_WDataset"]] = {}

    def _walk(self, path: str, create: bool) -> Tuple["_WGroup", str]:
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise ValueError(f"empty name {path!r}")
        group = self
        for part in parts[:-1]:
            child = group.children.get(part)
            if child is None and create:
                child = group.children[part] = _WGroup()
            if not isinstance(child, _WGroup):
                raise KeyError(f"{path!r}: {part!r} is not a group")
            group = child
        return group, parts[-1]

    def create_group(self, path: str) -> "_WGroup":
        parent, leaf = self._walk(path, create=True)
        if leaf in parent.children:
            raise ValueError(f"{path!r} exists")
        group = parent.children[leaf] = _WGroup()
        return group

    def create_dataset(self, path: str, data) -> "_WDataset":
        parent, leaf = self._walk(path, create=True)
        if leaf in parent.children:
            raise ValueError(f"{path!r} exists")
        arr = np.array(data, order="C")
        _datatype_message(arr.dtype)            # raises if not written
        ds = parent.children[leaf] = _WDataset(arr)
        return ds

    def __getitem__(self, path: str):
        parent, leaf = self._walk(path, create=False)
        return parent.children[leaf]


class _WDataset:
    def __init__(self, data: np.ndarray):
        self.data = data


class _Attrs(dict):
    def __setitem__(self, name: str, value) -> None:
        super().__setitem__(name, _as_attr(value))


class Writer(_WGroup):
    """Builds a file in memory (`create_group`, `create_dataset`,
    `.attrs[...] = ...`) and writes it on `close()` or on leaving a `with`
    block without an exception."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path

    def __enter__(self) -> "Writer":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.close()

    def close(self) -> None:
        out = bytearray(96)                      # the superblock, last
        root, btree, heap = self._write_group(out, self)
        struct.pack_into(
            "<8sBBBBBBBBHHIQQQQ", out, 0, SIGNATURE, 0, 0, 0, 0, 0, 8, 8, 0,
            LEAF_K, INTERNAL_K, 0, 0, UNDEFINED, len(out), UNDEFINED)
        struct.pack_into("<QQII QQ", out, 56, 0, root, 1, 0, btree, heap)
        with open(self.path, "wb") as fh:
            fh.write(out)

    @staticmethod
    def _append(out: bytearray, data: bytes) -> int:
        out.extend(bytes(_pad8(len(out)) - len(out)))
        address = len(out)
        out.extend(data)
        return address

    @classmethod
    def _header(cls, out: bytearray, messages: List[bytes]) -> int:
        body = b"".join(messages)
        if len(body) > 0xFFFFFFFF:
            raise ValueError("object header too large")
        prefix = struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body))
        return cls._append(out, prefix + body)

    @classmethod
    def _write_group(cls, out: bytearray, group: _WGroup
                     ) -> Tuple[int, int, int]:
        """Children first, then the heap, SNODs, B-tree and object header.
        Returns (object header, B-tree, heap) addresses."""
        names = sorted(group.children, key=lambda n: n.encode())
        if len(names) > _MAX_ENTRIES:
            raise ValueError(f"a group of {len(names)} entries (at most "
                             f"{_MAX_ENTRIES} are written)")
        entries = []                              # (name, header, scratch)
        for name in names:
            child = group.children[name]
            if isinstance(child, _WGroup):
                header, btree, heap = cls._write_group(out, child)
                entries.append((name, header, 1,
                                struct.pack("<QQ", btree, heap)))
            else:
                entries.append((name, cls._write_dataset(out, child), 0,
                                bytes(16)))

        # The local heap: "" at offset 0, then each name, 8-byte padded.
        segment, offsets = bytearray(8), {}
        for name in names:
            offsets[name] = len(segment)
            raw = name.encode() + b"\0"
            segment.extend(raw + bytes(_pad8(len(raw)) - len(raw)))
        heap = cls._append(out, struct.pack(
            "<4sB3xQQQ", b"HEAP", 0, len(segment), 1, 0))
        struct.pack_into("<Q", out, heap + 24, heap + 32)
        out.extend(segment)

        # Symbol-table nodes of up to 2 x LEAF_K entries, then one B-tree
        # node over them: key 0 is "", key i + 1 the last name of node i.
        snods, keys = [], [0]
        for i in range(0, len(entries), _SNOD_ENTRIES):
            chunk = entries[i:i + _SNOD_ENTRIES]
            node = bytearray(struct.pack("<4sBxH", b"SNOD", 1, len(chunk)))
            for name, header, cache, scratch in chunk:
                node += struct.pack("<QQI4x", offsets[name], header,
                                    cache) + scratch
            node += bytes(8 + 40 * _SNOD_ENTRIES - len(node))
            snods.append(cls._append(out, bytes(node)))
            keys.append(offsets[chunk[-1][0]])
        tree = bytearray(struct.pack("<4sBBHQQ", b"TREE", 0, 0, len(snods),
                                     UNDEFINED, UNDEFINED))
        for key, child in zip(keys, snods):
            tree += struct.pack("<QQ", key, child)
        tree += struct.pack("<Q", keys[-1])
        tree += bytes(24 + 8 * (4 * INTERNAL_K + 1) - len(tree))
        btree = cls._append(out, bytes(tree))

        messages = [_message(MSG_SYMBOL_TABLE, struct.pack("<QQ", btree,
                                                           heap))]
        messages += [_attribute_message(k, v) for k, v in group.attrs.items()]
        return cls._header(out, messages), btree, heap

    @classmethod
    def _write_dataset(cls, out: bytearray, ds: _WDataset) -> int:
        raw = ds.data.tobytes()
        address = cls._append(out, raw) if raw else UNDEFINED
        messages = [
            _message(MSG_DATASPACE, _dataspace_message(ds.data.shape)),
            _message(MSG_DATATYPE, _datatype_message(ds.data.dtype), 1),
            _message(MSG_LAYOUT, struct.pack("<BBQQ", 3, 1, address,
                                             len(raw))),
        ]
        return cls._header(out, messages)
