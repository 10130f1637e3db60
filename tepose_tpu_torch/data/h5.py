"""HDF5 files without h5py: a reader for the subset the DBs use, and an
appending writer for the InstaVariety builder.

The GPU host has numpy, scipy and the standard library, not h5py. The files
the port reads are the InstaVariety DB (`insta_train_db.h5`, written by
h5py's defaults: `chunks=True`, `maxshape=(None, ...)`, appended and
resized) and MATLAB v7.3 `annot_data.mat` (HDF5 behind a 512-byte user
block). What they use, and all this reader accepts:

  * superblock version 0 or 1, at offset 0 or after a user block of 512,
    1024, 2048, ... bytes (addresses relative to the base address);
  * the root group's symbol table: a version 1 B-tree of symbol nodes and a
    local heap of names (datasets in the root group only);
  * version 1 object headers, with continuation blocks;
  * dataspace, datatype, fill value, layout (version 3) and filter pipeline
    messages; attribute and time messages are skipped;
  * fixed-point and IEEE floating-point types of either byte order, and
    fixed-length byte strings;
  * contiguous and chunked layouts; chunks are indexed by a version 1
    B-tree of any depth and may be deflated (zlib) and shuffled.

Anything else raises `H5FormatError`, naming the file and the feature; no
partial data is returned. A dataset is read lazily: `ds[s:e]` and `ds[i]`
read only the bytes or chunks of those rows along axis 0, found by walking
the chunk B-tree down the branches that hold them (one numpy view a node,
never a Python object a chunk).

`H5Writer` appends rows along axis 0, as the builder's h5py writer does,
holding no more than the batch it is given: each key is spilled to its own
file beside the target, with room reserved at its head. At `close()` the
largest spill becomes the file: the other keys' rows are copied after its
own, the superblock, the root group and one contiguous dataset a key are
written into the reserved head, and the file is renamed into place, so the
largest key is never copied. h5py reads the result.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF

# object header message types
_DATASPACE, _DATATYPE, _FILL_OLD, _FILL = 0x1, 0x3, 0x4, 0x5
_LAYOUT, _FILTERS, _CONTINUATION, _SYMBOL_TABLE = 0x8, 0xB, 0x10, 0x11
_SKIPPED = {0x0: "nil", 0xC: "attribute", 0xD: "comment",
            0xE: "modification time (old)", 0x12: "modification time",
            0x15: "attribute info", 0x16: "reference count"}
_MESSAGE_NAMES = {0x2: "link info", 0x6: "link", 0x7: "external files",
                  0xA: "group info", 0x13: "B-tree 'K' values",
                  0x14: "driver info", 0x17: "file space info"}
_TYPE_CLASSES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                 7: "reference", 8: "enum", 9: "variable-length",
                 10: "array"}
_FILTER_NAMES = {3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset",
                 32000: "lzf", 32001: "blosc", 32004: "lz4", 32015: "zstd"}
DEFLATE, SHUFFLE = 1, 2

_IEEE = {2: (15, 10, 5, 0, 10, 15), 4: (31, 23, 8, 0, 23, 127),
         8: (63, 52, 11, 0, 52, 1023)}   # sign, exp loc, exp size,
#                                          mant loc, mant size, bias


class H5FormatError(ValueError):
    """A file, or a feature of one, outside the subset `data.h5` reads."""


def _unsupported(path: str, feature: str) -> H5FormatError:
    return H5FormatError(
        f"{path}: {feature} is not supported (tepose_tpu_torch.data.h5 reads "
        "superblock v0/v1 files with root-group datasets, contiguous or "
        "chunked, deflate and shuffle only)")


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class _Source:
    """Positioned reads of one file, addresses relative to its base."""

    def __init__(self, path: str):
        self.path = path
        self.fd = os.open(path, os.O_RDONLY)
        self.base = 0
        self.size = os.fstat(self.fd).st_size

    def read(self, addr: int, n: int) -> bytes:
        if self.fd < 0:
            raise ValueError(f"{self.path}: read from a closed file")
        b = os.pread(self.fd, n, self.base + addr)
        if len(b) != n:
            raise H5FormatError(
                f"{self.path}: truncated ({n} bytes wanted at "
                f"{self.base + addr}, {len(b)} there)")
        return b

    def read_into(self, addr: int, out: np.ndarray) -> None:
        view = memoryview(out.reshape(-1).view(np.uint8))
        done = 0
        while done < len(view):
            n = os.preadv(self.fd, [view[done:]], self.base + addr + done)
            if n <= 0:
                raise H5FormatError(f"{self.path}: truncated at "
                                    f"{self.base + addr + done}")
            done += n

    def close(self) -> None:
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1


def _uint(b: bytes, off: int, n: int) -> int:
    return int.from_bytes(b[off:off + n], "little")


# ------------------------------------------------------------------ reader


class H5Dataset:
    """A lazy dataset: `shape`, `dtype`, `chunks`, `len()`,
    `np.asarray(ds)`, `ds[()]`, and rows along axis 0: `ds[i]`, `ds[s:e]`.
    `chunks_read` counts the chunks read so far."""

    def __init__(self, src: _Source, name: str, shape: Tuple[int, ...],
                 dtype: np.dtype, layout: dict, filters: list,
                 fill: Optional[bytes]):
        self._src, self.name = src, name
        self.shape, self.dtype = shape, dtype
        self._layout, self._filters, self._fill = layout, filters, fill
        self.chunks = layout.get("chunks")
        self.chunks_read = 0

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError(f"{self.name}: a scalar dataset has no len()")
        return self.shape[0]

    def __repr__(self) -> str:
        return (f"<H5Dataset {self.name!r} shape {self.shape} "
                f"dtype {self.dtype}>")

    def __array__(self, dtype=None, copy=None):
        out = self._rows(0, self.shape[0]) if self.shape else self._scalar()
        return out if dtype is None else out.astype(dtype, copy=False)

    def __getitem__(self, key):
        if isinstance(key, tuple) and not key:
            return np.asarray(self)
        if not self.shape:
            raise IndexError(f"{self.name}: a scalar dataset takes only [()]")
        n = self.shape[0]
        if isinstance(key, (int, np.integer)):
            i = int(key) + n if key < 0 else int(key)
            if not 0 <= i < n:
                raise IndexError(f"{self.name}: index {key} out of range "
                                 f"for {n} rows")
            return self._rows(i, i + 1)[0]
        if not isinstance(key, slice) or key.step not in (None, 1):
            raise TypeError(f"{self.name}: index with an int or a slice "
                            f"of step 1 along axis 0, not {key!r}")
        start, stop, _ = key.indices(n)
        return self._rows(start, max(start, stop))

    # -- reading

    def _empty(self, rows: int) -> np.ndarray:
        shape = (rows,) + tuple(self.shape[1:])
        if self._fill is None or not any(self._fill):
            return np.zeros(shape, self.dtype)
        out = np.empty(shape, self.dtype)
        out[...] = np.frombuffer(self._fill, self.dtype)[0]
        return out

    def _scalar(self) -> np.ndarray:
        lay = self._layout
        if lay["class"] == "chunked":
            raise _unsupported(self._src.path, f"chunked scalar {self.name}")
        out = self._empty(1).reshape(())
        if lay["addr"] != UNDEF:
            self._src.read_into(lay["addr"], out)
        return out

    def _rows(self, r0: int, r1: int) -> np.ndarray:
        out = self._empty(r1 - r0)
        if r1 <= r0 or out.size == 0:
            return out
        lay = self._layout
        if lay["class"] == "contiguous":
            if lay["addr"] != UNDEF:
                row = out.nbytes // (r1 - r0)
                self._src.read_into(lay["addr"] + r0 * row, out)
            return out
        cs = lay["chunks"]
        for offs, addrs, sizes, masks in self._chunk_index(r0, r1):
            for off, addr, size, mask in zip(offs.tolist(), addrs.tolist(),
                                             sizes.tolist(), masks.tolist()):
                chunk = self._chunk(addr, size, mask).reshape(cs)
                src, dst = [], []
                for d, (o, c, n) in enumerate(zip(off, cs, self.shape)):
                    lo, hi = (max(o, r0), min(o + c, r1, n)) if d == 0 else (
                        o, min(o + c, n))
                    src.append(slice(lo - o, hi - o))
                    dst.append(slice(lo - r0, hi - r0) if d == 0
                               else slice(lo, hi))
                out[tuple(dst)] = chunk[tuple(src)]
        return out

    def _chunk(self, addr: int, size: int, mask: int) -> np.ndarray:
        self.chunks_read += 1
        raw = self._src.read(addr, size)
        for i in reversed(range(len(self._filters))):
            if mask >> i & 1:
                continue
            fid, _ = self._filters[i]
            if fid == DEFLATE:
                raw = zlib.decompress(raw)
            else:  # SHUFFLE
                es = self.dtype.itemsize
                n = len(raw) // es
                body = np.frombuffer(raw, np.uint8, n * es)
                raw = body.reshape(es, n).T.tobytes() + raw[n * es:]
        want = int(np.prod(self._layout["chunks"])) * self.dtype.itemsize
        if len(raw) != want:
            raise H5FormatError(f"{self._src.path}: a chunk of {self.name} "
                                f"holds {len(raw)} bytes, not {want}")
        return np.frombuffer(raw, self.dtype)

    def _chunk_index(self, r0: int, r1: int) -> Iterator[tuple]:
        """(offsets (n, rank), addresses, sizes, filter masks) of the
        chunks holding rows [r0, r1), a leaf node at a time."""
        src, lay = self._src, self._layout
        rank = len(self.shape)
        key = np.dtype([("size", "<u4"), ("mask", "<u4"),
                        ("off", "<u8", (rank + 1,))])
        rec = np.dtype([("key", key), ("child", "<u8")])
        lo = r0 - r0 % lay["chunks"][0]
        stack = [lay["addr"]] if lay["addr"] != UNDEF else []
        while stack:
            addr = stack.pop()
            head = src.read(addr, 24)
            if head[:4] != b"TREE" or head[4] != 1:
                raise H5FormatError(f"{src.path}: {self.name}'s chunk index "
                                    f"has no B-tree node at {addr}")
            level, used = head[5], _uint(head, 6, 2)
            body = src.read(addr + 24, used * rec.itemsize + key.itemsize)
            ents = np.frombuffer(body, rec, used)
            first = ents["key"]["off"][:, 0]
            if level == 0:
                keep = (first >= lo) & (first < r1)
                if keep.any():
                    e = ents[keep]
                    yield (e["key"]["off"][:, :rank].astype(np.int64),
                           e["child"], e["key"]["size"], e["key"]["mask"])
                continue
            last = np.frombuffer(body, key, 1, used * rec.itemsize)
            nxt = np.concatenate([first[1:], last["off"][:, 0]])
            keep = (first < r1) & (nxt >= lo)
            stack.extend(reversed(ents["child"][keep].tolist()))


class H5File:
    """A read-only HDF5 file: `keys()`, `in`, `[name]` (an `H5Dataset`),
    iteration, `len()`, a context manager and `close()`."""

    def __init__(self, path: str):
        self.path = str(path)
        self._src = _Source(self.path)
        try:
            self._members = self._read_root()
        except BaseException:
            self._src.close()
            raise
        self._open: Dict[str, H5Dataset] = {}

    def _read_root(self) -> Dict[str, int]:
        src = self._src
        at = 0
        while at + 8 <= src.size:
            if os.pread(src.fd, 8, at) == SIGNATURE:
                break
            at = 512 if at == 0 else at * 2
        else:
            raise H5FormatError(f"{self.path}: no HDF5 signature (not an "
                                "HDF5 file)")
        sb = os.pread(src.fd, 128, at)
        version = sb[8]
        if version > 1:
            raise _unsupported(self.path, f"superblock version {version} "
                               "(h5py's libver='latest' or 'v108'+)")
        so, sl = sb[13], sb[14]
        if (so, sl) != (8, 8):
            raise _unsupported(self.path, f"{so}-byte offsets and {sl}-byte "
                               "lengths")
        self._leaf_k, self._internal_k = _uint(sb, 16, 2), _uint(sb, 18, 2)
        p = 24 + (4 if version == 1 else 0)
        base = _uint(sb, p, 8)
        src.base = base if base != UNDEF else at
        root_oh = _uint(sb, p + 32 + 8, 8)
        msgs = self._messages(root_oh, "the root group")
        tables = [m for t, _, m in msgs if t == _SYMBOL_TABLE]
        if not tables:
            raise _unsupported(self.path, "a root group without a symbol "
                               "table (new-style link storage)")
        btree, heap = _uint(tables[0], 0, 8), _uint(tables[0], 8, 8)
        return self._group_members(btree, heap)

    def _messages(self, addr: int, what: str) -> List[tuple]:
        """(type, flags, data) of a version 1 object header's messages."""
        src = self._src
        head = src.read(addr, 16)
        if head[:4] == b"OHDR":
            raise _unsupported(self.path, f"version 2 object header ({what})")
        if head[0] != 1:
            raise _unsupported(self.path, f"object header version {head[0]} "
                               f"({what})")
        n, size = _uint(head, 2, 2), _uint(head, 8, 4)
        blocks, out = [(addr + 16, size)], []
        while blocks and len(out) < n:
            start, length = blocks.pop(0)
            data, p = src.read(start, length), 0
            while p + 8 <= length and len(out) < n:
                mtype, msize, mflags = (_uint(data, p, 2), _uint(data, p + 2, 2),
                                        data[p + 4])
                body = data[p + 8:p + 8 + msize]
                p += 8 + msize
                if mtype == _CONTINUATION:
                    blocks.append((_uint(body, 0, 8), _uint(body, 8, 8)))
                out.append((mtype, mflags, body))
        return out

    def _group_members(self, btree: int, heap: int) -> Dict[str, int]:
        src = self._src
        hh = src.read(heap, 32)
        if hh[:4] != b"HEAP":
            raise H5FormatError(f"{self.path}: no local heap at {heap}")
        names = src.read(_uint(hh, 24, 8), _uint(hh, 8, 8))
        members: Dict[str, int] = {}
        stack = [btree]
        while stack:
            addr = stack.pop()
            head = src.read(addr, 24)
            if head[:4] != b"TREE" or head[4] != 0:
                raise H5FormatError(f"{self.path}: no group B-tree node at "
                                    f"{addr}")
            level, used = head[5], _uint(head, 6, 2)
            body = src.read(addr + 24, used * 16 + 8)
            children = [_uint(body, 8 + 16 * i, 8) for i in range(used)]
            if level > 0:
                stack.extend(reversed(children))
                continue
            for snod in children:
                sh = src.read(snod, 8)
                if sh[:4] != b"SNOD":
                    raise H5FormatError(f"{self.path}: no symbol node at "
                                        f"{snod}")
                count = _uint(sh, 6, 2)
                ents = src.read(snod + 8, 40 * count)
                for i in range(count):
                    e = ents[40 * i:40 * (i + 1)]
                    off = _uint(e, 0, 8)
                    name = names[off:names.index(b"\0", off)].decode()
                    members[name] = _uint(e, 8, 8)
        return members

    # -- the mapping

    def keys(self) -> List[str]:
        return list(self._members)

    def __iter__(self):
        return iter(self._members)

    def __contains__(self, name) -> bool:
        return str(name).strip("/") in self._members

    def __getitem__(self, name: str) -> H5Dataset:
        name = str(name).strip("/")
        if name in self._open:
            return self._open[name]
        if "/" in name:
            raise _unsupported(self.path, f"a nested path {name!r} (root-"
                               "group datasets only)")
        if name not in self._members:
            raise KeyError(f"{self.path}: no dataset {name!r}")
        ds = self._dataset(name, self._members[name])
        self._open[name] = ds
        return ds

    def _dataset(self, name: str, addr: int) -> H5Dataset:
        path = self.path
        shape = dtype = layout = fill = None
        filters: list = []
        for mtype, mflags, body in self._messages(addr, name):
            if mflags & 0x02 and mtype in (_DATASPACE, _DATATYPE, _FILL,
                                           _LAYOUT, _FILTERS):
                raise _unsupported(path, f"a shared message in {name}")
            if mtype == _DATASPACE:
                shape = _dataspace(path, name, body)
            elif mtype == _DATATYPE:
                dtype = _datatype(path, name, body)
            elif mtype == _FILL:
                fill = _fill_value(body)
            elif mtype == _FILL_OLD:
                fill = fill if fill is not None else (
                    body[4:4 + _uint(body, 0, 4)] or None)
            elif mtype == _LAYOUT:
                layout = _layout(path, name, body)
            elif mtype == _FILTERS:
                filters = _filters(path, name, body)
            elif mtype == _SYMBOL_TABLE:
                raise _unsupported(path, f"a group ({name}; root-group "
                                   "datasets only)")
            elif mtype not in _SKIPPED and mtype != _CONTINUATION:
                raise _unsupported(path, "object header message "
                                   f"{_MESSAGE_NAMES.get(mtype, hex(mtype))}"
                                   f" in {name}")
        if shape is None or dtype is None or layout is None:
            raise H5FormatError(f"{path}: {name} lacks a dataspace, datatype "
                                "or layout message")
        if filters and layout["class"] != "chunked":
            raise H5FormatError(f"{path}: {name} has filters but no chunks")
        if layout["class"] == "chunked":
            if len(layout["chunks"]) != len(shape):
                raise H5FormatError(f"{path}: {name}'s chunks have rank "
                                    f"{len(layout['chunks'])}, its shape "
                                    f"{len(shape)}")
        if fill is not None and len(fill) != dtype.itemsize:
            fill = None if not any(fill) else fill[:dtype.itemsize]
        return H5Dataset(self._src, name, shape, dtype, layout, filters, fill)

    def close(self) -> None:
        self._src.close()

    def __enter__(self) -> "H5File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return f"<H5File {self.path!r} {self.keys()}>"


def open_h5(path: str) -> H5File:
    """Open `path` read-only (see the module docstring for what it reads)."""
    return H5File(path)


def _dataspace(path: str, name: str, b: bytes) -> Tuple[int, ...]:
    version, rank, flags = b[0], b[1], b[2]
    if version == 1:
        p = 8
    elif version == 2:
        if b[3] == 2:
            raise _unsupported(path, f"a null dataspace ({name})")
        p = 4
    else:
        raise _unsupported(path, f"dataspace version {version} ({name})")
    return tuple(_uint(b, p + 8 * i, 8) for i in range(rank))


def _datatype(path: str, name: str, b: bytes) -> np.dtype:
    cls, bits, size = b[0] & 0x0F, b[1], _uint(b, 4, 4)
    order = ">" if bits & 1 else "<"
    if cls == 0:
        offset, precision = _uint(b, 8, 2), _uint(b, 10, 2)
        if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
            raise _unsupported(path, f"a {precision}-bit integer at bit "
                               f"{offset} in {size} bytes ({name})")
        return np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}")
    if cls == 1:
        if bits & 0x40:
            raise _unsupported(path, f"VAX float order ({name})")
        want = _IEEE.get(size)
        got = (b[2], b[12], b[13], b[14], b[15], _uint(b, 16, 4))
        if want is None or got != want or _uint(b, 8, 2) != 0:
            raise _unsupported(path, f"a non-IEEE {size}-byte float ({name})")
        return np.dtype(f"{order}f{size}")
    if cls == 3:
        return np.dtype(f"S{size}")
    raise _unsupported(path, f"the {_TYPE_CLASSES.get(cls, cls)} datatype "
                       f"({name})")


def _fill_value(b: bytes) -> Optional[bytes]:
    version = b[0]
    if version in (1, 2):
        defined = b[3]
        if version == 2 and not defined:
            return None
        size = _uint(b, 4, 4)
        return b[8:8 + size] or None
    flags = b[1]
    if not flags & 0x20:
        return None
    return b[6:6 + _uint(b, 2, 4)] or None


def _layout(path: str, name: str, b: bytes) -> dict:
    version, cls = b[0], b[1]
    if version != 3:
        raise _unsupported(path, f"layout message version {version} "
                           f"({name})")
    if cls == 1:
        return {"class": "contiguous", "addr": _uint(b, 2, 8)}
    if cls == 2:
        ndims = b[2]
        dims = [_uint(b, 11 + 4 * i, 4) for i in range(ndims)]
        return {"class": "chunked", "addr": _uint(b, 3, 8),
                "chunks": tuple(dims[:-1])}
    raise _unsupported(path, f"the {'compact' if cls == 0 else cls} layout "
                       f"({name})")


def _filters(path: str, name: str, b: bytes) -> list:
    version, n = b[0], b[1]
    p = 8 if version == 1 else 2
    out = []
    for _ in range(n):
        fid = _uint(b, p, 2)
        named = version == 1 or fid >= 256
        nlen = _uint(b, p + 2, 2) if named else 0
        q = p + (4 if named else 2)
        nvals = _uint(b, q + 2, 2)
        q += 4 + (_pad8(nlen) if version == 1 else nlen)
        vals = [_uint(b, q + 4 * i, 4) for i in range(nvals)]
        q += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
        if fid not in (DEFLATE, SHUFFLE):
            raise _unsupported(path, f"filter {fid} "
                               f"({_FILTER_NAMES.get(fid, 'unknown')}) on "
                               f"{name}")
        out.append((fid, vals))
        p = q
    return out


# ------------------------------------------------------------------ writer

_HEAD = 1 << 16           # bytes reserved at the head of each spill


def _dtype_message(dt: np.dtype) -> bytes:
    order = 1 if dt.byteorder == ">" else 0
    if dt.kind in "iu":
        bits = order | (8 if dt.kind == "i" else 0)
        return (bytes([0x10, bits, 0, 0]) + struct.pack("<I", dt.itemsize)
                + struct.pack("<HH", 0, 8 * dt.itemsize))
    if dt.kind == "f" and dt.itemsize in _IEEE:
        sign, eloc, esize, mloc, msize, bias = _IEEE[dt.itemsize]
        return (bytes([0x11, order | 0x20, sign, 0])
                + struct.pack("<I", dt.itemsize)
                + struct.pack("<HHBBBBI", 0, 8 * dt.itemsize, eloc, esize,
                              mloc, msize, bias))
    if dt.kind == "S":
        return bytes([0x13, 1, 0, 0]) + struct.pack("<I", dt.itemsize)
    raise TypeError(f"H5Writer writes integers, IEEE floats and fixed-length "
                    f"bytes, not {dt}")


def _object_header(msgs: List[Tuple[int, bytes]]) -> bytes:
    body = b"".join(struct.pack("<HHB3x", t, _pad8(len(d)), 0)
                    + d.ljust(_pad8(len(d)), b"\0") for t, d in msgs)
    return struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body)) + body


class _Spill:
    def __init__(self, path: str, dtype: np.dtype, row_shape: tuple):
        self.path, self.dtype, self.row_shape = path, dtype, row_shape
        self.file = open(path, "wb")
        self.file.seek(_HEAD)
        self.rows = 0

    @property
    def nbytes(self) -> int:
        return self.rows * int(np.prod(self.row_shape, dtype=np.int64)) \
            * self.dtype.itemsize


class H5Writer:
    """Append rows along axis 0 to datasets of a new HDF5 file:
    `append(key, rows)`, then `close()` (or use it as a context manager;
    an exception inside the block removes every temporary file). The
    first append of a key fixes its dtype and row shape; later rows are
    cast to that dtype, as h5py casts them into an existing dataset. The
    file appears at `path` only when `close()` has written it whole."""

    def __init__(self, path: str):
        self.path = str(path)
        self._spills: Dict[str, _Spill] = {}
        self._closed = False

    def append(self, key: str, rows) -> None:
        if self._closed:
            raise ValueError(f"{self.path}: append to a closed H5Writer")
        if not key or "/" in key or "\0" in key:
            raise ValueError(f"H5Writer: bad dataset name {key!r}")
        rows = np.asarray(rows)
        if rows.ndim == 0:
            raise ValueError(f"{key}: rows need an axis 0")
        spill = self._spills.get(key)
        if spill is None:
            _dtype_message(rows.dtype)
            spill = _Spill(f"{self.path}.{len(self._spills)}.part",
                           rows.dtype, rows.shape[1:])
            self._spills[key] = spill
        elif rows.shape[1:] != spill.row_shape:
            raise ValueError(f"{key}: rows of shape {rows.shape[1:]} after "
                             f"rows of shape {spill.row_shape}")
        rows = np.ascontiguousarray(rows, spill.dtype)
        spill.file.write(memoryview(rows.reshape(-1)).cast("B"))
        spill.rows += rows.shape[0]

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        spills = self._spills
        try:
            for s in spills.values():
                s.file.close()
            if not spills:
                raise ValueError(f"{self.path}: nothing was appended")
            names = sorted(spills, key=lambda k: k.encode())
            big = max(names, key=lambda k: spills[k].nbytes)
            addrs, end = {big: _HEAD}, _HEAD + spills[big].nbytes
            with open(spills[big].path, "r+b") as out:
                for k in names:
                    if k == big:
                        continue
                    end = _pad8(end)
                    addrs[k] = end
                    out.seek(end)
                    with open(spills[k].path, "rb") as f:
                        f.seek(_HEAD)
                        for block in iter(lambda: f.read(1 << 24), b""):
                            out.write(block)
                    end += spills[k].nbytes
                head = self._metadata(names, addrs, end)
                out.seek(0)
                out.write(head)
                out.flush()
                os.fsync(out.fileno())
            os.replace(spills[big].path, self.path)
        finally:
            for s in spills.values():
                if os.path.exists(s.path):
                    os.remove(s.path)

    def abort(self) -> None:
        """Drop every spill; write nothing."""
        self._closed = True
        for s in self._spills.values():
            s.file.close()
            if os.path.exists(s.path):
                os.remove(s.path)

    def _metadata(self, names: List[str], addrs: Dict[str, int],
                  eof: int) -> bytes:
        """Superblock v0, the root group (object header, local heap, one
        B-tree node over one symbol node) and one object header a dataset,
        laid out from address 0."""
        n = len(names)
        leaf_k, internal_k = max(4, (n + 1) // 2), 16
        heap_data = b"\0" * 8
        name_off = {}
        for k in names:
            name_off[k] = len(heap_data)
            heap_data += k.encode().ljust(_pad8(len(k) + 1), b"\0")
        root_at = 96
        root_oh = _object_header([(_SYMBOL_TABLE, bytes(16))])
        heap_at = root_at + len(root_oh)
        heap_data_at = heap_at + 32
        tree_at = heap_data_at + len(heap_data)
        tree_size = 24 + (2 * internal_k + 1) * 8 + 2 * internal_k * 8
        snod_at = tree_at + tree_size
        snod_size = 8 + 2 * leaf_k * 40
        at = snod_at + snod_size
        headers = []
        for k in names:
            s = self._spills[k]
            shape = (s.rows,) + tuple(s.row_shape)
            space = struct.pack("<BBB5x", 1, len(shape), 0) + b"".join(
                struct.pack("<Q", d) for d in shape)
            fill = bytes([2, 2, 0, 0])
            layout = struct.pack("<BBQQ", 3, 1,
                                 addrs[k] if s.nbytes else UNDEF, s.nbytes)
            oh = _object_header([(_DATASPACE, space),
                                 (_DATATYPE, _dtype_message(s.dtype)),
                                 (_FILL, fill), (_LAYOUT, layout)])
            headers.append((k, at, oh))
            at += len(oh)
        if at > _HEAD:
            raise ValueError(f"{self.path}: {n} datasets need {at} bytes of "
                             f"metadata, more than the {_HEAD} reserved")
        root_oh = _object_header([(_SYMBOL_TABLE,
                                   struct.pack("<QQ", tree_at, heap_at))])
        sb = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
              + struct.pack("<HHI", leaf_k, internal_k, 0)
              + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
              + struct.pack("<QQII", 0, root_at, 1, 0)
              + struct.pack("<QQ", tree_at, heap_at))
        heap = (b"HEAP" + bytes(4)
                + struct.pack("<QQQ", len(heap_data), 1, heap_data_at))
        tree = (b"TREE" + bytes([0, 0]) + struct.pack("<H", 1)
                + struct.pack("<QQ", UNDEF, UNDEF)
                + struct.pack("<QQQ", 0, snod_at, name_off[names[-1]]))
        snod = b"SNOD" + bytes([1, 0]) + struct.pack("<H", n) + b"".join(
            struct.pack("<QQII16x", name_off[k], oh_at, 0, 0)
            for k, oh_at, _ in headers)
        buf = bytearray(at)
        for off, part in ((0, sb), (root_at, root_oh), (heap_at, heap),
                          (heap_data_at, heap_data), (tree_at, tree),
                          (snod_at, snod)):
            buf[off:off + len(part)] = part
        for _, oh_at, oh in headers:
            buf[oh_at:oh_at + len(oh)] = oh
        return bytes(buf)

    def __enter__(self) -> "H5Writer":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.close()
        else:
            self.abort()
