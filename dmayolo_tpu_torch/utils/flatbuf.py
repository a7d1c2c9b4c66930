"""A minimal FlatBuffers codec: what a TFLite model file needs.

A FlatBuffers buffer is little-endian.  Its first word is a uoffset (u32,
relative to where it is stored) to the root table.  A table starts with
an soffset (i32) back to its vtable: the vtable's size (u16), the table's
size (u16), then one u16 a field, the field's offset inside the table or
0 where the field is absent (its default then holds).  A scalar field is
stored inline; a string, vector or sub-table field as a uoffset to it.  A
vector is a u32 count and the elements (scalars inline, tables as
uoffsets); a string a u32 length, the bytes and a NUL.  A union is two
fields: its type (u8) and a uoffset to the table.

`Table` reads through vtables without copying: `numpy` returns a view of
the buffer.  `Builder` writes back to front (as every FlatBuffers builder
does: an object is finished before what points to it), aligning each
object to its size, and keeps the pieces it was given in a list, so that
a large byte vector (a model's weights) is written to the file as it
is, never copied into one growing buffer.
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

# scalar kinds: struct format and size
SCALARS = {"bool": "?", "i8": "b", "u8": "B", "i16": "h", "u16": "H", "i32": "i", "u32": "I",
           "i64": "q", "u64": "Q", "f32": "f", "f64": "d"}
_NP = {"bool": np.bool_, "i8": np.int8, "u8": np.uint8, "i16": np.int16, "u16": np.uint16,
       "i32": np.int32, "u32": np.uint32, "i64": np.int64, "u64": np.uint64, "f32": np.float32,
       "f64": np.float64}


def _u32(buf, pos: int) -> int:
    return struct.unpack_from("<I", buf, pos)[0]


class Table:
    """One table of a buffer (a numpy uint8 array, a memmap or bytes)."""

    __slots__ = ("buf", "pos", "_vt", "_vlen")

    def __init__(self, buf, pos: int):
        self.buf, self.pos = buf, pos
        self._vt = pos - struct.unpack_from("<i", buf, pos)[0]
        self._vlen = struct.unpack_from("<H", buf, self._vt)[0]

    @classmethod
    def root(cls, buf) -> "Table":
        return cls(buf, _u32(buf, 0))

    def _field(self, fid: int) -> int:
        """The field's position in the buffer, or 0 where it is absent."""
        o = 4 + 2 * fid
        if o >= self._vlen:
            return 0
        off = struct.unpack_from("<H", self.buf, self._vt + o)[0]
        return self.pos + off if off else 0

    def has(self, fid: int) -> bool:
        return self._field(fid) != 0

    def scalar(self, fid: int, kind: str, default=0):
        p = self._field(fid)
        return default if not p else struct.unpack_from("<" + SCALARS[kind], self.buf, p)[0]

    def _target(self, fid: int) -> int:
        p = self._field(fid)
        return p + _u32(self.buf, p) if p else 0

    def table(self, fid: int) -> Optional["Table"]:
        p = self._target(fid)
        return Table(self.buf, p) if p else None

    def _vector(self, fid: int) -> Tuple[int, int]:
        """(first element's position, count), (0, 0) where absent."""
        p = self._target(fid)
        return (p + 4, _u32(self.buf, p)) if p else (0, 0)

    def numpy(self, fid: int, kind: str) -> Optional[np.ndarray]:
        """A scalar vector as a numpy view of the buffer (None where absent)."""
        if not self.has(fid):
            return None
        start, n = self._vector(fid)
        return np.frombuffer(self.buf, _NP[kind], n, start)

    def string(self, fid: int) -> Optional[str]:
        p = self._target(fid)
        if not p:
            return None
        n = _u32(self.buf, p)
        return bytes(self.buf[p + 4:p + 4 + n]).decode("utf-8")

    def tables(self, fid: int) -> List["Table"]:
        start, n = self._vector(fid)
        return [Table(self.buf, start + 4 * i + _u32(self.buf, start + 4 * i)) for i in range(n)]


class Ref(int):
    """A finished object's offset, counted from the end of the buffer."""


class Builder:
    """Writes a buffer back to front into a list of pieces.

    Every `Ref` is the object's distance from the buffer's end, which does
    not change as more is written in front of it.  `table` takes its
    fields as (id, kind, value): kind a scalar kind, "ref" (a uoffset to a
    finished object) or "union" (value = (type, Ref))."""

    def __init__(self):
        self._pieces: List[Union[bytes, memoryview]] = []
        self.size = 0
        self._minalign = 4

    def _put(self, data) -> None:
        self._pieces.append(data)
        self.size += len(data)

    def _prep(self, align: int, additional: int) -> None:
        """Pad so that after `additional` more bytes the size is a multiple
        of `align`."""
        self._minalign = max(self._minalign, align)
        pad = (-(self.size + additional)) % align
        if pad:
            self._put(bytes(pad))

    def _uoffset(self, target: int) -> bytes:
        self._prep(4, 0)
        return struct.pack("<I", self.size + 4 - target)

    def string(self, s: str) -> Ref:
        data = s.encode("utf-8")
        self._prep(4, len(data) + 1)
        self._put(data + b"\0")
        self._put(struct.pack("<I", len(data)))
        return Ref(self.size)

    def vector(self, kind: str, values) -> Ref:
        """A vector of scalars (any sequence or array)."""
        arr = np.ascontiguousarray(values, dtype=_NP[kind])
        return self.bytes_vector(arr.view(np.uint8).reshape(-1), arr.itemsize, len(arr))

    def bytes_vector(self, data, align: int = 1, count: Optional[int] = None) -> Ref:
        """Raw bytes as a vector of `count` elements (default: the bytes),
        the data aligned to `align`; the bytes are kept, not copied."""
        data = memoryview(np.ascontiguousarray(data, dtype=np.uint8)).cast("B")
        n = len(data) if count is None else count
        self._prep(max(align, 4), len(data))
        if len(data):
            self._put(data)
        self._prep(4, 4)
        self._put(struct.pack("<I", n))
        return Ref(self.size)

    def refs(self, refs: Sequence[int]) -> Ref:
        """A vector of uoffsets to finished objects."""
        self._prep(4, 4 * len(refs))
        for r in reversed(refs):
            self._put(self._uoffset(r))
        self._put(struct.pack("<I", len(refs)))
        return Ref(self.size)

    def table(self, fields: Iterable[Tuple[int, str, object]]) -> Ref:
        fields = [f for f in fields if f[2] is not None]
        start = self.size
        where = {}
        # widest first: the fewest pad bytes between them
        flat = []
        for fid, kind, value in fields:
            if kind == "union":
                utype, uref = value
                flat.append((fid, "u8", utype))
                flat.append((fid + 1, "ref", uref))
            else:
                flat.append((fid, kind, value))
        for fid, kind, value in sorted(flat, key=lambda f: -(
                4 if f[1] == "ref" else struct.calcsize(SCALARS[f[1]]))):
            if kind == "ref":
                self._put(self._uoffset(value))
            else:
                fmt = "<" + SCALARS[kind]
                self._prep(struct.calcsize(fmt), 0)
                self._put(struct.pack(fmt, value))
            where[fid] = self.size
        self._prep(4, 4)
        n_fields = max(where) + 1 if where else 0
        vt_size = 4 + 2 * n_fields
        table_pos = self.size + 4
        vt = [vt_size, table_pos - start] + [table_pos - where[i] if i in where else 0
                                             for i in range(n_fields)]
        # the vtable goes right in front of the table: soffset = its size
        self._put(struct.pack("<i", vt_size))
        self._put(struct.pack("<%dH" % len(vt), *vt))
        return Ref(table_pos)

    def finish(self, root: int, file_identifier: Optional[bytes] = None) -> None:
        extra = 4 + (len(file_identifier) if file_identifier else 0)
        self._prep(self._minalign, extra)
        if file_identifier:
            self._put(file_identifier)
        self._put(self._uoffset(root))

    def write(self, path: Union[str, Path]) -> int:
        """Write the finished buffer to `path`; returns its size."""
        with open(path, "wb") as f:
            for piece in reversed(self._pieces):
                f.write(piece)
        return self.size

    def output(self) -> bytes:
        return b"".join(bytes(p) for p in reversed(self._pieces))
