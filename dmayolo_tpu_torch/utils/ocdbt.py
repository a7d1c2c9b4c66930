"""The OCDBT key-value store, read and written without tensorstore.

OCDBT ("optionally-cooperative distributed B+tree") is tensorstore's
store under every Orbax checkpoint of the JAX package
(`utils/orbax_ckpt.py`).  A store is a directory:

- `manifest.ocdbt`: the config (uuid, manifest kind, the inline-value and
  node-size limits, the compression) and the versions, each a B+tree
  root given as (data file, offset, length) with its height;
- data files (`d/<hex>`, or `ocdbt.process_<N>/d/<hex>` where Orbax
  merged the stores that each host wrote) holding B+tree nodes and the
  values too large to sit in a node.

A manifest or node is a container: a magic number (u32 big-endian,
0x0cdb3a2a for a manifest, 0x0cdb20de for a node), the container's
length (u64), a version and a compression (varints: 0 none, 1 zstd),
the body, and a crc32c of all the bytes before it (u32).  Integers in a
body are LEB128 varints unless said otherwise; lists are stored column
by column.  A body that names files starts with a data-file table:
paths prefix-compressed on the one before, each split into a base path
and a relative path, and resolved under the base path of the file that
holds the table.  A node holds its height, the table and its entries,
keys prefix-compressed; a leaf's values are inline or indirect (file,
offset, length), an interior entry's child is (file, offset, length)
with the length of a prefix that every key below shares and that the
child's keys omit.

`OcdbtStore` reads the latest version of a store with a single-file
manifest; `write_store` writes a store of one version whose B+tree is
one leaf, as much of the format as a checkpoint needs.
"""
from __future__ import annotations

import functools
import os
import struct
import time
import uuid
from pathlib import Path
from typing import Dict, Iterable, List, Tuple, Union

import numpy as np

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_KIND = {MANIFEST_MAGIC: "manifest", NODE_MAGIC: "B+tree node"}
_MISSING = 2**64 - 1  # offset and length of an absent root (an empty version)
MANIFEST_KINDS = {0: "single", 1: "numbered"}

# tensorstore's and Orbax's settings (orbax tensorstore_utils.add_ocdbt_write_options)
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000


_CRC_CHUNK = 1024  # bytes a row of the vectorised CRC


@functools.lru_cache(maxsize=None)
def _crc_tables():
    """CRC-32C's byte table, and the 32x32 GF(2) map that runs the CRC
    register through `_CRC_CHUNK` zero bytes, as four byte tables."""
    poly, table = 0x82F63B78, []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    table = np.array(table, np.uint32)
    basis = np.uint32(1) << np.arange(32, dtype=np.uint32)
    for _ in range(_CRC_CHUNK):
        basis = table[basis & 0xFF] ^ (basis >> 8)
    bits = (np.arange(256)[:, None] >> np.arange(8)) & 1  # (256, 8)
    shift = [np.bitwise_xor.reduce(np.where(bits, basis[8 * k:8 * k + 8], 0), axis=1).tolist()
             for k in range(4)]
    return table, shift


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as the containers' trailers hold it.

    The register is linear in the data, so the bytes are cut into rows of
    `_CRC_CHUNK` (zeros in front, which leave a zero register as it is),
    every row's register from zero is run at once with numpy, and the rows
    are joined in order through the zero-byte map.  The initial 0xFFFFFFFF
    is the first four bytes complemented, as for any reflected CRC."""
    table, shift = _crc_tables()
    a = np.frombuffer(data, np.uint8)
    if len(a) < 4:
        crc = 0xFFFFFFFF
        for b in a.tolist():
            crc = int(table[(crc ^ b) & 0xFF]) ^ (crc >> 8)
        return crc ^ 0xFFFFFFFF
    pad = -len(a) % _CRC_CHUNK
    rows = np.zeros(len(a) + pad, np.uint8)
    rows[pad:] = a
    rows[pad:pad + 4] ^= 0xFF
    rows = rows.reshape(-1, _CRC_CHUNK)
    r = np.zeros(len(rows), np.uint32)
    for j in range(_CRC_CHUNK):
        r = table[(r ^ rows[:, j]) & 0xFF] ^ (r >> 8)
    s0, s1, s2, s3 = shift
    crc = 0
    for v in r.tolist():
        crc = s0[crc & 0xFF] ^ s1[(crc >> 8) & 0xFF] ^ s2[(crc >> 16) & 0xFF] ^ s3[crc >> 24] ^ v
    return crc ^ 0xFFFFFFFF


class _Cursor:
    """Reads a body front to back; an overrun raises naming the file."""

    __slots__ = ("buf", "pos", "name")

    def __init__(self, buf: bytes, name: str):
        self.buf, self.pos, self.name = buf, 0, name

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError(f"{self.name}: body ends early")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.name}: varint longer than 10 bytes")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(vs: Iterable[int]) -> bytes:
    return b"".join(_varint(v) for v in vs)


def decode_container(raw: bytes, magic: int, name: str) -> bytes:
    """The body of a manifest or node container, its crc checked and its
    compression undone.  Raises naming `name` where a check fails."""
    kind = _KIND[magic]
    if len(raw) < 18:
        raise ValueError(f"{name}: {len(raw)} bytes, too short for an OCDBT {kind}")
    (got,) = struct.unpack(">I", raw[:4])
    if got != magic:
        raise ValueError(f"{name}: magic {got:#010x}, not an OCDBT {kind} ({magic:#010x})")
    (length,) = struct.unpack("<Q", raw[4:12])
    if length != len(raw):
        raise ValueError(f"{name}: the {kind} says {length} bytes, the file has {len(raw)}")
    (crc,) = struct.unpack("<I", raw[-4:])
    if crc32c(raw[:-4]) != crc:
        raise ValueError(f"{name}: crc32c mismatch: the {kind} is corrupt")
    c = _Cursor(raw[:-4], name)
    c.pos = 12
    version, compression = c.varint(), c.varint()
    if version != 0:
        raise ValueError(f"{name}: {kind} format version {version}; only version 0 is read")
    body = raw[c.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise ValueError(f"{name}: compression {compression}; only 0 (none) and 1 (zstd) are read")


def encode_container(body: bytes, magic: int) -> bytes:
    """A manifest or node container around `body`, zstd-compressed."""
    payload = _varint(0) + _varint(1) + bytes(zstd.compress(body, 0))
    length = 4 + 8 + len(payload) + 4
    head = struct.pack(">I", magic) + struct.pack("<Q", length) + payload
    return head + struct.pack("<I", crc32c(head))


def _read_files(c: _Cursor, base: str) -> List[Tuple[str, str]]:
    """The data-file table, read under `base` (the base path of the file
    that holds it): each file's (path from the store's root, base path)."""
    n = c.varint()
    if n == 0:
        return []
    prefix = [0] + c.varints(n - 1)
    suffix, blen = c.varints(n), c.varints(n)
    files, prev = [], b""
    for p, s, b in zip(prefix, suffix, blen):
        prev = prev[:p] + c.take(s)
        files.append((base + prev.decode(), base + prev[:b].decode()))
    return files


def _read_config(c: _Cursor) -> dict:
    cfg = {"uuid": c.take(16).hex(), "manifest_kind": c.varint(),
           "max_inline_value_bytes": c.varint(), "max_decoded_node_bytes": c.varint(),
           "version_tree_arity_log2": c.byte()}
    method = c.varint()
    if method == 0:
        cfg["compression"] = None
    elif method == 1:
        cfg["compression"] = {"id": "zstd", "level": struct.unpack("<i", c.take(4))[0]}
    else:
        raise ValueError(f"{c.name}: compression method {method} in the config")
    return cfg


Ref = Tuple[str, int, int]  # (file from the store's root, offset, length)


class OcdbtStore:
    """The latest version of the OCDBT store at `root`, read at once:
    `list()` gives its keys in order, `read(key)` a value's bytes.

    Raises where `root` has no `manifest.ocdbt` (not a store, or a write
    that did not finish), where the manifest is of the numbered kind,
    and where a container fails its checks."""

    def __init__(self, root):
        self.root = Path(root)
        mpath = self.root / "manifest.ocdbt"
        if not mpath.is_file():
            raise FileNotFoundError(
                f"{self.root}: no manifest.ocdbt (not an OCDBT store, or a write that did not finish)")
        c = _Cursor(decode_container(mpath.read_bytes(), MANIFEST_MAGIC, str(mpath)), str(mpath))
        self.config = _read_config(c)
        kind = self.config["manifest_kind"]
        if kind != 0:
            raise ValueError(f"{mpath}: a {MANIFEST_KINDS.get(kind, kind)} manifest "
                             f"(manifest_kind {kind}); only the single-file manifest is read")
        files = _read_files(c, "")
        n = c.varint()
        c.varints(n)  # generation numbers, oldest first
        heights = [c.byte() for _ in range(n)]
        fids, offs, lens = c.varints(n), c.varints(n), c.varints(n)
        self._values: Dict[bytes, Union[bytes, Ref]] = {}
        if n and offs[-1] != _MISSING:  # the latest version; an empty one has no root
            path, base = files[fids[-1]]
            self._walk((path, offs[-1], lens[-1]), base, heights[-1], b"")

    def _raw(self, ref: Ref) -> bytes:
        path, off, n = ref
        with open(self.root / path, "rb") as f:
            data = os.pread(f.fileno(), n, off)
        if len(data) != n:
            raise ValueError(f"{self.root / path}: {n} bytes at {off} asked, {len(data)} there")
        return data

    def _walk(self, ref: Ref, base: str, height: int, prefix: bytes) -> None:
        """Index the subtree at `ref` (in a file of base path `base`),
        whose keys all start with `prefix`, which its node omits."""
        name = f"{self.root / ref[0]}@{ref[1]}"
        c = _Cursor(decode_container(self._raw(ref), NODE_MAGIC, name), name)
        if c.byte() != height:
            raise ValueError(f"{name}: node height differs from its parent's reference")
        files = _read_files(c, base)
        n = c.varint()
        kprefix, ksuffix = [0] + c.varints(n - 1), c.varints(n)
        common = c.varints(n) if height else None
        keys, prev = [], b""
        for p, s in zip(kprefix, ksuffix):
            prev = prev[:p] + c.take(s)
            keys.append(prev)
        if height == 0:
            vlen, kinds = c.varints(n), c.varints(n)
            n_ind = sum(1 for k in kinds if k == 1)
            ifid, ioff = c.varints(n_ind), c.varints(n_ind)
            j = 0
            for key, ln, kind in zip(keys, vlen, kinds):
                if kind == 1:
                    self._values[prefix + key] = (files[ifid[j]][0], ioff[j], ln)
                    j += 1
                elif kind == 0:
                    self._values[prefix + key] = c.take(ln)
                else:
                    raise ValueError(f"{name}: value kind {kind}")
            return
        fids, offs, lens = c.varints(n), c.varints(n), c.varints(n)
        for key, cp, fid, off, ln in zip(keys, common, fids, offs, lens):
            path, fbase = files[fid]
            self._walk((path, off, ln), fbase, height - 1, prefix + key[:cp])

    def list(self) -> List[bytes]:
        return list(self._values)

    def ref(self, key: bytes) -> Union[bytes, Ref]:
        """A value's bytes where they sit in a node, else (file, offset,
        length); KeyError naming the key where it is absent."""
        try:
            return self._values[key]
        except KeyError:
            raise KeyError(f"{self.root}: no key {key!r}") from None

    def read(self, key: bytes) -> bytes:
        v = self.ref(key)
        return v if isinstance(v, bytes) else self._raw(v)


def write_store(root, items: Iterable[Tuple[bytes, bytes]]) -> int:
    """Write a new OCDBT store at `root` (a directory that holds none)
    from `items`, (key, value) pairs in any order with distinct keys: one
    data file of the values larger than `MAX_INLINE_VALUE_BYTES`, each
    written as it comes, then one leaf node of every key, then the
    manifest of one version.  Nodes and manifest are zstd-compressed, as
    tensorstore writes them.  Returns the bytes written."""
    root = Path(root)
    (root / "d").mkdir(parents=True, exist_ok=True)
    if (root / "manifest.ocdbt").exists():
        raise FileExistsError(f"{root}: already holds an OCDBT store")
    rel = f"d/{uuid.uuid4().hex}"
    entries: Dict[bytes, Union[bytes, Tuple[int, int]]] = {}
    indirect = 0
    with open(root / rel, "wb") as f:
        for key, value in items:
            if key in entries:
                raise ValueError(f"key {key!r} given twice")
            if len(value) <= MAX_INLINE_VALUE_BYTES:
                entries[key] = bytes(value)
            else:
                entries[key] = (f.tell(), len(value))
                f.write(value)
                indirect += len(value)
        if not entries:
            raise ValueError("an OCDBT store needs at least one key")
        keys = sorted(entries)
        node = _leaf_body(rel, keys, entries)
        if len(node) > MAX_DECODED_NODE_BYTES:
            raise ValueError(f"the leaf node is {len(node)} bytes decoded, over the "
                             f"{MAX_DECODED_NODE_BYTES} that readers accept")
        node = encode_container(node, NODE_MAGIC)
        node_off = f.tell()
        f.write(node)
        size = f.tell()
    body = (uuid.uuid4().bytes + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES)
            + _varint(MAX_DECODED_NODE_BYTES) + bytes([4]) + _varint(1) + struct.pack("<i", 0)
            + _files_table([rel])
            # one version: generation 1, height 0, root (file 0, offset, length),
            # num_keys, num_tree_bytes, num_indirect_value_bytes, commit time
            + _varints([1]) + _varint(1) + bytes([0]) + _varints([0, node_off, len(node)])
            + _varints([len(keys), len(node), indirect]) + struct.pack("<Q", time.time_ns())
            + _varint(0))  # no version-tree nodes
    manifest = encode_container(body, MANIFEST_MAGIC)
    (root / "manifest.ocdbt").write_bytes(manifest)
    return size + len(manifest)


def _files_table(paths: List[str]) -> bytes:
    """A data-file table of paths under the base path of the file that
    holds it (base-path lengths 0)."""
    enc = [p.encode() for p in paths]
    prefix = [len(os.path.commonprefix([a, b])) for a, b in zip(enc, enc[1:])]
    suffix = [e[p:] for e, p in zip(enc, [0] + prefix)]
    return (_varint(len(enc)) + _varints(prefix) + _varints(len(s) for s in suffix)
            + _varints(0 for _ in enc) + b"".join(suffix))


def _leaf_body(rel: str, keys: List[bytes], entries: Dict) -> bytes:
    prefix = [len(os.path.commonprefix([a, b])) for a, b in zip(keys, keys[1:])]
    suffix = [k[p:] for k, p in zip(keys, [0] + prefix)]
    vals = [entries[k] for k in keys]
    ind = [v for v in vals if not isinstance(v, bytes)]
    return (bytes([0]) + _files_table([rel] if ind else [])
            + _varint(len(keys)) + _varints(prefix) + _varints(len(s) for s in suffix)
            + b"".join(suffix)
            + _varints(len(v) if isinstance(v, bytes) else v[1] for v in vals)
            + _varints(0 if isinstance(v, bytes) else 1 for v in vals)
            + _varints(0 for _ in ind) + _varints(off for off, _ in ind)
            + b"".join(v for v in vals if isinstance(v, bytes)))
