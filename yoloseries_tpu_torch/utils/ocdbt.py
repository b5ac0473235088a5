"""Read-only OCDBT key-value store: tensorstore's "Optionally-Cooperative
Distributed B+Tree" format, in which Orbax writes a checkpoint's arrays
(``utils/orbax.py``), read without tensorstore.

Layout under the store's directory: ``manifest.ocdbt`` names the database
config and its versions; the newest version's root is a b-tree node inside a
data file (``d/<hash>``, or under ``ocdbt.process_<i>/`` where each process
of a multi-host run wrote its own files). Every manifest and node is encoded
as: a 4-byte magic (big-endian), the total length (u64), a format version
and a compression method (varints; 1 = one zstd frame), the body, and a
CRC-32C of all that precedes it. A node's body holds its height, a table of
the data files it references, and its entries in columns: keys with prefix
compression (relative to the prefix inherited from the parent), then for a
leaf each value, inline or as (file, offset, length) in a data file, and for
an interior node each child's location and the length of the key prefix
common to its subtree. Values are stored raw.

    store = OcdbtStore(step_dir / "state")
    store.keys()            # sorted
    store.get("params.stem.conv.kernel/.zarray")
"""

from __future__ import annotations

from pathlib import Path

from .zstd import decompress

__all__ = ["OcdbtError", "OcdbtStore", "crc32c"]

_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE
_MISSING = (1 << 64) - 1  # offset and length of an empty tree's root


class OcdbtError(ValueError):
    """Malformed or unsupported OCDBT data."""


def _crc_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as the OCDBT footer holds it."""
    c, t = 0xFFFFFFFF, _CRC_TABLE
    for b in data:
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    __slots__ = ("b", "i")

    def __init__(self, b: bytes):
        self.b, self.i = b, 0

    def varint(self) -> int:
        r = sh = 0
        while True:
            if self.i >= len(self.b):
                raise OcdbtError("truncated varint")
            c = self.b[self.i]
            self.i += 1
            r |= (c & 0x7F) << sh
            sh += 7
            if c < 0x80:
                return r

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.i + n > len(self.b):
            raise OcdbtError("truncated OCDBT body")
        out = self.b[self.i:self.i + n]
        self.i += n
        return out


def _decode(buf: bytes, magic: int, what: str) -> bytes:
    """Check an encoded manifest or node and return its (decompressed)
    body."""
    if len(buf) < 18 or int.from_bytes(buf[:4], "big") != magic:
        raise OcdbtError(f"{what}: bad magic")
    if int.from_bytes(buf[4:12], "little") != len(buf):
        raise OcdbtError(f"{what}: length does not match its header")
    if crc32c(buf[:-4]) != int.from_bytes(buf[-4:], "little"):
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    r = _Reader(buf[:-4])
    r.i = 12
    version, method = r.varint(), r.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version}")
    body = buf[r.i:-4]
    if method == 1:
        return decompress(body)
    if method != 0:
        raise OcdbtError(f"{what}: compression method {method}")
    return body


def _file_table(r: _Reader) -> list:
    """A node's or manifest's table of data files: paths relative to the
    store's directory, prefix-compressed."""
    n = r.varint()
    if n == 0:
        return []
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    r.varints(n)  # base path lengths: where base path and file name part
    paths, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + r.take(s)
        paths.append(prev.decode())
    return paths


def _keys(r: _Reader, n: int, interior: bool):
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    common = r.varints(n) if interior else None
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + r.take(s)
        keys.append(prev)
    return keys, common


class OcdbtStore:
    """The newest version of the OCDBT database in ``root``. Keys and value
    locations are read when the store opens; each data file is read at most
    once, when a value in it is first asked for."""

    def __init__(self, root):
        self.root = Path(root)
        self.bytes_read = 0
        self.height = None  # the root node's height; None for an empty store
        self._files: dict = {}
        self._values: dict = {}  # key -> bytes (inline) or (path, offset, length)
        body = _decode(self._read(self.root / "manifest.ocdbt"), _MANIFEST_MAGIC,
                       str(self.root / "manifest.ocdbt"))
        r = _Reader(body)
        r.take(16)  # uuid
        if r.varint() != 0:
            raise OcdbtError(f"{self.root}: numbered manifests are not supported")
        r.varint()  # max inline value bytes
        r.varint()  # max decoded node bytes
        r.take(1)  # version tree arity (log2)
        if r.varint() == 1:
            r.take(4)  # zstd level, int32
        files = _file_table(r)
        n = r.varint()
        if n == 0:
            return
        gens = r.varints(n)
        heights = list(r.take(n))
        fids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        latest = max(range(n), key=gens.__getitem__)
        if offsets[latest] == _MISSING:
            return
        self.height = heights[latest]
        self._walk(files[fids[latest]], offsets[latest], lengths[latest], heights[latest], b"")

    def _read(self, path: Path) -> bytes:
        data = self._files.get(path)
        if data is None:
            data = path.read_bytes()
            self.bytes_read += len(data)
            self._files[path] = data
        return data

    def _walk(self, file: str, offset: int, length: int, height: int, prefix: bytes):
        path = self.root / file
        buf = self._read(path)[offset:offset + length]
        if len(buf) != length:
            raise OcdbtError(f"{path}: node at {offset} runs past the file's end")
        r = _Reader(_decode(buf, _NODE_MAGIC, f"{path}@{offset}"))
        if r.take(1)[0] != height:
            raise OcdbtError(f"{path}@{offset}: height does not match its reference")
        files = _file_table(r)
        n = r.varint()
        keys, common = _keys(r, n, height > 0)
        if height > 0:
            fids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
            for i, key in enumerate(keys):
                self._walk(files[fids[i]], offs[i], lens[i], height - 1,
                           prefix + key[:common[i]])
            return
        lens = r.varints(n)
        kinds = r.varints(n)
        indirect = [i for i, k in enumerate(kinds) if k == 1]
        if any(k > 1 for k in kinds):
            raise OcdbtError(f"{path}@{offset}: unknown value kind")
        fids, offs = r.varints(len(indirect)), r.varints(len(indirect))
        for j, i in enumerate(indirect):
            self._values[prefix + keys[i]] = (files[fids[j]], offs[j], lens[i])
        for i, key in enumerate(keys):
            if kinds[i] == 0:
                self._values[prefix + key] = r.take(lens[i])

    def keys(self) -> list:
        return sorted(k.decode() for k in self._values)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._values

    def get(self, key: str) -> bytes:
        v = self._values[key.encode()]
        if isinstance(v, bytes):
            return v
        file, offset, length = v
        out = self._read(self.root / file)[offset:offset + length]
        if len(out) != length:
            raise OcdbtError(f"{self.root / file}: value of {key!r} runs past the file's end")
        return out
