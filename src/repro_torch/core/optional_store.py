"""The "lightweight file" — compressed key-value store for tier-1 units.

One ``optional.blob`` of concatenated per-unit frames plus a JSON manifest
mapping unit keys to (offset, csize, rsize, shape, dtype, codec). The format
is ``repro.core.optional_store``'s, byte for byte: a store written by either
package opens in the other, and the same units at the same level give the
same blob and manifest (tests/test_torch_store.py).

Codecs: ``raw`` (level 0), ``zlib``, and ``zlib-bp`` — 2-byte dtypes
(bf16/f16/i16) are byte-planed (all high bytes, then all low bytes) before
zlib, because homogeneous exponent bytes compress far better. Host tensors
are torch; bf16 moves through its ``uint16`` bit pattern (no ``ml_dtypes``).

Integrity: manifest v2 records the committed blob length and crc32, and
every IO/decode failure is a typed ``StoreError`` naming the unit key.
"""

from __future__ import annotations

import json
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.tensorstore_lite import dtype_name, from_bytes, to_numpy

MAGIC = b"FLT1"
MANIFEST_VERSION = 2

# max gap (bytes) between two manifest frames that one vectored pread may
# still bridge: one page
COALESCE_GAP = 4096

# units compressed at once by ``OptionalStoreWriter.add_all``
ENCODE_WORKERS = max(1, min(8, os.cpu_count() or 1))


class StoreError(Exception):
    """Base for every optional-store integrity failure; names the store path
    and, where one is involved, the unit key."""

    def __init__(self, msg: str, *, key: Optional[str] = None,
                 path: Optional[str] = None):
        self.key = key
        self.path = path
        where = f" (unit {key!r})" if key else ""
        src = f" [{path}]" if path else ""
        super().__init__(f"{msg}{where}{src}")


class TornFrameError(StoreError):
    """A frame read came back short (truncated or torn blob)."""


class CorruptFrameError(StoreError):
    """A frame's bytes don't decode, or decode to the wrong size."""


class StoreSkewError(StoreError):
    """Blob and manifest disagree (crash between the two commit renames, or
    files mixed from different builds)."""


@dataclass
class ReadStats:
    """Vectored-read accounting of one call (or summed over many): preads
    issued, frames delivered, payload bytes that came through multi-frame
    (coalesced) preads, and gap bytes read and discarded between them."""

    preads: int = 0
    frames: int = 0
    coalesced_bytes: int = 0
    gap_bytes: int = 0

    def add(self, other: "ReadStats") -> None:
        self.preads += other.preads
        self.frames += other.frames
        self.coalesced_bytes += other.coalesced_bytes
        self.gap_bytes += other.gap_bytes


@dataclass(frozen=True)
class Encoded:
    """One unit's frame, ready to append."""

    buf: bytes
    codec: str
    rsize: int
    shape: tuple
    dtype: str


def encode(t: torch.Tensor, level: int) -> Encoded:
    """Compress one host tensor exactly as the reference does. CPU-bound and
    GIL-free inside zlib, so callers may run it on worker threads."""
    arr = np.ascontiguousarray(to_numpy(t))
    meta = dict(rsize=arr.nbytes, shape=tuple(arr.shape), dtype=dtype_name(t.dtype))
    if level <= 0:
        return Encoded(arr.tobytes(), "raw", **meta)
    if arr.dtype.itemsize == 2:
        b = arr.reshape(-1).view(np.uint8).reshape(-1, 2)
        planed = np.concatenate([b[:, 1], b[:, 0]])
        return Encoded(zlib.compress(planed, level), "zlib-bp", **meta)
    return Encoded(zlib.compress(arr.reshape(-1).view(np.uint8), level), "zlib", **meta)


def _decode(buf: bytes, codec: str, shape: tuple, dtype: str) -> torch.Tensor:
    if codec == "raw":
        raw = bytearray(buf)
    elif codec == "zlib":
        raw = bytearray(zlib.decompress(buf))
    elif codec == "zlib-bp":
        planed = np.frombuffer(zlib.decompress(buf), np.uint8)
        n = planed.size // 2
        raw = np.empty((n, 2), np.uint8)
        raw[:, 1] = planed[:n]
        raw[:, 0] = planed[n:]
    else:
        raise ValueError(f"unknown codec {codec!r}")
    return from_bytes(raw, dtype, shape)


@dataclass
class StoreEntry:
    offset: int
    csize: int
    rsize: int
    shape: tuple
    dtype: str
    codec: str


class OptionalStoreWriter:
    """Streaming writer: units are appended one at a time.

    ``add`` encodes a host tensor; ``add_raw`` copies an already-compressed
    frame verbatim from another store (no decode, no recompress: the
    re-tiering copy rule). ``layout`` is recorded in the manifest, so a
    reader can tell a co-access-ordered blob from a build-order one.

    Commit order: blob rename first, then manifest rename; the manifest
    records the blob's committed length and crc32 so a crash between the two
    is detected at open (``StoreSkewError``).
    """

    def __init__(self, path: str, *, level: int = 6, layout: Optional[dict] = None):
        self.path = path
        self.level = level
        self.layout = dict(layout) if layout else {"source": "build-order"}
        self.manifest: Optional[dict] = None  # set by close()
        self._tmp = path + ".partial"
        self._f = open(self._tmp, "wb")
        self._f.write(MAGIC)
        self._offset = len(MAGIC)
        self._crc = zlib.crc32(MAGIC)
        self._manifest: dict[str, dict] = {}

    def append(self, key: str, enc: Encoded) -> None:
        if key in self._manifest:
            raise KeyError(f"duplicate unit key {key!r}")
        self._f.write(enc.buf)
        self._crc = zlib.crc32(enc.buf, self._crc)
        self._manifest[key] = dict(
            offset=self._offset,
            csize=len(enc.buf),
            rsize=enc.rsize,
            shape=list(enc.shape),
            dtype=enc.dtype,
            codec=enc.codec,
        )
        self._offset += len(enc.buf)

    def add(self, key: str, t: torch.Tensor) -> None:
        self.append(key, encode(t, self.level))

    def add_raw(self, key: str, buf: bytes, entry: "StoreEntry") -> None:
        """Append one compressed frame verbatim: ``buf`` is the exact frame a
        source store holds and ``entry`` its manifest entry there. The new
        entry keeps csize, rsize, shape, dtype and codec, at this blob's
        offset. A frame whose size disagrees with ``entry`` raises
        ``TornFrameError``."""
        if len(buf) != entry.csize:
            raise TornFrameError(f"raw frame is {len(buf)} bytes, manifest says {entry.csize}",
                                 key=key, path=self.path)
        self.append(key, Encoded(buf, entry.codec, entry.rsize, tuple(entry.shape), entry.dtype))

    def add_all(self, units: Iterable[tuple[str, torch.Tensor]]) -> None:
        """Append many units in order, compressing up to ``ENCODE_WORKERS``
        at once (zlib releases the GIL). At most ``2 * ENCODE_WORKERS`` units
        are held in flight; the blob is byte-identical to adding them one by
        one."""
        with ThreadPoolExecutor(ENCODE_WORKERS) as ex:
            pending: list = []
            for key, t in units:
                pending.append((key, ex.submit(encode, t, self.level)))
                if len(pending) >= 2 * ENCODE_WORKERS:
                    k, fut = pending.pop(0)
                    self.append(k, fut.result())
            for k, fut in pending:
                self.append(k, fut.result())

    def close(self) -> dict:
        self._f.close()
        os.replace(self._tmp, self.path)  # commit 1: blob visible
        man_path = self.path + ".manifest.json"
        tmp = man_path + ".partial"
        doc = {
            "version": MANIFEST_VERSION,
            "blob_len": self._offset,
            "blob_crc32": self._crc & 0xFFFFFFFF,
            "layout": self.layout,
            "entries": self._manifest,
        }
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, man_path)  # commit 2: manifest names the new blob
        self.manifest = self._manifest
        return self.manifest

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        else:
            self._f.close()
            if os.path.exists(self._tmp):
                os.remove(self._tmp)


class OptionalStore:
    """Read side — opened once at cold start; one read per miss. Byte reads
    are positioned (``os.preadv``), so concurrent readers share one handle."""

    def __init__(self, path: str):
        self.path = path
        try:
            with open(path + ".manifest.json") as f:
                man = json.load(f)
        except (json.JSONDecodeError, FileNotFoundError) as e:
            raise StoreSkewError(f"manifest unreadable: {e}", path=path) from e
        self.version = man.get("version", 1)
        if self.version not in (1, MANIFEST_VERSION):
            raise StoreError(f"unsupported manifest version {self.version!r}", path=path)
        self.blob_len: Optional[int] = man.get("blob_len")
        self.entries: dict[str, StoreEntry] = {
            k: StoreEntry(
                offset=v["offset"], csize=v["csize"], rsize=v["rsize"],
                shape=tuple(v["shape"]), dtype=v["dtype"], codec=v["codec"],
            )
            for k, v in man["entries"].items()
        }
        self._f = open(path, "rb")
        if self.blob_len is not None:
            actual = os.fstat(self._f.fileno()).st_size
            if actual != self.blob_len:
                self._f.close()
                raise StoreSkewError(
                    f"blob is {actual} bytes but the manifest committed "
                    f"{self.blob_len}", path=path)
        if self._f.read(len(MAGIC)) != MAGIC:
            self._f.close()
            raise StoreError("bad magic — not an optional store", path=path)

    def keys(self) -> Iterable[str]:
        return self.entries.keys()

    @property
    def compressed_bytes(self) -> int:
        return sum(e.csize for e in self.entries.values())

    @property
    def raw_bytes(self) -> int:
        return sum(e.rsize for e in self.entries.values())

    def _pread(self, offset: int, size: int) -> bytearray:
        """Positioned read of up to ``size`` bytes (short only at EOF). Loops:
        one pread returns at most ~2 GiB on Linux, less than a coalesced run
        of full-width expert frames."""
        buf = bytearray(size)
        got = 0
        with memoryview(buf) as view:
            while got < size:
                n = os.preadv(self._f.fileno(), [view[got:]], offset + got)
                if n == 0:
                    break
                got += n
        del buf[got:]
        return buf

    def read_raw(self, key: str, *, stats: Optional[ReadStats] = None) -> bytearray:
        """One unit's compressed frame; a short read raises ``TornFrameError``."""
        e = self.entries[key]
        try:
            buf = self._pread(e.offset, e.csize)
        except OSError as err:
            raise TornFrameError(f"frame read failed: {err}", key=key, path=self.path) from err
        if len(buf) != e.csize:
            raise TornFrameError(
                f"frame at offset {e.offset} is torn: wanted {e.csize} "
                f"bytes, blob yielded {len(buf)}", key=key, path=self.path)
        if stats is not None:
            stats.add(ReadStats(preads=1, frames=1))
        return buf

    def read_raw_many(self, keys: Iterable[str], *, gap_threshold: int = COALESCE_GAP,
                      stats: Optional[ReadStats] = None) -> dict[str, bytearray]:
        """Vectored read: frames within ``gap_threshold`` bytes of each other
        (in offset order) share one pread, then are sliced apart — the same
        bytes as per-key ``read_raw``; ``gap_threshold=0`` reads each frame
        with a pread of its own. Duplicate keys are deduped. ``stats``, if
        given, is added this call's preads, frames and coalesced bytes."""
        ks = list(dict.fromkeys(keys))
        if not ks:
            return {}
        ents = sorted(((k, self.entries[k]) for k in ks), key=lambda ke: ke[1].offset)
        runs: list[list[tuple[str, StoreEntry]]] = [[ents[0]]]
        for k, e in ents[1:]:
            prev = runs[-1][-1][1]
            gap = e.offset - (prev.offset + prev.csize)
            if gap_threshold > 0 and 0 <= gap <= gap_threshold:
                runs[-1].append((k, e))
            else:
                runs.append([(k, e)])
        out: dict[str, bytearray] = {}
        rs = ReadStats()
        for run in runs:
            start = run[0][1].offset
            end = run[-1][1].offset + run[-1][1].csize
            try:
                span = self._pread(start, end - start)
            except OSError as err:
                raise TornFrameError(f"frame read failed: {err}",
                                     key=run[0][0], path=self.path) from err
            for k, e in run:
                rel = e.offset - start
                buf = span[rel:rel + e.csize] if len(run) > 1 else span
                if len(buf) != e.csize:
                    raise TornFrameError(
                        f"frame at offset {e.offset} is torn: wanted "
                        f"{e.csize} bytes, blob yielded {len(buf)}",
                        key=k, path=self.path)
                out[k] = buf
            rs.preads += 1
            rs.frames += len(run)
            if len(run) > 1:
                payload = sum(e.csize for _, e in run)
                rs.coalesced_bytes += payload
                rs.gap_bytes += (end - start) - payload
        if stats is not None:
            stats.add(rs)
        return out

    def decode(self, key: str, buf: bytes) -> torch.Tensor:
        """Decompress one frame into a host tensor (safe off any lock).
        Undecodable or mis-sized frames raise ``CorruptFrameError``."""
        e = self.entries[key]
        try:
            t = _decode(buf, e.codec, e.shape, e.dtype)
        except (zlib.error, ValueError, TypeError) as err:
            raise CorruptFrameError(f"frame does not decode ({err})",
                                    key=key, path=self.path) from err
        nbytes = t.numel() * t.element_size()
        if nbytes != e.rsize:
            raise CorruptFrameError(f"decoded {nbytes} bytes, manifest says {e.rsize}",
                                    key=key, path=self.path)
        return t

    def fetch(self, key: str) -> torch.Tensor:
        return self.decode(key, self.read_raw(key))

    def close(self) -> None:
        self._f.close()


def write_store(path: str, units: Iterable[tuple[str, torch.Tensor]], *, level: int = 6) -> dict:
    with OptionalStoreWriter(path, level=level) as w:
        for key, t in units:
            w.add(key, t)
    return w.manifest
