"""``mx.recordio``: the packed binary record format (JAX counterpart:
``recordio.py``, which imports no JAX; the port keeps its own copy).

Reference parity: dmlc-core recordio (``dmlc::RecordIOWriter/Reader``) and
``python/mxnet/recordio.py`` (``MXRecordIO``, ``MXIndexedRecordIO``,
``IRHeader``/``pack``/``unpack``/``pack_img``/``unpack_img``) — SURVEY §2.6.

Wire format (dmlc recordio, so ``.rec`` files interoperate): each record
is ``uint32 magic (0xced7230a)``, ``uint32 lrecord`` whose upper 3 bits are
a continuation flag and lower 29 bits the payload length, then the payload
padded to 4 bytes. The native writer splits a payload that holds the
magic into continuation parts (dmlc's escape); the pure-Python writer
writes every record whole. Both readers read both layouts, and each
writer's files are byte-identical to the JAX package's same writer.
``MXTPU_NO_NATIVE`` forces the pure-Python reader and writer.
"""
from __future__ import annotations

import os
import struct
from collections import namedtuple
from typing import Dict, List, Optional

import numpy as onp

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xCED7230A
_KMAGIC = struct.pack("<I", _MAGIC)


def _lrec(length: int, cflag: int) -> int:
    return (cflag << 29) | length


def _decode_lrec(lrec: int):
    return lrec & ((1 << 29) - 1), lrec >> 29


def _native():
    """The C++ recordio parser (native/mxtpu_native.cc) when buildable;
    ``MXTPU_NO_NATIVE`` set to anything forces the pure-Python path."""
    if os.environ.get("MXTPU_NO_NATIVE"):
        return None
    from . import native
    return native if native.available() else None


class MXRecordIO:
    """Sequential .rec reader/writer (reference: dmlc::RecordIOWriter).

    Uses the C++ parser (native/mxtpu_native.cc — the src/io/ counterpart)
    when available; the pure-Python path below is the fallback and the
    format specification."""

    def __init__(self, uri: str, flag: str):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self._nat = None
        self.open()

    def open(self):
        nat = _native()
        if self.flag == "w":
            self.writable = True
            if nat is not None:
                self._nat = nat.NativeRecordWriter(self.uri)
                self.handle = None
            else:
                self.handle = open(self.uri, "wb")
        elif self.flag == "r":
            self.writable = False
            if nat is not None:
                self._nat = nat.NativeRecordReader(self.uri)
                self.handle = None
            else:
                self.handle = open(self.uri, "rb")
        else:
            raise MXNetError(f"Invalid flag {self.flag!r} (use 'r' or 'w')")
        self.is_open = True

    def close(self):
        if self.is_open:
            if self._nat is not None:
                self._nat.close()
                self._nat = None
            if self.handle is not None:
                self.handle.close()
            self.is_open = False

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001  a finalizer must not raise
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def reset(self):
        self.close()
        self.open()

    def tell(self) -> int:
        if self._nat is not None:
            return self._nat.tell()
        return self.handle.tell()

    def seek(self, pos: int):
        if self._nat is not None:
            self._nat.seek(pos)
        else:
            self.handle.seek(pos)

    def write(self, buf: bytes) -> int:
        """Append one record; returns its byte offset."""
        if not self.writable:
            raise MXNetError("recordio not opened for writing")
        if self._nat is not None:
            return self._nat.write(buf)
        pos = self.handle.tell()
        # NB: unlike the native writer this simple path does not split
        # payloads containing the magic; the reader handles both layouts.
        self.handle.write(_KMAGIC)
        self.handle.write(struct.pack("<I", _lrec(len(buf), 0)))
        self.handle.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self.handle.write(b"\x00" * pad)
        return pos

    def read(self) -> Optional[bytes]:
        if self.writable:
            raise MXNetError("recordio not opened for reading")
        if self._nat is not None:
            return self._nat.read()
        parts: List[bytes] = []
        while True:
            head = self.handle.read(8)
            if len(head) < 8:
                return b"".join(parts) if parts else None
            magic, lrec = struct.unpack("<II", head)
            if magic != _MAGIC:
                raise MXNetError("invalid record magic — corrupt .rec file")
            length, cflag = _decode_lrec(lrec)
            data = self.handle.read(length)
            pad = (4 - length % 4) % 4
            if pad:
                self.handle.read(pad)
            parts.append(data)
            # cflag: 0 whole, 1 start, 2 middle, 3 end. dmlc's writer splits
            # a payload at embedded magic bytes (removing them); its reader
            # re-inserts the magic between parts — so must we.
            if cflag in (0, 3):
                return parts[0] if len(parts) == 1 else _KMAGIC.join(parts)


class MXIndexedRecordIO(MXRecordIO):
    """Random-access .rec via .idx sidecar (reference: MXIndexedRecordIO).
    The idx file is ``key\\tbyte_offset`` per line, tool-compatible with
    im2rec output."""

    def __init__(self, idx_path: str, uri: str, flag: str, key_type=int):
        self.idx_path = idx_path
        self.idx: Dict = {}
        self.keys: List = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if not self.writable and os.path.isfile(idx_path):
            with open(idx_path) as f:
                for line in f:
                    key, pos = line.strip().split("\t")
                    key = key_type(key)
                    self.idx[key] = int(pos)
                    self.keys.append(key)

    def close(self):
        if getattr(self, "writable", False) and getattr(self, "is_open", False):
            with open(self.idx_path, "w") as f:
                for k in self.keys:
                    f.write(f"{k}\t{self.idx[k]}\n")
        super().close()

    def seek(self, idx):
        MXRecordIO.seek(self, self.idx[idx])

    def read_idx(self, idx) -> bytes:
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf: bytes):
        pos = self.write(buf)
        self.idx[idx] = pos
        self.keys.append(idx)


IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header: IRHeader, s: bytes) -> bytes:
    """Pack a label header + payload (reference: recordio.pack). Multi-label
    goes in ``flag`` = label count with labels prepended as float32s."""
    header = IRHeader(*header)
    label = header.label
    if isinstance(label, (onp.ndarray, list, tuple)):
        label = onp.asarray(label, dtype=onp.float32)
        header = header._replace(flag=label.size, label=0.0)
        payload = label.tobytes() + s
    else:
        payload = s
    return struct.pack(_IR_FORMAT, int(header.flag), float(header.label),
                       int(header.id), int(header.id2)) + payload


def unpack(s: bytes):
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    payload = s[_IR_SIZE:]
    if header.flag > 0:
        n = header.flag
        label = onp.frombuffer(payload[:4 * n], dtype=onp.float32)
        header = header._replace(label=label)
        payload = payload[4 * n:]
    return header, payload


def encode_img(img, quality: int = 95, img_fmt: str = ".jpg") -> bytes:
    """Encode an image to jpg/png bytes (the cv2 half of pack_img; shared
    with the native im2rec packer so both paths stay byte-identical)."""
    import cv2
    params = [cv2.IMWRITE_JPEG_QUALITY, quality] if img_fmt in (".jpg", ".jpeg") \
        else [cv2.IMWRITE_PNG_COMPRESSION, quality // 10]
    ok, buf = cv2.imencode(img_fmt, img, params)
    if not ok:
        raise MXNetError(f"failed to encode image as {img_fmt}")
    return buf.tobytes()


def pack_img(header: IRHeader, img, quality: int = 95, img_fmt: str = ".jpg") -> bytes:
    return pack(header, encode_img(img, quality=quality, img_fmt=img_fmt))


def unpack_img(s: bytes, iscolor: int = -1):
    import cv2
    header, payload = unpack(s)
    img = cv2.imdecode(onp.frombuffer(payload, dtype=onp.uint8), iscolor)
    return header, img
