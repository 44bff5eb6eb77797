"""RecordIO: ``MXRecordIO``, ``MXIndexedRecordIO``, ``IRHeader`` and
``pack``/``unpack``/``pack_img``/``unpack_img``.

Port of ``mxtpu/recordio.py`` (which mirrors ``python/mxnet/recordio.py``
and dmlc-core's on-disk format), kept as the port's own copy. Each record
is ``[magic:4][lrecord:4][data][pad to 4]``: lrecord's upper 3 bits are
the continuation flag (unused: records are single chunks) and its lower
29 bits the length. Files written by either package read in the other.
``pack_img`` and ``unpack_img`` encode and decode with Pillow, as the JAX
package does in place of the reference's OpenCV.
"""

from __future__ import annotations

import os
import struct
from collections import namedtuple
from typing import Optional

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xCED7230A
_LMASK = (1 << 29) - 1

IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class MXRecordIO:
    """Sequential record reader (``flag="r"``) or writer (``"w"``)."""

    def __init__(self, uri: str, flag: str):
        self.uri = uri
        self.flag = flag
        self.open()

    def open(self):
        if self.flag == "w":
            self._f = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self._f = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError(f"invalid flag {self.flag!r}")
        self._closed = False

    def close(self):
        if not self._closed:
            self._f.close()
            self._closed = True

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def reset(self):
        self.close()
        self.open()

    def tell(self) -> int:
        return self._f.tell()

    def seek(self, pos: int):
        if self.writable:
            raise IOError("seek on a RecordIO file opened for writing")
        self._f.seek(pos)

    def write(self, buf: bytes):
        if not self.writable:
            raise IOError("write on a RecordIO file opened for reading")
        self._f.write(struct.pack("<II", _MAGIC, len(buf) & _LMASK))
        self._f.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self._f.write(b"\x00" * pad)

    def read(self) -> Optional[bytes]:
        """The next record's payload, or ``None`` at the end of the file."""
        if self.writable:
            raise IOError("read on a RecordIO file opened for writing")
        head = self._f.read(8)
        if len(head) < 8:
            return None
        magic, lrec = struct.unpack("<II", head)
        if magic != _MAGIC:
            raise IOError(f"invalid RecordIO magic at {self._f.tell() - 8}")
        length = lrec & _LMASK
        data = self._f.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self._f.read(pad)
        return data


class MXIndexedRecordIO(MXRecordIO):
    """Random access through an ``.idx`` sidecar (``key\\toffset`` lines).
    Without one, a reader indexes the file by scanning it (the native
    ``rio_index`` where the library is built, else in Python); its keys are
    then 0, 1, ..."""

    def __init__(self, idx_path: str, uri: str, flag: str, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if not self.writable and os.path.isfile(idx_path):
            with open(idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) != 2:
                        continue
                    key = key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)
        elif not self.writable:
            for i, p in enumerate(self._scan()):
                key = key_type(i)
                self.idx[key] = int(p)
                self.keys.append(key)

    def _scan(self):
        """Each record's start offset."""
        from . import native
        try:
            offsets, _ = native.rio_index(self.uri)
            return offsets - 8            # payload start less the header
        except (RuntimeError, IOError):
            positions = []
            pos = self.tell()
            while self.read() is not None:
                positions.append(pos)
                pos = self.tell()
            self.seek(0)
            return positions

    def close(self):
        if self.writable and not getattr(self, "_closed", True):
            with open(self.idx_path, "w") as f:
                for k in self.keys:
                    f.write(f"{k}\t{self.idx[k]}\n")
        super().close()

    def read_idx(self, idx) -> bytes:
        self.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf: bytes):
        pos = self.tell()
        self.write(buf)
        self.idx[idx] = pos
        self.keys.append(idx)


def pack(header: IRHeader, s: bytes) -> bytes:
    """A header and payload as one record; a vector label is stored after
    the header, its length in ``flag``."""
    label = header.label
    if isinstance(label, (list, tuple, np.ndarray)) and not np.isscalar(label):
        label = np.asarray(label, np.float32)
        header = header._replace(flag=label.size, label=0.0)
        return struct.pack(_IR_FORMAT, header.flag, header.label, header.id,
                           header.id2) + label.tobytes() + s
    return struct.pack(_IR_FORMAT, header.flag, float(label), header.id,
                       header.id2) + s


def unpack(s: bytes):
    """A record as ``(IRHeader, payload)``; a vector label comes back as a
    float32 array."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    payload = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(payload[:header.flag * 4], np.float32)
        header = header._replace(label=label)
        payload = payload[header.flag * 4:]
    return header, payload


def pack_img(header: IRHeader, img: np.ndarray, quality: int = 95,
             img_fmt: str = ".jpg") -> bytes:
    """Encode an HWC uint8 image (JPEG or PNG, with Pillow) and pack it."""
    import io
    from PIL import Image
    buf = io.BytesIO()
    arr = np.asarray(img, np.uint8)
    pil = Image.fromarray(arr.squeeze() if arr.ndim == 3 and arr.shape[2] == 1
                          else arr)
    fmt = {"jpg": "JPEG", "jpeg": "JPEG", "png": "PNG"}[
        img_fmt.lstrip(".").lower()]
    pil.save(buf, format=fmt, quality=quality)
    return pack(header, buf.getvalue())


def unpack_img(s: bytes, iscolor: int = -1):
    """Unpack a record and decode its image with Pillow: ``(header,
    HWC uint8 array)``."""
    import io
    from PIL import Image
    header, payload = unpack(s)
    return header, np.asarray(Image.open(io.BytesIO(payload)))
