"""TensorBoard event files without TensorFlow or PIL.

Counterpart of xdiffusion_tpu/tensorboard.py, the same wire format:

- a TFRecord stream: [uint64 length LE][masked crc32c(length)][payload]
  [masked crc32c(payload)], crc32c the Castagnoli polynomial, masked with
  TensorFlow's rotate-and-add constant;
- each payload a hand-encoded `Event` protobuf (wall_time, step, and a
  `Summary` of tagged `simple_value` floats or PNG images).

The JAX package encodes its images with PIL; here the PNG is encoded with
numpy and zlib the way PIL does it (each row takes the filter, of none, up,
sub and Paeth in that order, whose bytes read as signed sum to the least
magnitude; deflate at zlib's default level; IDAT chunks of at most 65,536
bytes), so the filtered rows are PIL's byte for byte. The deflate bytes are
the same where PIL links the same zlib.
"""

from __future__ import annotations

import os
import socket
import struct
import time
import zlib
from typing import Optional

import numpy as np

# --- crc32c (Castagnoli, reflected poly 0x82F63B78), table-driven -------

_CRC_TABLE = []


def _crc_table():
    if not _CRC_TABLE:
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
            _CRC_TABLE.append(crc)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- minimal protobuf wire encoding ------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field_varint(num: int, value: int) -> bytes:
    return _varint((num << 3) | 0) + _varint(value)


def _field_double(num: int, value: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", value)


def _field_bytes(num: int, value: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(value)) + value


def _summary_value_scalar(tag: str, value: float) -> bytes:
    # Summary.Value: tag = field 1 (string), simple_value = field 2 (float)
    return _field_bytes(1, tag.encode()) + _field_float(2, float(value))


def _summary_value_image(tag: str, png: bytes, h: int, w: int, c: int) -> bytes:
    # Summary.Image: height=1, width=2, colorspace=3, encoded = field 4
    img = _field_varint(1, h) + _field_varint(2, w) + _field_varint(3, c) + _field_bytes(4, png)
    # Summary.Value: tag = field 1, image = field 4 (message)
    return _field_bytes(1, tag.encode()) + _field_bytes(4, img)


def _event(step: int, summary_value: Optional[bytes] = None,
           file_version: Optional[str] = None) -> bytes:
    # Event: wall_time=1 (double), step=2 (int64), file_version=3
    # (string), summary=5 (Summary message; Summary.value = field 1).
    ev = _field_double(1, time.time()) + _field_varint(2, int(step))
    if file_version is not None:
        ev += _field_bytes(3, file_version.encode())
    if summary_value is not None:
        ev += _field_bytes(5, _field_bytes(1, summary_value))
    return ev


# --- PNG ----------------------------------------------------------------


def _filtered_rows(pixels: np.ndarray) -> bytes:
    """The PNG scanlines of (H, W, C) uint8 `pixels`, each behind its filter
    byte, the filter chosen per row as PIL's encoder chooses it."""
    h, w, c = pixels.shape
    rows = pixels.reshape(h, w * c).astype(np.int16)
    prior = np.zeros(w * c, np.int16)
    out = []
    for row in rows:
        left = np.concatenate([np.zeros(c, np.int16), row[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int16), prior[:-c]])
        p = left + prior - up_left
        pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - up_left)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, up_left))
        best = None
        for kind, data in ((0, row), (2, row - prior), (1, row - left), (4, row - paeth)):
            data = (data & 0xFF).astype(np.uint8)
            cost = int(np.minimum(data, 256 - data.astype(np.int64)).sum())
            if best is None or cost < best[0]:
                best = (cost, kind, data)
        out.append(bytes([best[1]]) + best[2].tobytes())
        prior = row
    return b"".join(out)


def encode_png(pixels: np.ndarray) -> bytes:
    """(H, W, C) uint8 pixels, C = 1 (grey), 3 (RGB) or 4 (RGBA), as PNG."""
    h, w, c = pixels.shape
    color = {1: 0, 3: 2, 4: 6}[c]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    packer = zlib.compressobj(zlib.Z_DEFAULT_COMPRESSION, zlib.DEFLATED, 15)
    stream = packer.compress(_filtered_rows(pixels)) + packer.flush()
    idat = b"".join(chunk(b"IDAT", stream[i:i + 65536])
                    for i in range(0, len(stream), 65536))
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + idat + chunk(b"IEND", b"")


class TensorBoardWriter:
    """SummaryWriter-shaped scalar/image event logger."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}.v2")
        self._file = open(os.path.join(logdir, fname), "ab")
        self._write_record(_event(0, file_version="brain.Event:2"))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._file.write(header)
        self._file.write(struct.pack("<I", _masked_crc(header)))
        self._file.write(payload)
        self._file.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(_event(step, _summary_value_scalar(tag, value)))

    def add_image(self, tag: str, image: np.ndarray, step: int) -> None:
        """image: (H, W, C) float in [0, 1] or uint8; C in {1, 3, 4}."""
        image = np.asarray(image)
        if image.dtype != np.uint8:
            image = (np.clip(image, 0.0, 1.0) * 255).astype(np.uint8)
        h, w, c = image.shape
        self._write_record(_event(step, _summary_value_image(tag, encode_png(image), h, w, c)))

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._file.close()
