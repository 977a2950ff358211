"""Minimal TIFF codec, as in ``c_raytracer_tpu.image.tiff``: the
reference's two output formats, byte for byte the files the JAX package
writes.

The reference writes (image.c:64-139):
  * default: 8-bit RGB, strip-per-row, top-left orientation, contiguous;
  * with -f: raw float32 RGB plus the full z-buffer under custom tag 65000
    ("ZBuffer", TIFF_FLOAT) for the postprocess handoff.

NumPy only, little-endian, uncompressed.  A tag's values are packed as one
NumPy array of the tag's type, not one ``struct.pack`` per value: the
same bytes, without a million calls for the z tag of a 1024x1024 frame.
The reader accepts both these files and libtiff's (postprocess/image.c:
30-79 checks: 3 samples/pixel, 8- or 32-bit, contiguous).
"""

from __future__ import annotations

import struct

import numpy as np

_Z_BUFFER_TAG = 65000  # image.c:27

# TIFF type ids
_BYTE, _ASCII, _SHORT, _LONG, _RATIONAL, _FLOAT = 1, 2, 3, 4, 5, 11
_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 11: 4}
_TYPE_DTYPE = {3: "<u2", 4: "<u4", 11: "<f4"}
_INT_MAX = {3: 0xFFFF, 4: 0xFFFFFFFF}


def _payload(typ: int, values) -> bytes:
    """The little-endian bytes of a tag's values."""
    if typ in _INT_MAX:
        v = np.asarray(values, np.int64)
        if v.size and (v.min() < 0 or v.max() > _INT_MAX[typ]):
            raise ValueError(f"TIFF value out of range for type {typ}")
        return v.astype(_TYPE_DTYPE[typ]).tobytes()
    return np.asarray(values, _TYPE_DTYPE[typ]).tobytes()


def _pack_entries(entries, data_start):
    """entries: list of (tag, type, values).  Returns (ifd_bytes,
    extra_data_bytes); values longer than 4 bytes go to the data area."""
    ifd = []
    extra = []
    n_extra = 0
    for tag, typ, values in sorted(entries, key=lambda e: e[0]):
        count = len(values)
        size = _TYPE_SIZE[typ] * count
        payload = _payload(typ, values)
        if size <= 4:
            value_field = payload + b"\x00" * (4 - size)
        else:
            value_field = struct.pack("<I", data_start + n_extra)
            extra.append(payload)
            n_extra += size
        ifd.append(struct.pack("<HHI", tag, typ, count) + value_field)
    return b"".join(ifd), b"".join(extra)


def _write(path, width, height, bits, pixel_bytes, strip_data, z_buffer=None):
    # 10 fixed tags + SampleFormat + StripOffsets (+ ZBuffer)
    n_entries = 12 + (1 if z_buffer is not None else 0)
    header_size = 8
    ifd_offset = header_size
    ifd_size = 2 + n_entries * 12 + 4
    data_start = ifd_offset + ifd_size

    # strips: one per row (image.c:131 ROWSPERSTRIP=1)
    row_bytes = width * pixel_bytes
    # layout: [ifd extra data][zbuffer][strips]
    entries = [
        (256, _LONG, [width]),            # ImageWidth
        (257, _LONG, [height]),           # ImageLength
        (258, _SHORT, [bits, bits, bits]),  # BitsPerSample
        (259, _SHORT, [1]),               # Compression: none
        (262, _SHORT, [2]),               # Photometric: RGB
        (274, _SHORT, [1]),               # Orientation: top-left
        (277, _SHORT, [3]),               # SamplesPerPixel
        (278, _LONG, [1]),                # RowsPerStrip
        (279, _LONG, np.full(height, row_bytes)),  # StripByteCounts
        (284, _SHORT, [1]),               # PlanarConfig: contiguous
    ]
    if bits == 32:
        entries.append((339, _SHORT, [3, 3, 3]))  # SampleFormat: IEEE float
    else:
        entries.append((339, _SHORT, [1, 1, 1]))  # unsigned

    # the strips follow the extra data, whose size the offsets' values do
    # not change: pack once with placeholder offsets to find where
    placeholder = [(273, _LONG, np.zeros(height, np.int64))] + entries
    if z_buffer is not None:
        placeholder.append((_Z_BUFFER_TAG, _FLOAT, z_buffer))
    _, extra_try = _pack_entries(placeholder, data_start)
    strips_start = data_start + len(extra_try)
    strip_offsets = strips_start + np.arange(height, dtype=np.int64) * row_bytes

    final = [(273, _LONG, strip_offsets)] + placeholder[1:]
    ifd, extra = _pack_entries(final, data_start)
    if len(extra) != len(extra_try):
        raise AssertionError("TIFF extra data changed size")

    with open(path, "wb") as f:
        f.write(b"II*\x00" + struct.pack("<I", ifd_offset))
        f.write(struct.pack("<H", n_entries) + ifd + struct.pack("<I", 0))
        f.write(extra)
        f.write(strip_data)


def quantize_rgb8(image: np.ndarray) -> np.ndarray:
    """C clamp order (image.c:96-98): fmaxf(fminf(v·255, 255), 0) — both
    fminf and fmaxf ignore NaN operands, so NaN and +inf quantize to 255.
    The clip comes before the multiply, so a huge finite value does not
    overflow the float32 product."""
    img = np.asarray(image, np.float32)
    v = np.clip(img, 0.0, 1.0) * np.float32(255.0)
    v = np.where(np.isnan(img), np.float32(255.0), v)
    return v.astype(np.uint8)


def write_tiff_rgb8(path: str, image: np.ndarray) -> None:
    """8-bit output: clamp linear radiance ×255 (image.c:94-99)."""
    img = np.asarray(image, np.float32)
    h, w, _ = img.shape
    _write(path, w, h, 8, 3, quantize_rgb8(img).tobytes())


def write_tiff_raw(path: str, image: np.ndarray, z_buffer: np.ndarray) -> None:
    """-f raw output: float32 raster + z-buffer tag (image.c:64-85)."""
    img = np.ascontiguousarray(np.asarray(image, np.float32))
    z = np.asarray(z_buffer, np.float32).reshape(-1)
    h, w, _ = img.shape
    _write(path, w, h, 32, 12, img.tobytes(), z_buffer=z)


def read_tiff(path: str):
    """Read an uncompressed contiguous RGB TIFF (8-bit or float32).

    Returns (image (h, w, 3) float32 in [0,1] for 8-bit / raw values for
    float32, z_buffer (h*w,) float32 or None).
    Mirrors the postprocess loader's checks (pp/image.c:41-70).
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"II":
        end = "<"
    elif data[:2] == b"MM":
        end = ">"
    else:
        raise ValueError(f"Not a TIFF file [{path}].")
    magic, = struct.unpack(end + "H", data[2:4])
    if magic != 42:
        raise ValueError(f"Not a TIFF file [{path}].")
    off, = struct.unpack(end + "I", data[4:8])

    tags = {}
    n, = struct.unpack(end + "H", data[off:off + 2])
    for i in range(n):
        e = off + 2 + 12 * i
        tag, typ, count = struct.unpack(end + "HHI", data[e:e + 8])
        size = _TYPE_SIZE.get(typ, 1) * count
        if size <= 4:
            voff = e + 8
        else:
            voff, = struct.unpack(end + "I", data[e + 8:e + 12])
        fmt = {1: "u1", 3: "u2", 4: "u4", 11: "f4"}.get(typ)
        if fmt is None:
            continue
        if voff + size > len(data):
            raise ValueError(f"Truncated TIFF tag {tag} in [{path}].")
        tags[tag] = np.frombuffer(data, np.dtype(end + fmt), count, voff)

    width = int(tags[256][0])
    height = int(tags[257][0])
    bits = int(tags.get(258, (8,))[0])
    spp = int(tags.get(277, (1,))[0])
    if spp != 3 or bits not in (8, 32):
        raise ValueError(
            f"Expected 3 samples of 8/32 bits in TIFF [{path}].")
    if tags.get(284, (1,))[0] != 1:
        raise ValueError(f"Expected contiguous planar config in [{path}].")
    if tags.get(259, (1,))[0] != 1:
        raise ValueError(f"Compressed TIFF not supported [{path}].")

    offsets = tags[273]
    counts = tags.get(279)
    rows_per_strip = int(tags.get(278, (height,))[0])
    row_bytes = width * 3 * (bits // 8)
    buf = b"".join(
        data[int(so):int(so) + (int(counts[i]) if counts is not None
                                else row_bytes * rows_per_strip)]
        for i, so in enumerate(offsets))
    dt = np.uint8 if bits == 8 else np.dtype(end + "f4")
    img = np.frombuffer(buf, dtype=dt)[:height * width * 3]
    img = img.astype(np.float32).reshape(height, width, 3)
    if bits == 8:
        img = img / np.float32(255.0)

    z = None
    if _Z_BUFFER_TAG in tags:
        z = np.array(tags[_Z_BUFFER_TAG], np.float32)  # a writable copy
    return img, z
