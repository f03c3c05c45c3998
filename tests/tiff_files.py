"""Seeded damage to TIFF fixtures (numpy only, so that ``chip_smoke.py``
can rebuild the same files on the card's machine): byte mutations of
the strip and tile data, of the first directory's entries, and strips
or tiles whose byte count is cut short.  ``tests/data/tiff/make_fixtures.py``
records cv2's result for each in ``fixtures.json``.

The bases are classic TIFF files written by ``make_fixtures.write_tiff``:
the header, then the strips or tiles, then the directory, so the bytes
from 8 to the directory's offset are the chunks' data.
"""

import struct

import numpy as np


def mutation_rng(seed: int, name: str) -> np.random.Generator:
    """The generator of ``name``'s mutations: seeded by the seed and the
    base's file name, so each base's mutations stand alone."""
    return np.random.default_rng([seed, *name.encode()])


def _ifd(data: bytes):
    order = "<" if data[:2] == b"II" else ">"
    (first,) = struct.unpack(order + "I", data[4:8])
    return order, first


def mutate(data: bytes, rng: np.random.Generator) -> bytes:
    """1 to 3 bytes of the strip or tile data replaced, or with a bit
    flipped."""
    _, first = _ifd(data)
    d = bytearray(data)
    for _ in range(int(rng.integers(1, 4))):
        i = int(rng.integers(8, first))
        if rng.random() < 0.5:
            d[i] = int(rng.integers(0, 256))
        else:
            d[i] ^= 1 << int(rng.integers(0, 8))
    return bytes(d)


def mutate_entry(data: bytes, rng: np.random.Generator) -> bytes:
    """One byte of one entry of the first directory (its tag, type,
    count or value) replaced."""
    order, first = _ifd(data)
    (n,) = struct.unpack(order + "H", data[first:first + 2])
    d = bytearray(data)
    d[first + 2 + 12 * int(rng.integers(0, n)) + int(rng.integers(0, 12))] = int(
        rng.integers(0, 256))
    return bytes(d)


def chunk_counts(data: bytes) -> list:
    """The StripByteCounts or TileByteCounts values (LONG)."""
    order, first = _ifd(data)
    (n,) = struct.unpack(order + "H", data[first:first + 2])
    for k in range(n):
        e = first + 2 + 12 * k
        tag, kind, count = struct.unpack(order + "HHI", data[e:e + 8])
        if tag in (279, 325):
            assert kind == 4
            if count == 1:
                return [struct.unpack(order + "I", data[e + 8:e + 12])[0]]
            (at,) = struct.unpack(order + "I", data[e + 8:e + 12])
            return list(struct.unpack(f"{order}{count}I", data[at:at + 4 * count]))
    raise ValueError("no byte counts")


def cut(data: bytes, index: int, length: int) -> bytes:
    """The file with chunk ``index``'s byte count set to ``length``."""
    order, first = _ifd(data)
    (n,) = struct.unpack(order + "H", data[first:first + 2])
    d = bytearray(data)
    for k in range(n):
        e = first + 2 + 12 * k
        tag, kind, count = struct.unpack(order + "HHI", d[e:e + 8])
        if tag in (279, 325):
            at = e + 8 if count == 1 else struct.unpack(order + "I", d[e + 8:e + 12])[0]
            d[at + 4 * index:at + 4 * index + 4] = struct.pack(order + "I", length)
            return bytes(d)
    raise ValueError("no byte counts")


def cuts(data: bytes, step: int):
    """[(index, length)] of the chunks' byte counts cut to 1, 1 + step,
    ... bytes."""
    return [(index, length) for index, count in enumerate(chunk_counts(data))
            for length in range(1, count, step)]
