"""Model checkpoint IO (port of pero_ocr_tpu/utils/checkpoint.py).

The JAX package stores flax variables with
``flax.serialization.to_bytes``: msgpack of nested string-keyed maps
whose array leaves are msgpack extension objects.  The card's machine
has no msgpack package, so this module reads and writes the format
itself, in pure Python and numpy (:func:`save_variables` writes the
bytes ``to_bytes`` writes for the same tree).  The reader takes:

- every msgpack type: nil, bool, all int widths, float32/64,
  str8/16/32, bin8/16/32, arrays, maps, fixext and ext8/16/32;
- flax's extension types: 1 (ndarray: a msgpack ``(shape, dtype name,
  raw C-order bytes)``), 2 (complex: ``(real, imag)``) and 3 (numpy
  scalar, packed as a 0-d ndarray).  A ``bfloat16`` leaf, which numpy
  lacks, becomes a ``torch.bfloat16`` tensor;
- arrays over flax's ``MAX_CHUNK_SIZE`` (2**30 bytes), which flax writes
  as a map with the key ``__msgpack_chunked_array__``, are reassembled.

The writer packs what a flax parameter checkpoint holds, in
``msgpack.packb``'s encodings: str-keyed dicts (in insertion order, as
``to_bytes`` keeps them), str, bool, non-negative int, bytes, tuples,
and numpy arrays and ``torch`` tensors (extension type 1; a bfloat16
tensor under flax's dtype name ``bfloat16``).  Arrays over
``MAX_CHUNK_SIZE`` are written chunked, as flax writes them.

Loading policy, as in the JAX package: by default a missing or
unreadable checkpoint falls back to the caller's initialisation with a
warning; the CLI calls :func:`set_strict_loading` so that it raises
(``FileNotFoundError`` for a missing file, ``ValueError`` for one that
does not decode or does not fit the model).  The port's fallback is the
seeded torch initialisation of its modules, which is not flax's
initialisation: random weights differ between the two packages.
"""

from __future__ import annotations

import logging
import os
import struct
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

_STRICT_LOADING = False

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED_KEY = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE, bytes


class ExtType(NamedTuple):
    """An extension object of a type this decoder does not interpret
    (compares equal to ``msgpack.ExtType``)."""

    code: int
    data: bytes


def set_strict_loading(strict: bool) -> None:
    """Make missing/corrupt checkpoints a hard error process-wide.

    Called by the CLI unless the user passes ``--allow-random-weights``."""
    global _STRICT_LOADING
    _STRICT_LOADING = bool(strict)


def strict_loading_enabled() -> bool:
    return _STRICT_LOADING


# ----------------------------------------------------------------------
# msgpack decoding
_FIXED = {  # first byte -> (struct format, size) of fixed-width scalars
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LENGTH = {1: ">B", 2: ">H", 4: ">I"}
_STR = {0xD9: 1, 0xDA: 2, 0xDB: 4}
_BIN = {0xC4: 1, 0xC5: 2, 0xC6: 4}
_ARRAY = {0xDC: 2, 0xDD: 4}
_MAP = {0xDE: 2, 0xDF: 4}
_EXT = {0xC7: 1, 0xC8: 2, 0xC9: 4}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack data ends inside an object")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def length(self, width: int) -> int:
        return self.unpack(_LENGTH[width], width)

    def value(self, ext_hook) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self._map(b & 0x0F, ext_hook)
        if b <= 0x9F:
            return [self.value(ext_hook) for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            return self.unpack(*_FIXED[b])
        if b in _STR:
            return self._str(self.length(_STR[b]))
        if b in _BIN:
            return bytes(self.take(self.length(_BIN[b])))
        if b in _ARRAY:
            return [self.value(ext_hook) for _ in range(self.length(_ARRAY[b]))]
        if b in _MAP:
            return self._map(self.length(_MAP[b]), ext_hook)
        if b in _EXT or b in _FIXEXT:
            n = self.length(_EXT[b]) if b in _EXT else _FIXEXT[b]
            code = self.unpack(">b", 1)
            return ext_hook(code, self.take(n))
        raise ValueError(f"msgpack: invalid first byte 0x{b:02x}")

    def _str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def _map(self, n: int, ext_hook) -> dict:
        out = {}
        for _ in range(n):
            key = self.value(ext_hook)
            out[key] = self.value(ext_hook)
        return out


def unpackb(data, ext_hook: Optional[Callable[[int, memoryview], Any]] = None) -> Any:
    """Decode one msgpack object that fills ``data`` exactly.  Strings
    decode as ``str`` (UTF-8), bin as ``bytes``, arrays as lists.
    ``ext_hook(code, payload)`` decodes extension objects; without it
    they come back as :class:`ExtType`."""
    if ext_hook is None:
        ext_hook = _plain_ext
    reader = _Reader(data)
    out = reader.value(ext_hook)
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} trailing bytes")
    return out


def _plain_ext(code: int, payload: memoryview) -> ExtType:
    return ExtType(code, bytes(payload))


# ----------------------------------------------------------------------
# msgpack encoding
def _head(n: int, tags) -> bytes:
    """The first byte(s) of an object of size ``n``: the first
    (limit, tag, struct format) of ``tags`` whose limit holds ``n``; a
    format of None ORs ``n`` into the tag (fix types)."""
    for limit, tag, fmt in tags:
        if n <= limit:
            return bytes([tag | n]) if fmt is None else bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: size {n} too large")


_U8, _U16, _U32 = 0xFF, 0xFFFF, 0xFFFFFFFF
_STR_TAGS = ((31, 0xA0, None), (_U8, 0xD9, ">B"), (_U16, 0xDA, ">H"), (_U32, 0xDB, ">I"))
_BIN_TAGS = ((_U8, 0xC4, ">B"), (_U16, 0xC5, ">H"), (_U32, 0xC6, ">I"))
_ARRAY_TAGS = ((15, 0x90, None), (_U16, 0xDC, ">H"), (_U32, 0xDD, ">I"))
_MAP_TAGS = ((15, 0x80, None), (_U16, 0xDE, ">H"), (_U32, 0xDF, ">I"))
_EXT_TAGS = ((_U8, 0xC7, ">B"), (_U16, 0xC8, ">H"), (_U32, 0xC9, ">I"))
_FIXEXT_TAGS = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_uint(n: int) -> bytes:
    """msgpack's smallest encoding of an integer ``n >= 0``."""
    if 0 <= n < 0x80:
        return bytes([n])
    for hi, tag, fmt in ((_U8, 0xCC, ">B"), (_U16, 0xCD, ">H"), (_U32, 0xCE, ">I"),
                         (2**64 - 1, 0xCF, ">Q")):
        if 0 <= n <= hi:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: integer {n} is negative or too large")


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    head = bytes([_FIXEXT_TAGS[n]]) if n in _FIXEXT_TAGS else _head(n, _EXT_TAGS)
    return head + struct.pack(">b", code) + payload


def _array_payload(arr) -> bytes:
    """flax's ndarray payload: msgpack of (shape, dtype name, C bytes)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu()
        if arr.dtype == torch.bfloat16:
            raw = arr.contiguous().view(torch.int16).numpy().tobytes()
            return packb((tuple(arr.shape), "bfloat16", raw))
        arr = arr.numpy()
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured dtypes are not supported")
    return packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


def _pack(obj, out: list) -> None:
    if obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        out.append(_pack_uint(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_head(len(raw), _STR_TAGS) + raw)
    elif isinstance(obj, bytes):
        out.append(_head(len(obj), _BIN_TAGS) + obj)
    elif isinstance(obj, tuple):
        out.append(_head(len(obj), _ARRAY_TAGS))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        out.append(_head(len(obj), _MAP_TAGS))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        out.append(_pack_ext(EXT_NDARRAY, _array_payload(obj)))
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    """msgpack bytes of ``obj``, equal to ``msgpack.packb(obj,
    default=<flax's extension hook>)`` for the types the module
    docstring lists; any other raises ``TypeError``."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


def _itemsize(arr) -> int:
    return arr.element_size() if isinstance(arr, torch.Tensor) else arr.dtype.itemsize


def _nbytes(arr) -> int:
    return arr.numel() * arr.element_size() if isinstance(arr, torch.Tensor) else arr.nbytes


def _chunked(arr) -> dict:
    """flax's ``_chunk``: the flat array in pieces of at most
    MAX_CHUNK_SIZE bytes, with the shape."""
    flat = arr.reshape(-1)
    step = max(1, MAX_CHUNK_SIZE // _itemsize(arr))
    chunks = [flat[i:i + step] for i in range(0, flat.shape[0], step)]
    return {CHUNKED_KEY: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_tree(node):
    if isinstance(node, dict):
        return {k: _chunk_tree(v) for k, v in node.items()}
    if isinstance(node, (np.ndarray, torch.Tensor)) and _nbytes(node) > MAX_CHUNK_SIZE:
        return _chunked(node)
    return node


def msgpack_serialize(tree) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize(tree,
    in_place=True)`` (what ``to_bytes`` calls) writes for a tree of
    str-keyed dicts with array leaves: the dicts in their own key order,
    arrays over MAX_CHUNK_SIZE bytes chunked (``tree`` itself is not
    modified)."""
    return packb(_chunk_tree(tree))


# ----------------------------------------------------------------------
# flax's tree format
def _ndarray(payload: memoryview):
    shape, name, raw = unpackb(payload)
    if isinstance(name, bytes):
        name = name.decode("ascii")
    shape = tuple(int(d) for d in shape)
    if name == "bfloat16":
        # Native byte order, as numpy's own names (``tobytes("C")``).
        bits = np.frombuffer(raw, dtype=np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"flax checkpoint: unknown dtype {name!r}") from e
    if dtype.hasobject:
        raise ValueError(f"flax checkpoint: object dtype {name!r}")
    return np.frombuffer(raw, dtype=dtype).reshape(shape)


def _flax_ext(code: int, payload: memoryview):
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_COMPLEX:
        real, imag = unpackb(payload)
        return complex(real, imag)
    if code == EXT_NPSCALAR:
        arr = _ndarray(payload)
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    return _plain_ext(code, payload)


def _unchunk(node: dict):
    shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
    chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(node):
    if isinstance(node, dict):
        if CHUNKED_KEY in node:
            return _unchunk(node)
        return {k: _unchunk_tree(v) for k, v in node.items()}
    return node


def msgpack_restore(data) -> Any:
    """The tree that ``flax.serialization.msgpack_restore`` returns for
    ``data``: nested dicts with numpy array and scalar leaves
    (``torch.bfloat16`` tensors for bfloat16 leaves)."""
    return _unchunk_tree(unpackb(data, _flax_ext))


def is_torchscript_file(path: str) -> bool:
    """TorchScript archives are zip files; flax msgpack checkpoints are
    not: the 4-byte magic tells them apart."""
    try:
        with open(path, "rb") as f:
            return f.read(4) == b"PK\x03\x04"
    except OSError:
        return False


def to_state_dict(tree) -> Any:
    """flax's ``to_state_dict`` of a tree of dicts, lists and tuples:
    str keys, and lists and tuples as dicts keyed "0", "1", ..."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def save_variables(variables: Any, path: str) -> None:
    """Write ``variables`` (nested str-keyed dicts of numpy arrays or
    tensors) as the JAX package's ``save_variables`` does
    (``flax.serialization.to_bytes``: the same bytes), so that both
    packages' ``load_variables`` read it."""
    data = msgpack_serialize(to_state_dict(variables))
    with open(path, "wb") as f:
        f.write(data)


def load_variables(path: str) -> Any:
    """The variables tree stored at ``path`` by the JAX package's
    ``save_variables`` (``flax.serialization.to_bytes``)."""
    with open(path, "rb") as f:
        data = f.read()
    return msgpack_restore(data)


def load_or_init(
    checkpoint: Optional[str],
    init_fn: Callable[[], Any],
    name: str = "model",
    restore: Optional[Callable[[Any], Any]] = None,
) -> Any:
    """``restore(load_variables(checkpoint))`` if ``checkpoint`` exists
    (``restore`` defaults to returning the tree), else ``init_fn()``.

    A checkpoint that fails to decode or to restore raises
    ``ValueError`` under :func:`set_strict_loading` and otherwise falls
    back to ``init_fn()`` with a warning; a missing one raises
    ``FileNotFoundError`` under strict loading and otherwise falls back
    with a warning."""
    if checkpoint and os.path.exists(checkpoint):
        try:
            tree = load_variables(checkpoint)
            return restore(tree) if restore is not None else tree
        except Exception as e:
            if _STRICT_LOADING:
                raise ValueError(
                    f"Failed to load {name} checkpoint {checkpoint}: {e}"
                ) from e
            logger.warning(
                "Failed to load %s checkpoint %s (%s); using random init.",
                name, checkpoint, e,
            )
    elif checkpoint:
        if _STRICT_LOADING:
            raise FileNotFoundError(
                f"Checkpoint {checkpoint} for {name} not found. "
                "Fix the path, or pass --allow-random-weights to run "
                "with random initialization."
            )
        logger.warning(
            "Checkpoint %s for %s not found; using RANDOM weights "
            "(output will be garbage text).", checkpoint, name,
        )
    return init_fn()
