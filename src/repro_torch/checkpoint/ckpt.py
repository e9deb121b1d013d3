"""Checkpoints of tensor trees in the reference's file format, byte for
byte: one msgpack map from each leaf's ``jax.tree_util.keystr`` path
(``['params']['embed']['table']``, ``[0]`` for a list or tuple entry) to
``{shape, dtype name, raw bytes}``, every key a bin, as the reference's
``msgpack.packb(..., use_bin_type=True)`` writes it.  A file either
package writes, the other restores.

The port writes and reads that format with its own encoder and decoder
of the subset ``packb`` emits for it (maps, bins, strs, arrays and
unsigned ints), so it needs no msgpack package.  Writing streams leaf by
leaf to a temporary file renamed into place (atomic), and reading seeks
past the leaves it does not want, so the host holds one leaf at a time.
Leaves are saved from any device and restored onto the device of the
``like`` tree's leaf; dtypes go by name (``bfloat16`` too).
``save_state`` / ``restore_state`` add the step count and an ``extra``
tree, under the reference's envelope ``{step, params, opt, extra}``.
"""
from __future__ import annotations

import os
import struct
from typing import Any, BinaryIO

import torch


# ---------------------------------------------------------------------------
# the msgpack subset
# ---------------------------------------------------------------------------


def _uint(n: int) -> bytes:
    if n < 0:
        raise ValueError(f"negative int {n} in a checkpoint header")
    if n < 0x80:
        return bytes([n])
    for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                           (0xCE, ">I", 0xFFFFFFFF)):
        if n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    return b"\xcf" + struct.pack(">Q", n)


def _sized(n: int, fix: int, fix_max: int, codes) -> bytes:
    """The header of a map, array, str or bin of ``n`` entries/bytes:
    the fix form below ``fix_max`` (when the type has one), else the
    8-, 16- or 32-bit length form."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in codes:
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"{n} entries exceed msgpack's 32-bit lengths")


_L8, _L16, _L32 = (">B", 0xFF), (">H", 0xFFFF), (">I", 0xFFFFFFFF)


def _map(n: int) -> bytes:
    return _sized(n, 0x80, 15, ((None, *_L8), (0xDE, *_L16),
                                (0xDF, *_L32)))


def _array(n: int) -> bytes:
    return _sized(n, 0x90, 15, ((None, *_L8), (0xDC, *_L16),
                                (0xDD, *_L32)))


def _str(s: str) -> bytes:
    raw = s.encode()
    return _sized(len(raw), 0xA0, 31, ((0xD9, *_L8), (0xDA, *_L16),
                                       (0xDB, *_L32))) + raw


def _bin_header(n: int) -> bytes:
    return _sized(n, None, -1, ((0xC4, *_L8), (0xC5, *_L16), (0xC6, *_L32)))


def _bin(raw: bytes) -> bytes:
    return _bin_header(len(raw)) + raw


class _Reader:
    """Reads the subset back from a binary file."""

    def __init__(self, f: BinaryIO):
        self.f = f

    def _take(self, n: int) -> bytes:
        raw = self.f.read(n)
        if len(raw) != n:
            raise ValueError("checkpoint file is truncated")
        return raw

    def _length(self, code: int, forms) -> int:
        for c, fmt in forms:
            if code == c:
                return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]
        raise ValueError(f"unexpected msgpack type byte 0x{code:02x}")

    def map_len(self) -> int:
        code = self._take(1)[0]
        if 0x80 <= code <= 0x8F:
            return code & 0x0F
        return self._length(code, ((0xDE, ">H"), (0xDF, ">I")))

    def bin_len(self) -> int:
        return self._length(self._take(1)[0],
                            ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")))

    def value(self):
        """One object of the subset: a str or bin is returned as bytes."""
        code = self._take(1)[0]
        if code < 0x80:
            return code
        if 0x80 <= code <= 0x8F:
            return {self.value(): self.value() for _ in range(code & 0x0F)}
        if 0x90 <= code <= 0x9F:
            return [self.value() for _ in range(code & 0x0F)]
        if 0xA0 <= code <= 0xBF:
            return self._take(code & 0x1F)
        uints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}
        if code in uints:
            fmt = uints[code]
            return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]
        raw = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",
               0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if code in raw:
            fmt = raw[code]
            n = struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]
            return self._take(n)
        if code in (0xDC, 0xDD):
            n = self._length(code, ((0xDC, ">H"), (0xDD, ">I")))
            return [self.value() for _ in range(n)]
        if code in (0xDE, 0xDF):
            n = self._length(code, ((0xDE, ">H"), (0xDF, ">I")))
            return {self.value(): self.value() for _ in range(n)}
        raise ValueError(f"unexpected msgpack type byte 0x{code:02x}")


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def _leaves_with_paths(tree, path: str = ""):
    """``(keystr path, leaf)`` in ``jax.tree_util``'s order: dict keys
    sorted, list and tuple entries by index, None an empty subtree."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves_with_paths(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves_with_paths(sub, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _rebuild(like, values):
    """A tree shaped like ``like`` with its leaves taken from ``values``
    in :func:`_leaves_with_paths` order."""
    if isinstance(like, dict):
        return {key: _rebuild(like[key], values) for key in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(sub, values) for sub in like)
    if like is None:
        return None
    return next(values)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def _dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"checkpoint dtype {name!r} is not a torch dtype")
    return dtype


def _as_tensor(leaf) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)


def _host_bytes(t: torch.Tensor) -> memoryview:
    """The leaf's raw bytes in row-major order, on the host."""
    flat = t.detach().contiguous().reshape(-1).cpu()
    return memoryview(flat.view(torch.uint8).numpy()).cast("B")


def save(path: str, tree: Any) -> None:
    leaves = list(_leaves_with_paths(tree))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_map(len(leaves)))
        for key, leaf in leaves:
            t = _as_tensor(leaf)
            f.write(_bin(key.encode()))
            f.write(_map(3))
            f.write(_bin(b"shape") + _array(t.dim())
                    + b"".join(_uint(n) for n in t.shape))
            f.write(_bin(b"dtype") + _str(_dtype_name(t.dtype)))
            raw = _host_bytes(t)
            f.write(_bin(b"data") + _bin_header(raw.nbytes))
            f.write(raw)
            del raw
    os.replace(tmp, path)


def _index(f: BinaryIO) -> dict:
    """key → (shape, dtype name, data offset, data bytes), seeking past
    every leaf's data."""
    r = _Reader(f)
    index = {}
    for _ in range(r.map_len()):
        key = r.value()
        entry = {}
        for _ in range(r.map_len()):
            name = r.value()
            if name == b"data":
                n = r.bin_len()
                entry[name] = (f.tell(), n)
                f.seek(n, os.SEEK_CUR)
            else:
                entry[name] = r.value()
        dtype = entry[b"dtype"]
        index[key] = (tuple(entry[b"shape"]), dtype.decode()
                      if isinstance(dtype, bytes) else dtype,
                      *entry[b"data"])
    return index


def _read_leaf(f: BinaryIO, shape, dtype_name: str, offset: int,
               nbytes: int, device) -> torch.Tensor:
    out = torch.empty(shape, dtype=_dtype(dtype_name))
    if out.numel() * out.element_size() != nbytes:
        raise ValueError(f"checkpoint leaf holds {nbytes} bytes, not the "
                         f"{out.numel() * out.element_size()} of {shape} "
                         f"{dtype_name}")
    f.seek(offset)
    if nbytes and f.readinto(out.reshape(-1).view(torch.uint8).numpy()) \
            != nbytes:
        raise ValueError("checkpoint file is truncated")
    return out.to(device)


def restore(path: str, like: Any) -> Any:
    """The tree ``like`` with each leaf read from ``path`` onto that
    leaf's device.  A leaf missing from the file raises ``KeyError``,
    one of another shape ``ValueError``."""
    with open(path, "rb") as f:
        index = _index(f)
        values = []
        for key, ref in _leaves_with_paths(like):
            k = key.encode()
            if k not in index:
                raise KeyError(f"checkpoint missing leaf {k!r}")
            shape, dtype_name, offset, nbytes = index[k]
            ref = _as_tensor(ref)
            if shape != tuple(ref.shape):
                raise ValueError(f"shape mismatch at {k!r}: {shape} vs "
                                 f"{tuple(ref.shape)}")
            values.append(_read_leaf(f, shape, dtype_name, offset, nbytes,
                                     ref.device))
    return _rebuild(like, iter(values))


def save_state(path: str, step: int, params: Any, opt_state: Any,
               extra: Any = ()) -> None:
    save(path, {"step": torch.tensor(step, dtype=torch.int32),
                "params": params, "opt": opt_state, "extra": extra})


def restore_state(path: str, params_like: Any, opt_like: Any,
                  extra_like: Any = ()):
    out = restore(path, {"step": torch.tensor(0, dtype=torch.int32),
                         "params": params_like, "opt": opt_like,
                         "extra": extra_like})
    return int(out["step"]), out["params"], out["opt"], out["extra"]
