"""The safetensors format, read and written with torch alone (the card's
machine has no `safetensors` package).

A file is a little-endian u64 N, N bytes of JSON header, then the data.
The header maps each tensor's name to its `dtype`, `shape` and
`data_offsets` [begin, end) into the data, plus an optional
`__metadata__` of strings.  The data is memory-mapped
(`torch.UntypedStorage.from_file`), so the tensors `load_file` returns are
views of the file's pages: reading an 11 GB shard holds it once, in the
page cache, and copying a tensor to the card touches only its pages.  A
tensor whose offset is not a multiple of its element size is copied out.

Refused: a header that is not JSON or runs past the file, an unknown
dtype, offsets that do not tile the data exactly (an overlap, a hole, or
an end past the file: a truncated file), a size that is not the shape's,
and in `load_files` a name in two shards.
"""

from __future__ import annotations

import json
import math
import os
import struct
from typing import Dict, Iterable, Mapping, Optional

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}


def read_header(path: str) -> tuple:
    """(header dict without `__metadata__`, metadata or None, the data's
    offset in the file, the data's size)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: {size} bytes, no safetensors header")
        (n,) = struct.unpack("<Q", head)
        if 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes runs past the file ({size} bytes)")
        try:
            header = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: the header is not JSON: {e}") from e
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    meta = header.pop("__metadata__", None)
    data_size = size - 8 - n
    spans = []
    for name, entry in header.items():
        try:
            dtype, shape, (begin, end) = entry["dtype"], entry["shape"], entry["data_offsets"]
        except (TypeError, KeyError, ValueError) as e:
            raise ValueError(f"{path}: {name}: malformed entry {entry!r}") from e
        if dtype not in DTYPES:
            raise ValueError(f"{path}: {name}: unknown dtype {dtype!r}")
        if not all(isinstance(d, int) and d >= 0 for d in shape):
            raise ValueError(f"{path}: {name}: malformed shape {shape!r}")
        want = math.prod(shape) * DTYPES[dtype].itemsize
        if end - begin != want or begin < 0:
            raise ValueError(f"{path}: {name}: data_offsets [{begin}, {end}) do not hold "
                             f"{dtype} {shape} ({want} bytes)")
        spans.append((begin, end, name))
    at = 0
    for begin, end, name in sorted(spans):
        if begin != at:
            raise ValueError(f"{path}: {name}: data_offsets [{begin}, {end}) "
                             f"{'overlap' if begin < at else 'leave a hole after'} byte {at}")
        at = end
    if at != data_size:
        raise ValueError(f"{path}: the tensors end at data byte {at}, the file holds "
                         f"{data_size}{' (truncated)' if at > data_size else ''}")
    return header, meta, 8 + n, data_size


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """{name: tensor} of one file, on the CPU, memory-mapped."""
    header, _, start, _ = read_header(path)
    if not header:
        return {}
    size = os.path.getsize(path)
    raw = torch.empty(0, dtype=torch.uint8).set_(
        torch.UntypedStorage.from_file(path, shared=False, nbytes=size))
    out = {}
    for name, e in header.items():
        begin, end = e["data_offsets"]
        dtype = DTYPES[e["dtype"]]
        buf = raw[start + begin:start + end]
        if (start + begin) % dtype.itemsize:
            buf = buf.clone()
        out[name] = buf.view(dtype).reshape(e["shape"])
    return out


def load_files(paths: Iterable[str]) -> Dict[str, torch.Tensor]:
    """The union of several files' tensors (a sharded checkpoint,
    `*-0000k-of-0000n.safetensors`); a name in two files raises."""
    out: Dict[str, torch.Tensor] = {}
    where: Dict[str, str] = {}
    for path in paths:
        for name, t in load_file(path).items():
            if name in out:
                raise ValueError(f"{name} is in both {where[name]} and {path}")
            out[name], where[name] = t, path
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write `tensors` (any device; written in their dtype, in name order)
    as one safetensors file; returns the bytes written."""
    header: Dict[str, object] = {}
    at = 0
    for name in sorted(tensors):
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [at, at + n]}
        at += n
    if metadata:
        header["__metadata__"] = dict(metadata)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in sorted(tensors):
            t = tensors[name].detach().to("cpu").contiguous()
            f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
    return 8 + len(blob) + at
