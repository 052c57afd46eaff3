"""Hugging Face checkpoint directories, read and written without
``transformers`` or ``safetensors`` (the JAX package goes through
``from_pretrained`` and ``safetensors.torch.save_file``; this module stands
in for both, so ``convert-hf`` and ``export-hf`` run where neither library
is installed).

A directory holds ``config.json`` and the weights in one of four layouts:

  * ``model.safetensors``: an 8-byte little-endian header length N, N bytes
    of JSON (``{name: {"dtype", "shape", "data_offsets": [begin, end]}}``,
    offsets relative to the end of the header, plus an optional
    ``"__metadata__"`` of strings), then the raw little-endian bytes;
  * ``model.safetensors.index.json`` (``{"metadata": {"total_size"},
    "weight_map": {name: shard file}}``) over ``model-0000k-of-0000n
    .safetensors`` shards;
  * ``pytorch_model.bin`` (a ``torch.save`` of the state dict, read with
    ``weights_only=True``), or its ``pytorch_model.bin.index.json`` shards.

``read_state_dict`` returns a lazy mapping: a safetensors tensor is read
from its file when it is looked up, straight into the storage of a new
tensor (one copy, none held by the mapping), so a caller that stacks layer
by layer never holds two copies of the tree. ``write_state_dict`` streams
each tensor to its file in turn (a contiguous copy of one tensor at a time).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterator, Mapping

import torch

__all__ = ["SAFETENSORS_DTYPES", "read_config", "write_config",
           "read_safetensors_header", "write_safetensors", "HFStateDict",
           "read_state_dict", "write_state_dict", "config_value"]

#: safetensors dtype names and their torch dtypes
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in SAFETENSORS_DTYPES.items()}

SAFETENSORS = "model.safetensors"
SAFETENSORS_INDEX = "model.safetensors.index.json"
BIN = "pytorch_model.bin"
BIN_INDEX = "pytorch_model.bin.index.json"
CONFIG = "config.json"


def read_config(directory: str) -> dict:
    with open(os.path.join(directory, CONFIG)) as fh:
        return json.load(fh)


def write_config(directory: str, config: Mapping) -> None:
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, CONFIG), "w") as fh:
        json.dump(dict(config), fh, indent=2)


def read_safetensors_header(path: str) -> tuple:
    """(header without ``__metadata__``, byte offset of the data)."""
    with open(path, "rb") as fh:
        raw = fh.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file")
        (n,) = struct.unpack("<Q", raw)
        header = json.loads(fh.read(n).decode("utf-8"))
    header.pop("__metadata__", None)
    return header, 8 + n


def _read_tensor(fh, info: Mapping, start: int, name: str) -> torch.Tensor:
    dtype = SAFETENSORS_DTYPES.get(info["dtype"])
    if dtype is None:
        raise ValueError(f"{name}: safetensors dtype {info['dtype']!r} is "
                         "not supported")
    begin, end = info["data_offsets"]
    shape = [int(s) for s in info["shape"]]
    numel = 1
    for s in shape:
        numel *= s
    item = torch.empty((), dtype=dtype).element_size()
    if end - begin != numel * item:
        raise ValueError(f"{name}: {end - begin} bytes for shape {shape} of "
                         f"{info['dtype']}")
    out = torch.empty(end - begin, dtype=torch.uint8)
    fh.seek(start + begin)
    if end > begin and fh.readinto(out.numpy()) != end - begin:
        raise ValueError(f"{name}: the file ends inside the tensor")
    return out.view(dtype).reshape(shape)


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor]
                      ) -> int:
    """Write ``tensors`` (any device, layout or stride: each is copied to a
    contiguous host tensor when its turn comes) as one safetensors file;
    returns the data bytes. The header carries ``{"format": "pt"}``, which
    ``from_pretrained`` requires, and is padded with spaces to a multiple
    of 8 bytes, as ``safetensors`` writes it."""
    header: Dict[str, dict] = {"__metadata__": {"format": "pt"}}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             "name")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(raw)))
        fh.write(raw)
        for t in tensors.values():
            host = t.detach().to("cpu").contiguous()
            if host.numel():
                fh.write(host.reshape(-1).view(torch.uint8).numpy().data)
            del host
    return offset


class HFStateDict(Mapping):
    """The state dict of an HF directory as a read-only mapping: the keys
    come from the headers (or the ``.bin`` files), a value is read when it
    is looked up."""

    def __init__(self, directory: str):
        self.directory = directory
        self._where: Dict[str, tuple] = {}
        self._bin: Dict[str, torch.Tensor] = {}
        index = os.path.join(directory, SAFETENSORS_INDEX)
        bin_index = os.path.join(directory, BIN_INDEX)
        if os.path.exists(index):
            self.format = "safetensors"
            self._add_safetensors(_shards(index))
        elif os.path.exists(os.path.join(directory, SAFETENSORS)):
            self.format = "safetensors"
            self._add_safetensors([SAFETENSORS])
        elif os.path.exists(bin_index) or os.path.exists(
                os.path.join(directory, BIN)):
            self.format = "bin"
            files = _shards(bin_index) if os.path.exists(bin_index) else [BIN]
            for f in files:
                sd = torch.load(os.path.join(directory, f), map_location="cpu",
                                weights_only=True, mmap=True)
                self._bin.update(sd)
                self._where.update((k, (f, None, None)) for k in sd)
        else:
            raise FileNotFoundError(
                f"{directory}: no {SAFETENSORS}, {SAFETENSORS_INDEX}, {BIN} "
                f"or {BIN_INDEX}")

    def _add_safetensors(self, files) -> None:
        for f in files:
            path = os.path.join(self.directory, f)
            header, start = read_safetensors_header(path)
            for k, info in header.items():
                self._where[k] = (path, info, start)

    def __getitem__(self, key: str) -> torch.Tensor:
        if key in self._bin:
            return self._bin[key]
        path, info, start = self._where[key]
        with open(path, "rb") as fh:
            return _read_tensor(fh, info, start, key)

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)


def _shards(index_path: str) -> list:
    with open(index_path) as fh:
        weight_map = json.load(fh)["weight_map"]
    return list(dict.fromkeys(weight_map.values()))


def read_state_dict(directory: str) -> HFStateDict:
    """The (lazy) state dict of an HF checkpoint directory."""
    return HFStateDict(directory)


def write_state_dict(directory: str, tensors: Mapping[str, torch.Tensor], *,
                     format: str = "safetensors") -> str:
    """Write ``tensors`` into ``directory`` as one ``model.safetensors``
    or ``pytorch_model.bin`` (``format``); returns the file's path."""
    if format not in ("safetensors", "bin"):
        raise ValueError(f"format={format!r}: safetensors or bin")
    os.makedirs(directory, exist_ok=True)
    if format == "safetensors":
        path = os.path.join(directory, SAFETENSORS)
        write_safetensors(path, tensors)
    else:
        path = os.path.join(directory, BIN)
        torch.save({k: v.detach().to("cpu").contiguous().clone()
                    for k, v in tensors.items()}, path)
    return path


def config_value(hf_config, name: str, default=None):
    """A field of an HF config object or of its ``config.json`` dict."""
    if isinstance(hf_config, Mapping):
        return hf_config.get(name, default)
    return getattr(hf_config, name, default)
