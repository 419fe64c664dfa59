"""Wire encodings the request kinds (``requests/<kind>.py``) share: protobuf
fields by hand (the benchmark carries no generated stubs) and MCP's
JSON-RPC lines."""

from __future__ import annotations

import json
from typing import Iterator, Tuple, Union

import numpy as np


def varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def pb_field(num: int, wire: int, payload) -> bytes:
    """One protobuf field: a varint (``wire`` 0) or length-delimited bytes
    (``wire`` 2)."""
    tag = varint((num << 3) | wire)
    if wire == 0:
        return tag + varint(payload)
    return tag + varint(len(payload)) + payload


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def pb_fields(buf: bytes) -> Iterator[Tuple[int, Union[int, bytes]]]:
    """(field number, value) of each varint or length-delimited field."""
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        num, wire = tag >> 3, tag & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
            yield num, val
        elif wire == 2:
            n, i = _read_varint(buf, i)
            yield num, buf[i:i + n]
            i += n
        else:
            raise ValueError(f"unexpected wire type {wire}")


def mcp_tail(tool: str, args: dict) -> bytes:
    """The part of a ``tools/call`` JSON-RPC line after its id."""
    return (b'"method":"tools/call","params":{"name":"' + tool.encode()
            + b'","arguments":' + json.dumps(args).encode() + b"}}\n")


def mcp_request(rid: int, tail: bytes) -> bytes:
    return b'{"jsonrpc":"2.0","id":' + str(rid).encode() + b"," + tail


def int_id(s) -> int:
    """A served row id as an integer; -1 where it is none."""
    try:
        return int(s)
    except (TypeError, ValueError):
        return -1


def f32_bytes(rows: np.ndarray) -> bytes:
    return np.ascontiguousarray(rows, "<f4").tobytes()
