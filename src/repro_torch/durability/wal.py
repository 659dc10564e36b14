"""Write-ahead-log record codec: checksummed, length-prefixed frames.

A WAL *segment* is a byte string of back-to-back frames::

    | magic u32 | length u32 | crc32 u32 |  payload (length bytes)  |

(little-endian header). ``payload`` is the UTF-8 JSON encoding of one
``[op, obj]`` record, with numpy arrays encoded bitwise via the same
``(dtype, shape, base64)`` scheme the serverless payloads use
(``serverless.payload._enc``/``_dec``) — so params pytrees, forecast
bands and raw series round-trip byte-exact.

Decoding is *prefix-tolerant*: a segment whose tail was torn by a crash
(truncated mid-frame, or with flipped bytes in the last frame) decodes to
exactly the longest valid prefix of records — the frame whose magic,
bounds or checksum fails is dropped along with everything after it, and
decoding NEVER raises on malformed bytes. That is the whole recovery
contract: a kill -9 after any prefix of the record stream leaves a log
that replays to a consistent (possibly older) state, and the
boundary-stamped catch-up machinery regenerates the rest.
"""
from __future__ import annotations

import json
import struct
import zlib
from typing import Any, List, Tuple

from ..serverless.payload import _dec, _enc

#: per-frame magic: a corrupted length in frame k would otherwise let a
#: stale frame boundary masquerade as frame k+1; requiring the magic at
#: every boundary makes resynchronizing on garbage vanishingly unlikely
MAGIC = 0x57414C31  # "WAL1"

_HEADER = struct.Struct("<III")
HEADER_SIZE = _HEADER.size


def encode_record(op: str, obj: Any) -> bytes:
    """One framed record: header + JSON payload (arrays bitwise)."""
    payload = json.dumps([op, _enc(obj)],
                         separators=(",", ":")).encode("utf-8")
    return _HEADER.pack(MAGIC, len(payload),
                        zlib.crc32(payload)) + payload


def decode_payload(payload: bytes) -> Tuple[str, Any]:
    op, obj = json.loads(payload.decode("utf-8"))
    return op, _dec(obj)


def frame_records(payloads: List[bytes]) -> bytes:
    """Concatenate already-framed records into one segment blob."""
    return b"".join(payloads)


def decode_records(data: bytes) -> Tuple[List[Tuple[str, Any]], int, bool]:
    """Decode a segment into ``(records, valid_bytes, clean)``.

    ``records`` is the longest valid prefix of ``[op, obj]`` records;
    ``valid_bytes`` is how far into ``data`` that prefix extends;
    ``clean`` is True iff every byte decoded (no torn/corrupt tail).
    Malformed input is DATA, not an error — this never raises."""
    records: List[Tuple[str, Any]] = []
    pos = 0
    n = len(data)
    while pos + HEADER_SIZE <= n:
        magic, length, crc = _HEADER.unpack_from(data, pos)
        if magic != MAGIC:
            break                          # corrupted header
        end = pos + HEADER_SIZE + length
        if end > n:
            break                          # truncated mid-frame
        payload = data[pos + HEADER_SIZE:end]
        if zlib.crc32(payload) != crc:
            break                          # flipped payload bytes
        try:
            records.append(decode_payload(payload))
        except Exception:                  # crc collision on garbage JSON
            break
        pos = end
    return records, pos, pos == n


def split_frames(data: bytes) -> List[bytes]:
    """The valid prefix of a segment as individual framed records — what
    the chaos crash-point enumerator slices prefixes from."""
    frames: List[bytes] = []
    pos = 0
    records, valid, _clean = decode_records(data)
    del records
    while pos < valid:
        _magic, length, _crc = _HEADER.unpack_from(data, pos)
        end = pos + HEADER_SIZE + length
        frames.append(data[pos:end])
        pos = end
    return frames
