"""bp1 — the gateway's length-prefixed binary wire format.

Counterpart of ``repro/gateway/wire.py``, byte for byte: the committed
corpus ``tests/fixtures/wire/`` defines both packages' frames, so either
package's client talks to either package's server.  The JSON-lines
protocol spends most of the wire's throughput on text framing and
float-list (de)serialization; ``bp1`` replaces the hot path with fixed
binary frames whose float32 payloads reach the micro-batcher via
``np.frombuffer`` — zero copy, no intermediate lists.

Frame layout (all integers little-endian)::

    offset  size  field
    0       2     magic        b"\\xb1P"
    2       1     version      1
    3       1     opcode       see OP_* below
    4       4     flags        bit0 RESPONSE, bit1 ERROR
    8       8     req_id       client-chosen; responses echo it
    16      4     payload_len  bytes following the header
    20      ...   payload      u32 meta_len | meta (UTF-8 JSON) | data

``meta`` is a compact JSON object carrying the same fields the JSON-lines
protocol would put in its request/response dict (minus ``op``/``id``,
which live in the header).  ``data`` is opcode-specific raw bytes:

* ``SCORE`` requests pack ``n`` windows of shape ``(t, f)`` as
  contiguous ``<f4`` (meta: ``{"n", "t", "f"}``); responses return ``n``
  float32 scores.
* ``STEP`` requests pack ``t`` samples of ``f`` features each (meta:
  ``{"t"}``); responses return ``t`` float32 running errors.
* every other opcode is a "generic meta frame": empty ``data``, the
  whole message in ``meta`` — which lets the server reuse the JSON-era
  ``_op_*`` handlers unchanged.

Negotiation: a binary client opens the connection with the 4-byte
``PREAMBLE`` line ``b"\\xb1P1\\n"``.  A bp1-capable server switches the
connection to frame mode and answers with a ``HELLO`` response frame; a
legacy JSON-lines server cannot decode the preamble as UTF-8 and answers
a JSON error line (first byte ``{``), which the client detects and falls
back to JSON on the same connection.  The preamble is intentionally not
valid JSON *and* not valid UTF-8 so no legacy exchange can collide with
it.

This module's codec core is stdlib-only (``struct`` + ``json``); the
float32 helpers import numpy lazily.
"""
from __future__ import annotations

import json
import struct
from typing import Any, Iterator, NamedTuple

MAGIC = b"\xb1P"
VERSION = 1
#: What a binary client writes first.  Read by the server's JSON readline
#: loop (it ends in \n); invalid UTF-8, so a legacy server answers a JSON
#: error line instead of crashing — that mismatch is the fallback signal.
PREAMBLE = MAGIC + b"1\n"

#: magic(2s) version(B) opcode(B) flags(I) req_id(Q) payload_len(I)
HEADER = struct.Struct("<2sBBIQI")
HEADER_SIZE = HEADER.size  # 20 bytes

FLAG_RESPONSE = 0x1
FLAG_ERROR = 0x2

#: req_id used for connection-level frames that answer no particular
#: request (the HELLO greeting, framing-error notices).  Clients must
#: never use it for a request.
NO_REQUEST_ID = 0xFFFFFFFFFFFFFFFF

OP_HELLO = 0x01
OP_PING = 0x02
OP_SCORE = 0x03
OP_STEP = 0x04
OP_CLOSE = 0x05
OP_RESUME = 0x06
OP_RECALIBRATE = 0x07
OP_STATS = 0x08
OP_SNAPSHOT = 0x09

OPCODE_BY_NAME = {
    "hello": OP_HELLO,
    "ping": OP_PING,
    "score": OP_SCORE,
    "step": OP_STEP,
    "close": OP_CLOSE,
    "resume": OP_RESUME,
    "recalibrate": OP_RECALIBRATE,
    "stats": OP_STATS,
    "snapshot": OP_SNAPSHOT,
}
NAME_BY_OPCODE = {code: name for name, code in OPCODE_BY_NAME.items()}

#: Default cap on a single frame's payload; mirrors GatewayServer's
#: max_line_bytes so neither protocol can make the server buffer more
#: than the other.
DEFAULT_MAX_FRAME_BYTES = 16 << 20

_META_LEN = struct.Struct("<I")


class WireProtocolError(ValueError):
    """A frame violated the bp1 format (bad magic/version, impossible
    length, malformed payload container).  Framing-level instances mean
    byte alignment is lost and the connection must be dropped;
    payload-level instances (raised after a complete frame was read) are
    answerable with an error frame."""


class Frame(NamedTuple):
    opcode: int
    flags: int
    req_id: int
    payload: bytes

    @property
    def is_response(self) -> bool:
        return bool(self.flags & FLAG_RESPONSE)

    @property
    def is_error(self) -> bool:
        return bool(self.flags & FLAG_ERROR)


def pack_header(opcode: int, flags: int, req_id: int, payload_len: int) -> bytes:
    return HEADER.pack(MAGIC, VERSION, opcode, flags, req_id, payload_len)


def pack_payload(meta: dict[str, Any] | None, data: bytes = b"") -> bytes:
    """u32 meta_len | compact sorted-key JSON | raw data.

    Sorted keys + compact separators make encoding deterministic, which
    the conformance corpus relies on for byte-exact comparisons.  A
    frame with no meta and no data packs to an empty payload.
    """
    if not meta and not data:
        return b""
    meta_bytes = b"" if not meta else json.dumps(
        meta, separators=(",", ":"), sort_keys=True
    ).encode("utf-8")
    return _META_LEN.pack(len(meta_bytes)) + meta_bytes + bytes(data)


def pack_frame(
    opcode: int,
    req_id: int,
    meta: dict[str, Any] | None = None,
    data: bytes = b"",
    flags: int = 0,
) -> bytes:
    payload = pack_payload(meta, data)
    return pack_header(opcode, flags, req_id, len(payload)) + payload


def unpack_header(buf: bytes | bytearray | memoryview) -> tuple[int, int, int, int]:
    """-> (opcode, flags, req_id, payload_len); raises WireProtocolError
    on short input, bad magic, or unsupported version."""
    if len(buf) < HEADER_SIZE:
        raise WireProtocolError(
            f"short header: {len(buf)} bytes, need {HEADER_SIZE}"
        )
    magic, version, opcode, flags, req_id, payload_len = HEADER.unpack_from(buf)
    if magic != MAGIC:
        raise WireProtocolError(f"bad magic {bytes(magic)!r}")
    if version != VERSION:
        raise WireProtocolError(f"unsupported bp1 version {version}")
    return opcode, flags, req_id, payload_len


def split_payload(payload: bytes | memoryview) -> tuple[dict[str, Any], memoryview]:
    """Split a frame payload into (meta dict, data view).

    The returned data is a memoryview into ``payload`` — no copy — which
    is what lets ``np.frombuffer`` hand the batcher a view of the recv
    buffer.
    """
    view = memoryview(payload)
    if len(view) == 0:
        return {}, view
    if len(view) < _META_LEN.size:
        raise WireProtocolError("payload shorter than its meta_len prefix")
    (meta_len,) = _META_LEN.unpack_from(view)
    if _META_LEN.size + meta_len > len(view):
        raise WireProtocolError(
            f"meta_len {meta_len} overruns payload of {len(view)} bytes"
        )
    if meta_len == 0:
        meta: dict[str, Any] = {}
    else:
        try:
            meta = json.loads(bytes(view[_META_LEN.size:_META_LEN.size + meta_len]))
        except (ValueError, UnicodeDecodeError) as exc:
            raise WireProtocolError(f"meta is not valid JSON: {exc}") from None
        if not isinstance(meta, dict):
            raise WireProtocolError("meta must be a JSON object")
    return meta, view[_META_LEN.size + meta_len:]


class FrameReader:
    """Incremental frame decoder for a byte stream.

    Feed it arbitrary chunks; it yields complete frames and raises
    WireProtocolError the moment the stream stops being bp1 — critically,
    *before* buffering a payload whose advertised length exceeds
    ``max_frame_bytes`` (an adversarial length field must not cause a
    giant allocation).
    """

    def __init__(self, max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES) -> None:
        self.max_frame_bytes = int(max_frame_bytes)
        self._buf = bytearray()

    def feed(self, chunk: bytes) -> list[Frame]:
        self._buf += chunk
        return list(self._drain())

    def _drain(self) -> Iterator[Frame]:
        while len(self._buf) >= HEADER_SIZE:
            opcode, flags, req_id, payload_len = unpack_header(self._buf)
            if payload_len > self.max_frame_bytes:
                raise WireProtocolError(
                    f"payload_len {payload_len} exceeds max frame "
                    f"size {self.max_frame_bytes}"
                )
            end = HEADER_SIZE + payload_len
            if len(self._buf) < end:
                return
            payload = bytes(self._buf[HEADER_SIZE:end])
            del self._buf[:end]
            yield Frame(opcode, flags, req_id, payload)

    @property
    def pending_bytes(self) -> int:
        return len(self._buf)


async def read_frame(reader, max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES) -> Frame:
    """Read one frame from an asyncio StreamReader.

    Raises asyncio.IncompleteReadError on EOF (clean or mid-frame) and
    WireProtocolError on bad magic/version or an oversize length field —
    checked before the payload is read, so a hostile header never makes
    the server allocate its advertised length.
    """
    header = await reader.readexactly(HEADER_SIZE)
    opcode, flags, req_id, payload_len = unpack_header(header)
    if payload_len > max_frame_bytes:
        raise WireProtocolError(
            f"payload_len {payload_len} exceeds max frame size {max_frame_bytes}"
        )
    payload = await reader.readexactly(payload_len) if payload_len else b""
    return Frame(opcode, flags, req_id, payload)


# --- float32 helpers (numpy imported lazily: the codec core above is
# --- stdlib only) ------------------------------------------------------


def encode_f32(arr) -> bytes:
    """ndarray -> contiguous little-endian float32 bytes."""
    import numpy as np

    return np.ascontiguousarray(arr, dtype="<f4").tobytes()


def decode_f32(data, shape: tuple[int, ...]):
    """bytes/memoryview -> float32 ndarray *view* of ``data`` (zero copy).

    Validates the element count against ``shape`` before reshaping so a
    lying meta header turns into a WireProtocolError, not a numpy crash.
    """
    import numpy as np

    if len(data) % 4:
        raise WireProtocolError(
            f"payload length {len(data)} is not a multiple of float32 size"
        )
    arr = np.frombuffer(data, dtype="<f4")
    expected = 1
    for dim in shape:
        if dim < 0:
            raise WireProtocolError(f"negative dimension in shape {shape}")
        expected *= dim
    if arr.size != expected:
        raise WireProtocolError(
            f"payload carries {arr.size} float32 values, shape {shape} "
            f"needs {expected}"
        )
    return arr.reshape(shape)
