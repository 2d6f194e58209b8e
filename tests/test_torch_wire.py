"""The port's bp1 codec (``repro_torch.gateway.wire``) against the
reference's: the committed 28-frame corpus ``tests/fixtures/wire/``
rebuilt byte for byte and decoded back to each case spec (the logic of
``scripts/wire_conformance.py``, run on the port's codec), the codec's
round-trips (property-tested, and byte-equal to the reference codec's
frames for the same inputs), zero-copy payload decode, the framing
errors that make a server drop a connection, and ``scripts/wire_fuzz.py``'s
two tiers on the port: its codec tier, and its live tier's attacks thrown
at a port server."""
import asyncio
import importlib.util
import random
import re
import socket
import struct
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro.gateway import wire as jwire  # noqa: E402
from repro_torch.gateway import wire  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _conformance_on_port_codec():
    """``scripts/wire_conformance.py`` loaded as a module, its checks
    pointed at the port's codec (the script itself is not edited: its
    ``build``/``roundtrip``/``check`` read the module-level ``wire``)."""
    spec = importlib.util.spec_from_file_location(
        "wire_conformance_port", ROOT / "scripts" / "wire_conformance.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.wire = wire
    return mod


CONF = _conformance_on_port_codec()


def test_corpus_has_28_cases_on_disk():
    on_disk = sorted(p.stem for p in CONF.CORPUS_DIR.glob("*.bin"))
    assert on_disk == sorted(CONF.CASES) and len(on_disk) == 28


@pytest.mark.parametrize("name", sorted(CONF.CASES))
def test_corpus_frame_is_byte_exact_and_decodes_to_its_spec(name):
    committed = (CONF.CORPUS_DIR / f"{name}.bin").read_bytes()
    assert CONF.build(name) == committed
    assert CONF.roundtrip(name, committed) == []


def test_conformance_check_passes_on_the_port_codec(capsys):
    assert CONF.check(CONF.CORPUS_DIR) == 0
    assert "28 frames byte-exact" in capsys.readouterr().out


def test_constants_match_the_reference():
    for name in ("MAGIC", "VERSION", "PREAMBLE", "HEADER_SIZE", "FLAG_RESPONSE",
                 "FLAG_ERROR", "NO_REQUEST_ID", "OPCODE_BY_NAME", "NAME_BY_OPCODE",
                 "DEFAULT_MAX_FRAME_BYTES"):
        assert getattr(wire, name) == getattr(jwire, name), name


# -- codec (tests/test_wire.py's, each frame also byte-equal to the
# -- reference codec's) --------------------------------------------------


@settings(max_examples=60)
@given(opcode=st.integers(0, 255), flags=st.integers(0, 2 ** 32 - 1),
       rid=st.integers(0, 2 ** 64 - 1), plen=st.integers(0, 2 ** 20))
def test_header_pack_unpack_roundtrip(opcode, flags, rid, plen):
    buf = wire.pack_header(opcode, flags, rid, plen)
    assert len(buf) == wire.HEADER_SIZE
    assert buf == jwire.pack_header(opcode, flags, rid, plen)
    assert wire.unpack_header(buf) == (opcode, flags, rid, plen)


@settings(max_examples=40)
@given(rid=st.integers(0, 2 ** 32), n=st.integers(0, 64),
       tag=st.integers(0, 2 ** 30))
def test_payload_roundtrip_through_frame_reader(rid, n, tag):
    meta = {"n": n, "tag": str(tag), "nested": {"ok": True}}
    data = bytes((i * 7 + n) % 256 for i in range(n * 3))
    blob = wire.pack_frame(wire.OP_SCORE, rid, meta=meta, data=data)
    assert blob == jwire.pack_frame(jwire.OP_SCORE, rid, meta=meta, data=data)
    reader = wire.FrameReader()
    # split across feeds to exercise reassembly
    frames = reader.feed(blob[:13])
    frames += reader.feed(blob[13:])
    assert len(frames) == 1 and reader.pending_bytes == 0
    frame = frames[0]
    assert (frame.opcode, frame.req_id) == (wire.OP_SCORE, rid)
    got_meta, got_data = wire.split_payload(frame.payload)
    assert got_meta == meta and bytes(got_data) == data


def test_empty_payload_packs_to_empty_bytes():
    blob = wire.pack_frame(wire.OP_PING, 5)
    assert wire.unpack_header(blob)[3] == 0
    meta, data = wire.split_payload(b"")
    assert meta == {} and len(data) == 0


def test_frame_reader_rejects_bad_magic_version_and_oversize():
    good = wire.pack_frame(wire.OP_PING, 1)
    with pytest.raises(wire.WireProtocolError, match="magic"):
        wire.FrameReader().feed(b"zz" + good[2:])
    with pytest.raises(wire.WireProtocolError, match="version"):
        wire.FrameReader().feed(good[:2] + b"\x63" + good[3:])
    # an oversize length field is rejected from the 20 header bytes alone,
    # before any payload is buffered
    evil = bytearray(good)
    struct.pack_into("<I", evil, 16, 0xFFFFFFFF)
    reader = wire.FrameReader(max_frame_bytes=1 << 20)
    with pytest.raises(wire.WireProtocolError, match="payload"):
        reader.feed(bytes(evil))
    assert reader.pending_bytes <= wire.HEADER_SIZE


def test_split_payload_rejects_corrupt_meta():
    with pytest.raises(wire.WireProtocolError):
        wire.split_payload(struct.pack("<I", 999) + b"{}")  # meta_len > payload
    bad_json = b"{nope"
    with pytest.raises(wire.WireProtocolError):
        wire.split_payload(struct.pack("<I", len(bad_json)) + bad_json)
    with pytest.raises(wire.WireProtocolError):
        wire.split_payload(struct.pack("<I", 4) + b"[10]")  # meta not a dict


def test_decode_f32_is_zero_copy_and_validates_count():
    data = np.arange(24, dtype="<f4").tobytes()
    arr = wire.decode_f32(data, (2, 3, 4))
    assert arr.shape == (2, 3, 4)
    assert np.shares_memory(arr, np.frombuffer(data, "<f4"))
    np.testing.assert_array_equal(arr.ravel(), np.arange(24, dtype=np.float32))
    assert wire.encode_f32(arr) == data == jwire.encode_f32(arr)
    with pytest.raises(wire.WireProtocolError, match="float32"):
        wire.decode_f32(data, (5, 5))
    with pytest.raises(wire.WireProtocolError):
        wire.decode_f32(data[:-1], (24,))  # not a multiple of 4 bytes
    with pytest.raises(wire.WireProtocolError, match="negative"):
        wire.decode_f32(b"", (-1, 0))


def test_read_frame_from_a_stream_and_its_limits():
    """``read_frame`` (the server's reader) takes a frame off an asyncio
    stream, refuses an oversize length field before reading the payload,
    and ends with IncompleteReadError on a frame cut short."""
    blob = wire.pack_frame(wire.OP_STEP, 9, meta={"t": 1}, data=b"\0" * 8)

    async def read(chunks, limit=wire.DEFAULT_MAX_FRAME_BYTES):
        reader = asyncio.StreamReader()
        for chunk in chunks:
            reader.feed_data(chunk)
        reader.feed_eof()
        return await wire.read_frame(reader, limit)

    frame = asyncio.run(read([blob[:7], blob[7:]]))
    assert (frame.opcode, frame.req_id, frame.is_response) == (wire.OP_STEP, 9, False)
    assert wire.split_payload(frame.payload)[0] == {"t": 1}
    with pytest.raises(wire.WireProtocolError, match="exceeds"):
        asyncio.run(read([blob], limit=4))
    with pytest.raises(asyncio.IncompleteReadError):
        asyncio.run(read([blob[:-1]]))


# -- scripts/wire_fuzz.py on the port: its codec tier, and its live tier's
# -- attacks thrown at a port server ---------------------------------------


def _fuzz_on_port_codec():
    """``scripts/wire_fuzz.py`` loaded as a module, its codec pointed at the
    port's (the script reads the module-level ``wire``)."""
    spec = importlib.util.spec_from_file_location(
        "wire_fuzz_port", ROOT / "scripts" / "wire_fuzz.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.wire = wire
    return mod


FUZZ = _fuzz_on_port_codec()
FUZZ_SEED = 1302   # the script's default seed


def test_wire_fuzz_codec_tier_on_the_port_codec(capsys):
    """The codec tier at the script's 400 iterations: mutated frames in
    adversarial chunks parse or raise WireProtocolError, the reader never
    buffers past its cap, and fresh readers round-trip valid frames."""
    assert FUZZ.fuzz_codec(FUZZ_SEED, 400) == 0
    out = capsys.readouterr().out
    assert "400 iterations" in out
    rejected, tolerated = (int(x) for x in re.search(
        r"\((\d+) rejected, (\d+) tolerated\)", out).groups())
    assert rejected + tolerated == 400 and rejected > 0 and tolerated > 0


def test_wire_fuzz_live_attacks_leave_a_port_server_answering():
    """The live tier's 60 attacks (``_attack_bytes``: mutated frames after
    the preamble, truncated headers, oversize length fields, raw garbage on
    the JSON-lines path, bad magic, a doubled preamble) thrown at a port
    GatewayServer serving lstm-ae-f32-d2 on the CPU.  After every ten, and
    at the end on both protocols, a fresh connection still answers ping,
    score (bit-equal to the score before any attack) and step."""
    from repro_torch.engine import AnomalyService
    from repro_torch.gateway.client import GatewayClient
    from repro_torch.gateway.server import GatewayServer

    rng = random.Random(FUZZ_SEED)
    svc = AnomalyService("lstm-ae-f32-d2", schedule="wavefront", device="cpu")
    gw = svc.open_gateway(capacity=4, max_batch=4, max_wait_ms=5.0)
    server = GatewayServer(gw, port=0, pump_interval_ms=2.0)
    host, port = server.start_in_thread()
    feats = gw.pool.features
    window = np.linspace(0.0, 1.0, 8 * feats, dtype=np.float32).reshape(8, feats)
    try:
        with GatewayClient(host, port, protocol="binary") as c:
            oracle = c.score(window)
        for i in range(60):
            attack = FUZZ._attack_bytes(rng)
            with socket.create_connection((host, port), timeout=10) as s:
                # a short linger: an attack the server waits out (a header
                # cut short) must not hold the test for the script's 10 s
                s.settimeout(0.2)
                try:
                    s.sendall(attack)
                    if rng.random() < 0.5:
                        s.recv(4096)
                except OSError:
                    pass  # the server hanging up on us is a legal response
            if i % 10 == 9:
                proto = "binary" if rng.random() < 0.5 else "json"
                with GatewayClient(host, port, protocol=proto) as c:
                    assert c.request("ping")["ok"], f"attack {i}: ping failed"
                    assert c.score(window) == oracle, f"attack {i}: score drifted"
                    c.step(window[0])
        for proto in ("binary", "json"):
            with GatewayClient(host, port, protocol=proto) as c:
                assert c.ping()
                assert c.score(window) == oracle
    finally:
        server.stop_in_thread()
