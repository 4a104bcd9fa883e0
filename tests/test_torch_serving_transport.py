"""The port's streaming dataplane (``paddle_tpu_torch/serving/transport.py``)
against the reference's (``paddle_tpu/serving/transport.py``).

No model, no engine. The frame codec survives any re-chunking and writes
the same bytes as the reference's ``encode_frame`` for the same frame;
server / client reply, a frame larger than the socket buffers crosses in
one poll of the worker's listener, a peer stalled mid-frame costs the
router's link no wait and is dropped by the listener after
``_IO_TIMEOUT``, and a client outlives a server restart; the chaos
``net_fence`` modes; the KV wire: ``raw`` bit-equal (bf16 pages as their
16-bit words), int8 pool scales passed through, ``int8`` q equal to the
reference's and scales within 1 f32 ulp (both quantize in f32 with round
half to even), the frame size equal to the arithmetic; ``SeqChannels``;
the ``tq`` codec bit-equal on f32 (and bf16 words on its bf16 wire).
"""
import pickle
import struct
import time

import numpy as np
import pytest
import torch

from paddle_tpu.serving import transport as ref_transport
from paddle_tpu_torch.framework.dtype import from_host, to_host
from paddle_tpu_torch.serving import transport
from paddle_tpu_torch.serving.transport import (FrameDecoder, SeqChannels,
                                                TransportClient,
                                                TransportServer, decode_kv,
                                                encode_frame, encode_kv)

FRAMES = [
    {"t": "hello", "peer": "router", "name": "router"},
    {"t": "dispatch", "reqs": [{"rid": 0, "seq": 0,
                                "prompt": list(range(40)),
                                "params": {"max_new_tokens": 8}}]},
    {"t": "occ", "occ": {"beat": 3, "acked_seq": 1}, "ts": 12.5},
    {"t": "done", "recs": [{"rid": 0, "tokens": [1, 2, 3]}]},
    {"t": "kv", "k": np.arange(24, dtype=np.float32).reshape(2, 3, 4)},
]


@pytest.mark.parametrize("chunk", [1, 2, 3, 7, None])
def test_frame_codec_roundtrip_any_chunking(chunk):
    blob = b"".join(encode_frame(f) for f in FRAMES)
    chunk = chunk or len(blob)
    dec = FrameDecoder()
    got = []
    for i in range(0, len(blob), chunk):
        got.extend(dec.feed(blob[i:i + chunk]))
    assert len(got) == len(FRAMES)
    for g, f in zip(got[:-1], FRAMES[:-1]):
        assert g == f
    np.testing.assert_array_equal(got[-1]["k"], FRAMES[-1]["k"])


def test_frame_bytes_equal_reference():
    for f in FRAMES:
        assert encode_frame(f) == ref_transport.encode_frame(f)
    # and each side decodes the other's bytes
    (back,) = ref_transport.FrameDecoder().feed(encode_frame(FRAMES[1]))
    assert back == FRAMES[1]
    (back,) = FrameDecoder().feed(ref_transport.encode_frame(FRAMES[3]))
    assert back == FRAMES[3]


def _poll_until(fn, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(0.005)
    raise AssertionError("transport poll timed out")


def test_server_client_roundtrip_and_reply():
    server = TransportServer()
    client = TransportClient(server.addr)
    try:
        assert client.send({"t": "hello", "peer": "router", "name": "r"})
        (cid, frame), = _poll_until(server.poll)
        assert frame == {"t": "hello", "peer": "router", "name": "r"}
        assert cid in server.conn_ids()
        assert server.send(cid, {"t": "done", "recs": [{"rid": 7}]})
        (reply,) = _poll_until(client.poll)
        assert reply["recs"][0]["rid"] == 7
    finally:
        client.close()
        server.close()


def test_a_started_frame_is_read_to_its_end_in_one_poll():
    """A frame larger than the socket buffers (a long prompt's KV pages)
    is received whole by the poll that sees its first bytes, while the
    sender's one ``sendall`` runs in another thread."""
    import threading

    big = {"t": "kv", "k": np.arange(6 << 20, dtype=np.float32)}  # 24 MB
    server = TransportServer()
    client = TransportClient(server.addr)
    sent = []
    try:
        t = threading.Thread(target=lambda: sent.append(client.send(big)))
        t.start()
        deadline = time.monotonic() + 20.0
        got = []
        while not got and time.monotonic() < deadline:
            got = server.poll()
            # no poll returns with a frame half read
            assert not any(d.partial() for d in server._decoders.values())
        t.join(20.0)
        assert not t.is_alive() and sent == [True]
        (cid, frame), = got
        np.testing.assert_array_equal(frame["k"], big["k"])
    finally:
        client.close()
        server.close()


def test_a_link_never_waits_on_a_peer_stalled_mid_frame():
    """The router's link (a ``TransportClient``) reads only what is
    buffered: a peer that sends half a frame and stalls costs its poll no
    wait, keeps the connection, and the frame arrives whole once the rest
    does."""
    import socket

    listener = socket.create_server(("127.0.0.1", 0))
    client = TransportClient("127.0.0.1:%d" % listener.getsockname()[1])
    peer, _ = listener.accept()
    try:
        data = encode_frame(FRAMES[1])
        peer.sendall(data[:len(data) // 2])
        time.sleep(0.05)
        t0 = time.monotonic()
        assert client.poll() == []
        assert time.monotonic() - t0 < 0.5
        assert client.connected()
        peer.sendall(data[len(data) // 2:])
        (frame,) = _poll_until(client.poll)
        assert frame == FRAMES[1]
    finally:
        peer.close()
        client.close()
        listener.close()


def test_a_listener_drops_a_peer_stalled_mid_frame(monkeypatch):
    """The worker's listener reads a started frame to its end, but a peer
    that stalls mid-frame for ``_IO_TIMEOUT`` is dropped: the poll returns
    after that one wait with nothing, and frames on other connections are
    still delivered."""
    import socket

    monkeypatch.setattr(transport, "_IO_TIMEOUT", 0.2)
    server = TransportServer()
    host, port = server.addr.rsplit(":", 1)
    stalled = socket.create_connection((host, int(port)))
    client = TransportClient(server.addr)
    try:
        data = encode_frame(FRAMES[1])
        stalled.sendall(data[:len(data) // 2])
        assert client.send(FRAMES[3])
        time.sleep(0.05)
        t0 = time.monotonic()
        got = server.poll()
        assert 0.2 <= time.monotonic() - t0 < 2.0
        assert len(server.conn_ids()) == 1  # the stalled one went
        got += _poll_until(server.poll) if not got else []
        assert [f for _, f in got] == [FRAMES[3]]
    finally:
        stalled.close()
        client.close()
        server.close()


def test_client_reconnects_after_server_restart():
    server = TransportServer()
    host, port = server.addr.rsplit(":", 1)
    client = TransportClient(server.addr)
    try:
        assert client.send({"t": "occ", "occ": {"beat": 1}})
        _poll_until(server.poll)
        server.close()
        deadline = time.monotonic() + 5.0
        while client.connected() and time.monotonic() < deadline:
            client.send({"t": "occ", "occ": {"beat": 2}})
            time.sleep(0.01)
        assert not client.connected()
        server2 = TransportServer(host=host, port=int(port))
        try:
            got = None
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                client.send({"t": "occ", "occ": {"beat": 3}})
                got = server2.poll()
                if got:
                    break
                time.sleep(0.01)
            assert got, "client never re-delivered after server restart"
            assert got[0][1]["occ"]["beat"] == 3
            assert client.reconnects >= 1
        finally:
            server2.close()
    finally:
        client.close()


def test_chaos_net_fence_modes(monkeypatch):
    """``half_open`` swallows a frame while reporting success, ``drop``
    severs the connection (the client redials), ``latency`` delays a send
    that still arrives — each at the exact frame index asked for."""
    server = TransportServer()
    client = TransportClient(server.addr)
    try:
        assert client.send({"t": "occ", "occ": {"beat": 1}})
        (_, f1), = _poll_until(server.poll)
        assert f1["occ"]["beat"] == 1
        monkeypatch.setenv("PADDLE_CHAOS", "1")
        monkeypatch.setenv("PADDLE_CHAOS_NET_AT", "0")

        monkeypatch.setenv("PADDLE_CHAOS_NET_MODE", "half_open")
        monkeypatch.setattr(transport, "_send_index", 0)
        assert client.send({"t": "occ", "occ": {"beat": 2}})
        assert client.connected()
        assert client.send({"t": "occ", "occ": {"beat": 3}})
        got = _poll_until(server.poll)
        assert [fr["occ"]["beat"] for _, fr in got] == [3]

        monkeypatch.setenv("PADDLE_CHAOS_NET_MODE", "drop")
        monkeypatch.setattr(transport, "_send_index", 0)
        assert not client.send({"t": "occ", "occ": {"beat": 4}})
        monkeypatch.delenv("PADDLE_CHAOS_NET_MODE")
        deadline = time.monotonic() + 10.0
        got = []
        while not got and time.monotonic() < deadline:
            client.send({"t": "occ", "occ": {"beat": 5}})
            got = server.poll()
            time.sleep(0.01)
        assert got and got[-1][1]["occ"]["beat"] == 5
        assert client.reconnects >= 1

        monkeypatch.setenv("PADDLE_CHAOS_NET_MODE", "latency")
        monkeypatch.setenv("PADDLE_CHAOS_NET_LATENCY_MS", "120")
        monkeypatch.setattr(transport, "_send_index", 0)
        t0 = time.monotonic()
        assert client.send({"t": "occ", "occ": {"beat": 6}})
        assert time.monotonic() - t0 >= 0.12
        got = _poll_until(server.poll)
        assert got[-1][1]["occ"]["beat"] == 6
    finally:
        client.close()
        server.close()


def _slabs(seed, shape=(2, 3, 4, 16, 8)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal(shape, dtype=np.float32))


def test_kv_wire_raw_is_bit_equal_f32_and_bf16():
    k, v = _slabs(0)
    (frame,) = FrameDecoder().feed(encode_frame({"t": "kv",
                                                 "kv": encode_kv(k, v, "raw")}))
    out = decode_kv(frame["kv"])
    np.testing.assert_array_equal(out["k"], k)
    np.testing.assert_array_equal(out["v"], v)
    assert out["dtype"] == "float32"
    # a bf16 pool's pages: int16 words tagged bfloat16, back bit for bit
    kb, vb = torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()
    payload = encode_kv(kb, vb, "raw")
    assert payload["dtype"] == "bfloat16" and payload["k"].dtype == np.int16
    out = decode_kv(FrameDecoder().feed(encode_frame({"kv": payload}))[0]
                    ["kv"])
    assert torch.equal(from_host(out["k"], out["dtype"]), kb)
    assert torch.equal(from_host(out["v"], out["dtype"]), vb)
    # the words as the engine exports them (dtype given explicitly)
    words, name = to_host(kb)
    again = encode_kv(words, to_host(vb)[0], "raw", dtype=name)
    np.testing.assert_array_equal(again["k"], payload["k"])


def test_kv_wire_raw_passes_int8_pool_scales_through():
    rng = np.random.default_rng(1)
    k = rng.integers(-127, 128, size=(2, 3, 4, 16, 8)).astype(np.int8)
    v = rng.integers(-127, 128, size=(2, 3, 4, 16, 8)).astype(np.int8)
    ks = rng.random((2, 3, 4, 16), dtype=np.float32)
    vs = rng.random((2, 3, 4, 16), dtype=np.float32)
    for wire in ("raw", "int8"):  # an int8 pool ships raw on either wire
        out = decode_kv(encode_kv(k, v, wire, ks, vs))
        np.testing.assert_array_equal(out["k"], k)
        np.testing.assert_array_equal(out["v"], v)
        np.testing.assert_array_equal(out["k_scale"], ks)
        np.testing.assert_array_equal(out["v_scale"], vs)


def test_kv_wire_int8_equals_reference_and_size_arithmetic():
    k, v = _slabs(2, (2, 4, 4, 16, 8))
    got = encode_kv(k, v, "int8")
    ref = ref_transport.encode_kv(k, v, "int8")
    assert got["wire"] == ref["wire"] == "int8"
    assert got["dtype"] == ref["dtype"] == "float32"
    for key in ("k", "v"):
        assert got[key].dtype == np.int8
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]))
        np.testing.assert_allclose(got[key + "_scale"],
                                   np.asarray(ref[key + "_scale"]),
                                   rtol=2 ** -23, atol=0)
    out = decode_kv(got)
    ref_out = ref_transport.decode_kv(ref)
    for key in ("k", "v"):
        np.testing.assert_allclose(out[key], np.asarray(ref_out[key]),
                                   rtol=2 ** -22, atol=0)
        src = k if key == "k" else v
        step = np.abs(src).max(axis=(-2, -1), keepdims=True) / 127.0
        assert np.max(np.abs(out[key] - src) / step) <= 0.5 + 1e-5
    # the payload's bytes: one int8 per element, one f32 scale per
    # [layer, page, head], for each of k and v
    n, scales = k.size, k.size // (16 * 8)
    assert sum(got[x].nbytes for x in ("k", "v", "k_scale", "v_scale")) \
        == 2 * (n + 4 * scales)
    raw_bytes = len(encode_frame({"kv": encode_kv(k, v, "raw")}))
    int8_bytes = len(encode_frame({"kv": got}))
    assert int8_bytes < raw_bytes / 3
    # a bf16 pool's pages quantize from the bf16 values (about half)
    kb, vb = torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()
    gb = encode_kv(kb, vb, "int8")
    assert gb["dtype"] == "bfloat16"
    qk, _ = transport._quantize(to_host(kb)[0], "bfloat16", (-2, -1))
    np.testing.assert_array_equal(gb["k"], qk)
    raw_b = len(encode_frame({"kv": encode_kv(kb, vb, "raw")}))
    assert len(encode_frame({"kv": gb})) < 0.6 * raw_b


def test_seq_channels_dedup_reorder_seek_drop():
    ch = SeqChannels()
    assert [ch.next_seq("dispatch") for _ in range(3)] == [0, 1, 2]
    assert ch.next_seq("act0") == 0
    assert ch.stash("dispatch", 0, "d0")
    assert ch.pop_next("dispatch") == "d0"
    assert ch.stash("act0", 0, "a0")
    assert ch.pop_next("act0") == "a0"
    assert not ch.stash("dispatch", 0, "d0-again")
    # reorder and seek
    assert ch.stash("cot0", 1, "late")
    assert ch.pop_next("cot0") is None
    assert ch.stash("cot0", 0, "early")
    assert [ch.pop_next("cot0"), ch.pop_next("cot0")] == ["early", "late"]
    ch.stash("cot0", 5, "future")
    ch.seek("cot0", 2)
    assert ch.cursor("cot0") == 2 and ch.pending("cot0") == 1
    ch.seek("cot0", 6)
    assert ch.pending("cot0") == 0
    # a dead connection's channel is forgotten whole
    ch.next_seq("wt:7")
    assert ch.stash("wt:7", 0, "begin") and ch.pop_next("wt:7") == "begin"
    assert ch.stash("wt:7", 2, "orphan")
    ch.drop("wt:7")
    assert ch.pending("wt:7") == 0 and ch.cursor("wt:7") == 0
    assert ch.next_seq("wt:7") == 0
    ch.stash("dispatch", 1, "d1")
    ch.drop("wt:9")
    assert ch.pop_next("dispatch") == "d1"


def test_tq_frame_codec_bit_equal_and_reference_layout():
    arr = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    frame = transport.encode_tq_frame("act1", 7, arr, "f32", meta={"mb": 2})
    ref = ref_transport.encode_tq_frame("act1", 7, arr, "f32", meta={"mb": 2})
    assert encode_frame(frame) == ref_transport.encode_frame(ref)
    ch, seq, got, meta = transport.decode_tq_frame(frame)
    assert (ch, seq, meta) == ("act1", 7, {"mb": 2})
    np.testing.assert_array_equal(got, arr)
    assert transport.encode_tq_ack("act1", 7) == \
        ref_transport.encode_tq_ack("act1", 7)
    # the bf16 wire carries bf16 words and comes back as the bf16 values
    bf = transport.decode_tq_frame(
        transport.encode_tq_frame("act1", 8, arr, "bf16"))[2]
    want = torch.from_numpy(arr).bfloat16().float().numpy()
    np.testing.assert_array_equal(bf, want)
    # int8: the reference's per-row absmax
    q = transport.encode_tq_frame("c", 0, arr, "int8")["x"]
    rq = ref_transport.encode_tq_frame("c", 0, arr, "int8")["x"]
    np.testing.assert_array_equal(q["x"], np.asarray(rq["x"]))


def test_wt_frame_codec_matches_reference_layout():
    f = transport.encode_wt_frame("wt:0", 3, "begin", 2)
    assert f == ref_transport.encode_wt_frame("wt:0", 3, "begin", 2)
    assert transport.encode_wt_ack("wt:0", 3, 2, applied=True, kind="swap",
                                   live=2) == ref_transport.encode_wt_ack(
        "wt:0", 3, 2, applied=True, kind="swap", live=2)
    with pytest.raises(ValueError):
        transport.encode_wt_frame("wt:0", 0, "bogus", 1)


def test_frame_header_is_big_endian_length():
    blob = encode_frame({"t": "hello"})
    (n,) = struct.unpack(">I", blob[:4])
    assert pickle.loads(blob[4:]) == {"t": "hello"} and n == len(blob) - 4
