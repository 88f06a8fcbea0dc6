"""Native runtime tests: rate loop timing, seqlock bus integrity under a
concurrent writer, SPSC queue, UDP loopback (reference analog: TestClock.cpp
rate-loop validation + the Main.cpp/HardwareInterface runtime behaviors)."""

import struct
import threading
import time

import pytest

from quaternion_mpc_tpu.runtime import native


@pytest.fixture(scope="module", autouse=True)
def built():
    native.build()


def test_rate_loop_period():
    loop = native.RateLoop(period_s=0.002)
    t0 = time.perf_counter()
    for _ in range(50):
        loop.wait()
    elapsed = time.perf_counter() - t0
    assert 0.08 < elapsed < 0.25  # 50 × 2 ms with scheduling slack
    assert loop.ticks == 50


def test_rate_loop_overrun_reanchors():
    loop = native.RateLoop(period_s=0.002)
    loop.wait()
    time.sleep(0.02)  # blow through ~10 deadlines
    lateness = loop.wait()
    assert lateness > 0
    assert loop.overruns >= 1
    # after re-anchoring, the next ticks are on time again
    on_time = [loop.wait() for _ in range(5)]
    assert all(l == 0 for l in on_time[1:])


def test_state_bus_snapshot():
    bus = native.StateBus(size=64)
    seq, _ = bus.read()
    assert seq == 0  # nothing published
    bus.write(b"a" * 64)
    seq1, snap1 = bus.read()
    assert seq1 > 0 and snap1 == b"a" * 64
    bus.write(b"b" * 64)
    seq2, snap2 = bus.read()
    assert seq2 > seq1 and snap2 == b"b" * 64


def test_state_bus_no_torn_reads():
    """Concurrent writer at full speed: every read must be a consistent
    snapshot (all bytes equal), never a mix of two writes — the property the
    reference's unprotected 4 kHz reader (Main.cpp:137-139) does NOT have."""
    bus = native.StateBus(size=256)
    stop = threading.Event()

    def writer():
        i = 0
        while not stop.is_set():
            bus.write(bytes([i % 251] * 256))
            i += 1

    t = threading.Thread(target=writer)
    t.start()
    try:
        deadline = time.time() + 1.0
        reads = 0
        while time.time() < deadline:
            seq, snap = bus.read()
            if seq == 0:
                continue
            assert len(set(snap)) == 1, "torn read detected"
            reads += 1
        assert reads > 100
    finally:
        stop.set()
        t.join()


def test_spsc_queue_frames():
    q = native.SpscQueue(capacity_pow2=1 << 12)
    frames = [struct.pack("<If", i, i * 0.5) for i in range(100)]
    for f in frames:
        assert q.push(f)
    out = []
    while (f := q.pop()) is not None:
        out.append(f)
    assert out == frames


def test_spsc_queue_drops_when_full():
    q = native.SpscQueue(capacity_pow2=64)
    pushed = 0
    for _ in range(100):
        if q.push(b"x" * 16):
            pushed += 1
    assert 0 < pushed < 100  # filled up and started dropping, never blocked


def test_udp_loopback():
    rx = native.UdpLink(bind_port=0)
    tx = native.UdpLink(peer_ip="127.0.0.1", peer_port=rx.local_port)
    assert rx.recv() is None  # non-blocking empty
    payload = b"low_cmd:" + bytes(range(40))
    assert tx.send(payload) == len(payload)
    got = None
    for _ in range(100):
        got = rx.recv()
        if got is not None:
            break
        time.sleep(0.001)
    assert got == payload


def test_build_remakes_after_source_change(tmp_path, monkeypatch):
    """build() always runs make: a source newer than the library rebuilds
    it, and an unchanged source leaves it as it is."""
    import os
    import shutil

    for name in ("Makefile", "qmpc_runtime.cpp"):
        shutil.copy(native._NATIVE_DIR / name, tmp_path / name)
    lib = tmp_path / "libqmpc_runtime.so"
    monkeypatch.setattr(native, "_NATIVE_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIB_PATH", lib)

    assert native.build() == lib and lib.exists()
    built = lib.stat().st_mtime_ns
    native.build()
    assert lib.stat().st_mtime_ns == built

    src = tmp_path / "qmpc_runtime.cpp"
    later = lib.stat().st_mtime + 10
    os.utime(src, (later, later))
    native.build()
    assert lib.stat().st_mtime_ns > built
