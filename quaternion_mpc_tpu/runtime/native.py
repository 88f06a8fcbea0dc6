"""ctypes bindings for the native host runtime (native/qmpc_runtime.cpp).

The accelerator does the solves; this layer is the deployment-side real-time
plumbing the reference implements in C++ (Main.cpp rate loops, the
LeggedState mutex — here a seqlock — and the Unitree UDP bridge). Built from
the committed source with the in-tree Makefile (g++ only, no external deps)
on first use in each process.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import pathlib
import subprocess
from typing import Optional

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libqmpc_runtime.so"
_lib: Optional[ctypes.CDLL] = None


def build() -> pathlib.Path:
    """Run `make` (a no-op when the library is newer than its source), so a
    stale library is never loaded. A lock file serialises concurrent builds
    from several processes of one checkout."""
    with open(_NATIVE_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(
            ["make", "-C", str(_NATIVE_DIR)], check=True, capture_output=True
        )
    return _LIB_PATH


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    build()
    lib = ctypes.CDLL(str(_LIB_PATH))

    lib.qmpc_rate_loop_create.restype = ctypes.c_void_p
    lib.qmpc_rate_loop_create.argtypes = [ctypes.c_double]
    lib.qmpc_rate_loop_destroy.argtypes = [ctypes.c_void_p]
    lib.qmpc_rate_loop_wait.restype = ctypes.c_int64
    lib.qmpc_rate_loop_wait.argtypes = [ctypes.c_void_p]
    lib.qmpc_rate_loop_ticks.restype = ctypes.c_uint64
    lib.qmpc_rate_loop_ticks.argtypes = [ctypes.c_void_p]
    lib.qmpc_rate_loop_overruns.restype = ctypes.c_uint64
    lib.qmpc_rate_loop_overruns.argtypes = [ctypes.c_void_p]
    lib.qmpc_rate_loop_max_lateness_ns.restype = ctypes.c_int64
    lib.qmpc_rate_loop_max_lateness_ns.argtypes = [ctypes.c_void_p]
    lib.qmpc_set_realtime_priority.restype = ctypes.c_int
    lib.qmpc_set_realtime_priority.argtypes = [ctypes.c_int]

    lib.qmpc_state_bus_create.restype = ctypes.c_void_p
    lib.qmpc_state_bus_create.argtypes = [ctypes.c_uint32]
    lib.qmpc_state_bus_destroy.argtypes = [ctypes.c_void_p]
    lib.qmpc_state_bus_write.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
    ]
    lib.qmpc_state_bus_read.restype = ctypes.c_uint64
    lib.qmpc_state_bus_read.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
    ]

    lib.qmpc_spsc_create.restype = ctypes.c_void_p
    lib.qmpc_spsc_create.argtypes = [ctypes.c_uint32]
    lib.qmpc_spsc_destroy.argtypes = [ctypes.c_void_p]
    lib.qmpc_spsc_push.restype = ctypes.c_int
    lib.qmpc_spsc_push.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
    ]
    lib.qmpc_spsc_pop.restype = ctypes.c_uint32
    lib.qmpc_spsc_pop.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
    ]

    lib.qmpc_udp_create.restype = ctypes.c_void_p
    lib.qmpc_udp_create.argtypes = [ctypes.c_char_p, ctypes.c_uint16, ctypes.c_uint16]
    lib.qmpc_udp_destroy.argtypes = [ctypes.c_void_p]
    lib.qmpc_udp_local_port.restype = ctypes.c_uint16
    lib.qmpc_udp_local_port.argtypes = [ctypes.c_void_p]
    lib.qmpc_udp_send.restype = ctypes.c_int64
    lib.qmpc_udp_send.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
    ]
    lib.qmpc_udp_recv.restype = ctypes.c_int64
    lib.qmpc_udp_recv.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
    ]
    lib.qmpc_now_ns.restype = ctypes.c_int64

    _lib = lib
    return lib


def _u8(data: bytes):
    return (ctypes.c_uint8 * len(data)).from_buffer_copy(data)


class RateLoop:
    """Absolute-deadline periodic loop (Main.cpp:101-119 rate pattern)."""

    def __init__(self, period_s: float, realtime_priority: Optional[int] = None):
        self._lib = load()
        self._h = self._lib.qmpc_rate_loop_create(period_s)
        self.realtime = False
        if realtime_priority is not None:
            self.realtime = self._lib.qmpc_set_realtime_priority(realtime_priority) == 0

    def wait(self) -> int:
        """Sleep to the next deadline; returns lateness in ns (0 = on time)."""
        return self._lib.qmpc_rate_loop_wait(self._h)

    @property
    def ticks(self) -> int:
        return self._lib.qmpc_rate_loop_ticks(self._h)

    @property
    def overruns(self) -> int:
        return self._lib.qmpc_rate_loop_overruns(self._h)

    @property
    def max_lateness_ns(self) -> int:
        return self._lib.qmpc_rate_loop_max_lateness_ns(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.qmpc_rate_loop_destroy(self._h)
            self._h = None


class StateBus:
    """Single-writer seqlock snapshot bus (the LeggedState-mutex replacement)."""

    def __init__(self, size: int):
        self._lib = load()
        self._h = self._lib.qmpc_state_bus_create(size)
        self.size = size

    def write(self, data: bytes) -> None:
        buf = _u8(data)
        self._lib.qmpc_state_bus_write(self._h, buf, len(data))

    def read(self) -> tuple[int, bytes]:
        """(sequence, snapshot); sequence 0 = nothing published yet."""
        buf = (ctypes.c_uint8 * self.size)()
        seq = self._lib.qmpc_state_bus_read(self._h, buf, self.size)
        return seq, bytes(buf)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.qmpc_state_bus_destroy(self._h)
            self._h = None


class SpscQueue:
    """Lock-free SPSC frame queue for telemetry (LeggedLogger role)."""

    def __init__(self, capacity_pow2: int = 1 << 16):
        self._lib = load()
        self._h = self._lib.qmpc_spsc_create(capacity_pow2)
        if not self._h:
            raise ValueError("capacity must be a power of two")

    def push(self, frame: bytes) -> bool:
        buf = _u8(frame)
        return bool(self._lib.qmpc_spsc_push(self._h, buf, len(frame)))

    def pop(self, max_n: int = 4096) -> Optional[bytes]:
        buf = (ctypes.c_uint8 * max_n)()
        n = self._lib.qmpc_spsc_pop(self._h, buf, max_n)
        if n == 0:
            return None
        return bytes(buf[: min(n, max_n)])

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.qmpc_spsc_destroy(self._h)
            self._h = None


class UdpLink:
    """Non-blocking UDP endpoint (HardwareInterface/ros_udp bridge role)."""

    def __init__(self, peer_ip: str = "", peer_port: int = 0, bind_port: int = 0):
        self._lib = load()
        self._h = self._lib.qmpc_udp_create(
            peer_ip.encode() if peer_ip else b"", peer_port, bind_port
        )
        if not self._h:
            raise OSError("failed to create UDP link")

    @property
    def local_port(self) -> int:
        return self._lib.qmpc_udp_local_port(self._h)

    def send(self, data: bytes) -> int:
        buf = _u8(data)
        n = self._lib.qmpc_udp_send(self._h, buf, len(data))
        if n < 0:
            raise OSError(-n, os.strerror(-n))
        return n

    def recv(self, max_n: int = 2048) -> Optional[bytes]:
        buf = (ctypes.c_uint8 * max_n)()
        n = self._lib.qmpc_udp_recv(self._h, buf, max_n)
        if n == -11 or n == -35:  # EAGAIN / EWOULDBLOCK
            return None
        if n < 0:
            raise OSError(-n, os.strerror(-n))
        return bytes(buf[:n])

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.qmpc_udp_destroy(self._h)
            self._h = None
