"""TCPStore — the key-value rendezvous store, counterpart of
``paddle_tpu/distributed/store.py``.

The daemon and the client are native C++ (``csrc/tcp_store.cc``, the
port's copy of ``paddle_tpu/core/native/tcp_store.cc``), built by g++ at
first use into ``build/paddle_tpu_torch/`` and loaded through ctypes; a
pure-Python implementation of the same wire protocol is the fallback
where no toolchain exists (or ``PADDLE_TPU_DISABLE_NATIVE=1``), as in
the reference. ``TCPStore.backend`` and ``MasterDaemon.backend`` say
which one serves. Both speak the reference's protocol, so a client of
either package talks to a daemon of the other.

It is host rendezvous (launcher peer registration, barriers), beside
the rendezvous ``torch.distributed`` runs for its process groups.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import socket
import struct
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

_CMD_SET, _CMD_GET, _CMD_ADD, _CMD_WAIT, _CMD_DEL = 1, 2, 3, 4, 5


def _build_native() -> Optional[str]:
    """Compile ``csrc/tcp_store.cc`` into ``build/paddle_tpu_torch/
    libtcp_store-<hash>.so`` (named by the source's hash, so an edit
    rebuilds). None when there is no g++ or the build fails."""
    from ..ops._common import BUILD_DIR, CSRC_DIR
    src = CSRC_DIR / "tcp_store.cc"
    if not src.exists():
        return None
    sha = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"libtcp_store-{sha}.so"
    if out.exists():
        return str(out)
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # per-pid temporary and an atomic rename: processes of one job may
    # race to build it
    tmp = f"{out}.tmp.{os.getpid()}"
    cmd = [gxx, "-O2", "-fPIC", "-shared", "-std=c++17", "-pthread",
           str(src), "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    except (subprocess.SubprocessError, OSError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return str(out) if out.exists() else None
    return str(out)


def _load_native():
    if os.environ.get("PADDLE_TPU_DISABLE_NATIVE", "0") == "1":
        return None
    path = _build_native()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.ts_master_start.restype = ctypes.c_void_p
    lib.ts_master_start.argtypes = [ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int)]
    lib.ts_master_stop.argtypes = [ctypes.c_void_p]
    lib.ts_client_connect.restype = ctypes.c_void_p
    lib.ts_client_connect.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_int]
    lib.ts_client_close.argtypes = [ctypes.c_void_p]
    lib.ts_set.restype = ctypes.c_int
    lib.ts_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
                           ctypes.c_int]
    lib.ts_get.restype = ctypes.c_int
    lib.ts_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                           ctypes.c_char_p, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_int)]
    lib.ts_add.restype = ctypes.c_int
    lib.ts_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                           ctypes.POINTER(ctypes.c_int64)]
    lib.ts_wait.restype = ctypes.c_int
    lib.ts_wait.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.ts_del.restype = ctypes.c_int
    lib.ts_del.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    return lib


_native_lib = None
_native_tried = False
_native_lock = threading.Lock()


def native_lib():
    global _native_lib, _native_tried
    with _native_lock:
        if not _native_tried:
            _native_lib = _load_native()
            _native_tried = True
        return _native_lib


# --------------------------------------------------------- Python daemon
class _PyMasterDaemon:
    """Pure-Python master speaking the tcp_store.cc wire protocol."""

    def __init__(self, port: int = 0):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("0.0.0.0", port))
        self._srv.listen(128)
        self.port = self._srv.getsockname()[1]
        self._kv: Dict[bytes, bytes] = {}
        self._cond = threading.Condition()
        self._stop = False
        self._threads: List[threading.Thread] = []
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._stop:
            try:
                self._srv.settimeout(0.2)
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve, args=(conn,), daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn: socket.socket):
        try:
            while not self._stop:
                hdr = _recv_exact(conn, 5)
                if hdr is None:
                    return
                cmd, klen = struct.unpack("<BI", hdr)
                key = _recv_exact(conn, klen)
                if key is None:
                    return
                if cmd == _CMD_SET:
                    raw = _recv_exact(conn, 4)
                    if raw is None:
                        return
                    (vlen,) = struct.unpack("<I", raw)
                    val = _recv_exact(conn, vlen) if vlen else b""
                    if val is None:
                        return
                    with self._cond:
                        self._kv[key] = val
                        self._cond.notify_all()
                    conn.sendall(struct.pack("<BI", 0, 0))
                elif cmd in (_CMD_GET, _CMD_WAIT):
                    raw = _recv_exact(conn, 8)
                    if raw is None:
                        return
                    (timeout_ms,) = struct.unpack("<q", raw)
                    deadline = (None if timeout_ms < 0
                                else time.monotonic() + timeout_ms / 1000.0)
                    # Build the reply under the lock, send OUTSIDE it — a
                    # slow client draining a large value must not stall
                    # every other connection's SET/ADD/GET.
                    with self._cond:
                        while key not in self._kv:
                            rem = (None if deadline is None
                                   else deadline - time.monotonic())
                            if rem is not None and rem <= 0:
                                break
                            self._cond.wait(timeout=0.2 if rem is None
                                            else min(rem, 0.2))
                            if self._stop:
                                return
                        if key in self._kv:
                            val = self._kv[key] if cmd == _CMD_GET else b""
                            msg = struct.pack("<BI", 0, len(val)) + val
                        else:
                            msg = struct.pack("<BI", 1, 0)
                    conn.sendall(msg)
                elif cmd == _CMD_ADD:
                    raw = _recv_exact(conn, 8)
                    if raw is None:
                        return
                    (delta,) = struct.unpack("<q", raw)
                    with self._cond:
                        cur = int(self._kv.get(key, b"0") or b"0") + delta
                        self._kv[key] = str(cur).encode()
                        self._cond.notify_all()
                    val = str(cur).encode()
                    conn.sendall(struct.pack("<BI", 0, len(val)) + val)
                elif cmd == _CMD_DEL:
                    with self._cond:
                        self._kv.pop(key, None)
                    conn.sendall(struct.pack("<BI", 0, 0))
                else:
                    return
        except OSError:
            pass
        finally:
            conn.close()

    def stop(self):
        self._stop = True
        with self._cond:
            self._cond.notify_all()
        try:
            self._srv.close()
        except OSError:
            pass


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        try:
            chunk = conn.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


class MasterDaemon:
    """Owns the store state; runs on exactly one process (the master)."""

    def __init__(self, port: int = 0, prefer_native: bool = True):
        self._native = None
        self._py = None
        lib = native_lib() if prefer_native else None
        if lib is not None:
            out_port = ctypes.c_int(0)
            h = lib.ts_master_start(port, ctypes.byref(out_port))
            if h:
                self._native = (lib, ctypes.c_void_p(h))
                self.port = out_port.value
                self.backend = "native"
                return
        self._py = _PyMasterDaemon(port)
        self.port = self._py.port
        self.backend = "python"

    def stop(self):
        if self._native is not None:
            lib, h = self._native
            lib.ts_master_stop(h)
            self._native = None
        if self._py is not None:
            self._py.stop()
            self._py = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


# --------------------------------------------------------------- client
class _PyClient:
    def __init__(self, host: str, port: int, timeout_s: float):
        deadline = time.monotonic() + timeout_s
        last_err = None
        while True:
            try:
                self._sock = socket.create_connection((host, port),
                                                      timeout=2.0)
                break
            except OSError as e:  # master may not be up yet
                last_err = e
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"TCPStore: cannot reach {host}:{port}: {last_err}")
                time.sleep(0.1)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(None)
        self._lock = threading.Lock()

    def request(self, cmd: int, key: bytes, payload: bytes) -> Tuple[int, bytes]:
        with self._lock:
            self._sock.sendall(struct.pack("<BI", cmd, len(key)) + key
                               + payload)
            hdr = _recv_exact(self._sock, 5)
            if hdr is None:
                raise ConnectionError("TCPStore: connection lost")
            st, vlen = struct.unpack("<BI", hdr)
            val = _recv_exact(self._sock, vlen) if vlen else b""
            if val is None:
                raise ConnectionError("TCPStore: connection lost")
            return st, val

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


class TCPStore:
    """Client handle; when ``is_master`` also hosts the daemon in-process.

    API parity with the reference's pybind surface: ``set``/``get``/``add``/
    ``wait``/``delete_key``/``barrier``.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 is_master: bool = False, world_size: int = 1,
                 timeout: float = 300.0, prefer_native: bool = True):
        self.daemon = None
        if is_master:
            self.daemon = MasterDaemon(port, prefer_native=prefer_native)
            port = self.daemon.port
            host = "127.0.0.1"
        self.host, self.port = host, port
        self.world_size = world_size
        self.timeout = timeout
        self._native = None
        self._py = None
        lib = native_lib() if prefer_native else None
        if lib is not None:
            h = lib.ts_client_connect(host.encode(), port,
                                      int(timeout * 1000))
            if h:
                self._native = (lib, ctypes.c_void_p(h))
        if self._native is None:
            self._py = _PyClient(host, port, timeout)
        # one in-flight request per connection (the native client shares a
        # single fd; interleaved requests would corrupt the wire stream)
        self._req_lock = threading.Lock()

    @property
    def backend(self) -> str:
        return "native" if self._native is not None else "python"

    def set(self, key: str, value) -> None:
        val = value.encode() if isinstance(value, str) else bytes(value)
        if self._native is not None:
            lib, h = self._native
            with self._req_lock:
                rc = lib.ts_set(h, key.encode(), val, len(val))
            if rc != 0:
                raise ConnectionError(f"TCPStore.set({key}) rc={rc}")
        else:
            st, _ = self._py.request(_CMD_SET, key.encode(),
                                     struct.pack("<I", len(val)) + val)
            if st != 0:
                raise ConnectionError(f"TCPStore.set({key}) status={st}")

    def get(self, key: str, timeout: Optional[float] = None) -> bytes:
        tmo = self.timeout if timeout is None else timeout
        tmo_ms = -1 if tmo is None else int(tmo * 1000)
        if self._native is not None:
            lib, h = self._native
            cap = 1 << 16
            while True:
                buf = ctypes.create_string_buffer(cap)
                out_len = ctypes.c_int(0)
                with self._req_lock:
                    rc = lib.ts_get(h, key.encode(), tmo_ms, buf, cap,
                                    ctypes.byref(out_len))
                if rc == -2:
                    cap *= 16
                    continue
                if rc == 1:
                    raise TimeoutError(f"TCPStore.get({key}) timed out")
                if rc != 0:
                    raise ConnectionError(f"TCPStore.get({key}) rc={rc}")
                return buf.raw[:out_len.value]
        st, val = self._py.request(_CMD_GET, key.encode(),
                                   struct.pack("<q", tmo_ms))
        if st == 1:
            raise TimeoutError(f"TCPStore.get({key}) timed out")
        return val

    def add(self, key: str, delta: int = 1) -> int:
        if self._native is not None:
            lib, h = self._native
            out = ctypes.c_int64(0)
            with self._req_lock:
                rc = lib.ts_add(h, key.encode(), delta, ctypes.byref(out))
            if rc != 0:
                raise ConnectionError(f"TCPStore.add({key}) rc={rc}")
            return out.value
        st, val = self._py.request(_CMD_ADD, key.encode(),
                                   struct.pack("<q", delta))
        if st != 0:
            raise ConnectionError(f"TCPStore.add({key}) status={st}")
        return int(val)

    def wait(self, key: str, timeout: Optional[float] = None) -> None:
        tmo = self.timeout if timeout is None else timeout
        tmo_ms = -1 if tmo is None else int(tmo * 1000)
        if self._native is not None:
            lib, h = self._native
            with self._req_lock:
                rc = lib.ts_wait(h, key.encode(), tmo_ms)
            if rc == 1:
                raise TimeoutError(f"TCPStore.wait({key}) timed out")
            if rc != 0:
                raise ConnectionError(f"TCPStore.wait({key}) rc={rc}")
            return
        st, _ = self._py.request(_CMD_WAIT, key.encode(),
                                 struct.pack("<q", tmo_ms))
        if st == 1:
            raise TimeoutError(f"TCPStore.wait({key}) timed out")

    def delete_key(self, key: str) -> None:
        if self._native is not None:
            lib, h = self._native
            with self._req_lock:
                lib.ts_del(h, key.encode())
        else:
            self._py.request(_CMD_DEL, key.encode(), b"")

    def barrier(self, name: str = "default",
                timeout: Optional[float] = None) -> None:
        """All ``world_size`` clients must call; built on add+set+wait.

        Round numbering is server-side (a per-name sequence counter), so a
        client created later (elastic rejoin) enters the barrier round its
        peers are currently in rather than replaying round 1.
        """
        seq = self.add(f"/barrier/{name}/seq", 1)
        rnd = (seq - 1) // self.world_size
        key = f"/barrier/{name}/r{rnd}"
        n = self.add(key, 1)
        if n == self.world_size:
            self.set(key + "/done", b"1")
            if rnd > 0:
                # everyone has left round rnd-1 (they added for this round),
                # so its keys are dead — reclaim them or the master's map
                # grows two keys per barrier for the life of the job
                prev = f"/barrier/{name}/r{rnd - 1}"
                self.delete_key(prev)
                self.delete_key(prev + "/done")
        self.wait(key + "/done", timeout)

    def close(self):
        if self._native is not None:
            lib, h = self._native
            lib.ts_client_close(h)
            self._native = None
        if self._py is not None:
            self._py.close()
            self._py = None
        if self.daemon is not None:
            self.daemon.stop()
            self.daemon = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
