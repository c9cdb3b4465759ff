"""The rendezvous store of ``paddle_tpu_torch.distributed.store``.

The JAX package's own store scenarios (``tests/test_store.py``) run
through the port unchanged (``torch_scenarios``): both backends, the
native daemon and client built by g++ from the port's copy of
``tcp_store.cc`` and the Python fallback of the same wire protocol.
Then the two packages talk to each other in one process: the port's
client against the reference's daemon and the reverse, which shows the
wire protocol is the reference's.
"""

import os

import pytest

import torch_scenarios
from paddle_tpu.distributed import store as rstore
from paddle_tpu_torch.distributed import store as tstore


@pytest.mark.parametrize("scenario", torch_scenarios.scenario_ids(
    "test_store.py"))
def test_store_scenario_through_the_port(scenario, request):
    torch_scenarios.run("test_store.py", scenario, request)


def test_native_library_builds_into_the_build_dir():
    from paddle_tpu_torch.ops._common import BUILD_DIR
    lib = tstore.native_lib()
    assert lib is not None, "g++ is on this box: the native store builds"
    path = tstore._build_native()
    assert os.path.dirname(path) == str(BUILD_DIR)
    assert os.path.basename(path).startswith("libtcp_store-")


@pytest.mark.parametrize("daemon_native", [False, True],
                         ids=["python-daemon", "native-daemon"])
@pytest.mark.parametrize("client_native", [False, True],
                         ids=["python-client", "native-client"])
@pytest.mark.parametrize("direction", ["port-client", "port-daemon"])
def test_interop_across_the_packages(direction, client_native,
                                     daemon_native):
    daemon_mod, client_mod = ((rstore, tstore) if direction == "port-client"
                              else (tstore, rstore))
    daemon = daemon_mod.MasterDaemon(prefer_native=daemon_native)
    assert daemon.backend == ("native" if daemon_native else "python")
    try:
        c = client_mod.TCPStore(host="127.0.0.1", port=daemon.port,
                                world_size=1, timeout=10.0,
                                prefer_native=client_native)
        other = daemon_mod.TCPStore(host="127.0.0.1", port=daemon.port,
                                    world_size=1, timeout=10.0,
                                    prefer_native=not client_native)
        try:
            assert c.backend == ("native" if client_native else "python")
            c.set("k", b"\x00bytes\xff")
            assert other.get("k") == b"\x00bytes\xff"
            other.set("big", b"x" * 100_000)
            assert c.get("big") == b"x" * 100_000
            assert c.add("n", 5) == 5 and other.add("n", -2) == 3
            c.wait("n", timeout=1.0)
            with pytest.raises(TimeoutError):
                c.get("missing", timeout=0.2)
            other.delete_key("k")
            with pytest.raises(TimeoutError):
                c.get("k", timeout=0.2)
            c.barrier("b")
        finally:
            c.close()
            other.close()
    finally:
        daemon.stop()


def test_disabling_the_native_store_falls_back_to_python(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DISABLE_NATIVE", "1")
    assert tstore._load_native() is None
    monkeypatch.setattr(tstore, "_native_tried", False)
    monkeypatch.setattr(tstore, "_native_lib", None)
    s = tstore.TCPStore(is_master=True, world_size=1, timeout=5.0)
    try:
        assert s.backend == "python" and s.daemon.backend == "python"
        s.set("a", "b")
        assert s.get("a") == b"b"
    finally:
        s.close()
