"""The launch CLI of ``paddle_tpu_torch`` (``python -m
paddle_tpu_torch.distributed.launch``), the counterpart of
``tests/test_launch.py``: multi-node faked as processes on this host, the
trainers' payloads asserting their ``PADDLE_*`` contract, the test
checking exit codes and the files the trainers and the launcher leave.

Scenarios: two trainers over the native store (each with its
``workerlog.N``); two CPU ranks (``--devices cpu``) joining gloo through
``init_parallel_env`` and summing over it; a failing trainer (exit 3)
making the launcher exit 1 with ``failure.json``; an elastic in-place
restart that recovers, and one whose budget runs out; two launchers as a
two-node job over the ``TCPStore`` master; a multi-node job without
``--master``; an elastic ``1:2`` node range settling at one node. The
launcher and its trainers run in fresh processes, so the reference is
not imported here: its behaviour is what the scenarios assert, as its
own tests assert it.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading

from paddle_tpu_torch.distributed.launch.context import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PAYLOAD_STORE = textwrap.dedent("""
    import json, os, sys, time
    sys.path.insert(0, {repo!r})
    from paddle_tpu_torch.distributed.store import TCPStore

    rank = int(os.environ["PADDLE_TRAINER_ID"])
    world = int(os.environ["PADDLE_TRAINERS_NUM"])
    eps = os.environ["PADDLE_TRAINER_ENDPOINTS"].split(",")
    assert len(eps) == world, (eps, world)
    assert os.environ["PADDLE_CURRENT_ENDPOINT"] == eps[rank]
    host, port = os.environ["PADDLE_MASTER"].rsplit(":", 1)
    store = TCPStore(host=host, port=int(port), is_master=(rank == 0),
                     world_size=world, timeout=30)
    store.barrier("launch-test")
    with open(os.path.join({outdir!r}, f"rank{{rank}}.json"), "w") as f:
        json.dump({{"rank": rank, "world": world,
                   "local": os.environ["PADDLE_LOCAL_RANK"],
                   "restart": os.environ["PADDLE_RESTART_COUNT"],
                   "device": os.environ["FLAGS_selected_devices"]}}, f)
    store.add("bye", 1)
    if rank == 0:        # the master hosts the daemon: leave last
        while store.add("bye", 0) < world:
            time.sleep(0.05)
    store.close()
""")

PAYLOAD_GLOO = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, {repo!r})
    import torch
    import paddle_tpu_torch.distributed as D

    D.init_parallel_env()
    r, n = D.get_rank(), D.get_world_size()
    x = torch.full((4,), float(r + 1))
    D.all_reduce(x)
    with open(os.path.join({outdir!r}, f"gloo{{r}}.json"), "w") as f:
        json.dump({{"rank": r, "world": n, "backend": D.get_backend(),
                   "sum": x.tolist()}}, f)
    D.destroy_process_group()
""")

PAYLOAD_FLAKY = textwrap.dedent("""
    import os, sys
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    marker = os.path.join({outdir!r}, "attempted")
    if not os.path.exists(marker):
        if rank == 0:
            open(marker, "w").close()
        sys.exit(7)   # the first generation fails on every rank
    open(os.path.join({outdir!r}, f"ok{{rank}}"), "w").close()
""")


def run_launch(args, timeout=120):
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch"] + args
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)


def _payload(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text.format(repo=REPO, outdir=str(tmp_path)))
    return str(p)


def test_launch_two_procs(tmp_path):
    r = run_launch(["--nproc_per_node", "2", "--devices", "cpu",
                    "--log_dir", str(tmp_path / "log"),
                    _payload(tmp_path, "payload.py", PAYLOAD_STORE)])
    assert r.returncode == 0, (r.stdout, r.stderr)
    for rank in range(2):
        data = json.loads((tmp_path / f"rank{rank}.json").read_text())
        assert data == {"rank": rank, "world": 2, "local": str(rank),
                        "restart": "0", "device": "cpu"}
        assert (tmp_path / "log" / f"workerlog.{rank}").exists()


def test_launch_cpu_ranks_join_gloo(tmp_path):
    r = run_launch(["--devices", "cpu", "--nproc_per_node", "2",
                    "--log_dir", str(tmp_path / "log"),
                    _payload(tmp_path, "gloo.py", PAYLOAD_GLOO)])
    assert r.returncode == 0, (r.stdout, r.stderr)
    for rank in range(2):
        data = json.loads((tmp_path / f"gloo{rank}.json").read_text())
        assert data == {"rank": rank, "world": 2, "backend": "GLOO",
                        "sum": [3.0] * 4}


def test_launch_propagates_failure(tmp_path):
    payload = tmp_path / "boom.py"
    payload.write_text("import sys; sys.exit(3)\n")
    r = run_launch(["--nproc_per_node", "2", "--devices", "cpu",
                    "--log_dir", str(tmp_path / "log"), str(payload)])
    assert r.returncode == 1
    info = json.loads((tmp_path / "log" / "failure.json").read_text())
    assert info["reason"] == "container_failed"
    assert info["container"]["exit_code"] == 3


def test_launch_elastic_restart(tmp_path):
    r = run_launch(["--nproc_per_node", "2", "--devices", "cpu",
                    "--elastic_level", "1", "--max_restart", "2",
                    "--log_dir", str(tmp_path / "log"),
                    _payload(tmp_path, "flaky.py", PAYLOAD_FLAKY)])
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert (tmp_path / "ok0").exists() and (tmp_path / "ok1").exists()
    assert not (tmp_path / "log" / "failure.json").exists()


def test_launch_restart_budget_runs_out(tmp_path):
    payload = tmp_path / "always.py"
    payload.write_text("import sys; sys.exit(5)\n")
    r = run_launch(["--nproc_per_node", "1", "--devices", "cpu",
                    "--elastic_level", "1", "--max_restart", "1",
                    "--log_dir", str(tmp_path / "log"), str(payload)])
    assert r.returncode == 1
    info = json.loads((tmp_path / "log" / "failure.json").read_text())
    assert info["reason"] == "restart_budget_exhausted"


def test_launch_multi_node_fake(tmp_path):
    """Two launchers on this host are a two-node job: the store master
    gives them node ranks and every trainer the world's endpoints."""
    payload = _payload(tmp_path, "payload.py", PAYLOAD_STORE)
    master = f"127.0.0.1:{free_port()}"
    results = {}

    def run_node(idx):
        results[idx] = run_launch(
            ["--nnodes", "2", "--master", master, "--rank", str(idx),
             "--nproc_per_node", "1", "--devices", "cpu",
             "--log_dir", str(tmp_path / f"log{idx}"), payload])

    threads = [threading.Thread(target=run_node, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for idx in range(2):
        assert results[idx].returncode == 0, (idx, results[idx].stdout,
                                              results[idx].stderr)
    for rank in range(2):
        data = json.loads((tmp_path / f"rank{rank}.json").read_text())
        assert data["world"] == 2 and data["rank"] == rank


def test_launch_multi_node_requires_master(tmp_path):
    payload = tmp_path / "payload.py"
    payload.write_text("pass\n")
    r = run_launch(["--nnodes", "2", "--nproc_per_node", "1", "--devices",
                    "cpu", str(payload)])
    assert r.returncode != 0
    assert "--master" in (r.stdout + r.stderr)


def test_elastic_range_settles_below_max(tmp_path):
    """``--nnodes 1:2`` with one node joined: membership closes at one
    node after the settle window."""
    r = run_launch(["--nnodes", "1:2", "--master",
                    f"127.0.0.1:{free_port()}", "--rank", "0",
                    "--nproc_per_node", "1", "--devices", "cpu",
                    "--log_dir", str(tmp_path / "log"),
                    _payload(tmp_path, "payload.py", PAYLOAD_STORE)])
    assert r.returncode == 0, (r.stdout, r.stderr)
    data = json.loads((tmp_path / "rank0.json").read_text())
    assert data["world"] == 1


def test_reserved_ports_are_held_until_released():
    """``reserve_ports`` keeps each port bound: no ``bind(0)`` of another
    socket is handed it while held, a plain bind of it is refused, and a
    rendezvous server binding with ``SO_REUSEADDR`` (as rank 0's store
    does) takes it; after release it is free again. ``spawn`` holds its
    job's ports this way until the job ends."""
    import datetime
    import socket
    import torch.distributed as dist
    from paddle_tpu_torch.distributed.launch.context import reserve_ports
    ports, held = reserve_ports(2)
    try:
        assert len(set(ports)) == 2
        seen = set()
        for _ in range(500):
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                seen.add(s.getsockname()[1])
        assert not seen & set(ports)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", ports[0]))
                raise AssertionError("a held port was bound")
            except OSError:
                pass
        store = dist.TCPStore("127.0.0.1", ports[1], 1, True,
                              datetime.timedelta(seconds=10),
                              wait_for_workers=False)
        store.set("k", "v")
        assert store.get("k") == b"v"
        del store
    finally:
        for s in held:
            s.close()
    with socket.socket() as s:
        s.bind(("127.0.0.1", ports[0]))
