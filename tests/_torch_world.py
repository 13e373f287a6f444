"""Launch a world of rank processes for the port's distributed tests.

Each rank is a subprocess on 127.0.0.1 running a script the test file
holds as a string (never a test module, which imports JAX), with
``torch.set_num_threads(1)`` in the script, its own listen port, and the
machine list of the world. A world has one deadline: when it passes, every
rank is killed and the test fails with the ranks' stderr.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 180


def free_ports(n):
    """``n`` distinct ports that were free on 127.0.0.1 a moment ago."""
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


def machines(ports):
    return ",".join(f"127.0.0.1:{p}" for p in ports)


def run_world(script, world, spec, workdir, deadline=DEADLINE_S,
              expect_rc=0):
    """Run ``script`` as ``world`` ranks: each gets ``argv = [spec.json,
    rank]`` where the spec holds ``spec`` plus ``ports``, ``machines``,
    ``world`` and ``out`` (a per-rank JSON path the script writes).
    Returns the ranks' parsed outputs, or with ``expect_rc`` not 0 the
    ranks' ``(rc, stderr)``."""
    os.makedirs(workdir, exist_ok=True)
    ports = free_ports(world)
    spec = dict(spec, ports=ports, machines=machines(ports), world=world,
                out=os.path.join(workdir, "out_{rank}.json"))
    spec_path = os.path.join(workdir, "spec.json")
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)
    script_path = os.path.join(workdir, "rank.py")
    with open(script_path, "w") as fh:
        fh.write(script)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               PYTHONUNBUFFERED="1")
    procs, errs = [], []
    for r in range(world):
        err = open(os.path.join(workdir, f"err_{r}.txt"), "w+")
        errs.append(err)
        procs.append(subprocess.Popen(
            [sys.executable, script_path, spec_path, str(r)], env=env,
            stdout=subprocess.DEVNULL, stderr=err, cwd=workdir,
            start_new_session=True))
    t_end = time.monotonic() + deadline
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > t_end:
                raise TimeoutError(f"world of {world} passed its "
                                   f"{deadline} s deadline")
            time.sleep(0.05)
    except TimeoutError as e:
        _kill(procs)
        raise AssertionError(f"{e}\n{_stderr(errs)}") from None
    finally:
        _kill(procs)
    rcs = [p.returncode for p in procs]
    if expect_rc != 0:
        return [(rc, _read(e)) for rc, e in zip(rcs, errs)]
    if any(rc != 0 for rc in rcs):
        raise AssertionError(f"ranks exited {rcs}\n{_stderr(errs)}")
    outs = []
    for r in range(world):
        with open(spec["out"].format(rank=r)) as fh:
            outs.append(json.load(fh))
    for e in errs:
        e.close()
    return outs


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()


def _read(fh):
    fh.flush()
    fh.seek(0)
    return fh.read()


def _stderr(errs):
    return "\n".join(f"--- rank {r} stderr ---\n{_read(e)[-4000:]}"
                     for r, e in enumerate(errs))
