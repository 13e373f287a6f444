"""Crash and fleet supervisors: relaunch a killed or wedged training run
from its checkpoints.

Port of ``lightgbm_tpu/robustness/supervisor.py``::

    python -m lightgbm_tpu_torch.robustness.supervisor [options] -- \\
        config=train.conf checkpoint_dir=ckpts checkpoint_interval=50

The supervisor owns the detect -> restart half of the self-healing loop:
it launches the command line's train task as a child (``python -m
lightgbm_tpu_torch``), and on any nonzero exit — a crash, ``kill -9`` (a
negative return code), SIGTERM's checkpoint-then-exit 143, the watchdog's
abort 142, a shard corruption 144, comm loss 145 — relaunches the same
command with ``resume_from=auto`` appended once, under bounded restarts
with exponential backoff (jitter seeded, so a chaos run replays). A child
exiting 0 ends supervision; out of restarts, the worst child code is
returned.

Recovery is measured: at each failure the supervisor records the newest
checkpoint id (or gang manifest epoch), and when the relaunched child
banks a newer one the failure-to-recovered seconds land in the
``fault.recovery_seconds`` histogram (MTTR); ``fault.restarts`` and
``fault.child_failures`` count the events.

``--fleet=N`` supervises a gang (:class:`FleetSupervisor`): the train
command is a per-rank template whose tokens may hold ``{rank}``,
``{world}`` and ``{port}`` (the port of the rank's entry in the template's
``machines=`` list, which is what ``local_listen_port`` must be: the port
finds its rank from the machine list and that port). An elastic shrink
keeps the list's first ``world`` entries, so ``num_machines`` (part of the
checkpoint's config fingerprint) stays as written.

The supervisor process never touches the card: a wedged child cannot wedge
it.
"""
from __future__ import annotations

import random
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

from ..utils.log import Log
from .checkpoint import CheckpointManager
from .watchdog import EXIT_COMM_LOST, EXIT_HANG

# the command line's exit on a detected stream-shard corruption: restartable
# (the shard store is rebuilt from the dataset)
EXIT_SHARD_CORRUPT = 144
# the command line's SIGTERM handler writes a checkpoint and exits 143
EXIT_SIGTERM_CHECKPOINT = 143

_EXIT_LABELS = {
    EXIT_SIGTERM_CHECKPOINT: "checkpoint-then-exit (SIGTERM/preemption)",
    EXIT_HANG: "watchdog abort-to-checkpoint (hang)",
    EXIT_SHARD_CORRUPT: "stream-shard corruption",
    EXIT_COMM_LOST: "comm loss (PeerLostError/CommTimeoutError: a peer "
                    "rank died or stopped answering)",
    -9: "SIGKILL",
    -15: "SIGTERM (no handler)",
    -6: "SIGABRT",
    -11: "SIGSEGV",
}


def describe_exit(rc: int) -> str:
    label = _EXIT_LABELS.get(rc)
    if label is None and rc < 0:
        label = f"killed by signal {-rc}"
    return f"exit {rc}" + (f" [{label}]" if label else "")


def _train_args_dict(train_args: List[str]) -> Dict[str, str]:
    """The ``key=value`` pairs of a command line (``--key=value`` as the
    command line normalizes it; a conf file's contents are not read)."""
    out: Dict[str, str] = {}
    for tok in train_args:
        tok = tok.strip()
        if tok.startswith("--"):
            tok = tok[2:]
            if "=" in tok:
                k, v = tok.split("=", 1)
                tok = k.replace("-", "_") + "=" + v
        if "=" in tok:
            k, v = tok.split("=", 1)
            out[k.strip()] = v.strip().strip('"')
    return out


def _backoff(sup, restarts: int) -> float:
    delay = min(sup.backoff_base_s * (2.0 ** (restarts - 1)),
                sup.backoff_max_s)
    return delay * (1.0 + sup.jitter * sup._rng.random())


class Supervisor:
    """Bounded-restart supervisor for one train command.

    ``spawn_fn(argv) -> proc`` (Popen-like: ``poll()``), ``sleep`` and
    ``clock`` are injectable, so the restart policy, the backoff schedule
    and the MTTR accounting are tested without processes or time."""

    def __init__(self, train_args: List[str], *,
                 max_restarts: int = 5,
                 backoff_base_s: float = 1.0,
                 backoff_max_s: float = 60.0,
                 jitter: float = 0.25,
                 seed: Optional[int] = None,
                 poll_interval_s: float = 0.05,
                 spawn_fn: Optional[Callable] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Optional[Callable[[], float]] = None):
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
        self.train_args = list(train_args)
        self.max_restarts = max_restarts
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.jitter = jitter
        self.poll_interval_s = poll_interval_s
        self._rng = random.Random(seed) if seed is not None else random
        self._spawn = spawn_fn or self._spawn_child
        self._sleep = sleep
        self._clock = clock
        params = _train_args_dict(train_args)
        self.checkpoint_dir = params.get("checkpoint_dir", "")
        if not self.checkpoint_dir:
            Log.warning(
                "supervisor: no checkpoint_dir in the train command — a "
                "restarted child will retrain FROM SCRATCH every time "
                "(set checkpoint_dir=... and checkpoint_interval=N so "
                "restarts resume)")
        self.resume_appended = params.get("resume_from") == "auto"
        self.restarts = 0
        self.recovery_seconds: List[float] = []
        self.exit_codes: List[int] = []

    def _now(self) -> float:
        if self._clock is not None:
            return self._clock()
        from .. import observability as _obs
        return _obs.clock()

    @staticmethod
    def _spawn_child(argv: List[str]):
        return subprocess.Popen([sys.executable, "-m", "lightgbm_tpu_torch"]
                                + list(argv))

    def _last_ckpt_id(self) -> int:
        if not self.checkpoint_dir:
            return -1
        return _newest_recovery_point(self.checkpoint_dir)

    def _recovered(self, reg, pending_fail_t: float) -> float:
        mttr = self._now() - pending_fail_t
        self.recovery_seconds.append(mttr)
        reg.histogram("fault.recovery_seconds").observe(mttr)
        return mttr

    def run(self) -> int:
        """Supervise until the child exits 0 or the restarts run out;
        returns the final child exit code."""
        from .. import observability as _obs
        reg = _obs.get_registry()
        argv = list(self.train_args)
        pending_fail_t: Optional[float] = None
        ckpt_id_at_fail = -1
        while True:
            Log.info("supervisor: launching `%s -m lightgbm_tpu_torch %s`",
                     sys.executable, " ".join(argv))
            proc = self._spawn(argv)
            rc: Optional[int] = None
            recovered_logged = pending_fail_t is None
            while rc is None:
                # MTTR: healed when the relaunched child banks a checkpoint
                # newer than any before the failure
                if not recovered_logged and self.checkpoint_dir:
                    cur = self._last_ckpt_id()
                    if cur > ckpt_id_at_fail:
                        mttr = self._recovered(reg, pending_fail_t)
                        _obs.event("supervisor_recovered",
                                   checkpoint_id=cur,
                                   recovery_seconds=round(mttr, 3))
                        Log.info("supervisor: recovered — checkpoint %d "
                                 "written %.2fs after the failure (MTTR)",
                                 cur, mttr)
                        recovered_logged = True
                        pending_fail_t = None
                rc = proc.poll()
                if rc is None:
                    self._sleep(self.poll_interval_s)
            if rc == 0:
                if not recovered_logged and pending_fail_t is not None:
                    # no checkpoint written after the failure: the clean
                    # exit is the recovery point
                    self._recovered(reg, pending_fail_t)
                Log.info("supervisor: child completed cleanly after %d "
                         "restart(s)", self.restarts)
                return 0
            self.exit_codes.append(rc)
            reg.inc("fault.child_failures")
            _obs.event("supervisor_child_failed", exit_code=rc,
                       restarts=self.restarts)
            if self.restarts >= self.max_restarts:
                worst = max(self.exit_codes, key=_severity)
                Log.warning("supervisor: child failed with %s and the "
                            "restart budget (%d) is exhausted — giving up "
                            "with %s", describe_exit(rc), self.max_restarts,
                            describe_exit(worst))
                return worst
            pending_fail_t = self._now()
            ckpt_id_at_fail = self._last_ckpt_id()
            self.restarts += 1
            reg.inc("fault.restarts")
            delay = _backoff(self, self.restarts)
            Log.warning("supervisor: child failed with %s — restart %d/%d "
                        "with resume_from=auto in %.2fs",
                        describe_exit(rc), self.restarts,
                        self.max_restarts, delay)
            self._sleep(delay)
            if not self.resume_appended:
                # a later key=value wins in cli.parse_args
                argv = argv + ["resume_from=auto"]
                self.resume_appended = True

    def report(self) -> Dict:
        return {"restarts": self.restarts,
                "exit_codes": self.exit_codes,
                "recovery_seconds": [round(s, 3)
                                     for s in self.recovery_seconds],
                "checkpoint_dir": self.checkpoint_dir}


def _severity(rc: int):
    """Order of exit codes for "the worst": a signal death (negative) over
    any code, then the larger code."""
    return (rc < 0, abs(rc))


def _newest_recovery_point(directory: str) -> int:
    """The newest checkpoint id or gang manifest epoch under ``directory``
    (0 when none)."""
    from .distributed import list_manifests
    ids = [e for e, _ in list_manifests(directory)]
    ids += [i for i, _ in CheckpointManager(directory).list_checkpoints()]
    return max(ids, default=0)


def _fit_machines(tok: str, world: int) -> str:
    """A ``machines=`` token cut to its first ``world`` entries (an elastic
    shrink relaunches on fewer ranks; ``num_machines`` stays as written,
    the machine list decides the world)."""
    if not tok.startswith("machines="):
        return tok
    entries = [e for e in tok[len("machines="):].split(",") if e.strip()]
    return "machines=" + ",".join(entries[:world])


def _rank_port(toks: List[str], rank: int) -> str:
    for tok in toks:
        if tok.startswith("machines="):
            entries = [e.strip() for e in tok[len("machines="):].split(",")
                       if e.strip()]
            if rank < len(entries) and ":" in entries[rank]:
                return entries[rank].rsplit(":", 1)[1]
    return ""


class FleetSupervisor:
    """Gang supervisor for a world of rank processes (``--fleet=N``).

    Launches ``world`` ranks from one argv template (``{rank}``,
    ``{world}``, ``{port}`` placeholders) and watches them as a gang: the
    first nonzero exit fails the gang — the survivors get ``reap_grace_s``
    to exit on their own (a rank whose peer died exits 145: its own code
    is the attribution), then are terminated and killed — and the gang is
    relaunched with ``resume_from=auto`` under bounded restarts, resuming
    from the newest gang-consistent manifest.

    Attribution: a rank exiting :data:`EXIT_COMM_LOST` (145) reports a lost
    peer and is never the culprit; the culprit is a rank with any other
    failure. A rank failing ``rank_dead_after`` consecutive gang incidents
    is dead: with ``elastic`` the fleet shrinks by it and relaunches with
    ``elastic=true tpu_reshard_on_resume=true`` appended; without it the
    supervisor refuses and exits 145 (shrinking is never implicit). Out of
    restarts it returns the worst first-failing code. Fleet MTTR as
    :class:`Supervisor`'s. ``spawn_fn`` / ``sleep`` / ``clock`` /
    ``pre_launch_fn`` (``(world, generation) -> [extra argv tokens]``, e.g.
    fresh ports per generation) are injectable."""

    def __init__(self, argv_template: List[str], world: int, *,
                 max_restarts: int = 5,
                 backoff_base_s: float = 1.0,
                 backoff_max_s: float = 60.0,
                 jitter: float = 0.25,
                 seed: Optional[int] = None,
                 poll_interval_s: float = 0.05,
                 elastic: bool = False,
                 rank_dead_after: int = 2,
                 min_world: int = 1,
                 reap_grace_s: float = 10.0,
                 pre_launch_fn: Optional[Callable] = None,
                 spawn_fn: Optional[Callable] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Optional[Callable[[], float]] = None):
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
        if rank_dead_after < 1:
            raise ValueError(f"rank_dead_after must be >= 1, "
                             f"got {rank_dead_after}")
        self.argv_template = list(argv_template)
        self.world = int(world)
        self.max_restarts = max_restarts
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.jitter = jitter
        self.poll_interval_s = poll_interval_s
        self.elastic = bool(elastic)
        self.rank_dead_after = int(rank_dead_after)
        self.min_world = int(min_world)
        self.reap_grace_s = float(reap_grace_s)
        self._pre_launch = pre_launch_fn
        self._rng = random.Random(seed) if seed is not None else random
        self._spawn = spawn_fn or Supervisor._spawn_child
        self._sleep = sleep
        self._clock = clock
        params = _train_args_dict(argv_template)
        self.checkpoint_dir = params.get("checkpoint_dir", "")
        if not self.checkpoint_dir:
            Log.warning("fleet supervisor: no checkpoint_dir in the train "
                        "template — a relaunched gang retrains FROM "
                        "SCRATCH every time (set checkpoint_dir=... and "
                        "checkpoint_interval=N)")
        self._appended: List[str] = []
        if params.get("resume_from") != "auto":
            self._appended.append("resume_from=auto")
        self.restarts = 0
        self.generation = 0
        self.shrinks = 0
        self.recovery_seconds: List[float] = []
        self.gang_exit_codes: List[Dict[int, int]] = []
        self._consecutive_fails: Dict[int, int] = {}

    def _now(self) -> float:
        if self._clock is not None:
            return self._clock()
        from .. import observability as _obs
        return _obs.clock()

    def _newest_id(self) -> int:
        if not self.checkpoint_dir:
            return -1
        return _newest_recovery_point(self.checkpoint_dir)

    def _materialize(self) -> List[List[str]]:
        """Per-rank argvs of this generation: template + pre-launch extras
        + appended tokens, the machine list cut to the world, and the
        placeholders filled in."""
        extra = (list(self._pre_launch(self.world, self.generation))
                 if self._pre_launch else [])
        toks = [_fit_machines(t, self.world) for t in
                self.argv_template + extra + self._appended]
        return [[t.format(rank=rank, world=self.world,
                          port=_rank_port(toks, rank)) for t in toks]
                for rank in range(self.world)]

    def _reap(self, procs, rcs) -> set:
        """Collect the gang after a failure: survivors get ``reap_grace_s``
        to exit on their own, then are terminated and killed. Returns the
        ranks that had to be reaped (their codes are the supervisor's
        doing and never make a culprit)."""
        deadline = self._now() + self.reap_grace_s
        while any(rc is None for rc in rcs):
            for i, p in enumerate(procs):
                if rcs[i] is None:
                    rcs[i] = p.poll()
            if all(rc is not None for rc in rcs) \
                    or self._now() >= deadline:
                break
            self._sleep(self.poll_interval_s)
        reaped = {i for i, rc in enumerate(rcs) if rc is None}
        for i in sorted(reaped):
            try:
                procs[i].terminate()
            except Exception as e:                           # noqa: BLE001
                Log.debug("fleet: terminate rank %d failed: %s", i, e)
        deadline = self._now() + self.reap_grace_s
        while any(rcs[i] is None for i in reaped):
            for i in reaped:
                if rcs[i] is None:
                    rcs[i] = procs[i].poll()
            if all(rcs[i] is not None for i in reaped):
                break
            if self._now() >= deadline:
                for i in reaped:
                    if rcs[i] is None:
                        try:
                            procs[i].kill()
                        except Exception as e:               # noqa: BLE001
                            Log.debug("fleet: kill rank %d failed: %s", i, e)
                        rcs[i] = procs[i].poll()
                break
            self._sleep(self.poll_interval_s)
        return reaped

    def run(self) -> int:
        """Supervise the gang until it completes or the restarts run out;
        returns the final exit code (0 = success)."""
        from .. import observability as _obs
        reg = _obs.get_registry()
        pending_fail_t: Optional[float] = None
        id_at_fail = -1
        while True:
            argvs = self._materialize()
            Log.info("fleet supervisor: launching gang generation %d "
                     "(world %d)", self.generation, self.world)
            procs = [self._spawn(a) for a in argvs]
            rcs: List[Optional[int]] = [None] * self.world
            first_bad: Dict[int, int] = {}
            while True:
                if pending_fail_t is not None and self.checkpoint_dir:
                    cur = self._newest_id()
                    if cur > id_at_fail:
                        mttr = self._now() - pending_fail_t
                        self.recovery_seconds.append(mttr)
                        reg.histogram("fault.recovery_seconds").observe(mttr)
                        _obs.event("fleet_recovered", recovery_point=cur,
                                   world=self.world,
                                   recovery_seconds=round(mttr, 3))
                        Log.info("fleet supervisor: recovered — recovery "
                                 "point %d banked %.2fs after the failure "
                                 "(fleet MTTR)", cur, mttr)
                        pending_fail_t = None
                for i, p in enumerate(procs):
                    if rcs[i] is None:
                        rcs[i] = p.poll()
                first_bad = {i: rc for i, rc in enumerate(rcs)
                             if rc is not None and rc != 0}
                if first_bad or all(rc == 0 for rc in rcs):
                    break
                self._sleep(self.poll_interval_s)
            if not first_bad:
                if pending_fail_t is not None:
                    mttr = self._now() - pending_fail_t
                    self.recovery_seconds.append(mttr)
                    reg.histogram("fault.recovery_seconds").observe(mttr)
                Log.info("fleet supervisor: gang completed cleanly after "
                         "%d restart(s), %d shrink(s)",
                         self.restarts, self.shrinks)
                return 0
            reaped = self._reap(procs, rcs)
            self.gang_exit_codes.append(
                {i: rc for i, rc in enumerate(rcs) if rc is not None})
            reg.inc("fault.fleet_gang_failures")
            for i, rc in sorted(first_bad.items()):
                Log.warning("fleet supervisor: rank %d failed first with "
                            "%s", i, describe_exit(rc))
            # 145 reports a lost peer; a reaped rank's code is our SIGTERM
            culprits = sorted(
                i for i, rc in enumerate(rcs)
                if rc not in (None, 0, EXIT_COMM_LOST) and i not in reaped)
            for i in range(self.world):
                if i in culprits:
                    self._consecutive_fails[i] = \
                        self._consecutive_fails.get(i, 0) + 1
                else:
                    self._consecutive_fails[i] = 0
            _obs.event("fleet_gang_failed", generation=self.generation,
                       exit_codes={str(i): rc for i, rc in enumerate(rcs)
                                   if rc is not None},
                       culprits=culprits)
            dead = sorted(i for i, n in self._consecutive_fails.items()
                          if n >= self.rank_dead_after)
            if dead:
                if not self.elastic:
                    Log.warning(
                        "fleet supervisor: rank(s) %s failed %d consecutive "
                        "gang incident(s) and look DEAD, but elastic resume "
                        "is OFF — refusing to shrink the fleet implicitly. "
                        "Relaunch with --elastic (children then run "
                        "elastic=true tpu_reshard_on_resume=true) to "
                        "restart on the surviving ranks, or repair the host "
                        "(exit %d)", dead, self.rank_dead_after,
                        EXIT_COMM_LOST)
                    return EXIT_COMM_LOST
                new_world = self.world - len(dead)
                if new_world < self.min_world:
                    Log.warning("fleet supervisor: shrinking past "
                                "min_world=%d is not possible (dead ranks "
                                "%s) — giving up (exit %d)", self.min_world,
                                dead, EXIT_COMM_LOST)
                    return EXIT_COMM_LOST
                Log.warning("fleet supervisor: rank(s) %s declared dead — "
                            "ELASTIC shrink %d -> %d rank(s); children "
                            "resume from the newest gang-consistent "
                            "manifest through tpu_reshard_on_resume", dead,
                            self.world, new_world)
                self.world = new_world
                self.shrinks += 1
                reg.inc("fault.fleet_shrinks")
                self._consecutive_fails = {}
                for tok in ("elastic=true", "tpu_reshard_on_resume=true"):
                    if tok not in self._appended \
                            and tok not in self.argv_template:
                        self._appended.append(tok)
            if self.restarts >= self.max_restarts:
                worst = max(first_bad.values())
                Log.warning("fleet supervisor: restart budget (%d) "
                            "exhausted — giving up with %s",
                            self.max_restarts, describe_exit(worst))
                return worst
            pending_fail_t = self._now()
            id_at_fail = self._newest_id()
            self.restarts += 1
            reg.inc("fault.fleet_restarts")
            delay = _backoff(self, self.restarts)
            Log.warning("fleet supervisor: relaunching the gang (restart "
                        "%d/%d, world %d) with resume_from=auto in %.2fs",
                        self.restarts, self.max_restarts, self.world, delay)
            self._sleep(delay)
            self.generation += 1

    def report(self) -> Dict:
        return {"restarts": self.restarts,
                "generations": self.generation,
                "world": self.world,
                "shrinks": self.shrinks,
                "gang_exit_codes": [
                    {str(i): rc for i, rc in g.items()}
                    for g in self.gang_exit_codes],
                "recovery_seconds": [round(s, 3)
                                     for s in self.recovery_seconds],
                "checkpoint_dir": self.checkpoint_dir}


def main(argv: Optional[List[str]] = None) -> int:
    """The command line. Supervisor options are ``--flag=value`` before
    ``--``; everything after ``--`` (or the first bare ``key=value``) is
    the train command handed to ``python -m lightgbm_tpu_torch``.
    ``--fleet=N`` supervises an N-rank gang (the command is a per-rank
    template), ``--elastic`` permits shrinking onto the survivors and
    ``--rank-dead-after=K`` sets how many consecutive gang incidents make
    a rank dead."""
    argv = sys.argv[1:] if argv is None else list(argv)
    opts = {"max_restarts": 5, "backoff_base_s": 1.0, "backoff_max_s": 60.0,
            "jitter": 0.25, "seed": None}
    fleet = 0
    fleet_opts = {"elastic": False, "rank_dead_after": 2}
    train_args: List[str] = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok == "--":
            train_args.extend(argv[i + 1:])
            break
        if tok == "--elastic":
            fleet_opts["elastic"] = True
            i += 1
            continue
        if tok.startswith("--") and "=" in tok:
            k, v = tok[2:].split("=", 1)
            k = k.replace("-", "_")
            if k in ("max_restarts", "seed"):
                opts[k] = int(v)
                i += 1
                continue
            if k in ("backoff_base_s", "backoff_max_s", "jitter"):
                opts[k] = float(v)
                i += 1
                continue
            if k == "fleet":
                fleet = int(v)
                i += 1
                continue
            if k == "rank_dead_after":
                fleet_opts["rank_dead_after"] = int(v)
                i += 1
                continue
            if k == "elastic":
                fleet_opts["elastic"] = v.strip().lower() in (
                    "1", "true", "yes", "on")
                i += 1
                continue
        train_args.append(tok)
        i += 1
    if not train_args:
        print("usage: python -m lightgbm_tpu_torch.robustness.supervisor "
              "[--max-restarts=N] [--backoff-base-s=F] [--backoff-max-s=F] "
              "[--jitter=F] [--seed=N] [--fleet=N [--elastic] "
              "[--rank-dead-after=K]] -- <lightgbm_tpu_torch CLI args>",
              file=sys.stderr)
        return 2
    if fleet > 0:
        sup = FleetSupervisor(train_args, fleet, **opts, **fleet_opts)
    else:
        sup = Supervisor(train_args, **opts)
    rc = sup.run()
    rep = sup.report()
    Log.info("%s: done (exit %d): %d restart(s), recovery_seconds=%s",
             "fleet supervisor" if fleet > 0 else "supervisor", rc,
             rep["restarts"], rep["recovery_seconds"])
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
